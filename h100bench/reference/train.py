"""The reference's first training steps, and the numbers the program's are
held to.

The reference draws the weights and the documents again from the seed,
packs them itself, holds each of the program's first batches to its own
packing (as a set of rows), and then takes the same steps as the program on
those rows, in the program's order: the loss and gradient in float32,
clipped, AdamW, weights kept in the configuration's type.  It gives each
step's loss, each leaf's norm of the first (clipped) gradient and each
leaf's norm of the change after the steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h100bench.lib import traffic as trafficmod
from h100bench.lib import weights
from h100bench.reference import optim
from h100bench.reference.decoder import Decoder
from h100bench.reference.packing import Packer, rows_unmatched, targets_of
from h100bench.reference.precision import Precision


def packed_batches(seed: int, mix: Dict, vocab: int, count: int) -> List[np.ndarray]:
    packer = Packer(trafficmod.documents(seed, mix, vocab), int(mix["seq_len"]), int(mix["batch"]))
    return [packer.batch() for _ in range(count)]


def steps(doc: Dict, mix: Dict, seed: int, rows: List[np.ndarray], device: torch.device,
          prec: Optional[Precision] = None, keep: bool = False, against: Optional[Dict] = None) -> Dict:
    """Take ``len(rows)`` steps on ``rows`` (each (B, S) int32, in the order
    to train them) from the seed's weights.  Returns {"loss": [...],
    "grad": {leaf: norm of step 1's clipped gradient}, "change": {leaf:
    norm of the weights' change}, "readings": [each step's mean layer
    readings]}; with ``keep`` also host copies of that gradient and of the
    last weights ("grad_t", "params_t"), and with ``against`` (another
    side's copies) each leaf's norm of the difference from them
    ("grad_diff", "change_diff": the change's difference is the last
    weights', the start being the same)."""
    model, opt = doc["model"], doc["optimizer"]
    dtype = weights.DTYPES[model.get("dtype", "bfloat16")]
    params = dict(weights.flatten(weights.make_params(model, doc["init"], mix, seed, device, dtype)))
    start = {k: p.clone() for k, p in params.items()}
    m = {k: torch.zeros(p.shape, dtype=torch.float32, device=device) for k, p in params.items()}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    out: Dict = {"loss": [], "readings": []}
    links = None
    for i, toks in enumerate(rows):
        tokens = torch.from_numpy(np.ascontiguousarray(toks)).to(device)
        targets = torch.from_numpy(targets_of(toks)).to(device)
        live = {k: p.to(torch.float32).requires_grad_(True) for k, p in params.items()}
        dec = Decoder(model, live, doc["ep_shards"], prec)
        if links is None:
            links = dec.links_init(device)
        with torch.enable_grad():
            loss, links, readings = dec.loss(tokens, targets, links)
            grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(live[k]) if g is None else g) for k, g in zip(live, grads)}
        del live, dec
        grads = optim.clip(grads, opt["grad_clip"])
        if i == 0:
            out["grad"] = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            if keep:
                out["grad_t"] = {k: g.to("cpu") for k, g in grads.items()}
            if against is not None:
                out["grad_diff"] = _diff(grads, against["grad_t"])
        optim.adamw(opt, params, grads, m, v, i)
        del grads
        out["loss"].append(float(loss.detach()))
        out["readings"].append({k: float(r.detach()) for k, r in readings.items()})
        if links is not None:
            links = [{k: t.detach() for k, t in ln.items()} for ln in links]
    out["change"] = {k: float(torch.linalg.vector_norm(params[k].detach().float() - start[k].float())) for k in params}
    if keep:
        out["params_t"] = {k: p.to("cpu") for k, p in params.items()}
    if against is not None:
        out["change_diff"] = _diff(params, against["params_t"])
    return out


def _diff(ours: Dict[str, torch.Tensor], theirs: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.detach().float() - theirs[k].to(t.device).float())) for k, t in ours.items()}


def check_rows(seed: int, mix: Dict, vocab: int, program_rows: List[np.ndarray]) -> int:
    """Rows of the program's first batches that the reference's packing of
    the same documents does not have."""
    ref = packed_batches(seed, mix, vocab, len(program_rows))
    return sum(rows_unmatched(p, r) for p, r in zip(program_rows, ref))
