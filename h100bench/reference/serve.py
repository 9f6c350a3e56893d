"""The reference over one served round, and the gap the program's tokens are
held to.

The reference draws the weights and the round's prompts again from the
seed, prefills all of the round's prompts in one call, as the program does
(the MoE layers' capacities depend on the whole call), then decodes fed the
program's own tokens, a step at a time over the whole batch.  At each
served position it reads how far the served token's logit lies below its
own best: the widest such gap is the number compared.  A control, run in
lockstep on the same prompts and tokens, puts first the token its lower
precision makes best; its gap is read the same way.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from h100bench.lib import traffic as trafficmod
from h100bench.lib import weights
from h100bench.reference.decoder import Decoder
from h100bench.reference.precision import Precision


def params_f32(doc: Dict, mix: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    model = doc["model"]
    dtype = weights.DTYPES[model.get("dtype", "bfloat16")]
    tree = weights.make_params(model, doc["init"], mix, seed, device, dtype)
    return {k: p.to(torch.float32) for k, p in weights.flatten(tree)}


def _gap(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """(B,) how far ``token``'s logit lies below the best."""
    return logits.max(dim=-1).values - torch.gather(logits, -1, token[:, None].to(torch.int64))[:, 0]


@torch.no_grad()
def round_gaps(doc: Dict, mix: Dict, seed: int, round_index: int, served: np.ndarray,
               device: torch.device, control: Optional[Precision] = None) -> Dict:
    """``served`` (B, n) the program's tokens of the round (the first from
    the prefill).  Returns {"gap": widest gap of the program's tokens,
    "gaps": (n,) widest a position, "control_gap": the control's (with
    ``control``), "readings": the prefill's and the decode steps' mean layer
    readings}."""
    model = doc["model"]
    p = params_f32(doc, mix, seed, device)
    prompts = torch.from_numpy(trafficmod.prompts(seed, mix, model["vocab_size"], round_index)).to(device)
    toks = torch.from_numpy(np.ascontiguousarray(served)).to(device=device, dtype=torch.int64)
    B, S = prompts.shape
    n = toks.shape[1]
    sides = [Decoder(model, p, doc["ep_shards"])]
    if control is not None:
        sides.append(Decoder(model, p, doc["ep_shards"], control))
    outs = [dec.prefill(prompts, S + n - 1) for dec in sides]
    logits = [o[0] for o in outs]
    states = [o[1] for o in outs]
    prefill_readings = {k: float(v) for k, v in outs[0][2].items()}
    decode_readings = []
    gaps, control_gaps = [], []
    for i in range(n):
        gaps.append(_gap(logits[0], toks[:, i]))
        if control is not None:
            control_gaps.append(_gap(logits[0], logits[1].argmax(dim=-1)))
        if i + 1 < n:
            stepped = [dec.decode(toks[:, i], st, S + i) for dec, st in zip(sides, states)]
            logits = [s[0] for s in stepped]
            decode_readings.append(stepped[0][1])
    every = torch.stack(gaps, dim=1)
    per_pos = every.max(dim=0).values
    out = {"gap": float(per_pos.max()), "gaps": per_pos.tolist(), "mean_gap": float(every.mean()),
           "not_best": float((every > 0).to(torch.float32).mean()),
           "readings": {"prefill": prefill_readings,
                        "decode": {k: float(torch.stack([r[k] for r in decode_readings]).mean())
                                   for k in (decode_readings[0] if decode_readings else {})}}}
    if control is not None:
        ctrl = torch.stack(control_gaps, dim=1)
        out.update(control_gap=float(ctrl.max()), control_mean_gap=float(ctrl.mean()),
                   control_not_best=float((ctrl > 0).to(torch.float32).mean()))
    return out
