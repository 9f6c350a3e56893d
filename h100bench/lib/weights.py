"""Weights from the seed, made by the benchmark and handed to both sides.

Every leaf is drawn on the device by a ``torch.Generator`` of its own,
seeded from the run's seed and the leaf's path, in the type it is served in
(one call a stacked leaf), so any one leaf can be drawn again later without
the others: the program's change over its first steps is read leaf by leaf
against a fresh draw, and the plain reference draws the same values again
once the program's state is freed.

The layout is the port's parameter tree (nested dicts, every block leaf
stacked over the layers), worked out here from the configuration file;
``check_layout`` holds it to the program's own specs before a run.  Each
matrix is drawn at 1/sqrt(fan-in of its inputs) (the port's own init takes
a stacked leaf's layer count as its fan-in), Mamba-2's ``A_log`` and
``dt_bias`` as the Mamba-2 paper initialises them, norms at one.  The
traffic's router skew is part of a router leaf's draw.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def padded_vocab(model: Dict) -> int:
    return (model["vocab_size"] + 127) // 128 * 128


def dims(model: Dict) -> Dict[str, int]:
    """The widths the layout and the reference use.  Mamba-2's B/C group
    count is the file's ``mamba.n_groups`` (the published ``ngroups``), 1
    where the file has none, as in the published default."""
    d = model["d_model"]
    out = {"d": d, "L": model["num_layers"], "V": model["vocab_size"], "Vp": padded_vocab(model)}
    if model.get("num_heads", 0):
        H = model["num_heads"]
        out.update(H=H, K=model["num_kv_heads"], hd=model.get("head_dim") or d // H)
    if model.get("moe"):
        m = model["moe"]
        out.update(E=m["num_experts"], k=m["top_k"], f=m["expert_ff"])
    if model.get("mamba"):
        m = model["mamba"]
        di = m["expand"] * d
        nh = di // m["head_dim"]
        g = m.get("n_groups", 1)
        if g < 1 or nh % g:
            raise ValueError(f"mamba.n_groups {g} does not divide the {nh} heads")
        out.update(di=di, nh=nh, P=m["head_dim"], N=m["d_state"], g=g, w=m["conv_width"], chunk=m["chunk"])
    return out


def layout(model: Dict, init: Dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """``{path: (shape, kind, scale)}`` of every leaf, ``/``-joined paths in
    the port's tree; ``kind`` is normal, ones, a_log or dt_bias."""
    if model.get("attn_period", 1) != 1 or model.get("moe", {}).get("layout", "all") != "all":
        raise NotImplementedError("the benchmark's layout takes one kind of layer, repeated")
    z = dims(model)
    d, L, Vp = z["d"], z["L"], z["Vp"]
    tied = model.get("tie_embeddings", False)
    out: Dict[str, Tuple[Tuple[int, ...], str, float]] = {
        "embed/table": ((Vp, d), "normal", 1.0 / math.sqrt(d) if tied else init["embed_scale"]),
        "blocks/l0/norm1/scale": ((L, d), "ones", 1.0),
        "final_norm/scale": ((d,), "ones", 1.0),
    }
    if not tied:
        out["lm_head/table"] = ((Vp, d), "normal", init["head_scale"])
    b = "blocks/l0/"
    if model.get("num_heads", 0):
        H, K, hd = z["H"], z["K"], z["hd"]
        out.update({
            b + "attn/wq": ((L, d, H, hd), "normal", d ** -0.5),
            b + "attn/wk": ((L, d, K, hd), "normal", d ** -0.5),
            b + "attn/wv": ((L, d, K, hd), "normal", d ** -0.5),
            b + "attn/wo": ((L, H, hd, d), "normal", (H * hd) ** -0.5),
        })
    else:
        di, nh, g, n, w = z["di"], z["nh"], z["g"], z["N"], z["w"]
        out.update({
            b + "mamba/w_z": ((L, d, di), "normal", d ** -0.5),
            b + "mamba/w_x": ((L, d, di), "normal", d ** -0.5),
            b + "mamba/w_B": ((L, d, g, n), "normal", d ** -0.5),
            b + "mamba/w_C": ((L, d, g, n), "normal", d ** -0.5),
            b + "mamba/w_dt": ((L, d, nh), "normal", d ** -0.5),
            b + "mamba/dt_bias": ((L, nh), "dt_bias", 1.0),
            b + "mamba/A_log": ((L, nh), "a_log", 1.0),
            b + "mamba/D": ((L, nh), "ones", 1.0),
            b + "mamba/conv_x": ((L, w, di), "normal", w ** -0.5),
            b + "mamba/conv_B": ((L, w, g, n), "normal", w ** -0.5),
            b + "mamba/conv_C": ((L, w, g, n), "normal", w ** -0.5),
            b + "mamba/norm_scale": ((L, di), "ones", 1.0),
            b + "mamba/w_out": ((L, di, d), "normal", di ** -0.5),
        })
    if model.get("moe"):
        E, f = z["E"], z["f"]
        out.update({
            b + "norm2/scale": ((L, d), "ones", 1.0),
            b + "moe/router": ((L, d, E), "normal", init["router_scale"]),
            b + "moe/w_gate": ((L, E, d, f), "normal", d ** -0.5),
            b + "moe/w_up": ((L, E, d, f), "normal", d ** -0.5),
            b + "moe/w_down": ((L, E, f, d), "normal", f ** -0.5),
        })
    return out


def leaf_seed(seed: int, path: str) -> int:
    """A generator seed for one leaf of one run's draw."""
    digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def router_bias(E: int, alpha: float) -> np.ndarray:
    """Zipf(``alpha``) logit bias over the experts, centred: the reference
    benchmark's pattern (``_skewed_router_bias``), low ids hottest."""
    probs = 1.0 / np.arange(1, E + 1) ** alpha
    probs /= probs.sum()
    logp = np.log(probs)
    return logp - logp.mean()


def router_skew(model: Dict, traffic: Dict, seed: int) -> Optional[np.ndarray]:
    """(L, E) float64 bias each layer's router rows get (None without
    skew): the Zipf profile times the traffic's scale, its hot experts put
    in a seed-drawn order in each layer."""
    alpha = float(traffic.get("router_skew_alpha", 0.0))
    scale = float(traffic.get("router_skew_scale", 0.0))
    if not model.get("moe") or alpha == 0.0 or scale == 0.0:
        return None
    E, L = model["moe"]["num_experts"], model["num_layers"]
    rng = np.random.default_rng([seed % 2**64, 0x524F55])
    bias = router_bias(E, alpha) * scale
    return np.stack([bias[rng.permutation(E)] for _ in range(L)])


def make_leaf(model: Dict, init: Dict, traffic: Dict, seed: int, path: str,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    shape, kind, scale = layout(model, init)[path]
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, path))
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "a_log":
        # A in [1, 16], as Mamba-2 initialises it.
        u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if kind == "dt_bias":
        # dt log-uniform in [1e-3, 1e-1], dt_bias its inverse softplus.
        u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))).clamp(min=1e-4)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    out = torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(scale)
    if path.endswith("moe/router"):
        skew = router_skew(model, traffic, seed)
        if skew is not None:
            out.add_(torch.from_numpy(skew).to(device=device, dtype=dtype)[:, None, :])
    return out


def nest(flat: Dict[str, Any]) -> Dict:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def make_params(model: Dict, init: Dict, traffic: Dict, seed: int, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """The whole tree, in the configuration's type unless ``dtype``."""
    dt = dtype or DTYPES[model.get("dtype", "bfloat16")]
    return nest({p: make_leaf(model, init, traffic, seed, p, device, dt) for p in layout(model, init)})


def check_layout(params: Dict, program_specs: Dict) -> None:
    """Raise unless ``params`` has exactly the program's leaves and shapes."""
    ours = {p: tuple(t.shape) for p, t in flatten(params)}
    theirs = {p: tuple(s.shape) for p, s in flatten(program_specs)}
    if ours != theirs:
        raise ValueError(f"the benchmark's weights do not match the program's tree: "
                         f"only ours {sorted(set(ours) - set(theirs))}, only the program's "
                         f"{sorted(set(theirs) - set(ours))}, shapes differ at "
                         f"{sorted(p for p in ours if p in theirs and ours[p] != theirs[p])}")
