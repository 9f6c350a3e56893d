"""Readings the limits of ``correct`` are set from, on the chip.

    python3 h100bench/control.py --workload <cell> --seeds 11,12,... [--control-seeds 21,22,23] [--look] [--out FILE]

For each of ``--seeds`` it runs the cell's program as a run does up to its
check, without the measured window (training: set-up's checked steps;
serving: one whole round), frees it, and reads the numbers ``correct``
compares: the lower readings.  For each of ``--control-seeds`` it reads the
same numbers of the control, the plain reference in the program's place
computed with fp8 matrix products (the step below the configuration's
bfloat16), and, for training, of a planted fault: half of each batch left
out, the mean taken over the rest.  A serving control is read in lockstep
with the reference on the program's own prompts and tokens.  With
``--look`` a training program's reading also says, leaf by leaf, where its
first steps part from the reference's element by element.  One JSON object
a reading goes to standard output (and ``--out``).  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _leaves(side, ref):
    """Each leaf's norms on both sides and its norms of the differences."""
    return {k: {"grad": side["grad"][k], "grad_ref": ref["grad"][k], "grad_diff": ref["grad_diff"][k],
                "change": side["change"][k], "change_ref": ref["change"][k], "change_diff": ref["change_diff"][k]}
            for k in ref["grad"]}


def _look(cell, seed, prog, ref, device):
    """Each leaf's shares of elements that moved on either side, that ended
    apart, and whose first gradients differ in sign; of the elements apart,
    the share that ended on neighbouring values of the weights' type (one
    rounding step apart); and the shares of the weights' squared difference
    that lie on sign flips and on elements only one side moved."""
    import torch

    from h100bench.lib import weights

    out = {}
    for k, p in prog["params_t"].items():
        start = weights.make_leaf(cell.config["model"], cell.config["init"], cell.mix, seed, k, device,
                                  p.dtype).float()
        pp, pr = p.to(device), ref["params_t"][k].to(device)
        dp, dr = pp.float() - start, pr.float() - start
        flip = torch.sign(prog["grad_t"][k].to(device)) != torch.sign(ref["grad_t"][k].to(device))
        apart = dp != dr
        one_side = (dp != 0) != (dr != 0)
        d2 = (dp - dr).square()
        total = float(d2.sum())
        n_apart = int(apart.sum())
        # Neighbouring values of one sign are one apart as integers of the type's width.
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[pp.element_size()]
        steps = (pp.view(bits).long() - pr.view(bits).long()).abs()
        out[k] = {"moved": float(((dp != 0) | (dr != 0)).float().mean()), "apart": n_apart / apart.numel(),
                  "grad_sign_differs": float(flip.float().mean()),
                  "apart_one_step": float((steps[apart] == 1).sum()) / n_apart if n_apart else 0.0,
                  "diff_sq_on_sign_flips": float(d2[flip].sum()) / total if total else 0.0,
                  "diff_sq_one_side_moved": float(d2[one_side].sum()) / total if total else 0.0}
        del start, pp, pr, dp, dr, flip, apart, one_side, d2, steps
    return out


def readings(workload: str, seeds, control_seeds, device=None, root: Path = ROOT, emit=print,
             control: str = "fp8", look: bool = False):
    """Emit the readings; ``control`` is the control's precision (fp8 for
    the configurations' bfloat16; bf16 for a float32 one on a CPU)."""
    import torch

    from h100bench.lib import cell as cellmod
    from h100bench.lib import checks
    from h100bench.reference import serve as refserve
    from h100bench.reference import train as reftrain
    from h100bench.reference.precision import Precision

    cell = cellmod.load(workload, root)
    device = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = cell.mix["driver"]
    low_prec = Precision(control)
    low_side = f"control_{control}"
    vocab = cell.config["model"]["vocab_size"]
    for seed in seeds:
        t0 = time.perf_counter()
        run = cellmod.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=device, started=t0)
        drv = cellmod.driver(kind).Driver(run)
        drv.setup()
        if kind == "serve":
            served, _, _, _ = drv._serve(1, drv.n_dec, None)
        drv.release()
        _free(device)
        if kind == "train":
            ref = reftrain.steps(cell.config, cell.mix, seed, drv.rows, device, keep=look, against=drv.prog)
            nums = checks.train_numbers(drv.prog, ref)
            nums["rows_unmatched"] = reftrain.check_rows(seed, cell.mix, vocab, drv.rows)
            extra = {"look": _look(cell, seed, drv.prog, ref, device)} if look else {}
            emit({"side": "program", "seed": seed, **nums, "loss_program": drv.prog["loss"], "loss_reference": ref["loss"],
                  "leaves": _leaves(drv.prog, ref), **extra, "s": time.perf_counter() - t0})
            del ref
        else:
            out = refserve.round_gaps(cell.config, cell.mix, seed, 1, served, device,
                                      control=low_prec if seed in control_seeds else None)
            emit({"side": "program", "seed": seed, "logit_gap": out["gap"], "mean_gap": out["mean_gap"],
                  "not_best": out["not_best"], "gaps": out["gaps"], "readings": out["readings"],
                  "s": time.perf_counter() - t0})
            if "control_gap" in out:
                emit({"side": low_side, "seed": seed, "logit_gap": out["control_gap"],
                      "mean_gap": out["control_mean_gap"], "not_best": out["control_not_best"]})
        del drv
        _free(device)
    if kind != "train":
        return
    for seed in control_seeds:
        rows = reftrain.packed_batches(seed, cell.mix, vocab, int(cell.mix["check_steps"]))
        for side, kw in ((low_side, {"prec": low_prec}), ("fault_half_batch", {})):
            part = [r[: len(r) // 2] for r in rows] if side == "fault_half_batch" else rows
            other = reftrain.steps(cell.config, cell.mix, seed, part, device, keep=True, **kw)
            ref = reftrain.steps(cell.config, cell.mix, seed, rows, device, against=other)
            emit({"side": side, "seed": seed, **checks.train_numbers(other, ref), "loss_side": other["loss"],
                  "loss_reference": ref["loss"], "leaves": _leaves(other, ref)})
            del other, ref
            _free(device)
        _free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--look", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps({"workload": args.workload, **obj})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(args.workload, seeds, controls, emit=emit, look=args.look)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
