"""The port's roofline against ``repro.roofline`` on the CPU: the op
counter (``op_cost``) against the reference's jaxpr counter on the same
functions, the kernels' counter records, the reduced configs' product FLOPs
against a walk of the reference's jaxprs, and the analysis and report
functions on the same numbers.

The counter runs on ``meta`` tensors (nothing allocated) and on CPU tensors
made with numpy from a seed; both give the same count, which is what lets
the card's count be held to the ``meta`` count in ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.config.base import all_arch_ids as j_all_arch_ids
from repro.config.base import get_config as j_get_config
from repro.models.layers.moe import SpmdCtx as JCtx
from repro.models.model_api import build as j_build
from repro.models.param import tree_abstract as j_tree_abstract
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.optim.specs import opt_state_specs as j_opt_state_specs
from repro.roofline import analysis as j_analysis
from repro.roofline import jaxpr_cost as j_cost
from repro.roofline import report as j_report
from repro.train.step import make_prefill_step as j_make_prefill_step
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.config.base import ShapeConfig
from repro_torch.config.base import get_config as t_get_config
from repro_torch.kernels.combine.ops import combine
from repro_torch.kernels.dispatch.ops import dispatch
from repro_torch.kernels.histogram.ops import histogram
from repro_torch.kernels.ssd_scan.ops import state_scan
from repro_torch.kernels.topk_gating.ops import gating
from repro_torch.launch.dryrun import build_step
from repro_torch.roofline import analysis as t_analysis
from repro_torch.roofline import hw as t_hw
from repro_torch.roofline import kernel_cost
from repro_torch.roofline import report as t_report
from repro_torch.roofline.op_cost import OpCounter, trace_cost

META = "meta"


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def _cpu(rng, *shape, grad=False):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_(grad)


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# --------------------------------------------------------------------- #
# The counter, case by case against the reference's
# --------------------------------------------------------------------- #


def _loop(x, ws):
    for w in ws:
        x = x @ w
    return x


def _nested(x, ws):
    for row in ws:
        for w in row:
            x = x @ w
    return x


def _j_loop(x, ws):
    return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]


def _j_nested(x, ws):
    def outer(c, wrow):
        return jax.lax.scan(lambda ci, w: (ci @ w, None), c, wrow)[0], None
    return jax.lax.scan(outer, x, ws)[0]


COUNTER_CASES = {
    # name: (port fn, port shapes, reference fn, exact FLOPs)
    "matmul": (lambda x, y: x @ y, [(64, 128), (128, 32)], lambda x, y: x @ y, 2 * 64 * 128 * 32),
    "batched_einsum": (lambda x, y: torch.einsum("bij,bjk->bik", x, y), [(4, 8, 16), (4, 16, 8)],
                       lambda x, y: jnp.einsum("bij,bjk->bik", x, y), 2 * 4 * 8 * 16 * 8),
    "loop_of_16": (_loop, [(32, 32), (16, 32, 32)], _j_loop, 16 * 2 * 32**3),
    "nested_loops": (_nested, [(16, 16), (4, 3, 16, 16)], _j_nested, 12 * 2 * 16**3),
}


class TestCounter:
    @pytest.mark.parametrize("case", sorted(COUNTER_CASES))
    def test_flops_exact_and_equal_to_reference(self, case):
        fn, shapes, jfn, want = COUNTER_CASES[case]
        got = trace_cost(fn, *[_meta(*s) for s in shapes])
        assert got["flops"] == want and got["dot_flops"] == want
        assert j_cost.trace_cost(jfn, *[_sds(*s) for s in shapes])["flops"] == want

    @pytest.mark.parametrize("case", sorted(COUNTER_CASES))
    def test_meta_counts_as_cpu(self, case):
        fn, shapes, _, _ = COUNTER_CASES[case]
        rng = np.random.default_rng(len(case))
        on_cpu = trace_cost(fn, *[_cpu(rng, *s) for s in shapes])
        assert on_cpu == trace_cost(fn, *[_meta(*s) for s in shapes])

    @staticmethod
    def _remat_loss(ws, x):
        def body(c, w):
            return torch.tanh(c @ w)
        for w in ws.unbind(0):
            x = checkpoint(body, x, w, use_reentrant=False, preserve_rng_state=False)
        return (x ** 2).sum()

    def test_remat_grad_counts_recompute(self):
        """grad with remat ≈ forward + recompute + 2× the backward products:
        3.0–4.5× the forward, as the reference's test bounds it."""
        def grad(ws, x):
            with torch.enable_grad():
                return torch.autograd.grad(self._remat_loss(ws, x), ws)

        fwd = trace_cost(self._remat_loss, _meta(8, 64, 64), _meta(64, 64))["flops"]
        bwd = trace_cost(grad, _meta(8, 64, 64, grad=True), _meta(64, 64))
        assert 3.0 <= bwd["flops"] / fwd <= 4.5

        def j_loss(ws, x):
            out, _ = jax.lax.scan(jax.checkpoint(lambda c, w: (jnp.tanh(c @ w), None)), x, ws)
            return (out ** 2).sum()

        # Products exactly: 8 forward, 8 recomputed, 8 for the weights and 7
        # for the activations: x takes no gradient, and autograd skips the
        # first step's.  The reference transposes one scan body for all 8
        # steps, so it also makes that one, which nothing reads: one
        # product more.
        assert bwd["dot_flops"] == 31 * 2 * 64**3
        j_dots = _j_dot_flops(jax.make_jaxpr(jax.grad(j_loss))(_sds(8, 64, 64), _sds(64, 64)))
        assert bwd["dot_flops"] == j_dots - 2 * 64**3

        j_ratio = (j_cost.trace_cost(jax.grad(j_loss), _sds(8, 64, 64), _sds(64, 64))["flops"]
                   / j_cost.trace_cost(j_loss, _sds(8, 64, 64), _sds(64, 64))["flops"])
        assert 3.0 <= j_ratio <= 4.5

    def test_elementwise_bytes(self):
        got = trace_cost(lambda a: torch.tanh(a) + 1.0, _meta(128, 128))
        assert got["bytes"] >= 2 * 128 * 128 * 4
        # tanh and the add each read and write one (128, 128) float32; the
        # reference also counts the 4 bytes of its literal 1.0.
        assert got["bytes"] == 4 * 128 * 128 * 4
        assert got["bytes"] == j_cost.trace_cost(lambda a: jnp.tanh(a) + 1.0, _sds(128, 128))["bytes"] - 4
        assert got["flops"] == 2 * 128 * 128 and got["dot_flops"] == 0

    def test_views_move_nothing(self):
        got = trace_cost(lambda a: a.view(4, 8).t()[:2].unsqueeze(0).expand(3, 2, 4), _meta(8, 4))
        assert got["flops"] == got["bytes"] == 0
        # A reshape of a transpose copies (``clone``): a layout copy, which
        # is not counted, so that the count does not depend on strides.
        got = trace_cost(lambda a: a.t().reshape(-1), _meta(8, 4))
        assert (got["flops"], got["bytes"]) == (0, 0)
        # A cast does work.
        got = trace_cost(lambda a: a.to(torch.bfloat16), _meta(8, 4))
        assert (got["flops"], got["bytes"]) == (32, 32 * 4 + 32 * 2)

    def test_peak_counts_arguments_and_frees(self):
        """x, then (x * 2) alive while (x * 2) * 3 is written: three
        tensors; the temporary is gone by the next op."""
        n = 256 * 4
        got = trace_cost(lambda x: ((x * 2) * 3).sum(), _meta(256))
        assert got["peak_bytes"] == 3 * n
        # A loop that drops each step's tensor keeps the peak flat.
        def loop(x):
            for _ in range(10):
                x = x * 2
            return x
        assert trace_cost(loop, _meta(256))["peak_bytes"] == 3 * n


# --------------------------------------------------------------------- #
# The kernels' records
# --------------------------------------------------------------------- #


def _kernel_calls(rng):
    """Each wrapper's call on CPU inputs made beforehand (made inside the
    counter, they would count), with the formula's record."""
    T, E, k, D, S = 64, 32, 8, 16, 96
    logits = torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, E, 512).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, T, S).astype(np.int32))
    valid = torch.from_numpy(rng.random(S) < 0.4)
    states = _cpu(rng, 5, 2, 4, 3)
    decay = torch.from_numpy(rng.random((5, 2)).astype(np.float32))
    y_flat = _cpu(rng, 2 * S, D)
    slot = torch.from_numpy(rng.permutation(2 * S + 1)[:T * 2].reshape(T, 2).astype(np.int32))
    w = torch.from_numpy(rng.random((T, 2)).astype(np.float32))
    return {
        "topk_gating": (lambda: gating(logits, k), kernel_cost.topk_gating(logits, k)),
        "load_histogram": (lambda: histogram(ids, E), kernel_cost.load_histogram(ids, E)),
        "dispatch_gather": (lambda: dispatch(x, src, valid), kernel_cost.dispatch_gather(x, src)),
        "ssd_state_scan": (lambda: state_scan(states, decay), kernel_cost.ssd_state_scan(states)),
        "moe_combine": (lambda: combine(y_flat, slot, w), kernel_cost.moe_combine(y_flat, slot)),
    }


class TestKernelRecords:
    @pytest.mark.parametrize("name", ["topk_gating", "load_histogram", "dispatch_gather", "ssd_state_scan",
                                      "moe_combine"])
    def test_record_is_the_formula_and_nothing_else(self, name):
        """Each wrapper on CPU tensors (its plain version runs): the counter
        holds the formula's record and counts none of the plain ops."""
        call, want = _kernel_calls(np.random.default_rng(3))[name]
        with OpCounter() as c:
            call()
        got = c.result()
        assert got["kernels"] == {name: {"calls": 1, "flops": want.flops, "bytes": want.bytes}}
        assert (got["flops"], got["dot_flops"], got["bytes"]) == (want.flops, 0, want.bytes)

    def test_scan_backward_record(self):
        rng = np.random.default_rng(4)
        states = _cpu(rng, 6, 2, 4, 3, grad=True)
        decay = torch.from_numpy(rng.random((6, 2)).astype(np.float32)).requires_grad_(True)
        g = _cpu(rng, 6, 2, 4, 3)
        with OpCounter() as c:
            torch.autograd.grad(state_scan(states, decay), (states, decay), g)
        fwd = kernel_cost.ssd_state_scan(states)
        bwd = kernel_cost.ssd_state_scan_bwd(g, torch.float32)
        got = c.result()
        assert got["kernels"] == {
            "ssd_state_scan": {"calls": 1, "flops": fwd.flops, "bytes": fwd.bytes},
            "ssd_state_scan_bwd": {"calls": 1, "flops": bwd.flops, "bytes": bwd.bytes},
        }
        assert (got["flops"], got["bytes"]) == (fwd.flops + bwd.flops, fwd.bytes + bwd.bytes)

    def test_combine_backward_record(self):
        """The combine under grad on CPU tensors (the loop, and its
        autograd gradient in the backward): one record each way, none of
        the loop's ops."""
        rng = np.random.default_rng(5)
        y_flat = _cpu(rng, 48, 16, grad=True)
        slot = torch.from_numpy(rng.permutation(49)[:40].reshape(20, 2).astype(np.int32))
        w = torch.from_numpy(rng.random((20, 2)).astype(np.float32)).requires_grad_(True)
        g = _cpu(rng, 20, 16)
        with OpCounter() as c:
            torch.autograd.grad(combine(y_flat, slot, w), (y_flat, w), g)
        fwd = kernel_cost.moe_combine(y_flat, slot)
        bwd = kernel_cost.moe_combine_bwd(y_flat, slot)
        got = c.result()
        assert got["kernels"] == {
            "moe_combine": {"calls": 1, "flops": fwd.flops, "bytes": fwd.bytes},
            "moe_combine_bwd": {"calls": 1, "flops": bwd.flops, "bytes": bwd.bytes},
        }
        assert (got["flops"], got["bytes"]) == (fwd.flops + bwd.flops, fwd.bytes + bwd.bytes)

    def test_formulas_keep_the_kernel_checks_bytes(self):
        """The numbers ``chip_smoke.py``'s kernel checks have used: gating at
        (8192, 32) bf16 k 8, the histogram at N 65,536 E 32, the scan and its
        backward at (9, 512, 64, 128) float32."""
        assert kernel_cost.topk_gating(_meta(8192, 32, dtype=torch.bfloat16), 8).bytes == 1_048_576
        assert kernel_cost.load_histogram(_meta(65536, dtype=torch.int32), 32).bytes == 262_272
        assert kernel_cost.ssd_state_scan(_meta(9, 512, 64, 128)).bytes == 285_229_056
        assert kernel_cost.ssd_state_scan_bwd(_meta(9, 512, 64, 128), torch.float32).bytes == 402_685_952
        # The gather from shapes alone: every slot filled.
        S, D = 163840, 1024
        assert kernel_cost.dispatch_gather(_meta(8192, D, dtype=torch.bfloat16),
                                           _meta(S, dtype=torch.int32)).bytes == 2 * S * D * 2 + 5 * S


# --------------------------------------------------------------------- #
# Reduced configs: product FLOPs against the reference's jaxprs
# --------------------------------------------------------------------- #

ARCHS = j_all_arch_ids()
BATCH, SEQ = 2, 32


def _j_dot_flops(jaxpr) -> int:
    """The reference's loop-aware walk (``jaxpr_cost.analyze_jaxpr``),
    summing ``_dot_flops`` only."""
    jaxpr = j_cost._jaxpr_of(jaxpr)
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            total += _j_dot_flops(eqn.params["jaxpr"]) * eqn.params["length"]
        elif name == "while":
            total += _j_dot_flops(eqn.params["body_jaxpr"])
        elif name == "cond":
            total += max(_j_dot_flops(b) for b in eqn.params["branches"])
        elif name == "dot_general":
            total += j_cost._dot_flops(eqn)
        else:
            for key in j_cost._SUBJAXPR_PARAMS:
                if key in eqn.params:
                    total += _j_dot_flops(eqn.params[key])
                    break
    return total


def _j_step(arch, kind):
    cfg = j_get_config(arch).reduced()
    model = j_build(cfg)
    B, S = BATCH, SEQ
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = jax.ShapeDtypeStruct((B, cfg.encoder_len, cfg.d_model), jnp.dtype(cfg.dtype))
    if cfg.family == "vlm":
        extra["patches"] = jax.ShapeDtypeStruct((B, cfg.num_patches, cfg.d_model), jnp.dtype(cfg.dtype))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "prefill":
        fn = j_make_prefill_step(model, ctx=JCtx())
        args = (j_tree_abstract(model.specs(), dtype_override=jnp.dtype(cfg.dtype)),
                j_tree_abstract(model.decode_state_specs(B, S)), dict(tokens=tok, **extra))
    else:
        opt = JOpt(name=cfg.optimizer)
        pdt = jnp.float32 if cfg.optimizer == "adamw" else jnp.bfloat16
        state = {"params": j_tree_abstract(model.specs(), dtype_override=pdt),
                 "opt": j_tree_abstract(j_opt_state_specs(opt, model.specs())),
                 "step": jax.ShapeDtypeStruct((), jnp.int32)}
        dk = model.dyskew_init(JCtx())
        if dk is not None:
            state["dyskew"] = jax.eval_shape(lambda: dk)
        fn = j_make_train_step(model, opt, ctx=JCtx())
        args = (state, dict(tokens=tok, targets=tok, **extra))
    return _j_dot_flops(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_dot_flops_equal_reference(arch, kind):
    """Every product of the reduced config's prefill and train step, the
    port's op counter on ``meta`` against the reference's jaxpr.  No
    difference is left: the same products in the same number, the layer
    stack, chunk loops and remat recompute run by Python in the port and
    by ``scan`` / ``checkpoint`` in the reference."""
    cfg = t_get_config(arch).reduced()
    fn, args, _ = build_step(cfg, ShapeConfig(kind, SEQ, BATCH, kind))
    got = trace_cost(fn, *args)
    assert got["dot_flops"] == _j_step(arch, kind)
    assert got["flops"] > got["dot_flops"] > 0


# --------------------------------------------------------------------- #
# Analysis and report, on the same numbers
# --------------------------------------------------------------------- #


class TestAnalysis:
    @pytest.mark.parametrize("dtype,dims", [("bf16", "128,4096"), ("f32", "10"), ("s8", "100,2"),
                                            ("pred", ""), ("c128", "3,3"), ("token", "4")])
    def test_shape_bytes(self, dtype, dims):
        assert t_analysis.shape_bytes(dtype, dims) == j_analysis.shape_bytes(dtype, dims)

    @pytest.mark.parametrize("kind", t_analysis.COLLECTIVE_KINDS)
    @pytest.mark.parametrize("group", [1, 2, 4, 8])
    def test_collective_wire_bytes(self, kind, group):
        """The reference's ring formulas, read through its HLO parser on a
        one-line module."""
        hlo = (f"ENTRY %main (a: f32[256,256]) -> f32[256,256] {{\n"
               f"  ROOT %x = f32[256,256]{{1,0}} {kind}(%a), replica_groups=[1,{group}]<=[{group}]\n}}\n")
        total, _ = j_analysis.collective_bytes_per_device(hlo)
        assert int(t_analysis.collective_wire_bytes(kind, 256 * 256 * 4, group)) == total

    @pytest.mark.parametrize("flops,nbytes,coll,mf", [
        (1e18, 1e12, 1e12, 5e17), (3e15, 7e13, 0.0, 1e15), (0.0, 0.0, 0.0, 0.0), (1e9, 1e13, 0.0, 2e9)])
    def test_roofline_terms(self, flops, nbytes, coll, mf):
        """The reference's formulas over the H100 constants: the reference's
        terms rescaled from its TPU peaks to the H100's."""
        from repro.roofline import hw as j_hw

        t = t_analysis.RooflineTerms(chips=1, flops_global=flops, hbm_bytes_global=nbytes,
                                     collective_bytes_global=coll, by_kind={}, model_flops=mf)
        j = j_analysis.RooflineTerms(chips=1, flops_global=flops, hbm_bytes_global=nbytes,
                                     collective_bytes_global=coll, by_kind={}, model_flops=mf)
        assert t.t_compute == pytest.approx(j.t_compute * j_hw.PEAK_FLOPS_BF16 / t_hw.PEAK_FLOPS_BF16)
        assert t.t_memory == pytest.approx(j.t_memory * j_hw.HBM_BW / t_hw.HBM_BW)
        assert t.t_collective == pytest.approx(j.t_collective * j_hw.ICI_LINK_BW / t_hw.NVLINK_BW)
        assert t.useful_flops_ratio == j.useful_flops_ratio
        assert set(t.as_dict()) == set(j.as_dict())
        if flops:
            assert t.bottleneck == ("compute" if t.t_compute >= max(t.t_memory, t.t_collective)
                                    else "memory" if t.t_memory >= t.t_collective else "collective")

    def test_analyze_takes_the_counter(self):
        cost = {"flops": 2e15, "bytes": 4e12, "dot_flops": 1e15, "peak_bytes": 0, "kernels": {}}
        t = t_analysis.analyze(cost, 1, 1e15)
        assert t.t_compute == pytest.approx(2e15 / 989e12)
        assert t.t_memory == pytest.approx(4e12 / 3.35e12)
        assert t.collective_bytes_global == 0.0 and t.useful_flops_ratio == 0.5
        assert set(t.by_kind) == set(t_analysis.COLLECTIVE_KINDS)

    @pytest.mark.parametrize("params,tokens,kind", [
        (478_412_800, 8 * 1024, "train"), (1_518_600_192, 8 * 1024, "prefill"), (10, 1, "decode")])
    def test_model_flops_estimate(self, params, tokens, kind):
        assert (t_analysis.model_flops_estimate(params, tokens, kind)
                == j_analysis.model_flops_estimate(params, tokens, kind))


def _records():
    """Dry-run records of both kinds, made with numpy from a seed."""
    rng = np.random.default_rng(5)
    recs = []
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b", "mamba2-1.3b", "qwen1.5-32b"):
        for shape in ("decode_32k", "train_4k", "long_500k", "prefill_32k"):
            rec = {"arch": arch, "shape": shape, "mesh": "single"}
            if shape == "long_500k" and arch != "mamba2-1.3b":
                rec["status"] = "SKIP: pure full-attention arch at 500k (sub-quadratic required)"
            else:
                tc, tm, tl = rng.lognormal(-3, 3, 3)
                rec.update(status="OK", memory={"per_device_total_gb": float(rng.uniform(0, 400)),
                                                "fits_hbm": bool(rng.random() < 0.5)},
                           roofline={"t_compute_s": float(tc), "t_memory_s": float(tm),
                                     "t_collective_s": float(tl) * (rng.random() < 0.5),
                                     "bottleneck": "memory", "useful_flops_ratio": float(rng.random()),
                                     "collective_bytes_global": float(rng.lognormal(20, 3))})
            recs.append(rec)
    recs.append({"arch": "granite-20b", "shape": "train_4k", "mesh": "single",
                 "status": "FAIL: RuntimeError: boom"})
    return recs


class TestReport:
    def test_load_and_table_equal_reference(self, tmp_path):
        import json

        for i, rec in enumerate(_records()):
            (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
        t_recs = t_report.load_records(str(tmp_path))
        j_recs = j_report.load_records(str(tmp_path))
        assert t_recs == j_recs
        assert t_report.roofline_table(t_recs, "single") == j_report.roofline_table(j_recs, "single")

    def test_picks_equal_reference(self):
        recs = _records()
        t_picks = t_report.pick_hillclimb_candidates(recs)
        j_picks = j_report.pick_hillclimb_candidates(recs)
        assert {k: (r["arch"], r["shape"]) for k, r in t_picks.items()} == \
               {k: (r["arch"], r["shape"]) for k, r in j_picks.items()}

    @pytest.mark.parametrize("x", [0, 3e-6, 2.5e-3, 0.75, 12.0, 512.0, 1234.5, 2e6, 7e9, 3e13])
    def test_formats_equal_reference(self, x):
        assert t_report.fmt_s(x) == j_report.fmt_s(x)
        assert t_report.fmt_bytes(x) == j_report.fmt_bytes(x)


def test_hbm_and_peaks_are_the_h100s():
    assert t_hw.PEAK_FLOPS_BF16 == 989e12 and t_hw.HBM_BW == 3.35e12
    assert t_hw.PEAK_FLOPS_FP32 == 67e12 and t_hw.CHIPS_SINGLE == 1
    assert t_hw.HBM_BYTES == 80 * 10**9


def test_dataclass_fields_match_reference():
    assert [f.name for f in dataclasses.fields(t_analysis.RooflineTerms)] == \
           [f.name for f in dataclasses.fields(j_analysis.RooflineTerms)]
