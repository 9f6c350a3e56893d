"""The port's dry-run (``launch/dryrun.py``, ``launch/mesh.py``, the shapes
of ``config/base.py``) against ``repro``'s on the CPU.

The reference lowers and compiles on 512 forced host devices, which a test
cannot afford; what both sides must agree on is read from the reference's
own functions: the shape suite, which cells run, parameter counts and
``MODEL_FLOPS``.  The port traces every cell on ``meta`` tensors; a count on
``meta`` equals the same step's count on CPU tensors made from a seed,
which is what ``chip_smoke.py`` holds the card's count to.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.config import base as j_base
from repro.models.model_api import build as j_build
from repro.roofline import analysis as j_analysis
from repro.roofline import report as j_report
from repro_torch.config import base as t_base
from repro_torch.launch import dryrun, mesh
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import tree_leaves
from repro_torch.roofline import report as t_report
from repro_torch.roofline.op_cost import trace_cost

ARCHS = j_base.all_arch_ids()
SHAPE_NAMES = list(j_base.SHAPES)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_runnable_cells_equal_reference(arch, shape):
    assert dataclasses.asdict(t_base.SHAPES[shape]) == dataclasses.asdict(j_base.SHAPES[shape])
    assert t_base.cell_is_runnable(t_base.get_config(arch), t_base.SHAPES[shape]) == \
        j_base.cell_is_runnable(j_base.get_config(arch), j_base.SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_counts_on_meta_equal_reference(arch):
    """params, active params and MODEL_FLOPS of every shape, from the port's
    ``meta`` build of the full-size config; the abstract parameters hold
    exactly ``params`` elements and allocate nothing."""
    jcfg = j_base.get_config(arch)
    want_params = j_build(jcfg).num_params()
    for shape in SHAPE_NAMES:
        js = j_base.SHAPES[shape]
        tokens = js.global_batch * (js.seq_len if js.kind in ("train", "prefill") else 1)
        fn, args, meta = dryrun.build_cell(arch, shape)
        assert meta["params"] == want_params
        assert meta["active_params"] == jcfg.active_param_count()
        assert meta["model_flops"] == j_analysis.model_flops_estimate(jcfg.active_param_count(), tokens, js.kind)
        params = args[0]["params"] if js.kind == "train" else args[0]
        leaves = tree_leaves(params)
        assert all(t.is_meta for t in leaves)
        assert sum(t.numel() for t in leaves) == want_params


@pytest.mark.parametrize("arch,shape", [("granite-moe-1b-a400m", "decode_32k"), ("mamba2-1.3b", "prefill_32k")])
def test_run_cell_full_size_ok(arch, shape, tmp_path):
    # PyTorch's dispatch-mode machinery imports torch._dynamo at first use,
    # which sets TORCHINDUCTOR_CACHE_DIR: import it before the snapshot.
    import torch._dynamo  # noqa: F401

    env = dict(os.environ)
    rec = dryrun.run_cell(arch, shape, "card", out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "OK", rec.get("traceback")
    assert dict(os.environ) == env          # sets no environment variable
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__card.json").read_text())
    assert on_disk["status"] == "OK"
    for key in ("params", "active_params", "model_flops", "chips", "kind", "trace_s"):
        assert key in rec
    assert rec["chips"] == 1
    assert set(rec["memory"]) == {"argument_bytes", "peak_bytes", "per_device_total_gb", "fits_hbm"}
    assert 0 < rec["memory"]["argument_bytes"] < rec["memory"]["peak_bytes"]
    assert rec["memory"]["fits_hbm"] == (rec["memory"]["peak_bytes"] <= 80 * 10**9)
    t = rec["roofline"]
    assert t["flops_global"] == rec["cost"]["flops"] and t["collective_bytes_global"] == 0.0
    assert t["t_compute_s"] > 0 and t["t_memory_s"] > 0 and t["t_collective_s"] == 0.0
    assert rec["cost"]["kernels"], "the kernels report themselves on meta too"
    # The port's report renders the record as the reference's does.
    recs = t_report.load_records(str(tmp_path))
    assert t_report.roofline_table(recs, "card") == j_report.roofline_table(recs, "card")


def test_long_500k_skips_full_attention(tmp_path):
    rec = dryrun.run_cell("granite-20b", "long_500k", out_dir=str(tmp_path), verbose=False)
    ok, why = j_base.cell_is_runnable(j_base.get_config("granite-20b"), j_base.SHAPES["long_500k"])
    assert not ok and rec["status"] == why
    assert json.loads((tmp_path / "granite-20b__long_500k__single.json").read_text())["status"] == why


def test_a_failing_cell_is_recorded(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "build_cell", boom)
    rec = dryrun.run_cell("granite-moe-1b-a400m", "decode_32k", verbose=False)
    assert rec["status"] == "FAIL: RuntimeError: boom" and "Traceback" in rec["traceback"]


class TestFlags:
    @pytest.mark.parametrize("spec,field", [("h1", "causal_skip"), ("h9", "moe_scatter_combine"),
                                            ("h2", "cast_before_gather"), ("h8", "constrain_grads")])
    def test_accepted(self, spec, field):
        assert getattr(dryrun.parse_flags(spec)[0], field)

    def test_both(self):
        f, rule = dryrun.parse_flags("h1, H9")
        assert f.causal_skip and f.moe_scatter_combine and rule == {"fsdp_only": False, "h10": False}

    def test_rule_switches(self):
        f, rule = dryrun.parse_flags("h6,h10,h2")
        assert f.cast_before_gather and rule == {"fsdp_only": True, "h10": True}

    @pytest.mark.parametrize("spec", ["h5", "h3", "h4", "h7", "h11", "h1,h5"])
    def test_sharding_only_raise(self, spec):
        with pytest.raises(ValueError, match="sharding"):
            dryrun.parse_flags(spec)

    def test_unknown_raises(self):
        with pytest.raises(ValueError, match="unknown"):
            dryrun.parse_flags("h99")


class TestMesh:
    def test_one_card(self):
        """One process is the mesh (data 1, model 1); ``repro``'s single pod
        is (data 16, model 16)."""
        m = mesh.Mesh()
        assert m.shape == {"data": 1, "model": 1}
        assert mesh.dp_size(m) == 1 and mesh.model_size(m) == 1 and mesh.dp_axes(False) == ("data",)
        pod = mesh.make_production_mesh()
        assert pod.shape == {"data": 16, "model": 16} and mesh.dp_size(pod) == 16

    def test_four_cards_raise(self):
        """The pod meshes no longer raise: ``repro``'s (pod 2, data 16,
        model 16) and its data axes (pod, data)."""
        m = mesh.make_production_mesh(multi_pod=True)
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
        assert mesh.dp_size(m) == 32 and mesh.model_size(m) == 16
        assert mesh.dp_axes(True) == ("pod", "data")

    @pytest.mark.parametrize("arch", ARCHS)
    def test_spmd_ctx(self, arch):
        """Token groups and link instances of every shape on both pods, as
        ``repro``'s ``spmd_ctx`` gives them; one card has one of each."""
        import types

        from repro.launch import dryrun as j_dryrun

        cfg, jcfg = t_base.get_config(arch), j_base.get_config(arch)
        ctx = dryrun.spmd_ctx(cfg, mesh.Mesh())
        assert ctx.num_groups == 1 and ctx.num_ep_shards == 1
        for multi in (False, True):
            pod = mesh.make_production_mesh(multi_pod=multi)
            for shape in j_base.SHAPES.values():
                tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
                want = j_dryrun.spmd_ctx(jcfg, types.SimpleNamespace(shape=pod.shape), multi, tokens,
                                         shape.global_batch)
                got = dryrun.spmd_ctx(cfg, pod, tokens, shape.global_batch)
                split = shape.global_batch % mesh.dp_size(pod) == 0
                assert got.num_groups == want.num_groups and got.num_ep_shards == want.num_ep_shards, \
                    (arch, shape.name, multi)
                assert bool(want.batch_axes) == split


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_matches_init(arch):
    """``abstract_params`` and ``decode_state_init(device="meta")`` carry the
    shapes and dtypes of the real ones, and draw nothing."""
    model = t_build(t_base.get_config(arch).reduced())
    gen = torch.Generator().manual_seed(0)
    real = model.init(gen, device="cpu")
    after = gen.get_state()
    abstract = model.abstract_params()
    assert torch.equal(gen.get_state(), after)
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(real)] == \
           [(tuple(t.shape), t.dtype) for t in tree_leaves(abstract)]
    live, ab = model.decode_state_init(2, 16, device="cpu"), model.decode_state_init(2, 16, device="meta")
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(live)] == \
           [(tuple(t.shape), t.dtype) for t in tree_leaves(ab)]
    assert all(t.is_meta for t in tree_leaves(ab))


def _on_cpu(args, seed=0):
    """The ``meta`` arguments made real on the CPU from a seed: floats
    normal (decays and link loads uniform in [0, 1)), integers in range."""
    rng = np.random.default_rng(seed)

    def real(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            a = rng.uniform(0.0, 1.0, t.shape) if t.ndim <= 1 else 0.05 * rng.standard_normal(t.shape)
            return torch.from_numpy(np.asarray(a, np.float32)).to(t.dtype)
        if t.dtype == torch.bool:
            return torch.zeros(t.shape, dtype=torch.bool)
        if t.ndim == 0:                       # a position or step counter
            return torch.zeros((), dtype=t.dtype)
        return torch.from_numpy(rng.integers(0, 64, t.shape).astype(np.int64)).to(t.dtype)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return real(x)

    return walk(args)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b", "jamba-1.5-large-398b", "whisper-base",
                                  "pixtral-12b"])
def test_meta_count_equals_cpu_count(arch, kind):
    """The same reduced step counted on ``meta`` and on CPU tensors: FLOPs,
    product FLOPs, bytes and kernel records equal.  On the CPU the kernels'
    plain versions run and on the card the kernels: neither is counted op by
    op, each wrapper reports its record."""
    cfg = dataclasses.replace(t_base.get_config(arch).reduced(), dtype="float32")
    shape = t_base.ShapeConfig(kind, 32, 2, kind)
    fn, args, _ = dryrun.build_step(cfg, shape)
    on_meta = trace_cost(fn, *args)
    fn, _, _ = dryrun.build_step(cfg, shape)
    on_cpu = trace_cost(fn, *_on_cpu(args))
    for key in ("flops", "dot_flops", "bytes", "kernels"):
        assert on_cpu[key] == on_meta[key], key
    if cfg.moe is not None:
        assert set(on_meta["kernels"]) >= {"topk_gating", "load_histogram", "dispatch_gather"}
    if cfg.mamba is not None and kind != "decode":
        assert "ssd_state_scan" in on_meta["kernels"]
    if cfg.mamba is not None and kind == "train":
        assert on_meta["kernels"]["ssd_state_scan_bwd"]["calls"] > 0
