"""The plain PyTorch versions of the port's three kernels against the
Pallas kernels of ``repro`` (interpret mode, as ``tests/test_kernels.py``
runs them) and against the jnp oracles, at that file's shapes, on inputs
made with numpy and fed to both sides.

The CUDA kernels themselves cannot run without a GPU: they are built and
held against these same plain versions on the card by ``chip_smoke.py``.
What runs here is everything around them: the plain versions, the ``ops``
switch, the wrappers' argument checks and the launch counters.

The MoE combine has no Pallas kernel: its contract (``combine/ref.py``,
what the CUDA kernels compute) is held to the plain loop it replaced, the
forward and the slots' gradient bit for bit in float64 and float32, and
``combine`` on CPU tensors is that loop, gradients included.

Tolerances: top-k indices EQUAL and weights rtol 1e-5 / atol 1e-6 (those of
``tests/test_kernels.py``: float32 softmax sums differ in order);
histogram EQUAL (integer counts); dispatch EQUAL by value (pure data
movement) in float32 and bfloat16.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dispatch.kernel import dispatch_gather as j_dispatch_kernel
from repro.kernels.dispatch.ref import dispatch_gather_ref as j_dispatch_ref
from repro.kernels.histogram.kernel import load_histogram as j_hist_kernel
from repro.kernels.histogram.ref import load_histogram_ref as j_hist_ref
from repro.kernels.topk_gating.kernel import topk_gating as j_gating_kernel
from repro.kernels.topk_gating.ref import topk_gating_ref as j_gating_ref
from repro_torch import kernels as tk
from repro_torch.kernels.combine import kernel as t_combine_kernel
from repro_torch.kernels.combine import kernel_bwd as t_combine_bwd
from repro_torch.kernels.combine import ops as t_combine_ops
from repro_torch.kernels.combine import ref as t_combine_ref
from repro_torch.kernels.dispatch import kernel as t_dispatch_kernel
from repro_torch.kernels.dispatch import ops as t_dispatch_ops
from repro_torch.kernels.dispatch.ref import dispatch_gather_ref as t_dispatch_ref
from repro_torch.kernels.histogram import kernel as t_hist_kernel
from repro_torch.kernels.histogram import ops as t_hist_ops
from repro_torch.kernels.histogram.ref import load_histogram_ref as t_hist_ref
from repro_torch.kernels.ssd_scan import ops as t_ssd_ops
from repro_torch.kernels.topk_gating import kernel as t_gating_kernel
from repro_torch.kernels.topk_gating import ops as t_gating_ops
from repro_torch.kernels.topk_gating.ref import topk_gating_ref as t_gating_ref


def _to_torch(a: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TestDispatchPlain:
    @pytest.mark.parametrize("T,S,D", [(64, 128, 128), (256, 512, 256),
                                       (128, 64, 512), (32, 32, 128)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_and_oracle(self, T, S, D, dtype):
        rng = np.random.default_rng(T + S + D)
        x = rng.standard_normal((T, D)).astype(np.float32)
        src = rng.integers(0, T, S).astype(np.int32)
        valid = rng.random(S) < 0.8
        jx = jnp.asarray(x).astype(JDT[dtype])
        pallas = j_dispatch_kernel(jx, jnp.asarray(src), jnp.asarray(valid),
                                   block_s=32, block_d=128, interpret=True)
        oracle = j_dispatch_ref(jx, jnp.asarray(src), jnp.asarray(valid))
        out = t_dispatch_ops.dispatch(
            _to_torch(x, TDT[dtype]), _to_torch(src), _to_torch(valid)
        )
        assert out.dtype == TDT[dtype] and out.shape == (S, D)
        np.testing.assert_array_equal(_f32(out), np.asarray(pallas, np.float32))
        np.testing.assert_array_equal(_f32(out), np.asarray(oracle, np.float32))

    def test_all_invalid_is_zero(self):
        out = t_dispatch_ref(torch.ones(16, 128), torch.zeros(32, dtype=torch.int32),
                             torch.zeros(32, dtype=torch.bool))
        assert float(out.abs().max()) == 0.0

    @pytest.mark.parametrize("valid_dtype", [torch.bool, torch.int32, torch.float32])
    def test_valid_of_any_type(self, valid_dtype):
        rng = np.random.default_rng(0)
        x = _to_torch(rng.standard_normal((8, 16)).astype(np.float32))
        src = _to_torch(rng.integers(0, 8, 12).astype(np.int32))
        valid = _to_torch(rng.random(12) < 0.5)
        want = t_dispatch_ref(x, src, valid)
        assert torch.equal(t_dispatch_ref(x, src, valid.to(valid_dtype)), want)

    def test_reproduces_moe_buffer(self):
        """The buffer ``repro``'s MoE layer builds with take_along_axis."""
        T, D, E, C = 64, 128, 8, 16
        rng = np.random.default_rng(3)
        x = rng.standard_normal((T, D)).astype(np.float32)
        src = rng.integers(0, T, E * C).astype(np.int32)
        valid = rng.random(E * C) < 0.7
        jx = jnp.asarray(x)
        jbuf = jnp.take_along_axis(jx[None], jnp.asarray(src)[None, :, None], axis=1)[0]
        jbuf = jbuf * jnp.asarray(valid)[:, None]
        out = t_dispatch_ops.dispatch(_to_torch(x), _to_torch(src), _to_torch(valid))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jbuf))


class TestHistogramPlain:
    @pytest.mark.parametrize("N,E", [(256, 8), (1024, 64), (2048, 384),
                                     (4096, 32)])
    def test_matches_pallas_and_oracle(self, N, E):
        ids = np.random.default_rng(N + E).integers(0, E, N).astype(np.int32)
        pallas = j_hist_kernel(jnp.asarray(ids), num_dest=E, block_n=256, interpret=True)
        oracle = j_hist_ref(jnp.asarray(ids), E)
        out = t_hist_ops.histogram(_to_torch(ids), E)
        assert out.dtype == torch.float32 and out.shape == (E,)
        np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(out.numpy(), np.asarray(oracle))
        assert float(out.sum()) == N

    def test_skewed_distribution(self):
        ids = torch.cat([torch.zeros(900, dtype=torch.int32),
                         torch.ones(124, dtype=torch.int32)])
        out = t_hist_ref(ids, 16)
        assert float(out[0]) == 900 and float(out[1]) == 124

    def test_ids_out_of_range_count_nowhere(self):
        """As the Pallas kernel's one-hot compare ignores them."""
        ids = np.array([0, 3, -1, 4, 7, 3, 100], np.int32)
        pallas = j_hist_kernel(jnp.asarray(ids), num_dest=4, block_n=7, interpret=True)
        out = t_hist_ref(_to_torch(ids), 4)
        np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(out.numpy(), [1, 0, 0, 2])

    @pytest.mark.parametrize("N", [1, 7, 1000])
    def test_sizes_that_divide_nothing(self, N):
        ids = np.random.default_rng(N).integers(0, 5, N).astype(np.int32)
        np.testing.assert_array_equal(
            t_hist_ref(_to_torch(ids), 5).numpy(), np.bincount(ids, minlength=5)
        )


class TestTopkGatingPlain:
    @pytest.mark.parametrize("T,E,k", [(128, 8, 2), (256, 64, 4),
                                       (512, 384, 8), (64, 16, 1)])
    def test_matches_pallas_and_oracle(self, T, E, k):
        logits = np.random.default_rng(T + E + k).standard_normal((T, E)).astype(np.float32)
        pw, pidx = j_gating_kernel(jnp.asarray(logits), k=k, block_t=64, interpret=True)
        ow, oidx = j_gating_ref(jnp.asarray(logits), k)
        w, idx = t_gating_ops.gating(_to_torch(logits), k)
        assert w.dtype == torch.float32 and idx.dtype == torch.int32
        assert w.shape == idx.shape == (T, k)
        for rw, ridx in ((pw, pidx), (ow, oidx)):
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
            np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-5, atol=1e-6)

    def test_bfloat16_logits(self):
        logits = np.random.default_rng(5).standard_normal((96, 32)).astype(np.float32)
        jl = jnp.asarray(logits).astype(jnp.bfloat16)
        ow, oidx = j_gating_ref(jl, 8)
        w, idx = t_gating_ref(_to_torch(logits, torch.bfloat16), 8)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(oidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(ow), rtol=1e-5, atol=1e-6)

    def test_ties_go_to_the_lower_index(self):
        """``jax.lax.top_k`` and the Pallas argmax both send a tie to the
        lower index; ``torch.topk`` promises nothing, so the plain version
        sorts stably."""
        logits = np.zeros((4, 16), np.float32)
        logits[1, [3, 9, 12]] = 2.0          # three-way tie at the top
        logits[2, :] = np.repeat(np.arange(8, dtype=np.float32), 2)  # pairs
        logits[3, 15] = 1.0
        pw, pidx = j_gating_kernel(jnp.asarray(logits), k=4, block_t=4, interpret=True)
        _, oidx = j_gating_ref(jnp.asarray(logits), 4)
        w, idx = t_gating_ref(_to_torch(logits), 4)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(oidx))
        np.testing.assert_array_equal(idx[0].numpy(), [0, 1, 2, 3])
        np.testing.assert_array_equal(idx[1].numpy(), [3, 9, 12, 0])
        np.testing.assert_array_equal(idx[2].numpy(), [14, 15, 12, 13])
        np.testing.assert_allclose(w.numpy(), np.asarray(pw), rtol=1e-5, atol=1e-6)

    def test_weights_normalized(self):
        logits = _to_torch(np.random.default_rng(0).standard_normal((128, 32)).astype(np.float32))
        w, _ = t_gating_ref(logits, 4)
        np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)

    def test_rows_need_not_fill_a_block(self):
        """The Pallas kernel asserts T % block_t == 0; the port has no
        such restriction."""
        logits = np.random.default_rng(1).standard_normal((37, 24)).astype(np.float32)
        _, oidx = j_gating_ref(jnp.asarray(logits), 3)
        _, idx = t_gating_ref(_to_torch(logits), 3)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(oidx))


class TestWrappers:
    """CPU tensors take the plain version; the launch wrappers take only
    GPU tensors and raise on anything else; nothing counts as a launch."""

    def test_cpu_tensors_never_count_as_launches(self):
        tk.reset_launch_counts()
        t_gating_ops.gating(torch.zeros(4, 8), 2)
        t_hist_ops.histogram(torch.zeros(4, dtype=torch.int32), 8)
        t_dispatch_ops.dispatch(torch.zeros(4, 8), torch.zeros(2, dtype=torch.int32),
                                torch.ones(2, dtype=torch.bool))
        states = torch.zeros(2, 3, 4, 4, requires_grad=True)
        t_ssd_ops.state_scan(states, torch.ones(2, 3)).sum().backward()
        assert states.grad is not None
        y_flat = torch.zeros(6, 8, requires_grad=True)
        t_combine_ops.combine(y_flat, torch.tensor([[0, 6], [5, 1]], dtype=torch.int32),
                              torch.ones(2, 2)).sum().backward()
        assert y_flat.grad is not None
        assert tk.launch_counts() == {
            "topk_gating": 0, "load_histogram": 0, "dispatch_gather": 0,
            "ssd_state_scan": 0, "ssd_state_scan_bwd": 0,
            "moe_combine": 0, "moe_combine_bwd": 0,
        }

    def test_reset_launch_counts(self):
        t_gating_kernel.launches = 5
        assert tk.launch_counts()["topk_gating"] == 5
        tk.reset_launch_counts()
        assert tk.launch_counts()["topk_gating"] == 0

    def test_gating_kernel_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="GPU"):
            t_gating_kernel.topk_gating(torch.zeros(4, 8), k=2)

    def test_histogram_kernel_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="GPU"):
            t_hist_kernel.load_histogram(torch.zeros(4, dtype=torch.int32), num_dest=8)

    def test_dispatch_kernel_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="GPU"):
            t_dispatch_kernel.dispatch_gather(
                torch.zeros(4, 8), torch.zeros(2, dtype=torch.int32),
                torch.ones(2, dtype=torch.bool),
            )

    def test_combine_kernels_refuse_cpu_tensors(self):
        y_flat, slot, w = torch.zeros(6, 8), torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, 2)
        with pytest.raises(ValueError, match="GPU"):
            t_combine_kernel.moe_combine(y_flat, slot, w)
        with pytest.raises(ValueError, match="GPU"):
            t_combine_bwd.moe_combine_bwd(torch.zeros(2, 8), y_flat, slot, w)

    @pytest.mark.parametrize("bad,error", [
        (dict(y_flat=torch.zeros(6)), ValueError),
        (dict(slot=torch.zeros(2, dtype=torch.int32)), ValueError),
        (dict(w=torch.ones(2, 3)), ValueError),
        (dict(y_flat=torch.zeros(6, 8, dtype=torch.float16)), TypeError),
        (dict(slot=torch.zeros(2, 2, dtype=torch.int64)), TypeError),
        (dict(w=torch.ones(2, 2, dtype=torch.bfloat16)), TypeError),
        (dict(slot=torch.zeros(2, 33, dtype=torch.int32), w=torch.ones(2, 33)), ValueError),
        (dict(y_flat=torch.zeros(6, 0)), ValueError),
        (dict(dy=torch.zeros(3, 8)), ValueError),
        (dict(dy=torch.zeros(2, 8, dtype=torch.bfloat16)), ValueError),
    ], ids=["y_flat_1d", "slot_1d", "w_shape", "y_flat_fp16", "slot_int64", "w_bf16", "k33",
            "empty_rows", "dy_shape", "dy_type"])
    def test_combine_kernels_check_shapes_and_types(self, bad, error):
        """Shapes and types are checked before the device, so each is
        refused here with CPU tensors; dy only by the backward."""
        args = dict(y_flat=torch.zeros(6, 8), slot=torch.zeros(2, 2, dtype=torch.int32),
                    w=torch.ones(2, 2), dy=torch.zeros(2, 8))
        args.update(bad)
        with pytest.raises(error):
            t_combine_bwd.moe_combine_bwd(args["dy"], args["y_flat"], args["slot"], args["w"])
        if "dy" not in bad:
            with pytest.raises(error):
                t_combine_kernel.moe_combine(args["y_flat"], args["slot"], args["w"])

    def test_loader_is_not_imported_with_the_package(self):
        """Importing the kernels must not build or load anything: the
        loader is imported inside the launch wrappers."""
        import os
        import pathlib
        import subprocess
        import sys
        src = pathlib.Path(__file__).resolve().parents[1] / "src"
        code = (
            "import sys, repro_torch.kernels, repro_torch.models.layers.moe,"
            " repro_torch.models.layers.mamba2;"
            "assert 'repro_torch.kernels._loader' not in sys.modules"
        )
        subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(src)))

    def test_sources_exist_for_every_kernel(self):
        from repro_torch.kernels import _loader
        assert [p.name for p in _loader.sources()] == [
            "combine.cu", "dispatch.cu", "histogram.cu", "ssd_state_scan.cu", "topk_gating.cu",
        ]
        for path in _loader.sources():
            text = path.read_text()
            assert 'extern "C" int dyskew_' in text and "<<<" in text


def _csrc_constant(source: str, name: str) -> int:
    import re

    from repro_torch.kernels import _loader
    text = (_loader.CSRC_DIR / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


class TestLaunchShapes:
    """The launch shapes the wrappers hand the redesigned kernels are
    computed in Python, so that they can be checked here without a card."""

    @pytest.mark.parametrize("E", [1, 32, 12288])
    @pytest.mark.parametrize("N", [0, 1, 64, 8191, 8192, 8193, 32767, 32768, 32769,
                                   65536, 5000011])
    def test_histogram_launch_shape(self, N, E):
        blocks, threads = t_hist_kernel.launch_shape(N, E)
        assert threads % 32 == 0 and 32 <= threads <= t_hist_kernel.MAX_THREADS
        if N <= t_hist_kernel.SINGLE_BLOCK_MAX:
            # One block, a thread for every 16-byte vector of ids or every
            # bin, up to 1024.
            assert blocks == 1
            assert threads * 4 >= min(N, 4 * t_hist_kernel.MAX_THREADS)
            assert threads >= min(E, t_hist_kernel.MAX_THREADS)
        else:
            assert 2 <= blocks <= t_hist_kernel.MAX_CLUSTER <= 16
            assert threads == t_hist_kernel.MAX_THREADS
        # Never more blocks than the ids need.
        assert (blocks - 1) * t_hist_kernel.IDS_PER_CLUSTER_BLOCK < max(N, 1)

    def test_histogram_limits_match_the_source(self):
        assert _csrc_constant("histogram.cu", "kMaxDest") == t_hist_kernel.MAX_DEST
        assert _csrc_constant("histogram.cu", "kMaxThreads") == t_hist_kernel.MAX_THREADS
        assert t_hist_kernel.MAX_CLUSTER <= _csrc_constant("histogram.cu", "kMaxCluster")

    @pytest.mark.parametrize("sm_count", [1, 132])
    @pytest.mark.parametrize("S", [1, 7, 8, 9, 128, 4224, 163840, 10_000_019])
    def test_dispatch_launch_blocks(self, S, sm_count):
        blocks = t_dispatch_kernel.launch_blocks(S, sm_count)
        warps = t_dispatch_kernel.WARPS_PER_BLOCK
        assert 1 <= blocks <= sm_count * t_dispatch_kernel.BLOCKS_PER_SM
        # Never a block whose warps all find no slot ...
        assert (blocks - 1) * warps < S
        # ... and every slot has a warp in the first round, where the grid allows.
        if S <= sm_count * t_dispatch_kernel.BLOCKS_PER_SM * warps:
            assert blocks * warps >= S

    def test_dispatch_grid_matches_the_source(self):
        assert _csrc_constant("dispatch.cu", "kWarpsPerBlock") == t_dispatch_kernel.WARPS_PER_BLOCK
        assert _csrc_constant("dispatch.cu", "kMinBlocksPerSm") == t_dispatch_kernel.BLOCKS_PER_SM

    @pytest.mark.parametrize("sm_count", [1, 132])
    @pytest.mark.parametrize("row_bytes", [14, 2048, 4096, 14336])
    @pytest.mark.parametrize("T", [0, 1, 8, 64, 8192, 65536])
    def test_combine_launch_shape(self, T, row_bytes, sm_count):
        """The widest piece (vectors a lane) that still gives every SM
        ``WARPS_PER_SM`` warps, else one vector a lane."""
        k = t_combine_kernel
        u = k.launch_shape(T, row_bytes, sm_count)
        vecs = -(-row_bytes // 16)

        def warps(width):
            return T * -(-vecs // (32 * width))

        assert u in (1, 2, 4)
        if u > 1:
            assert warps(u) >= sm_count * k.WARPS_PER_SM
        if u < 4:
            assert warps(u * 2) < sm_count * k.WARPS_PER_SM

    def test_combine_launch_shape_on_the_main_path(self):
        """granite's train step and serve prefill take 2 KB pieces, a
        decode step of 64 tokens the narrowest, on the H100's 132 SMs."""
        k = t_combine_kernel
        assert k.launch_shape(8192, 2048, 132) == 4
        assert k.launch_shape(65536, 2048, 132) == 4
        assert k.launch_shape(64, 2048, 132) == 1
        assert k.launch_shape(8192, 14336, 132) == 4

    def test_combine_constants_match_the_source(self):
        assert _csrc_constant("combine.cu", "kWarpsPerBlock") == t_combine_kernel.WARPS_PER_BLOCK
        assert _csrc_constant("combine.cu", "kMaxTopK") == t_combine_kernel.MAX_TOP_K
        assert _csrc_constant("combine.cu", "kZeroRows") == t_combine_bwd.ZERO_ROWS
        assert _csrc_constant("combine.cu", "kWarp") == t_combine_kernel.WARP

    @pytest.mark.parametrize("k", [1, 2, 3, 8, 32])
    @pytest.mark.parametrize("element_size", [2, 4])
    @pytest.mark.parametrize("E", [4, 5, 8, 16, 32, 64, 100, 128, 256, 384, 512])
    def test_gating_launch_shape(self, E, element_size, k):
        g = t_gating_kernel
        whole_vectors = {16 << i for i in range(6)}   # 1, 2, 4, ..., 32 vectors
        for aligned in (True, False):
            path, lanes = g.launch_shape(E, k, element_size, aligned)
            assert 32 % lanes == 0
            group = (aligned and k in (1, 2, 4, 8)
                     and E * element_size in whole_vectors)
            if group:
                # G lanes of one 16-byte vector each hold the row exactly.
                assert path == g.PATH_GROUP
                assert lanes * (16 // element_size) == E
            else:
                # One warp a row, at most 16 values a lane (the source's
                # largest VPL).
                assert (path, lanes) == (g.PATH_WARP, 32)
                assert lanes * 16 >= E

    def test_gating_constants_match_the_source(self):
        import re

        from repro_torch.kernels import _loader
        g = t_gating_kernel
        assert _csrc_constant("topk_gating.cu", "kWarp") == g.WARP
        assert _csrc_constant("topk_gating.cu", "kVectorBytes") == g.VECTOR_BYTES
        assert _csrc_constant("topk_gating.cu", "kMaxGroupK") == max(g.GROUP_KS)
        assert _csrc_constant("topk_gating.cu", "kPathWarp") == g.PATH_WARP
        assert _csrc_constant("topk_gating.cu", "kPathGroup") == g.PATH_GROUP
        assert _csrc_constant("topk_gating.cu", "kMaxExperts") == g.MAX_EXPERTS
        assert _csrc_constant("topk_gating.cu", "kMaxK") == g.MAX_K
        # The instantiations the entry point switches over: every k of
        # GROUP_KS, and G = 1, 2, 4, ..., 32.
        text = (_loader.CSRC_DIR / "topk_gating.cu").read_text()

        def value(tok):
            return int(tok) if tok.isdigit() else _csrc_constant("topk_gating.cu", tok)

        ks = {value(t) for t in re.findall(r"launch_group<T, G, (\w+)>", text)}
        lanes = {value(t) for t in re.findall(r"launch_group_k<T, (\w+)>", text)}
        assert ks == set(g.GROUP_KS)
        assert lanes == {1, 2, 4, 8, 16, 32}

    @pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 32])
    @pytest.mark.parametrize("T", [0, 1, 7, 8191])
    def test_gating_output_views(self, T, k):
        """The wrapper's one allocation, on the CPU: the kernel writes the
        weights' bits to words [0, T*k) and the ids to [T*k, 2*T*k)."""
        buf, w, idx = t_gating_kernel.output_views(T, k, "cpu")
        assert buf.shape == (2, T, k) and buf.dtype == torch.int32
        assert w.shape == (T, k) and w.dtype == torch.float32 and w.is_contiguous()
        assert idx.shape == (T, k) and idx.dtype == torch.int32 and idx.is_contiguous()
        assert w.data_ptr() == buf.data_ptr()
        assert idx.data_ptr() == buf.data_ptr() + T * k * 4
        rng = np.random.default_rng(T * 100 + k)
        want_w = rng.random((T, k), dtype=np.float32)
        want_i = rng.integers(0, 512, (T, k), dtype=np.int32)
        words = buf.view(-1).numpy()
        words[: T * k] = want_w.reshape(-1).view(np.int32)
        words[T * k:] = want_i.reshape(-1)
        np.testing.assert_array_equal(w.numpy(), want_w)
        np.testing.assert_array_equal(idx.numpy(), want_i)
        if k in t_gating_kernel.GROUP_KS:
            # The group path stores min(k, 4) words at once: the ids' offset
            # keeps that alignment for every T (the source checks it too).
            assert (T * k * 4) % (4 * min(k, 4)) == 0

    @pytest.mark.parametrize("name", sorted(tk._MODULES))
    def test_signature_matches_wrapper_and_source(self, name):
        """``_loader._SIGNATURES`` lists, for each entry point, the arguments
        its wrapper passes plus the stream, and as many as the C function
        declares.  Read from the sources, nothing built."""
        import ast
        import inspect
        import re

        from repro_torch.kernels import _loader

        tree = ast.parse(inspect.getsource(tk._MODULES[name]))
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute) and n.func.attr == "launch"
                 and isinstance(n.func.value, ast.Name) and n.func.value.id == "_loader"]
        assert len(calls) == 1
        call = calls[0]
        entry = call.args[0].value
        passed = 0
        for arg in call.args[2:]:
            if isinstance(arg, ast.Starred):
                # A starred tuple-returning helper: count what it returns.
                helper = getattr(tk._MODULES[name], arg.value.func.id)
                passed += len(helper(*([1] * len(arg.value.args))))
            else:
                passed += 1
        sig = _loader._SIGNATURES[entry]
        assert passed + 1 == len(sig)
        assert sig[-1] is ctypes.c_void_p
        text = "\n".join(p.read_text() for p in _loader.sources())
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
        assert len(params.split(",")) == len(sig)


def _combine_inputs(seed, T=12, k=4, S=40, d=24, dtype=torch.float64):
    """A combine's inputs as a routing plan makes them: every kept pick owns
    a slot of its own, the rest are dropped (slot S).  Token 0 has all its
    picks dropped, and slot S - 1 is kept by a pick, so the plain loop's
    clamp sends every dropped pick onto a row that is also kept."""
    rng = np.random.default_rng(seed)
    keep = rng.random((T, k)) < 0.6
    keep[0] = False
    keep[1, 0] = True
    n = int(keep.sum())
    assert n < S
    slots = rng.permutation(S - 1)[:n - 1]
    slot = np.full((T, k), S, dtype=np.int32)
    slot[keep] = np.concatenate([[S - 1], slots])
    y_flat = torch.from_numpy(rng.standard_normal((S, d))).to(dtype)
    w = torch.from_numpy(rng.random((T, k))).to(torch.float64 if dtype == torch.float64 else torch.float32)
    dy = torch.from_numpy(rng.standard_normal((T, d))).to(dtype)
    return y_flat, torch.from_numpy(slot), w, dy


def _loop_grads(y_flat, slot, w, dy):
    yf, ww = y_flat.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = t_combine_ref.moe_combine_ref(yf, slot, ww)
    return (y.detach(),) + torch.autograd.grad(y, (yf, ww), dy)


class TestCombinePlain:
    """The kernels' contract (``combine/ref.py``) against the plain loop the
    port has always run, and the CPU path of ``combine`` against that
    loop."""

    @pytest.mark.parametrize("seed", range(3))
    def test_contract_equals_the_loop_in_float64(self, seed):
        """Forward and the slots' gradient the same bits; the weights'
        gradient (a dot product, summed in another order) to 1e-12."""
        y_flat, slot, w, dy = _combine_inputs(seed)
        y_loop, d_yf_loop, d_w_loop = _loop_grads(y_flat, slot, w, dy)
        assert torch.equal(t_combine_ref.moe_combine_contract(y_flat, slot, w), y_loop)
        d_yf, d_w = t_combine_ref.moe_combine_bwd_ref(dy, y_flat, slot, w)
        assert d_yf.dtype == torch.float64 and d_w.dtype == torch.float64
        assert torch.equal(d_yf, d_yf_loop)
        np.testing.assert_allclose(d_w.numpy(), d_w_loop.numpy(), rtol=1e-12, atol=1e-12)
        kept = slot.numpy() < y_flat.shape[0]
        assert not kept[0].any() and (d_w[0] == 0).all() and (y_loop[0] == 0).all()
        # A slot no pick owns gets a zero gradient.
        owned = np.zeros(y_flat.shape[0], bool)
        owned[slot.numpy()[kept]] = True
        assert (d_yf[torch.from_numpy(~owned)] == 0).all()

    @pytest.mark.parametrize("seed", range(3))
    def test_contract_is_the_loop_in_float32(self, seed):
        y_flat, slot, w, dy = _combine_inputs(seed, dtype=torch.float32)
        y_loop, d_yf_loop, d_w_loop = _loop_grads(y_flat, slot, w, dy)
        assert torch.equal(t_combine_ref.moe_combine_contract(y_flat, slot, w), y_loop)
        d_yf, d_w = t_combine_ref.moe_combine_bwd_ref(dy, y_flat, slot, w)
        assert torch.equal(d_yf, d_yf_loop)
        np.testing.assert_allclose(d_w.numpy(), d_w_loop.numpy(), rtol=1e-5, atol=1e-5)

    def test_contract_rounds_once_in_bfloat16(self):
        """bfloat16: the sum in float32, rounded once; autograd through the
        contract gives the slots' gradient the backward formula's bits."""
        y_flat, slot, w, dy = _combine_inputs(5, dtype=torch.bfloat16)
        y = t_combine_ref.moe_combine_contract(y_flat, slot, w)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, t_combine_ref.moe_combine_contract(y_flat.float(), slot, w).bfloat16())
        yf = y_flat.clone().requires_grad_(True)
        d_yf_auto, = torch.autograd.grad(t_combine_ref.moe_combine_contract(yf, slot, w), (yf,), dy)
        d_yf, d_w = t_combine_ref.moe_combine_bwd_ref(dy, y_flat, slot, w)
        assert d_yf.dtype == torch.bfloat16 and d_w.dtype == torch.float32
        assert torch.equal(d_yf_auto, d_yf)
        # The loop rounds every product and sum to bfloat16: near, not equal.
        y_loop = t_combine_ref.moe_combine_ref(y_flat, slot, w)
        assert float((y.float() - y_loop.float()).abs().max()) <= 2.0 ** -5 * float(y.float().abs().max())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_combine_is_the_loop_bit_for_bit(self, dtype):
        """``combine`` on CPU tensors: the loop's output and, through the
        ``autograd.Function``, the loop's own gradients, bit for bit."""
        y_flat, slot, w, dy = _combine_inputs(9, dtype=dtype)
        y_loop, d_yf_loop, d_w_loop = _loop_grads(y_flat, slot, w, dy)
        yf, ww = y_flat.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = t_combine_ops.combine(yf, slot, ww)
        d_yf, d_w = torch.autograd.grad(y, (yf, ww), dy)
        for got, want in ((y, y_loop), (d_yf, d_yf_loop), (d_w, d_w_loop)):
            assert got.dtype == want.dtype and torch.equal(got, want)
