"""The Mamba-2 slice of the port against ``repro``, on the CPU, on inputs made
with numpy from a seed and fed to both sides: the plain state scan against
the Pallas ``ssd_state_scan`` (interpret mode, as ``tests/test_kernels.py``
runs it) and its jnp oracle; ``ssd_chunked`` and ``mamba_apply`` against the
reference layer; reduced ``mamba2-1.3b`` and reduced ``jamba-1.5-large-398b``
served through the port against the reference.

The gradients too: ``StateScan`` (the scan's ``autograd.Function``) against
``jax.vjp`` of the reference's jnp scan and against autograd through the
plain scan, and ``ssd_chunked``'s and ``mamba_apply``'s gradients in every
input and parameter against ``jax.vjp`` of the reference layer, which
differentiates its ``lax.scan`` over chunks.

The CUDA kernels themselves need a GPU: ``chip_smoke.py`` builds them and
holds them against the same plain versions on the card.  Here the ``ops``
switch sends CPU tensors to the plain versions, and the wrappers' argument
checks and launch counters are what runs of the kernel modules.

Tolerances, each with its reason:
- plain scan: rtol 1e-5 / atol 1e-5, those of ``tests/test_kernels.py`` (the
  reference's XLA may contract the multiply-add; the port rounds both);
- ``ssd_chunked``, ``mamba_apply``: rtol 1e-5 / atol 1e-5 on values of
  magnitude 1-30.  The port runs the chunked SSD in four stages over all
  chunks where the reference runs one fused body per chunk, and it folds the
  input weights into ``x`` rather than into ``B``: the same float32
  products, summed in another order;
- the scan's gradients against the reference's vjp: ``d_states`` rtol 1e-5
  / atol 1e-5, as the scan (the adjoint is the same recurrence run
  backwards), one bfloat16 step (rtol 2^-8) for bfloat16 states, whose
  gradient is rounded to bfloat16 from float32 values that differ in the
  last bits; ``d_decay`` rtol 1e-5 and an absolute 1e-5 of its largest
  element, a sum over the P * N plane in another order.  Against autograd
  through the plain scan: EQUAL, the multiply and the add rounded one by
  one on both sides;
- ``ssd_chunked``'s and ``mamba_apply``'s gradients: max |Δ| <= 5e-5 of
  the leaf's largest |gradient| (measured: 1.5e-6 for ``ssd_chunked``,
  7.9e-6 for ``mamba_apply``, whose gradients also pass the gated norm and
  the projections).  The forward's reasons, carried through the backward's
  products;
- the grad arm of ``ssd_chunked`` against its no-grad arm: EQUAL (the same
  operations, out of place);
- the served slice, ``mamba2-1.3b`` and ``jamba-1.5-large-398b`` reduced,
  float32: logits rtol 2e-4 / atol 2e-5 (two to eight layers of float32
  products taken in another order, compounding through the residual
  stream), greedy tokens and the position EQUAL, as in
  ``tests/test_torch_serve.py``.  ``mamba2-1.3b`` ties its unit-scale
  embeddings to the head, which gives logits of magnitude 30 here (jamba's
  untied 0.02-scale head gives 0.5): its absolute band is 3e-4, 1e-5 of
  that magnitude, as ``test_dense_model_matches_the_reference`` scales its
  band for the same reason.  SSM states and conv windows after decode:
  rtol 2e-4, atol 1e-5 of the largest element (the states are sums over the
  prompt and reach 250 here);
- the port's own decode against its full forward: rtol 2e-2 / atol 2e-3,
  the band of ``tests/test_arch_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_config as j_get_config
from repro.kernels.ssd_scan.kernel import ssd_state_scan as j_scan_kernel
from repro.kernels.ssd_scan.ref import ssd_state_scan_ref as j_scan_ref
from repro.models.layers import mamba2 as j_mamba2
from repro.models.layers.moe import SpmdCtx as JCtx
from repro.models.model_api import build as j_build
from repro.train.step import make_decode_step as j_make_decode_step
from repro.train.step import make_prefill_step as j_make_prefill_step
from repro_torch import kernels as tk
from repro_torch.config.base import get_config as t_get_config
from repro_torch.kernels.ssd_scan import kernel as t_scan_kernel
from repro_torch.kernels.ssd_scan import kernel_bwd as t_scan_bwd_kernel
from repro_torch.kernels.ssd_scan import ops as t_scan_ops
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_bwd_ref as t_scan_bwd_ref
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref as t_scan_ref
from repro_torch.models import transformer as t_transformer
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.layers import mamba2 as t_mamba2
from repro_torch.models.layers import moe as t_moe
from repro_torch.models.layers.moe import SpmdCtx as TCtx
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import tree_leaves
from repro_torch.train.step import make_decode_step as t_make_decode_step
from repro_torch.train.step import make_prefill_step as t_make_prefill_step

LAYER_GRAD_TOL = 5e-5      # of the largest |gradient| of a leaf; see the module docstring
MAMBA = "mamba2-1.3b"
JAMBA = "jamba-1.5-large-398b"
BATCH, DECODE = 2, 3
SEQ = 96           # three chunks of the reduced configs' chunk of 32
N_EP = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------- #
# The plain state scan
# --------------------------------------------------------------------- #


def _scan_inputs(C, H, P, N, seed):
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((C, H, P, N)).astype(np.float32)
    decay = (1.0 / (1.0 + np.exp(-rng.standard_normal((C, H))))).astype(np.float32)  # (0, 1)
    return states, decay


class TestScanPlain:
    @pytest.mark.parametrize("C,H,P,N", [(8, 8, 16, 16), (16, 16, 64, 32),
                                         (32, 8, 64, 128), (1, 8, 16, 16)])
    def test_matches_pallas_and_oracle(self, C, H, P, N):
        states, decay = _scan_inputs(C, H, P, N, C * H + P + N)
        pallas = j_scan_kernel(jnp.asarray(states), jnp.asarray(decay),
                               block_h=4, block_p=16, interpret=True)
        oracle = j_scan_ref(jnp.asarray(states), jnp.asarray(decay))
        out = t_scan_ops.state_scan(_t(states), _t(decay))
        assert out.dtype == torch.float32 and out.shape == (C, H, P, N)
        for ref in (pallas, oracle):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        assert float(out[0].abs().max()) == 0.0

    def test_bfloat16_states(self):
        states, decay = _scan_inputs(8, 8, 16, 16, 7)
        js = jnp.asarray(states).astype(jnp.bfloat16)
        pallas = j_scan_kernel(js, jnp.asarray(decay), block_h=4, block_p=16, interpret=True)
        oracle = j_scan_ref(js, jnp.asarray(decay))
        out = t_scan_ref(_t(states, torch.bfloat16), _t(decay))
        assert out.dtype == torch.float32
        for ref in (pallas, oracle):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_composes_with_the_chunk_recurrence(self):
        """As ``TestSsdScanConsistency``: the prefix feeds the recurrence."""
        states, _ = _scan_inputs(8, 4, 8, 8, 0)
        prefix = t_scan_ref(_t(states), torch.full((8, 4), 0.9))
        h = np.zeros((4, 8, 8), np.float32)
        for c in range(8):
            np.testing.assert_allclose(prefix[c].numpy(), h, rtol=1e-5, atol=1e-6)
            h = h * np.float32(0.9) + states[c]

    def test_decays_of_zero_and_one(self):
        """Decay 0 forgets everything before the chunk; decay 1 sums."""
        states = torch.ones((5, 2, 3, 3))
        decay = torch.tensor([[0.0, 1.0]] * 5)
        out = t_scan_ref(states, decay)
        np.testing.assert_array_equal(out[:, 0, 0, 0].numpy(), [0, 1, 1, 1, 1])
        np.testing.assert_array_equal(out[:, 1, 0, 0].numpy(), [0, 1, 2, 3, 4])

    def test_any_shape(self):
        """The Pallas kernel asserts H % block_h == 0 and P % block_p == 0;
        the port has no such restriction."""
        states, decay = _scan_inputs(3, 5, 7, 3, 11)
        oracle = j_scan_ref(jnp.asarray(states), jnp.asarray(decay))
        np.testing.assert_allclose(t_scan_ref(_t(states), _t(decay)).numpy(),
                                   np.asarray(oracle), rtol=1e-5, atol=1e-5)


class TestScanWrapper:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        tk.reset_launch_counts()
        states, decay = _scan_inputs(4, 2, 3, 4, 1)
        out = t_scan_ops.state_scan(_t(states), _t(decay))
        assert torch.equal(out, t_scan_ref(_t(states), _t(decay)))
        assert tk.launch_counts()["ssd_state_scan"] == 0

    def test_kernel_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="GPU"):
            t_scan_kernel.ssd_state_scan(torch.zeros(2, 3, 4, 4), torch.ones(2, 3))

    @pytest.mark.parametrize("states,decay,error", [
        (torch.zeros(2, 3, 4), torch.ones(2, 3), ValueError),          # not 4-D
        (torch.zeros(2, 3, 4, 4), torch.ones(3, 2), ValueError),       # decay shape
        (torch.zeros(2, 3, 4, 4, dtype=torch.float16), torch.ones(2, 3), TypeError),
        (torch.zeros(2, 3, 4, 4), torch.ones(2, 3, dtype=torch.int32), TypeError),
        (torch.zeros(2, 4, 4, 3).transpose(1, 3), torch.ones(2, 3), ValueError),  # strided
    ])
    def test_kernel_refuses_what_it_does_not_take(self, states, decay, error):
        with pytest.raises(error):
            t_scan_kernel.ssd_state_scan(states, decay)


# --------------------------------------------------------------------- #
# The scan's backward
# --------------------------------------------------------------------- #

#: (C, H, P, N, states dtype): one chunk (nothing reaches an output), two,
#: the served chunk count, a ragged plane, bfloat16 states.
SCAN_GRAD_CASES = [(1, 4, 8, 16, "float32"), (2, 4, 8, 16, "float32"), (9, 8, 16, 32, "float32"),
                   (5, 3, 5, 7, "float32"), (9, 4, 16, 16, "bfloat16")]


def _scan_grad_inputs(C, H, P, N, seed):
    states, decay = _scan_inputs(C, H, P, N, seed)
    g = np.random.default_rng(seed + 1).standard_normal((C, H, P, N)).astype(np.float32)
    return states, decay, g


def _state_scan_grads(fn, states, decay, g):
    s, d = states.clone().requires_grad_(True), decay.clone().requires_grad_(True)
    out = fn(s, d)
    if not out.requires_grad:   # C = 1: the plain scan reaches no output from an input
        return torch.zeros_like(s), torch.zeros_like(d)
    return torch.autograd.grad(out, (s, d), torch.from_numpy(g))


class TestScanBackward:
    @pytest.mark.parametrize("C,H,P,N,dtype", SCAN_GRAD_CASES)
    def test_state_scan_grads_match_the_reference_vjp(self, C, H, P, N, dtype):
        states, decay, g = _scan_grad_inputs(C, H, P, N, C + H + P + N)
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        js = jnp.asarray(states).astype(jdt)
        _, vjp = jax.vjp(j_scan_ref, js, jnp.asarray(decay))
        jds, jdd = vjp(jnp.asarray(g))
        ds, dd = _state_scan_grads(t_scan_ops.state_scan, _t(states, tdt), _t(decay), g)
        assert ds.dtype == tdt and dd.dtype == torch.float32
        assert ds.shape == states.shape and dd.shape == decay.shape
        # The adjoint is the forward's recurrence run backwards: the scan's
        # tolerance.  bfloat16 gradients are held at one bfloat16 step.
        rtol = 1e-5 if dtype == "float32" else 2 ** -8
        np.testing.assert_allclose(ds.float().numpy(), np.asarray(jds.astype(jnp.float32)),
                                   rtol=rtol, atol=1e-5)
        # d_decay sums a plane of P * N products: another order of summation.
        np.testing.assert_allclose(dd.numpy(), np.asarray(jdd), rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(jdd).max()), 1.0))
        # d_decay[c] is live for 1 <= c <= C-2 only.
        assert (float(ds.float().abs().max()) > 0) == (C > 1)
        assert (float(dd.abs().max()) > 0) == (C > 2)
        # The last chunk reaches no output; d_decay[0] meets out[0] == 0.
        assert float(ds[-1].abs().max()) == 0 and float(dd[-1].abs().max()) == 0
        assert float(dd[0].abs().max()) == 0

    @pytest.mark.parametrize("C,H,P,N,dtype", SCAN_GRAD_CASES)
    def test_backward_equals_plain_autograd(self, C, H, P, N, dtype):
        """The hand-written backward (its plain version on the CPU) against
        autograd through the plain scan: the same bits, as the CUDA kernel
        must give for d_states."""
        states, decay, g = _scan_grad_inputs(C, H, P, N, 2 * C + H)
        tdt = getattr(torch, dtype)
        got = _state_scan_grads(t_scan_ops.state_scan, _t(states, tdt), _t(decay), g)
        want = _state_scan_grads(t_scan_ref, _t(states, tdt), _t(decay), g)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        out = t_scan_ref(_t(states), _t(decay))
        ds, dd = t_scan_bwd_ref(torch.from_numpy(g), out, _t(decay))
        assert ds.dtype == dd.dtype == torch.float32
        assert torch.equal(ds.to(tdt), got[0])

    def test_only_the_inputs_that_need_it_get_a_gradient(self):
        states, decay, g = _scan_grad_inputs(4, 2, 4, 4, 9)
        s = _t(states).requires_grad_(True)
        out = t_scan_ops.state_scan(s, _t(decay))
        (ds,) = torch.autograd.grad(out, (s,), torch.from_numpy(g))
        assert ds.shape == states.shape

    def test_backward_kernel_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="GPU"):
            t_scan_bwd_kernel.ssd_state_scan_bwd(torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4, 4),
                                                 torch.ones(2, 3))

    @pytest.mark.parametrize("g,out,decay,dtype,error", [
        (torch.zeros(2, 3, 4), torch.zeros(2, 3, 4), torch.ones(2, 3), torch.float32, ValueError),
        (torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4, 5), torch.ones(2, 3), torch.float32, ValueError),
        (torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4, 4), torch.ones(3, 2), torch.float32, ValueError),
        (torch.zeros(2, 3, 4, 4, dtype=torch.bfloat16), torch.zeros(2, 3, 4, 4), torch.ones(2, 3),
         torch.float32, TypeError),
        (torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4, 4), torch.ones(2, 3), torch.float16, TypeError),
        (torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4, 4), torch.ones(2, 3, dtype=torch.int32),
         torch.float32, TypeError),
        (torch.zeros(2, 4, 4, 3).transpose(1, 3), torch.zeros(2, 3, 4, 4), torch.ones(2, 3),
         torch.float32, ValueError),
    ])
    def test_backward_kernel_refuses_what_it_does_not_take(self, g, out, decay, dtype, error):
        with pytest.raises(error):
            t_scan_bwd_kernel.ssd_state_scan_bwd(g, out, decay, dtype)

    def test_state_scan_checks_its_inputs(self):
        with pytest.raises(ValueError, match="contiguous"):
            t_scan_ops.state_scan(torch.zeros(2, 4, 4, 3).transpose(1, 3), torch.ones(2, 3))
        with pytest.raises(ValueError, match="meta"):
            t_scan_ops.state_scan(torch.zeros(2, 3, 4, 4), torch.ones(2, 3, device="meta"))


# --------------------------------------------------------------------- #
# The layer
# --------------------------------------------------------------------- #


def _ssd_inputs(seed, B=2, S=48, H=4, P=8, G=2, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("chunk,groups,with_h0", [
    (16, 2, True), (16, 2, False), (8, 1, True), (12, 4, True),
])
def test_ssd_chunked_matches_the_reference(chunk, groups, with_h0):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(chunk + groups, G=groups)
    assert x.shape[1] // chunk >= 3
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = _t(h0) if with_h0 else None
    jy, jh = j_mamba2.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk, h0=jh0)
    ty, th = t_mamba2.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk, h0=th0)
    assert ty.shape == x.shape and th.shape == h0.shape and th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_ssd_chunked_runs_its_scan_once_over_all_chunks():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(3)
    calls = []

    def scan(states, decay):
        calls.append((tuple(states.shape), tuple(decay.shape)))
        return t_scan_ref(states, decay)

    want = t_mamba2.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), 16, h0=_t(h0))
    got = t_mamba2.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), 16, h0=_t(h0), scan=scan)
    # [h0, s_0, s_1, s_2] over batch * heads: one call, no copy in between.
    assert calls == [((4, 2 * 4, 8, 8), (4, 2 * 4))]
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def _rel_err(ref, got) -> float:
    """max |got - ref| over max |ref|."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("chunk,groups,with_h0", [
    (16, 2, True), (16, 2, False), (8, 1, True), (12, 4, True),
])
def test_ssd_chunked_gradients_match_the_reference(chunk, groups, with_h0):
    """Every input's gradient, through both outputs, against ``jax.vjp`` of
    ``repro``'s ``ssd_chunked``, on the grad arm (the scan as
    ``StateScan``)."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(chunk + groups + 1, G=groups)
    rng = np.random.default_rng(chunk * groups)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gh = rng.standard_normal(h0.shape).astype(np.float32)
    inputs = [x, dt, A, Bm, Cm] + ([h0] if with_h0 else [])

    def jfn(*args):
        return j_mamba2.ssd_chunked(*args[:5], chunk, h0=args[5] if with_h0 else None)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))

    live = [_t(a).requires_grad_(True) for a in inputs]
    ty, th = t_mamba2.ssd_chunked(*live[:5], chunk, h0=live[5] if with_h0 else None)
    tgrads = torch.autograd.grad((ty, th), live, (_t(gy), _t(gh)))
    for name, jg, tg in zip(("x", "dt", "A", "Bm", "Cm", "h0"), jgrads, tgrads):
        assert tg.shape == jg.shape, name
        assert _rel_err(jg, tg.numpy()) <= LAYER_GRAD_TOL, (name, _rel_err(jg, tg.numpy()))


def test_ssd_chunked_grad_arm_gives_the_forward_of_the_no_grad_arm():
    """The grad arm computes the same products out of place: its outputs
    equal the serving arm's bit for bit."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(5)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    with torch.no_grad():
        want = t_mamba2.ssd_chunked(*args, 16, h0=_t(h0))
    live = [a.clone().requires_grad_(True) for a in args]
    got = t_mamba2.ssd_chunked(*live, 16, h0=_t(h0))
    assert all(g.requires_grad for g in got)
    assert all(torch.equal(a, b.detach()) for a, b in zip(want, got))


def _mamba_cfg(get_config):
    return dataclasses.replace(get_config(MAMBA).reduced(), dtype="float32")


@pytest.fixture(scope="module")
def mamba_layer():
    jcfg, tcfg = _mamba_cfg(j_get_config), _mamba_cfg(t_get_config)
    from repro.models.param import tree_materialize as j_materialize
    jp = j_materialize(j_mamba2.mamba_specs(jcfg), jax.random.PRNGKey(3), jnp.float32)
    # Zero-initialised leaves get values, so that they count.
    rng = np.random.default_rng(4)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(jp["dt_bias"].shape), jnp.float32),
              A_log=jnp.asarray(0.5 * rng.standard_normal(jp["A_log"].shape), jnp.float32))
    return jcfg, tcfg, jp, params_from_numpy(_np(jp), device="cpu")


def _carried_state(cfg, seed):
    """A decode state as a prompt would leave it: nothing is zero."""
    one = j_mamba2.mamba_state_init(cfg, BATCH, jnp.float32)
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in one.items()}


@pytest.mark.parametrize("arm", ["stateless", "prefill_from_state", "decode"])
def test_mamba_apply_matches_the_reference(mamba_layer, arm):
    jcfg, tcfg, jp, tp = mamba_layer
    S = 1 if arm == "decode" else SEQ
    xin = np.random.default_rng(5).standard_normal((BATCH, S, jcfg.d_model)).astype(np.float32)
    state = None if arm == "stateless" else _carried_state(jcfg, 6)
    jy, jst = j_mamba2.mamba_apply(jp, jnp.asarray(xin), cfg=jcfg,
                                   state=None if state is None else jax.tree.map(jnp.asarray, state))
    tst_in = None if state is None else {k: _t(v) for k, v in state.items()}
    ty, tst = t_mamba2.mamba_apply(tp, _t(xin), cfg=tcfg, state=tst_in)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    if state is None:
        assert tst is None and jst is None
        return
    assert set(tst) == set(jst)
    for key in jst:
        assert tst[key].shape == jst[key].shape
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # The carried state is not mutated by the layer itself.
    for key, v in state.items():
        np.testing.assert_array_equal(tst_in[key].numpy(), v)


@pytest.mark.parametrize("arm", ["stateless", "prefill_from_state"])
def test_mamba_apply_gradients_match_the_reference(mamba_layer, arm):
    """Every parameter's gradient (``A_log``, ``dt_bias`` and ``w_dt``, which
    reach the loss only through the chunk decays, among them), the input's
    and, from a carried state, the state's, against ``jax.vjp`` of
    ``repro``'s ``mamba_apply``, with cotangents on every output."""
    jcfg, tcfg, jp, tp = mamba_layer
    rng = np.random.default_rng(11)
    xin = rng.standard_normal((BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    state = None if arm == "stateless" else _carried_state(jcfg, 12)
    gy = rng.standard_normal((BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    keys = sorted(jp)
    skeys = [] if state is None else sorted(state)
    gst = {k: rng.standard_normal(state[k].shape).astype(np.float32) for k in skeys}

    def jfn(params, x, st):
        y, new = j_mamba2.mamba_apply(params, x, cfg=jcfg, state=st)
        return y, new
    _, vjp = jax.vjp(jfn, jp, jnp.asarray(xin),
                     None if state is None else jax.tree.map(jnp.asarray, state))
    jgp, jgx, jgs = vjp((jnp.asarray(gy), None if state is None else jax.tree.map(jnp.asarray, gst)))

    live_p = {k: tp[k].detach().clone().requires_grad_(True) for k in keys}
    live_x = _t(xin).requires_grad_(True)
    live_s = None if state is None else {k: _t(state[k]).requires_grad_(True) for k in skeys}
    ty, tst = t_mamba2.mamba_apply(live_p, live_x, cfg=tcfg, state=live_s)
    outs = [ty] + [tst[k] for k in skeys]
    cots = [_t(gy)] + [_t(gst[k]) for k in skeys]
    ins = [live_p[k] for k in keys] + [live_x] + [live_s[k] for k in skeys]
    tg = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    want = [jgp[k] for k in keys] + [jgx] + [jgs[k] for k in skeys]
    names = keys + ["xin"] + [f"state/{k}" for k in skeys]
    assert {"A_log", "dt_bias", "w_dt"} <= set(keys)
    for name, jg, g in zip(names, want, tg):
        g = torch.zeros(jg.shape) if g is None else g
        assert float(np.abs(np.asarray(jg)).max()) > 0, name
        assert _rel_err(jg, g.numpy()) <= LAYER_GRAD_TOL, (arm, name, _rel_err(jg, g.numpy()))


# --------------------------------------------------------------------- #
# The slice: served through the model API
# --------------------------------------------------------------------- #


def _reduced(get_config, arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


@pytest.fixture(scope="module", params=[MAMBA, JAMBA])
def models(request):
    arch = request.param
    jm, tm = j_build(_reduced(j_get_config, arch)), t_build(_reduced(t_get_config, arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(jparams), device="cpu", dtype=torch.float32)
    return arch, jm, tm, jparams, tparams


def _tokens(seed=1, S=SEQ):
    return np.random.default_rng(seed).integers(0, 256, (BATCH, S)).astype(np.int32)


def test_prefill_and_greedy_decode_match_the_reference(models):
    arch, jm, tm, jparams, tparams = models
    logit_atol = 3e-4 if tm.cfg.tie_embeddings else 2e-5
    jctx, tctx = JCtx(num_groups=1, num_ep_shards=N_EP), TCtx(num_groups=1, num_ep_shards=N_EP)
    jpre, jdec = jax.jit(j_make_prefill_step(jm, jctx)), jax.jit(j_make_decode_step(jm, jctx))
    tpre, tdec = t_make_prefill_step(tm, tctx), t_make_decode_step(tm, tctx)
    max_seq = SEQ + DECODE + 1
    jstate = jm.decode_state_init(BATCH, max_seq)
    tstate = state_from_numpy(_np(jstate), device="cpu")
    assert sorted(tstate) == sorted(tm.decode_state_init(BATCH, max_seq, device="cpu"))
    toks = _tokens()

    jlogits, jstate = jpre(jparams, jstate, {"tokens": jnp.asarray(toks)})
    tlogits, tstate = tpre(tparams, tstate, {"tokens": torch.from_numpy(toks)})
    for step in range(DECODE + 1):
        assert tlogits.shape == (BATCH, 1, tm.cfg.padded_vocab)
        assert bool(torch.isfinite(tlogits).all())
        np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                                   rtol=2e-4, atol=logit_atol, err_msg=f"{arch} step {step}")
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tlogits, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        assert int(jstate["pos"]) == int(tstate["pos"]) == SEQ + step
        if step == DECODE:
            break
        jlogits, jstate = jdec(jparams, jstate, jtok)
        tlogits, tstate = tdec(tparams, tstate, ttok)
    # The SSM states and conv windows agree after prefill and decode.
    for j in t_transformer.mamba_layer_positions(tm.cfg):
        for key in ("ssm", "conv_x", "conv_B", "conv_C"):
            want = np.asarray(jstate[f"ssm_l{j}"][key])
            np.testing.assert_allclose(
                tstate[f"ssm_l{j}"][key].numpy(), want, rtol=2e-4,
                atol=1e-5 * float(np.abs(want).max()), err_msg=f"{arch} ssm_l{j} {key}",
            )


def test_decode_matches_full_forward(models):
    """The port alone: token-by-token decode logits after a prefill of two
    chunks match the full forward pass over three."""
    _, _, tm, _, tparams = models
    toks = torch.from_numpy(_tokens())
    full_logits, _ = t_transformer.forward(tparams, toks, cfg=tm.cfg,
                                           dyskew=tm.dyskew_init(device="cpu"))
    rtol, atol = 2e-2, 2e-3
    half = 64
    state = tm.decode_state_init(BATCH, SEQ, device="cpu")
    logits_p, state = tm.prefill(tparams, {"tokens": toks[:, :half]}, state)
    np.testing.assert_allclose(logits_p.numpy(), full_logits[:, :half].numpy(),
                               rtol=rtol, atol=atol)
    for t in range(half, half + 3):
        logits_t, state = tm.decode_step(tparams, state, toks[:, t:t + 1])
        np.testing.assert_allclose(logits_t[:, 0].numpy(), full_logits[:, t].numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"step {t}")
    assert int(state["pos"]) == half + 3


def test_prefill_updates_the_ssm_state_in_place(models):
    _, _, tm, _, tparams = models
    state = tm.decode_state_init(BATCH, SEQ + 1, device="cpu")
    mamba_pos = t_transformer.mamba_layer_positions(tm.cfg)
    assert mamba_pos
    before = {j: dict(state[f"ssm_l{j}"]) for j in mamba_pos}
    assert all(float(v.abs().sum()) == 0.0 for d in before.values() for v in d.values())
    _, new_state = tm.prefill(tparams, {"tokens": torch.from_numpy(_tokens())}, state)
    for j in mamba_pos:
        for key, tensor in before[j].items():
            assert new_state[f"ssm_l{j}"][key] is tensor, (j, key)
            assert float(tensor.abs().sum()) > 0.0, (j, key)
    tok = torch.zeros((BATCH, 1), dtype=torch.int32)
    _, after = tm.decode_step(tparams, new_state, tok)
    assert all(after[f"ssm_l{j}"]["ssm"] is before[j]["ssm"] for j in mamba_pos)


def test_every_mamba_layer_scans_through_the_ops_switch(models, monkeypatch):
    """Prefill calls the model's scan, ``KERNEL_OPS.scan`` =
    ``ops.state_scan``, once per Mamba layer, on (chunks + 1, batch * heads,
    head_dim, d_state); decode calls it never.  The calls are recorded in
    the plain version that ``ops.state_scan`` takes for CPU tensors."""
    _, _, tm, _, tparams = models
    assert t_moe.KERNEL_OPS.scan is t_scan_ops.state_scan
    calls = []
    plain = t_scan_ops.ssd_state_scan_ref

    def recording(states, decay):
        calls.append(tuple(states.shape))
        return plain(states, decay)

    monkeypatch.setattr(t_scan_ops, "ssd_state_scan_ref", recording)
    cfg = tm.cfg
    state = tm.decode_state_init(BATCH, SEQ + 1, device="cpu")
    _, state = tm.prefill(tparams, {"tokens": torch.from_numpy(_tokens())}, state)
    n_mamba = len(t_transformer.mamba_layer_positions(cfg)) * t_transformer.num_blocks(cfg)
    nh = cfg.mamba.num_heads(cfg.d_model)
    nc = SEQ // cfg.mamba.chunk
    assert calls == [(nc + 1, BATCH * nh, cfg.mamba.head_dim, cfg.mamba.d_state)] * n_mamba
    tm.decode_step(tparams, state, torch.zeros((BATCH, 1), dtype=torch.int32))
    assert len(calls) == n_mamba


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_specs_and_state_match_the_reference_at_full_width(arch):
    jm, tm = j_build(j_get_config(arch)), t_build(t_get_config(arch))
    jleaves = jax.tree.leaves(
        jax.tree.map(lambda p: (p.shape, p.axes, p.init, p.scale), jm.specs(),
                     is_leaf=lambda x: hasattr(x, "axes")),
        is_leaf=lambda x: isinstance(x, tuple),
    )
    tleaves = [(p.shape, p.axes, p.init, p.scale) for p in tree_leaves(tm.specs())]
    assert jleaves == tleaves
    assert jm.num_params() == tm.num_params()
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(tm.cfg)
    # Decode-state layout, shapes only (no full-size allocation).
    jshapes = jax.eval_shape(lambda: jm.decode_state_init(8, 1056))
    jflat = sorted((jax.tree_util.keystr(k), v.shape, str(v.dtype))
                   for k, v in jax.tree_util.tree_flatten_with_path(jshapes)[0])
    tstate = t_transformer.decode_state_init(tm.cfg, 8, 1056, t_transformer.model_dtype(tm.cfg),
                                             device="meta")
    tflat = sorted((jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for k, v in jax.tree_util.tree_flatten_with_path(tstate)[0])
    assert jflat == tflat


def test_mamba2_is_the_published_size():
    cfg = t_get_config(MAMBA)
    assert cfg.param_count() == 1_518_600_192
    assert (cfg.num_layers, cfg.d_model, cfg.mamba.num_heads(cfg.d_model),
            cfg.mamba.d_state, cfg.padded_vocab) == (48, 2048, 64, 128, 50304)
    assert t_transformer.mamba_layer_positions(cfg) == (0,)
    assert t_transformer.num_blocks(cfg) == 48
