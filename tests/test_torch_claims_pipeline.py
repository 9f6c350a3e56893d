"""The multi-stage pipeline's invariants, held through the port on the
CPU: the twin of ``tests/test_pipeline.py``, its hypothesis layer included.

Each twin runs its reference test's pipeline through ``repro_torch`` with
``device="cpu"`` and asserts the reference test's invariant: rows and bytes
conserved through every shuffle, the same seed the same bits, a one-stage
pipeline exactly a bare engine run, the suite's shapes and summaries.  What
a run returns (stage reports, makespans, row counts) is also held to the
reference's run of the same inputs and seeds, bit for bit, with the
distribute mask of every link tick (``RefRuns``: the reference's side of
each grid case runs once per module; the fuzz layer runs both sides on
each example it draws).

The fuzz layer mirrors the reference's strategies and ``max_examples``,
with ``derandomize=True`` so that it draws the same examples, and passes
the same count, in every run; ``deadline=None`` as the reference's.
"""

import numpy as np
import pytest

try:
    import hypothesis
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dependency
    hypothesis = None

from torch_sim_common import RefRuns, same_bits

KINDS = ["none", "static_rr", "dyskew", "p2c"]


@pytest.fixture(scope="module")
def twin():
    return RefRuns()


def _cluster(m):
    return m.engine.ClusterConfig(num_nodes=2, interpreters_per_node=4)


def _fanout_mod(keys, rng):
    return keys % 3


def _fanout_rand(keys, rng):
    return rng.integers(0, 4, len(keys))


FANOUTS = [None, _fanout_mod, _fanout_rand]


def _stages(m, shuffles, fanout=None, kind=None):
    specs = [m.pipeline.StageSpec(name=f"s{i}", shuffle=sh, mean_row_cost=2e-4, fanout_fn=fanout,
                                  batch_rows=64)
             for i, sh in enumerate(shuffles)]
    return m.pipeline.override_strategy(specs, kind) if kind else specs


def _inputs(m, n_rows, alpha=1.2):
    return [
        m.pipeline.PipelineInput(name="a", n_rows=n_rows, num_keys=64, zipf_alpha=alpha),
        m.pipeline.PipelineInput(name="b", n_rows=max(n_rows // 2, 8), num_keys=32, zipf_alpha=0.0,
                                 partition="rr"),
    ]


def _sim(m, stages, seed, cluster=None):
    return m.pipeline.PipelineSimulator(cluster or _cluster(m), stages, seed=seed, **m.dev)


def _advance(stage, sim, k, rows):
    """Replay stage ``k``'s fanout draws: the rows stage ``k + 1`` gets."""
    for ti, rs in enumerate(rows):
        rng = sim._rng(k, ti, lane=2)
        fan = stage.fanout(rs.keys, rng)
        rs.keys = stage.transform_keys(np.repeat(rs.keys, fan), rng)
        rs.producers = np.zeros(len(rs.keys), np.int64)


# --------------------------------------------------------------------- #
# The invariant checkers, shared by the grid and the fuzz layer; each
# returns what its run computed, for the comparison with the reference.
# --------------------------------------------------------------------- #


def check_row_conservation(m, shuffles, fanout, kind, seed):
    """Every stage processes exactly the rows the previous stage's fanout
    emitted: none lost in a shuffle, none duplicated."""
    sim = _sim(m, _stages(m, shuffles, fanout=fanout, kind=kind), seed)
    inputs = _inputs(m, 120)
    res = sim.run(inputs)
    assert res.stages[0].rows_in == [i.n_rows for i in inputs]
    rows = sim.initial_rows(inputs)
    for k, stage in enumerate(sim.stages):
        assert res.stages[k].rows_in == [len(rs.keys) for rs in rows]
        _advance(stage, sim, k, rows)
    assert res.rows_out == [len(rs.keys) for rs in rows]
    return res


def check_byte_conservation(m, kind, seed):
    """The bytes a stage offers the engine are exactly the sizes its size
    model assigned: batching and stream splitting lose nothing."""
    sim = _sim(m, _stages(m, ["hash", "worker"], kind=kind), seed)
    inputs = _inputs(m, 100)
    res = sim.run(inputs)
    rows = sim.initial_rows(inputs)
    for k, stage in enumerate(sim.stages):
        for ti, t in enumerate(sim.stage_tenants(k, rows, inputs)):
            rng = sim._rng(k, ti, lane=1)
            stage.costs(rows[ti].keys, rng)  # advance the cost draw
            expect = float(stage.sizes(rows[ti].keys, rng).sum())
            got = sum(float(b.sizes.sum()) for s in t.streams for b in s)
            assert got == pytest.approx(expect, rel=1e-12)
            assert res.stages[k].bytes_in[ti] == pytest.approx(expect, rel=1e-12)
        _advance(stage, sim, k, rows)
    return res


def check_same_seed_bit_identity(m, kind, seed):
    stages = _stages(m, ["hash", "worker"], fanout=_fanout_rand, kind=kind)
    inputs = _inputs(m, 100)
    r1 = _sim(m, stages, seed).run(inputs)
    r2 = _sim(m, stages, seed).run(inputs)
    assert r1.makespan == r2.makespan
    assert r1.rows_out == r2.rows_out
    for s1, s2 in zip(r1.stages, r2.stages):
        assert s1.completions == s2.completions
        assert np.array_equal(s1.input_rows_per_worker, s2.input_rows_per_worker)
        assert np.array_equal(s1.busy_per_worker, s2.busy_per_worker)
        for q1, q2 in zip(s1.results, s2.results):
            assert q1.latency == q2.latency
            assert q1.bytes_moved_remote == q2.bytes_moved_remote
    return r1


def check_one_stage_equals_bare_engine(m, kind, seed, alpha):
    """A one-stage pipeline IS a bare engine run: the same tenants and
    seed give bit-identical results, traced or not."""
    sim = _sim(m, _stages(m, ["hash"], kind=kind), seed)
    inputs = _inputs(m, 150, alpha=alpha)
    res = sim.run(inputs)
    # The stage-0 tenants again, on a bare UNTRACED engine (ids stripped).
    tenants = sim.stage_tenants(0, sim.initial_rows(inputs), inputs)
    for t in tenants:
        for s in t.streams:
            for i, b in enumerate(s):
                s[i] = m.engine.Batch(costs=b.costs, sizes=b.sizes)
    bare = m.engine.MultiQuerySimulator(_cluster(m), seed=sim.stage_seed(0), **m.dev).run(tenants)
    assert len(bare) == len(res.stages[0].results)
    for qb, qp in zip(bare, res.stages[0].results):
        assert qb.latency == qp.latency
        assert qb.utilization == qp.utilization
        assert qb.bytes_moved_remote == qp.bytes_moved_remote
        assert qb.rows_redistributed == qp.rows_redistributed
        assert np.array_equal(qb.per_worker_busy, qp.per_worker_busy)
    return res, bare


# --------------------------------------------------------------------- #
# The grid
# --------------------------------------------------------------------- #


def hash_partition(m, n):
    keys = np.random.default_rng(3).integers(0, 10_000, 500)
    d1 = m.pipeline.hash_partition(keys, n)
    assert np.array_equal(d1, m.pipeline.hash_partition(keys, n))
    assert d1.min() >= 0 and d1.max() < n
    return d1


def zipf_keys(m, alpha):
    keys = m.pipeline.zipf_keys(200, 16, alpha, np.random.default_rng(5))
    assert len(keys) == 200
    assert keys.min() >= 0 and keys.max() < 16
    return keys


def zipf_skews_with_alpha(m):
    flat = np.bincount(m.pipeline.zipf_keys(5000, 16, 0.0, np.random.default_rng(0)), minlength=16)
    skew = np.bincount(m.pipeline.zipf_keys(5000, 16, 1.5, np.random.default_rng(0)), minlength=16)
    assert skew.max() > 2 * flat.max()
    return flat, skew


class TestPartitioning:
    @pytest.mark.parametrize("n", [1, 7, 64])
    def test_hash_partition_in_range_and_deterministic(self, twin, n):
        same_bits(*twin(hash_partition, n))

    @pytest.mark.parametrize("alpha", [0.0, 1.1, 2.0])
    def test_zipf_keys_in_range(self, twin, alpha):
        same_bits(*twin(zipf_keys, alpha))

    def test_zipf_skews_with_alpha(self, twin):
        same_bits(*twin(zipf_skews_with_alpha))


def empty_tenant(m):
    """A tenant whose fanout kills every row mid-pipeline still gets its
    stage reports (zero rows)."""
    stages = [
        m.pipeline.StageSpec(name="kill", shuffle="hash", batch_rows=32,
                             fanout_fn=lambda k, rng: np.zeros(len(k), np.int64)),
        m.pipeline.StageSpec(name="after", batch_rows=32),
    ]
    res = _sim(m, stages, 3).run([m.pipeline.PipelineInput(name="t", n_rows=64, num_keys=8)])
    assert res.stages[1].rows_in == [0]
    assert res.rows_out == [0]
    return res.makespan, [s.rows_in for s in res.stages], [s.results for s in res.stages]


class TestConservation:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("fanout", FANOUTS)
    def test_row_conservation(self, twin, kind, fanout):
        same_bits(*twin(check_row_conservation, ("hash", "worker"), fanout, kind, 7))

    @pytest.mark.parametrize("shuffles", [["hash"], ["worker", "hash", "worker"]])
    def test_row_conservation_depths(self, twin, shuffles):
        same_bits(*twin(check_row_conservation, tuple(shuffles), _fanout_rand, "dyskew", 11))

    @pytest.mark.parametrize("kind", KINDS)
    def test_byte_conservation(self, twin, kind):
        same_bits(*twin(check_byte_conservation, kind, 13))

    def test_empty_tenant_flows_through(self, twin):
        same_bits(*twin(empty_tenant))


def cross_seed_makespans(m):
    stages = _stages(m, ["hash"], fanout=_fanout_rand)
    inputs = _inputs(m, 200)
    return [_sim(m, stages, seed).run(inputs).makespan for seed in (1, 2)]


class TestDeterminism:
    @pytest.mark.parametrize("kind", KINDS)
    def test_same_seed_bit_identity(self, twin, kind):
        same_bits(*twin(check_same_seed_bit_identity, kind, 17))

    def test_cross_seed_divergence(self, twin):
        ref, (a, b) = twin(cross_seed_makespans)
        assert a != b
        same_bits(ref, (a, b))


def traced_and_plain(m):
    n = _cluster(m).num_workers

    def tenants():
        rng = np.random.default_rng(4)
        out = []
        for q in range(2):
            streams, base = [], 0
            for p in range(n):
                rows = 20 + 10 * (p == 0)
                costs = rng.lognormal(np.log(3e-4), 0.4, rows)
                streams.append([m.engine.Batch(costs=costs.copy(), sizes=np.full(rows, 1024.0),
                                               ids=np.arange(base, base + rows, dtype=np.int64))])
                base += rows
            out.append(m.engine.TenantQuery(name=f"q{q}", streams=streams,
                                            strategy=m.engine.StrategyConfig(kind="dyskew")))
        return out

    traced_sim = m.engine.MultiQuerySimulator(_cluster(m), trace_placement=True, seed=9, **m.dev)
    traced = traced_sim.run(tenants())
    plain = m.engine.MultiQuerySimulator(_cluster(m), seed=9, **m.dev).run(tenants())
    return traced, plain, list(traced_sim.last_placement)


def none_placement(m, force_loop):
    n = _cluster(m).num_workers
    streams, base = [], 0
    for p in range(n):
        rows = 8 + p
        streams.append([m.engine.Batch(costs=np.full(rows, 2e-4), sizes=np.full(rows, 64.0),
                                       ids=np.arange(base, base + rows, dtype=np.int64))])
        base += rows
    t = m.engine.TenantQuery(name="t", streams=streams, strategy=m.engine.StrategyConfig(kind="none"))
    sim = m.engine.MultiQuerySimulator(_cluster(m), trace_placement=True,
                                       none_closed_form=False if force_loop else None, **m.dev)
    res = sim.run([t])
    return sim.last_placement[0], res


class TestDifferentialPin:
    @pytest.mark.parametrize("kind", KINDS)
    def test_one_stage_equals_bare_engine(self, twin, kind):
        same_bits(*twin(check_one_stage_equals_bare_engine, kind, 23, 1.2))

    def test_trace_does_not_perturb_run(self, twin):
        """Tracing is purely observational, and the trace is complete."""
        ref, (traced, plain, placement) = twin(traced_and_plain, min_ticks=1)
        for a, b in zip(traced, plain):
            assert a.latency == b.latency
            assert np.array_equal(a.per_worker_busy, b.per_worker_busy)
        for tr in placement:
            assert tr is not None and (tr >= 0).all()
        same_bits(ref, (traced, plain, placement))

    @pytest.mark.parametrize("force_loop", [False, True])
    def test_none_strategy_placement_is_producer(self, twin, force_loop):
        """'none' moves no row: each row's traced placement is its
        producer, through the closed form and through the event loop."""
        ref, (place, res) = twin(none_placement, force_loop)
        n = 8
        expect = np.concatenate([np.full(8 + p, p, np.int64) for p in range(n)])
        assert np.array_equal(place, expect)
        same_bits(ref, (place, res))


def pipeline_suite_shapes(m):
    suite = m.workload.pipeline_suite(quick=True)
    names = [name for name, _, _ in suite]
    assert names == ["fanout_explode", "groupby_attenuate", "collision_chain", "etl_chain"]
    for _, stages, inputs in suite:
        assert 2 <= len(stages) <= 5
        assert inputs
        assert all(i.n_rows >= 256 for i in inputs)
    return names, [[i.n_rows for i in inputs] for _, _, inputs in suite]


def imbalance_coefficient(m):
    f = m.replay.imbalance_coefficient
    assert f([4, 4, 4, 4]) == 1.0
    assert f([8, 0, 0, 0]) == 4.0
    assert np.isnan(f([]))
    assert np.isnan(f([0.0, 0.0]))


def amplification_ratios(m):
    assert m.replay.amplification_ratios([1.0, 2.0, 1.0]) == [2.0, 0.5]
    assert np.isnan(m.replay.amplification_ratios([float("nan"), 2.0])[0])


def summarize_pipeline(m):
    name, stages, inputs = m.workload.pipeline_suite(quick=True)[2]
    assert name == "collision_chain"
    res = _sim(m, stages, 5, m.engine.ClusterConfig(num_nodes=2)).run(inputs)
    s = m.replay.summarize_pipeline(res)
    assert s["stages"] == [sp.name for sp in stages]
    assert len(s["input_imbalance"]) == len(stages)
    assert len(s["amplification"]) == len(stages) - 1
    assert s["makespan"] > 0
    # one tenant: end-to-end makespan == sum of stage makespans
    assert s["makespan"] == pytest.approx(s["stage_makespan_sum"])
    # the collision chain amplifies skew mid-pipeline
    assert max(s["amplification"]) > 1.5
    return s


def makespan_vs_stage_sum_with_overlapping_tenants(m):
    """Later stages start at per-tenant barriers: the end-to-end makespan
    is at most the per-stage sum."""
    inputs = _inputs(m, 150) + [m.pipeline.PipelineInput(name="late", n_rows=64, num_keys=8,
                                                         arrival=0.05)]
    res = _sim(m, _stages(m, ["hash", "worker", "hash"]), 11).run(inputs)
    assert res.makespan <= res.stage_makespan_sum + 1e-12
    return res


SUITE_CASES = [pipeline_suite_shapes, imbalance_coefficient, amplification_ratios, summarize_pipeline,
               makespan_vs_stage_sum_with_overlapping_tenants]


class TestSuiteAndMetrics:
    """One case a reference test of ``TestSuiteAndMetrics`` (its name with
    ``test_`` dropped)."""

    @pytest.mark.parametrize("case", SUITE_CASES, ids=lambda f: f.__name__)
    def test_suite_and_metrics(self, twin, case):
        same_bits(*twin(case, min_ticks=0))


def bad_shuffle_rejected(m):
    with pytest.raises(ValueError, match="shuffle"):
        m.pipeline.StageSpec(name="x", shuffle="broadcast")


def bad_partition_rejected(m):
    with pytest.raises(ValueError, match="partition"):
        m.pipeline.PipelineInput(name="x", partition="range")


def empty_pipeline_rejected(m):
    with pytest.raises(ValueError, match="at least one stage"):
        _sim(m, [], 0)


def empty_inputs_rejected(m):
    with pytest.raises(ValueError, match="at least one input"):
        _sim(m, _stages(m, ["hash"]), 0).run([])


def negative_fanout_rejected(m):
    stages = [m.pipeline.StageSpec(name="bad", shuffle="hash",
                                   fanout_fn=lambda k, rng: np.full(len(k), -1)),
              m.pipeline.StageSpec(name="sink")]
    with pytest.raises(ValueError, match="fanout_fn"):
        _sim(m, stages, 0).run([m.pipeline.PipelineInput(name="t", n_rows=32, num_keys=4)])


def override_strategy_preserves_knobs(m):
    spec = m.pipeline.StageSpec(name="s")
    out = m.pipeline.override_strategy([spec], "static_rr")
    assert out[0].strategy.kind == "static_rr"
    assert out[0].strategy.tick_interval == spec.strategy.tick_interval
    # and the dyskew detection config rides along untouched
    assert out[0].strategy.dyskew == spec.strategy.dyskew
    return out[0].strategy


VALIDATION_CASES = [bad_shuffle_rejected, bad_partition_rejected, empty_pipeline_rejected,
                    empty_inputs_rejected, negative_fanout_rejected, override_strategy_preserves_knobs]


class TestValidation:
    """One case a reference test of ``TestValidation`` (its name with
    ``test_`` dropped)."""

    @pytest.mark.parametrize("case", VALIDATION_CASES, ids=lambda f: f.__name__)
    def test_validation(self, twin, case):
        same_bits(*twin(case))


# --------------------------------------------------------------------- #
# The fuzz layer (optional dev dependency, same checkers)
# --------------------------------------------------------------------- #

if hypothesis is not None:
    FUZZ = settings(max_examples=10, deadline=None, derandomize=True)
    KIND_ST = st.sampled_from(KINDS)

    class TestFuzzInvariants:
        @FUZZ
        @given(
            shuffles=st.lists(st.sampled_from(["hash", "worker"]), min_size=1, max_size=3),
            fanout=st.sampled_from(FANOUTS),
            kind=KIND_ST,
            seed=st.integers(0, 50),
        )
        def test_row_conservation(self, twin, shuffles, fanout, kind, seed):
            same_bits(*twin(check_row_conservation, tuple(shuffles), fanout, kind, seed))

        @FUZZ
        @given(kind=KIND_ST, seed=st.integers(0, 50))
        def test_byte_conservation(self, twin, kind, seed):
            same_bits(*twin(check_byte_conservation, kind, seed))

        @FUZZ
        @given(kind=KIND_ST, seed=st.integers(0, 50))
        def test_same_seed_bit_identity(self, twin, kind, seed):
            same_bits(*twin(check_same_seed_bit_identity, kind, seed))

        @FUZZ
        @given(kind=KIND_ST, seed=st.integers(0, 50), alpha=st.floats(0.0, 1.6))
        def test_one_stage_equals_bare_engine(self, twin, kind, seed, alpha):
            same_bits(*twin(check_one_stage_equals_bare_engine, kind, seed, alpha))
