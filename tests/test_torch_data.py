"""The port's data pipeline against ``repro.data.pipeline`` on the CPU.

Documents, packing, fair-share tenant mixing and the targets are host
numpy on both sides and must be EQUAL.  The DySkew balancing pass routes
packed sequences across data-parallel shards through ``AdaptiveLink.step``
(costs ``lens² / seq_len²``, float32 non-integers): its destinations, the
reordered ``tokens`` and the carried link state must be EQUAL too.
Mirrors ``TestDataPipeline`` of ``tests/test_substrate.py``, the pipeline
cases of ``tests/test_slo_layer.py`` and ``tests/test_extra_coverage.py``,
and the data half of
``tests/test_policy_interface.py::TestServingAndDataResolution``.
"""

import numpy as np
import pytest
import torch

import repro.data.pipeline as j_pipe
import repro_torch.data.pipeline as t_pipe

CPU = "cpu"


def both(**kw):
    return (j_pipe.DataPipeline(j_pipe.DataConfig(**kw)),
            t_pipe.DataPipeline(t_pipe.DataConfig(**kw), device=CPU))


def assert_batch_equal(a, b, where=""):
    assert set(a) == set(b) == {"tokens", "targets"}
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")


def record_dest(pipe, device_side):
    """Every destination the pipeline's link step plans, in order."""
    log, link = [], pipe.link
    step = link.step

    def rec(*args, **kw):
        state, plan = step(*args, **kw)
        log.append(plan.dest.numpy().copy() if device_side else np.asarray(plan.dest).copy())
        return state, plan
    link.step = rec
    return log


class TestPacking:
    def test_packing_fills_sequences(self):
        seqs = {}
        for m in (j_pipe, t_pipe):
            cfg = m.DataConfig(vocab_size=100, seq_len=256, global_batch=8)
            seqs[m] = m.pack_documents(iter(m.SyntheticDocs(cfg)), 256, 8)
        for a, b in zip(seqs[j_pipe], seqs[t_pipe]):
            np.testing.assert_array_equal(a, b)
            assert len(b) == 256 and (b != 0).sum() > 0

    def test_unpacked_doc_is_carried_not_dropped(self):
        docs = [np.ones(200, np.int32), np.ones(100, np.int32), np.ones(56, np.int32)]
        carry = []
        seqs = t_pipe.pack_documents(iter(docs), seq_len=256, count=1, carry=carry)
        assert int((seqs[0] != 0).sum()) == 256
        assert [len(d) for d in carry] == [100]
        seqs2 = t_pipe.pack_documents(iter([]), seq_len=256, count=1, carry=carry)
        assert int((seqs2[0] != 0).sum()) == 100 and carry == []


class TestDataPipeline:
    def test_pipeline_batches_and_targets(self):
        jp, tp = both(vocab_size=100, seq_len=128, global_batch=4, num_shards=2)
        for i in range(3):
            a, b = next(jp), next(tp)
            assert_batch_equal(a, b, f"batch {i}")
        assert b["tokens"].shape == (4, 128)
        nz = b["tokens"][:, 1:] != 0
        np.testing.assert_array_equal(b["targets"][:, :-1][nz], b["tokens"][:, 1:][nz])

    def test_prefetch_thread(self):
        """The worker thread yields the same batches, in order, as calling
        the reference one batch at a time; ``stop`` joins it."""
        jp, tp = both(vocab_size=100, seq_len=64, global_batch=8, num_shards=4, seed=1)
        tp.start()
        thread = tp._thread
        try:
            for i in range(6):
                assert_batch_equal(next(jp), next(tp), f"batch {i}")
        finally:
            tp.stop()
        assert tp._thread is None and not thread.is_alive()

    @pytest.mark.parametrize("num_shards,batch,seq,moves", [(8, 32, 128, True), (8, 8, 1024, False)])
    def test_balancing_30_batches(self, num_shards, batch, seq, moves):
        """30 balanced batches at 8 shards: every link plan's ``dest``, the
        reordered tokens and the carried link state equal the reference's.
        At one sequence a shard (the training shape) a move cannot lower the
        makespan, so the cost gate keeps every sequence home."""
        jp, tp = both(vocab_size=1000, seq_len=seq, global_batch=batch, num_shards=num_shards, seed=2)
        jdest, tdest = record_dest(jp, False), record_dest(tp, True)
        for i in range(30):
            assert_batch_equal(next(jp), next(tp), f"batch {i}")
        assert len(tdest) == len(jdest) == 30
        moved = 0
        producer = np.arange(batch) * num_shards // batch
        for i, (a, b) in enumerate(zip(jdest, tdest)):
            np.testing.assert_array_equal(a, b, err_msg=f"dest {i}")
            moved += int((b != producer).any())
        assert (moved > 0) == moves
        for key in ("state", "strikes", "transitions", "tick"):
            np.testing.assert_array_equal(np.asarray(jp.link_state[key]), tp.link_state[key].numpy())
        for key, v in jp.link_state["metrics"].items():
            np.testing.assert_array_equal(np.asarray(v), tp.link_state["metrics"][key].numpy(), err_msg=key)

    def test_dyskew_reorder_preserves_sequences(self):
        on = t_pipe.DataPipeline(t_pipe.DataConfig(vocab_size=100, seq_len=64, global_batch=8,
                                                   num_shards=4, dyskew_balance=True, seed=3), device=CPU)
        off = t_pipe.DataPipeline(t_pipe.DataConfig(vocab_size=100, seq_len=64, global_batch=8,
                                                    num_shards=4, dyskew_balance=False, seed=3), device=CPU)
        b, b2 = next(on), next(off)
        assert sorted(r.tobytes() for r in b["tokens"]) == sorted(r.tobytes() for r in b2["tokens"])

    def test_default_device_needs_a_gpu(self):
        cfg = t_pipe.DataConfig(vocab_size=64, seq_len=32, global_batch=4, num_shards=2)
        if torch.cuda.is_available():
            assert t_pipe.DataPipeline(cfg).link.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                t_pipe.DataPipeline(cfg)


class TestTenantMixing:
    def test_tenant_tokens_equal_emitted_tokens(self):
        kw = dict(vocab_size=100, seq_len=256, global_batch=8, doc_len_mean=180.0, doc_len_sigma=1.2,
                  tenant_weights=(3.0, 1.0), seed=5, num_shards=1)
        jp, tp = both(**kw)
        emitted = 0
        for i in range(10):
            a, b = next(jp), next(tp)
            assert_batch_equal(a, b, f"batch {i}")
            emitted += int((b["tokens"] != 0).sum())
        np.testing.assert_array_equal(jp.tenant_tokens, tp.tenant_tokens)
        assert int(tp.tenant_tokens.sum()) == emitted

    def test_token_shares_follow_weights(self):
        kw = dict(vocab_size=100, seq_len=256, global_batch=8, tenant_weights=(2.0, 1.0, 1.0),
                  seed=4, num_shards=4)
        jp, tp = both(**kw)
        for i in range(20):
            assert_batch_equal(next(jp), next(tp), f"batch {i}")
        np.testing.assert_array_equal(jp.tenant_tokens, tp.tenant_tokens)
        share = tp.tenant_tokens / tp.tenant_tokens.sum()
        np.testing.assert_allclose(share, [0.5, 0.25, 0.25], atol=0.05)


class TestPlacementResolution:
    def test_data_pipeline_registry_placement(self):
        jp, tp = both(vocab_size=64, seq_len=128, global_batch=8, num_shards=4, placement="static_rr", seed=3)
        assert_batch_equal(next(jp), next(tp))
        assert not tp.policy.uses_link

    def test_data_pipeline_unknown_placement_raises(self):
        cfg = t_pipe.DataConfig(vocab_size=64, seq_len=128, global_batch=8, num_shards=4, placement="bogus")
        with pytest.raises(ValueError, match="bogus"):
            t_pipe.DataPipeline(cfg, device=CPU)
