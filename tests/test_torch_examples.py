"""The port's four examples (``python -m repro_torch.examples.<name>``) on
the CPU, each checked for what the verify skill says it shows: the link's
makespan drops to the balanced one, dyskew < static_rr < none in latency,
dyskew's p99 no worse than round-robin's, and both dispatch modes train
(one process and two gloo ranks, at a tiny width)."""

import math

import pytest

from repro_torch.examples import quickstart, serve_dyskew, sim_replay, train_moe_dyskew

CPU = "cpu"


def test_quickstart_link_balances():
    makespans = quickstart.run(CPU)
    assert makespans[0] == pytest.approx(3.2) and makespans[-1] == pytest.approx(0.8)


def test_sim_replay_orders_the_strategies():
    lat = sim_replay.run(CPU)
    assert lat["dyskew"] < lat["static_rr"] < lat["none"]


def test_serve_dyskew_tail_no_worse_than_round_robin():
    res = serve_dyskew.run(CPU)
    assert res["dyskew"]["p99_latency"] <= res["round_robin"]["p99_latency"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_train_moe_dyskew_trains_both_modes(ranks):
    out = train_moe_dyskew.run(steps=3, batch=4, seq=32, device=CPU, ranks=ranks, layers=1, d_model=64)
    assert set(out) == {"dyskew", "static"}
    for hist in out.values():
        assert hist and all(math.isfinite(h["loss"]) for h in hist)
        assert 0.0 <= hist[-1]["moe_dropped_frac"] <= 1.0
