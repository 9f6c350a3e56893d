"""Replay a skewed UDF query under all three strategies (paper Fig. 1-4
mechanics, small scale).

Run:  PYTHONPATH=src python -m repro_torch.examples.sim_replay [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

from repro_torch.sim.engine import ClusterConfig, Simulator
from repro_torch.sim.replay import default_strategies, scan_arrival_gap
from repro_torch.sim.workload import QueryProfile, generate_query


def run(device: Optional[str] = None, n_rows: int = 12000) -> Dict[str, float]:
    """Prints one line a strategy; returns each strategy's latency."""
    cluster = ClusterConfig(num_nodes=8)
    profile = QueryProfile(
        name="demo", n_rows=n_rows, mean_row_cost=2e-3,
        cost_sigma=2.0,            # heavy-tailed UDF cost (the hard case)
        partition_alpha=0.4, hot_fraction=0.05,
    )
    batches = generate_query(profile, cluster.num_workers, seed=0)
    gap = scan_arrival_gap(profile, cluster)

    print(f"query: {profile.n_rows} rows, partition+cost skew, "
          f"{cluster.num_workers} interpreters on {cluster.num_nodes} nodes\n")
    latency = {}
    for name, st in default_strategies().items():
        r = Simulator(cluster, st, seed=0, device=device).run_query(batches, arrival_gap=gap)
        latency[name] = r.latency
        print(f"{name:10s} latency={r.latency:7.3f}s utilization={r.utilization:.2f} "
              f"rows_moved={r.rows_redistributed}")
    return latency


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    run(ap.parse_args().device)
