"""Discrete-event simulator: the paper-faithful reproduction layer.

engine       — ONE array-backed event loop (workers / adaptive links /
               network) serving both the single-query API and N
               concurrent tenants, with optional weighted fair-share
               admission, batched state-machine ticks, and a closed-form
               'none'-strategy fast path
batched_link — (T, n) stacked link state: one tick call advances
               every tenant's state machines (the hundreds-of-tenants
               scaling path)
legacy       — the seed list-of-tuples engine, kept as the equivalence
               reference for the unified loop
workload     — synthetic suites matching the paper's evaluation
               scenarios, plus open-loop arrival processes, interference
               traffic and the many-tenants scaling mix
pipeline     — multi-stage UDF pipelines: chained engine stages with
               inter-stage shuffles and per-row lineage, so skew
               amplification/attenuation is measurable stage by stage
replay       — strategy comparison + aggregate statistics (single-tenant,
               closed- and open-loop multi-tenant: per-class tails,
               Jain's fairness; pipeline skew-propagation summaries),
               with optional process-pool fan-out

Every simulator takes ``device``: where the link state machines live and
tick (``None``: the GPU, raising without one; ``"cpu"`` runs them on the
host).  The event loop, the policies and the admission planners are host
numpy whatever the device.
"""

from repro_torch.sim.batched_link import BatchedLinkSim
from repro_torch.sim.engine import (
    Batch,
    ClusterConfig,
    MultiQuerySimulator,
    QueryResult,
    Simulator,
    StrategyConfig,
    TenantQuery,
    closed_form_none_result,
)
from repro_torch.sim.pipeline import (
    PipelineInput,
    PipelineResult,
    PipelineSimulator,
    StageSpec,
    override_strategy,
)
from repro_torch.sim.workload import QueryProfile, generate_query

__all__ = [
    "Batch",
    "BatchedLinkSim",
    "ClusterConfig",
    "MultiQuerySimulator",
    "PipelineInput",
    "PipelineResult",
    "PipelineSimulator",
    "QueryProfile",
    "QueryResult",
    "Simulator",
    "StageSpec",
    "StrategyConfig",
    "TenantQuery",
    "closed_form_none_result",
    "generate_query",
    "override_strategy",
]
