"""DySkew core: the paper's primary contribution as composable PyTorch
modules (the port of ``repro.core``).

Public API:
  types.DySkewConfig / Policy / LinkState / SkewModelKind
  skew_models — Eq.(1) row-percentage, idle-time, Eq.(2) sync-slope,
                N-strikes, batch-density Row Size Model
  state_machine — per-link-instance adaptive state machine (Fig. 2);
                `tick` advances one query's sibling group, `tick_many`
                a stacked (T, n) tenant axis with inactive-row masking
                (the batched simulator tick)
  redistribution — round_robin (legacy baseline), lpt_greedy, zigzag
  admission — shared admission planning: per-batch guards (density
              guard, cost gate, self-skip eligibility), the on-device
              redistribution gate (CostModelConfig /
              admit_redistribution — polymorphic over numpy and torch,
              one formula set for the host planners and the link step),
              and the weighted fair-share multi-tenant layer
  adaptive_link.AdaptiveLink — the assembled adaptive data link
  policy — the pluggable redistribution-policy seam: the
           `RedistributionPolicy` interface and name registry that
           `StrategyConfig` (simulator) resolves placement through
  ordered_sums — float sums in index order, the same bits on the card
                 and on the host
"""

from repro_torch.core.adaptive_link import AdaptiveLink, AdaptiveLinkConfig
from repro_torch.core.admission import (
    AdmissionDecision,
    BatchAdmission,
    CostModelConfig,
    FairShareAdmission,
    FairShareConfig,
)
from repro_torch.core.policy import (
    PolicyContext,
    RedistributionPolicy,
    StrategyConfig,
    available_policies,
    register_policy,
    resolve_policy,
)
from repro_torch.core.types import (
    DySkewConfig,
    LinkState,
    Policy,
    RoutingPlan,
    SkewModelKind,
    link_state_init,
)

__all__ = [
    "AdaptiveLink",
    "AdaptiveLinkConfig",
    "AdmissionDecision",
    "BatchAdmission",
    "CostModelConfig",
    "DySkewConfig",
    "FairShareAdmission",
    "FairShareConfig",
    "LinkState",
    "Policy",
    "PolicyContext",
    "RedistributionPolicy",
    "RoutingPlan",
    "SkewModelKind",
    "StrategyConfig",
    "available_policies",
    "link_state_init",
    "register_policy",
    "resolve_policy",
]
