"""Round engines: the whole-round ``fused_e2e`` engine and its plumbing."""

from repro_torch.fed.engines.base import (
    BroadcastState,
    ClientPhase,
    check_unique_cohort,
    cohort_budgets,
    k_cap_bucket,
)
from repro_torch.fed.engines.e2e import FusedE2EEngine

__all__ = [
    "BroadcastState",
    "ClientPhase",
    "FusedE2EEngine",
    "check_unique_cohort",
    "cohort_budgets",
    "k_cap_bucket",
]
