"""The import shim of ``repro/fed/engine.py``: the engines live in
:mod:`repro_torch.fed.engines`, and every name the reference's shim
re-exports that the port carries imports from here too (the reference's
``tree_stack``, a JAX pytree helper, has no use in the port)."""

from repro_torch.fed.engines import (  # noqa: F401
    BatchedEngine,
    BroadcastState,
    ClientPhase,
    FusedE2EEngine,
    FusedEngine,
    HeteroClientEngine,
    HeteroFusedE2EEngine,
    RoundsTrajectory,
    SequentialEngine,
    check_unique_cohort,
    cohort_budgets,
    k_cap_bucket,
    make_engine,
)
from repro_torch.fed.engines.base import (  # noqa: F401
    _channel_scan_ops,
    _ServerOwnerMixin,
    fake_quant_dense,
    shared_frozen_backbone,
)

__all__ = [
    "BroadcastState",
    "ClientPhase",
    "RoundsTrajectory",
    "SequentialEngine",
    "BatchedEngine",
    "FusedEngine",
    "FusedE2EEngine",
    "HeteroClientEngine",
    "HeteroFusedE2EEngine",
    "make_engine",
    "k_cap_bucket",
    "cohort_budgets",
    "check_unique_cohort",
]
