"""The federated AdaLD runtime (Algorithm 1): the ``sequential``,
``batched``, ``fused`` and ``fused_e2e`` engines, and their
family-bucketed forms for mixed fleets."""

from repro_torch.fed.cohort import (
    FamilyBucket,
    partition_fleet,
    split_cohort,
    validate_family_contracts,
)
from repro_torch.fed.engines import (
    BatchedEngine,
    FusedE2EEngine,
    FusedEngine,
    HeteroClientEngine,
    HeteroFusedE2EEngine,
    SequentialEngine,
    make_engine,
)
from repro_torch.fed.rounds import METHODS, FedConfig, FedRun, run_federated
from repro_torch.fed.server import Server

__all__ = [
    "SequentialEngine",
    "BatchedEngine",
    "FusedEngine",
    "FusedE2EEngine",
    "HeteroClientEngine",
    "HeteroFusedE2EEngine",
    "FamilyBucket",
    "partition_fleet",
    "split_cohort",
    "validate_family_contracts",
    "make_engine",
    "Server",
    "METHODS",
    "FedConfig",
    "FedRun",
    "run_federated",
]
