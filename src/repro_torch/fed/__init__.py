"""The federated AdaLD runtime (Algorithm 1): the ``sequential``,
``batched``, ``fused`` and ``fused_e2e`` engines."""

from repro_torch.fed.engines import (
    BatchedEngine,
    FusedE2EEngine,
    FusedEngine,
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
    "make_engine",
    "Server",
    "METHODS",
    "FedConfig",
    "FedRun",
    "run_federated",
]
