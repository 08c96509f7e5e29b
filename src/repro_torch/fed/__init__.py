"""The federated AdaLD runtime (Algorithm 1) for ``engine="fused_e2e"``."""

from repro_torch.fed.engines import FusedE2EEngine
from repro_torch.fed.rounds import METHODS, FedConfig, FedRun, run_federated

__all__ = ["FusedE2EEngine", "METHODS", "FedConfig", "FedRun", "run_federated"]
