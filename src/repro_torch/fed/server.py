"""FL server state (Algorithm 1, server block) — the port of
``repro/fed/server.py``.  Aggregation, distillation and the broadcast run
inside the round (:mod:`repro_torch.fed.steps`); the server holds the LLM's
parameters between rounds for evaluation."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib

__all__ = ["Server"]


class Server:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        seed: int = 42,
        device: str | torch.device = "cuda",
        initial_params: dict | None = None,
    ):
        self.cfg = cfg
        self.params = (
            initial_params if initial_params is not None else model_lib.init(cfg, seed, device)
        )
