"""The dense and MoE model families with LoRA, on tensors with a client axis."""

from repro_torch.models import model
from repro_torch.models.model import Aux, decode_step, forward, init, init_cache, prefill

__all__ = ["model", "Aux", "forward", "init", "init_cache", "decode_step", "prefill"]
