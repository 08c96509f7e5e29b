"""The dense, MoE, SSM and hybrid model families with LoRA, on tensors with a
client axis."""

from repro_torch.models import model
from repro_torch.models.model import Aux, backbone, decode_step, forward, init, init_cache, prefill

__all__ = ["model", "Aux", "backbone", "decode_step", "forward", "init", "init_cache", "prefill"]
