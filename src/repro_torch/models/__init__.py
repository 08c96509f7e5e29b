"""Every model family with LoRA — dense, MoE, SSM, hybrid, the VLM and the
audio encoder-decoder — on tensors with a client axis."""

from repro_torch.models import model
from repro_torch.models.model import Aux, backbone, decode_step, forward, init, init_cache, prefill

__all__ = ["model", "Aux", "backbone", "decode_step", "forward", "init", "init_cache", "prefill"]
