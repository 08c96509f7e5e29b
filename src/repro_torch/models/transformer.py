"""The dense decoder stack — the port of ``repro/models/transformer.py``'s
``stack_apply`` for the GPT-2 family.

Layer parameters keep the reference's layer-stacked layout: every leaf
under ``stack/pos0/`` has a leading ``(num_layers, ...)`` axis (after the
client axis, when the leaf is per client), and the ``lax.scan`` over layers
becomes a Python loop that slices layer ``l`` out of each leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attn_apply
from repro_torch.models.layers import gelu, layer_norm, linear

__all__ = ["StackState", "STACK_PREFIX", "layer_slice", "stack_apply"]

STACK_PREFIX = "stack/pos0/"
# dims of one layer's leaf of ONE model, by its last path component; a
# stack leaf has these + 1 (the layer axis), + 2 with a leading client axis
_LAYER_NDIM = {"w": 2, "b": 1, "scale": 1, "bias": 1, "A": 2, "B": 2}


class StackState(NamedTuple):
    x: torch.Tensor  # (C, B, S, D) activations
    lora_h: torch.Tensor | None  # (C, B, r) pooled projection of the last adapted layer


def layer_slice(params: dict[str, torch.Tensor], l: int) -> dict[str, torch.Tensor]:
    """Layer ``l`` of every ``stack/pos0/`` leaf, keyed relative to the
    layer (``attn/wq/w``, ``lora/q/A``, ...), client axis kept."""
    out = {}
    for key, t in params.items():
        if key.startswith(STACK_PREFIX):
            per_client = t.ndim == _LAYER_NDIM[key.rsplit("/", 1)[-1]] + 2
            out[key[len(STACK_PREFIX):]] = t[:, l] if per_client else t[l]
    return out


def stack_apply(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> StackState:
    """Run the ``cfg.num_layers`` pre-norm blocks over ``x (C, B, S, D)``."""
    lora_h = None
    for l in range(cfg.num_layers):
        lp = layer_slice(params, l)
        h_in = layer_norm(x, lp["norm1/scale"], lp["norm1/bias"])
        y, h = attn_apply(lp, h_in, cfg)
        if h is not None:
            lora_h = h.mean(dim=2)  # (C, B, r): paper eq. 8, pooled over the sequence
        x = x + y
        h2 = layer_norm(x, lp["norm2/scale"], lp["norm2/bias"])
        up = gelu(linear(h2, lp["mlp/up/w"], lp.get("mlp/up/b")))
        x = x + linear(up, lp["mlp/down/w"], lp.get("mlp/down/b"))
    return StackState(x=x, lora_h=lora_h)
