"""The decoder stack — the port of ``repro/models/transformer.py``'s
``stack_apply`` and ``init_stack_cache`` for the attention families
(``dense`` and ``moe``): pre-norm blocks of self-attention, then a dense or
a MoE MLP by ``cfg.is_moe_layer``, with LayerNorm or RMSNorm by
``cfg.norm``.  These families have a period of one layer, so every layer
is of one kind and the stack is the reference's one period ``pos0``.

Layer parameters keep the reference's layer-stacked layout: every leaf
under ``stack/pos0/`` has a leading ``(num_layers, ...)`` axis (after the
client axis, when the leaf is per client), and the ``lax.scan`` over layers
becomes a Python loop that slices layer ``l`` out of each leaf.  The decode
cache stacks the layers' KV caches the same way, ``(L, ...)``, and layer
``l`` writes into its slice in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache, attn_apply, init_kv_cache
from repro_torch.models.layers import mlp_apply, norm_apply, torch_dtype
from repro_torch.models.moe import moe_apply

__all__ = [
    "StackState", "STACK_PREFIX", "LAYER_NDIM", "layer_slice", "init_stack_cache", "stack_apply",
]

STACK_PREFIX = "stack/pos0/"
# dims of one layer's leaf of ONE model, by its last path component (a MoE
# layer's experts ``mlp/{up,down,gate}`` are (E, i, o)); a stack leaf has
# these + 1 (the layer axis), + 2 with a leading client axis
LAYER_NDIM = {"w": 2, "b": 1, "scale": 1, "bias": 1, "A": 2, "B": 2, "up": 3, "down": 3,
              "gate": 3}


class StackState(NamedTuple):
    x: torch.Tensor  # (C, B, S, D) activations
    moe_aux: torch.Tensor  # (C,) fp32 load-balance loss summed over the MoE layers
    lora_h: torch.Tensor | None  # (C, B, r) pooled projection of the last adapted layer


def layer_slice(params: dict[str, torch.Tensor], l: int) -> dict[str, torch.Tensor]:
    """Layer ``l`` of every ``stack/pos0/`` leaf, keyed relative to the
    layer (``attn/wq/w``, ``lora/q/A``, ...), client axis kept."""
    out = {}
    for key, t in params.items():
        if key.startswith(STACK_PREFIX):
            per_client = t.ndim == LAYER_NDIM[key.rsplit("/", 1)[-1]] + 2
            out[key[len(STACK_PREFIX):]] = t[:, l] if per_client else t[l]
    return out


def init_stack_cache(cfg: ModelConfig, batch: int, cache_len: int, *, window: int | None = None,
                     device: str | torch.device = "cuda") -> dict[str, KVCache]:
    """The stack's decode cache, ``{"pos0": KVCache}`` (the reference's
    period dict, one period for the attention families) with every field
    stacked over the ``cfg.num_layers`` layers; with a ``window`` a ring of
    ``min(cache_len, window)`` slots."""
    one = init_kv_cache(cfg, batch, cache_len if window is None else min(cache_len, window),
                        device)
    return {"pos0": KVCache(*(t.expand((cfg.num_layers,) + t.shape).clone() for t in one))}


def stack_apply(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                caches: dict[str, KVCache] | None = None,
                window: int | None = None) -> StackState:
    """Run the ``cfg.num_layers`` pre-norm blocks over ``x (C, B, S, D)``;
    with ``caches`` (decode) layer ``l`` attends over, and writes into, its
    slice of the stacked cache in place.  ``window``: the sliding window of
    every attention layer."""
    lora_h = None
    moe_aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    cd = torch_dtype(cfg.compute_dtype)
    is_moe = cfg.is_moe_layer(0)  # period one: every layer's MLP is of one kind
    for l in range(cfg.num_layers):
        lp = layer_slice(params, l)
        h_in = norm_apply(lp, "norm1", x, cfg.norm)
        cache = None if caches is None else KVCache(*(t[l] for t in caches["pos0"]))
        y, h = attn_apply(lp, h_in, cfg, cache=cache, window=window)
        if h is not None:
            lora_h = h.mean(dim=2)  # (C, B, r): paper eq. 8, pooled over the sequence
        x = x + y
        h2 = norm_apply(lp, "norm2", x, cfg.norm)
        if is_moe:
            y2, aux = moe_apply(lp, h2, cfg)
            moe_aux = moe_aux + aux
        else:
            y2 = mlp_apply(lp, h2, activation=cfg.activation, cd=cd)
        x = x + y2
    return StackState(x=x, moe_aux=moe_aux, lora_h=lora_h)
