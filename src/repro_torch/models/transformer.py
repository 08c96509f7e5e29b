"""The layer stacks — the port of ``repro/models/transformer.py``'s
``period_of``, ``stack_apply`` and ``init_stack_cache`` for the
attention families (``dense``, ``moe``, and the VLM's decoder), the
attention-free SSM family (Mamba2: the SSD mixer is the whole layer, no
second norm and no MLP), the hybrid (Jamba: SSD mixers with an attention
layer every ``attn_every`` layers and a MoE MLP every ``moe_every``) and
the encoder-decoder (audio): a bidirectional encoder stack under
``encoder/`` and a decoder whose layers add a cross-attention sub-layer
(``norm_x`` then ``cross``, between the mixer and the MLP) over the
encoder's output.

Layers repeat with a **period** of ``p`` positions (1 for the uniform
families; ``lcm(attn_every, moe_every)`` for the hybrid), and layer ``i =
r·p + j`` is repeat ``r`` of position ``j``.  Parameters keep the
reference's layout: every leaf under ``stack/pos{j}/``
(``encoder/pos{j}/`` for the encoder) has a leading ``(num_layers // p,
...)`` repeats axis (after the client axis, when the leaf is per client).
The reference's ``lax.scan`` over repeats becomes a Python loop, repeats
outermost and positions inside them, which slices repeat ``r`` out of each
leaf.  The decode cache is the same period dict: a ``KVCache`` at each
attention position and an ``SSMCache`` at each SSM position, each field
stacked over the repeats, and layer ``i`` writes into its slice in place.
An encoder stack has period 1 unless it is as deep as the decoder, when it
takes the decoder's (the reference's rule).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache, attn_apply, cross_attn_apply, init_kv_cache
from repro_torch.models.layers import mlp_apply, norm_apply, torch_dtype
from repro_torch.models.moe import moe_apply
from repro_torch.models.ssm import SSMCache, init_ssm_cache, ssm_apply
from repro_torch.sharding import constrain

__all__ = [
    "StackState", "STACK_PREFIX", "ENCODER_PREFIX", "STACK_PREFIXES", "LAYER_NDIM", "period_of",
    "stack_period", "layer_kinds", "pos_prefix", "layer_slice", "init_stack_cache", "stack_apply",
]

STACK_PREFIX = "stack/"
ENCODER_PREFIX = "encoder/"
STACK_PREFIXES = (STACK_PREFIX, ENCODER_PREFIX)
# dims of one layer's leaf of ONE model, by its last path component (a MoE
# layer's experts ``mlp/{up,down,gate}`` are (E, i, o)); a stack leaf has
# these + 1 (the repeats axis), + 2 with a leading client axis
LAYER_NDIM = {"w": 2, "b": 1, "scale": 1, "bias": 1, "A": 2, "B": 2, "up": 3, "down": 3,
              "gate": 3, "conv_x_w": 2, "conv_bc_w": 2, "conv_x_b": 1, "conv_bc_b": 1,
              "dt_bias": 1, "a_log": 1, "d_skip": 1}


class StackState(NamedTuple):
    x: torch.Tensor  # (C, B, S, D) activations
    moe_aux: torch.Tensor  # (C,) fp32 load-balance loss summed over the MoE layers
    lora_h: torch.Tensor | None  # (C, B, r) pooled projection of the last adapted layer


def period_of(cfg: ModelConfig) -> int:
    """Positions in the repeating layer period: 1, or for the hybrid
    ``attn_every`` (lcm'd with ``moe_every`` when it has MoE)."""
    if cfg.family != "hybrid":
        return 1
    p = cfg.attn_every if cfg.moe is None else math.lcm(cfg.attn_every, cfg.moe_every)
    assert cfg.num_layers % p == 0, (
        f"{cfg.name}: num_layers={cfg.num_layers} not divisible by period {p}")
    return p


def stack_period(cfg: ModelConfig, num_layers: int) -> int:
    """The period of a stack of ``num_layers``: the model's, or 1 for an
    encoder of another depth than the decoder's."""
    p = period_of(cfg)
    return p if num_layers == cfg.num_layers else 1


def layer_kinds(cfg: ModelConfig, j: int) -> tuple[str, str | None]:
    """``(mixer, mlp)`` of position ``j``: ``"attn"`` or ``"ssm"``, and
    ``"moe"``, ``"dense"`` or None (the SSM family has no MLP)."""
    mixer = "attn" if cfg.is_attention_layer(j) else "ssm"
    if cfg.family == "ssm":
        return mixer, None
    return mixer, "moe" if cfg.is_moe_layer(j) else "dense"


def pos_prefix(j: int, prefix: str = STACK_PREFIX) -> str:
    return f"{prefix}pos{j}/"


def layer_slice(params: dict[str, torch.Tensor], j: int, r: int,
                prefix: str = STACK_PREFIX) -> dict[str, torch.Tensor]:
    """Repeat ``r`` of every ``{prefix}pos{j}/`` leaf, keyed relative to
    the layer (``attn/wq/w``, ``ssm/a_log``, ``lora/q/A``, ``cross/wk/w``,
    ...), client axis kept."""
    pre, out = pos_prefix(j, prefix), {}
    for key, t in params.items():
        if key.startswith(pre):
            per_client = t.ndim == LAYER_NDIM[key.rsplit("/", 1)[-1]] + 2
            out[key[len(pre):]] = t[:, r] if per_client else t[r]
    return out


def init_stack_cache(cfg: ModelConfig, batch: int, cache_len: int, *, window: int | None = None,
                     device: str | torch.device = "cuda") -> dict[str, KVCache | SSMCache]:
    """The stack's decode cache, the reference's period dict ``{"pos{j}":
    KVCache or SSMCache}`` with every field stacked over the position's
    repeats; with a ``window`` each attention layer keeps a ring of
    ``min(cache_len, window)`` slots."""
    p = period_of(cfg)
    out = {}
    for j in range(p):
        if layer_kinds(cfg, j)[0] == "attn":
            one = init_kv_cache(cfg, batch, cache_len if window is None
                                else min(cache_len, window), device)
        else:
            one = init_ssm_cache(cfg, batch, device)
        out[f"pos{j}"] = type(one)(*(t.expand((cfg.num_layers // p,) + t.shape).clone()
                                     for t in one))
    return out


def stack_apply(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                caches: dict[str, KVCache | SSMCache] | None = None,
                window: int | None = None, prefix: str = STACK_PREFIX,
                num_layers: int | None = None, causal: bool = True,
                enc_out: torch.Tensor | None = None, pool_moe: bool = False) -> StackState:
    """Run the ``num_layers`` (default ``cfg.num_layers``) pre-norm blocks
    of the stack under ``prefix`` over ``x (C, B, S, D)``, layer ``r·p +
    j`` for repeats ``r`` and positions ``j``; with ``caches`` (decode)
    each layer reads, and writes into, its slice of the stacked cache in
    place.  ``window``: the sliding window of every attention layer;
    ``causal=False``: bidirectional self-attention (the encoder).  With
    ``enc_out (C, B, T, D)`` a layer that has a ``cross`` sub-layer
    cross-attends to it.  ``pool_moe`` routes each MoE layer's tokens
    across the client axis as one set (``moe_apply``'s ``pool_clients``:
    the stacked decode).  ``lora_h`` starts at zeros when a position of
    the period is an attention layer and the model has LoRA (the
    reference's start: such a model whose adapters give no projection
    reports zeros), else at None.  With ``cfg.remat``, grad on and no
    ``caches``, each repeat runs under a non-reentrant
    ``torch.utils.checkpoint``, and so does each position of a period of
    several (the reference's nested remat); the results are the same."""
    num_layers = cfg.num_layers if num_layers is None else num_layers
    p = stack_period(cfg, num_layers)
    kinds = [layer_kinds(cfg, j) for j in range(p)]
    lora_h = None
    if cfg.lora is not None and any(mixer == "attn" for mixer, _ in kinds):
        lora_h = torch.zeros(x.shape[:2] + (cfg.lora.rank,), dtype=torch_dtype(cfg.compute_dtype),
                             device=x.device)
    moe_aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    cd = torch_dtype(cfg.compute_dtype)

    def residual(x):  # the stream batch-sharded, whole over "model" (the identity without rules)
        return constrain(x, None, "batch", None, None)

    def layer(j, r, state):
        """Layer ``r·p + j`` on ``state = [x, moe_aux, lora_h]``, which it
        empties: no caller holds the stream once its first residual
        replaces it."""
        x, moe_aux, lora_h = state
        state.clear()
        mixer, mlp = kinds[j]
        lp = layer_slice(params, j, r, prefix)
        cache = None if caches is None else type(caches[f"pos{j}"])(
            *(t[r] for t in caches[f"pos{j}"]))
        h_in = norm_apply(lp, "norm1", x, cfg.norm)
        if mixer == "attn":
            y, h = attn_apply(lp, h_in, cfg, cache=cache, window=window, causal=causal)
            if h is not None:
                lora_h = h.mean(dim=2)  # (C, B, r): paper eq. 8, pooled over the sequence
        else:
            y = ssm_apply(lp, h_in, cfg, cache=cache)
        x = residual(x + y)
        if enc_out is not None and "cross/wq/w" in lp:
            x = residual(x + cross_attn_apply(lp, norm_apply(lp, "norm_x", x, cfg.norm),
                                              enc_out, cfg))
        if mlp is None:
            return [x, moe_aux, lora_h]
        h2 = norm_apply(lp, "norm2", x, cfg.norm)
        if mlp == "moe":
            y2, aux = moe_apply(lp, h2, cfg, pool_clients=pool_moe)
            moe_aux = moe_aux + aux
        else:
            y2 = mlp_apply(lp, h2, activation=cfg.activation, cd=cd)
        return [residual(x + y2), moe_aux, lora_h]

    # remat (the reference's jax.checkpoint): a pass a backward can follow
    # keeps only each repeat's inputs and recomputes the repeat's layers in
    # the backward, and a period of several positions checkpoints each one
    # inside it too; a cached or no-grad pass has nothing to keep.  On a mesh
    # the recompute runs in the step's backward, which every step takes
    # inside its ``sharding.on_mesh``, so the activation rules hold for it
    remat = cfg.remat and caches is None and torch.is_grad_enabled()

    def checkpointed(fn, state):
        """``fn(state)`` under a non-reentrant checkpoint, which keeps the
        state's tensors for the recompute."""
        return list(torch.utils.checkpoint.checkpoint(
            lambda *s: tuple(fn(list(s))), *state, use_reentrant=False))

    def period(r, state):
        for j in range(p):
            one = functools.partial(layer, j, r)
            state = checkpointed(one, state) if remat and p > 1 else one(state)
        return state

    state = [residual(x), moe_aux, lora_h]
    for r in range(num_layers // p):
        one = functools.partial(period, r)
        state = checkpointed(one, state) if remat else one(state)
    x, moe_aux, lora_h = state
    return StackState(x=x, moe_aux=moe_aux, lora_h=lora_h)
