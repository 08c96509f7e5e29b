"""The LM training step — the port of ``repro/launch/steps.py``.

  train_step   — next-token LM loss (chunked cross-entropy: the (B, S, V)
                 logits never exist at once), full-parameter AdamW,
                 gradient accumulation over ``cfg.microbatches``.
  prefill_step — :func:`repro_torch.serve.steps.make_prefill_step`.
  serve_step   — :func:`repro_torch.serve.steps.make_decode_step`.

A step takes ONE model's parameters (every leaf shared, no client axis)
and its AdamW state on a client axis of 1 (:func:`init_train_opt`): the
port's AdamW clips each client over its own leaves, so a single model's
tree is handed to it as one client, and the clip spans the whole tree as
the reference's does.  The reference jits the step; the port runs it
eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import _lm_logits, backbone
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.sharding import constrain, local_apply

# the serving steps live in repro_torch.serve, re-exported as the reference does
from repro_torch.serve.steps import make_decode_step as make_serve_step
from repro_torch.serve.steps import make_prefill_step

__all__ = [
    "CE_CHUNK",
    "chunked_lm_loss",
    "init_train_opt",
    "full_grads",
    "full_adamw_step",
    "make_train_loss",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
]

CE_CHUNK = 512  # sequence positions per cross-entropy chunk


def chunked_lm_loss(params: dict, cfg: ModelConfig, h: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy summed over ``(..., S)`` in chunks over S,
    divided by ``max(1, Σ mask)``.

    ``h (..., S, d)`` hidden states, ``targets``/``mask (..., S)``.  S is
    padded to a multiple of the chunk (the padding masked out).  Each chunk
    computes its own head matmul and log-sum-exp; with more than one chunk
    each is recomputed in the backward pass (activation checkpointing), so
    peak memory holds one ``(..., CE_CHUNK, V)`` block of logits instead
    of ``(..., S, V)``, as the reference's scan does."""
    s = h.shape[-2]
    chunk = min(CE_CHUNK, s)
    pad = (-s) % chunk
    if pad:
        h = _pad_positions(h, pad, h.ndim - 2)
        targets = _pad_positions(targets, pad, targets.ndim - 1)
        mask = _pad_positions(mask, pad, mask.ndim - 1)

    def one(hc, tc, mc):
        # (..., chunk, V); on a mesh the chunk's vocab gathered whole first
        logits = constrain(_lm_logits(params, cfg, hc, None).float(),
                           *(None,) * (hc.ndim - 3), "batch", None, None)
        logz = torch.logsumexp(logits, dim=-1)
        tgt_logit = torch.gather(logits, -1, tc[..., None].long())[..., 0]
        return torch.sum((logz - tgt_logit) * mc)

    n_chunks = h.shape[-2] // chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        part = (h[..., i * chunk:(i + 1) * chunk, :], targets[..., i * chunk:(i + 1) * chunk],
                mask[..., i * chunk:(i + 1) * chunk])
        if n_chunks > 1 and torch.is_grad_enabled():
            total = total + torch.utils.checkpoint.checkpoint(one, *part, use_reentrant=False)
        else:
            total = total + one(*part)
    return total / torch.clamp(torch.sum(mask), min=1.0)


def _pad_positions(x: torch.Tensor, pad: int, seq_dim: int) -> torch.Tensor:
    """``x`` with ``pad`` zeros after the last position of ``seq_dim``.  On a
    mesh each rank pads its own batch rows (the positions are whole on
    every rank), as DTensor's own pad may lose a mesh dim's placement."""
    widths = (0, 0) * (x.ndim - 1 - seq_dim) + (0, pad)
    logical = tuple("batch" if d == seq_dim - 1 else None for d in range(x.ndim))
    return local_apply(lambda t: torch.nn.functional.pad(t, widths), (x,), (logical,), logical,
                       {"batch": x.shape[seq_dim - 1]})


def init_train_opt(params: dict[str, torch.Tensor], cfg: ModelConfig) -> AdamWState:
    """AdamW state for every leaf of one model, on a client axis of 1."""
    return adamw_init({k: v[None] for k, v in params.items()},
                      state_dtype=cfg.optimizer_state_dtype)


def full_grads(loss_fn: Callable, params: dict[str, torch.Tensor], *args):
    """``(loss_fn's outputs, grads)`` for every leaf of ``params``:
    ``loss_fn(params, *args)`` returns ``(loss, *metrics)``, the gradient is
    of ``loss``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        out = loss_fn(leaves, *args)
        # a leaf the loss does not read (an ``o`` adapter) gets a zero
        # gradient, as jax.grad gives it
        grads = torch.autograd.grad(out[0], list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    return tuple(o.detach() for o in out), dict(zip(leaves, grads))


def full_adamw_step(grads: dict, opt: AdamWState, params: dict, *, lr: float,
                    weight_decay: float) -> tuple[dict, AdamWState]:
    """AdamW on every leaf of one model, as one client: the clip is taken
    over the whole tree."""
    new, opt = adamw_update({k: g[None] for k, g in grads.items()}, opt,
                            {k: p[None] for k, p in params.items()}, lr=lr,
                            weight_decay=weight_decay)
    return {k: v[0] for k, v in new.items()}, opt


def make_train_loss(cfg: ModelConfig, *, router_aux_weight: float = 0.01) -> Callable:
    """The train step's loss: ``loss_fn(params, tokens (B, S), frontend=None)
    -> (loss, ce)``, the next-token CE plus ``router_aux_weight`` times the
    MoE router's auxiliary loss; :func:`full_grads` takes it."""

    def loss_fn(params, tokens, frontend=None):
        h, aux = backbone(params, cfg, tokens[None], frontend=frontend)
        targets = tokens[None, :, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32, device=tokens.device)
        ce = chunked_lm_loss(params, cfg, h[:, :, :-1], targets, mask)
        return ce + router_aux_weight * aux.moe_aux[0], ce

    return loss_fn


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, weight_decay: float = 0.1,
                    router_aux_weight: float = 0.01) -> Callable:
    """LM pretraining/fine-tuning step over a ``{"tokens": (B, S)}`` batch
    (plus ``"frontend" (B, F, d)`` for a VLM or audio model, the stub's
    draw when absent), full-parameter AdamW.

    step(params, opt (from :func:`init_train_opt`), batch)
    -> (params, opt, {"loss": (), "ce": ()})

    The loss is the next-token CE plus ``router_aux_weight`` times the MoE
    router's auxiliary loss (0 without MoE layers).  With
    ``cfg.microbatches = m > 1`` dividing the batch, the gradients of the m
    microbatches are summed in the params' dtype and divided by m."""
    loss_fn = make_train_loss(cfg, router_aux_weight=router_aux_weight)

    def train_step(params, opt: AdamWState, batch):
        tokens, frontend = batch["tokens"], batch.get("frontend")
        bsz, m = tokens.shape[0], cfg.microbatches
        if m > bsz or bsz % m != 0:
            m = 1  # smoke-scale batches: accumulate-free step
        if m <= 1:
            (loss, ce), grads = full_grads(loss_fn, params, tokens, frontend)
        else:
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            fronts = [None] * m if frontend is None else frontend.chunk(m)
            for micro, micro_f in zip(tokens.chunk(m), fronts):
                (loss, _), g = full_grads(loss_fn, params, micro, micro_f)
                grads = {k: grads[k] + g[k].to(grads[k].dtype) for k in grads}
                loss_sum = loss_sum + loss
            grads = {k: g / m for k, g in grads.items()}
            loss = ce = loss_sum / m
        params, opt = full_adamw_step(grads, opt, params, lr=lr, weight_decay=weight_decay)
        return params, opt, {"loss": loss, "ce": ce}

    return train_step
