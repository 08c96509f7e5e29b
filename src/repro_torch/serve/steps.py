"""Serving step factories — the port of ``repro/serve/steps.py``.

  decode_step         — one token against the cache, one model's params.
  stacked_decode_step — one token, per-request adapters: gathers row
                        ``idx[b]`` of the adapter slab for request b and
                        merges the rows into the shared frozen backbone.
  prefill_step        — full forward over a prompt, last-position logits.

The reference jits these; the port runs them eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.lora import merge_lora
from repro_torch.models import decode_step as model_decode_step
from repro_torch.models import prefill as model_prefill
from repro_torch.serve.adapters import gather_adapters

__all__ = ["make_decode_step", "make_stacked_decode_step", "make_prefill_step"]


def make_decode_step(cfg: ModelConfig, *, window: int | None = None) -> Callable:
    """(params, cache, token (B,)) -> (logits (B, V), cache)."""

    @torch.no_grad()
    def decode_step(params, cache, token):
        return model_decode_step(params, cfg, cache, token, window=window)

    return decode_step


def make_stacked_decode_step(cfg: ModelConfig, *, window: int | None = None) -> Callable:
    """(frozen, slab, idx (B,), cache, token (B,)) -> (logits, cache): the
    multi-tenant decode step.  ``frozen``: the shared backbone
    (``split_lora()[1]``); ``slab``: the adapter slab; ``idx``: the slab
    slot of each request."""

    @torch.no_grad()
    def stacked_decode_step(frozen, slab, idx, cache, token):
        params = merge_lora(gather_adapters(slab, idx), frozen)
        return model_decode_step(params, cfg, cache, token, window=window)

    return stacked_decode_step


def make_prefill_step(cfg: ModelConfig, *, window: int | None = None) -> Callable:
    """(params, batch {"tokens": (B, S)}) -> last-position logits (B, V)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model_prefill(params, cfg, batch, window=window)
        return logits

    return prefill_step
