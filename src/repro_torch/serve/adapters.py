"""Adapter slab: per-tenant LoRA rows stacked on the device, gathered per
request — the port of ``repro/serve/adapters.py``.

One frozen backbone lives on the device, shared by every tenant; a slab
holds ``slots`` adapter rows, every LoRA leaf with a new leading
``(slots, ...)`` axis; a decode step gathers row ``idx[b]`` for request b.
The gathered leaves are ``(B, ...)``: the port's model takes them as its
leading client axis (B requests of batch 1 each), so no axis moves — the
reference moves the batch inside its layer axis instead.
"""

from __future__ import annotations

import torch

from repro_torch import bridge

__all__ = ["slab_init", "slab_set_row", "gather_adapters", "canonicalize_row"]


def slab_init(like: dict, slots: int, device: str | torch.device = "cuda") -> dict:
    """A zeroed slab on ``device``: every leaf of ``like`` (an adapter row
    or a ``lora_template`` skeleton) gains a leading ``(slots,)`` axis."""
    return {k: torch.zeros((slots,) + tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in like.items()}


def slab_set_row(slab: dict, row: dict, slot: int) -> dict:
    """Write one adapter row into ``slab[slot]``, in place; returns the slab."""
    for k, s in slab.items():
        s[slot].copy_(row[k])
    return slab


def gather_adapters(slab: dict, idx: torch.Tensor) -> dict:
    """Per-request adapters: rows ``idx (B,)`` of every slab leaf, ``(B, ...)``."""
    return {k: v.index_select(0, idx) for k, v in slab.items()}


def canonicalize_row(raw: dict, like: dict) -> dict:
    """A raw adapter row (flat ``a/b/c`` keys or a nested dict) checked
    against ``like``: every leaf present with the expected shape, in the
    expected dtype."""
    flat = bridge.flatten(raw)
    out = {}
    for key, leaf in like.items():
        val = flat.get(key)
        if val is None:
            raise KeyError(f"adapter row is missing leaf {key!r} — the source does not match "
                           "the model's LoRA structure")
        if tuple(val.shape) != tuple(leaf.shape):
            raise ValueError(f"adapter leaf {key!r} has shape {tuple(val.shape)}, model expects "
                             f"{tuple(leaf.shape)}")
        out[key] = torch.as_tensor(val).to(leaf.dtype)
    return out
