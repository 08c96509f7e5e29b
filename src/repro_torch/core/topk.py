"""Adaptive Top-k logit sparsification as the sparse uplink wire (paper
§III-A, eqs. 3-4) — the port of ``repro/core/topk.py``'s wire formats.

A cohort's upload is ONE fixed-width wire: for every client and public
sample the ``k_cap`` largest logits as ``(values, indices)`` plus an
explicit transmit mask (client ``n`` transmits its first ``k_n`` entries;
a dropped straggler, ``k = 0``, transmits nothing).  ``quantize_wire``
turns it into the int8 wire with one fp32 scale per (client, sample) row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "QUANT_LEVELS",
    "SparseWire",
    "QuantizedWire",
    "sparsify_wire",
    "quantize_wire",
]

# Symmetric int8 range: round(v / scale) lands in [-127, 127], so the scale
# amax/127 is exactly invertible at the extremes and -128 is never emitted.
QUANT_LEVELS = 127


class SparseWire(NamedTuple):
    """values (N, ..., k_cap) (0 where not transmitted), indices
    (N, ..., k_cap) int32, mask (N, ..., k_cap) bool, vocab (python int)."""

    values: torch.Tensor
    indices: torch.Tensor
    mask: torch.Tensor
    vocab: int

    @property
    def k_cap(self) -> int:
        return int(self.values.shape[-1])


class QuantizedWire(NamedTuple):
    """The sparse wire with int8 values and a per-(client, sample)-row fp32
    ``scale (N, ...)`` (1.0 for rows that transmit nothing)."""

    values: torch.Tensor
    scale: torch.Tensor
    indices: torch.Tensor
    mask: torch.Tensor
    vocab: int

    @property
    def k_cap(self) -> int:
        return int(self.values.shape[-1])


def quantize_wire(wire: SparseWire) -> QuantizedWire:
    """Symmetric per-row int8 quantization: scale ``max|v| / 127`` over the
    row's transmitted entries (1.0 when there are none); ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    v = torch.where(wire.mask, wire.values, 0).float()
    amax = torch.amax(torch.abs(v), dim=-1)
    scale = torch.where(amax > 0, amax / QUANT_LEVELS, 1.0).float()
    q = torch.clamp(torch.round(v / scale[..., None]), -QUANT_LEVELS, QUANT_LEVELS)
    return QuantizedWire(
        values=q.to(torch.int8), scale=scale, indices=wire.indices,
        mask=wire.mask, vocab=wire.vocab,
    )


def sparsify_wire(
    logits: torch.Tensor, ks: torch.Tensor, k_cap: int, *, quantize: bool = False
) -> SparseWire | QuantizedWire:
    """Per-client adaptive top-k of ``(N, ..., vocab)`` logits as the wire,
    with the budgets ``ks`` (int, one per client) as data.

    ``lax.top_k`` in the reference is a stable select — on ties the lower
    index comes first — which ``torch.topk`` does not promise; a stable
    descending sort sliced at ``k_cap`` gives the identical order.
    """
    vocab = logits.shape[-1]
    k_cap = int(min(k_cap, vocab))
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    values, indices = values[..., :k_cap], indices[..., :k_cap]
    kk = torch.clamp(torch.as_tensor(ks, dtype=torch.int32, device=logits.device), 0, vocab)
    kk = kk.reshape(kk.shape + (1,) * (values.ndim - kk.ndim))
    mask = torch.arange(k_cap, dtype=torch.int32, device=logits.device) < kk
    mask = mask.expand(values.shape).contiguous()
    wire = SparseWire(
        values=torch.where(mask, values, 0.0),
        indices=indices.to(torch.int32).contiguous(),
        mask=mask,
        vocab=vocab,
    )
    return quantize_wire(wire) if quantize else wire

