"""Adaptive Top-k logit sparsification (paper §III-A, eqs. 3-4) — the
port of ``repro/core/topk.py``.

Two uplink forms:

* the DENSE top-k mask, ``(..., vocab)`` with zeros off the support, which
  the ``batched`` and ``fused`` engines hand to the dense aggregation:
  :func:`topk_mask_batch` (one exact top-k per client) and
  :func:`topk_mask_dynamic` (the threshold bisection the ``fused`` engine
  runs, whose CUDA kernel is :func:`repro_torch.kernels.ops.topk_mask_dynamic`);
* the sparse WIRE of the ``fused_e2e`` engine: for every client and public
  sample the ``k_cap`` largest logits as ``(values, indices)`` plus an
  explicit transmit mask (client ``n`` transmits its first ``k_n`` entries;
  a dropped straggler, ``k = 0``, transmits nothing).  ``quantize_wire``
  turns it into the int8 wire with one fp32 scale per (client, sample) row.
  The wires of several family buckets merge into one union wire
  (:func:`concat_wires`: each padded to the widest ``k_cap`` with masked
  zeros at index 0, which the aggregation skips).

``lax.top_k`` in the reference is a stable select — on ties the lower
index comes first — which ``torch.topk`` does not promise; a stable
descending sort sliced at ``k`` gives the identical order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels.ref import BISECTION_ITERS, topk_mask_ref

__all__ = [
    "BISECTION_ITERS",
    "QUANT_LEVELS",
    "SparseLogits",
    "topk_sparsify",
    "densify",
    "sparsify_batch",
    "payload_entries",
    "topk_mask_dense",
    "topk_mask_batch",
    "topk_mask_dynamic",
    "SparseWire",
    "QuantizedWire",
    "sparsify_wire",
    "quantize_wire",
    "dequantize_wire",
    "pad_wire",
    "concat_wires",
    "take_wire_rows",
    "wire_densify",
    "wire_support",
]

# Symmetric int8 range: round(v / scale) lands in [-127, 127], so the scale
# amax/127 is exactly invertible at the extremes and -128 is never emitted.
QUANT_LEVELS = 127

class SparseLogits(NamedTuple):
    """One payload's top-k: ``values``/``indices (..., k)`` descending,
    ``k`` and ``vocab`` python ints."""

    values: torch.Tensor
    indices: torch.Tensor
    k: int
    vocab: int


def _stable_topk(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest per row, ties broken by lower index."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def topk_sparsify(logits: torch.Tensor, k: int) -> SparseLogits:
    """The top-k logits per row (paper eq. 3); the last axis is the vocab."""
    vocab = logits.shape[-1]
    k = int(min(k, vocab))
    values, indices = _stable_topk(logits, k)
    return SparseLogits(values=values, indices=indices.to(torch.int32), k=k, vocab=vocab)


def densify(sparse: SparseLogits, *, fill: float = 0.0) -> torch.Tensor:
    """Scatter a payload back to a dense ``(..., vocab)`` tensor (paper
    eq. 4: zeros off the top-k support, unless ``fill`` overrides)."""
    shape = sparse.values.shape[:-1] + (sparse.vocab,)
    dense = torch.full(shape, fill, dtype=sparse.values.dtype, device=sparse.values.device)
    return dense.scatter_(-1, sparse.indices.long(), sparse.values)


def sparsify_batch(logits: torch.Tensor, k: int) -> SparseLogits:
    """:func:`topk_sparsify` of a ``(num_samples, vocab)`` batch: one
    client's public-set upload of a round."""
    return topk_sparsify(logits, k)


def payload_entries(sparse: SparseLogits) -> int:
    """The (value, index) entries of a payload: samples · k."""
    return int(sparse.values.numel())


def topk_mask_dense(logits: torch.Tensor, k: int, *, use_kernel: bool = False) -> torch.Tensor:
    """Keep the top-k per row, zero elsewhere.  ``use_kernel`` routes to the
    bisection kernel (:func:`repro_torch.kernels.ops.topk_mask`), whose
    threshold semantics keep every tie at the k-th value."""
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return kops.topk_mask(logits, k)
    return densify(topk_sparsify(logits, k))


def topk_mask_batch(logits: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Per-client densified top-k of a ``(C, ..., vocab)`` stack with one
    budget per client: one stable top-k at ``max(ks)``, client ``i``'s
    entries beyond ``ks[i]`` zeroed before the scatter — equal to
    ``densify(topk_sparsify(logits[i], ks[i]))`` for every client."""
    if logits.shape[0] != len(ks):
        raise ValueError(f"{len(ks)} budgets for {logits.shape[0]} clients")
    vocab = logits.shape[-1]
    ks = [int(min(k, vocab)) for k in ks]
    if min(ks) < 0:
        raise ValueError(f"negative top-k budget in {ks}")
    k_max = max(ks + [1])
    values, indices = _stable_topk(logits, k_max)
    karr = torch.as_tensor(ks, dtype=torch.int32, device=logits.device)
    karr = karr.reshape((len(ks),) + (1,) * (logits.ndim - 1))
    keep = torch.arange(k_max, dtype=torch.int32, device=logits.device) < karr
    values = torch.where(keep, values, torch.zeros_like(values))
    return torch.zeros_like(logits).scatter_(-1, indices, values)


def topk_mask_dynamic(logits: torch.Tensor, k) -> torch.Tensor:
    """Dense top-k mask with the budget as DATA: ``k`` (ints or an int
    tensor) broadcastable to ``logits.shape[:-1]``, clamped to ``[0, vocab]``.

    The reference's fp32 threshold bisection (:func:`repro_torch.kernels.
    ref.topk_mask_ref`): every tie at the k-th value is kept, and ``k == 0``
    zeroes the row (a dropped straggler transmits nothing)."""
    vocab = logits.shape[-1]
    kk = torch.clamp(torch.as_tensor(k, dtype=torch.int32, device=logits.device), 0, vocab)
    kk = torch.broadcast_to(kk, logits.shape[:-1]).reshape(-1)
    out = topk_mask_ref(logits.reshape(-1, vocab), kk, guard=True)
    return out.reshape(logits.shape)


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


def dequantize_wire(wire: QuantizedWire) -> SparseWire:
    """The float wire back from the int8 one: ``values · scale`` a row,
    exact zeros off the transmit mask."""
    v = wire.values.float() * wire.scale[..., None]
    return SparseWire(values=torch.where(wire.mask, v, 0.0), indices=wire.indices,
                      mask=wire.mask, vocab=wire.vocab)


def sparsify_wire(
    logits: torch.Tensor, ks: torch.Tensor, k_cap: int, *, quantize: bool = False
) -> SparseWire | QuantizedWire:
    """Per-client adaptive top-k of ``(N, ..., vocab)`` logits as the wire,
    with the budgets ``ks`` (int, one per client) as data."""
    vocab = logits.shape[-1]
    k_cap = int(min(k_cap, vocab))
    values, indices = _stable_topk(logits, k_cap)
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


def pad_wire(wire: SparseWire | QuantizedWire, k_cap: int) -> SparseWire | QuantizedWire:
    """Widen a wire to ``k_cap`` entries a row with masked-out padding
    (value 0, index 0, mask False), which the densify and the aggregation
    skip; the quantized wire's per-row ``scale`` is untouched."""
    pad = k_cap - wire.k_cap
    if pad < 0:
        raise ValueError(f"cannot shrink a wire from {wire.k_cap} to {k_cap}")
    if pad == 0:
        return wire
    widen = lambda t: torch.nn.functional.pad(t, (0, pad))  # noqa: E731
    fields = {"values": widen(wire.values), "indices": widen(wire.indices),
              "mask": widen(wire.mask)}
    if isinstance(wire, QuantizedWire):
        fields["scale"] = wire.scale
    return type(wire)(vocab=wire.vocab, **fields)


def concat_wires(wires: Sequence[SparseWire | QuantizedWire]) -> SparseWire | QuantizedWire:
    """The union of several cohorts' uplinks as one wire: each padded to the
    widest ``k_cap``, then concatenated on the leading client axis.  The
    wire is vocab-indexed, so the union of family buckets' wires
    aggregates as one cohort's; every wire must address one vocabulary and
    be of one format."""
    if not wires:
        raise ValueError("concat_wires needs at least one wire")
    vocabs = {w.vocab for w in wires}
    if len(vocabs) > 1:
        raise ValueError(f"wires address different vocabularies: {sorted(vocabs)}")
    if len({type(w) for w in wires}) > 1:
        raise ValueError("cannot union float and quantized wires — "
                         "quantize (or dequantize) every bucket first")
    k_cap = max(w.k_cap for w in wires)
    padded = [pad_wire(w, k_cap) for w in wires]
    fields = {f: torch.cat([getattr(w, f) for w in padded]) for f in wires[0]._fields
              if f != "vocab"}
    return type(wires[0])(vocab=wires[0].vocab, **fields)


def take_wire_rows(wire: SparseWire | QuantizedWire, rows) -> SparseWire | QuantizedWire:
    """The wire's client rows ``rows`` in that order (a permutation back to
    cohort order, or the transmitters only)."""
    take = torch.as_tensor(rows, dtype=torch.long, device=wire.values.device)
    fields = {f: getattr(wire, f)[take] for f in wire._fields if f != "vocab"}
    return type(wire)(vocab=wire.vocab, **fields)


def _scatter_last(values: torch.Tensor, indices: torch.Tensor, vocab: int) -> torch.Tensor:
    """``values (..., k)`` added at ``indices`` into zeros ``(..., vocab)``."""
    out = torch.zeros(values.shape[:-1] + (vocab,), dtype=values.dtype, device=values.device)
    return out.scatter_add_(-1, indices.long(), values)


def wire_densify(wire: SparseWire | QuantizedWire) -> torch.Tensor:
    """The dense ``(N, ..., vocab)`` stack of a wire, zeros off the
    transmitted support (an int8 wire dequantized first): what the dense
    aggregation reads."""
    if isinstance(wire, QuantizedWire):
        wire = dequantize_wire(wire)
    return _scatter_last(torch.where(wire.mask, wire.values, 0), wire.indices, wire.vocab)


def wire_support(wire: SparseWire | QuantizedWire) -> torch.Tensor:
    """The dense ``(N, ..., vocab)`` bool transmit mask: which indices each
    client sent, True even where the value sent is 0.0.  The mask is summed
    first and thresholded after, so a masked pad entry at index 0 cannot
    clear a real index-0 entry."""
    return _scatter_last(wire.mask.float(), wire.indices, wire.vocab) > 0
