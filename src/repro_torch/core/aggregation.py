"""Server-side logit aggregation (paper §III-A, eqs. 6-7) — the port of
``repro/core/aggregation.py``.

    s_{n,c} = |K̃_{n,c}|,   w_{n,c} = s_{n,c} / Σ_n s_{n,c},   K_g = Σ_n w_{n,c} K̃_{n,c}

Two input forms, each with the paper's ``adaptive`` mode and the
``zeropad`` / ``mean_nonzero`` baselines:

* a DENSE ``(N, ..., vocab)`` stack of the transmitters' top-k masks (the
  ``batched`` and ``fused`` engines), with an optional explicit transmit
  ``mask`` (without it "transmitted" is the ``!= 0`` sentinel):
  :func:`aggregate`.  ``use_kernel=True`` sends the adaptive mode to the
  dense CUDA kernel, whose formula ``Σ|x|x / (Σ|x| + eps)`` is not the jnp
  one ``Σ (|x| / (S + eps)) x``; each route keeps its own, as in the
  reference.
* the sparse WIRE (the ``fused_e2e`` engine): every mode reduces to one
  two-channel scatter-accumulate over the O(N·B·k_cap) wire entries into
  ``(..., vocab)`` sums: :func:`aggregate_wire`.

``use_kernel=True`` routes through :mod:`repro_torch.kernels.ops` (the CUDA
kernels on the card, their plain versions for CPU tensors).
"""

from __future__ import annotations

from typing import Literal

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.topk import QuantizedWire, SparseWire
from repro_torch.kernels.ref import scatter_wire_sums_dequant_ref

__all__ = [
    "AggregationMode",
    "aggregate_sparse",
    "aggregate_adaptive",
    "aggregate_zeropad",
    "aggregate_mean_nonzero",
    "aggregate",
    "aggregate_wire",
    "scatter_wire_sums",
    "scatter_wire_sums_dequant",
    "max_intermediate_elems",
]

AggregationMode = Literal["adaptive", "zeropad", "mean_nonzero"]
_EPS = 1e-12


def _support(stack: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """The transmit mask as the stack's dtype: explicit when given, else the
    ``!= 0`` sentinel (which cannot see a transmitted 0.0)."""
    return (stack != 0).to(stack.dtype) if mask is None else mask.to(stack.dtype)


def aggregate_adaptive(
    stack: torch.Tensor, *, mask: torch.Tensor | None = None, eps: float = _EPS
) -> torch.Tensor:
    """Paper eqs. 6-7 over a dense ``(N, ..., vocab)`` stack: dimensions no
    client transmitted stay 0."""
    s = torch.abs(stack) * _support(stack, mask)
    w = s / (torch.sum(s, dim=0)[None] + eps)
    return torch.sum(w * stack, dim=0)


def aggregate_zeropad(stack: torch.Tensor, *, mask: torch.Tensor | None = None) -> torch.Tensor:
    """The paper's ZeroPad baseline: the plain mean, zeros included."""
    if mask is not None:
        stack = stack * mask.to(stack.dtype)
    return torch.mean(stack, dim=0)


def aggregate_mean_nonzero(
    stack: torch.Tensor, *, mask: torch.Tensor | None = None, eps: float = _EPS
) -> torch.Tensor:
    """The mean over the clients that transmitted each dimension."""
    m = _support(stack, mask)
    return torch.sum(stack * m, dim=0) / (torch.sum(m, dim=0) + eps)


def aggregate(
    stack: torch.Tensor,
    mode: AggregationMode = "adaptive",
    *,
    mask: torch.Tensor | None = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Aggregate a dense ``(N, ..., vocab)`` stack in ``mode``;
    ``use_kernel`` routes the adaptive mode through the dense CUDA kernel
    (masked first when ``mask`` is given)."""
    if mode == "adaptive":
        if use_kernel:
            from repro_torch.kernels import ops as kops

            return kops.sparse_aggregate(stack if mask is None else stack * mask.to(stack.dtype))
        return aggregate_adaptive(stack, mask=mask)
    if mode == "zeropad":
        return aggregate_zeropad(stack, mask=mask)
    if mode == "mean_nonzero":
        return aggregate_mean_nonzero(stack, mask=mask)
    raise ValueError(f"unknown aggregation mode: {mode!r}")


def scatter_wire_sums(
    a: torch.Tensor, b: torch.Tensor, indices: torch.Tensor, vocab: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain scatter-accumulate of ``a, b, indices (N, ..., k)`` into
    ``(..., vocab)`` sums (masked entries must already be zero), in the
    channels' dtype, one client after the other — the reference's
    scatter-add in ``a.dtype`` (the kernel route sums in fp32)."""
    n, k = a.shape[0], a.shape[-1]
    lead = a.shape[1:-1]
    idx = indices.reshape(n, -1, k).long()
    row_ix = torch.arange(idx.shape[1], device=a.device)[:, None].expand(idx.shape[1:])
    num = torch.zeros((idx.shape[1], vocab), dtype=a.dtype, device=a.device)
    den = torch.zeros((idx.shape[1], vocab), dtype=b.dtype, device=a.device)
    for i, (ai, bi) in enumerate(zip(a.reshape(n, -1, k), b.reshape(n, -1, k))):
        num.index_put_((row_ix, idx[i]), ai, accumulate=True)
        den.index_put_((row_ix, idx[i]), bi, accumulate=True)
    return num.reshape(lead + (vocab,)), den.reshape(lead + (vocab,))


def scatter_wire_sums_dequant(
    q_values: torch.Tensor,
    scale: torch.Tensor,
    mask: torch.Tensor,
    indices: torch.Tensor,
    vocab: int,
    mode: AggregationMode = "adaptive",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain dequantize-fused scatter for the int8 wire: ``v = q * scale``
    per row, the mode's two channels, then :func:`scatter_wire_sums`."""
    n, k = q_values.shape[0], q_values.shape[-1]
    lead = q_values.shape[1:-1]
    fold = lambda x: x.reshape(n, -1, k)  # noqa: E731
    num, den = scatter_wire_sums_dequant_ref(
        fold(q_values), scale.reshape(n, -1), fold(mask), fold(indices), vocab, mode
    )
    return num.reshape(lead + (vocab,)), den.reshape(lead + (vocab,))


def aggregate_wire(
    wire: SparseWire | QuantizedWire,
    mode: AggregationMode = "adaptive",
    *,
    num_transmitters: int | None = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Aggregate straight from the wire: ``(..., vocab)`` teacher logits.

    ``zeropad`` divides by the number of transmitting clients
    (``num_transmitters``, derived from the mask when not given);
    ``adaptive`` and ``mean_nonzero`` divide by the den channel + eps.
    """
    if mode not in ("adaptive", "zeropad", "mean_nonzero"):
        raise ValueError(f"unknown aggregation mode: {mode!r}")
    if use_kernel:
        from repro_torch.kernels import ops as kops

        sums, sums_dequant = kops.scatter_wire_sums, kops.scatter_wire_sums_dequant
    else:
        sums, sums_dequant = scatter_wire_sums, scatter_wire_sums_dequant
    if isinstance(wire, QuantizedWire):
        num, den = sums_dequant(
            wire.values, wire.scale, wire.mask, wire.indices, wire.vocab, mode
        )
    else:
        m = wire.mask.to(wire.values.dtype)
        v = wire.values * m
        if mode == "adaptive":
            s = torch.abs(v)
            a, b = s * v, s
        else:
            a, b = v, m
        num, den = sums(a, b, wire.indices, wire.vocab)

    if mode == "zeropad":
        if num_transmitters is None:
            num_transmitters = int(wire.mask.reshape(wire.mask.shape[0], -1).any(dim=1).sum())
        return num / max(int(num_transmitters), 1)
    return num / (den + _EPS)


class _LargestOutput(TorchDispatchMode):
    """Tracks the largest element count of any op's output."""

    def __init__(self):
        super().__init__()
        self.worst = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.worst = max(self.worst, t.numel())
        return out


def max_intermediate_elems(fn, *args, **kwargs) -> int:
    """Largest element count of any op's output while ``fn(*args,
    **kwargs)`` runs: the inspection behind the sparse path's memory
    contract, that aggregating straight from the wire never builds the
    ``(N, B, V)`` dense stack.

    The reference takes a jaxpr and reads every equation's outputs,
    sub-jaxprs included; torch has no jaxpr, so this takes the function and
    its arguments and runs it under a dispatch mode that sees every op,
    views included (a broadcast to ``(N, B, V)`` counts at that size,
    erring strict, as the reference's ``broadcast_in_dim`` does).  It runs
    on CPU, CUDA and ``meta`` tensors.  On the card the wire kernels'
    wrappers (:mod:`repro_torch.kernels.ops`) allocate their outputs through
    torch and launch with no scratch of their own, so the mode sees every
    buffer the kernel route holds; the launch itself is not an op."""
    with _LargestOutput() as mode:
        fn(*args, **kwargs)
    return mode.worst


def aggregate_sparse(
    values: torch.Tensor,
    indices: torch.Tensor,
    vocab: int,
    mode: AggregationMode = "adaptive",
    *,
    eps: float = _EPS,
) -> torch.Tensor:
    """Aggregate straight from sparse ``(value, index)`` payloads, every
    entry taken as transmitted (:func:`aggregate_wire` is the masked wire's
    route): per row, ``Σ|K|K``, ``Σ|K|``, ``ΣK`` and the count of clients
    at each vocab index, then the ``mode``'s ratio (``zeropad``: ``ΣK /
    N``; ``mean_nonzero`` and any other mode, as the reference: ``ΣK /
    (count + eps)``).  The reference walks the clients of a row in a loop;
    here one ``scatter_add_`` a sum takes every client's entries at once.

    values/indices ``(N, ..., k)`` -> ``(..., vocab)``."""
    n, k = values.shape[0], values.shape[-1]
    lead = values.shape[1:-1]
    rows = lead.numel()
    # (rows, N·k): a row's entries of every client side by side
    vals = values.reshape(n, rows, k).transpose(0, 1).reshape(rows, n * k)
    idx = indices.reshape(n, rows, k).transpose(0, 1).reshape(rows, n * k).long()

    def summed(src: torch.Tensor) -> torch.Tensor:
        return torch.zeros((rows, vocab), dtype=vals.dtype, device=vals.device).scatter_add_(
            1, idx, src)

    if mode == "adaptive":
        s = torch.abs(vals)
        out = summed(s * vals) / (summed(s) + eps)
    elif mode == "zeropad":
        out = summed(vals) / float(n)
    else:
        out = summed(vals) / (summed(torch.ones_like(vals)) + eps)
    return out.reshape(lead + (vocab,))
