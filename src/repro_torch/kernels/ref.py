"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its CUDA kernel computes, in the same
order, so the kernel is held against it with ``torch.equal`` on the card;
the ``ops`` wrappers also run these for tensors that lie on the CPU.  They
mirror ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["scatter_wire_sums_ref", "scatter_wire_sums_dequant_ref", "dequant_channels"]


def scatter_wire_sums_ref(
    a: torch.Tensor, b: torch.Tensor, indices: torch.Tensor, vocab: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-channel scatter-accumulate of sparse wire entries, fp32.

    ``a, b, indices: (N, rows, k)`` -> ``(num, den)`` each ``(rows, vocab)``:
    ``num[r, indices[n, r, j]] += a[n, r, j]`` (and b into den), one client
    at a time in order.  Indices are distinct per (n, r) row apart from
    masked padding at index 0, whose contributions must be zero.
    """
    n, rows, _k = a.shape
    dev = a.device
    num = torch.zeros((rows, vocab), dtype=torch.float32, device=dev)
    den = torch.zeros((rows, vocab), dtype=torch.float32, device=dev)
    row_ix = torch.arange(rows, device=dev)[:, None].expand(indices.shape[1:])
    for i in range(n):
        idx = indices[i].long()
        num.index_put_((row_ix, idx), a[i].float(), accumulate=True)
        den.index_put_((row_ix, idx), b[i].float(), accumulate=True)
    return num, den


def dequant_channels(
    q_values: torch.Tensor, scale: torch.Tensor, mask: torch.Tensor, mode: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 wire's per-entry contribution channels: ``v = q * scale *
    mask`` per row, then ``(|v|*v, |v|)`` for adaptive or ``(v, mask)`` for
    zeropad / mean_nonzero."""
    m = mask.float()
    v = q_values.float() * scale.float()[..., None] * m
    if mode == "adaptive":
        s = torch.abs(v)
        return s * v, s
    if mode in ("zeropad", "mean_nonzero"):
        return v, m
    raise ValueError(f"unknown aggregation mode: {mode!r}")


def scatter_wire_sums_dequant_ref(
    q_values: torch.Tensor,
    scale: torch.Tensor,
    mask: torch.Tensor,
    indices: torch.Tensor,
    vocab: int,
    mode: str = "adaptive",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantize-fused wire scatter: ``q_values (N, rows, k) int8``,
    ``scale (N, rows)``, ``mask`` bool or {0, 1}, ``indices (N, rows, k)``
    -> ``(num, den)`` each ``(rows, vocab)`` fp32."""
    a, b = dequant_channels(q_values, scale, mask, mode)
    return scatter_wire_sums_ref(a, b, indices, vocab)
