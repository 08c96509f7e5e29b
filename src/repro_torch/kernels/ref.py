"""Plain PyTorch versions of the port's kernels.

The ``ops`` wrappers run these for tensors that lie on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against its plain version on the
card.  The top-k and aggregation kernels compute exactly what their plain
versions compute, in the same order, and are held with ``torch.equal``;
the KL and attention kernels sum in another order (online, blocked) than
their plain versions' log-sum-exp and softmax, and are held within a
stated tolerance.  They mirror ``repro/kernels/ref.py``: fp32, bf16 or fp16
inputs, upcast first, fp32 math; the top-k keeps its input's dtype and the
attention returns q's, the rest return fp32 (the ``ops`` wrappers cast the
aggregation sums back to their input's dtype, as the reference's do).
"""

from __future__ import annotations

import torch

__all__ = [
    "BISECTION_ITERS",
    "AGG_EPS",
    "topk_mask_ref",
    "sparse_aggregate_ref",
    "scatter_wire_sums_ref",
    "scatter_wire_sums_dequant_ref",
    "dequant_channels",
    "distill_kl_ref",
    "flash_attention_ref",
]

# Threshold-bisection iteration count of the top-k kernels: the plain and
# kernel sparsifiers must converge identically.
BISECTION_ITERS = 30
# eps of the dense adaptive aggregation kernel's denominator
AGG_EPS = 1e-12
# the attention kernel's causal-mask fill
NEG_INF = -1e30


def topk_mask_ref(x: torch.Tensor, ks: torch.Tensor, *, guard: bool) -> torch.Tensor:
    """Dense top-k mask of ``x (rows, V)`` by fp32 threshold bisection,
    with one budget per row ``ks (rows,)`` int.

    ``lo = min``, ``hi = max + 1``; :data:`BISECTION_ITERS` times
    ``mid = 0.5 * (lo + hi)``, and ``lo = mid`` where ``count(x >= mid) >=
    k`` else ``hi = mid``; keep ``x >= lo`` (so every tie at the k-th value
    is kept).  ``guard`` also zeroes the rows whose ``k`` is 0 — the
    per-row-budget kernel; the static-k kernel has no guard.  Every step is
    one rounded fp32 operation and the counts are integers, so the CUDA
    kernels reproduce this bit for bit."""
    xf = x.float()
    lo = torch.amin(xf, dim=-1)
    hi = torch.amax(xf, dim=-1) + 1.0
    for _ in range(BISECTION_ITERS):
        mid = (lo + hi) * 0.5
        take = torch.sum(xf >= mid[:, None], dim=-1) >= ks
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    keep = xf >= lo[:, None]
    if guard:
        keep = keep & (ks > 0)[:, None]
    return torch.where(keep, x, torch.zeros_like(x))


def sparse_aggregate_ref(stack: torch.Tensor) -> torch.Tensor:
    """Dense adaptive aggregation ``Σₙ|x|x / (Σₙ|x| + 1e-12)`` of
    ``stack (N, rows, V)`` -> ``(rows, V)`` fp32, one client at a time in
    order with a separate multiply and add (no ``sum(0)``, whose order on
    the card is not fixed), as the kernel does."""
    num = torch.zeros(stack.shape[1:], dtype=torch.float32, device=stack.device)
    den = torch.zeros_like(num)
    for x in stack.float():
        s = torch.abs(x)
        num = num + s * x
        den = den + s
    return num / (den + AGG_EPS)


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


def distill_kl_ref(teacher: torch.Tensor, student: torch.Tensor,
                   temperature: float = 2.0) -> torch.Tensor:
    """Per-row ``KL(softmax(t/T) || softmax(s/T))`` of ``(rows, V)``
    inputs -> ``(rows,)`` fp32, from the log-sum-exp; no T² and no mean
    (the caller applies those)."""
    t = teacher.float() / temperature
    s = student.float() / temperature
    log_p = t - torch.logsumexp(t, dim=-1, keepdim=True)
    log_q = s - torch.logsumexp(s, dim=-1, keepdim=True)
    return torch.sum(torch.exp(log_p) * (log_p - log_q), dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain causal softmax attention over fused head-batches ``(B, S, D)``
    in fp32 math: scores ``q k^T * D^-0.5``, the future masked with -1e30."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    s = q.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(torch.where(causal, scores, NEG_INF), dim=-1)
    return torch.einsum("bst,btd->bsd", probs, v.float()).to(q.dtype)
