"""Public wrappers for the port's kernels.

Each wrapper folds the batch dims as ``repro/kernels/ops.py`` does, checks
its inputs, and then looks at the device the tensors lie on: a CPU tensor
goes to the plain version in :mod:`repro_torch.kernels.ref`, a CUDA tensor
to the hand-written kernel (built from ``csrc/`` at first use) — or an
exception, never a fallback.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import scatter_wire_sums_dequant_ref, scatter_wire_sums_ref

__all__ = ["LAUNCHES", "reset_launches", "scatter_wire_sums", "scatter_wire_sums_dequant"]

LAUNCHES: dict[str, int] = {"scatter_wire_sums": 0, "scatter_wire_sums_dequant": 0}

_MODES = {"adaptive": 0, "zeropad": 1, "mean_nonzero": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, tensors: dict, dtypes: dict, shape: tuple) -> None:
    dev = None
    for key, t in tensors.items():
        if t.dtype not in dtypes[key]:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected one of {dtypes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {dev}")
    for key, t in tensors.items():
        want = shape[: t.ndim] if key == "scale" else shape
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(want)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


@functools.cache
def _fn(symbol: str, nargs_ptr: int, nargs_int: int):
    fn = getattr(build.load("sparse_agg"), symbol)
    fn.argtypes = [_P] * nargs_ptr + [_I] * nargs_int + [_P]
    fn.restype = _I
    return fn


def _launch(name: str, symbol: str, ptrs, ints, device) -> None:
    fn = _fn(symbol, len(ptrs), len(ints))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*[t.data_ptr() for t in ptrs], *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def scatter_wire_sums(
    a: torch.Tensor, b: torch.Tensor, indices: torch.Tensor, vocab: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-channel scatter-accumulate from the sparse uplink wire:
    ``a, b, indices (N, ..., k)`` -> ``(num, den)`` each ``(..., vocab)``
    fp32, with ``num[..., idx] += a`` summed over the clients in order."""
    _check(
        "scatter_wire_sums", {"a": a, "b": b, "indices": indices},
        {"a": (torch.float32,), "b": (torch.float32,), "indices": (torch.int32,)},
        tuple(a.shape),
    )
    n, k = a.shape[0], a.shape[-1]
    lead = a.shape[1:-1]
    fa, fb, fi = (x.reshape(n, -1, k) for x in (a, b, indices))
    rows = fa.shape[1]
    if a.device.type == "cpu":
        num, den = scatter_wire_sums_ref(fa, fb, fi, vocab)
    else:
        num = torch.empty((rows, vocab), dtype=torch.float32, device=a.device)
        den = torch.empty_like(num)
        if rows:
            _launch("scatter_wire_sums", "scatter_wire_sums_f32",
                    (fa, fb, fi, num, den), (n, rows, k, vocab), a.device)
    return num.reshape(lead + (vocab,)), den.reshape(lead + (vocab,))


def scatter_wire_sums_dequant(
    q_values: torch.Tensor,
    scale: torch.Tensor,
    mask: torch.Tensor,
    indices: torch.Tensor,
    vocab: int,
    mode: str = "adaptive",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantize-fused scatter-accumulate from the int8 wire:
    ``q_values/mask/indices (N, ..., k)`` + per-row ``scale (N, ...)`` ->
    ``(num, den)`` each ``(..., vocab)`` fp32 for the aggregation ``mode``."""
    if mode not in _MODES:
        raise ValueError(f"unknown aggregation mode: {mode!r}")
    _check(
        "scatter_wire_sums_dequant",
        {"q_values": q_values, "scale": scale, "mask": mask, "indices": indices},
        {"q_values": (torch.int8,), "scale": (torch.float32,),
         "mask": (torch.bool, torch.int8, torch.uint8), "indices": (torch.int32,)},
        tuple(q_values.shape),
    )
    n, k = q_values.shape[0], q_values.shape[-1]
    lead = q_values.shape[1:-1]
    fq, fm, fi = (x.reshape(n, -1, k) for x in (q_values, mask, indices))
    fs = scale.reshape(n, -1)
    rows = fq.shape[1]
    if q_values.device.type == "cpu":
        num, den = scatter_wire_sums_dequant_ref(fq, fs, fm, fi, vocab, mode)
    else:
        num = torch.empty((rows, vocab), dtype=torch.float32, device=q_values.device)
        den = torch.empty_like(num)
        if rows:
            _launch("scatter_wire_sums_dequant", "scatter_wire_sums_dequant_i8",
                    (fq, fs, fm.view(torch.uint8), fi, num, den),
                    (n, rows, k, vocab, _MODES[mode]), q_values.device)
    return num.reshape(lead + (vocab,)), den.reshape(lead + (vocab,))
