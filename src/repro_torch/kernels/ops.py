"""Public wrappers for the port's kernels.

Each wrapper folds the batch dims as ``repro/kernels/ops.py`` does, checks
its inputs, and then looks at the device the tensors lie on: a CPU tensor
goes to the plain version in :mod:`repro_torch.kernels.ref`, a CUDA tensor
to the hand-written kernel (built from ``csrc/`` at first use) — or an
exception, never a fallback.  Float inputs are fp32, bf16 or fp16: each
kernel has an entry point for each (``*_f32``, ``*_bf16``, ``*_f16``); the
16-bit ones read their type, compute in fp32 and write the reference
wrapper's output dtype, and a 16-bit tensor is never upcast here to reach
the fp32 kernel.  ``LAUNCHES`` counts kernel launches per wrapper and input
dtype (``name`` for fp32, ``name.bf16`` for bf16, ``name.f16`` for fp16),
and for the attention per kernel too (after the dtype's tag: ``.d128`` for
the D = 128 kernels, ``.dany`` for every head dim but 64 and 128;
:func:`flash_instance`), so a run can show that its path went through the
kernels.

The KL and attention kernels are forward only, as in the reference: their
wrappers raise on an input that requires a gradient (with autograd on)
rather than return a result that no gradient flows through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    distill_kl_ref,
    flash_attention_ref,
    scatter_wire_sums_dequant_ref,
    scatter_wire_sums_ref,
    sparse_aggregate_ref,
    topk_mask_ref,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "topk_mask_dynamic",
    "topk_mask",
    "sparse_aggregate",
    "scatter_wire_sums",
    "scatter_wire_sums_dequant",
    "distill_kl_rows",
    "distill_kl",
    "flash_attention",
]

# the wrappers with bf16 and fp16 kernels beside the fp32 one (the int8
# wire's scatter reads int8 values and an fp32 scale whatever the round's dtype)
BF16_KERNELS = ("topk_mask_dynamic", "topk_mask", "sparse_aggregate", "scatter_wire_sums",
                "distill_kl", "flash_attention")
LAUNCHES: dict[str, int] = {
    **dict.fromkeys(("topk_mask_dynamic", "topk_mask", "sparse_aggregate", "scatter_wire_sums",
                     "scatter_wire_sums_dequant", "distill_kl", "flash_attention"), 0),
    **{f"{name}{tag}": 0 for name in BF16_KERNELS for tag in (".bf16", ".f16")},
    **{f"flash_attention{tag}{instance}": 0 for tag in ("", ".bf16", ".f16") for instance in (".d128", ".dany")},
}

_MODES = {"adaptive": 0, "zeropad": 1, "mean_nonzero": 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLOAT = (torch.float32, torch.bfloat16, torch.float16)
_SUFFIX = {torch.float32: ("", "_f32"), torch.bfloat16: (".bf16", "_bf16"),
           torch.float16: (".f16", "_f16")}
# the top-k library's code for a row dtype (topk_mask_smem_max_vocab)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, tensors: dict, dtypes: dict, shapes: dict) -> None:
    """Dtypes, contiguity, one device and the shapes; the float operands of
    one call share their dtype."""
    dev, floats = None, set()
    for key, t in tensors.items():
        if t.dtype not in dtypes[key]:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected one of {dtypes[key]}")
        if dtypes[key] == _FLOAT:
            floats.add(t.dtype)
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {dev}")
    for key, want in shapes.items():
        if tuple(tensors[key].shape) != tuple(want):
            raise ValueError(
                f"{name}: {key} has shape {tuple(tensors[key].shape)}, expected {tuple(want)}"
            )
    if len(floats) > 1:
        raise TypeError(f"{name}: the float inputs mix dtypes {sorted(map(str, floats))}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    """The kernel has no backward (nor has the reference's): refuse to hand
    back a result that would silently carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward only (as the reference kernel): an input requires grad, and "
            "the result would carry no gradient; detach the inputs or use the plain-PyTorch "
            "route (use_kernel=False)"
        )


@functools.cache
def _fn(lib: str, symbol: str, nargs_ptr: int, nargs_int: int, nargs_float: int = 0):
    """The C entry point ``symbol`` of ``lib``: ``nargs_ptr`` pointers,
    ``nargs_int`` ints, ``nargs_float`` floats, then the stream; returns a
    ``cudaError_t``."""
    fn = getattr(build.load(lib), symbol)
    fn.argtypes = [_P] * nargs_ptr + [_I] * nargs_int + [_F] * nargs_float + [_P]
    fn.restype = _I
    return fn


@functools.cache
def smem_max_vocab(device_index: int, dtype: torch.dtype = torch.float32) -> int:
    """Widest row the top-k kernel for ``dtype`` rows keeps in shared memory
    on this card (the fp32 kernel beside a candidate buffer, the 16-bit
    ones a row alone); wider rows take its global-memory path."""
    fn = build.load("topk_select").topk_mask_smem_max_vocab
    fn.argtypes, fn.restype = [_I], _I
    with torch.cuda.device(device_index):
        out = fn(_DTYPE_CODE[dtype])
    if out < 0:
        raise RuntimeError(f"topk_mask_smem_max_vocab: CUDA error {-out}")
    return out


def _launch(name: str, lib: str, symbol: str, ptrs, ints, device, floats=(),
            dtype: torch.dtype | None = None, instance: str = "") -> None:
    """Launch ``symbol`` (+ the entry point's suffix for the float inputs'
    ``dtype``: ``_f32``, ``_bf16``, ``_f16``) and count it under ``name``
    (+ ``.bf16``, ``.f16``, + ``instance``)."""
    tag, suffix = ("", "") if dtype is None else _SUFFIX[dtype]
    fn = _fn(lib, symbol + suffix, len(ptrs), len(ints), len(floats))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*[None if t is None else t.data_ptr() for t in ptrs], *ints, *floats, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}{suffix}: CUDA error {rc} at launch")
    LAUNCHES[name + tag + instance] += 1


def _topk(name: str, logits: torch.Tensor, ks: torch.Tensor | None, k_static: int) -> torch.Tensor:
    """The bisection top-k mask over the rows of ``logits (..., V)``: per-row
    budgets ``ks`` (shape ``logits.shape[:-1]``, with the ``k > 0`` guard)
    or, when ``ks`` is None, one static ``k_static`` and no guard."""
    tensors = {"logits": logits} if ks is None else {"logits": logits, "ks": ks}
    _check(name, tensors, {"logits": _FLOAT, "ks": (torch.int32,)},
           {} if ks is None else {"ks": logits.shape[:-1]})
    vocab = logits.shape[-1]
    flat = logits.reshape(-1, vocab)
    rows = flat.shape[0]
    if logits.device.type == "cpu":
        kk = (torch.full((rows,), k_static, dtype=torch.int32) if ks is None
              else torch.clamp(ks.reshape(rows), 0, vocab))
        return topk_mask_ref(flat, kk, guard=ks is not None).reshape(logits.shape)
    out = torch.empty_like(flat)
    if rows and vocab:
        use_smem = int(vocab <= smem_max_vocab(logits.device.index or 0, logits.dtype))
        _launch(name, "topk_select", "topk_mask", (flat, ks, out),
                (rows, vocab, k_static, int(ks is not None), use_smem), logits.device,
                dtype=logits.dtype)
    return out.reshape(logits.shape)


def topk_mask_dynamic(logits: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Per-row-budget dense top-k mask of ``logits (..., V)`` fp32, bf16 or
    fp16 (out: the same dtype) with int32 budgets ``ks`` of the leading
    shape, clamped to ``[0, V]``, by the fp32 bisection on the values (the
    16-bit kernels find the k-th value exactly and replay the bisection's steps):
    threshold semantics (ties at the k-th value kept), ``k = 0`` zeroes the
    row — the ``fused`` engine's uplink sparsifier."""
    return _topk("topk_mask_dynamic", logits, ks, 0)


def topk_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Dense top-k mask of ``logits (..., V)`` fp32, bf16 or fp16 with one static
    ``min(k, V)`` for every row and no ``k > 0`` guard (paper eq. 4)."""
    return _topk("topk_mask", logits, None, int(min(int(k), logits.shape[-1])))


def sparse_aggregate(stack: torch.Tensor) -> torch.Tensor:
    """Dense adaptive aggregation (eqs. 6-7) of ``stack (N, ..., V)`` fp32,
    bf16 or fp16: ``Σₙ|x|x / (Σₙ|x| + 1e-12)`` in fp32 -> ``(..., V)`` in the
    stack's dtype (the reference wrapper's cast)."""
    _check("sparse_aggregate", {"stack": stack}, {"stack": _FLOAT}, {})
    n, vocab = stack.shape[0], stack.shape[-1]
    flat = stack.reshape(n, -1, vocab)
    if stack.device.type == "cpu":
        return sparse_aggregate_ref(flat).to(stack.dtype).reshape(stack.shape[1:])
    out = torch.empty(flat.shape[1:], dtype=stack.dtype, device=stack.device)
    if out.numel():
        _launch("sparse_aggregate", "sparse_agg", "sparse_aggregate", (flat, out),
                (n, flat.shape[1], vocab), stack.device, dtype=stack.dtype)
    return out.reshape(stack.shape[1:])


def scatter_wire_sums(
    a: torch.Tensor, b: torch.Tensor, indices: torch.Tensor, vocab: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-channel scatter-accumulate from the sparse uplink wire:
    ``a, b, indices (N, ..., k)`` -> ``(num, den)`` each ``(..., vocab)``,
    with ``num[..., idx] += a`` summed in fp32 over the clients in order;
    fp32, bf16 or fp16 ``a, b``, and the sums come back in their dtype (the
    reference wrapper's cast, which the 16-bit kernels make as they write;
    an fp16 sum past 65 504 becomes inf, as the cast makes it)."""
    _check(
        "scatter_wire_sums", {"a": a, "b": b, "indices": indices},
        {"a": _FLOAT, "b": _FLOAT, "indices": (torch.int32,)},
        {"b": a.shape, "indices": a.shape},
    )
    n, k = a.shape[0], a.shape[-1]
    lead = a.shape[1:-1]
    fa, fb, fi = (x.reshape(n, -1, k) for x in (a, b, indices))
    rows = fa.shape[1]
    if a.device.type == "cpu":
        num, den = (x.to(a.dtype) for x in scatter_wire_sums_ref(fa, fb, fi, vocab))
    else:
        num = torch.empty((rows, vocab), dtype=a.dtype, device=a.device)
        den = torch.empty_like(num)
        if rows:
            _launch("scatter_wire_sums", "sparse_agg", "scatter_wire_sums",
                    (fa, fb, fi, num, den), (n, rows, k, vocab), a.device, dtype=a.dtype)
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
        {"scale": q_values.shape[:-1], "mask": q_values.shape, "indices": q_values.shape},
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
            _launch("scatter_wire_sums_dequant", "sparse_agg", "scatter_wire_sums_dequant_i8",
                    (fq, fs, fm.view(torch.uint8), fi, num, den),
                    (n, rows, k, vocab, _MODES[mode]), q_values.device)
    return num.reshape(lead + (vocab,)), den.reshape(lead + (vocab,))


def distill_kl_rows(teacher: torch.Tensor, student: torch.Tensor,
                    temperature: float = 2.0) -> torch.Tensor:
    """Per-row ``KL(σ(t/T) || σ(s/T))`` of ``(..., V)`` fp32, bf16 or fp16 inputs
    -> ``(...)`` fp32 (no T², no mean) through the fused one-pass kernel.
    Forward only: raises when either input requires grad (with autograd
    on), since a loss built on it would silently train nothing."""
    _forward_only("distill_kl", teacher, student)
    _check("distill_kl", {"teacher": teacher, "student": student},
           {"teacher": _FLOAT, "student": _FLOAT},
           {"student": teacher.shape})
    vocab = teacher.shape[-1]
    t_flat, s_flat = teacher.reshape(-1, vocab), student.reshape(-1, vocab)
    if teacher.device.type == "cpu":
        return distill_kl_ref(t_flat, s_flat, temperature).reshape(teacher.shape[:-1])
    out = torch.empty(t_flat.shape[0], dtype=torch.float32, device=teacher.device)
    if out.numel() and vocab:
        _launch("distill_kl", "distill_kl", "distill_kl", (t_flat, s_flat, out),
                (t_flat.shape[0], vocab), teacher.device, (1.0 / temperature,),
                dtype=teacher.dtype)
    return out.reshape(teacher.shape[:-1])


def distill_kl(teacher: torch.Tensor, student: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Mean of :func:`distill_kl_rows` times T² (Hinton's scaling) —
    ``core.distill.kl_divergence``'s value through the kernel.  Forward
    only, as the reference kernel."""
    return torch.mean(distill_kl_rows(teacher, student, temperature)) * (temperature**2)


# the Pallas kernel's tile: S must be a multiple of min(128, S)
FLASH_BLOCK = 128


def flash_instance(d: int) -> str:
    """The launch counter's suffix (after the dtype's tag) of the CUDA
    kernel that head dim ``d`` reaches: ``""`` for 64 (GPT-2, granite,
    stablelm, seamless, mamba2), ``".d128"`` for 128 (yi-9b, command-r,
    llama4, internvl2, jamba, moonshot), ``".dany"`` for any other ``d >= 1``
    (``flash_attention_anyd_kernel``: D padded to a multiple of 32, past 256
    in chunks of output columns)."""
    if d < 1:
        raise ValueError(f"flash_attention: no kernel takes head dim {d}")
    return {64: "", 128: ".d128"}.get(d, ".dany")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its data starts on a 16-byte boundary, else a
    fresh contiguous copy that does (a view at a storage offset, such as
    ``buf[1:].view(...)``): the attention kernels' tensor maps and 16-byte
    loads need a 16-byte-aligned base address.  Only the base is realigned:
    a row of ``D`` elements starts on a 16-byte boundary only where its bytes
    are a multiple of 16, and the kernel for other head dims loads such rows
    in narrower pieces.  The kernel then runs on the copy; nothing falls
    back."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of ``(B, H, S, D)`` or fused ``(B·H, S, D)`` fp32,
    bf16 or fp16 q, k, v (out: q's dtype, from fp32 math), with ``S`` a multiple
    of ``min(128, S)`` as the reference's tiling asserts, at any head dim
    ``D >= 1`` as the reference (``D`` 0 raises its ``ZeroDivisionError``, from
    ``D**-0.5``): on the CPU the plain version, on the card one launch of the
    kernel :func:`flash_instance` names, never a fallback.  Forward only
    (inference prefill): raises when an input requires grad."""
    _forward_only("flash_attention", q, k, v)
    if q.ndim not in (3, 4):
        raise ValueError(f"flash_attention: q has shape {tuple(q.shape)}, expected (B, H, S, D) "
                         "or (B*H, S, D)")
    _check("flash_attention", {"q": q, "k": k, "v": v},
           {"q": _FLOAT, "k": _FLOAT, "v": _FLOAT},
           {"k": q.shape, "v": q.shape})
    s, d = q.shape[-2], q.shape[-1]
    blk = min(FLASH_BLOCK, s)
    if s % blk:
        raise ValueError(f"flash_attention: seq {s} must tile by {blk}")
    scale = d**-0.5  # D 0: ZeroDivisionError, as the reference's d**-0.5
    fold = lambda x: x.reshape(-1, s, d)  # noqa: E731
    if q.device.type == "cpu":
        return flash_attention_ref(fold(q), fold(k), fold(v)).reshape(q.shape)
    q, k, v = (aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    bh = fold(q).shape[0]
    if bh and s:
        _launch("flash_attention", "flash_attention", "flash_attention", (q, k, v, out),
                (bh, s, d), q.device, (scale,), dtype=q.dtype, instance=flash_instance(d))
    return out
