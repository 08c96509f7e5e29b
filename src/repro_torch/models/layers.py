"""Primitive layers on tensors with a leading CLIENT axis — the port of
``repro/models/layers.py``: LayerNorm and RMSNorm, RoPE, the GELU and
SwiGLU MLPs, embeddings.

Activations are ``(C, ..., d)``: ``C`` clients (1 for a single model).  A
weight leaf is either SHARED (its base shape, broadcast over the clients:
the matmul sees ``(C·B·S, d)``) or PER CLIENT (a leading ``(C, ...)``
axis: a batched matmul over the client axis); the layer tells the two apart
by the leaf's number of dims.  Two defaults differ from PyTorch's own:
the norms' eps is 1e-6 (as in the reference), and GELU is the tanh
approximation (``jax.nn.gelu``'s default).  RoPE rotates split halves
(``x[..., :Dh/2]`` against ``x[..., Dh/2:]``, the reference's
``jnp.split``), not interleaved pairs.

Precision follows the reference's: a layer computes in the model's
compute dtype (:func:`linear` casts its input and weights to it, as
``dense_apply`` does), the norms keep their statistics in fp32 and return
their input's dtype, RoPE's angles and rotation are fp32, and parameters
are stored in ``param_dtype``.

Init draws from an explicit seeded stream on the CPU (:class:`InitStream`)
— the same shapes and scales as ``repro.models.init`` (truncated-normal
fan-in dense weights, zero biases, N(0, 0.02) embeddings) — so a seed gives
the same weights on any device.  Each leaf is drawn in fixed chunks, every
chunk from a numpy generator of its own, on a pool of threads: the values
depend on the seed alone, and a billion-parameter model draws in about a
second rather than the ~16 s of one sequential generator.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding import gather_fsdp

__all__ = [
    "NORM_EPS",
    "FLOAT_DTYPES",
    "torch_dtype",
    "linear",
    "layer_norm",
    "rms_norm",
    "norm_apply",
    "gelu",
    "rope_frequencies",
    "apply_rope",
    "mlp_apply",
    "embedding",
    "per_client",
    "InitStream",
    "truncated_normal",
    "normal",
]

NORM_EPS = 1e-6
_SQRT2 = math.sqrt(2.0)
# Φ(-2), Φ(2): the truncated normal on [-2, 2] by inverse-CDF sampling
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))


def per_client(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View a ``(C, n)`` per-client vector so it broadcasts over ``x`` =
    ``(C, ..., n)``; a shared ``(n,)`` vector broadcasts as it is."""
    if t.ndim == 1:
        return t
    return t.reshape((t.shape[0],) + (1,) * (x.ndim - 2) + (t.shape[-1],))


# the dtype names a config may give its parameters, compute and optimizer state
FLOAT_DTYPES = ("float32", "bfloat16", "float16")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (one of
    :data:`FLOAT_DTYPES`)."""
    return getattr(torch, name)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           cd: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w (+ b)`` in the compute dtype ``cd`` (x, w and b cast to it)
    for ``x (C, ..., i)`` and a shared ``w (i, o)`` or a per-client
    ``w (C, i, o)``.  A DTensor weight is gathered over the FSDP axes first
    (:func:`repro_torch.sharding.gather_fsdp`)."""
    x, w = x.to(cd), gather_fsdp(w).to(cd)
    if w.ndim == 2:
        y = torch.matmul(x, w)
    else:
        c = x.shape[0]
        y = torch.bmm(x.reshape(c, -1, x.shape[-1]), w).reshape(x.shape[:-1] + (w.shape[-1],))
    if b is not None:
        y = y + per_client(b.to(cd), y)
    return y


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in fp32, eps 1e-6."""
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=NORM_EPS)
    return (y * per_client(scale.float(), y) + per_client(bias.float(), y)).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm over the last axis, statistics in fp32, eps 1e-6."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + NORM_EPS)
    return (y * per_client(scale.float(), y)).to(x.dtype)


def norm_apply(params: dict[str, torch.Tensor], name: str, x: torch.Tensor,
               kind: str) -> torch.Tensor:
    """The norm ``name`` (``norm1``, ``final_norm``, ...) of ``params`` by
    the config's ``kind``: RMSNorm holds ``{name}/scale`` only, LayerNorm
    ``{name}/scale`` and ``{name}/bias``."""
    if kind == "rmsnorm":
        return rms_norm(x, params[f"{name}/scale"])
    return layer_norm(x, params[f"{name}/scale"], params[f"{name}/bias"])


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """RoPE's inverse frequencies ``(head_dim // 2,)``, fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x (..., S, H, Dh)`` by the absolute ``positions (S,)``: the
    first half of each head against the second, angles in fp32."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq  # (S, Dh/2)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_apply(lp: dict[str, torch.Tensor], x: torch.Tensor, *, activation: str,
              cd: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense MLP of one layer (``mlp/{up,down}/{w,b}``, and
    ``mlp/gate/{w,b}`` under SwiGLU): ``down(silu(gate(x)) * up(x))`` or
    ``down(gelu(up(x)))``."""
    up = linear(x, lp["mlp/up/w"], lp.get("mlp/up/b"), cd=cd)
    if activation == "swiglu":
        hidden = F.silu(linear(x, lp["mlp/gate/w"], lp.get("mlp/gate/b"), cd=cd)) * up
    else:
        hidden = gelu(up)
    return linear(hidden, lp["mlp/down/w"], lp.get("mlp/down/b"), cd=cd)


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of a shared ``(V, d)`` or per-client ``(C, V, d)`` table for
    ``ids (C, ...)`` -> ``(C, ..., d)``."""
    if table.ndim == 2:
        return table[ids]
    c = torch.arange(table.shape[0], device=ids.device)
    return table[c.reshape((-1,) + (1,) * (ids.ndim - 1)), ids]


class InitStream:
    """A seeded stream of parameter draws: the n-th leaf drawn from it takes
    the n-th child of ``numpy.random.SeedSequence(seed)``, and its values
    come in chunks of ``CHUNK``, each from a child of the leaf's, filled in
    parallel on the CPU."""

    CHUNK = 1 << 22
    _POOL = ThreadPoolExecutor(max_workers=max(1, min(8, os.cpu_count() or 1)))

    def __init__(self, seed: int):
        self._seq = np.random.SeedSequence(int(seed))

    def _fill(self, shape, draw) -> np.ndarray:
        """``draw(generator, out)`` over the chunks of a new fp32 array."""
        out = np.empty(int(np.prod(shape, dtype=np.int64)), dtype=np.float32)
        (leaf,) = self._seq.spawn(1)
        chunks = [out[i:i + self.CHUNK] for i in range(0, out.size, self.CHUNK)]
        seeds = leaf.spawn(len(chunks))
        list(self._POOL.map(lambda a: draw(np.random.Generator(np.random.PCG64(a[1])), a[0]),
                            zip(chunks, seeds)))
        return out.reshape(shape)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = self._fill(shape, lambda g, out: g.random(out=out, dtype=np.float32))
        return torch.from_numpy(u).mul_(hi - lo).add_(lo)

    def normal(self, shape) -> torch.Tensor:
        return torch.from_numpy(self._fill(
            shape, lambda g, out: g.standard_normal(out=out, dtype=np.float32)))


def truncated_normal(shape, std: float, gen: InitStream) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std`` (fp32, on the CPU), by
    the inverse CDF of a uniform draw."""
    u = gen.uniform(shape, _PHI_LO, _PHI_HI)
    return u.mul_(2.0).sub_(1.0).erfinv_().mul_(_SQRT2 * std)


def normal(shape, std: float, gen: InitStream) -> torch.Tensor:
    return gen.normal(shape).mul_(std)
