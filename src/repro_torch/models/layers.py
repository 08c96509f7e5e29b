"""Primitive layers on tensors with a leading CLIENT axis — the port of
``repro/models/layers.py`` for the GPT-2 family.

Activations are ``(C, ..., d)``: ``C`` clients (1 for a single model).  A
weight leaf is either SHARED (its base shape, broadcast over the clients:
the matmul sees ``(C·B·S, d)``) or PER CLIENT (a leading ``(C, ...)``
axis: a batched matmul over the client axis); the layer tells the two apart
by the leaf's number of dims.  Two defaults differ from PyTorch's own:
LayerNorm's eps is 1e-6 (as in the reference), and GELU is the tanh
approximation (``jax.nn.gelu``'s default).

Precision follows the reference's: a layer computes in the model's
compute dtype (:func:`linear` casts its input and weights to it, as
``dense_apply`` does), LayerNorm keeps its statistics in fp32 and returns
its input's dtype, and parameters are stored in ``param_dtype``.

Init draws from an explicit CPU ``torch.Generator`` — the same shapes and
scales as ``repro.models.init`` (truncated-normal fan-in dense weights, zero
biases, N(0, 0.02) embeddings) — so a seed gives the same weights on any
device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "NORM_EPS",
    "torch_dtype",
    "linear",
    "layer_norm",
    "gelu",
    "embedding",
    "per_client",
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


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"float32"``,
    ``"bfloat16"``)."""
    return getattr(torch, name)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           cd: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w (+ b)`` in the compute dtype ``cd`` (x, w and b cast to it)
    for ``x (C, ..., i)`` and a shared ``w (i, o)`` or a per-client
    ``w (C, i, o)``."""
    x, w = x.to(cd), w.to(cd)
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of a shared ``(V, d)`` or per-client ``(C, V, d)`` table for
    ``ids (C, ...)`` -> ``(C, ..., d)``."""
    if table.ndim == 2:
        return table[ids]
    c = torch.arange(table.shape[0], device=ids.device)
    return table[c.reshape((-1,) + (1,) * (ids.ndim - 1)), ids]


def truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std`` (fp32, on the CPU)."""
    u = torch.empty(shape, dtype=torch.float32).uniform_(_PHI_LO, _PHI_HI, generator=gen)
    return u.mul_(2.0).sub_(1.0).erfinv_().mul_(_SQRT2 * std)


def normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).normal_(0.0, std, generator=gen)
