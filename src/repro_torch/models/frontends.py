"""Stub modality frontends — the port of ``repro/models/frontends.py``.

The ``vlm`` and ``audio`` architectures specify the transformer backbone
only; the vision tower and projector (VLM) and the speech feature extractor
(audio) are stubs: a batch may carry precomputed patch or frame embeddings
as ``"frontend" (B, frontend_len, d_model)``, and without them the model
uses :func:`synth_frontend_embeddings`, a deterministic stand-in with
zero mean and unit variance.

The reference draws it from ``jax.random.normal(PRNGKey(seed))``, which
torch cannot reproduce (as with the init, ROADMAP.md "Known deviations"):
here it is fp32 standard normals from numpy generators seeded with
``seed`` (:class:`~repro_torch.models.layers.InitStream`), so the CPU and
the card get the same tensor.  The reference's draw is a constant per
shape and seed, so one draw per (shape, seed, dtype, device) is the same
function: the last ``CACHE_ENTRIES`` are kept, and a full-width VLM
forward does not draw hundreds of millions of values on the host each
call.  A cached tensor is shared: callers must not write into it.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import InitStream, torch_dtype

__all__ = ["CACHE_ENTRIES", "frontend_embedding_shape", "synth_frontend_embeddings"]

CACHE_ENTRIES = 8
_CACHE: OrderedDict = OrderedDict()


def frontend_embedding_shape(cfg: ModelConfig, batch: int) -> tuple[int, int, int]:
    """``(B, frontend_len, d_model)`` of the stubbed modality stream."""
    assert cfg.frontend != "none"
    return (batch, cfg.frontend_len, cfg.d_model)


def synth_frontend_embeddings(cfg: ModelConfig, batch: int, *, seed: int = 0,
                              dtype: str | None = None,
                              device: str | torch.device = "cuda") -> torch.Tensor:
    """Deterministic stand-in embeddings ``(B, frontend_len, d_model)`` in
    ``dtype`` (default ``cfg.compute_dtype``) on ``device``."""
    shape = frontend_embedding_shape(cfg, batch)
    dt, dev = torch_dtype(dtype or cfg.compute_dtype), torch.device(device)
    key = (shape, int(seed), dt, dev)
    x = _CACHE.get(key)
    if x is None:
        x = InitStream(seed).normal(shape).to(device=dev, dtype=dt)
        while len(_CACHE) >= CACHE_ENTRIES:
            _CACHE.popitem(last=False)
        _CACHE[key] = x
    else:
        _CACHE.move_to_end(key)
    return x
