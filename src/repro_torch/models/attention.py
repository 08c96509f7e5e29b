"""Full-sequence causal self-attention with q/k/v LoRA — the port of
``repro/models/attention.py``'s ``_dense_attention`` path for the GPT-2
family.  (The chunked path is taken only at ``S >= 1024``; decode and the
KV cache belong to serving, a later slice.)
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear

__all__ = ["lora_delta", "attn_apply"]

_NEG_INF = -1e30


def lora_delta(
    a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *, alpha: float, rank: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``x @ A @ B * alpha/r`` with per-client factors ``A (C, d, r)``,
    ``B (C, r, o)`` for ``x (C, ..., d)``.  Returns ``(delta, h)`` with the
    projection ``h = x @ A`` (paper eq. 8)."""
    h = linear(x, a)
    return linear(h, b) * (alpha / rank), h


def attn_apply(
    lp: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Causal self-attention of one layer.  ``lp`` holds the layer's
    ``attn/w{q,k,v,o}/{w,b}`` and, when it has adapters,
    ``lora/<target>/{A,B}``; ``x (C, B, S, d)``.  Returns ``(y, lora_h)``
    where ``lora_h (C, B, S, r)`` is the q adapter's projection (the v
    adapter's without a q adapter), or None without adapters."""
    c, bsz, s, _ = x.shape
    hd = cfg.head_dim
    proj, hs = {}, {}
    for name in ("q", "k", "v"):
        y = linear(x, lp[f"attn/w{name}/w"], lp.get(f"attn/w{name}/b"))
        if f"lora/{name}/A" in lp:
            delta, hs[name] = lora_delta(
                lp[f"lora/{name}/A"], lp[f"lora/{name}/B"], x,
                alpha=cfg.lora.alpha, rank=cfg.lora.rank,
            )
            y = y + delta
        proj[name] = y.reshape(c * bsz, s, -1, hd)
    scores = torch.einsum("bshd,bthd->bhst", proj["q"].float(), proj["k"].float()) * hd**-0.5
    pos = torch.arange(s, device=x.device)
    causal = pos[:, None] >= pos[None, :]
    scores = torch.where(causal, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, proj["v"].float())
    out = out.reshape(c, bsz, s, -1).to(x.dtype)
    y = linear(out, lp["attn/wo/w"], lp.get("attn/wo/b"))
    return y, hs.get("q", hs.get("v"))
