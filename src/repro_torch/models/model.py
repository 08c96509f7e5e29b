"""Top-level model: embeddings + stack + tied LM head — the port of
``repro/models/model.py``'s ``init`` and ``forward`` for the GPT-2 family.

Parameters are a flat dict keyed by the reference's pytree paths joined
with ``/`` (``embed``, ``stack/pos0/attn/wq/w``, ``lora_head/A``, ...), so
:mod:`repro_torch.bridge` moves weights between the packages leaf for leaf.
``forward`` runs a leading CLIENT axis: ``tokens (C, B, S)``, LoRA leaves
``(C, ...)``, backbone leaves shared or ``(C, ...)`` (see
:mod:`repro_torch.models.layers`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import embedding, layer_norm, linear, normal, truncated_normal
from repro_torch.models.transformer import STACK_PREFIX, stack_apply

__all__ = ["Aux", "check_supported", "init", "forward"]

_ATTN_TARGETS = ("q", "k", "v", "o")


class Aux(NamedTuple):
    lora_h: torch.Tensor | None  # (C, B, r) pooled LoRA projection (paper eq. 8)


def check_supported(cfg: ModelConfig) -> None:
    """The port carries the GPT-2 family (dense, learned positions,
    LayerNorm, GELU, multi-head attention, fp32); anything else is a later
    slice's work."""
    ok = (
        cfg.family == "dense" and cfg.moe is None and cfg.positional == "learned"
        and cfg.norm == "layernorm" and cfg.activation == "gelu"
        and cfg.num_kv_heads == cfg.num_heads and cfg.sliding_window is None
    )
    if not ok:
        raise NotImplementedError(
            f"model {cfg.name!r}: the port carries the GPT-2 family only "
            "(ROADMAP.md port queue: other model families and mixed fleets)"
        )
    if cfg.param_dtype != "float32" or cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"model {cfg.name!r}: the port computes in float32 only (ROADMAP.md port queue: bf16)"
        )


def init(cfg: ModelConfig, seed: int, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Fresh parameters with the reference's shapes and scales, drawn from
    a CPU ``torch.Generator`` seeded with ``seed`` and moved to ``device``."""
    check_supported(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    d, L, hd = cfg.d_model, cfg.num_layers, cfg.head_dim
    p: dict[str, torch.Tensor] = {
        "embed": normal((cfg.vocab_size, d), 0.02, gen),
        "final_norm/scale": torch.ones(d),
        "final_norm/bias": torch.zeros(d),
    }
    pre = STACK_PREFIX

    def dense(name, i, o):
        p[pre + name + "/w"] = truncated_normal((L, i, o), i**-0.5, gen)
        if cfg.use_bias:
            p[pre + name + "/b"] = torch.zeros(L, o)

    for norm in ("norm1", "norm2"):
        p[pre + norm + "/scale"] = torch.ones(L, d)
        p[pre + norm + "/bias"] = torch.zeros(L, d)
    for name, (i, o) in {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
                         "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}.items():
        dense("attn/" + name, i, o)
    dense("mlp/up", d, cfg.d_ff)
    dense("mlp/down", cfg.d_ff, d)
    lc = cfg.lora
    if lc is not None:
        out_dims = {"q": cfg.num_heads * hd, "k": cfg.num_kv_heads * hd,
                    "v": cfg.num_kv_heads * hd, "o": d}
        for tgt in (t for t in lc.targets if t in _ATTN_TARGETS):
            p[pre + f"lora/{tgt}/A"] = normal((L, d, lc.rank), d**-0.5, gen)
            p[pre + f"lora/{tgt}/B"] = torch.zeros(L, lc.rank, out_dims[tgt])
    p["pos_embed"] = normal((cfg.max_seq_len, d), 0.02, gen)
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((cfg.vocab_size, d), 0.02, gen)
    if lc is not None and "head" in lc.targets:
        p["lora_head/A"] = normal((d, lc.rank), d**-0.5, gen)
        p["lora_head/B"] = torch.zeros(lc.rank, cfg.vocab_size)
    return {k: v.to(device) for k, v in p.items()}


def _lm_logits(params, cfg: ModelConfig, h: torch.Tensor, head_cols: int | None) -> torch.Tensor:
    """``h (C, B, [S,] d)`` -> logits over the first ``head_cols`` vocab
    columns (all of them when None): the tied head plus the LoRA head delta."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    cols = slice(None) if head_cols is None else slice(0, head_cols)
    head = head[cols] if head.ndim == 2 else head[:, cols]
    logits = linear(h, head.transpose(-1, -2))
    if "lora_head/A" in params:
        lb = params["lora_head/B"][..., cols]
        logits = logits + linear(linear(h, params["lora_head/A"]), lb) * (
            cfg.lora.alpha / cfg.lora.rank
        )
    return logits


def forward(
    params: dict[str, torch.Tensor],
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    last_only: bool = False,
    head_cols: int | None = None,
) -> tuple[torch.Tensor, Aux]:
    """``tokens (C, B, S)`` -> logits ``(C, B, S, V)``, or ``(C, B, V)``
    from the final position only with ``last_only``; ``head_cols=k`` keeps
    the first k vocab columns (the class readout).  ``Aux.lora_h`` always
    pools the whole sequence."""
    check_supported(cfg)
    s = tokens.shape[-1]
    pos = params["pos_embed"]
    pos = pos[:s] if pos.ndim == 2 else pos[:, None, :s]
    x = embedding(params["embed"], tokens) + pos
    st = stack_apply(params, x, cfg)
    h = st.x[:, :, -1] if last_only else st.x
    h = layer_norm(h, params["final_norm/scale"], params["final_norm/bias"])
    return _lm_logits(params, cfg, h, head_cols), Aux(lora_h=st.lora_h)
