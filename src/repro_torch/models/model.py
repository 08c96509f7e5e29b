"""Top-level model: embeddings + stack + LM head — the port of
``repro/models/model.py``'s ``init``, ``forward``, ``init_cache``,
``decode_step`` and ``prefill`` for the attention families (``dense`` and
``moe``: learned positions or RoPE, LayerNorm or RMSNorm, GELU or SwiGLU,
multi-head or grouped-query attention, a tied or untied head), the
attention-free SSM family (Mamba2, no positions) and the hybrid (Jamba's
layer period of SSD mixers, attention and MoE).

Parameters are a flat dict keyed by the reference's pytree paths joined
with ``/`` (``embed``, ``stack/pos0/attn/wq/w``, ``lora_head/A``, ...), so
:mod:`repro_torch.bridge` moves weights between the packages leaf for leaf.
``forward`` runs a leading CLIENT axis: ``tokens (C, B, S)``, LoRA leaves
``(C, ...)``, backbone leaves shared or ``(C, ...)`` (see
:mod:`repro_torch.models.layers`).

LoRA adapters sit on the attention layers' projections and on the LM head;
an attention-free model (SSM) has the head adapter alone, and its paper
eq. 8 projection comes from it (see :func:`backbone`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (
    InitStream, embedding, linear, norm_apply, normal, torch_dtype, truncated_normal,
)
from repro_torch.models.moe import moe_init
from repro_torch.models.ssm import ssm_init
from repro_torch.models.transformer import (
    LAYER_NDIM, STACK_PREFIX, init_stack_cache, layer_kinds, period_of, pos_prefix, stack_apply,
)

__all__ = [
    "Aux", "check_supported", "init", "backbone", "forward", "init_cache", "decode_step", "prefill",
]

_ATTN_TARGETS = ("q", "k", "v", "o")
# dims of the top-level leaves of ONE model (a per-client leaf has one more)
_TOP_NDIM = {"embed": 2, "pos_embed": 2, "lm_head": 2, "final_norm/scale": 1,
             "final_norm/bias": 1, "lora_head/A": 2, "lora_head/B": 2}


class Aux(NamedTuple):
    moe_aux: torch.Tensor  # (C,) fp32 load-balance loss (0 without MoE layers)
    lora_h: torch.Tensor | None  # (C, B, r) pooled LoRA projection (paper eq. 8)


def check_supported(cfg: ModelConfig) -> None:
    """The port carries the dense, MoE, SSM and hybrid families, with fp32
    or bf16 parameters and compute; the VLM and audio families (and
    cross-attention or a frontend) are a later slice's work."""
    if cfg.family in ("vlm", "audio") or cfg.cross_attention or cfg.frontend != "none":
        raise NotImplementedError(
            f"model {cfg.name!r} (family {cfg.family!r}): the port carries the dense, MoE, SSM "
            "and hybrid families only (ROADMAP.md port queue: other model families and mixed "
            "fleets)"
        )
    for field in ("param_dtype", "compute_dtype", "optimizer_state_dtype"):
        if getattr(cfg, field) not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"model {cfg.name!r}: {field}={getattr(cfg, field)!r}; the port carries float32 "
                "and bfloat16 (ROADMAP.md port queue: fp16)"
            )


def init(cfg: ModelConfig, seed: int, device: str | torch.device = "cuda", *,
         adapters_only: bool = False) -> dict[str, torch.Tensor]:
    """Fresh parameters with the reference's shapes and scales, drawn in
    fp32 from the CPU stream :class:`~repro_torch.models.layers.InitStream`
    seeded with ``seed``, stored in
    ``cfg.param_dtype`` on ``device``.  The LoRA adapters are drawn first,
    so ``adapters_only=True`` returns the same adapter leaves alone without
    drawing the backbone: what a client needs under a shared pretrained
    backbone, where drawing and copying the backbone would cost seconds a
    client at a billion parameters."""
    check_supported(cfg)
    gen = InitStream(seed)
    d, hd, period = cfg.d_model, cfg.head_dim, period_of(cfg)
    reps = cfg.num_layers // period
    p: dict[str, torch.Tensor] = {}
    lc = cfg.lora
    if lc is not None:
        out_dims = {"q": cfg.num_heads * hd, "k": cfg.num_kv_heads * hd,
                    "v": cfg.num_kv_heads * hd, "o": d}
        for j in range(period):  # adapters on the attention layers only
            if layer_kinds(cfg, j)[0] != "attn":
                continue
            for tgt in (t for t in lc.targets if t in _ATTN_TARGETS):
                p[pos_prefix(j) + f"lora/{tgt}/A"] = normal((reps, d, lc.rank), d**-0.5, gen)
                p[pos_prefix(j) + f"lora/{tgt}/B"] = torch.zeros(reps, lc.rank, out_dims[tgt])
        if "head" in lc.targets:
            p["lora_head/A"] = normal((d, lc.rank), d**-0.5, gen)
            p["lora_head/B"] = torch.zeros(lc.rank, cfg.vocab_size)
    if not adapters_only:
        p.update(_init_backbone(cfg, gen))
    dt = torch_dtype(cfg.param_dtype)
    return {k: v.to(device=device, dtype=dt) for k, v in p.items()}


def _init_backbone(cfg: ModelConfig, gen: InitStream) -> dict[str, torch.Tensor]:
    """The frozen leaves of :func:`init`, fp32 on the CPU: each position of
    the layer period, its leaves stacked over the repeats."""
    d, hd, period = cfg.d_model, cfg.head_dim, period_of(cfg)
    reps = cfg.num_layers // period
    layer_norm = cfg.norm == "layernorm"
    p: dict[str, torch.Tensor] = {
        "embed": normal((cfg.vocab_size, d), 0.02, gen),
        "final_norm/scale": torch.ones(d),
    }
    if layer_norm:
        p["final_norm/bias"] = torch.zeros(d)

    def dense(name, i, o):
        p[name + "/w"] = truncated_normal((reps, i, o), i**-0.5, gen)
        if cfg.use_bias:
            p[name + "/b"] = torch.zeros(reps, o)

    for j in range(period):
        pre = pos_prefix(j)
        mixer, mlp = layer_kinds(cfg, j)
        for norm in ("norm1",) if mlp is None else ("norm1", "norm2"):
            p[pre + norm + "/scale"] = torch.ones(reps, d)
            if layer_norm:
                p[pre + norm + "/bias"] = torch.zeros(reps, d)
        if mixer == "attn":
            for name, (i, o) in {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
                                 "wv": (d, cfg.num_kv_heads * hd),
                                 "wo": (cfg.num_heads * hd, d)}.items():
                dense(pre + "attn/" + name, i, o)
        else:
            p.update({pre + k: v for k, v in ssm_init(cfg, reps, gen).items()})
        if mlp == "moe":
            p.update({pre + k: v for k, v in moe_init(cfg, reps, gen).items()})
        elif mlp == "dense":
            dense(pre + "mlp/up", d, cfg.d_ff)
            dense(pre + "mlp/down", cfg.d_ff, d)
            if cfg.activation == "swiglu":
                dense(pre + "mlp/gate", d, cfg.d_ff)
    if cfg.positional == "learned":
        p["pos_embed"] = normal((cfg.max_seq_len, d), 0.02, gen)
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((cfg.vocab_size, d), 0.02, gen)
    return p


def _lm_logits(params, cfg: ModelConfig, h: torch.Tensor, head_cols: int | None) -> torch.Tensor:
    """``h (C, B, [S,] d)`` -> logits over the first ``head_cols`` vocab
    columns (all of them when None) in the compute dtype: the tied head
    plus the LoRA head delta."""
    cd = torch_dtype(cfg.compute_dtype)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    cols = slice(None) if head_cols is None else slice(0, head_cols)
    head = head[cols] if head.ndim == 2 else head[:, cols]
    logits = linear(h, head.transpose(-1, -2), cd=cd)
    if "lora_head/A" in params:
        lb = params["lora_head/B"][..., cols]
        logits = logits + linear(linear(h, params["lora_head/A"], cd=cd), lb, cd=cd) * (
            cfg.lora.alpha / cfg.lora.rank
        )
    return logits


def _head_projection(params: dict[str, torch.Tensor], cfg: ModelConfig,
                     h: torch.Tensor) -> torch.Tensor:
    """The fallback eq. 8 projection of a model whose stack gives none (no
    attention layer): ``mean_s(h · lora_head.A)`` over the normed hidden
    states ``h (C, B, S, d)`` -> ``(C, B, r)``."""
    return linear(h, params["lora_head/A"], cd=torch_dtype(cfg.compute_dtype)).mean(dim=2)


def _embed(params: dict[str, torch.Tensor], cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings ``tokens (C, B, S)`` -> ``(C, B, S, d)`` in the
    compute dtype, plus the learned position rows ``positions (S,)`` when
    the model has them (RoPE rotates q and k in attention instead)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = embedding(params["embed"], tokens).to(cd)
    if cfg.positional == "learned":
        pos = params["pos_embed"].index_select(-2, positions.long())
        x = x + (pos if pos.ndim == 2 else pos[:, None]).to(cd)
    return x


def backbone(
    params: dict[str, torch.Tensor],
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    last_only: bool = False,
    window: int | None = None,
) -> tuple[torch.Tensor, Aux]:
    """Hidden states post final-norm, pre LM head: ``tokens (C, B, S)`` ->
    ``(C, B, S, d)``, or ``(C, B, 1, d)`` for the final position only with
    ``last_only`` (the stack still runs every position).  Training reads
    this with a chunked cross-entropy, so ``(B, S, V)`` logits never exist
    at once.  ``Aux.lora_h`` always pools the whole sequence: when the
    stack gives no projection (an SSM model) and the model has a head
    adapter, it is :func:`_head_projection` of every normed position, so
    then the final norm runs over the whole sequence even with
    ``last_only``.  ``window`` (default ``cfg.sliding_window``) is every
    attention layer's sliding window."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    x = _embed(params, cfg, tokens, torch.arange(tokens.shape[-1], device=tokens.device))
    st = stack_apply(params, x, cfg, window=window)
    lora_h = st.lora_h
    if lora_h is None and "lora_head/A" in params:
        h = norm_apply(params, "final_norm", st.x, cfg.norm)
        lora_h = _head_projection(params, cfg, h)
        h = h[:, :, -1:] if last_only else h
    else:
        h = norm_apply(params, "final_norm", st.x[:, :, -1:] if last_only else st.x, cfg.norm)
    return h, Aux(moe_aux=st.moe_aux, lora_h=lora_h)


def forward(
    params: dict[str, torch.Tensor],
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    last_only: bool = False,
    head_cols: int | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, Aux]:
    """``tokens (C, B, S)`` -> logits ``(C, B, S, V)``, or ``(C, B, V)``
    from the final position only with ``last_only``; ``head_cols=k`` keeps
    the first k vocab columns (the class readout).  ``Aux.lora_h`` always
    pools the whole sequence."""
    h, aux = backbone(params, cfg, tokens, last_only=last_only, window=window)
    logits = _lm_logits(params, cfg, h, head_cols)
    return (logits[:, :, 0] if last_only else logits), aux


def _client_rows(params: dict[str, torch.Tensor]) -> int:
    """The leading client axis of the per-client leaves (requests with an
    adapter row each, in serving), or 1 when every leaf is shared."""
    for key, t in params.items():
        base = (LAYER_NDIM[key.rsplit("/", 1)[-1]] + 1 if key.startswith(STACK_PREFIX)
                else _TOP_NDIM[key])
        if t.ndim == base + 1:
            return int(t.shape[0])
    return 1


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, window: int | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Decode cache: the stacked per-layer caches (``{"layers": {"pos{j}":
    KVCache or SSMCache}}``, every field with a leading repeats axis) and
    the absolute ``length``.  With a ``window`` (default
    ``cfg.sliding_window``) each attention layer keeps a ring of
    ``min(cache_len, window)`` slots; an SSM layer keeps its conv histories
    and state, whatever the length."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    return {
        "layers": init_stack_cache(cfg, batch, cache_len, window=window, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: dict[str, torch.Tensor], cfg: ModelConfig, cache: dict,
                token: torch.Tensor, *, window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One serving step: consume ``token (B,)`` at position ``length``,
    return the next-token logits ``(B, V)`` and the cache, advanced IN
    PLACE (the new K/V in each attention layer's ring slot and its
    ``length + 1``, each SSM layer's histories and state, ``length + 1``).

    ``params`` is one model (shared leaves: the batch is a client axis of 1)
    or per-request adapters on the client axis (``B`` rows of batch 1 each)
    over a shared backbone.  ``window`` (default ``cfg.sliding_window``)
    must be the one the cache was made with."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    b = token.shape[0]
    c = _client_rows(params)
    if c not in (1, b):
        raise ValueError(f"{c} adapter rows for a batch of {b}")
    x = _embed(params, cfg, token.reshape(c, b // c, 1), cache["length"].reshape(1))
    st = stack_apply(params, x, cfg, caches=cache["layers"], window=window)
    h = norm_apply(params, "final_norm", st.x, cfg.norm)
    logits = _lm_logits(params, cfg, h, None).reshape(b, -1)
    for layer_cache in cache["layers"].values():
        if isinstance(layer_cache, KVCache):
            layer_cache.length.add_(1)
    cache["length"].add_(1)
    return logits, cache


def prefill(params: dict[str, torch.Tensor], cfg: ModelConfig, batch: dict, *,
            window: int | None = None) -> tuple[torch.Tensor, Aux]:
    """Full forward over the prompts ``batch["tokens"] (B, S)`` of one
    model, returning the last-position logits ``(B, V)`` — what sampling
    needs — and ``Aux`` with ``moe_aux ()`` and ``lora_h (B, r)``.  From
    ``S = 1024`` on the attention takes the chunked path."""
    logits, aux = forward(params, cfg, batch["tokens"][None], last_only=True, window=window)
    return logits[0], Aux(moe_aux=aux.moe_aux[0],
                          lora_h=None if aux.lora_h is None else aux.lora_h[0])
