"""Top-level model: embeddings + stack(s) + LM head — the port of
``repro/models/model.py``'s ``init``, ``forward``, ``init_cache``,
``decode_step``, ``prefill`` and ``input_token_len`` for every family:
the attention families (``dense`` and ``moe``: learned positions or RoPE,
LayerNorm or RMSNorm, GELU or SwiGLU, multi-head or grouped-query
attention, a tied or untied head), the attention-free SSM family (Mamba2,
no positions), the hybrid (Jamba's layer period of SSD mixers, attention
and MoE), the VLM (stub patch embeddings prepended to the text, the head
reading the text region) and the audio encoder-decoder (a bidirectional
encoder over stub frame embeddings, ``encoder/`` and ``enc_norm``, and a
decoder that cross-attends to its output).

The modality stream is the batch's ``frontend (B, F, d)`` when the caller
gives one, else :func:`repro_torch.models.frontends.synth_frontend_embeddings`
(ROADMAP.md "Known deviations": a numpy draw, not ``jax.random``'s),
broadcast over the client axis.

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
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import frontends
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (
    FLOAT_DTYPES, InitStream, embedding, linear, norm_apply, normal, torch_dtype, truncated_normal,
)
from repro_torch.models.moe import moe_init
from repro_torch.models.ssm import ssm_init
from repro_torch.models.transformer import (
    ENCODER_PREFIX, LAYER_NDIM, STACK_PREFIX, STACK_PREFIXES, init_stack_cache, layer_kinds,
    pos_prefix, stack_apply, stack_period,
)
from repro_torch.sharding import constrain, gather_fsdp, rules_installed

__all__ = [
    "Aux", "check_supported", "init", "param_shapes", "input_token_len", "backbone", "forward",
    "init_cache", "decode_step", "prefill",
]

_ATTN_TARGETS = ("q", "k", "v", "o")
# dims of the top-level leaves of ONE model (a per-client leaf has one more)
_TOP_NDIM = {"embed": 2, "pos_embed": 2, "lm_head": 2, "final_norm/scale": 1,
             "final_norm/bias": 1, "enc_norm/scale": 1, "enc_norm/bias": 1, "lora_head/A": 2,
             "lora_head/B": 2}


class Aux(NamedTuple):
    moe_aux: torch.Tensor  # (C,) fp32 load-balance loss (0 without MoE layers)
    lora_h: torch.Tensor | None  # (C, B, r) pooled LoRA projection (paper eq. 8)


def check_supported(cfg: ModelConfig) -> None:
    """The port carries every family with fp32, bf16 or fp16 parameters,
    compute and optimizer state; any other dtype name raises."""
    for field in ("param_dtype", "compute_dtype", "optimizer_state_dtype"):
        if getattr(cfg, field) not in FLOAT_DTYPES:
            raise ValueError(
                f"model {cfg.name!r}: {field}={getattr(cfg, field)!r}; expected one of "
                f"{', '.join(FLOAT_DTYPES)}"
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
    return _build(cfg, InitStream(seed), device, adapters_only)


class _ShapeStream:
    """An :class:`InitStream` that draws nothing: every leaf an empty
    ``meta`` tensor of its shape."""

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        return torch.empty(shape, device="meta")

    def normal(self, shape) -> torch.Tensor:
        return torch.empty(shape, device="meta")


def param_shapes(cfg: ModelConfig, dtype: str | None = None) -> dict[str, torch.Tensor]:
    """The keys, shapes and dtypes :func:`init` gives (in ``dtype``, the
    config's ``param_dtype`` by default) as ``meta`` tensors, with nothing
    drawn or allocated: the port's ``jax.eval_shape(init)``, for a model of
    any size."""
    p = _build(cfg, _ShapeStream(), "meta", False)
    return p if dtype is None else {k: v.to(torch_dtype(dtype)) for k, v in p.items()}


def _build(cfg: ModelConfig, gen, device, adapters_only: bool) -> dict[str, torch.Tensor]:
    check_supported(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    p: dict[str, torch.Tensor] = {}
    lc = cfg.lora
    if lc is not None:
        out_dims = {"q": cfg.num_heads * hd, "k": cfg.num_kv_heads * hd,
                    "v": cfg.num_kv_heads * hd, "o": d}
        for prefix, layers in _stacks(cfg):
            period = stack_period(cfg, layers)
            for j in range(period):  # adapters on the attention layers only
                if layer_kinds(cfg, j)[0] != "attn":
                    continue
                pre, reps = pos_prefix(j, prefix), layers // period
                for tgt in (t for t in lc.targets if t in _ATTN_TARGETS):
                    p[pre + f"lora/{tgt}/A"] = normal((reps, d, lc.rank), d**-0.5, gen)
                    p[pre + f"lora/{tgt}/B"] = torch.zeros(reps, lc.rank, out_dims[tgt])
        if "head" in lc.targets:
            p["lora_head/A"] = normal((d, lc.rank), d**-0.5, gen)
            p["lora_head/B"] = torch.zeros(lc.rank, cfg.vocab_size)
    dt = torch_dtype(cfg.param_dtype)
    p = {k: v.to(device=device, dtype=dt) for k, v in p.items()}
    if not adapters_only:  # each leaf stored as it is drawn: one fp32 leaf on the host at a time
        p.update((k, v.to(device=device, dtype=dt)) for k, v in _init_backbone(cfg, gen))
    return p


def _stacks(cfg: ModelConfig) -> list[tuple[str, int]]:
    """``(prefix, layers)`` of the model's stacks: the decoder, then the
    encoder when there is one."""
    out = [(STACK_PREFIX, cfg.num_layers)]
    if cfg.encoder_layers > 0:
        out.append((ENCODER_PREFIX, cfg.encoder_layers))
    return out


def _init_backbone(cfg: ModelConfig, gen):
    """The frozen leaves of :func:`init` as ``(key, leaf)`` pairs, each leaf
    fp32 on the CPU and drawn when its pair is taken: each position of each
    stack's layer period, its leaves stacked over the repeats; the
    decoder's layers carry ``norm_x`` and ``cross`` with cross-attention,
    and the encoder ends in ``enc_norm``."""
    d, hd = cfg.d_model, cfg.head_dim
    layer_norm = cfg.norm == "layernorm"

    def norm(name, lead=()):
        yield name + "/scale", torch.ones(lead + (d,))
        if layer_norm:
            yield name + "/bias", torch.zeros(lead + (d,))

    def dense(name, reps, i, o):
        yield name + "/w", truncated_normal((reps, i, o), i**-0.5, gen)
        if cfg.use_bias:
            yield name + "/b", torch.zeros(reps, o)

    yield "embed", normal((cfg.vocab_size, d), 0.02, gen)
    yield from norm("final_norm")
    attn_dims = {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
                 "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}
    for prefix, layers in _stacks(cfg):
        period = stack_period(cfg, layers)
        reps = layers // period
        cross = cfg.cross_attention and prefix == STACK_PREFIX
        for j in range(period):
            pre = pos_prefix(j, prefix)
            mixer, mlp = layer_kinds(cfg, j)
            for name in ("norm1",) if mlp is None else ("norm1", "norm2"):
                yield from norm(pre + name, (reps,))
            if mixer == "attn":
                for name, (i, o) in attn_dims.items():
                    yield from dense(pre + "attn/" + name, reps, i, o)
            else:
                yield from ((pre + k, v) for k, v in ssm_init(cfg, reps, gen).items())
            if cross:
                yield from norm(pre + "norm_x", (reps,))
                for name, (i, o) in attn_dims.items():
                    yield from dense(pre + "cross/" + name, reps, i, o)
            if mlp == "moe":
                yield from ((pre + k, v) for k, v in moe_init(cfg, reps, gen).items())
            elif mlp == "dense":
                yield from dense(pre + "mlp/up", reps, d, cfg.d_ff)
                yield from dense(pre + "mlp/down", reps, cfg.d_ff, d)
                if cfg.activation == "swiglu":
                    yield from dense(pre + "mlp/gate", reps, d, cfg.d_ff)
        if prefix == ENCODER_PREFIX:
            yield from norm("enc_norm")
    if cfg.positional == "learned":
        yield "pos_embed", normal((cfg.max_seq_len, d), 0.02, gen)
    if not cfg.tie_embeddings:
        yield "lm_head", normal((cfg.vocab_size, d), 0.02, gen)


def input_token_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens a sample given the assigned shape's ``seq_len``: the
    VLM's patches take ``frontend_len`` positions of it."""
    if cfg.family == "vlm":
        return seq_len - cfg.frontend_len
    return seq_len


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
    table = params["embed"]
    if rules_installed() and tokens.shape[-1] > 1 and table.ndim == 2:
        # a one-hot matmul in place of the gather, so the contraction runs
        # over the vocab shards (a gather on the vocab-sharded table would
        # gather the whole table); the one-hot vocab-sharded and
        # recomputed in the backward pass rather than kept
        def embed(tok, tab):
            vocab = torch.arange(cfg.vocab_size, device=tok.device)
            onehot = constrain((tok[..., None] == vocab).to(cd), None, "batch", None, "vocab")
            return torch.matmul(onehot, gather_fsdp(tab).to(cd))

        x = torch.utils.checkpoint.checkpoint(embed, tokens, table, use_reentrant=False)
    elif rules_installed() and table.ndim == 2:
        # decode: each rank looks its vocab shard's rows up for every token
        # (the ids whole on every rank), the partial rows summed over "model"
        whole = (None,) * tokens.ndim
        rows = torch.nn.functional.embedding(constrain(tokens, *whole), gather_fsdp(table))
        x = constrain(rows, *whole, None).to(cd)
    else:
        x = embedding(table, tokens).to(cd)
    if cfg.positional == "learned":
        pos = params["pos_embed"].index_select(-2, positions.long())
        x = x + (pos if pos.ndim == 2 else pos[:, None]).to(cd)
    return x


def _frontend(cfg: ModelConfig, frontend: torch.Tensor | None, c: int, b: int,
              device: torch.device) -> torch.Tensor:
    """The modality stream ``(C, B, F, d)`` in the compute dtype: the
    caller's ``(B, F, d)`` or ``(C, B, F, d)``, else the stub's draw; a
    shared stream is broadcast over the clients (a view, no copy)."""
    if frontend is None:
        frontend = frontends.synth_frontend_embeddings(cfg, b, device=device)
    frontend = frontend.to(torch_dtype(cfg.compute_dtype))
    return frontend.expand((c,) + tuple(frontend.shape)) if frontend.ndim == 3 else frontend


def _run_encoder(params: dict[str, torch.Tensor], cfg: ModelConfig,
                 frontend: torch.Tensor) -> torch.Tensor:
    """The audio encoder: the ``encoder/`` stack, bidirectional, over the
    frame embeddings ``frontend (C, B, F, d)``, then ``enc_norm`` ->
    ``(C, B, F, d)`` in the compute dtype.  Its adapters' projection is
    dropped, as in the reference."""
    st = stack_apply(params, frontend.to(torch_dtype(cfg.compute_dtype)), cfg,
                     prefix=ENCODER_PREFIX, num_layers=cfg.encoder_layers, causal=False)
    return norm_apply(params, "enc_norm", st.x, cfg.norm)


def backbone(
    params: dict[str, torch.Tensor],
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    frontend: torch.Tensor | None = None,
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
    attention layer's sliding window.

    ``frontend`` (``(B, F, d)`` or per client ``(C, B, F, d)``; the stub
    when None) is the VLM's patches, prepended to the text (positions run
    over both, and so does the pooled projection; the hidden states
    returned are the text's), or the audio model's frames, which the
    encoder reads and the decoder cross-attends to."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    c, b, s = tokens.shape
    enc_out, f = None, 0
    if cfg.family in ("vlm", "audio"):
        frontend = _frontend(cfg, frontend, c, b, tokens.device)
        if cfg.family == "audio":
            enc_out = _run_encoder(params, cfg, frontend)
        else:
            f = frontend.shape[2]
    pos = torch.arange(f + s, device=tokens.device)
    x = _embed(params, cfg, tokens, pos[f:])
    if f:
        x = torch.cat([frontend.to(x.dtype), x], dim=2)
    st = stack_apply(params, x, cfg, window=window, enc_out=enc_out)
    st = st._replace(x=st.x[:, :, f:]) if f else st  # the text region only
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
    frontend: torch.Tensor | None = None,
    last_only: bool = False,
    head_cols: int | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, Aux]:
    """``tokens (C, B, S)`` -> logits ``(C, B, S, V)`` (the text positions
    of a VLM), or ``(C, B, V)`` from the final position only with
    ``last_only``; ``head_cols=k`` keeps the first k vocab columns (the
    class readout).  ``Aux.lora_h`` always pools the whole sequence.
    ``frontend``: see :func:`backbone`."""
    h, aux = backbone(params, cfg, tokens, frontend=frontend, last_only=last_only, window=window)
    logits = _lm_logits(params, cfg, h, head_cols)
    return (logits[:, :, 0] if last_only else logits), aux


def _client_rows(params: dict[str, torch.Tensor]) -> int:
    """The leading client axis of the per-client leaves (requests with an
    adapter row each, in serving), or 1 when every leaf is shared."""
    for key, t in params.items():
        base = (LAYER_NDIM[key.rsplit("/", 1)[-1]] + 1 if key.startswith(STACK_PREFIXES)
                else _TOP_NDIM[key])
        if t.ndim == base + 1:
            return int(t.shape[0])
    return 1


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, window: int | None = None,
               enc_out: torch.Tensor | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Decode cache: the stacked per-layer caches (``{"layers": {"pos{j}":
    KVCache or SSMCache}}``, every field with a leading repeats axis) and
    the absolute ``length``.  With a ``window`` (default
    ``cfg.sliding_window``) each attention layer keeps a ring of
    ``min(cache_len, window)`` slots; an SSM layer keeps its conv histories
    and state, whatever the length.  An audio model's cache also holds the
    fixed encoder output ``enc_out (batch, F, d)`` the decoder
    cross-attends to (zeros in the compute dtype when none is given, as in
    the reference)."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    cache = {
        "layers": init_stack_cache(cfg, batch, cache_len, window=window, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.family == "audio":
        if enc_out is None:
            enc_out = torch.zeros((batch, cfg.frontend_len, cfg.d_model),
                                  dtype=torch_dtype(cfg.compute_dtype), device=device)
        cache["enc_out"] = enc_out
    return cache


def decode_step(params: dict[str, torch.Tensor], cfg: ModelConfig, cache: dict,
                token: torch.Tensor, *, window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One serving step: consume ``token (B,)`` at position ``length``,
    return the next-token logits ``(B, V)`` and the cache, advanced IN
    PLACE (the new K/V in each attention layer's ring slot and its
    ``length + 1``, each SSM layer's histories and state, ``length + 1``).
    An audio model's decoder cross-attends to the cache's ``enc_out``; a
    VLM decodes text alone, its positions from the cache's length.

    ``params`` is one model (shared leaves: the batch is a client axis of 1)
    or per-request adapters on the client axis (``B`` rows of batch 1 each)
    over a shared backbone; either way an MoE layer routes the ``B``
    tokens as one group set, as the reference's batch.  ``window`` (default ``cfg.sliding_window``)
    must be the one the cache was made with."""
    check_supported(cfg)
    window = window if window is not None else cfg.sliding_window
    b = token.shape[0]
    c = _client_rows(params)
    if c not in (1, b):
        raise ValueError(f"{c} adapter rows for a batch of {b}")
    x = _embed(params, cfg, token.reshape(c, b // c, 1), cache["length"].reshape(1))
    enc_out = cache.get("enc_out")
    if enc_out is not None:  # the encoder's frames of each request, on the client axis
        enc_out = enc_out.reshape((c, b // c) + tuple(enc_out.shape[1:]))
    st = stack_apply(params, x, cfg, caches=cache["layers"], window=window, enc_out=enc_out,
                     pool_moe=True)
    h = norm_apply(params, "final_norm", st.x, cfg.norm)
    logits = _lm_logits(params, cfg, h, None).reshape(b, -1)
    for layer_cache in cache["layers"].values():
        if isinstance(layer_cache, KVCache):
            layer_cache.length.add_(1)
    cache["length"].add_(1)
    return logits, cache


def prefill(params: dict[str, torch.Tensor], cfg: ModelConfig, batch: dict, *,
            window: int | None = None) -> tuple[torch.Tensor, Aux]:
    """Full forward over the prompts ``batch["tokens"] (B, S)`` (and
    ``batch["frontend"] (B, F, d)`` when given) of one model, returning the
    last-position logits ``(B, V)`` — what sampling needs — and ``Aux``
    with ``moe_aux ()`` and ``lora_h (B, r)``.  From ``S = 1024`` on the
    attention takes the chunked path."""
    logits, aux = forward(params, cfg, batch["tokens"][None], frontend=batch.get("frontend"),
                          last_only=True, window=window)
    return logits[0], Aux(moe_aux=aux.moe_aux[0],
                          lora_h=None if aux.lora_h is None else aux.lora_h[0])
