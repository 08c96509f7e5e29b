"""Self-attention with q/k/v LoRA, grouped-query heads, RoPE, the
sliding window and the decode KV cache, and the encoder-decoder's
cross-attention — the port of ``repro/models/attention.py``.

Full-sequence mode (no cache) masks the future (and, with a window, keys
``window`` or more positions back), or nothing with ``causal=False`` (an
encoder's bidirectional layers): dense attention below ``2 * Q_CHUNK``
positions, and from there the reference's chunked path, which scans query
chunks so the ``(S, S)`` scores are never held at once
(``_chunked_attention``; the same function, less peak memory).  Decode mode
writes one new token's K/V into a ring slot of the cache and attends over
every written slot still inside the window.

Grouped-query attention keeps ``num_kv_heads`` K/V heads; query head ``h``
reads K/V head ``h // q_per_kv`` (the reference's ``jnp.repeat`` on the
head axis).  Under RoPE, q and k are rotated by absolute position; in
decode the new key is rotated by ``length`` before it is written, so a
cached key is never rotated again.

Cross-attention (:func:`cross_attn_apply`) reads q from the decoder's
stream and K/V from the encoder's output: no mask, no RoPE, no LoRA, and
K/V recomputed on every call, decode steps included, as in the reference.

On a mesh (:func:`repro_torch.sharding.on_mesh`) the attention runs as
each rank's block: the full sequence per (batch row, head), decode per
slot shard of the sequence-sharded cache, the partial softmaxes merged
across the ranks; with no rules installed both are the one-device code.

Per-request adapters (multi-tenant serving) ride on the model's leading
client axis: ``C`` requests of batch 1 each, every request with its own
``(C, d, r)`` adapter row, so row b's contraction is the per-client matmul
of a cohort.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, linear, torch_dtype
from repro_torch.sharding import (
    constrain, index_copy_, local_apply, reduce_over, split_axes, split_last,
)

__all__ = ["KVCache", "Q_CHUNK", "init_kv_cache", "lora_delta", "qkv", "attn_apply",
           "cross_attn_apply"]

_NEG_INF = -1e30
# query-chunk length of the full-sequence path from 2 * Q_CHUNK positions on
Q_CHUNK = 512


class KVCache(NamedTuple):
    """One attention layer's decode cache (stacked over layers in the
    model's cache: a leading ``(L, ...)`` axis on every field)."""

    k: torch.Tensor  # (B, C, Kv, Dh)
    v: torch.Tensor  # (B, C, Kv, Dh)
    pos: torch.Tensor  # (C,) int32 absolute position of each slot, -1 = empty
    length: torch.Tensor  # () int32 tokens seen so far


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  device: str | torch.device = "cuda") -> KVCache:
    """An empty cache, K and V in the model's compute dtype."""
    hd, dt = cfg.head_dim, torch_dtype(cfg.compute_dtype)
    return KVCache(
        k=torch.zeros((batch, cache_len, cfg.num_kv_heads, hd), dtype=dt, device=device),
        v=torch.zeros((batch, cache_len, cfg.num_kv_heads, hd), dtype=dt, device=device),
        pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def lora_delta(
    a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *, alpha: float, rank: int,
    cd: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``x @ A @ B * alpha/r`` in the compute dtype ``cd``, with shared
    factors ``A (d, r)``, ``B (r, o)`` or per-client ones ``A (C, d, r)``,
    ``B (C, r, o)`` for ``x (C, ..., d)``.  Returns ``(delta, h)`` with the
    projection ``h = x @ A`` (paper eq. 8)."""
    h = linear(x, a, cd=cd)
    return linear(h, b, cd=cd) * (alpha / rank), h


def qkv(lp: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig):
    """The layer's q, k, v for ``x (C, B, S, d)``, each ``(C·B, S, H,
    Dh)``, and ``lora_h (C, B, S, r)``: the q adapter's projection (the v
    adapter's without a q adapter), or None without adapters."""
    c, bsz, s, _ = x.shape
    cd = torch_dtype(cfg.compute_dtype)
    proj, hs = {}, {}
    for name in ("q", "k", "v"):
        y = linear(x, lp[f"attn/w{name}/w"], lp.get(f"attn/w{name}/b"), cd=cd)
        if f"lora/{name}/A" in lp:
            delta, hs[name] = lora_delta(
                lp[f"lora/{name}/A"], lp[f"lora/{name}/B"], x,
                alpha=cfg.lora.alpha, rank=cfg.lora.rank, cd=cd,
            )
            y = y + delta
        heads = cfg.num_heads if name == "q" else cfg.num_kv_heads
        proj[name] = split_last(y, heads, c * bsz, s)
    return proj["q"], proj["k"], proj["v"], hs.get("q", hs.get("v"))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor | None) -> torch.Tensor:
    """``softmax(q k^T * Dh^-0.5)`` over the keys ``valid`` marks (every
    key when None), times v: q ``(B, S, H, Dh)``, k/v ``(B, T, Kv, Dh)``
    with ``Kv`` dividing ``H`` (query head h reads K/V head ``h // (H /
    Kv)``), ``valid`` broadcastable to ``(S, T)`` -> ``(B, S, H·Dh)``
    fp32."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    # every (batch row, head) attends on its own: on a mesh each rank runs
    # its block of the head-sharded (B, H, S, T) scores, the reference's
    # anchor on the scores
    heads = ("batch", None, "heads", None)
    return local_apply(_attend_heads, (q, k, v, valid), (heads, heads, heads, None), heads[:3],
                       {"batch": q.shape[0], "heads": q.shape[2]})


def _attend_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Decode's :func:`_attend` over the cache.  On a mesh whose cache is
    sharded over its slots (the reference's flash-decoding layout, q whole
    over ``"model"``) each rank attends over its own slots and the partial
    softmaxes are merged across the ranks (their maxima, normalisers and
    weighted values reduced), where placing the heads would move the whole
    cache every step."""
    seq = split_axes("seq", k.shape[1])
    if not seq:
        return _attend(q, k, v, valid)
    whole, slots = ("batch", None, None, None), ("batch", "seq", None, None)
    return local_apply(functools.partial(_attend_slots, axes=seq), (q, k, v, valid),
                       (whole, slots, slots, (None, "seq")), whole[:3],
                       {"batch": q.shape[0], "seq": k.shape[1]})


def _attend_slots(q, k, v, valid, axes):
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * q.shape[-1] ** -0.5
    scores = torch.where(valid, scores, _NEG_INF)
    top = reduce_over(scores.amax(dim=-1, keepdim=True), "max", axes)
    p = torch.exp(scores - top)
    norm = reduce_over(p.sum(dim=-1, keepdim=True), "sum", axes)  # (B, H, S, 1)
    out = reduce_over(torch.einsum("bhst,bthd->bshd", p, v.float()), "sum", axes)
    out = out / norm.transpose(1, 2)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _attend_heads(q, k, v, valid):
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * q.shape[-1] ** -0.5
    if valid is not None:
        scores = torch.where(valid, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.reshape(out.shape[0], out.shape[1], -1)


def _causal(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int | None) -> torch.Tensor:
    """``(S, T)``: key t is visible to query s (not in its future, and
    fewer than ``window`` positions back with a window)."""
    delta = q_pos[:, None] - k_pos[None, :]
    return (delta >= 0) if window is None else (delta >= 0) & (delta < window)


def _dense_attention(q, k, v, window: int | None = None, causal: bool = True) -> torch.Tensor:
    pos = torch.arange(q.shape[1], device=q.device)
    return _attend(q, k, v, _causal(pos, pos, window) if causal else None)


def _chunked_attention(q, k, v, window: int | None = None, causal: bool = True) -> torch.Tensor:
    """Attention one ``Q_CHUNK`` of queries at a time against every key
    (causal, or every key with ``causal=False``): peak memory ``(B, H,
    Q_CHUNK, S)`` scores, the exact softmax per row."""
    s = q.shape[1]
    assert s % Q_CHUNK == 0, f"seq {s} not divisible by q-chunk {Q_CHUNK}"
    pos = torch.arange(s, device=q.device)
    return torch.cat([
        _attend(q[:, i:i + Q_CHUNK], k, v,
                _causal(pos[i:i + Q_CHUNK], pos, window) if causal else None)
        for i in range(0, s, Q_CHUNK)
    ], dim=1)


def attn_apply(
    lp: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
    cache: KVCache | None = None,
    window: int | None = None,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Self-attention of one layer.  ``lp`` holds the layer's
    ``attn/w{q,k,v,o}/{w,b}`` and, when it has adapters,
    ``lora/<target>/{A,B}``; ``x (C, B, S, d)``.  Returns ``(y, lora_h)``
    (see :func:`qkv`).  ``window`` limits each query to the keys fewer
    than ``window`` positions back; ``causal=False`` (full sequence only:
    an encoder layer) lets every query see every key, window or not, as the
    reference's mask does.

    With ``cache`` (decode, ``S == 1``) the new K/V is written IN PLACE into
    ring slot ``length % cache_len`` of the cache (``k``, ``v``, ``pos``;
    the caller advances ``length``), and the query attends over every slot
    written so far (and, with a window, at a position after ``length -
    window``)."""
    c, bsz, s, _ = x.shape
    q, k, v, lora_h = qkv(lp, x, cfg)
    if cache is None:  # full sequence: anchor the head axis (decode keeps the
        # sequence-sharded cache's layout instead, q replicated over "model")
        q = constrain(q, "batch", None, "heads", None)
        k = constrain(k, "batch", None, "kv", None)
        v = constrain(v, "batch", None, "kv", None)
    # absolute positions: 0..S-1, or the cached length in decode (a tensor:
    # no host sync)
    pos = torch.arange(s, device=x.device) if cache is None else cache.length.reshape(1)
    if cfg.positional == "rope":
        q = apply_rope(q, pos, theta=cfg.rope_theta)
        k = apply_rope(k, pos, theta=cfg.rope_theta)
    if cache is None:
        attend = _chunked_attention if s >= 2 * Q_CHUNK else _dense_attention
        out = attend(q, k, v, window, causal)
    else:
        assert s == 1, "decode mode expects one new token"
        # a one-element index tensor: the write needs no host sync
        slot = (cache.length % cache.k.shape[1]).reshape(1).long()
        index_copy_(cache.k, 1, slot, k.to(cache.k.dtype))
        index_copy_(cache.v, 1, slot, v.to(cache.v.dtype))
        index_copy_(cache.pos, 0, slot, cache.length.reshape(1))
        valid = (cache.pos >= 0) & (cache.pos <= cache.length)  # every written slot
        if window is not None:
            valid &= cache.pos > cache.length - window
        out = _attend_cache(q, cache.k, cache.v, valid[None, :])
    out = out.reshape(c, bsz, s, -1).to(x.dtype)
    y = linear(out, lp["attn/wo/w"], lp.get("attn/wo/b"), cd=torch_dtype(cfg.compute_dtype))
    return y, lora_h


def cross_attn_apply(lp: dict[str, torch.Tensor], x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross-attention of one layer: q from ``x (C, B, S,
    d)``, K and V from ``enc_out (C, B, T, d)``, grouped-query heads, no
    mask, no RoPE and no LoRA; ``lp`` holds the layer's
    ``cross/w{q,k,v,o}/{w,b}``.  K and V are recomputed on every call."""
    c, bsz, s, _ = x.shape
    cd = torch_dtype(cfg.compute_dtype)

    def proj(name, src):
        y = linear(src, lp[f"cross/w{name}/w"], lp.get(f"cross/w{name}/b"), cd=cd)
        return split_last(y, cfg.num_heads if name == "q" else cfg.num_kv_heads, c * bsz,
                          src.shape[2])

    out = _attend(proj("q", x), proj("k", enc_out), proj("v", enc_out), None)
    out = out.reshape(c, bsz, s, -1).to(x.dtype)
    return linear(out, lp["cross/wo/w"], lp.get("cross/wo/b"), cd=cd)
