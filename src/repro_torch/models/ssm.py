"""The Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060] — the
port of ``repro/models/ssm.py``, on tensors with a leading CLIENT axis.

The block: separate projections to ``z``, ``x``, ``(B, C)`` and ``dt``; a
causal depthwise conv of width ``conv_width`` over ``x`` and over
``(B, C)``, in fp32 with SiLU; ``dt = softplus(dt_raw + dt_bias)``; the SSD
core over ``d_inner / P`` heads of size ``P`` with state ``N``; the skip
``D·x``; ``y · silu(z)`` gated in fp32, an RMSNorm in the compute dtype and
``out_proj``.

Full-sequence mode runs the *chunked SSD* (the paper's "ssd_minimal"):
dense ``(Q, Q)`` masked products inside each chunk, the chunk states, the
recurrence over the chunk states and their contribution to the output.
The reference writes its four-operand contractions as ``jnp.einsum``; here
each is a chain of pairwise products in a fixed order (``C·Bᵀ``, times the
decay ``L``, then a batched matmul with ``x``), so no ``(B, H, nc, Q, Q,
P)`` intermediate exists and the order is the same on every device.
Decode is the dual recurrent form, one token at a time::

    state <- state · exp(dt·A) + dt · (B ⊗ x);   y = C · state + D·x

and writes the conv histories and the fp32 state into the cache IN PLACE,
with no host sync.

``x·dt`` and the whole SSD run in fp32 (the conv returns fp32) whatever
the compute dtype; the decode state is fp32, the conv histories are kept
in the cache's dtype (the compute dtype).  ``F.softplus`` takes its linear
branch above 20, where ``jax.nn.softplus`` is ``logaddexp(x, 0)``: the two
differ by less than 3e-9 there.

Parameters are keyed relative to the layer, ``ssm/w_z/w``,
``ssm/conv_x_w``, ``ssm/gate_norm/scale``, ...; each is shared (its base
shape) or per client (a leading ``(C, ...)`` axis).  On the full sequence
``xh`` and ``dt`` are anchored head-sharded (:func:`repro_torch.sharding.
constrain`, the identity without rules), as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    InitStream, linear, normal, per_client, rms_norm, torch_dtype, truncated_normal,
)
from repro_torch.sharding import constrain, local_apply, split_last

__all__ = ["SSMCache", "ssm_dims", "init_ssm_cache", "ssm_init", "segsum", "ssd_chunked",
           "causal_conv", "ssm_apply"]


class SSMCache(NamedTuple):
    """One SSM layer's decode cache (stacked over a position's repeats in
    the model's cache: a leading ``(R, ...)`` axis on every field)."""

    conv_x: torch.Tensor  # (B, W-1, d_inner) pre-conv x history
    conv_bc: torch.Tensor  # (B, W-1, 2N) pre-conv B/C history
    state: torch.Tensor  # (B, H, P, N) fp32 recurrent state


def ssm_dims(cfg: ModelConfig) -> tuple[int, int]:
    """``(d_inner, heads)`` of the config's SSM mixer."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


def init_ssm_cache(cfg: ModelConfig, batch: int, device: str | torch.device = "cuda",
                   dtype: str | None = None) -> SSMCache:
    """An empty cache: the histories in ``dtype`` (the compute dtype by
    default), the state in fp32."""
    ssm = cfg.ssm
    d_inner, heads = ssm_dims(cfg)
    dt = torch_dtype(dtype or cfg.compute_dtype)
    w = ssm.conv_width - 1
    return SSMCache(
        conv_x=torch.zeros((batch, w, d_inner), dtype=dt, device=device),
        conv_bc=torch.zeros((batch, w, 2 * ssm.state_dim), dtype=dt, device=device),
        state=torch.zeros((batch, heads, ssm.head_dim, ssm.state_dim), dtype=torch.float32,
                          device=device),
    )


def ssm_init(cfg: ModelConfig, repeats: int, gen: InitStream) -> dict[str, torch.Tensor]:
    """The SSM mixer's leaves of ``repeats`` stacked layers, keyed relative
    to the layer (``ssm/w_z/w (R, d, d_inner)``, ...), fp32 on the CPU with
    the reference's shapes and scales: fan-in truncated-normal projections,
    ``N(0, 0.1²)`` conv weights, zero conv biases, ``dt_bias`` the inverse
    softplus of a log-uniform draw in ``[dt_min, dt_max]``, ``a_log`` =
    ``log U[1, 16]``, ``d_skip`` ones and the gate norm's scale ones."""
    ssm = cfg.ssm
    d, (d_inner, heads), n2, r = cfg.d_model, ssm_dims(cfg), 2 * ssm.state_dim, repeats
    p: dict[str, torch.Tensor] = {}
    for name, (i, o) in {"w_z": (d, d_inner), "w_x": (d, d_inner), "w_bc": (d, n2),
                         "w_dt": (d, heads), "out_proj": (d_inner, d)}.items():
        p[f"ssm/{name}/w"] = truncated_normal((r, i, o), i**-0.5, gen)
        if cfg.use_bias:
            p[f"ssm/{name}/b"] = torch.zeros(r, o)
    p["ssm/conv_x_w"] = normal((r, ssm.conv_width, d_inner), 0.1, gen)
    p["ssm/conv_x_b"] = torch.zeros(r, d_inner)
    p["ssm/conv_bc_w"] = normal((r, ssm.conv_width, n2), 0.1, gen)
    p["ssm/conv_bc_b"] = torch.zeros(r, n2)
    lo, hi = math.log(ssm.dt_min), math.log(ssm.dt_max)
    u = torch.exp(gen.uniform((r, heads), 0.0, 1.0) * (hi - lo) + lo)
    p["ssm/dt_bias"] = u + torch.log(-torch.expm1(-u))  # inverse softplus
    p["ssm/a_log"] = torch.log(gen.uniform((r, heads), 1.0, 16.0))
    p["ssm/d_skip"] = torch.ones(r, heads)
    p["ssm/gate_norm/scale"] = torch.ones(r, d_inner)
    return p


def segsum(a: torch.Tensor) -> torch.Tensor:
    """``a (..., Q)`` -> ``(..., Q, Q)``: ``out[..., i, j] = Σ_{j<m<=i}
    a[m]`` as a difference of cumulative sums, ``-inf`` above the
    diagonal (so ``exp`` gives exactly 0 there)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(q, device=a.device)
    return torch.where(i[:, None] >= i[None, :], diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                chunk: int, init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan.  ``x (B, S, H, P)`` (already times dt), ``a
    (B, S, H)`` (dt·A, the per-step log-decay), ``b_mat``/``c_mat (B, S,
    N)``, ``init_state (B, H, P, N)`` or None (zeros).  Returns ``(y (B, S,
    H, P), final_state (B, H, P, N))``."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)  # (B, nc, H, Q, P)
    ac = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)  # (B, H, nc, Q)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)
    a_cumsum = torch.cumsum(ac, dim=-1)  # (B, H, nc, Q)

    # 1) inside each chunk: (C·Bᵀ) ∘ L, then times x
    l_mat = torch.exp(segsum(ac)).permute(0, 2, 1, 3, 4)  # (B, nc, H, Q, Q)
    scores = torch.matmul(cc, bc.transpose(-1, -2))  # (B, nc, Q, Q)
    y_diag = torch.matmul(scores[:, :, None] * l_mat, xc)  # (B, nc, H, Q, P)

    # 2) each chunk's final state: (x · decay)ᵀ · B
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum).permute(0, 2, 1, 3)  # (B,nc,H,Q)
    states = torch.matmul((xc * decay_states[..., None]).transpose(-1, -2),
                          bc[:, :, None])  # (B, nc, H, P, N)

    # 3) the recurrence over the chunk states
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=states.dtype, device=states.device)
    states = torch.cat([init_state[:, None], states], dim=1)  # (B, nc+1, H, P, N)
    chunk_decay = F.pad(a_cumsum[..., -1], (1, 0))  # (B, H, nc+1)
    decay_chunk = torch.exp(segsum(chunk_decay))  # (B, H, nc+1, nc+1)
    flat = states.permute(0, 2, 1, 3, 4).reshape(bsz, h, nc + 1, p * n)
    new_states = torch.matmul(decay_chunk, flat).reshape(bsz, h, nc + 1, p, n)
    prev_states = new_states[:, :, :-1].permute(0, 2, 1, 3, 4)  # (B, nc, H, P, N)
    final_state = new_states[:, :, -1]

    # 4) the chunk states' contribution to the output: (C · stateᵀ) · decay
    state_decay_out = torch.exp(a_cumsum).permute(0, 2, 1, 3)  # (B, nc, H, Q)
    y_off = torch.matmul(cc[:, :, None], prev_states.transpose(-1, -2)) \
        * state_decay_out[..., None]  # (B, nc, H, Q, P)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y, final_state


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                history: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv over the sequence, in fp32, with SiLU:
    ``x (C, B, S, ch)``, ``w`` ``(W, ch)`` or ``(C, W, ch)``, ``b`` ``(ch,)``
    or ``(C, ch)``, ``history (C, B, W-1, ch)`` or None (zeros).  Returns
    ``(silu(out) (C, B, S, ch) fp32, the last W-1 inputs (C, B, W-1, ch)
    fp32)``."""
    w32, x32 = w.float(), x.float()
    width, s = w32.shape[-2], x.shape[2]
    pad = (x32.new_zeros(x32.shape[:2] + (width - 1, x32.shape[-1])) if history is None
           else history.float())
    xp = torch.cat([pad, x32], dim=2)  # (C, B, S+W-1, ch)
    out = xp[:, :, 0:s] * per_client(w32[..., 0, :], x32)
    for i in range(1, width):
        out = out + xp[:, :, i:i + s] * per_client(w32[..., i, :], x32)
    out = out + per_client(b.float(), x32)
    return F.silu(out), xp[:, :, xp.shape[2] - (width - 1):]


def ssm_apply(lp: dict[str, torch.Tensor], x_in: torch.Tensor, cfg: ModelConfig, *,
              cache: SSMCache | None = None) -> torch.Tensor:
    """One Mamba2 block over ``x_in (C, B, S, d)`` -> ``(C, B, S, d)`` in
    ``x_in``'s dtype.  ``lp`` holds the layer's ``ssm/...`` leaves.  With
    ``cache`` (decode, ``S == 1``; the cache's batch is ``C·B``) the conv
    reads the cached histories and the state takes one recurrent step; the
    new histories and state are written into the cache IN PLACE."""
    ssm = cfg.ssm
    d_inner, heads = ssm_dims(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    n, p = ssm.state_dim, ssm.head_dim
    c, bsz, s, _ = x_in.shape

    def proj(name):
        return linear(x_in, lp[f"ssm/{name}/w"], lp.get(f"ssm/{name}/b"), cd=cd)

    z, x_pre, bc_pre, dt_raw = proj("w_z"), proj("w_x"), proj("w_bc"), proj("w_dt")
    dt = F.softplus(dt_raw.float() + per_client(lp["ssm/dt_bias"].float(), dt_raw))  # (C,B,S,H)

    hist = (None, None) if cache is None else (
        cache.conv_x.view(c, bsz, -1, d_inner), cache.conv_bc.view(c, bsz, -1, 2 * n))
    xs, new_x = causal_conv(x_pre, lp["ssm/conv_x_w"], lp["ssm/conv_x_b"], hist[0])
    bc, new_bc = causal_conv(bc_pre, lp["ssm/conv_bc_w"], lp["ssm/conv_bc_b"], hist[1])
    xh = split_last(xs, heads, c, bsz, s)
    if cache is None:  # head-sharded, so the SSD's (B, H, nc, Q, Q) decays shard by head
        xh = constrain(xh, None, "batch", None, "heads", None)
        dt = constrain(dt, None, "batch", None, "heads")
    a_dt = dt * per_client(-torch.exp(lp["ssm/a_log"].float()), dt)  # dt·A, A negative
    x_dt = (xh * dt[..., None]).reshape(c * bsz, s, heads, p)
    b_mat = bc[..., :n].reshape(c * bsz, s, n)
    c_mat = bc[..., n:].reshape(c * bsz, s, n)
    if cache is None:
        # independent per (batch row, head): on a mesh each rank runs its block
        chunk = min(ssm.chunk_size, s)
        y = local_apply(lambda x_, a_, b_, c_: ssd_chunked(x_, a_, b_, c_, chunk)[0],
                        (x_dt, a_dt.reshape(c * bsz, s, heads), b_mat, c_mat),
                        (("batch", None, "heads", None), ("batch", None, "heads"),
                         ("batch", None, None), ("batch", None, None)),
                        ("batch", None, "heads", None), {"batch": c * bsz, "heads": heads})
    else:
        assert s == 1, "decode mode expects one new token"
        da = torch.exp(a_dt.reshape(c * bsz, heads))
        state = cache.state * da[..., None, None] + x_dt[:, 0, :, :, None] * b_mat[:, :, None]
        y = torch.matmul(state, c_mat[:, 0, None, :, None])[..., 0][:, None]  # (CB, 1, H, P)
        cache.conv_x.copy_(new_x.reshape(cache.conv_x.shape))
        cache.conv_bc.copy_(new_bc.reshape(cache.conv_bc.shape))
        cache.state.copy_(state)
    y = y.reshape(c, bsz, s, heads, p) + per_client(lp["ssm/d_skip"].float(), dt)[..., None] * xh
    # the inner width whole or model-sharded as z is, so the gradient the
    # head split gets back is placed as its forward was (the identity
    # without rules)
    y = constrain(y.reshape(c, bsz, s, d_inner), None, "batch", None, "dff") * F.silu(z.float())
    y = rms_norm(y.to(cd), lp["ssm/gate_norm/scale"])
    out = linear(y, lp["ssm/out_proj/w"], lp.get("ssm/out_proj/b"), cd=cd)
    return out.to(x_in.dtype)
