"""Mixture-of-Experts MLP with top-k routing and capacity-factor dispatch —
the port of ``repro/models/moe.py``, on tensors with a leading CLIENT axis.

Tokens are routed in GROUPS of ``min(GROUP_SIZE, B·S)`` tokens (GShard's
group axis; see :func:`group_size` where that does not divide ``B·S``),
each client's tokens in groups of its own: the reference runs
one client's round under ``vmap``, so its capacity and its drops depend on
that client's tokens alone, and pooling the clients' tokens into shared
groups would change both.  The stacked serving step is the other case:
its client axis holds one request a row over one shared backbone, and the
reference routes the batch's tokens as one token set, so there the caller
asks for ``pool_clients=True`` (the shape alone cannot tell the two apart:
B federated clients may share one pretrained backbone too).  Routing: a softmax router in fp32, ``top_k``
experts per token (ties to the lower expert index, as ``lax.top_k``),
gates renormalised with ``+1e-9``; each (token, slot) takes a place in its
expert's queue by a slot-major cumulative sum, so every token's first
choice is served before any second choice, and a place at or past the
capacity ``int(max(4, round(cf·k·Tg/E)))`` (at most ``Tg``) is dropped.
Dispatch and combine are one-hot tensors ``(C, G, Tg, E, cap)``, as in the
reference, so the layer is one differentiable graph with no ragged
buffers.  The Switch load-balance loss ``E · Σ_e f_e · p_e`` (top-1
fractions times mean router probabilities) is returned per client.

Expert weights are ``mlp/{up,down,gate}`` of shape ``(E, i, o)`` in one
layer (no ``/w``), shared or per client ``(C, E, i, o)``; the router is the
dense ``mlp/router/w (d, E)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk import _stable_topk
from repro_torch.models.layers import InitStream, gelu, linear, torch_dtype, truncated_normal
from repro_torch.sharding import constrain, gather_fsdp, split_axes

__all__ = ["GROUP_SIZE", "group_size", "moe_capacity", "moe_init", "moe_apply"]

# tokens per dispatch group, as in the reference
GROUP_SIZE = 1024


def group_size(t: int) -> int:
    """Tokens per dispatch group for ``t`` tokens: ``min(GROUP_SIZE, t)`` as
    in the reference, or, where that does not divide ``t`` (the reference
    raises there), the largest divisor of ``t`` below ``GROUP_SIZE``."""
    return next(tg for tg in range(min(GROUP_SIZE, t), 0, -1) if t % tg == 0)


def moe_capacity(cfg: ModelConfig, tg: int) -> int:
    """Per-group, per-expert capacity: the reference's expression, Python's
    ``round`` (half to even) included."""
    moe = cfg.moe
    return min(int(max(4, round(moe.capacity_factor * moe.top_k * tg / moe.num_experts))), tg)


def moe_init(cfg: ModelConfig, num_layers: int, gen: InitStream) -> dict[str, torch.Tensor]:
    """The MoE MLP's leaves of a layer stack, keyed relative to the layer
    (``mlp/router/w (L, d, E)``, ``mlp/up (L, E, d, f)``, ...), fp32 on the
    CPU with the reference's fan-in truncated-normal scales."""
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    p = {
        "mlp/router/w": truncated_normal((num_layers, d, e), d**-0.5, gen),
        "mlp/up": truncated_normal((num_layers, e, d, f), d**-0.5, gen),
        "mlp/down": truncated_normal((num_layers, e, f, d), f**-0.5, gen),
    }
    if cfg.activation == "swiglu":
        p["mlp/gate"] = truncated_normal((num_layers, e, d, f), d**-0.5, gen)
    return p


def _experts(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``x (C, G, E, cap, i)`` through each expert's ``w``: shared ``(E, i,
    o)`` or per client ``(C, E, i, o)``."""
    eq = "ngepi,eio->ngepo" if w.ndim == 3 else "ngepi,neio->ngepo"
    return torch.einsum(eq, x, gather_fsdp(w).to(cd))


def moe_apply(lp: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
              pool_clients: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (C, B, S, d)`` -> ``(out (C, B, S, d), aux (C,) fp32)``: one
    layer's MoE MLP and each client's load-balance loss.  ``pool_clients``
    routes the ``C·B·S`` tokens as one token set (groups, capacities and
    drops over all of them; ``aux`` the pooled loss on every row), which
    needs a router and experts without a client axis."""
    moe = cfg.moe
    cd = torch_dtype(cfg.compute_dtype)
    shape = x.shape
    if pool_clients:
        if lp["mlp/up"].ndim != 3 or lp["mlp/router/w"].ndim != 2:
            raise ValueError("pooled routing needs one shared router and shared experts")
        x = x.reshape((1, -1) + tuple(shape[2:]))
    c, b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    t = b * s
    tg = group_size(t)
    g = t // tg
    # on a mesh a dispatch group's tokens are whole on a rank (capacity is
    # per group): the groups split over the batch axes the rows split over
    # where they divide the groups too, else every rank holds every group
    rows = split_axes("batch", b)
    grouped = bool(rows) and split_axes("batch", g) == rows
    if not grouped:
        x = constrain(x, None, None, None, None)
    tokens = constrain(x.reshape(c, g, tg, d).to(cd), None, "batch" if grouped else None, None,
                       None)

    # -- routing --
    router_logits = linear(tokens, lp["mlp/router/w"], cd=cd)  # (C, G, Tg, E)
    router_probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, expert_idx = _stable_topk(router_probs, k)  # (C, G, Tg, K)
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
    capacity = moe_capacity(cfg, tg)

    experts = torch.arange(e, device=x.device)
    # one-hot by comparison: F.one_hot checks its input's range on the host,
    # a device sync in every layer
    onehot = (expert_idx[..., None] == experts).float()  # (C, G, Tg, K, E)
    # each (token, slot)'s place in its expert's queue, slot-major
    flat = onehot.transpose(2, 3).reshape(c, g, k * tg, e)
    pos_flat = torch.cumsum(flat, dim=2) - flat
    position = pos_flat.reshape(c, g, k, tg, e).transpose(2, 3)
    position_in_expert = torch.sum(position * onehot, dim=-1)  # (C, G, Tg, K)
    keep = position_in_expert < capacity
    gates = gate_vals * keep.to(gate_vals.dtype)

    # one_hot of a place past the capacity is all zeros, as jax.nn.one_hot's
    cap_onehot = (position_in_expert[..., None]
                  == torch.arange(capacity, device=x.device, dtype=torch.float32)).float()
    dispatch = torch.einsum("ngtke,ngtkp->ngtep", onehot * keep[..., None], cap_onehot)
    combine = torch.einsum("ngtk,ngtke,ngtkp->ngtep", gates, onehot, cap_onehot)

    # -- the experts --
    expert_in = torch.einsum("ngtep,ngtd->ngepd", dispatch.to(cd), tokens)  # (C, G, E, cap, d)
    up = _experts(expert_in, lp["mlp/up"], cd)
    if "mlp/gate" in lp:
        hidden = F.silu(_experts(expert_in, lp["mlp/gate"], cd)) * up
    else:
        hidden = gelu(up)
    expert_out = _experts(hidden, lp["mlp/down"], cd)
    out = torch.einsum("ngtep,ngepd->ngtd", combine.to(cd), expert_out)

    # -- the Switch load-balance loss, per client --
    top1 = (expert_idx[..., 0, None] == experts).float()
    f_e = torch.mean(top1, dim=(1, 2))
    p_e = torch.mean(router_probs, dim=(1, 2))
    aux = e * torch.sum(f_e * p_e, dim=-1)
    return out.reshape(shape).to(x.dtype), aux.float().expand(shape[0])
