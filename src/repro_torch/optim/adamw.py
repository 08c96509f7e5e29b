"""AdamW over dicts of tensors with a leading CLIENT axis — the port of
``repro/optim/adamw.py`` (fp32 moments, bias correction, global-norm clip).

The reference vmaps one client's update over the cohort; here every leaf
carries the cohort axis ``(C, ...)`` and the step count is ``(C,)``.  The
global-norm clip is taken PER CLIENT, over that client's leaves only — a
norm over the whole stack would couple the clients' updates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]


class AdamWState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor  # (C,) int32


def adamw_init(params: dict[str, torch.Tensor], *, state_dtype: str = "float32") -> AdamWState:
    """Zero moments for ``(C, ...)`` leaves; ``state_dtype`` must be fp32."""
    if state_dtype != "float32":
        raise NotImplementedError(
            f"optimizer_state_dtype={state_dtype!r}: the port keeps fp32 moments "
            "only (ROADMAP.md port queue: bf16)"
        )
    first = next(iter(params.values()))
    return AdamWState(
        m={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        count=torch.zeros(first.shape[0], dtype=torch.int32, device=first.device),
    )


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-client L2 norm over all leaves: ``(C,)``."""
    sq = [torch.sum(torch.square(g.float()).reshape(g.shape[0], -1), dim=1) for g in grads.values()]
    return torch.sqrt(sum(sq))


def _per_client(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (like.ndim - 1))


@torch.no_grad()
def adamw_update(
    grads: dict[str, torch.Tensor],
    state: AdamWState,
    params: dict[str, torch.Tensor],
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float | None = 1.0,
) -> tuple[dict[str, torch.Tensor], AdamWState]:
    """Returns ``(new_params, new_state)``; inputs are left untouched."""
    count = state.count + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=cf.device), cf)
    if grad_clip is not None:
        scale = torch.clamp(grad_clip / (global_norm(grads) + 1e-9), max=1.0)
        grads = {k: g * _per_client(scale, g) for k, g in grads.items()}
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = state.m[k] * b1 + g * (1.0 - b1)
        v = state.v[k] * b2 + torch.square(g) * (1.0 - b2)
        step = (m / _per_client(bc1, m)) / (torch.sqrt(v / _per_client(bc2, v)) + eps)
        p32 = p.float()
        new_p[k] = (p32 - lr * (step + weight_decay * p32)).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(m=new_m, v=new_v, count=count)
