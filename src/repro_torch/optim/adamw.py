"""AdamW over dicts of tensors with a leading CLIENT axis — the port of
``repro/optim/adamw.py`` (bias correction, global-norm clip).

The reference vmaps one client's update over the cohort; here every leaf
carries the cohort axis ``(C, ...)`` and the step count is ``(C,)``.  The
global-norm clip is taken PER CLIENT, over that client's leaves only — a
norm over the whole stack would couple the clients' updates.

The moments are stored in ``state_dtype`` (fp32 or bf16) and the update
math always runs in fp32.  ``master_dtype="float32"`` keeps an fp32 MASTER
copy of low-precision live params in the state: the update reads and
advances the master, and the live params are re-emitted as its cast, so
that small updates are not lost to bf16 rounding from step to step.
Without a master the update is the classic one on the live params.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]


class AdamWState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor  # (C,) int32
    # fp32 master params for low-precision live params; None: masterless
    master: dict[str, torch.Tensor] | None = None


def _dtype(name: str) -> torch.dtype:
    if name not in ("float32", "bfloat16", "float16"):
        raise ValueError(
            f"an optimizer dtype of {name!r}: expected float32, bfloat16 or float16"
        )
    return getattr(torch, name)


def adamw_init(params: dict[str, torch.Tensor], *, state_dtype: str = "float32",
               master_dtype: str | None = None) -> AdamWState:
    """Zero moments in ``state_dtype`` for ``(C, ...)`` leaves, and a master
    copy of the params in ``master_dtype`` unless it is None."""
    dt = _dtype(state_dtype)
    first = next(iter(params.values()))
    master = (None if master_dtype is None
              else {k: p.detach().to(_dtype(master_dtype), copy=True) for k, p in params.items()})
    return AdamWState(
        m={k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
        count=torch.zeros(first.shape[0], dtype=torch.int32, device=first.device),
        master=master,
    )


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-client L2 norm over all leaves: ``(C,)``."""
    return torch.sqrt(sum(_sum_of_squares(g) for g in grads.values()))


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """``Σ g²`` over every dim but the client axis of a ``(C, ...)`` leaf,
    in row-major order (a sharded gradient in place: no dim is flattened)."""
    return torch.sum(torch.square(g.float()).contiguous(), dim=tuple(range(1, g.ndim)))


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
    # the fp32 bias corrections 1 - b**count: the python scalar rides into
    # the kernel, where a host-made tensor would be a blocking copy
    bc1 = 1.0 - b1**cf
    bc2 = 1.0 - b2**cf
    if grad_clip is not None:
        scale = torch.clamp(grad_clip / (global_norm(grads) + 1e-9), max=1.0)
        grads = {k: g * _per_client(scale, g).to(g.dtype) for k, g in grads.items()}
    src = params if state.master is None else state.master
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = state.m[k].float() * b1 + g * (1.0 - b1)
        v = state.v[k].float() * b2 + torch.square(g) * (1.0 - b2)
        step = (m / _per_client(bc1, m)) / (torch.sqrt(v / _per_client(bc2, v)) + eps)
        p32 = src[k].float()
        new_p[k] = p32 - lr * (step + weight_decay * p32)
        new_m[k], new_v[k] = m.to(state.m[k].dtype), v.to(state.v[k].dtype)
    master = None if state.master is None else {
        k: new_p[k].to(state.master[k].dtype) for k in params}
    return ({k: new_p[k].to(p.dtype) for k, p in params.items()},
            AdamWState(m=new_m, v=new_v, count=count, master=master))
