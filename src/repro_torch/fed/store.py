"""The device fleet store: where the fleet's per-client LoRA and optimizer
state live between rounds — the port of ``repro/fed/store.py``'s
``DeviceFleetStore``.

Every engine keeps the fleet's trainable state outside the Client objects,
stacked on a leading ``(num_clients, ...)`` axis on the device, and works
on the selected cohort per round:

* ``fetch(sel) -> (idx, lora, frozen, opt)`` — the cohort's rows, leading
  axis = cohort (fresh tensors, safe to update); ``sel`` may be the
  cohort's index tensor already on the device;
* ``commit(idx, lora, opt)`` — write the advanced cohort rows back;
* ``client_row(cid) -> (lora, frozen)`` — one client's trees, for
  evaluation;
* ``lora_rows(sel)`` — fresh rows of the given clients' adapters, leading
  axis = ``len(sel)``: the serving contract, the read an adapter cache
  issues on a slot miss (no optimizer state, no backbone).

The frozen backbone is one shared dict when every client rides the same
tensors (the paper's one pretrained W') and stacked per client otherwise.
The host store (out-of-core fleets) is a later slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.optim import AdamWState, adamw_init

__all__ = ["DeviceFleetStore"]


def _stack(trees: Sequence[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _rows(tree: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in tree.items()}


class DeviceFleetStore:
    """The whole fleet stacked on the device; fetch is one gather per leaf,
    commit one indexed write per leaf (in place)."""

    kind = "device"

    def __init__(self, loras: Sequence[dict], frozens: Sequence[dict], *, shared: bool,
                 state_dtype: str = "float32"):
        self.num_clients = len(loras)
        self.shared = bool(shared)
        self.lora = _stack(loras)
        self.frozen = frozens[0] if self.shared else _stack(frozens)
        self.opt = adamw_init(self.lora, state_dtype=state_dtype)

    @property
    def device(self) -> torch.device:
        return next(iter(self.lora.values())).device

    def fetch(self, sel: Sequence[int] | torch.Tensor):
        """The cohort's rows; ``sel`` is the client ids, or their int64
        index tensor already on the device (staged: no host copy)."""
        idx = sel if isinstance(sel, torch.Tensor) else torch.as_tensor(list(sel), device=self.device)
        opt = AdamWState(m=_rows(self.opt.m, idx), v=_rows(self.opt.v, idx),
                         count=self.opt.count[idx])
        frozen = self.frozen if self.shared else _rows(self.frozen, idx)
        return idx, _rows(self.lora, idx), frozen, opt

    def commit(self, idx: torch.Tensor, lora: dict, opt: AdamWState) -> None:
        for full, new in ((self.lora, lora), (self.opt.m, opt.m), (self.opt.v, opt.v)):
            for k in full:
                full[k][idx] = new[k]
        self.opt.count[idx] = opt.count

    def client_row(self, cid: int) -> tuple[dict, dict]:
        lora = {k: v[cid] for k, v in self.lora.items()}
        frozen = self.frozen if self.shared else {k: v[cid] for k, v in self.frozen.items()}
        return lora, frozen

    def lora_rows(self, sel: Sequence[int]) -> dict:
        idx = torch.as_tensor(list(sel), device=self.device)
        return _rows(self.lora, idx)
