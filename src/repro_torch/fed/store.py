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
  issues on a slot miss (no optimizer state, no backbone);
* ``state_dict()``/``load_state_dict(state)`` — the whole fleet as one
  checkpointable tree ``{"lora", "opt", "frozen"}``, and
  ``save_shards(dir)``/``load_shards(dir)`` — the same state as
  per-client-range npz shards (``repro_torch.checkpoint``, the reference's
  layout); a load always takes copies the store owns.

The frozen backbone is one shared dict when every client rides the same
tensors (the paper's one pretrained W') and stacked per client otherwise.
The host store (out-of-core fleets) is a later slice.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

from repro_torch.checkpoint import ckpt as ckpt_io
from repro_torch.optim import AdamWState, adamw_init

__all__ = ["DeviceFleetStore", "owned_copy"]


def _stack(trees: Sequence[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _rows(tree: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in tree.items()}


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a flat dict or an AdamWState (None stays
    None), and of ``rest``, trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, AdamWState):
        return AdamWState(*(_map(fn, *fields) for fields in zip(tree, *rest)))
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def owned_copy(t, device) -> torch.Tensor:
    """``t`` on ``device`` in storage of its own: a tensor already there
    is cloned, anything else is copied once on the way."""
    out = torch.as_tensor(t, device=device)
    if isinstance(t, torch.Tensor) and out.data_ptr() == t.data_ptr():
        out = out.clone()
    return out


def _check_shard_cover(shards, num_clients: int, dir_path: str) -> None:
    expect = 0
    for lo, hi in sorted((lo, hi) for lo, hi, _ in shards):
        if lo != expect:
            raise ValueError(f"fleet shards in {dir_path} do not cover clients [{expect}, {lo}) — "
                             "checkpoint is incomplete")
        expect = hi
    if expect != num_clients:
        raise ValueError(f"fleet shards in {dir_path} cover {expect} clients, store holds "
                         f"{num_clients}")


class DeviceFleetStore:
    """The whole fleet stacked on the device; fetch is one gather per leaf,
    commit one indexed write per leaf (in place)."""

    kind = "device"
    shard_size = 1024  # clients a persisted shard holds at most

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

    # -- checkpoints ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {"lora": self.lora, "opt": self.opt, "frozen": self.frozen}

    def load_state_dict(self, state: dict) -> None:
        """Take the state as copies the store owns, on the store's device
        (the round writes the fleet in place)."""
        own = lambda t: owned_copy(t, self.device)  # noqa: E731
        self.lora = _map(own, state["lora"])
        self.opt = _map(own, state["opt"])
        self.frozen = _map(own, state["frozen"])

    def save_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        """The fleet as per-client-range npz shards (each written
        atomically), and the shared backbone as ``{prefix}_frozen.npz``."""
        os.makedirs(dir_path, exist_ok=True)
        for lo in range(0, self.num_clients, self.shard_size):
            hi = min(lo + self.shard_size, self.num_clients)
            rows = {"lora": self.lora, "opt": self.opt}
            if not self.shared:
                rows["frozen"] = self.frozen
            ckpt_io.save(os.path.join(dir_path, ckpt_io.fleet_shard_name(prefix, lo, hi)),
                         {k: _map(lambda t: t[lo:hi], v) for k, v in rows.items()})
        if self.shared:
            ckpt_io.save(os.path.join(dir_path, f"{prefix}_frozen.npz"), {"frozen": self.frozen})

    def load_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        shards = ckpt_io.list_fleet_shards(dir_path, prefix)
        _check_shard_cover(shards, self.num_clients, dir_path)
        stacks = {"lora": self.lora, "opt": self.opt}
        if not self.shared:
            stacks["frozen"] = self.frozen
        # restored on the host: load_state_dict's copy to the device is the one
        parts = [ckpt_io.restore(path, ckpt_io.host_skeleton(
                     {k: _map(lambda t: t[: hi - lo], v) for k, v in stacks.items()}))
                 for lo, hi, path in shards]
        state = {k: _map(lambda *xs: torch.cat(xs), *(p[k] for p in parts)) for k in stacks}
        if self.shared:
            like = ckpt_io.host_skeleton({"frozen": self.frozen})
            state["frozen"] = ckpt_io.restore(os.path.join(dir_path, f"{prefix}_frozen.npz"),
                                              like)["frozen"]
        self.load_state_dict(state)
