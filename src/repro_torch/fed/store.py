"""Fleet stores: where the fleet's per-client LoRA and optimizer state live
between rounds — the port of ``repro/fed/store.py``.

Every cohort engine keeps the fleet's trainable state outside the Client
objects and works on the selected cohort per round, through a store's
contract:

* ``fetch(sel) -> (idx, lora, frozen, opt)`` — the cohort's rows on the
  device, leading axis = cohort (fresh tensors, safe to update);
* ``commit(idx, lora, opt)`` — write the advanced cohort rows back;
* ``prefetch(sel)`` — a hint: the NEXT round's cohort, which a host store
  starts staging while the current round computes (a no-op by default);
* ``client_row(cid) -> (lora, frozen)`` — one client's trees, for
  evaluation;
* ``lora_rows(sel)`` — fresh rows of the given clients' adapters, leading
  axis = ``len(sel)``: the serving contract, the read an adapter cache
  issues on a slot miss (no optimizer state, no backbone);
* ``state_dict()``/``load_state_dict(state)`` — the whole fleet as one
  checkpointable tree ``{"lora", "opt", "frozen"}``, the same layout under
  either store, and ``save_shards(dir)``/``load_shards(dir)`` — the same
  state as per-client-range npz shards (``repro_torch.checkpoint``, the
  reference's layout); a load always takes copies the store owns.

The frozen backbone is one shared dict when every client rides the same
tensors (the paper's one pretrained W') and stacked per client otherwise.

Two stores:

* :class:`DeviceFleetStore` — the whole fleet stacked on the device;
  O(N) device memory; the only store a multi-round block accepts.
* :class:`HostFleetStore` — the fleet in host memory (optionally paged to
  npz shards on disk), only the cohort on the device: device memory is
  O(cohort), whatever N is.  A double-buffered prefetch stages round r+1's
  cohort while round r computes, and a dirty-row patch keeps the result
  bit-identical with prefetch on or off, overlapping cohorts included.

How the host store meets the card:

* *Pinned staging, not pinned fleets.*  A GPT-2 small client row (LoRA r 8
  on q/v, 294 912 fp32 values, with Adam's m and v) is ~3.5 MB, so a
  10 000-client fleet is ~35 GB of host memory; pinning it would defeat
  :meth:`HostFleetStore.from_template`'s lazy rows and could exhaust
  pinned memory.  The fleet stays in pageable memory; a cohort is gathered
  with ``torch.index_select(..., out=)`` into one of two pinned staging
  slots per cohort shape (``cudaHostAlloc`` is slow: allocated once), then
  copied to the device with ``non_blocking=True`` on a side
  ``torch.cuda.Stream``.  (A copy from pageable memory is synchronous and
  overlaps nothing.)
* *Stream hazards.*  ``fetch`` makes the consuming stream wait on the
  copy's event, and the staged tensors, allocated on the side stream,
  ``record_stream`` the consumer, so that the caching allocator does not
  hand their memory out again while the round reads it.  A staging slot is
  refilled only after its last copy's event has completed.  The current
  stream is thread-local: the staging thread sets its own device and
  stream.
* *Commit.*  The cohort's rows are copied device-to-host into pinned
  memory on the current stream, after the round's last write, and the
  host waits for that copy before it writes the host rows and marks the
  ids dirty: the dirty-row patch is only right if ``commit`` has finished
  when it returns.
* *Lazy rows.*  ``torch.zeros`` on the CPU writes every page; a lazy
  fleet's stacks are ``np.zeros`` (calloc: untouched rows cost address
  space only) seen through ``torch.from_numpy``, a bf16 leaf as an
  ``np.uint16`` buffer viewed as bf16 (numpy has no bf16).
* *Owned copies.*  ``fetch`` returns storage of its own: on the CPU a
  gather is a fresh tensor, never a view of the host stack.
* *A failed staging thread* re-raises its exception at the ``fetch`` of
  its cohort, where the reference falls back to a cold fetch: on the card
  that would hide a broken staging path.  A hint for another cohort (a
  miss) still cold-fetches, as in the reference.
* On the CPU there is no side stream: the thread and the dirty-row logic
  run as on the card, the streams, events and pinned slots do not.
"""

from __future__ import annotations

import os
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_io
from repro_torch.optim import AdamWState, adamw_init

__all__ = [
    "FleetStore",
    "DeviceFleetStore",
    "HostFleetStore",
    "make_fleet_store",
    "owned_copy",
]

_NO_STACK = (
    "HostFleetStore keeps the fleet out of device memory: the full stacked "
    "device tree does not exist.  The scan-carry multi-round drivers "
    "(scan_rounds / run_rounds) donate the stacked fleet into one compiled "
    "scan and therefore require fleet_store='device'; the host store runs "
    "the per-round driver instead."
)

_ROWS = ("lora", "opt")  # what a commit writes; a per-client backbone is read only


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


def _map_keys(fn, trees: dict, *rest) -> dict:
    """:func:`_map` over each tree of ``{"lora": ..., "opt": ..., ...}``."""
    return {k: _map(fn, t, *(r[k] for r in rest)) for k, t in trees.items()}


def _leaves(trees: dict) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map_keys(out.append, trees)
    return out


def _nbytes(tree) -> int:
    out: list[int] = []
    _map(lambda t: out.append(t.numel() * t.element_size()), tree)
    return sum(out)


def owned_copy(t, device) -> torch.Tensor:
    """``t`` on ``device`` in storage of its own: a tensor already there
    is cloned, anything else is copied once on the way (an ndarray that
    ``torch.as_tensor`` would alias on the CPU included)."""
    out = torch.as_tensor(t, device=device)
    aliased = (out.data_ptr() == t.data_ptr() if isinstance(t, torch.Tensor)
               else isinstance(t, np.ndarray) and out.device.type == "cpu")
    return out.clone() if aliased else out


def _lazy_zeros(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """Zeros whose pages are not touched until written (calloc-backed)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.zeros(shape, np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.zeros(shape, torch.empty((), dtype=dtype).numpy().dtype))


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


class FleetStore:
    """The fleet-state owner's contract (see the module docstring).
    ``shard_size`` bounds the clients one persisted shard holds; any store
    reads shards written at any shard size (the names carry the ranges)."""

    kind: str
    num_clients: int
    shared: bool
    shard_size: int = 1024

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    # -- the round loop's contract -------------------------------------------
    def fetch(self, sel):
        raise NotImplementedError

    def commit(self, idx, lora: dict, opt: AdamWState) -> None:
        raise NotImplementedError

    def prefetch(self, sel: Sequence[int]) -> None:
        """Hint: the NEXT round's cohort.  Default: nothing to stage."""

    def client_row(self, cid: int) -> tuple[dict, dict]:
        raise NotImplementedError

    # -- the serving contract ------------------------------------------------
    def lora_rows(self, sel: Sequence[int]) -> dict:
        raise NotImplementedError

    # -- checkpoints -----------------------------------------------------------
    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, state: dict) -> None:
        raise NotImplementedError

    def _rows_host(self, lo: int, hi: int) -> dict:
        """Clients [lo, hi) as ``{"lora", "opt"}`` (+ ``"frozen"`` rows for
        per-client backbones), for a shard."""
        raise NotImplementedError

    def _frozen_shared_tree(self) -> dict:
        raise NotImplementedError

    def save_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        """The fleet as per-client-range npz shards (each written
        atomically), and the shared backbone as ``{prefix}_frozen.npz``."""
        os.makedirs(dir_path, exist_ok=True)
        for lo in range(0, self.num_clients, self.shard_size):
            hi = min(lo + self.shard_size, self.num_clients)
            ckpt_io.save(os.path.join(dir_path, ckpt_io.fleet_shard_name(prefix, lo, hi)),
                         self._rows_host(lo, hi))
        if self.shared:
            ckpt_io.save(os.path.join(dir_path, f"{prefix}_frozen.npz"),
                         {"frozen": self._frozen_shared_tree()})

    def load_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        raise NotImplementedError

    def device_bytes(self) -> int:
        """Device bytes the store holds BETWEEN rounds: O(N) for the device
        store, the shared backbone only (O(1) in N) for the host store."""
        raise NotImplementedError


class DeviceFleetStore(FleetStore):
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

    def state_dict(self) -> dict:
        return {"lora": self.lora, "opt": self.opt, "frozen": self.frozen}

    def load_state_dict(self, state: dict) -> None:
        """Take the state as copies the store owns, on the store's device
        (the round writes the fleet in place)."""
        own = lambda t: owned_copy(t, self.device)  # noqa: E731
        self.lora = _map(own, state["lora"])
        self.opt = _map(own, state["opt"])
        self.frozen = _map(own, state["frozen"])

    def _rows_host(self, lo: int, hi: int) -> dict:
        rows = {"lora": self.lora, "opt": self.opt}
        if not self.shared:
            rows["frozen"] = self.frozen
        return _map_keys(lambda t: t[lo:hi], rows)

    def _frozen_shared_tree(self) -> dict:
        return self.frozen

    def load_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        shards = ckpt_io.list_fleet_shards(dir_path, prefix)
        _check_shard_cover(shards, self.num_clients, dir_path)
        stacks = {"lora": self.lora, "opt": self.opt}
        if not self.shared:
            stacks["frozen"] = self.frozen
        # restored on the host: load_state_dict's copy to the device is the one
        parts = [ckpt_io.restore(path, ckpt_io.host_skeleton(
                     _map_keys(lambda t: t[: hi - lo], stacks)))
                 for lo, hi, path in shards]
        state = {k: _map(lambda *xs: torch.cat(xs), *(p[k] for p in parts)) for k in stacks}
        if self.shared:
            like = ckpt_io.host_skeleton({"frozen": self.frozen})
            state["frozen"] = ckpt_io.restore(os.path.join(dir_path, f"{prefix}_frozen.npz"),
                                              like)["frozen"]
        self.load_state_dict(state)

    def device_bytes(self) -> int:
        return sum(_nbytes(t) for t in (self.lora, self.opt, self.frozen))


class HostFleetStore(FleetStore):
    """The fleet in host memory (optionally paged to npz shards), only the
    cohort on the device: device memory is O(cohort) whatever N is.

    Prefetch protocol: :meth:`prefetch` snapshots the requested cohort and
    stages its device copy on a worker thread while the round computes;
    every :meth:`commit` after the snapshot marks its rows dirty, and a
    :meth:`fetch` of that cohort patches the dirty positions from the (by
    then committed) host rows, so a prefetched fetch returns exactly what
    an unprefetched one would, overlapping cohorts included.  Up to two
    staged cohorts are held (the round loop hints round r+1 BEFORE it
    fetches round r's staged rows), each with its own dirty set; older
    entries are evicted first in, first out.

    ``spill_dir`` pages the host stacks to per-range npz shards in that
    directory behind a cache of 4 shards (written back on eviction), so
    host memory is O(cohort · shard_size) too.

    :meth:`from_template` builds an N-client store from ONE template row
    (every client reads the template until its first commit) in O(1) time
    and O(committed rows) resident memory."""

    kind = "host"

    def __init__(self, loras: Sequence[dict], frozens: Sequence[dict], *, shared: bool,
                 state_dtype: str = "float32", prefetch: bool = True,
                 spill_dir: str | None = None, shard_size: int = 1024):
        lora = {k: torch.stack([t[k].detach().cpu() for t in loras]) for k in loras[0]}
        host = {"lora": lora, "opt": adamw_init(lora, state_dtype=state_dtype)}
        if not shared:
            host["frozen"] = {k: torch.stack([t[k].detach().cpu() for t in frozens])
                              for k in frozens[0]}
        self._init_common(
            num_clients=len(loras), shared=shared, prefetch=prefetch, spill_dir=spill_dir,
            shard_size=shard_size, host=host, frozen_shared=frozens[0] if shared else None,
            template=None, device=next(iter(loras[0].values())).device,
        )

    @classmethod
    def from_template(cls, lora_row: dict, frozen: dict, *, num_clients: int,
                      state_dtype: str = "float32", prefetch: bool = True,
                      spill_dir: str | None = None, shard_size: int = 1024) -> "HostFleetStore":
        """An N-client fleet on ``frozen``'s device that shares ``frozen``
        and starts every client at ``lora_row`` with fresh Adam state in
        ``state_dtype``."""
        self = cls.__new__(cls)
        lora = {k: owned_copy(v.detach(), "cpu") for k, v in lora_row.items()}
        opt = adamw_init({k: v[None] for k, v in lora.items()}, state_dtype=state_dtype)
        template = {"lora": lora, "opt": _map(lambda t: t[0], opt)}
        host = _map_keys(lambda r: _lazy_zeros((int(num_clients),) + tuple(r.shape), r.dtype),
                         template)
        self._init_common(
            num_clients=num_clients, shared=True, prefetch=prefetch, spill_dir=spill_dir,
            shard_size=shard_size, host=host, frozen_shared=frozen, template=template,
            device=next(iter(frozen.values())).device,
        )
        return self

    def _init_common(self, *, num_clients, shared, prefetch, spill_dir, shard_size, host,
                     frozen_shared, template, device) -> None:
        self.num_clients = int(num_clients)
        self.shared = bool(shared)
        self.shard_size = int(shard_size)
        self.prefetch_enabled = bool(prefetch)
        self._device = torch.device(device)
        if self._device.type == "cuda" and self._device.index is None:
            # an index of its own: the staging thread sets it as its device
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._frozen_shared = frozen_shared  # a tree on the device, or None
        self._template = template
        self._initialized = np.zeros(self.num_clients, bool) if template is not None else None
        self._lock = threading.Lock()
        # the double buffer: cohort tuple -> [thread, result box, dirty ids]
        self._pf: dict[tuple, list] = {}
        # the card's staging: a side stream, two pinned slots a shape, and
        # the pinned rows a commit copies back through
        self._side: torch.cuda.Stream | None = None
        self._slots: dict[tuple, list] = {}
        self._turn: dict[tuple, int] = {}
        self._commit_bufs: dict[int, dict] = {}
        # row skeletons (shape, dtype) of every stacked tree
        self._row_like = _map_keys(lambda a: torch.empty(tuple(a.shape[1:]), dtype=a.dtype,
                                                         device="meta"), host)
        self._spill_dir = spill_dir
        self._cache: dict[int, dict] | None = None
        if spill_dir is None:
            self._host = host
        else:  # page the stacks out now; keep only the row skeletons
            self._host = None
            self._cache, self._cache_cap = {}, 4
            os.makedirs(spill_dir, exist_ok=True)
            self._spill_all(host)

    @property
    def device(self) -> torch.device:
        return self._device

    # -- the stacked device trees do not exist here ------------------------------
    @property
    def lora(self):
        raise RuntimeError(_NO_STACK)

    @property
    def opt(self):
        raise RuntimeError(_NO_STACK)

    @property
    def frozen(self):
        if self.shared:
            return self._frozen_shared
        raise RuntimeError(_NO_STACK)

    # -- spill paging (callers hold self._lock) ----------------------------------
    def _shard_path(self, si: int) -> str:
        lo = si * self.shard_size
        hi = min(lo + self.shard_size, self.num_clients)
        return os.path.join(self._spill_dir, ckpt_io.fleet_shard_name("spill", lo, hi))

    def _spill_all(self, host: dict) -> None:
        for lo in range(0, self.num_clients, self.shard_size):
            hi = min(lo + self.shard_size, self.num_clients)
            ckpt_io.save(self._shard_path(lo // self.shard_size),
                         _map_keys(lambda a: a[lo:hi], host))

    def _shard_tree(self, si: int) -> dict:
        tree = self._cache.get(si)
        if tree is not None:
            return tree
        lo = si * self.shard_size
        n = min(lo + self.shard_size, self.num_clients) - lo
        skeleton = _map_keys(lambda r: torch.empty((n,) + tuple(r.shape), dtype=r.dtype),
                             self._row_like)
        path = self._shard_path(si)
        tree = (ckpt_io.restore(path, skeleton) if os.path.exists(path)
                else _map_keys(lambda t: t.zero_(), skeleton))
        if len(self._cache) >= self._cache_cap:
            evict = next(iter(self._cache))
            ckpt_io.save(self._shard_path(evict), self._cache.pop(evict))
        self._cache[si] = tree
        return tree

    # -- host rows (callers hold self._lock) ---------------------------------------
    def _row(self, cid: int, key: str):
        """One client's host row of ``key`` (views: callers copy)."""
        if self._template is not None and not self._initialized[cid]:
            return self._template[key]
        if self._spill_dir is None:
            return _map(lambda a: a[cid], self._host[key])
        tree = self._shard_tree(cid // self.shard_size)
        return _map(lambda a: a[cid % self.shard_size], tree[key])

    def _empty(self, n: int, keys, pin: bool = False) -> dict:
        return {k: _map(lambda r: torch.empty((n,) + tuple(r.shape), dtype=r.dtype,
                                              pin_memory=pin), self._row_like[k])
                for k in keys}

    def _fill(self, ids: list[int], out: dict) -> dict:
        """Gather the clients' rows into ``out`` (host tensors of
        ``len(ids)`` rows), cohort order."""
        if self._spill_dir is None:
            ids_t = torch.as_tensor(ids, dtype=torch.long)
            for k in out:
                _map(lambda a, o: torch.index_select(a, 0, ids_t, out=o), self._host[k], out[k])
            if self._template is not None:
                for j, cid in enumerate(ids):
                    if not self._initialized[cid]:
                        for k in out:
                            _map(lambda o, t: o[j].copy_(t), out[k], self._template[k])
        else:
            for j, cid in enumerate(ids):
                for k in out:
                    _map(lambda o, r: o[j].copy_(r), out[k], self._row(cid, k))
        return out

    def _gather(self, ids, keys=None) -> dict:
        """Fresh host stacks of the given clients' rows."""
        keys = list(self._row_like) if keys is None else keys
        ids = [int(i) for i in ids]
        with self._lock:
            return self._fill(ids, self._empty(len(ids), keys))

    def _write_rows(self, ids: list[int], trees: dict) -> None:
        with self._lock:
            if self._spill_dir is None:
                ids_t = torch.as_tensor(ids, dtype=torch.long)
                for k, new in trees.items():
                    _map(lambda a, nw: a.index_copy_(0, ids_t, nw), self._host[k], new)
            else:
                for j, cid in enumerate(ids):
                    tree = self._shard_tree(cid // self.shard_size)
                    for k, new in trees.items():
                        _map(lambda a, nw: a[cid % self.shard_size].copy_(nw[j]), tree[k], new)
            if self._initialized is not None:
                self._initialized[ids] = True

    # -- staging onto the device -----------------------------------------------------
    def _on_card(self) -> bool:
        return self._device.type == "cuda"

    def _stage(self, ids: list[int], keys, stream: torch.cuda.Stream | None) -> dict:
        """The rows of ``ids`` on the device, in storage of their own:
        ``{"dev": trees, "event": the copy's event or None}``.  On the card
        the rows pass through a pinned slot, copied on ``stream``."""
        if not self._on_card():
            return {"dev": self._gather(ids, keys), "event": None}
        shape = (len(ids), tuple(keys))
        with self._lock:
            slots = self._slots.get(shape)
            if slots is None:
                slots = self._slots[shape] = [
                    {"host": self._empty(len(ids), keys, pin=True), "event": None}
                    for _ in range(2)]
            turn = self._turn.get(shape, 0)
            self._turn[shape] = 1 - turn
            slot = slots[turn]
            if slot["event"] is not None:  # its last copy must be done before a refill
                slot["event"].synchronize()
            self._fill(ids, slot["host"])
            with torch.cuda.stream(stream):
                dev = _map_keys(lambda h: h.to(self._device, non_blocking=True), slot["host"])
                slot["event"] = event = torch.cuda.Event()
                event.record(stream)
        return {"dev": dev, "event": event}

    def _consume(self, staged: dict) -> dict:
        """Staged rows, safe to read on the current stream."""
        if staged["event"] is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(staged["event"])
            for t in _leaves(staged["dev"]):
                t.record_stream(stream)
        return staged["dev"]

    def _cold(self, ids: list[int], keys) -> dict:
        stream = torch.cuda.current_stream(self._device) if self._on_card() else None
        return self._consume(self._stage(ids, keys, stream))

    # -- the round loop's contract ---------------------------------------------------
    def fetch(self, sel: Sequence[int]):
        sel = tuple(int(i) for i in sel)
        idx = torch.as_tensor(sel, device=self._device)
        dev = self._take_prefetched(sel)
        if dev is None:
            dev = self._cold(list(sel), list(self._row_like))
        frozen = self._frozen_shared if self.shared else dev["frozen"]
        return idx, dev["lora"], frozen, dev["opt"]

    def commit(self, idx, lora: dict, opt: AdamWState) -> None:
        ids = [int(i) for i in (idx.tolist() if isinstance(idx, torch.Tensor) else idx)]
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"commit got duplicate client ids {sorted(ids)}: duplicate row writes would "
                "resolve in unspecified order"
            )
        rows = {"lora": lora, "opt": opt}
        if self._on_card():
            # into pinned rows on the current stream, after the round's last
            # write; the host waits for the copy before it touches the fleet
            bufs = self._commit_bufs.get(len(ids))
            if bufs is None:
                bufs = self._commit_bufs[len(ids)] = self._empty(len(ids), _ROWS, pin=True)
            _map_keys(lambda b, d: b.copy_(d, non_blocking=True), bufs, rows)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._device))
            done.synchronize()
            rows = bufs
        self._write_rows(ids, rows)
        # rows committed after a prefetch snapshot: that staged copy may be
        # stale there, and the matching fetch re-reads them
        for entry in self._pf.values():
            entry[2].update(ids)

    def prefetch(self, sel: Sequence[int]) -> None:
        if not self.prefetch_enabled:
            return
        sel = tuple(int(i) for i in sel)
        # the double buffer: the round loop hints round r+1 while round r's
        # staged cohort is pending; keep both, evict beyond that, oldest first
        self._pf.pop(sel, None)
        while len(self._pf) >= 2:
            self._pf.pop(next(iter(self._pf)))[0].join()
        box: dict = {}
        if self._on_card() and self._side is None:
            self._side = torch.cuda.Stream(device=self._device)

        def stage():
            try:
                if self._on_card():
                    torch.cuda.set_device(self._device)  # the thread's own device
                box["staged"] = self._stage(list(sel), list(self._row_like), self._side)
            except Exception as e:  # noqa: BLE001 - re-raised at the fetch of this cohort
                box["error"] = e

        t = threading.Thread(target=stage, daemon=True)
        self._pf[sel] = [t, box, set()]
        t.start()

    def _drop_prefetch(self) -> None:
        for entry in self._pf.values():
            entry[0].join()
        self._pf.clear()

    def _take_prefetched(self, sel: tuple) -> dict | None:
        entry = self._pf.pop(sel, None)
        if entry is None:
            return None  # no hint for this cohort: a cold fetch
        t, box, dirty = entry
        t.join()
        if "error" in box:
            raise RuntimeError(f"staging the prefetched cohort {list(sel)} failed") from box["error"]
        dev = self._consume(box["staged"])
        stale = [p for p, cid in enumerate(sel) if cid in dirty]
        if stale:
            fresh = self._cold([sel[p] for p in stale], list(_ROWS))
            pos = torch.as_tensor(stale, device=self._device)
            for k in _ROWS:
                _map(lambda full, f: full.index_copy_(0, pos, f), dev[k], fresh[k])
        return dev

    def client_row(self, cid: int) -> tuple[dict, dict]:
        row = self._cold([int(cid)], list(self._row_like))
        lora = {k: v[0] for k, v in row["lora"].items()}
        frozen = self._frozen_shared if self.shared else {k: v[0] for k, v in row["frozen"].items()}
        return lora, frozen

    def lora_rows(self, sel: Sequence[int]) -> dict:
        return self._cold([int(i) for i in sel], ["lora"])["lora"]

    # -- checkpoints ---------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The whole fleet as one tree of host tensors, in the device
        store's layout.  Materialises O(N) host memory: a fleet at scale
        persists through :meth:`save_shards`."""
        self._drop_prefetch()
        full = self._rows_host(0, self.num_clients)
        return {"lora": full["lora"], "opt": full["opt"],
                "frozen": self._frozen_shared if self.shared else full["frozen"]}

    def load_state_dict(self, state: dict) -> None:
        self._drop_prefetch()
        host = {k: _map(lambda t: owned_copy(t, "cpu"), state[k]) for k in _ROWS}
        if self.shared:
            self._frozen_shared = _map(lambda t: owned_copy(t, self._device), state["frozen"])
        else:
            host["frozen"] = _map(lambda t: owned_copy(t, "cpu"), state["frozen"])
        with self._lock:
            self._template = None
            self._initialized = None
            if self._spill_dir is None:
                self._host = host
            else:
                self._cache.clear()
                self._spill_all(host)

    def _rows_host(self, lo: int, hi: int) -> dict:
        return self._gather(range(lo, hi))

    def _frozen_shared_tree(self) -> dict:
        return self._frozen_shared

    def save_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        self._drop_prefetch()
        super().save_shards(dir_path, prefix=prefix)

    def load_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        self._drop_prefetch()
        shards = ckpt_io.list_fleet_shards(dir_path, prefix)
        _check_shard_cover(shards, self.num_clients, dir_path)
        for lo, hi, path in shards:
            self._write_rows(list(range(lo, hi)), ckpt_io.restore(path, self._empty(hi - lo,
                                                                                     self._row_like)))
        if self.shared:
            like = ckpt_io.host_skeleton({"frozen": self._frozen_shared})
            frozen = ckpt_io.restore(os.path.join(dir_path, f"{prefix}_frozen.npz"), like)["frozen"]
            self._frozen_shared = _map(lambda t: t.to(self._device), frozen)

    # -- introspection ---------------------------------------------------------------------
    def device_bytes(self) -> int:
        """The shared backbone only (the cohort's rows are a round's, not
        the store's): independent of N."""
        return _nbytes(self._frozen_shared) if self.shared else 0

    def host_bytes(self) -> int:
        """Resident host bytes of the fleet's rows: 0 when spilled; for a
        lazy fleet the committed rows and the template."""
        if self._spill_dir is not None:
            return 0
        if self._template is None:
            return sum(_nbytes(t) for t in self._host.values())
        row = sum(_nbytes(t) for t in self._template.values())
        return row * (int(self._initialized.sum()) + 1)


def make_fleet_store(spec, *, loras, frozens, shared: bool,
                     state_dtype: str = "float32") -> FleetStore:
    """Resolve a ``FedConfig.fleet_store`` spec — ``"device"``, ``"host"`` or
    an already-built :class:`FleetStore` — into a store holding the given
    per-client trees, its Adam state fresh in ``state_dtype``."""
    if isinstance(spec, FleetStore):
        return spec
    if spec in (None, "device"):
        return DeviceFleetStore(loras, frozens, shared=shared, state_dtype=state_dtype)
    if spec == "host":
        return HostFleetStore(loras, frozens, shared=shared, state_dtype=state_dtype)
    raise ValueError(
        f"unknown fleet_store: {spec!r} (expected 'device', 'host', or a FleetStore instance)"
    )
