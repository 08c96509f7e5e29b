"""AdapterCache: LRU paging of tenant adapters over device slots — the
port of ``repro/serve/cache.py``.

:meth:`AdapterCache.lookup` maps a batch of tenant ids to slot indices:

* **hit** — the tenant's adapter already sits in a slot: the slot is
  returned and the tenant becomes most recently used;
* **miss** — the least recently used unpinned slot is evicted (adapter
  rows are read only at serve time, so nothing is written back) and the
  tenant's row is paged in from the :class:`AdapterSource` with one slab
  write.

Slots referenced earlier in the same batch are pinned: a lookup never
evicts an adapter the batch still needs.  Duplicate ids in a batch count
once; a batch with more distinct tenants than slots raises.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Protocol, Sequence

import numpy as np
import torch

from repro_torch.serve.adapters import canonicalize_row, slab_init, slab_set_row

__all__ = ["AdapterSource", "CacheStats", "AdapterCache"]


class AdapterSource(Protocol):
    """Where cold adapters live (a live fleet store, host memory)."""

    num_adapters: int

    def lora_row(self, cid: int) -> Any:
        """Tenant ``cid``'s LoRA row (a flat dict of tensors)."""
        ...


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    lookups: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AdapterCache:
    """LRU tenant-adapter cache over a slab of ``slots`` rows on ``device``.
    ``like`` is the adapter-row skeleton (``repro_torch.lora.lora_template``
    of the served model's params); every paged row is checked against it."""

    def __init__(self, source: AdapterSource, *, like: dict, slots: int,
                 device: str | torch.device = "cuda"):
        if slots < 1:
            raise ValueError(f"AdapterCache needs >= 1 slot, got {slots}")
        self.source = source
        self.slots = int(slots)
        self._like = like
        self.slab = slab_init(like, self.slots, device)
        self._slot_of: OrderedDict[int, int] = OrderedDict()  # cid -> slot, LRU order
        self._free = list(range(self.slots))
        self.stats = CacheStats()

    def resident(self) -> tuple[int, ...]:
        """Tenant ids currently in slots, LRU -> MRU order."""
        return tuple(self._slot_of)

    def reset_stats(self) -> None:
        self.stats = CacheStats()

    def _page_in(self, cid: int, pinned: set[int]) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            victim = next((c for c in self._slot_of if c not in pinned), None)
            if victim is None:  # unreachable: the distinct-id count is checked first
                raise RuntimeError("all slots pinned by the current batch")
            slot = self._slot_of.pop(victim)
            self.stats.evictions += 1
        slab_set_row(self.slab, canonicalize_row(self.source.lora_row(cid), self._like), slot)
        self._slot_of[cid] = slot
        return slot

    def lookup(self, ids: Sequence[int]) -> np.ndarray:
        """Slot per request: ``ids (B,)`` tenant ids -> ``(B,) int32`` slab
        slots, paging misses in from the source.  Duplicate ids in a batch
        share a slot (the first occurrence decides hit or miss)."""
        ids = [int(i) for i in ids]
        distinct = len(set(ids))
        if distinct > self.slots:
            raise ValueError(
                f"batch needs {distinct} distinct adapters but the cache has {self.slots} "
                "slots — raise the slot count or shrink the batch"
            )
        self.stats.lookups += 1
        pinned: set[int] = set()
        out = np.empty(len(ids), np.int32)
        for b, cid in enumerate(ids):
            if cid in self._slot_of:
                if cid not in pinned:  # duplicates count once per batch
                    self.stats.hits += 1
                self._slot_of.move_to_end(cid)
                out[b] = self._slot_of[cid]
            else:
                self.stats.misses += 1
                out[b] = self._page_in(cid, pinned)
            pinned.add(cid)
        return out
