"""Federation -> serving handoff — the port of ``repro/serve/export.py``.

``export_adapters`` resolves a live
:class:`~repro_torch.fed.store.FleetStore` (device or host) or what a run with
``ckpt_dir`` left on disk (either package's: the layout is the
reference's) into the :class:`~repro_torch.serve.cache.AdapterSource` an
AdapterCache pages from:

* ``step_N.fleet/`` shard directories (``fleet_{lo:08d}_{hi:08d}.npz`` +
  ``fleet_frozen.npz``): rows are read per shard, with a small LRU of
  open shards, so the fleet is never held whole in memory;
* monolithic ``step_N.npz`` checkpoints: the ``fleet__lora`` stacked
  subtree, loaded once into host memory;
* a live store, read through its ``lora_rows`` serving contract.

Each source's ``frozen_tree()`` is the fleet's shared backbone, which
``serving_params`` grafts into a params dict of the same model::

    src = export_adapters(ckpt_dir)
    params = serving_params(src, model.init(cfg, seed))
    cache = AdapterCache(src, like=lora_template(params), slots=8)
"""

from __future__ import annotations

import os
from collections import OrderedDict

import torch

from repro_torch.checkpoint import ckpt as ckpt_io
from repro_torch.lora import is_lora_path

__all__ = [
    "export_adapters",
    "serving_params",
    "FleetStoreSource",
    "ShardDirSource",
    "MonolithicSource",
]

_NOT_SHARED = (
    "this fleet checkpoints a PER-CLIENT backbone (no shared frozen tree); "
    "multi-tenant serving stacks adapters against ONE shared backbone — "
    "export a shared-backbone federation instead"
)


class FleetStoreSource:
    """Adapters straight out of a live fleet store, device or host (no disk
    round-trip)."""

    def __init__(self, store):
        self.store = store
        self.num_adapters = store.num_clients

    def lora_row(self, cid: int) -> dict:
        return {k: v[0] for k, v in self.store.lora_rows([int(cid)]).items()}

    def frozen_tree(self) -> dict:
        if not self.store.shared:
            raise ValueError(_NOT_SHARED)
        return self.store.frozen


class ShardDirSource:
    """Adapters from a ``step_N.fleet/`` shard directory.  Rows are read
    per shard on demand; at most ``max_open`` shards' adapters stay in
    memory (LRU), so host memory is O(shard), not O(fleet)."""

    def __init__(self, dir_path: str, *, prefix: str = "fleet", max_open: int = 2):
        self.dir = dir_path
        self.prefix = prefix
        self._shards = ckpt_io.list_fleet_shards(dir_path, prefix)
        if not self._shards:
            raise FileNotFoundError(f"no {prefix!r} shards in {dir_path} — not a fleet shard dir")
        self.num_adapters = max(hi for _, hi, _ in self._shards)
        self._open: OrderedDict[str, dict] = OrderedDict()
        self._max_open = max_open

    def _shard_lora(self, path: str) -> dict:
        tree = self._open.get(path)
        if tree is None:
            tree = ckpt_io.restore_subtree(path, "lora")
            while len(self._open) >= self._max_open:
                self._open.popitem(last=False)
            self._open[path] = tree
        else:
            self._open.move_to_end(path)
        return tree

    def lora_row(self, cid: int) -> dict:
        cid = int(cid)
        for lo, hi, path in self._shards:
            if lo <= cid < hi:
                return {k: v[cid - lo] for k, v in self._shard_lora(path).items()}
        raise IndexError(f"tenant {cid} outside the shard ranges of {self.dir} "
                         f"(fleet of {self.num_adapters})")

    def frozen_tree(self) -> dict:
        frozen_path = os.path.join(self.dir, f"{self.prefix}_frozen.npz")
        if not os.path.exists(frozen_path):
            raise ValueError(_NOT_SHARED)
        return ckpt_io.restore_subtree(frozen_path, "frozen")


class MonolithicSource:
    """Adapters from a monolithic ``step_N.npz``: the ``fleet__lora``
    stacked subtree, loaded once into host memory."""

    def __init__(self, path: str):
        self.path = path
        self._lora = ckpt_io.restore_subtree(path, "fleet__lora")
        sizes = {int(x.shape[0]) for x in self._lora.values()}
        if len(sizes) != 1:
            raise ValueError(f"{path}: fleet__lora leaves disagree on the client axis: {sizes}")
        self.num_adapters = sizes.pop()

    def lora_row(self, cid: int) -> dict:
        return {k: v[int(cid)] for k, v in self._lora.items()}

    def frozen_tree(self) -> dict:
        frozen = ckpt_io.restore_subtree(self.path, "fleet__frozen")
        # a shared backbone stores ONE tree, per-client backbones stack N:
        # ambiguous only if every frozen leaf's leading dim were the fleet
        # size, which real parameter trees (norm vectors, embeddings) never are
        per_client = all(x.ndim >= 1 and int(x.shape[0]) == self.num_adapters
                         for x in frozen.values())
        if per_client and self.num_adapters > 1:
            raise ValueError(_NOT_SHARED)
        return frozen


def serving_params(source, like: dict) -> dict:
    """Full serving params: the source's shared backbone grafted into
    ``like`` (a freshly initialised params dict of the same model config),
    leaf by key.  LoRA leaves keep ``like``'s values — per request the
    AdapterCache slab overrides them; detached, they are the fallback
    adapter."""
    frozen = source.frozen_tree()
    out = {}
    for key, leaf in like.items():
        if is_lora_path(key):
            out[key] = leaf
            continue
        val = frozen.get(key)
        if val is None:
            raise KeyError(f"exported backbone is missing leaf {key!r} — it does not match the "
                           "model config")
        if tuple(val.shape) != tuple(leaf.shape):
            raise ValueError(f"backbone leaf {key!r} has shape {tuple(val.shape)}, model expects "
                             f"{tuple(leaf.shape)}")
        out[key] = torch.as_tensor(val).to(dtype=leaf.dtype, device=leaf.device)
    return out


def export_adapters(src):
    """Resolve ``src`` into an AdapterSource: a live fleet store, a
    ``step_N.fleet/`` shard directory, a ``step_N.npz`` file, or a
    checkpoint directory (its newest valid step, shards preferred over the
    monolithic fleet subtree)."""
    # imported here: ``repro_torch.fed`` imports the launchers' steps, which
    # import serving; at module level this would close a cycle
    from repro_torch.fed.store import FleetStore

    if isinstance(src, FleetStore):
        return FleetStoreSource(src)
    if not isinstance(src, (str, os.PathLike)):
        raise TypeError(f"export_adapters wants a FleetStore or a path, got {type(src)!r}")
    path = os.fspath(src)
    if os.path.isdir(path):
        try:
            return ShardDirSource(path)
        except FileNotFoundError:
            pass
        step = ckpt_io.latest_step(path)
        if step is not None:
            shard_dir = ckpt_io.fleet_shard_dir(path, step)
            if os.path.isdir(shard_dir):
                return ShardDirSource(shard_dir)
            return MonolithicSource(os.path.join(path, f"step_{step:08d}.npz"))
        raise FileNotFoundError(f"{path}: neither fleet shards nor step_N.npz checkpoints found")
    if os.path.isfile(path) and path.endswith(".npz"):
        return MonolithicSource(path)
    raise FileNotFoundError(f"export_adapters: no such checkpoint: {path}")
