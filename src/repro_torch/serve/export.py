"""Federation -> serving handoff — the port of ``repro/serve/export.py``
for a live fleet store.

``export_adapters(store)`` wraps a live
:class:`~repro_torch.fed.store.DeviceFleetStore` as the
:class:`~repro_torch.serve.cache.AdapterSource` an AdapterCache pages
from; ``serving_params`` grafts the fleet's shared backbone into a params
dict of the same model::

    src = export_adapters(store)
    params = serving_params(src, model.init(cfg, seed))
    cache = AdapterCache(src, like=lora_template(params), slots=8)

The reference's other sources read its checkpoint files (``step_N.fleet/``
shard directories, monolithic ``step_N.npz``), which the port does not
carry yet: they raise.
"""

from __future__ import annotations

import os

import torch

from repro_torch.fed.engines.base import not_carried
from repro_torch.fed.store import DeviceFleetStore
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
_CHECKPOINTS = "scenarios and faults, then checkpoints"


class FleetStoreSource:
    """Adapters straight out of a live fleet store (no disk round-trip)."""

    def __init__(self, store: DeviceFleetStore):
        self.store = store
        self.num_adapters = store.num_clients

    def lora_row(self, cid: int) -> dict:
        return {k: v[0] for k, v in self.store.lora_rows([int(cid)]).items()}

    def frozen_tree(self) -> dict:
        if not self.store.shared:
            raise ValueError(_NOT_SHARED)
        return self.store.frozen


class ShardDirSource:
    """The reference's ``step_N.fleet/`` shard directories: not carried."""

    def __init__(self, *args, **kwargs):
        raise not_carried("serving from fleet shard checkpoints", _CHECKPOINTS)


class MonolithicSource:
    """The reference's monolithic ``step_N.npz`` checkpoints: not carried."""

    def __init__(self, *args, **kwargs):
        raise not_carried("serving from monolithic checkpoints", _CHECKPOINTS)


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


def export_adapters(src) -> FleetStoreSource:
    """Resolve ``src`` into an AdapterSource: a live fleet store.  A path
    (the reference's checkpoints) raises: the port has no checkpoints yet."""
    if isinstance(src, DeviceFleetStore):
        return FleetStoreSource(src)
    if isinstance(src, (str, os.PathLike)):
        raise not_carried("export_adapters from a checkpoint path", _CHECKPOINTS)
    raise TypeError(f"export_adapters wants a DeviceFleetStore or a path, got {type(src)!r}")
