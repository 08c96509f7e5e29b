"""Checkpointing: trees of tensors <-> ``.npz`` with path-flattened keys —
the port of ``repro/checkpoint/ckpt.py``, in the reference's layout, so a
checkpoint either package writes restores in the other.

Keys.  A leaf's key is its path's parts joined by ``__``: dict keys by
name, NamedTuple fields by name (``AdamWState.m/v/count/master``, a
``None`` field making no key) and sequence items as ``idx{i}``.  The port
keeps a model's parameters as a flat dict keyed ``"a/b/c"``, where the
reference nests dicts; a ``/`` in a key is a path separator here, so both
write ``a__b__c``.  ``None`` leaves (the holes of a ``split_lora`` tree)
make no key, as in the reference.

Leaves.  A tensor is read to the host and stored at its own dtype and
shape.  numpy has no bf16: the reference's ``np.asarray`` of a bf16 array
is stored as raw 2-byte void (``|V2``, the bf16 bits), and the port writes
a bf16 tensor the same way.  :func:`restore` reads ``|V2`` as bf16 bits
(the reference's own ``restore`` cannot cast it back).  Restored tensors
take the ``like`` leaf's dtype and device and own their storage; a
:func:`host_skeleton` of a tree on the card restores to the host, so the
caller's one copy to the card is the only one.

Crash safety: :func:`save` is atomic — the arrays and then the metadata
sidecar are written to temp files in the target directory and
``os.replace``d into place, so a process killed mid-save never leaves a
truncated checkpoint under the final name; :func:`latest_step` skips
candidates that are not readable zip archives.
"""

from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any

import numpy as np
import torch

__all__ = [
    "save",
    "restore",
    "host_skeleton",
    "restore_subtree",
    "latest_step",
    "save_step",
    "restore_step",
    "step_metadata",
    "fleet_shard_name",
    "list_fleet_shards",
    "fleet_shard_dir",
]

_SEP = "__"


def _leaves(tree: Any, path: tuple = ()):
    """``(key parts, leaf)`` of every non-None leaf, in the tree's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, path + tuple(str(key).split("/")))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _leaves(val, path + (f"idx{i}",))
    else:
        yield path, tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # the bf16 bits, as the reference stores them
            return leaf.contiguous().view(torch.int16).cpu().numpy().view("V2")
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in _leaves(tree)}


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A stored array as a CPU tensor that owns its storage; ``|V2`` is
    read as bf16 bits.  An array read from an npz is a fresh one, so it is
    taken as it is, without a copy."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, copy=True)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device."""
    return _host_tensor(arr).to(device=like.device, dtype=like.dtype)


def _rebuild(like: Any, path: tuple, fetch) -> Any:
    """``like``'s structure with every non-None leaf replaced by
    ``fetch(path parts, leaf)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, path + tuple(str(k).split("/")), fetch) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(**{n: _rebuild(getattr(like, n), path + (n,), fetch)
                             for n in like._fields})
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, path + (f"idx{i}",), fetch) for i, v in enumerate(like))
    return fetch(path, like)


def host_skeleton(like: Any) -> Any:
    """``like``'s structure with each tensor an empty CPU tensor of its
    shape and dtype: :func:`restore` into it leaves every leaf on the host."""
    return _rebuild(like, (), lambda _parts, leaf: torch.empty(tuple(leaf.shape),
                                                               dtype=leaf.dtype))


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save(path: str, tree: Any, *, metadata: dict | None = None) -> None:
    """Atomically write ``tree`` (and the optional JSON ``metadata``
    sidecar ``path + ".meta.json"``), the arrays FIRST: a crash between
    the two replaces leaves a valid array file with a stale or absent
    sidecar, never a torn one."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    _atomic_write(path, lambda f: np.savez(f, **flat))  # a file object: savez cannot rename it
    if metadata is not None:
        _atomic_write(path + ".meta.json", lambda f: f.write(json.dumps(metadata).encode()))


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``, a tree of tensors (their
    dtypes and devices).
    Raises ``ValueError`` naming the key when the checkpoint lacks a leaf
    or stores it at another shape than ``like``'s."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:

        def fetch(parts, leaf):
            key = _SEP.join(parts)
            if key not in data:
                raise ValueError(
                    f"checkpoint {path} has no entry for {key!r} — the stored tree does not "
                    "match the requested structure"
                )
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint {path} entry {key!r} has shape {arr.shape}, but the target "
                    f"structure expects {tuple(leaf.shape)}"
                )
            return _from_numpy(arr, leaf)

        return _rebuild(like, (), fetch)


def restore_subtree(path: str, prefix: str) -> Any:
    """The subtree stored under the flattened key ``prefix`` (e.g.
    ``"fleet__lora"``), without a skeleton: a flat ``{"a/b/c": tensor}``
    dict on the CPU (the port's parameter layout), or the leaf itself when
    ``prefix`` names one.  Raises ``KeyError`` when nothing matches."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    out: dict[str, torch.Tensor] = {}
    lead = prefix + _SEP
    with np.load(path) as data:
        for key in data.files:
            if key == prefix:
                return _host_tensor(data[key])
            if key.startswith(lead):
                out["/".join(key[len(lead):].split(_SEP))] = _host_tensor(data[key])
    if not out:
        raise KeyError(f"checkpoint {path} holds no keys under prefix {prefix!r}")
    return out


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_step(ckpt_dir: str, step: int, tree: Any, **meta) -> str:
    path = _step_path(ckpt_dir, step)
    save(path, tree, metadata={"step": step, **meta})
    return path


def latest_step(ckpt_dir: str) -> int | None:
    """Newest VALID step in ``ckpt_dir`` (None when there is none): a
    ``step_NNNNNNNN.npz`` that is a readable zip archive, so a torn file
    is skipped and resume falls back to the newest loadable step."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        (int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := re.match(r"step_(\d+)\.npz$", f))),
        reverse=True,
    )
    for step in steps:
        try:
            if zipfile.is_zipfile(_step_path(ckpt_dir, step)):
                return step
        except OSError:
            continue
    return None


def step_metadata(ckpt_dir: str, step: int) -> dict | None:
    """The JSON sidecar saved with ``save_step`` (None when absent or
    unparseable: a torn sidecar must not block a restore of the arrays)."""
    path = _step_path(ckpt_dir, step) + ".meta.json"
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def restore_step(ckpt_dir: str, like: Any, step: int | None = None) -> tuple[Any, int]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return restore(_step_path(ckpt_dir, step), like), step


# -- per-client fleet shards ---------------------------------------------
#
# A fleet-scale checkpoint splits the per-client state into range shards
# (``{prefix}_{lo:08d}_{hi:08d}.npz``, each written atomically by
# :func:`save`) beside the small main step npz, written FIRST, so a valid
# ``step_NNNNNNNN.npz`` implies complete shards.  Shard directories
# (``step_NNNNNNNN.fleet/``) do not match the step-file pattern.

_SHARD_RE = re.compile(r"^(?P<prefix>.+)_(?P<lo>\d{8})_(?P<hi>\d{8})\.npz$")


def fleet_shard_name(prefix: str, lo: int, hi: int) -> str:
    """Canonical file name of the shard holding clients ``[lo, hi)``."""
    return f"{prefix}_{lo:08d}_{hi:08d}.npz"


def fleet_shard_dir(ckpt_dir: str, step: int) -> str:
    """The shard directory riding alongside one step's main npz."""
    return os.path.join(ckpt_dir, f"step_{step:08d}.fleet")


def list_fleet_shards(dir_path: str, prefix: str = "fleet") -> list[tuple[int, int, str]]:
    """All ``(lo, hi, path)`` shard ranges of ``prefix`` in ``dir_path``,
    sorted by range; ``FileNotFoundError`` when the directory is missing."""
    if not os.path.isdir(dir_path):
        raise FileNotFoundError(f"no fleet shard directory at {dir_path}")
    out = []
    for f in os.listdir(dir_path):
        m = _SHARD_RE.match(f)
        if m and m.group("prefix") == prefix:
            out.append((int(m.group("lo")), int(m.group("hi")), os.path.join(dir_path, f)))
    return sorted(out)
