"""Move parameters between the JAX reference package and the port.

The reference keeps a model's parameters as a nested dict pytree; the port
keeps a flat dict keyed by the same paths joined with ``/`` (the strings of
``repro/lora/lora.py``'s ``_path_strings``).  The layer-stacked leading
axis of ``stack/pos0/...`` is kept as it is, so every leaf has the same
shape on both sides.  Arrays cross as numpy: call ``jax.tree.map(np.asarray,
params)`` on the JAX side first.  ``None`` leaves (the holes of a
``split_lora`` tree) are skipped.  numpy has no bf16 of its own: a bf16
leaf of the reference (an ``ml_dtypes`` array) crosses as its exact fp32
values and becomes a bf16 tensor again, and a bf16 tensor goes back as
fp32 numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flatten", "unflatten", "to_torch", "to_numpy_tree"]


def flatten(tree: dict, prefix: str = "") -> dict[str, object]:
    """Nested dict -> ``{"a/b/c": leaf}`` in the tree's key order."""
    out: dict[str, object] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten(val, path + "/"))
        elif val is not None:
            out[path] = val
    return out


def unflatten(flat: dict[str, object]) -> dict:
    """``{"a/b/c": leaf}`` -> nested dict."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _tensor(v) -> torch.Tensor:
    a = np.array(v, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def to_torch(tree: dict, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """A reference param tree (numpy leaves) -> the port's flat tensor dict."""
    return {k: _tensor(v).to(device) for k, v in flatten(tree).items()}


def to_numpy_tree(params: dict[str, torch.Tensor]) -> dict:
    """The port's flat tensor dict -> a reference-shaped tree of numpy arrays
    (bf16 leaves as fp32)."""
    return unflatten({
        k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
        for k, v in params.items()
    })
