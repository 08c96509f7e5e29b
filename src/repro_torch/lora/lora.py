"""LoRA parameter groups (paper §II-A, eq. 1) — the port of
``repro/lora/lora.py``.

A parameter dict splits into the trainable adapters θ_n = {A_n, B_n} (every
leaf whose path has a ``lora`` or ``lora_*`` component) and the frozen
backbone W'; only the first group ever gets a gradient.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["is_lora_path", "split_lora", "merge_lora", "lora_param_count", "map_lora",
           "lora_template"]


def is_lora_path(key: str) -> bool:
    return any(part == "lora" or part.startswith("lora_") for part in key.split("/"))


def split_lora(params: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """``(trainable adapters, frozen backbone)``; the backbone leaves are
    marked ``requires_grad=False``."""
    lora = {k: v for k, v in params.items() if is_lora_path(k)}
    frozen = {k: v.requires_grad_(False) for k, v in params.items() if not is_lora_path(k)}
    return lora, frozen


def lora_param_count(params: dict[str, torch.Tensor]) -> int:
    """The number of trainable adapter parameters in ``params``."""
    return sum(int(v.numel()) for k, v in params.items() if is_lora_path(k))


def merge_lora(lora: dict, frozen: dict) -> dict:
    """Inverse of :func:`split_lora`."""
    return {**frozen, **lora}


def map_lora(fn: Callable[[torch.Tensor], torch.Tensor], params: dict) -> dict:
    """Apply ``fn`` to the LoRA leaves only."""
    return {k: fn(v) if is_lora_path(k) else v for k, v in params.items()}


def lora_template(params: dict) -> dict:
    """Shape and dtype skeleton of the adapter group (``split_lora()[0]``
    with leaves on the ``meta`` device, which holds no data) — the ``like``
    argument the serving ``AdapterCache`` checks adapter rows against."""
    lora, _ = split_lora(params)
    return {k: torch.empty_like(v, device="meta") for k, v in lora.items()}
