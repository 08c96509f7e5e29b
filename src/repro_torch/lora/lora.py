"""LoRA parameter groups (paper §II-A, eq. 1) — the port of
``repro/lora/lora.py``.

A parameter dict splits into the trainable adapters θ_n = {A_n, B_n} (every
leaf whose path has a ``lora`` or ``lora_*`` component) and the frozen
backbone W'; only the first group ever gets a gradient.
"""

from __future__ import annotations

import torch

__all__ = ["is_lora_path", "split_lora", "merge_lora"]


def is_lora_path(key: str) -> bool:
    return any(part == "lora" or part.startswith("lora_") for part in key.split("/"))


def split_lora(params: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """``(trainable adapters, frozen backbone)``; the backbone leaves are
    marked ``requires_grad=False``."""
    lora = {k: v for k, v in params.items() if is_lora_path(k)}
    frozen = {k: v.requires_grad_(False) for k, v in params.items() if not is_lora_path(k)}
    return lora, frozen


def merge_lora(lora: dict, frozen: dict) -> dict:
    """Inverse of :func:`split_lora`."""
    return {**frozen, **lora}
