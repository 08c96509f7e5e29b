"""Shape/arch launch policy — the port of ``repro/launch/policy.py``;
import-safe (no process group, no allocation).

Shared by the dry run and the tests, so the window policy and the input
stand-ins are defined once.  The stand-ins are ``meta`` tensors, the
port's ``ShapeDtypeStruct``: shapes and dtypes, no storage.
"""

from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["window_for", "arch_shape_config", "input_specs"]


def window_for(cfg: ModelConfig, shape: ShapeConfig) -> int | None:
    """Full-attention archs get sliding window 4096 at long_500k; SSM and
    hybrid run natively (the SSM state is O(1); jamba's few attention
    layers keep the sequence-sharded full-length cache)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return 4096
    return None


def arch_shape_config(arch: str, shape: ShapeConfig) -> ModelConfig:
    cfg = get_config(arch)
    # decode/prefill don't train: microbatching is a train-only lever.
    if shape.kind != "train":
        cfg = cfg.with_overrides(microbatches=1)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> dict:
    """``meta`` stand-ins for every model input of this step kind: the
    batch ``{"tokens": (B, S_text) int32}`` (plus ``"frontend" (B, F, d)``
    in the compute dtype for a VLM or audio model) of a train or prefill
    step, or a decode step's ``token (B,)`` and cache
    (:func:`repro_torch.models.init_cache` on ``meta``).  ``mesh`` is
    unused, as in the reference."""
    from repro_torch.models import init_cache
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.model import input_token_len

    b = shape.global_batch
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        s_text = input_token_len(cfg, shape.seq_len)
        specs["batch"] = {"tokens": torch.empty((b, s_text), dtype=torch.int32, device="meta")}
        if cfg.frontend != "none":
            specs["batch"]["frontend"] = torch.empty(
                (b, cfg.frontend_len, cfg.d_model), dtype=torch_dtype(cfg.compute_dtype),
                device="meta")
    else:  # decode
        w = window_for(cfg, shape)
        specs["token"] = torch.empty((b,), dtype=torch.int32, device="meta")
        specs["cache"] = init_cache(cfg, b, shape.seq_len, window=w, device="meta")
    return specs
