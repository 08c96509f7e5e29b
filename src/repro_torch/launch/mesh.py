"""Mesh construction for the launchers — the port of the cohort part of
``repro/launch/mesh.py``, and the card's constants.

A function, not a module-level constant: importing this module makes no
process group.  The production mesh and the host mesh are a later slice
(ROADMAP.md port queue: "production mesh, sharding rules and the dry
run")."""

from __future__ import annotations

import torch

from repro_torch.sharding import cohort_mesh

__all__ = ["H100", "make_client_mesh"]

# NVIDIA H100 SXM, the data sheet's figures (dense rates without sparsity,
# at the 700 W power limit), not measurements: the roofline denominators.
H100 = {
    "peak_bf16_flops": 989e12,  # FLOP/s on the tensor cores
    "peak_tf32_flops": 495e12,  # FLOP/s on the tensor cores
    "peak_fp32_flops": 67e12,  # FLOP/s outside the tensor cores
    "hbm_bandwidth": 3.35e12,  # B/s
    "hbm_bytes": 80 * 1024**3,
}


def make_client_mesh(device: str | torch.device = "cuda"):
    """The federated engines' cohort placement: a 1-D mesh over the ranks
    of the process group (axis ``"clients"``).  The launch-side alias of
    :func:`repro_torch.sharding.cohort_mesh`, so launchers make meshes from
    one module."""
    return cohort_mesh(device)
