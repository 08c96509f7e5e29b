"""Mesh construction for the launchers — the port of
``repro/launch/mesh.py``: the production mesh, the host mesh, the cohort
mesh, and the card's constants.

Functions, not module-level constants: importing this module makes no
process group.  A mesh is a ``DeviceMesh`` over the default process
group, which the caller starts (``torch.distributed.run``, spawned ranks,
or the dry run's fake group of 256 or 512 ranks)."""

from __future__ import annotations

import math

import torch

from repro_torch.sharding import cohort_mesh

__all__ = ["H100", "make_production_mesh", "make_host_mesh", "make_client_mesh"]

# NVIDIA H100 SXM, the data sheet's figures (dense rates without sparsity,
# at the 700 W power limit), not measurements: the roofline denominators,
# and the cost model every dry-run record carries under ``hw``.
H100 = {
    "peak_bf16_flops": 989e12,  # FLOP/s on the tensor cores
    "peak_tf32_flops": 495e12,  # FLOP/s on the tensor cores
    "peak_fp32_flops": 67e12,  # FLOP/s outside the tensor cores
    "hbm_bandwidth": 3.35e12,  # B/s
    "nvlink_bandwidth": 900e9,  # B/s a card, all 18 NVLink 4 links, both directions
    "hbm_bytes": 80 * 1024**3,
}

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    """16x16 = 256 ranks a pod; ``multi_pod`` adds the 2-pod leading axis.
    The default group must have exactly that many ranks: no smaller mesh
    is ever built in its place."""
    import torch.distributed as dist

    shape, axes = PRODUCTION_SHAPES[multi_pod]
    want = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != want:
        raise RuntimeError(f"the production mesh {shape} needs a world of {want} ranks, not {have}")
    return make_host_mesh(shape, axes, device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device: str | torch.device = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the ranks the caller started
    (their count is the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=tuple(axes))


def make_client_mesh(device: str | torch.device = "cuda"):
    """The federated engines' cohort placement: a 1-D mesh over the ranks
    of the process group (axis ``"clients"``).  The launch-side alias of
    :func:`repro_torch.sharding.cohort_mesh`, so launchers make meshes from
    one module."""
    return cohort_mesh(device)
