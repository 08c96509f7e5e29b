"""Launchers — the port of ``repro/launch``: step functions for training
and serving (``steps``), the cohort mesh and the card's constants
(``mesh``: also the production and host meshes), the launch policy
(``policy``), and the entry points ``python -m repro_torch.launch.fed_train``
(the federation, ``--shard-clients`` under ``torch.distributed.run``),
``repro_torch.launch.train`` (LM training) and ``repro_torch.launch.serve``
(serving).

NOTE: ``repro_torch.launch.dryrun`` starts a fake process group of 256 or
512 ranks: run it only in a process of its own (its CLI).  Everything
else here is import-safe."""

from repro_torch.launch.mesh import H100, make_client_mesh, make_host_mesh, make_production_mesh
from repro_torch.launch.steps import (
    CE_CHUNK,
    chunked_lm_loss,
    init_train_opt,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "CE_CHUNK",
    "H100",
    "chunked_lm_loss",
    "init_train_opt",
    "make_client_mesh",
    "make_host_mesh",
    "make_production_mesh",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
]
