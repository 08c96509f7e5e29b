"""Launchers — the port of ``repro/launch``: step functions for training
and serving (``steps``), the cohort mesh and the card's constants
(``mesh``), and the entry points ``python -m repro_torch.launch.fed_train``
(the federation, ``--shard-clients`` under ``torch.distributed.run``),
``repro_torch.launch.train`` (LM training) and ``repro_torch.launch.serve``
(serving).  The production mesh and host mesh, ``policy`` and the dry run
are a later slice: ROADMAP.md port queue, "production mesh, sharding rules
and the dry run"."""

from repro_torch.launch.mesh import H100, make_client_mesh
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
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
]
