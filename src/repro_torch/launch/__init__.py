"""Launchers: step functions for training and serving (the port of
``repro/launch``'s ``steps`` module) and the federated driver
``python -m repro_torch.launch.fed_train``.  The rest of ``repro/launch``
(the ``serve`` and ``train`` launchers, ``mesh``, ``policy`` and the dry
run) is a later slice: ROADMAP.md port queue, "launchers and scale-out"."""

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
    "chunked_lm_loss",
    "init_train_opt",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
]
