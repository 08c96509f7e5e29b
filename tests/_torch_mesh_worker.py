"""The port's steps on a 2x2 ``("data", "model")`` mesh for
``tests/test_torch_mesh_step.py``: four gloo ranks on the CPU, started by
``spawn`` (this module imports the port, torch and numpy only, so a rank
starts without JAX).

:func:`steps` runs one family's train step, prefill and decode steps on
the parameters of ``init(cfg, SEED)`` — placed by the spec rules as
DTensors on a mesh with the activation rules installed, or plain on one
process (the test's reference side bridges the same init into JAX).
:func:`main` is the spawned entry: each rank writes what it computed to
``{out}/rank{rank}.pt``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as sh
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import init_train_opt, make_train_step
from repro_torch.models import init, init_cache
from repro_torch.serve.steps import make_decode_step, make_prefill_step

FAMILIES = {"dense": "yi-9b", "moe": "granite-moe-1b-a400m", "ssm": "mamba2-130m"}
SEED = 3
B, S, DECODE = 4, 16, 10  # batch (divides the data axis), prompt and cache length, decode steps


def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def steps(family: str, mesh=None) -> dict:
    """One family's train step, prefill and ``DECODE`` decode steps from
    an empty cache: the loss, the updated parameters, the prefill logits
    and every decode step's logits, as plain tensors."""
    cfg = get_smoke_config(FAMILIES[family])
    params = init(cfg, SEED, "cpu")
    opt = init_train_opt(params, cfg)
    batch = {"tokens": torch.as_tensor(tokens(cfg))}
    cache = init_cache(cfg, B, S, device="cpu")
    token_spec = ("data",)
    if mesh is not None:
        pspecs = sh.param_specs(params, mesh)
        params_d = sh.distribute_tree(params, pspecs, mesh)
        opt = sh.distribute_tree(opt, sh.opt_state_specs(pspecs), mesh)
        batch = sh.distribute_tree(batch, sh.batch_specs(mesh, with_labels=False), mesh)
        cache = sh.distribute_tree(cache, sh.cache_specs(cache, mesh), mesh)
        params = params_d
    ctx = sh.on_mesh(mesh) if mesh is not None else torch.no_grad()
    out = {}
    with ctx:
        new_p, _, metrics = make_train_step(cfg)(params, opt, batch)
        out["loss"] = _full(metrics["loss"]).item()
        out["params"] = {k: _full(v) for k, v in new_p.items()}
        out["prefill"] = _full(make_prefill_step(cfg)(params, batch))
        decode = make_decode_step(cfg)
        logits = []
        for t in range(DECODE):
            tok = torch.as_tensor(tokens(cfg)[:, t])
            if mesh is not None:
                tok = sh.distribute_tree(tok, token_spec, mesh)
            step_logits, cache = decode(params, cache, tok)
            logits.append(_full(step_logits))
        out["decode"] = torch.stack(logits)
    return out


def main(rank: int, rdzv: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=4)
    try:
        mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
        torch.save({f: steps(f, mesh) for f in FAMILIES}, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
