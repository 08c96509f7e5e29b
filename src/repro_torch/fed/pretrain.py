"""Backbone pretraining for the federated runs — the port of
``repro/fed/pretrain.py``.

The paper fine-tunes PRETRAINED GPT-2 (small on the clients, large on the
server) under per-client LoRA.  No checkpoint can be loaded here, so
pretraining is simulated as the reference simulates it: full-parameter
training on a pretraining split of the synthetic corpus that the federated
run never sees, stopped at moderate accuracy.  The result is the shared
frozen backbone W' of paper eq. 1 with fresh, zero-delta LoRA adapters
(``B = 0``) on top: the federated run then trains only θ_n = {A_n, B_n}.

A single model runs as one client of the port's cohort AdamW (its state on
a client axis of 1), so the gradient clip spans the whole tree.  Results
are cached per (config, steps, lr, seed, data, ...) and device, so runs
that share a configuration pretrain once.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import epoch_batches
from repro_torch.data.synthetic import IntentDataset
from repro_torch.fed import steps as fed_steps
from repro_torch.launch.steps import full_adamw_step, full_grads, init_train_opt, make_train_step
from repro_torch.lora import merge_lora, split_lora
from repro_torch.models import model as model_lib

__all__ = ["pretrain_classifier", "pretrain_lm"]

_CACHE: dict = {}


def _data_key(data: IntentDataset) -> str:
    """A digest of the pretraining split's tokens and labels."""
    return hashlib.sha1(np.ascontiguousarray(data.tokens).tobytes()
                        + np.ascontiguousarray(data.labels).tobytes()).hexdigest()


def _owned(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A copy of every tensor of a cached result: the engines' fleet store
    and server state are written in place, and a cached tensor handed out
    as it is would carry one run's writes into the next."""
    return {k: v.clone() for k, v in params.items()}


def _reset_lora(params: dict, cfg: ModelConfig, seed: int, device) -> dict:
    """The pretrained backbone under the fresh adapters of ``init(cfg,
    seed)``: pretraining moved A and B too, and the federated protocol
    starts from W' with B = 0."""
    fresh_lora, _ = split_lora(model_lib.init(cfg, seed, device, adapters_only=True))
    _, frozen = split_lora(params)
    return merge_lora(fresh_lora, frozen)


def _supervised_step(cfg: ModelConfig, num_classes: int, lr: float, last_only: bool):
    """step(params, opt, batch {tokens (B, L), labels (B,)}) -> (params,
    opt, {"loss", "acc"}): the class readout's NLL at the last position (the
    head computes only the ``num_classes`` columns it reads) plus 0.01 times
    the MoE router's auxiliary loss (0 without MoE layers)."""

    def loss_fn(params, tokens, labels):
        last, aux = fed_steps.last_logits(
            params, cfg, tokens[None], last_only=last_only,
            head_cols=num_classes if last_only else None,
        )
        cls = fed_steps.class_logits(last[0], num_classes)
        logp = torch.log_softmax(cls.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0].mean()
        acc = torch.mean((torch.argmax(cls, dim=-1) == labels).float())
        return nll + 0.01 * aux.moe_aux[0], acc

    def step(params, opt, batch):
        (loss, acc), grads = full_grads(loss_fn, params, batch["tokens"], batch["labels"])
        params, opt = full_adamw_step(grads, opt, params, lr=lr, weight_decay=1e-4)
        return params, opt, {"loss": loss, "acc": acc}

    return step


def _pretrain(step, params: dict, opt, data: IntentDataset, steps: int, batch_size: int,
              seed: int, keys: tuple[str, ...], device, label: str | None) -> dict:
    """``steps`` steps over shuffled epochs of ``data`` drawn from
    ``np.random.default_rng(seed)``, the reference's batch order; with a
    ``label``, the metrics every 25 steps are printed (which waits for the
    device)."""
    rng = np.random.default_rng(seed)
    done = 0
    while done < steps:
        for batch in epoch_batches(data, batch_size, rng=rng):
            tb = {k: torch.as_tensor(batch[k], device=device) for k in keys}
            params, opt, metrics = step(params, opt, tb)
            done += 1
            if label is not None and done % 25 == 0:
                shown = " ".join(f"{k}={float(metrics[k]):.3f}" for k in ("loss", "acc")
                                 if k in metrics)
                print(f"[{label}] step {done}: {shown}")
            if done >= steps:
                break
    return params


def pretrain_classifier(
    cfg: ModelConfig,
    pretrain_data: IntentDataset,
    *,
    num_classes: int,
    steps: int = 150,
    lr: float = 2e-3,
    batch_size: int = 64,
    seed: int = 0,
    last_only: bool = True,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """Full-parameter supervised pretraining from ``init(cfg, seed)``;
    returns the pretrained backbone with the fresh adapters of ``init(cfg,
    seed + 1)`` — the shared W' + θ_0 of eq. 1."""
    key = (cfg, steps, lr, seed, _data_key(pretrain_data), num_classes, batch_size, last_only,
           str(torch.device(device)))
    if key not in _CACHE:
        params = model_lib.init(cfg, seed, device)
        step = _supervised_step(cfg, num_classes, lr, last_only)
        params = _pretrain(step, params, init_train_opt(params, cfg), pretrain_data, steps,
                           batch_size, seed, ("tokens", "labels"), device,
                           f"pretrain {cfg.name}" if verbose else None)
        _CACHE[key] = _reset_lora(params, cfg, seed + 1, device)
    return _owned(_CACHE[key])


def pretrain_lm(
    cfg: ModelConfig,
    pretrain_data: IntentDataset,
    *,
    steps: int = 60,
    lr: float = 2e-3,
    batch_size: int = 64,
    seed: int = 0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """LM-only (next-token) pretraining: token and keyword features with no
    label information — the paper's server LLM, a generically pretrained
    model whose task knowledge arrives through distillation.  Returns the
    backbone under the fresh adapters of ``init(cfg, seed + 1)``."""
    key = ("lm", cfg, steps, lr, seed, _data_key(pretrain_data), str(torch.device(device)))
    if key not in _CACHE:
        params = model_lib.init(cfg, seed, device)
        step = make_train_step(cfg, lr=lr, weight_decay=1e-4)
        params = _pretrain(step, params, init_train_opt(params, cfg), pretrain_data, steps,
                           batch_size, seed, ("tokens",), device,
                           f"pretrain-lm {cfg.name}" if verbose else None)
        _CACHE[key] = _reset_lora(params, cfg, seed + 1, device)
    return _owned(_CACHE[key])
