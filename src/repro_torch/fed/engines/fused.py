"""The fused client-phase engine — the port of ``repro/fed/engines/fused.py``."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.fed import steps as fed_steps
from repro_torch.fed.client import Client
from repro_torch.fed.engines.base import BroadcastState, ClientPhase, check_unique_cohort
from repro_torch.fed.engines.batched import _FleetEngine

__all__ = ["FusedEngine"]


class FusedEngine(_FleetEngine):
    """The batched engine's phases as one round function
    (:func:`repro_torch.fed.steps.make_fused_round_fn`): the per-client
    adaptive k enters as data, and the uplink sparsifier is the
    threshold-semantics bisection (ties at the k-th value are kept) — the
    CUDA kernel with ``use_kernels=True``, its plain version otherwise.  A
    ``k = 0`` straggler's row is zeroed by the sparsifier and dropped on the
    host; byte accounting uses the host-side k, so the ledger is identical
    to the other engines'.  ``shard_clients=True`` runs the client phase on
    each rank's block of the cohort and gathers it
    (:mod:`repro_torch.sharding`); the dense uplink leaves the round
    whole, on every rank."""

    name = "fused"

    def __init__(
        self,
        clients: list[Client],
        cfg: ModelConfig,
        *,
        num_classes: int,
        lr: float = 1e-3,
        distill_lr: float = 1e-3,
        temperature: float = 2.0,
        lam: float = 0.03,
        local_steps: int = 4,
        distill_steps: int = 2,
        restrict_to_support: bool = False,
        value_bits: int = 16,
        k_min: int = 1,
        last_only: bool = True,
        shard_clients: bool = False,
        use_kernels: bool = False,
        quantize_wire: bool = False,
        compute_dtype: str = "float32",
        fleet_store="device",
    ):
        super().__init__(clients, cfg, local_steps=local_steps, value_bits=value_bits,
                         k_min=k_min, last_only=last_only, quantize_wire=quantize_wire,
                         fleet_store=fleet_store, shard_clients=shard_clients)

        def fused(n_distill: int):
            return fed_steps.make_fused_round_fn(
                cfg, num_classes, lr=lr, distill_lr=distill_lr, temperature=temperature,
                lam=lam, restrict_to_support=restrict_to_support, local_steps=local_steps,
                distill_steps=n_distill, last_only=last_only, use_kernels=use_kernels,
                compute_dtype=compute_dtype,
            )

        self._fused_warm = fused(distill_steps)
        self._fused_cold = fused(0)  # round 0: no broadcast knowledge yet

    def run_round(
        self,
        sel: Sequence[int],
        pub_tokens: torch.Tensor,
        bcast: BroadcastState | None,
        states: BatchedChannelState | Sequence[ChannelState],
        *,
        adaptive_k: bool,
        send_h: bool,
    ) -> ClientPhase:
        sel = check_unique_cohort(sel)
        cohort = [self.clients[i] for i in sel]
        states = list(states)
        batches = self._stacked_batches(cohort, step_major=False)  # (C, S, ...)
        shard, idx, lora, frozen, opt, batches = self._fetch_cohort(sel, batches)
        n_samples = int(pub_tokens.shape[0])
        ks = self._budgets(states, n_samples, adaptive_k, len(cohort), send_h)

        if bcast is not None:
            step, g_tokens, g_logits, g_h = self._fused_warm, bcast.tokens, bcast.logits, bcast.h
        else:  # the g_* operands are unused by the cold round
            step, g_tokens, g_logits, g_h = self._fused_cold, pub_tokens, None, None
        lora, opt, dense_all, h_all = step(
            lora, frozen, opt, g_tokens, g_logits, g_h, batches, pub_tokens, ks, shard=shard
        )

        active, payloads, rank = self._upload_manifests(cohort, states, ks, n_samples, send_h)
        dense, h = self._dense_uplink(active, ks, dense_all, h_all, rank)
        self._store.commit(idx, lora, opt)
        return ClientPhase(payloads=payloads, ks=ks, dense=dense, h=h)
