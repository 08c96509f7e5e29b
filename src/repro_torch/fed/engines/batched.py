"""The batched (per-phase) cohort engine and the fleet plumbing every
engine inherits — the port of ``repro/fed/engines/batched.py``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.core.topk import topk_mask_batch
from repro_torch.fed import steps as fed_steps
from repro_torch.fed.client import Client, make_upload_payload
from repro_torch.fed.engines.base import (
    BroadcastState,
    ClientPhase,
    check_unique_cohort,
    cohort_budgets,
    fake_quant_dense,
    shared_frozen_backbone,
)
from repro_torch.fed.store import make_fleet_store
from repro_torch.lora import merge_lora, split_lora

__all__ = ["BatchedEngine"]


class _FleetEngine:
    """The host plumbing every engine shares: the fleet's LoRA and optimizer
    state in a fleet store (``fleet_store``: ``"device"``, ``"host"`` or a
    built :class:`repro_torch.fed.store.FleetStore`; a round fetches the
    cohort's rows and commits the advanced rows back), the cohort's budgets,
    upload manifests and private batches.  The engine owns the client
    parameters from construction on: read them back through
    :meth:`client_params`.  Each engine builds the step functions it runs.

    ``shard_clients`` (the fused engines) places the cohort over the ranks
    of the default process group (:func:`repro_torch.sharding.cohort_mesh`):
    each rank fetches and computes its block of the cohort, and every rank
    commits the whole gathered cohort, so every rank holds the same fleet."""

    def __init__(
        self,
        clients: list[Client],
        cfg: ModelConfig,
        *,
        local_steps: int,
        value_bits: int,
        k_min: int,
        last_only: bool,
        quantize_wire: bool,
        fleet_store="device",
        shard_clients: bool = False,
    ):
        self.clients = clients
        self.cfg = cfg
        self.local_steps = local_steps
        self.value_bits = value_bits
        self.k_min = k_min
        self.last_only = last_only
        self.quantize_wire = quantize_wire
        loras, frozens = zip(*(split_lora(c.params) for c in clients))
        self._store = make_fleet_store(fleet_store, loras=loras, frozens=frozens,
                                       shared=shared_frozen_backbone(frozens),
                                       state_dtype=cfg.optimizer_state_dtype)
        self._shared = self._store.shared
        del loras, frozens
        for c in clients:  # the store owns the fleet state from here on
            c.params = c.opt = None
        self.shard_clients = shard_clients
        self._mesh = sharding.cohort_mesh(self.device) if shard_clients else None

    @property
    def device(self) -> torch.device:
        return self._store.device

    @property
    def store_kind(self) -> str:
        return self._store.kind

    def prefetch_cohort(self, sel: Sequence[int]) -> None:
        """Hint the NEXT round's cohort: a host store starts staging it onto
        the device now, under the current round's compute (a no-op on the
        device store).  Under ``shard_clients`` it stages exactly the rows
        this rank will fetch, its block of the padded cohort, or the hint
        misses."""
        sel = list(sel)
        if sel:
            sel, _ = self._pad_cohort(self._cohort_shard(len(sel)), sel, {})
        self._store.prefetch(sel)

    # -- shard_clients: the cohort over the ranks ---------------------------
    def _cohort_shard(self, n: int) -> sharding.CohortShard | None:
        """This rank's share of a cohort of ``n``; ``None`` unsharded."""
        return None if self._mesh is None else sharding.CohortShard.of(self._mesh, n)

    def _pad_cohort(self, shard: sharding.CohortShard | None, sel: Sequence[int], batches: dict):
        """The masked ``k = 0`` padding contract, in one place (the fused
        round, the e2e round and the e2e block): a cohort that does not
        divide the world size is extended with duplicate rows of ``sel[0]``
        that ride at ``k = 0``.  Their batches are copies, so ``sel[0]``'s
        rng stream advances once, and the gather drops their rows
        (:meth:`repro_torch.sharding.CohortShard.gather`) before anything
        reads them.  Returns this rank's block of the padded cohort's ids
        and of its batches; ``(sel, batches)`` unsharded."""
        if shard is None:
            return list(sel), batches
        return (shard.block(shard.padded(list(sel))),
                {k: shard.block(shard.padded(v)) for k, v in batches.items()})

    def _fetch_cohort(self, sel: Sequence[int], batches: dict):
        """``(shard, idx, lora, frozen, opt, batches)``: the rows this rank
        computes, fetched from the store, and ``idx``, the ids the round
        commits: the cohort's, which under ``shard_clients`` are the whole
        real cohort's (the gathered rows), not this rank's block."""
        shard = self._cohort_shard(len(sel))
        block, batches = self._pad_cohort(shard, sel, batches)
        idx, lora, frozen, opt = self._store.fetch(block)
        if shard is not None:
            idx = torch.as_tensor(list(sel), device=self.device)
        return shard, idx, lora, frozen, opt, batches

    def client_params(self, cid: int) -> dict:
        """One client's merged parameters (for evaluation)."""
        return merge_lora(*self._store.client_row(cid))

    # -- checkpoints: the store's state, in the reference's layout ---------
    def fleet_state(self) -> dict:
        """The fleet as one checkpointable tree ``{"lora", "opt",
        "frozen"}``, the backbone included, so a checkpoint stands alone."""
        return self._store.state_dict()

    def load_fleet_state(self, state: dict) -> None:
        self._store.load_state_dict(state)

    def save_fleet_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        """The fleet as per-client-range shards, never as one tree."""
        self._store.save_shards(dir_path, prefix=prefix)

    def load_fleet_shards(self, dir_path: str, *, prefix: str = "fleet") -> None:
        self._store.load_shards(dir_path, prefix=prefix)

    def _budgets(self, states, n_samples: int, adaptive_k: bool, n_cohort: int,
                 send_h: bool = False) -> list[int]:
        return cohort_budgets(
            states, self.cfg, n_samples, adaptive_k, n_cohort, send_h,
            value_bits=self.value_bits, k_min=self.k_min, quantize_wire=self.quantize_wire,
        )

    def _upload_manifests(self, cohort, states, ks, n_samples: int, send_h: bool):
        """(active indices, payload manifests, lora rank or None) for the
        k > 0 transmitters — dropped stragglers contribute nothing."""
        active = [i for i, k in enumerate(ks) if k > 0]
        payloads, rank = [], None
        for i in active:
            payload, rank = make_upload_payload(
                self.cfg, cohort[i].client_id, n_samples, ks[i], send_h=send_h,
                value_bits=self.value_bits, snr_db=states[i].snr_db,
                quantize=self.quantize_wire,
            )
            payloads.append(payload)
        return active, payloads, rank

    def _stacked_batches(self, cohort, *, step_major: bool):
        """Each client's next ``local_steps`` private batches from its own
        rng: a list of ``{tokens (C, B, L), labels (C, B)}`` per step, or one
        client-major ``{tokens (C, S, B, L), labels (C, S, B)}``."""
        per_client = [c.next_train_batches(self.local_steps) for c in cohort]
        keys, steps = per_client[0][0].keys(), range(self.local_steps)
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        if step_major:
            return [{key: as_t(np.stack([b[s][key] for b in per_client])) for key in keys}
                    for s in steps]
        return {key: as_t(np.stack([np.stack([b[s][key] for s in steps]) for b in per_client]))
                for key in keys}

    def _dense_uplink(self, active, ks, dense_all, h_all, rank):
        """The transmitters' rows of the cohort's dense top-k stack (int8-coded
        under ``quantize_wire``) and of its projections; (None, None) when
        every client dropped."""
        if not active:
            return None, None
        take = None if len(active) == len(ks) else torch.as_tensor(active, device=self.device)
        dense = dense_all if take is None else dense_all[take]
        if self.quantize_wire:
            dense = fake_quant_dense(dense)
        h = None
        if rank is not None and h_all is not None:
            h = h_all if take is None else h_all[take]
        return dense, h


class BatchedEngine(_FleetEngine):
    """The whole cohort advances through each phase of the round — client
    distillation, local fine-tuning, public inference — as one step over a
    leading client axis; the uplink is the exact per-client top-k
    (:func:`repro_torch.core.topk.topk_mask_batch`) as a dense stack."""

    name = "batched"

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
        quantize_wire: bool = False,
        fleet_store="device",
    ):
        super().__init__(clients, cfg, local_steps=local_steps, value_bits=value_bits,
                         k_min=k_min, last_only=last_only, quantize_wire=quantize_wire,
                         fleet_store=fleet_store)
        self.distill_steps = distill_steps
        self._train = fed_steps.make_batched_finetune_step(
            cfg, num_classes, lr=lr, last_only=last_only
        )
        self._distill = fed_steps.make_batched_distill_step(
            cfg, lr=distill_lr, temperature=temperature, lam=lam,
            restrict_to_support=restrict_to_support, last_only=last_only,
        )
        self._public = fed_steps.make_batched_public_logits(cfg, last_only=last_only)

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
        idx, lora, frozen, opt = self._store.fetch(sel)

        # -- lines 5-7: cohort distillation against the shared broadcast --
        if bcast is not None:
            for _ in range(self.distill_steps):
                lora, opt, _ = self._distill(lora, frozen, opt, bcast.tokens, bcast.logits, bcast.h)
        # -- line 8: local fine-tuning, one cohort update per step --
        for batch in self._stacked_batches(cohort, step_major=True):
            lora, opt, _ = self._train(lora, frozen, opt, batch)

        # -- lines 9-11: public inference + per-client adaptive top-k --
        n_samples = int(pub_tokens.shape[0])
        ks = self._budgets(states, n_samples, adaptive_k, len(cohort), send_h)
        logits, h = self._public(lora, frozen, pub_tokens)  # (C, P, V), (C, P, r)|None
        active, payloads, rank = self._upload_manifests(cohort, states, ks, n_samples, send_h)
        dense, h_out = self._dense_uplink(active, ks, topk_mask_batch(logits, ks), h, rank)

        self._store.commit(idx, lora, opt)
        return ClientPhase(payloads=payloads, ks=ks, dense=dense, h=h_out)
