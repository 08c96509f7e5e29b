"""Family-bucketed engines for mixed fleets — the port of
``repro/fed/engines/hetero.py``'s ``HeteroClientEngine`` and
``HeteroFusedE2EEngine.run_round``.

The fleet is cut into family buckets (:mod:`repro_torch.fed.cohort`), each
with a fleet store of its own, and a round runs one client phase per
bucket with a selected client; the uploads merge in the shared
vocab-indexed logit space, in cohort order, so the server reads them as it
reads a homogeneous cohort's, and the ledger is the sequential engine's
over the same clients.  Checkpoint trees and shards carry one ``bucket{i}``
entry (or file prefix) per bucket, as the reference's do.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.core.topk import concat_wires, take_wire_rows
from repro_torch.fed import steps as fed_steps
from repro_torch.fed.client import Client
from repro_torch.fed.cohort import (
    fleet_index, partition_fleet, split_cohort, validate_family_contracts,
)
from repro_torch.fed.engines.base import (
    BroadcastState,
    ClientPhase,
    _ServerOwnerMixin,
    check_unique_cohort,
    k_cap_bucket,
    not_carried,
)
from repro_torch.fed.engines.batched import BatchedEngine, _FleetEngine
from repro_torch.fed.engines.fused import FusedEngine

__all__ = ["HeteroClientEngine", "HeteroFusedE2EEngine"]


class _BucketsMixin:
    """The fleet plumbing over the buckets' engines ``self._engines``:
    client reads routed through the fleet index, checkpoint trees and
    shards one ``bucket{i}`` per bucket, and the next-round hint forwarded
    bucket by bucket, as the round will fetch it."""

    @property
    def device(self) -> torch.device:
        return self._engines[0].device

    @property
    def store_kind(self) -> str:
        return self._engines[0].store_kind

    def client_params(self, cid: int) -> dict:
        bi, local = self._where[int(cid)]
        return self._engines[bi].client_params(local)

    def fleet_state(self) -> dict:
        return {f"bucket{i}": e.fleet_state() for i, e in enumerate(self._engines)}

    def load_fleet_state(self, state: dict) -> None:
        for i, e in enumerate(self._engines):
            e.load_fleet_state(state[f"bucket{i}"])

    def save_fleet_shards(self, dir_path: str) -> None:
        """Every bucket's fleet into one directory, ``bucket{i}_*`` files."""
        for i, e in enumerate(self._engines):
            e.save_fleet_shards(dir_path, prefix=f"bucket{i}")

    def load_fleet_shards(self, dir_path: str) -> None:
        for i, e in enumerate(self._engines):
            e.load_fleet_shards(dir_path, prefix=f"bucket{i}")

    def prefetch_cohort(self, sel: Sequence[int]) -> None:
        for b, _pos, local in split_cohort(self.buckets, sel):
            self._engines[b.index].prefetch_cohort(local)


class HeteroClientEngine(_BucketsMixin):
    """The client phase of ``batched`` or ``fused`` for a mixed fleet: one
    sub-engine of that kind per family bucket, whose transmitters' dense
    rows (and projections) are merged back into cohort order, so the
    Server's aggregation reads one ``(N, P, V)`` stack."""

    name = "hetero"

    def __init__(self, kind: str, clients: list[Client], **kwargs):
        self.buckets = partition_fleet(clients)
        validate_family_contracts(self.buckets)
        self.kind = kind
        sub_cls = {"batched": BatchedEngine, "fused": FusedEngine}[kind]
        self._engines = [sub_cls([clients[i] for i in b.client_ids], b.cfg, **kwargs)
                         for b in self.buckets]
        self._where = fleet_index(self.buckets)

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
        states = list(states)
        ks = [0] * len(sel)
        merged = []  # (cohort position, dense row, h row, payload), transmitters only
        for b, pos, local in split_cohort(self.buckets, sel):
            phase = self._engines[b.index].run_round(
                local, pub_tokens, bcast, [states[p] for p in pos],
                adaptive_k=adaptive_k, send_h=send_h,
            )
            for p, k in zip(pos, phase.ks):
                ks[p] = k
            for j, p in enumerate(p for p, k in zip(pos, phase.ks) if k > 0):
                merged.append((p, None if phase.dense is None else phase.dense[j],
                               None if phase.h is None else phase.h[j], phase.payloads[j]))
        merged.sort(key=lambda entry: entry[0])
        dense = torch.stack([m[1] for m in merged]) if merged else None
        h = torch.stack([m[2] for m in merged]) if merged and merged[0][2] is not None else None
        return ClientPhase(payloads=[m[3] for m in merged], ks=ks, dense=dense, h=h)


class HeteroFusedE2EEngine(_BucketsMixin, _ServerOwnerMixin):
    """The whole round of a mixed fleet: one client-phase call per family
    bucket (:func:`repro_torch.fed.steps.make_bucket_client_phase_fn`, each
    bucket's state in its own fleet store), the buckets' wires concatenated
    into one union wire at one cohort-wide ``k_cap`` and permuted back into
    cohort order (the projections likewise), then one family-blind server
    phase (:func:`repro_torch.fed.steps.make_server_phase_fn`).  The
    multi-round block, ``run_rounds``, is a later slice's work."""

    name = "hetero_fused_e2e"

    def __init__(
        self,
        clients: list[Client],
        *,
        server,
        num_classes: int,
        lr: float = 1e-3,
        distill_lr: float = 1e-3,
        temperature: float = 2.0,
        lam: float = 0.03,
        local_steps: int = 4,
        distill_steps: int = 2,
        server_distill_steps: int = 12,
        aggregation: str = "adaptive",
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
        if shard_clients:  # the reference's own refusal
            raise NotImplementedError(
                "shard_clients is not supported for heterogeneous fleets yet: each family "
                "bucket would need its own divisible client-axis placement"
            )
        self.buckets = partition_fleet(clients)
        validate_family_contracts(self.buckets, server_cfg=server.cfg)
        self._where = fleet_index(self.buckets)
        self.vocab = self.buckets[0].cfg.vocab_size
        self.last_only = last_only
        self.quantize_wire = quantize_wire
        # one fleet-state holder per bucket: store, budgets, manifests, batches
        self._engines = [
            _FleetEngine([clients[i] for i in b.client_ids], b.cfg, local_steps=local_steps,
                         value_bits=value_bits, k_min=k_min, last_only=last_only,
                         quantize_wire=quantize_wire, fleet_store=fleet_store)
            for b in self.buckets
        ]
        self._num_classes = num_classes
        self._phase_kwargs = dict(
            lr=lr, distill_lr=distill_lr, temperature=temperature, lam=lam,
            restrict_to_support=restrict_to_support, local_steps=local_steps,
            distill_steps=distill_steps, last_only=last_only, quantize=quantize_wire,
            compute_dtype=compute_dtype,
        )
        self._server_kwargs = dict(
            distill_lr=distill_lr, temperature=temperature, lam=lam,
            restrict_to_support=restrict_to_support, server_distill_steps=server_distill_steps,
            aggregation=aggregation, last_only=last_only, use_kernels=use_kernels,
            compute_dtype=compute_dtype,
        )
        self._init_server_state(server)

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
        states = list(states)
        n_samples = int(pub_tokens.shape[0])
        parts = split_cohort(self.buckets, sel)

        # budgets first, in cohort order: one k_cap for every bucket's wire
        ks = [0] * len(sel)
        budgets = []
        for b, pos, _local in parts:
            ks_b = self._engines[b.index]._budgets([states[p] for p in pos], n_samples,
                                                   adaptive_k, len(pos), send_h)
            budgets.append(ks_b)
            for p, k in zip(pos, ks_b):
                ks[p] = k
        k_cap = k_cap_bucket(ks, self.vocab)
        if bcast is not None:
            g_tokens, g_logits, g_h, g_valid = bcast.tokens, bcast.logits, bcast.h, True
        else:
            (g_tokens, g_logits, g_h), g_valid = self._cold_broadcast(pub_tokens, n_samples), False

        # -- the client phase: one call per family bucket --
        wires, h_parts, order, payloads_by_pos = [], [], [], {}
        for (b, pos, local), ks_b in zip(parts, budgets):
            be = self._engines[b.index]
            cohort = [be.clients[j] for j in local]
            b_states = [states[p] for p in pos]
            batches = be._stacked_batches(cohort, step_major=False)
            idx, lora, frozen, opt = be._store.fetch(local)
            fn = fed_steps.make_bucket_client_phase_fn(b.cfg, self._num_classes, k_cap=k_cap,
                                                       **self._phase_kwargs)
            lora, opt, wire, h = fn(
                lora, frozen, opt, g_tokens, g_logits, g_h, g_valid, batches, pub_tokens,
                torch.as_tensor(ks_b, dtype=torch.int32, device=be.device),
            )
            be._store.commit(idx, lora, opt)
            _active, payloads, _rank = be._upload_manifests(cohort, b_states, ks_b, n_samples,
                                                            send_h)
            tx = iter(payloads)
            payloads_by_pos.update({p: next(tx) for p, k in zip(pos, ks_b) if k > 0})
            wires.append(wire)
            h_parts.append(h)
            order.extend(pos)

        # -- one union wire in cohort order, then one family-blind server phase --
        inv = np.argsort(np.asarray(order))
        union = take_wire_rows(concat_wires(wires), inv)
        h_all = None
        if h_parts[0] is not None:
            h_all = torch.cat(h_parts)[torch.as_tensor(inv, device=self.device)]
        server_phase = fed_steps.make_server_phase_fn(self.server.cfg, send_h=send_h,
                                                      **self._server_kwargs)
        (self._s_lora, self._s_opt, b_logits, b_h, self._d_loss) = server_phase(
            self._s_lora, self._s_frozen, self._s_opt, union, h_all, ks, pub_tokens)
        self._b_tokens, self._b_logits, self._b_h = pub_tokens, b_logits, b_h

        tx = [p for p in range(len(sel)) if ks[p] > 0]
        return ClientPhase(payloads=[payloads_by_pos[p] for p in tx], ks=ks,
                           sparse=take_wire_rows(union, tx) if tx else None)

    def run_rounds(self, *args, **kwargs):
        raise not_carried("scan_rounds on a mixed fleet (HeteroFusedE2EEngine.run_rounds)",
                          "other model families and mixed fleets")
