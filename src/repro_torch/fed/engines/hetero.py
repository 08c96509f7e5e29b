"""Family-bucketed engines for mixed fleets — the port of
``repro/fed/engines/hetero.py``'s ``HeteroClientEngine`` and
``HeteroFusedE2EEngine`` (``run_round`` and the multi-round
``run_rounds``).

The fleet is cut into family buckets (:mod:`repro_torch.fed.cohort`), each
with a fleet store of its own, and a round runs one client phase per
bucket with a selected client; the uploads merge in the shared
vocab-indexed logit space, so the server reads them as it reads a
homogeneous cohort's, and the ledger is the sequential engine's over the
same clients.  Checkpoint trees and shards carry one ``bucket{i}`` entry
(or file prefix) per bucket, as the reference's do.

``HeteroFusedE2EEngine.run_rounds`` is the reference's one ``lax.scan``
over R rounds of a mixed fleet, split as the homogeneous block is
(:mod:`repro_torch.fed.engines.e2e`): :meth:`HeteroFusedE2EEngine.
stage_rounds` does the host work first and :meth:`HeteroFusedE2EEngine.
run_block` runs the R round bodies with no call that waits for the
device.  The reference pads every bucket to a static size a round (and
scatters the pads into a scratch row) because a scan needs static shapes;
here each round runs each participating bucket at its own size, so no pad
row exists.  The union wire of a block's round is the buckets' wires
concatenated in bucket order, the reference block's order (the per-round
path permutes it back into cohort order, as the reference's does).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.core.protocol import UplinkPayload
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
    _channel_scan_ops,
    check_unique_cohort,
    k_cap_bucket,
)
from repro_torch.fed.engines.batched import BatchedEngine, _FleetEngine
from repro_torch.fed.engines.fused import FusedEngine

__all__ = ["HeteroClientEngine", "HeteroFusedE2EEngine", "StagedBucketRound",
           "StagedHeteroRounds"]


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
    phase (:func:`repro_torch.fed.steps.make_server_phase_fn`).
    ``run_rounds`` runs R such rounds as one block at one block-wide
    ``k_cap``, with a per-family eval tap."""

    _family_tap = True

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

    def _stage_round(self, sel: Sequence[int], states, n_samples: int, adaptive_k: bool,
                     send_h: bool):
        """One round's host work, in the reference's order: the budgets of
        every participating bucket (cohort order within each), then the
        upload manifests and each selected client's private batches.
        Returns ``(ks in cohort order, the transmitters' manifests in
        cohort order, [(bucket, cohort positions, StagedBucketRound)])``; a
        bucket that sits the round out draws nothing."""
        states = list(states)
        parts = split_cohort(self.buckets, sel)
        ks = [0] * len(sel)
        budgets = []
        for b, pos, _local in parts:
            ks_b = self._engines[b.index]._budgets([states[p] for p in pos], n_samples,
                                                   adaptive_k, len(pos), send_h)
            budgets.append(ks_b)
            for p, k in zip(pos, ks_b):
                ks[p] = k
        by_pos, staged = {}, []
        for (b, pos, local), ks_b in zip(parts, budgets):
            be = self._engines[b.index]
            cohort = [be.clients[j] for j in local]
            _active, payloads, _rank = be._upload_manifests(cohort, [states[p] for p in pos],
                                                            ks_b, n_samples, send_h)
            tx = iter(payloads)
            by_pos.update({p: next(tx) for p, k in zip(pos, ks_b) if k > 0})
            staged.append((b, pos, StagedBucketRound(
                bucket=b.index, local=local, ks=ks_b,
                batches=be._stacked_batches(cohort, step_major=False))))
        return ks, [by_pos[p] for p in sorted(by_pos)], staged

    def _client_phase_fn(self, cfg, k_cap: int):
        return fed_steps.make_bucket_client_phase_fn(cfg, self._num_classes, k_cap=k_cap,
                                                     **self._phase_kwargs)

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
        n_samples = int(pub_tokens.shape[0])
        # budgets first: one k_cap for every bucket's wire
        ks, payloads, parts = self._stage_round(sel, states, n_samples, adaptive_k, send_h)
        k_cap = k_cap_bucket(ks, self.vocab)
        if bcast is not None:
            g_tokens, g_logits, g_h, g_valid = bcast.tokens, bcast.logits, bcast.h, True
        else:
            (g_tokens, g_logits, g_h), g_valid = self._cold_broadcast(pub_tokens, n_samples), False

        # -- the client phase: one call per family bucket --
        wires, h_parts, order = [], [], []
        for b, pos, part in parts:
            be = self._engines[b.index]
            idx, lora, frozen, opt = be._store.fetch(part.local)
            lora, opt, wire, h = self._client_phase_fn(b.cfg, k_cap)(
                lora, frozen, opt, g_tokens, g_logits, g_h, g_valid, part.batches, pub_tokens,
                torch.as_tensor(part.ks, dtype=torch.int32, device=be.device),
            )
            be._store.commit(idx, lora, opt)
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
        return ClientPhase(payloads=payloads, ks=ks,
                           sparse=take_wire_rows(union, tx) if tx else None)

    # -- the multi-round block: run_rounds (the mixin's) = stage_rounds + run_block
    def stage_rounds(
        self,
        sels: Sequence[Sequence[int]],
        pubs: Sequence[torch.Tensor],
        states_per_round: Sequence,
        *,
        adaptive_k: bool,
        send_h: bool,
        eval_tokens: torch.Tensor | None = None,
        eval_labels: torch.Tensor | None = None,
        channel_scan: dict | None = None,
    ) -> StagedHeteroRounds:
        """The block's host work, the reference's host pre-pass in its
        order: each round's buckets, budgets, upload manifests and the
        selected clients' private batches (:meth:`_stage_round`; a family
        that sits a round out draws none), the bucket of the round's first
        selected client, then one ``k_cap`` for every k of the block; every
        operand copied to the device once, a ``channel_scan``'s among
        them, with the cohorts' fleet ids for its SNR and outage taps."""
        sels, eval_tokens, eval_labels = self._block_checks(sels, eval_tokens, eval_labels)
        n_samples = int(pubs[0].shape[0]) if sels else 0
        all_ks, all_payloads, parts, first_bucket = [], [], [], []
        for sel, states in zip(sels, states_per_round):
            ks, payloads, staged = self._stage_round(sel, states, n_samples, adaptive_k, send_h)
            all_ks.append(ks)
            all_payloads.append(payloads)
            for _b, _pos, part in staged:  # the store's rows, staged on the device
                part.idx = torch.as_tensor(part.local, device=self.device)
            parts.append([part for _b, _pos, part in staged])
            first_bucket.append(next(b.index for b, pos, _part in staged if 0 in pos))
        union_ks = [[k for part in round_parts for k in part.ks] for round_parts in parts]
        return StagedHeteroRounds(
            ks=all_ks, payloads=all_payloads,
            k_cap=k_cap_bucket([k for ks in all_ks for k in ks], self.vocab),
            send_h=send_h, parts=parts, union_ks=union_ks,
            ks_dev=torch.as_tensor(union_ks, dtype=torch.int32, device=self.device).reshape(
                len(sels), len(sels[0]) if sels else 0),
            first_bucket=first_bucket,
            sel_dev=[torch.as_tensor(sel, device=self.device) for sel in sels],
            pubs=[torch.as_tensor(p, device=self.device) for p in pubs[:len(sels)]],
            eval_tokens=eval_tokens, eval_labels=eval_labels,
            chan=(None if channel_scan is None or not sels
                  else _channel_scan_ops(channel_scan, len(sels), self.device)),
        )

    def run_block(self, staged: StagedHeteroRounds) -> dict[str, torch.Tensor]:
        """The R round bodies of a staged block back to back; no call in
        here waits for the device.  A round: each participating bucket's
        rows fetched, its client phase, its rows committed; the union wire
        (buckets in order) through one server phase; the eval tap (the
        server, then each family's first selected client after its commit,
        or its local client 0 when the family sat out); the fleet's channel
        one step on.  Returns the taps as device tensors: ``mean_k``,
        ``distill_loss`` ``(R,)`` and, with eval data, ``server_acc`` and
        ``client_acc`` ``(R,)`` and ``family_client_acc`` ``(R, F)``; with a
        channel scenario the cohort's ``snr_db`` and ``outage``, ``(R, C)``."""
        self._require_device_store()
        rounds = len(staged.ks)
        if rounds == 0:
            return {}
        has_eval = staged.eval_tokens is not None
        fns = [self._client_phase_fn(b.cfg, staged.k_cap) for b in self.buckets]
        server_phase = fed_steps.make_server_phase_fn(self.server.cfg, send_h=staged.send_h,
                                                      **self._server_kwargs)
        g_tokens, g_logits, g_h, g_valid = self._block_broadcast(staged.pubs[0])
        taps: dict[str, list] = {"distill_loss": []}
        if has_eval:
            server_eval = fed_steps.make_scan_eval_fn(self.server.cfg, self._num_classes,
                                                      last_only=self.last_only)
            family_evals = [fed_steps.make_scan_eval_fn(b.cfg, self._num_classes,
                                                        last_only=self.last_only)
                            for b in self.buckets]
            taps.update(server_acc=[], client_acc=[], family_client_acc=[])
        if staged.chan is not None:
            chan_step = fed_steps.make_channel_step_fn()
            ch_z, ch_bad, ch_w, ch_u, ch_base, rho, p_gb, p_bg, fade = staged.chan
            taps.update(snr_db=[], outage=[])
        for r in range(rounds):
            wires, h_parts, at = [], [], 0
            for part in staged.parts[r]:
                store = self._engines[part.bucket]._store
                _, lora, frozen, opt = store.fetch(part.idx)
                lora, opt, wire, h = fns[part.bucket](
                    lora, frozen, opt, g_tokens, g_logits, g_h, g_valid, part.batches,
                    staged.pubs[r], staged.ks_dev[r, at:at + len(part.ks)])
                store.commit(part.idx, lora, opt)
                wires.append(wire)
                h_parts.append(h)
                at += len(part.ks)
            h_all = None if h_parts[0] is None else torch.cat(h_parts)
            (self._s_lora, self._s_opt, b_logits, b_h, d_loss) = server_phase(
                self._s_lora, self._s_frozen, self._s_opt, concat_wires(wires), h_all,
                staged.union_ks[r], staged.pubs[r], staged.ks_dev[r])
            taps["distill_loss"].append(d_loss.float())
            if has_eval:
                taps["server_acc"].append(server_eval(
                    {k: v[0] for k, v in self._s_lora.items()}, self._s_frozen,
                    staged.eval_tokens, staged.eval_labels))
                first = {part.bucket: part.local[0] for part in staged.parts[r]}
                fam = [family_evals[f](*self._engines[f]._store.client_row(first.get(f, 0)),
                                       staged.eval_tokens, staged.eval_labels)
                       for f in range(len(self.buckets))]
                taps["family_client_acc"].append(torch.stack(fam))
                taps["client_acc"].append(fam[staged.first_bucket[r]])
            if staged.chan is not None:  # the fleet's channel advances one round
                ch_z, ch_bad, snr = chan_step(ch_z, ch_bad, ch_w[r], ch_u[r], ch_base[r],
                                              rho, p_gb, p_bg, fade)
                taps["snr_db"].append(snr[staged.sel_dev[r]])
                taps["outage"].append(ch_bad[staged.sel_dev[r]])
            g_tokens, g_logits, g_h, g_valid = staged.pubs[r], b_logits, b_h, True
        self._b_tokens, self._b_logits, self._b_h = g_tokens, g_logits, g_h
        self._d_loss = taps["distill_loss"][-1]
        out = {k: torch.stack(v) for k, v in taps.items()}
        out["mean_k"] = staged.ks_dev.float().mean(dim=1)
        return out


@dataclasses.dataclass
class StagedBucketRound:
    """One family bucket's share of a staged round."""

    bucket: int  # the bucket's index
    local: list[int]  # its selected clients' bucket-local ids, in cohort order
    ks: list[int]  # their budgets (host ints)
    batches: dict  # their private batches, {tokens (c, S, B, L), labels (c, S, B)}
    idx: torch.Tensor | None = None  # ``local`` as a device tensor (a block's staging)


@dataclasses.dataclass
class StagedHeteroRounds:
    """A mixed fleet's block of R rounds staged by
    :meth:`HeteroFusedE2EEngine.stage_rounds`: the host's accounting in
    cohort order, and every operand of the block on the device, each round's
    in bucket order (the union wire's)."""

    ks: list[list[int]]  # per round, each cohort client's k
    payloads: list[list[UplinkPayload]]  # per round, the transmitters' manifests
    k_cap: int  # one wire width for the whole block
    send_h: bool
    parts: list[list[StagedBucketRound]]  # per round, its buckets in bucket order
    union_ks: list[list[int]]  # per round, the budgets in bucket order (host ints)
    ks_dev: torch.Tensor  # (R, C) int32: union_ks on the device
    first_bucket: list[int]  # per round, the bucket of the cohort's first client
    sel_dev: list[torch.Tensor]  # per round, the cohort's fleet ids (the channel taps)
    pubs: list[torch.Tensor]  # per round, the public batch (P, L)
    eval_tokens: torch.Tensor | None = None  # (N, L), N a multiple of EVAL_BATCH
    eval_labels: torch.Tensor | None = None
    chan: tuple | None = None  # a channel scenario's operands (``_channel_scan_ops``)
