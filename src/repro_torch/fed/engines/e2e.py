"""The whole-round engine — the port of ``repro/fed/engines/e2e.py``'s
``FusedE2EEngine``: ``run_round`` and the multi-round ``run_rounds``.

The fleet's state lives in the engine's fleet store; a round gathers the
cohort's rows, runs the client phase and the server phase as
one function call with the sparse wire between them, and writes the
advanced rows back.

``run_rounds`` is the reference's one compiled ``lax.scan`` over R rounds.
The port splits it in two: :meth:`FusedE2EEngine.stage_rounds` does all the
host work first (budgets, manifests, one ``k_cap`` for the block, every
round's batches, public tokens, budgets and cohort indices copied to the
device), then :meth:`FusedE2EEngine.run_block` runs the R round bodies
back to back, from the first launch to the end of the last round with no
call that waits for the device; the per-round taps are copied to the host
once, after the block.

``shard_clients=True`` runs each round's client phase on this rank's block
of the padded cohort, gathers the block's state, wire and projections on
every rank (:mod:`repro_torch.sharding`) and runs the server phase,
replicated, on the real cohort, in ``run_round`` and in the block alike.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.core.protocol import UplinkPayload
from repro_torch.fed import steps as fed_steps
from repro_torch.fed.client import Client
from repro_torch.fed.engines.base import (
    BroadcastState,
    ClientPhase,
    _ServerOwnerMixin,
    _channel_scan_ops,
    check_unique_cohort,
    k_cap_bucket,
)
from repro_torch.fed.engines.batched import _FleetEngine

__all__ = ["FusedE2EEngine", "StagedRounds"]


@dataclasses.dataclass
class StagedRounds:
    """A block of R rounds staged by :meth:`FusedE2EEngine.stage_rounds`:
    the host's accounting, and every operand of the block on the device."""

    ks: list[list[int]]  # per round, each cohort client's k (host ints)
    payloads: list[list[UplinkPayload]]  # per round, the transmitters' manifests
    k_cap: int  # one wire width for the whole block
    send_h: bool
    sels: list[list[int]]  # per round, the cohort's client ids
    idx: list[torch.Tensor]  # per round, the cohort's fleet rows, (C,) int64
    # per round, the rows this rank fetches and computes: ``idx`` unsharded,
    # its block of the padded cohort under ``shard``
    fetch_idx: list[torch.Tensor]
    ks_dev: torch.Tensor  # (R, C) int32, the budgets as data
    pubs: list[torch.Tensor]  # per round, the public batch (P, L)
    batches: list[dict]  # per round, {tokens (C, S, B, L), labels (C, S, B)}
    eval_tokens: torch.Tensor | None = None  # (N, L), N a multiple of EVAL_BATCH
    eval_labels: torch.Tensor | None = None
    # a channel scenario's operands on the device (``_channel_scan_ops``)
    chan: tuple | None = None
    shard: object = None  # the block's CohortShard (shard_clients), else None


class FusedE2EEngine(_ServerOwnerMixin, _FleetEngine):
    """Client phase and server phase of a round as one function call, with
    the uplink crossing to the server as the sparse wire."""

    name = "fused_e2e"

    def __init__(
        self,
        clients: list[Client],
        cfg: ModelConfig,
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
        super().__init__(clients, cfg, local_steps=local_steps, value_bits=value_bits,
                         k_min=k_min, last_only=last_only, quantize_wire=quantize_wire,
                         fleet_store=fleet_store, shard_clients=shard_clients)
        self._fn_kwargs = dict(
            lr=lr, distill_lr=distill_lr, temperature=temperature, lam=lam,
            restrict_to_support=restrict_to_support, local_steps=local_steps,
            distill_steps=distill_steps, server_distill_steps=server_distill_steps,
            aggregation=aggregation, last_only=last_only, use_kernels=use_kernels,
            quantize=quantize_wire, compute_dtype=compute_dtype,
        )
        self._num_classes = num_classes
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
        cohort = [self.clients[i] for i in sel]
        states = list(states)
        batches = self._stacked_batches(cohort, step_major=False)  # (C, S, ...)
        shard, idx, lora, frozen, opt, batches = self._fetch_cohort(sel, batches)
        n_samples = int(pub_tokens.shape[0])
        ks = self._budgets(states, n_samples, adaptive_k, len(cohort), send_h)
        k_cap = k_cap_bucket(ks, self.cfg.vocab_size)
        if bcast is not None:
            g_tokens, g_logits, g_h, g_valid = bcast.tokens, bcast.logits, bcast.h, True
        else:
            (g_tokens, g_logits, g_h), g_valid = self._cold_broadcast(pub_tokens, n_samples), False

        fn = fed_steps.make_fused_e2e_round_fn(
            self.cfg, self.server.cfg, self._num_classes, k_cap=k_cap, send_h=send_h,
            **self._fn_kwargs,
        )
        (lora, opt, self._s_lora, self._s_opt, wire, b_logits, b_h, self._d_loss) = fn(
            lora, frozen, opt, self._s_lora, self._s_frozen, self._s_opt,
            g_tokens, g_logits, g_h, g_valid, batches, pub_tokens, ks, shard=shard,
        )
        self._b_tokens, self._b_logits, self._b_h = pub_tokens, b_logits, b_h

        active, payloads, _rank = self._upload_manifests(cohort, states, ks, n_samples, send_h)
        sparse = None
        if active:
            take = torch.as_tensor(active, device=self.device)
            fields = {f: getattr(wire, f)[take] for f in wire._fields if f != "vocab"}
            sparse = type(wire)(vocab=wire.vocab, **fields)
        self._store.commit(idx, lora, opt)
        return ClientPhase(payloads=payloads, ks=ks, sparse=sparse)

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
    ) -> StagedRounds:
        """The block's host work, in the per-round path's order: each
        round's budgets, upload manifests and private batches (each selected
        client's rng advances as ``run_round`` advances it), then one
        ``k_cap`` for every k of the block; every operand copied to the
        device, a ``channel_scan``'s
        (:meth:`~repro_torch.core.channel.ChannelSimulator.scan_channel_inputs`)
        among them."""
        sels, eval_tokens, eval_labels = self._block_checks(sels, eval_tokens, eval_labels)
        n_cohort = len(sels[0]) if sels else 0
        all_ks, all_payloads, batches, blocks = [], [], [], []
        n_samples = int(pubs[0].shape[0]) if sels else 0
        shard = self._cohort_shard(n_cohort) if sels else None
        for sel, states in zip(sels, states_per_round):
            cohort = [self.clients[i] for i in sel]
            states = list(states)
            ks = self._budgets(states, n_samples, adaptive_k, len(cohort), send_h)
            _active, payloads, _rank = self._upload_manifests(cohort, states, ks, n_samples,
                                                              send_h)
            all_ks.append(ks)
            all_payloads.append(payloads)
            block, batch = self._pad_cohort(shard, sel,
                                            self._stacked_batches(cohort, step_major=False))
            blocks.append(block)
            batches.append(batch)
        idx = [torch.as_tensor(sel, device=self.device) for sel in sels]
        return StagedRounds(
            ks=all_ks, payloads=all_payloads,
            k_cap=k_cap_bucket([k for ks in all_ks for k in ks], self.cfg.vocab_size),
            send_h=send_h, sels=sels, idx=idx,
            fetch_idx=idx if shard is None else [torch.as_tensor(b, device=self.device)
                                                 for b in blocks],
            ks_dev=torch.as_tensor(all_ks, dtype=torch.int32, device=self.device).reshape(
                len(sels), n_cohort),
            pubs=[torch.as_tensor(p, device=self.device) for p in pubs[:len(sels)]],
            batches=batches, eval_tokens=eval_tokens, eval_labels=eval_labels,
            chan=(None if channel_scan is None or not sels
                  else _channel_scan_ops(channel_scan, len(sels), self.device)),
            shard=shard,
        )

    def run_block(self, staged: StagedRounds) -> dict[str, torch.Tensor]:
        """The R round bodies of a staged block back to back, each the
        fleet gather, the round function, the in-block eval tap (server, and
        the round's first client) and the fleet commit; no call in here
        waits for the device.  Returns the taps as device tensors, one
        ``(R,)`` row each: ``mean_k``, ``distill_loss`` and, with eval data,
        ``server_acc`` and ``client_acc``; with a channel scenario the
        cohort's ``snr_db`` (fp32) and ``outage`` (bool), ``(R, C)``."""
        self._require_device_store()
        rounds = len(staged.ks)
        has_eval = staged.eval_tokens is not None
        if rounds == 0:
            return {}
        fn = fed_steps.make_fused_e2e_round_fn(
            self.cfg, self.server.cfg, self._num_classes, k_cap=staged.k_cap,
            send_h=staged.send_h, **self._fn_kwargs,
        )
        server_eval = fed_steps.make_scan_eval_fn(self.server.cfg, self._num_classes,
                                                  last_only=self.last_only)
        client_eval = fed_steps.make_scan_eval_fn(self.cfg, self._num_classes,
                                                  last_only=self.last_only)
        g_tokens, g_logits, g_h, g_valid = self._block_broadcast(staged.pubs[0])
        taps: dict[str, list] = {"distill_loss": []}
        if has_eval:
            taps.update(server_acc=[], client_acc=[])
        if staged.chan is not None:
            chan_step = fed_steps.make_channel_step_fn()
            ch_z, ch_bad, ch_w, ch_u, ch_base, rho, p_gb, p_bg, fade = staged.chan
            taps.update(snr_db=[], outage=[])
        for r in range(rounds):
            idx = staged.idx[r]
            _, lora, frozen, opt = self._store.fetch(staged.fetch_idx[r])
            (lora, opt, self._s_lora, self._s_opt, _wire, b_logits, b_h, d_loss) = fn(
                lora, frozen, opt, self._s_lora, self._s_frozen, self._s_opt,
                g_tokens, g_logits, g_h, g_valid, staged.batches[r], staged.pubs[r],
                staged.ks[r], staged.ks_dev[r], shard=staged.shard,
            )
            taps["distill_loss"].append(d_loss.float())
            if has_eval:
                taps["server_acc"].append(server_eval(
                    {k: v[0] for k, v in self._s_lora.items()}, self._s_frozen,
                    staged.eval_tokens, staged.eval_labels))
                # the first client's backbone from the store: under shard_clients
                # this rank's block need not hold it
                first_frozen = (frozen if self._shared
                                else self._store.client_row(staged.sels[r][0])[1])
                taps["client_acc"].append(client_eval(
                    {k: v[0] for k, v in lora.items()}, first_frozen,
                    staged.eval_tokens, staged.eval_labels))
            self._store.commit(idx, lora, opt)
            if staged.chan is not None:  # the fleet's channel advances one round
                ch_z, ch_bad, snr = chan_step(ch_z, ch_bad, ch_w[r], ch_u[r], ch_base[r],
                                              rho, p_gb, p_bg, fade)
                taps["snr_db"].append(snr[idx])
                taps["outage"].append(ch_bad[idx])
            g_tokens, g_logits, g_h, g_valid = staged.pubs[r], b_logits, b_h, True
        self._b_tokens, self._b_logits, self._b_h = g_tokens, g_logits, g_h
        self._d_loss = taps["distill_loss"][-1]
        out = {k: torch.stack(v) for k, v in taps.items()}
        out["mean_k"] = staged.ks_dev.float().mean(dim=1)
        return out
