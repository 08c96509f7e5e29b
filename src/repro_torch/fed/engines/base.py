"""Shared engine plumbing: budget math, the dense uplink's int8 code, round
dataclasses (a multi-round block's trajectory among them), the channel
scenario's operands for a block, the sequential engine and the
server-owner mixin — the port of ``repro/fed/engines/base.py``.

Checkpoint trees (``fleet_state``, ``server_state``) take the reference's
shapes: one model's LoRA and optimizer state have no client axis there,
so the port's client axis of 1 is dropped on the way out and restored on
the way in (an AdamW ``count`` of shape ``()``)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import topk_budget_batch
from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.core.protocol import UplinkPayload, downlink_bits, lora_projection_bits
from repro_torch.core.topk import QUANT_LEVELS, QuantizedWire, SparseWire, densify
from repro_torch.fed.client import Client
from repro_torch.fed.steps import EVAL_BATCH
from repro_torch.fed.store import owned_copy
from repro_torch.lora import merge_lora, split_lora
from repro_torch.optim import AdamWState

__all__ = [
    "BroadcastState",
    "ClientPhase",
    "RoundsTrajectory",
    "SequentialEngine",
    "cohort_budgets",
    "k_cap_bucket",
    "check_unique_cohort",
    "fake_quant_dense",
    "not_carried",
    "one_model_opt",
    "client_axis_opt",
    "shared_frozen_backbone",
]


def not_carried(what: str, item: str) -> NotImplementedError:
    """The error for what the port does not carry yet, naming its item of
    ROADMAP.md's port queue."""
    return NotImplementedError(f"{what} is not carried by the port yet (ROADMAP.md port queue: {item})")


def cohort_budgets(
    states,
    cfg: ModelConfig,
    n_samples: int,
    adaptive_k: bool,
    n_cohort: int,
    send_h: bool = False,
    *,
    value_bits: int = 16,
    k_min: int = 1,
    quantize_wire: bool = False,
) -> list[int]:
    """Per-client adaptive k for a cohort (host-side scalar math).  With
    ``send_h`` the LoRA-projection bits are reserved out of each budget
    first; under ``quantize_wire`` the (value, index) entries cost 8 value
    bits while the projection keeps ``value_bits``."""
    if not adaptive_k:
        return [cfg.vocab_size] * n_cohort
    reserved = (
        lora_projection_bits(n_samples, cfg.lora.rank, value_bits)
        if (send_h and cfg.lora is not None)
        else 0
    )
    return topk_budget_batch(
        states, vocab_size=cfg.vocab_size, num_samples=n_samples,
        value_bits=8 if quantize_wire else value_bits, k_min=k_min, reserved_bits=reserved,
    )


def k_cap_bucket(ks: Sequence[int], vocab: int) -> int:
    """Static wire width for a round: the next power of two >= max(ks),
    clamped to the vocabulary."""
    need = max(list(ks) + [1])
    cap = 1
    while cap < need:
        cap *= 2
    return min(cap, vocab)


def _channel_scan_ops(channel_scan: dict, num_rounds: int, device) -> tuple:
    """Validate a ``scan_channel_inputs`` dict and copy it to ``device``
    for a block of ``num_rounds``: ``(z0, bad0, w, u, base_snr_db, rho,
    p_gb, p_bg, fade_scale)``, fp32 (``bad0`` bool).  Every scenario is
    these operands only; the block runs one channel step for all."""
    try:
        w = np.asarray(channel_scan["w"])
    except KeyError as e:
        raise ValueError(f"channel_scan is missing key {e}") from None
    if w.ndim != 2 or w.shape[0] < num_rounds:
        raise ValueError(
            f"channel_scan covers {w.shape[0] if w.ndim == 2 else '?'} rounds, need {num_rounds} "
            "(ChannelSimulator.scan_channel_inputs(num_rounds))"
        )
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)  # noqa: E731
    return (
        f32(channel_scan["z0"]),
        torch.as_tensor(np.asarray(channel_scan["bad0"], dtype=bool), device=device),
        f32(w[:num_rounds]),
        f32(np.asarray(channel_scan["u"])[:num_rounds]),
        f32(np.asarray(channel_scan["base_snr_db"])[:num_rounds]),
        f32(channel_scan["rho"]),
        f32(channel_scan["p_gb"]),
        f32(channel_scan["p_bg"]),
        f32(channel_scan["fade_scale"]),
    )


def one_model_opt(opt: AdamWState) -> AdamWState:
    """One model's optimizer state on a client axis of 1 -> the
    reference's shapes (``count`` a scalar)."""
    drop = lambda tree: None if tree is None else {k: v[0] for k, v in tree.items()}  # noqa: E731
    return AdamWState(m=drop(opt.m), v=drop(opt.v), count=opt.count[0], master=drop(opt.master))


def client_axis_opt(opt: AdamWState, device) -> AdamWState:
    """The inverse of :func:`one_model_opt`, as owned copies on ``device``."""
    add = lambda tree: None if tree is None else {  # noqa: E731
        k: owned_copy(v, device)[None] for k, v in tree.items()}
    return AdamWState(m=add(opt.m), v=add(opt.v),
                      count=owned_copy(opt.count, device).to(torch.int32).reshape(1),
                      master=add(opt.master))


def fake_quant_dense(dense: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize a densified top-k stack through the int8 wire's
    per-(client, sample)-row symmetric code, as the dense engines do under
    ``quantize_wire``; zeros stay exact zeros.  ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(dense), dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / QUANT_LEVELS, 1.0)
    return torch.clamp(torch.round(dense / scale), -QUANT_LEVELS, QUANT_LEVELS) * scale


def shared_frozen_backbone(frozens: Sequence[dict]) -> bool:
    """True iff every client's frozen dict holds literally the same tensors
    (one W' under per-client LoRA deltas): identity, not value comparison."""
    first = frozens[0]
    return all(
        o.keys() == first.keys() and all(o[k] is first[k] for k in first) for o in frozens[1:]
    )


def check_unique_cohort(sel: Sequence[int]) -> list[int]:
    """A cohort selects each client at most once: the fleet write-back of
    duplicate rows would be ambiguous."""
    out = [int(i) for i in sel]
    if len(set(out)) != len(out):
        dups = sorted({i for i in out if out.count(i) > 1})
        raise ValueError(f"cohort selection contains duplicate client ids {dups}")
    return out


@dataclasses.dataclass(frozen=True)
class BroadcastState:
    """The server's knowledge broadcast carried across rounds."""

    tokens: torch.Tensor  # (P, L) public batch the knowledge was inferred on
    logits: torch.Tensor  # (P, V) global logits K_g
    h: torch.Tensor | None  # (P, r) global LoRA projection h_g
    bits: int  # on-air size of one broadcast to one client


@dataclasses.dataclass
class ClientPhase:
    """One round's client-phase result: ``ks`` for every selected client
    (0 = dropped straggler), the transmitters' manifests, and their uplink
    (transmitters only, cohort order): the dense top-k stack ``dense (N, P,
    V)`` with the projections ``h (N, P, r)`` of the dense engines, or the
    sparse wire of ``fused_e2e``."""

    payloads: list[UplinkPayload]
    ks: list[int]
    dense: torch.Tensor | None = None
    h: torch.Tensor | None = None
    sparse: SparseWire | QuantizedWire | None = None

    @property
    def uplink_bytes(self) -> float:
        return float(sum(p.bytes for p in self.payloads))

    @property
    def num_transmitters(self) -> int:
        return len(self.payloads)


@dataclasses.dataclass
class RoundsTrajectory:
    """Per-round observables of one ``run_rounds`` block
    (:class:`FusedE2EEngine` or, on a mixed fleet,
    :class:`HeteroFusedE2EEngine`).

    ``ks``/``payloads`` are the host's accounting (what R ``run_round``
    calls report); ``mean_k``, ``distill_loss`` and, when eval data was
    passed, ``server_acc``/``client_acc`` are the block's in-block taps,
    kept on the device round by round and copied to the host once, after
    the block.  ``distill_loss`` is the round's final server-distill step
    loss (NaN for an all-dropped round: the server never distilled).
    ``snr_db``/``outage`` (blocks given a ``channel_scan``): per round, the
    cohort's SNR (dB, -inf in outage) and Gilbert-Elliott outage flags from
    the block's own fp32 replica of the channel chain that priced
    ``ks``/``payloads``.  ``family_client_acc`` (a mixed fleet's block with
    eval data; None otherwise): per round, one accuracy a family bucket,
    of the family's first selected client after its update, or of its
    local client 0, untouched, when the family sat the round out;
    ``client_acc`` is the entry of the family of the round's first
    selected client."""

    ks: list[list[int]]
    payloads: list[list[UplinkPayload]]
    mean_k: list[float]
    distill_loss: list[float]
    server_acc: list[float] | None = None
    client_acc: list[float] | None = None
    family_client_acc: list[list[float]] | None = None
    snr_db: list[list[float]] | None = None
    outage: list[list[bool]] | None = None


class SequentialEngine:
    """The reference client-phase executor: one client at a time, each
    through its own :class:`Client` methods (Algorithm 1 exactly as
    written).  The clients keep their own parameters and optimizer state."""

    name = "sequential"
    store_kind = "device"  # per-client params live on the device, unstacked

    def __init__(self, clients: list[Client], cfg: ModelConfig, *, value_bits: int = 16,
                 k_min: int = 1):
        self.clients = clients
        self.cfg = cfg
        self.value_bits = value_bits
        self.k_min = k_min

    def client_params(self, cid: int) -> dict:
        """Current parameters of one client (for evaluation)."""
        return self.clients[cid].params

    def fleet_state(self) -> dict:
        """The fleet's trainable state as one checkpointable tree of
        per-client subtrees ``client{i}/params|opt`` (the reference's)."""
        return {f"client{i}": {"params": c.params, "opt": one_model_opt(c.opt)}
                for i, c in enumerate(self.clients)}

    def load_fleet_state(self, state: dict) -> None:
        for i, c in enumerate(self.clients):
            dev = c.params["embed"].device
            c.params = {k: owned_copy(v, dev) for k, v in state[f"client{i}"]["params"].items()}
            c.opt = client_axis_opt(state[f"client{i}"]["opt"], dev)

    def prefetch_cohort(self, sel: Sequence[int]) -> None:
        """No-op: every client's state already lives on the device."""

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
        if bcast is not None:
            for c in cohort:
                c.local_distill(bcast.tokens, bcast.logits, bcast.h)
        dense_rows, hs, payloads, ks = [], [], [], []
        for c, st in zip(cohort, states):
            c.local_train()
            up = c.upload(
                pub_tokens, st, value_bits=self.value_bits,
                k_override=None if adaptive_k else self.cfg.vocab_size,
                send_h=send_h, k_min=self.k_min,
            )
            if up is None:  # straggler in outage: transmits nothing
                ks.append(0)
                continue
            ks.append(up.k)
            dense_rows.append(densify(up.sparse))
            if up.h is not None:
                hs.append(up.h)
            payloads.append(up.payload)
        return ClientPhase(
            payloads=payloads, ks=ks,
            dense=torch.stack(dense_rows) if dense_rows else None,
            h=torch.stack(hs) if hs else None,
        )


class _ServerOwnerMixin:
    """Server-state plumbing of the whole-round engines: they own the server
    LLM's LoRA (with a client axis of 1), optimizer state and frozen
    backbone for the run, compute the broadcast in the round, and write
    the merged parameters back for evaluation.  The multi-round block's
    ``run_rounds`` lives here too: each engine brings its
    ``stage_rounds`` and ``run_block``."""

    handles_server = True
    _family_tap = False  # the block reports one client accuracy a family bucket

    # -- the multi-round block: stage_rounds, then run_block ------------------
    def run_rounds(
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
    ) -> RoundsTrajectory:
        """Run R whole rounds as one block, as R ``run_round`` calls would:
        fleet, server and broadcast state advance in place, and the block
        returns a :class:`RoundsTrajectory`.

        ``eval_tokens``/``eval_labels`` (both or neither) are evaluated after
        each round on the server model and on the round's first selected
        client (on a mixed fleet also on each family's), the models the
        per-round loop evaluates; the split is truncated to whole
        ``EVAL_BATCH`` batches, as the host evaluator walks it, and a split
        smaller than one batch is refused.  The host's work comes first
        (``stage_rounds``), then the block (``run_block``); its taps cross
        to the host once, after it."""
        staged = self.stage_rounds(
            sels, pubs, states_per_round, adaptive_k=adaptive_k, send_h=send_h,
            eval_tokens=eval_tokens, eval_labels=eval_labels, channel_scan=channel_scan,
        )
        taps = self.run_block(staged)
        names = list(taps)
        host = {}
        if taps:  # one copy to the host for every tap
            flat = torch.cat([taps[k].reshape(-1).float() for k in names]).cpu()
            for k, part in zip(names, flat.split([taps[k].numel() for k in names])):
                host[k] = part.reshape(taps[k].shape).tolist()
        no_eval, no_chan = staged.eval_tokens is None, channel_scan is None
        return RoundsTrajectory(
            ks=staged.ks, payloads=staged.payloads, mean_k=host.get("mean_k", []),
            distill_loss=host.get("distill_loss", []),
            server_acc=None if no_eval else host.get("server_acc", []),
            client_acc=None if no_eval else host.get("client_acc", []),
            family_client_acc=(None if no_eval or not self._family_tap
                               else host.get("family_client_acc", [])),
            snr_db=None if no_chan else host.get("snr_db", []),
            outage=None if no_chan else [[bool(x) for x in row] for row in host.get("outage", [])],
        )

    def _require_device_store(self) -> None:
        """A block reads the fleet's rows by index tensors staged on the
        device: only the device store holds the whole fleet there."""
        if self.store_kind != "device":
            raise RuntimeError(
                "run_rounds scans the WHOLE fleet stack (every family bucket's on a mixed "
                "fleet) as a donated device carry, which only fleet_store='device' provides; "
                f"a host store (store_kind={self.store_kind!r}) keeps O(cohort) device "
                "residency — drive rounds one at a time with run_round instead (rounds.py "
                "falls back automatically)"
            )

    def _block_checks(self, sels, eval_tokens, eval_labels):
        """The reference's refusals of a block, before any work: a device
        store, unique and equal-size cohorts, eval data in pairs and of at
        least one ``EVAL_BATCH``.  Returns the cohorts as lists and the eval
        split cut to whole batches, on the device."""
        self._require_device_store()
        sels = [check_unique_cohort(sel) for sel in sels]
        if (eval_tokens is None) != (eval_labels is None):
            raise ValueError("pass eval_tokens and eval_labels together")
        if any(len(sel) != len(sels[0]) for sel in sels):
            raise ValueError("run_rounds requires equal-size cohorts")
        if sels and eval_tokens is not None:
            seen = (int(eval_tokens.shape[0]) // EVAL_BATCH) * EVAL_BATCH
            if seen == 0:
                raise ValueError(
                    f"eval split of {int(eval_tokens.shape[0])} samples is smaller than one eval "
                    f"batch ({EVAL_BATCH})"
                )
            eval_tokens = torch.as_tensor(eval_tokens[:seen], device=self.device)
            eval_labels = torch.as_tensor(eval_labels[:seen], device=self.device)
        return sels, eval_tokens, eval_labels

    def _block_broadcast(self, pub0: torch.Tensor):
        """The broadcast a block's first round distills against: the last
        round's, or round 0's placeholders (``g_valid`` False)."""
        if self._b_logits is not None:
            return self._b_tokens, self._b_logits, self._b_h, True
        g_tokens, g_logits, g_h = self._cold_broadcast(pub0, int(pub0.shape[0]))
        return g_tokens, g_logits, g_h, False

    def _init_server_state(self, server) -> None:
        self.server = server
        lora, self._s_frozen = split_lora(server.params)
        self._s_lora = {k: v[None] for k, v in lora.items()}
        self._s_opt = server.opt
        self._b_tokens: torch.Tensor | None = None
        self._b_logits: torch.Tensor | None = None
        self._b_h: torch.Tensor | None = None
        self._d_loss: torch.Tensor | None = None

    def _cold_broadcast(self, pub_tokens: torch.Tensor, n_samples: int):
        """Round-0 placeholders: no broadcast exists yet, so the round skips
        the client distillation (``g_valid=False``)."""
        cfg = self.server.cfg
        dev = pub_tokens.device
        g_logits = torch.zeros((n_samples, cfg.vocab_size), device=dev)
        g_h = torch.zeros((n_samples, cfg.lora.rank), device=dev) if cfg.lora is not None else None
        return pub_tokens, g_logits, g_h

    def broadcast_state(self, pub_tokens: torch.Tensor) -> BroadcastState:
        """The broadcast the LAST executed round computed."""
        assert self._b_logits is not None, "no round has run yet"
        rank = (
            self.server.cfg.lora.rank
            if (self.server.cfg.lora is not None and self._b_h is not None)
            else None
        )
        bits = downlink_bits(int(self._b_logits.shape[0]), int(self._b_logits.shape[-1]), rank)
        return BroadcastState(tokens=pub_tokens, logits=self._b_logits, h=self._b_h, bits=bits)

    @property
    def last_distill_loss(self) -> float:
        """The final server-distill step loss of the last round (NaN before
        any round and for a round where every client dropped)."""
        return float("nan") if self._d_loss is None else float(self._d_loss)

    def sync_server(self) -> None:
        """Write the engine-held server state back onto the Server."""
        self.server.params = merge_lora({k: v[0] for k, v in self._s_lora.items()}, self._s_frozen)
        self.server.opt = self._s_opt

    def server_state(self) -> dict:
        """The engine-held server state as one checkpointable tree."""
        return {"s_lora": {k: v[0] for k, v in self._s_lora.items()},
                "s_frozen": self._s_frozen, "s_opt": one_model_opt(self._s_opt)}

    def load_server_state(self, state: dict) -> None:
        dev = self.device
        self._s_lora = {k: owned_copy(v, dev)[None] for k, v in state["s_lora"].items()}
        self._s_frozen = {k: owned_copy(v, dev) for k, v in state["s_frozen"].items()}
        self._s_opt = client_axis_opt(state["s_opt"], dev)
        self.sync_server()

    def load_broadcast(self, tokens, logits, h=None) -> None:
        """Restore the broadcast the NEXT round's cohort distills against
        (a checkpoint's)."""
        dev = self.device
        self._b_tokens = torch.as_tensor(tokens, device=dev)
        self._b_logits = owned_copy(logits, dev)
        self._b_h = None if h is None else owned_copy(h, dev)
