"""Fault injection, wire validation and HARQ retransmission — the port of
``repro/core/faults.py``.

The paper's wireless setting assumes every surviving upload arrives intact.
A production federation does not get that luxury: payloads arrive corrupted,
clients die mid-round, and fault episodes cluster in bursts.  This module
makes those failure modes deterministic and replayable, riding the same
machinery as the channel simulator:

* :class:`FaultConfig` — declarative fault scenario presets (``FAULTS``):
  per-transmission corruption probability, per-(round, client) crash
  probability, and bursty fault episodes driven by the same Gilbert-Elliott
  two-state chain as the channel's outage scenarios.
* :class:`FaultSimulator` — every draw is keyed by ``(seed, domain, round,
  cid)`` exactly like :class:`repro_torch.core.channel.ChannelSimulator`,
  on domains disjoint from the channel's, so fault trajectories are
  deterministic, independent of cohort composition/order, and never perturb
  the channel realisation of a run.  :meth:`FaultSimulator.resolve_round`
  turns one round's attempted uploads into a delivery verdict per client
  (delivered after ``a`` HARQ attempts / quarantined after exhausting
  retries / crashed — upload never arrives), and
  :meth:`FaultSimulator.scan_fault_inputs` exposes the identical draws as
  f32/bool operands for the multi-round block (the per-round delivery
  masks derived from either source are bit-identical).
* :func:`validate_wire` / :func:`quarantine_wire` — server-side integrity
  gate on the sparse uplink wire: non-finite values, out-of-range or
  negative indices, and fits-violating byte counts are rejected per client;
  quarantine zeroes the offender's transmit mask, so the existing
  transmit-mask aggregation excludes it (a quarantined client looks
  exactly like a k = 0 straggler to eqs. 6-7).  The wire's tensors are
  read to the host for the check; the quarantined wire stays on the
  wire's device, in its own tensor type.

Crash semantics: a crash models the client dying during TRANSMISSION —
after its local compute (the paper's lines 5-8 already ran on-device) but
before the upload lands, so its local LoRA state still advances while the
server never hears from it.  A crashed client had a nonzero attempted k
and a reason of ``"crash"``, unlike a k = 0 "budget afforded nothing"
straggler.

HARQ pricing: every transmission attempt of a payload costs its full
on-air bytes against the SAME Shannon budget that priced the adaptive k —
a client can only retry while the remaining budget affords another full
copy, capped at ``1 + max_retries`` attempts.  Delivered-after-retries
keeps its true k in aggregation but its ledger bytes are
``attempts * payload_bytes``; a client that exhausts retries (or budget)
degrades to k = 0 exclusion with the failed attempts still on the ledger
(the bytes were spent on air even though nothing usable arrived).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.channel import bits_per_entry
from repro_torch.core.scenario import ge_stationary_bad, ge_step

__all__ = [
    "FaultConfig",
    "FAULTS",
    "get_faults",
    "FaultCarry",
    "FaultResolution",
    "FaultSimulator",
    "validate_wire",
    "validate_dense",
    "quarantine_wire",
    "corrupt_wire",
]


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Declarative fault scenario (frozen; presets in :data:`FAULTS`).

    ``corrupt_prob`` is the per-TRANSMISSION corruption probability — each
    HARQ attempt redraws it independently.  ``crash_prob`` is the
    per-(round, client) probability that a selected transmitter dies during
    upload (no bytes land, no retries).  ``max_retries`` caps HARQ
    retransmissions after a corrupted copy (0 = no retransmission: first
    corrupt copy quarantines).  ``burst_enter``/``burst_exit`` enable a
    Gilbert-Elliott episode chain (enter = P(good -> bad), exit =
    P(bad -> good)); while a client is inside an episode its corruption
    probability is ``burst_corrupt_prob`` instead of ``corrupt_prob``.
    """

    name: str = "none"
    corrupt_prob: float = 0.0
    crash_prob: float = 0.0
    max_retries: int = 0
    burst_enter: float | None = None
    burst_exit: float = 0.5
    burst_corrupt_prob: float = 0.9

    def __post_init__(self):
        for field in ("corrupt_prob", "crash_prob", "burst_exit",
                      "burst_corrupt_prob"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultConfig.{field} must be in [0, 1], got {v}")
        if self.burst_enter is not None and not 0.0 <= self.burst_enter <= 1.0:
            raise ValueError(
                f"FaultConfig.burst_enter must be in [0, 1], got {self.burst_enter}"
            )
        if self.max_retries < 0:
            raise ValueError(
                f"FaultConfig.max_retries must be >= 0, got {self.max_retries}"
            )

    @property
    def enabled(self) -> bool:
        """Whether this config can ever perturb a run (the disabled config
        is the bit-identity contract: a run with ``faults=None`` and one
        with the ``"none"`` preset must be indistinguishable)."""
        return (
            self.corrupt_prob > 0.0
            or self.crash_prob > 0.0
            or (self.burst_enter is not None and self.burst_enter > 0.0)
        )

    @property
    def max_attempts(self) -> int:
        return 1 + self.max_retries


FAULTS: dict[str, FaultConfig] = {
    # bit-identical to faults=None on every engine path (gated in CI)
    "none": FaultConfig(name="none"),
    # i.i.d. per-transmission corruption with HARQ recovery
    "corruption": FaultConfig(name="corruption", corrupt_prob=0.35, max_retries=2),
    # clients die mid-upload; nothing to retry
    "crashes": FaultConfig(name="crashes", crash_prob=0.2),
    # quiet links punctuated by Gilbert-Elliott fault episodes in which
    # most transmissions corrupt (mean episode length 1/burst_exit rounds)
    "bursty": FaultConfig(
        name="bursty", corrupt_prob=0.05, max_retries=1,
        burst_enter=0.15, burst_exit=0.4, burst_corrupt_prob=0.9,
    ),
    # the unreliable-edge kitchen sink: crashes + bursty corruption
    "lossy": FaultConfig(
        name="lossy", corrupt_prob=0.15, crash_prob=0.1, max_retries=1,
        burst_enter=0.1, burst_exit=0.5, burst_corrupt_prob=0.8,
    ),
}


def get_faults(spec: "str | FaultConfig | None") -> FaultConfig | None:
    """Resolve a preset name / config / None (mirrors
    :func:`repro_torch.core.scenario.get_scenario`)."""
    if spec is None:
        return None
    if isinstance(spec, FaultConfig):
        return spec
    if isinstance(spec, str):
        try:
            return FAULTS[spec]
        except KeyError:
            raise ValueError(
                f"unknown fault preset {spec!r}; available: {sorted(FAULTS)}"
            ) from None
    raise TypeError(f"faults spec must be str | FaultConfig | None, got {type(spec)}")


@dataclasses.dataclass(frozen=True)
class FaultCarry:
    """Per-fleet burst-episode state between rounds (pure value, replayed
    contiguously exactly like :class:`repro_torch.core.channel.ChannelCarry`)."""

    round_index: int  # the round this carry has evolved THROUGH (-1 = init)
    burst: np.ndarray  # (N,) bool — inside a fault episode


@dataclasses.dataclass(frozen=True)
class FaultResolution:
    """One round's delivery verdict for a cohort (cohort order).

    ``delivered[i]`` — the upload landed intact (possibly after HARQ
    retries).  ``attempts[i]`` — transmissions actually made (0 for a crash
    or a k = 0 non-transmitter; >= 1 otherwise).  ``reasons[i]`` — ``None``
    for delivered clients and k = 0 non-transmitters, ``"crash"`` /
    ``"corrupt"`` for lost uploads.
    """

    delivered: list[bool]
    attempts: list[int]
    reasons: list[str | None]

    @property
    def num_crashed(self) -> int:
        return sum(1 for r in self.reasons if r == "crash")

    @property
    def num_quarantined(self) -> int:
        return sum(1 for r in self.reasons if r == "corrupt")


class FaultSimulator:
    """Deterministic per-round fault realisation for N clients.

    Every draw is keyed ``(seed, domain, round, cid)`` on stream domains
    disjoint from :class:`repro_torch.core.channel.ChannelSimulator`'s (7-10), so
    enabling faults never perturbs a run's channel realisation, two
    simulators with the same seed agree draw-for-draw, and a client's fault
    trajectory is independent of which other clients were selected and of
    query order.  Uniforms are cast to f32 AT DRAW TIME so the host
    resolution and the scan-operand path (:meth:`scan_fault_inputs`)
    compare bit-identically.
    """

    _CRASH_DOMAIN = 21
    _CORRUPT_DOMAIN = 22
    _BURST_INIT_DOMAIN = 23
    _BURST_DOMAIN = 24

    def __init__(
        self, num_clients: int, config: FaultConfig | None = None, *, seed: int = 0
    ):
        self.num_clients = int(num_clients)
        self.config = config or FaultConfig()
        self.seed = int(seed)
        self._carry: FaultCarry | None = None
        # contiguous replay cache: (crash_u (N,), corrupt_u (N, A), burst (N,))
        self._realised: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def _stream(self, domain: int, round_index: int, cid: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(
                entropy=self.seed, spawn_key=(domain, int(round_index), int(cid))
            )
        )

    # -- burst-episode dynamics: pure carry API ---------------------------

    def init_fault_carry(self) -> FaultCarry:
        """Fleet episode state BEFORE round 0 (Gilbert-Elliott stationary
        start, own stream domain)."""
        cfg = self.config
        burst = np.zeros(self.num_clients, dtype=bool)
        if cfg.burst_enter is not None and cfg.burst_enter > 0.0:
            pi_bad = ge_stationary_bad(cfg.burst_enter, cfg.burst_exit)
            if pi_bad > 0.0:
                burst = np.array([
                    self._stream(self._BURST_INIT_DOMAIN, 0, cid).random() < pi_bad
                    for cid in range(self.num_clients)
                ])
        return FaultCarry(round_index=-1, burst=burst)

    def step_faults(
        self, carry: FaultCarry, round_index: int
    ) -> tuple[FaultCarry, np.ndarray, np.ndarray, np.ndarray]:
        """Advance the fleet's fault state through one round (pure).

        Returns ``(carry', crash_u, corrupt_u, burst)`` — the f32 crash
        uniforms ``(N,)``, the f32 HARQ-attempt corruption uniforms
        ``(N, 1 + max_retries)`` and the bool episode states ``(N,)`` for
        ``round_index``.  Must be stepped contiguously (the episode chain is
        Markov); random access goes through the replay cache.
        """
        if round_index != carry.round_index + 1:
            raise ValueError(
                f"step_faults must advance contiguously: carry is at round "
                f"{carry.round_index}, got round_index {round_index}"
            )
        cfg = self.config
        n = self.num_clients
        burst = carry.burst
        if cfg.burst_enter is not None and cfg.burst_enter > 0.0:
            u = np.array([
                self._stream(self._BURST_DOMAIN, round_index, cid).random()
                for cid in range(n)
            ])
            burst = ge_step(carry.burst, u, cfg.burst_enter, cfg.burst_exit)
        crash_u = np.array([
            self._stream(self._CRASH_DOMAIN, round_index, cid).random()
            for cid in range(n)
        ], dtype=np.float32)
        corrupt_u = np.array([
            self._stream(self._CORRUPT_DOMAIN, round_index, cid).random(
                cfg.max_attempts
            )
            for cid in range(n)
        ], dtype=np.float32)
        return (
            FaultCarry(round_index=round_index, burst=burst),
            crash_u, corrupt_u, burst.copy(),
        )

    def _ensure_realised(self, round_index: int) -> None:
        if self._carry is None:
            self._carry = self.init_fault_carry()
        while len(self._realised) <= round_index:
            self._carry, crash_u, corrupt_u, burst = self.step_faults(
                self._carry, len(self._realised)
            )
            self._realised.append((crash_u, corrupt_u, burst))

    # -- delivery resolution ----------------------------------------------

    @staticmethod
    def _resolve_one(
        cfg: FaultConfig,
        crash_u: float,
        corrupt_u: np.ndarray,
        burst: bool,
        k: int,
        payload_bits: float,
        budget_bits: float,
    ) -> tuple[bool, int, str | None]:
        """One client's verdict from its round draws (shared by the host
        per-round path and the scan-operand path, so they cannot diverge)."""
        if k <= 0:
            return False, 0, None  # never transmitted; not a fault
        if np.float32(crash_u) < np.float32(cfg.crash_prob):
            return False, 0, "crash"
        p = cfg.burst_corrupt_prob if burst else cfg.corrupt_prob
        p = np.float32(p)
        if payload_bits <= 0.0:
            return True, 1, None
        # each HARQ attempt re-spends the full payload against the SAME
        # Shannon budget; the first copy fits by construction
        affordable = max(1, int(math.floor(budget_bits / payload_bits)))
        allowed = min(cfg.max_attempts, affordable)
        for a in range(allowed):
            if not np.float32(corrupt_u[a]) < p:
                return True, a + 1, None
        return False, allowed, "corrupt"

    def resolve_round(
        self,
        round_index: int,
        client_ids: Sequence[int],
        ks: Sequence[int],
        payload_bits: Sequence[float],
        budget_bits: Sequence[float],
    ) -> FaultResolution:
        """Resolve one round's deliveries for a cohort.

        ``ks``/``payload_bits``/``budget_bits`` are the cohort's ATTEMPTED
        adaptive k, the priced on-air bits of one payload copy, and the
        Shannon bit budget — all in cohort order.  The verdict for a client
        depends only on ``(seed, round, cid)`` and its own scalars, so it is
        invariant under cohort permutation and composition.
        """
        if round_index < 0:
            raise ValueError(f"round_index must be >= 0, got {round_index}")
        self._ensure_realised(round_index)
        crash_u, corrupt_u, burst = self._realised[round_index]
        delivered, attempts, reasons = [], [], []
        for i, cid in enumerate(client_ids):
            cid = int(cid)
            if not 0 <= cid < self.num_clients:
                raise ValueError(
                    f"fault streams track per-fleet state: client_ids must "
                    f"be in [0, {self.num_clients}), got {cid}"
                )
            d, a, r = self._resolve_one(
                self.config, float(crash_u[cid]), corrupt_u[cid],
                bool(burst[cid]), int(ks[i]),
                float(payload_bits[i]), float(budget_bits[i]),
            )
            delivered.append(d)
            attempts.append(a)
            reasons.append(r)
        return FaultResolution(delivered=delivered, attempts=attempts, reasons=reasons)

    # -- scan data operands -----------------------------------------------

    def scan_fault_inputs(self, num_rounds: int, *, start_round: int = 0) -> dict:
        """Host-precomputed fault draws for a multi-round block as f32/bool
        operands (the fault analogue of
        :meth:`repro_torch.core.channel.ChannelSimulator.scan_channel_inputs`).

        The arrays come from the very replay cache :meth:`resolve_round`
        consumes, so delivery masks derived from these operands
        (:meth:`resolve_from_inputs`) are bit-identical to the per-round
        host path: the block takes faults as its int32 ``k`` data (a
        non-delivered client rides the block at k = 0, as a straggler
        does).
        """
        if num_rounds < 0 or start_round < 0:
            raise ValueError("num_rounds and start_round must be >= 0")
        cfg = self.config
        n, a = self.num_clients, cfg.max_attempts
        crash = np.zeros((num_rounds, n), dtype=np.float32)
        corrupt = np.zeros((num_rounds, n, a), dtype=np.float32)
        burst = np.zeros((num_rounds, n), dtype=bool)
        if num_rounds:
            self._ensure_realised(start_round + num_rounds - 1)
        for r in range(num_rounds):
            cu, ou, bu = self._realised[start_round + r]
            crash[r], corrupt[r], burst[r] = cu, ou, bu
        return {
            "crash_u": crash,
            "corrupt_u": corrupt,
            "burst": burst,
            "crash_prob": np.float32(cfg.crash_prob),
            "corrupt_prob": np.float32(cfg.corrupt_prob),
            "burst_corrupt_prob": np.float32(cfg.burst_corrupt_prob),
            "max_retries": np.int32(cfg.max_retries),
        }

    def resolve_from_inputs(
        self,
        inputs: dict,
        round_offset: int,
        client_ids: Sequence[int],
        ks: Sequence[int],
        payload_bits: Sequence[float],
        budget_bits: Sequence[float],
    ) -> FaultResolution:
        """The scan-operand twin of :meth:`resolve_round`: same verdicts,
        sourced from a :meth:`scan_fault_inputs` dict instead of the stream
        cache (parity-tested bit-identical)."""
        crash_u = inputs["crash_u"][round_offset]
        corrupt_u = inputs["corrupt_u"][round_offset]
        burst = inputs["burst"][round_offset]
        delivered, attempts, reasons = [], [], []
        for i, cid in enumerate(client_ids):
            d, a, r = self._resolve_one(
                self.config, float(crash_u[int(cid)]), corrupt_u[int(cid)],
                bool(burst[int(cid)]), int(ks[i]),
                float(payload_bits[i]), float(budget_bits[i]),
            )
            delivered.append(d)
            attempts.append(a)
            reasons.append(r)
        return FaultResolution(delivered=delivered, attempts=attempts, reasons=reasons)


# -- server-side wire validation / quarantine -----------------------------


def _host(x) -> np.ndarray:
    """A wire field as host numpy (bf16, which numpy lacks, as its exact
    fp32 values)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def validate_wire(
    wire,
    *,
    value_bits: int = 16,
    budget_bits: Sequence[float] | None = None,
    reserved_bits: float = 0.0,
) -> tuple[np.ndarray, list[str | None]]:
    """Server-side integrity gate on a sparse uplink wire
    (:class:`repro_torch.core.topk.SparseWire` or ``QuantizedWire``).

    Per client row ``n``, reject when any MASKED-IN entry carries a
    non-finite value (``"non_finite"``; for the int8 wire the check applies
    to the f32 dequant scales of active rows), an index outside
    ``[0, vocab)`` (``"index_range"``), or — when ``budget_bits`` is given —
    when the claimed transmitted entries plus ``reserved_bits`` price above
    the client's Shannon budget at ``value_bits`` per value
    (``"over_budget"``: a fits-violating byte count; honest payloads
    satisfy ``PayloadSpec.fits`` by construction).  A client whose mask is
    all-False transmits nothing and is vacuously valid.

    Returns ``(ok (N,) bool, reasons)`` with ``reasons[n]`` the FIRST
    violated check or None.
    """
    indices = _host(wire.indices)
    mask = _host(wire.mask)
    vocab = int(wire.vocab)
    n = indices.shape[0]
    ok = np.ones(n, dtype=bool)
    reasons: list[str | None] = [None] * n
    flat_mask = mask.reshape(n, -1)
    flat_idx = indices.reshape(n, -1)
    values = _host(wire.values)
    is_quant = values.dtype == np.int8
    flat_scale = _host(wire.scale).reshape(n, -1) if is_quant else None
    flat_values = values.reshape(n, -1)
    d = bits_per_entry(value_bits, vocab)
    for i in range(n):
        m = flat_mask[i]
        if not m.any():
            continue  # nothing transmitted (k = 0 straggler row)
        if is_quant:
            finite = np.isfinite(flat_scale[i]).all()
        else:
            finite = np.isfinite(flat_values[i][m]).all()
        if not finite:
            ok[i], reasons[i] = False, "non_finite"
            continue
        masked_idx = flat_idx[i][m]
        if masked_idx.min() < 0 or masked_idx.max() >= vocab:
            ok[i], reasons[i] = False, "index_range"
            continue
        if budget_bits is not None:
            bits = float(m.sum()) * d + float(reserved_bits)
            if bits > float(budget_bits[i]) + 1e-6:
                ok[i], reasons[i] = False, "over_budget"
    return ok, reasons


def validate_dense(
    stack, h_stack=None
) -> tuple[np.ndarray, list[str | None]]:
    """The densified-path twin of :func:`validate_wire`: per-client finite
    check on an (N, P, V) upload stack (+ optional (N, P, r) projections).
    The dense form has no index/byte channel to violate, so the only
    reachable reason is ``"non_finite"`` — e.g. a client whose local
    training diverged to NaN logits gets quarantined instead of poisoning
    the eq. 6-7 aggregation."""
    if isinstance(stack, torch.Tensor):
        # one (N,) flag a client crosses to the host, not the whole stack
        finite = torch.isfinite(stack.reshape(stack.shape[0], -1)).all(dim=1)
        if h_stack is not None:
            finite &= torch.isfinite(h_stack.reshape(h_stack.shape[0], -1)).all(dim=1)
        ok = finite.cpu().numpy()
    else:
        arr = np.asarray(stack)
        n = arr.shape[0]
        ok = np.isfinite(arr.reshape(n, -1)).all(axis=1)
        if h_stack is not None:
            ok &= np.isfinite(np.asarray(h_stack).reshape(n, -1)).all(axis=1)
    return ok, [None if o else "non_finite" for o in ok]


def quarantine_wire(wire, ok: np.ndarray):
    """Exclude rejected clients from aggregation through the existing
    transmit-mask pattern: a quarantined row's mask goes all-False, which is
    exactly the representation of a k = 0 straggler — eqs. 6-7 then weight
    it out without any new aggregation semantics.

    The payload CONTENTS are scrubbed too (values/indices to 0, dequant
    scales to 1.0): masked-out entries are weighted by ``values * mask``
    in the scatter path, and ``NaN * 0 == NaN`` would leak a corrupted
    value straight through an all-False mask.  The new wire's tensors are
    fresh, on the wire's device."""
    drop = ~torch.as_tensor(np.asarray(ok, dtype=bool), device=wire.mask.device)
    fields = {}
    for name, fill in (("mask", False), ("values", 0), ("indices", 0), ("scale", 1.0)):
        if hasattr(wire, name):
            t = getattr(wire, name).clone()
            t[drop] = fill
            fields[name] = t
    return wire._replace(**fields)


def corrupt_wire(wire, rows: Sequence[int], mode: str = "nan"):
    """Test/bench fault injector: corrupt the given client rows of a wire
    (returns a new wire, the rest of it shared).  ``mode`` is ``"nan"`` (a
    masked value — or dequant scale — becomes NaN), ``"index"`` (an index
    leaves ``[0, vocab)``), or ``"negative_index"``."""
    out: dict[str, torch.Tensor] = {}

    def field(name: str) -> torch.Tensor:
        if name not in out:
            out[name] = getattr(wire, name).contiguous().clone()
        return out[name]

    for r in rows:
        if mode == "nan":
            name = "scale" if wire.values.dtype == torch.int8 else "values"
            t = field(name)
            t.view(t.shape[0], -1)[r, 0] = float("nan")
        elif mode in ("index", "negative_index"):
            t = field("indices")
            t.view(t.shape[0], -1)[r, 0] = wire.vocab if mode == "index" else -1
        else:
            raise ValueError(f"unknown corrupt_wire mode {mode!r}")
    return wire._replace(**out)
