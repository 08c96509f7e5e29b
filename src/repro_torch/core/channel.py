"""Wireless channel model driving the adaptive Top-k budget (paper §III-A).

The paper models each client's uplink as an AWGN channel.  Shannon capacity

    C = B * log2(1 + SNR)            [bits/s]          (paper eq. 5)

with bandwidth ``B`` (Hz) and linear SNR.  A client granted fraction
``eta`` of the channel for at most ``T`` seconds per round may transmit
``eta * C * T`` bits, which caps the number of (logit, index) pairs it can
upload:

    k = floor(eta * C * T / d)                          (paper §III-A)

where ``d`` is the number of bits to encode one logit value plus its
dimension index.

This module is a *deterministic byte-budget simulator*: the budget it
produces is enforced on the actual payload shapes by
:mod:`repro_torch.core.protocol`, so communication accounting is exact even though
no radio exists.  Fading is simulated with a seeded PRNG so experiments are
reproducible (paper Table I: seeds 0, 1, 42).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.scenario import (
    ScenarioConfig,
    exp_to_gauss,
    gauss_to_exp_power,
    ge_stationary_bad,
    ge_step,
    trajectory_offset_db,
    uniform_to_gauss,
)

__all__ = [
    "ChannelState",
    "BatchedChannelState",
    "ChannelCarry",
    "ChannelConfig",
    "ChannelSimulator",
    "capacity_bps",
    "bit_budget",
    "topk_budget",
    "topk_budget_batch",
    "bits_per_entry",
]


def capacity_bps(bandwidth_hz: float, snr_db: float) -> float:
    """Shannon capacity of an AWGN link (paper eq. 5)."""
    if bandwidth_hz <= 0.0:
        return 0.0
    snr_linear = 10.0 ** (snr_db / 10.0)
    return bandwidth_hz * math.log2(1.0 + snr_linear)


def bits_per_entry(value_bits: int, vocab_size: int) -> int:
    """Bits ``d`` to encode one (logit, index) pair.

    A top-k entry is a value (``value_bits``, e.g. 16 for bf16) plus an index
    into the vocabulary, which needs ``ceil(log2(vocab))`` bits.
    """
    if vocab_size <= 1:
        index_bits = 1
    else:
        index_bits = int(math.ceil(math.log2(vocab_size)))
    return int(value_bits) + index_bits


@dataclasses.dataclass(frozen=True)
class ChannelState:
    """Instantaneous link state for one client in one round."""

    bandwidth_hz: float
    snr_db: float
    eta: float  # fraction of channel resource allocated to this client
    deadline_s: float  # T: max transmission time per round

    @property
    def capacity_bps(self) -> float:
        return capacity_bps(self.bandwidth_hz, self.snr_db)

    @property
    def bit_budget(self) -> float:
        return self.eta * self.capacity_bps * self.deadline_s


def bit_budget(state: ChannelState) -> float:
    return state.bit_budget


def topk_budget(
    state: ChannelState,
    *,
    vocab_size: int,
    num_samples: int,
    value_bits: int = 16,
    k_min: int = 1,
    k_max: int | None = None,
    reserved_bits: float = 0.0,
) -> int:
    """Maximum permissible k per sample: ``k = floor((eta*C*T - reserved)/d)``
    spread over ``num_samples`` public samples uploaded this round.

    The paper states the per-logit budget; with a batch of public samples the
    same budget divides across samples (each sample's sparse vector costs
    ``k*d`` bits).  Clamped to ``[k_min, min(k_max, vocab)]`` so a client in
    deep fade still sends its argmax rather than dropping out.

    ``reserved_bits`` is the fixed-cost part of the payload that rides on the
    SAME Shannon budget before any (value, index) entry does — for the paper's
    ``adald`` method the LoRA projection ``h``
    (:func:`repro_torch.core.protocol.lora_projection_bits`).  Reserving it here is
    what makes ``PayloadSpec.fits`` hold by construction for the realized
    payload: without the reservation the projection rode on top of a
    budget-exact top-k and pushed the payload past capacity.  A budget that
    cannot cover the reservation plus ``k_min`` entries per sample behaves
    like deep fade: the client DROPS THE ROUND (k = 0) rather than emitting
    an unfittable payload.  (Before this fix the ``max(k_min, ...)``
    survival floor lifted the negative entry count back to ``k_min``, so a
    100-bit link with a 1000-bit LoRA reservation "transmitted" a payload
    several times its own capacity and broke the fits-by-construction
    invariant.  The floor is for links that can't afford ``k_min`` BARE
    entries — those still send their argmax; a link that can't afford its
    fixed reservation has nothing coherent to send.)

    A link in outage (zero bit budget) returns 0 regardless of ``k_min``:
    the survival floor exists for faded-but-alive links, but nothing can be
    transmitted over zero capacity — the client drops the round.
    """
    if state.bit_budget <= 0.0:
        return 0
    d = bits_per_entry(value_bits, vocab_size)
    total_entries = (state.bit_budget - float(reserved_bits)) / float(d)
    k = int(math.floor(total_entries / max(1, num_samples)))
    hi = vocab_size if k_max is None else min(k_max, vocab_size)
    if k < k_min and reserved_bits > 0.0:
        # Unaffordable reservation: deep fade.  The survival floor would
        # emit k_min entries ON TOP of a reservation the budget cannot
        # cover; drop the round instead (Client.upload and the engines'
        # _budgets agree — k == 0 clients transmit nothing).
        return 0
    return max(k_min, min(k, hi))


@dataclasses.dataclass(frozen=True)
class BatchedChannelState:
    """Link states for a whole round's selected cohort as arrays.

    The batched round engine consumes this directly; ``__iter__`` /
    ``__getitem__`` recover the scalar :class:`ChannelState` views so the
    sequential reference engine sees identical per-client states.
    """

    bandwidth_hz: np.ndarray  # (C,)
    snr_db: np.ndarray  # (C,)
    eta: np.ndarray  # (C,)
    deadline_s: np.ndarray  # (C,)

    @classmethod
    def from_states(cls, states: Sequence[ChannelState]) -> "BatchedChannelState":
        return cls(
            bandwidth_hz=np.array([s.bandwidth_hz for s in states], dtype=np.float64),
            snr_db=np.array([s.snr_db for s in states], dtype=np.float64),
            eta=np.array([s.eta for s in states], dtype=np.float64),
            deadline_s=np.array([s.deadline_s for s in states], dtype=np.float64),
        )

    def __len__(self) -> int:
        return int(self.snr_db.shape[0])

    def __getitem__(self, i: int) -> ChannelState:
        return ChannelState(
            bandwidth_hz=float(self.bandwidth_hz[i]),
            snr_db=float(self.snr_db[i]),
            eta=float(self.eta[i]),
            deadline_s=float(self.deadline_s[i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def topk_budget_batch(
    states: "BatchedChannelState | Sequence[ChannelState]",
    *,
    vocab_size: int,
    num_samples: int,
    value_bits: int = 16,
    k_min: int = 1,
    k_max: int | None = None,
    reserved_bits: float = 0.0,
) -> list[int]:
    """Per-client adaptive budgets for a round's cohort.

    Evaluates the scalar :func:`topk_budget` per client (host-side, tiny N)
    rather than a vectorized reimplementation so the batched engine's ``k``
    is bit-identical to the sequential reference — a one-ulp difference in a
    vectorized log2 could flip a ``floor`` and desynchronise the engines.
    """
    return [
        topk_budget(
            s,
            vocab_size=vocab_size,
            num_samples=num_samples,
            value_bits=value_bits,
            k_min=k_min,
            k_max=k_max,
            reserved_bits=reserved_bits,
        )
        for s in states
    ]


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Fleet-level channel configuration.

    Defaults loosely follow an LTE-like uplink: 1 MHz effective bandwidth,
    mean SNR 10 dB with log-normal shadowing + Rayleigh-like fast fading,
    1 s round deadline, equal resource share ``eta = 1/num_selected``.

    Straggler / dropout scenarios: ``dropout_prob`` puts a selected client's
    link into outage (zero capacity -> k = 0, the client transmits nothing
    that round, regardless of ``min_k``), and ``min_k = 0`` additionally
    removes the survival floor so a faded-but-alive client whose budget
    cannot afford a single (value, index) entry also drops out.  The round
    engines exclude k == 0 clients from aggregation entirely instead of
    zero-padding them in.
    """

    bandwidth_hz: float = 1.0e6
    mean_snr_db: float = 10.0
    shadowing_std_db: float = 4.0
    fast_fading: bool = True
    deadline_s: float = 1.0
    eta: float | None = None  # None -> 1/num_clients per round
    value_bits: int = 16
    min_k: int = 1  # survival floor; 0 lets deep-fade clients drop the round
    dropout_prob: float = 0.0  # per-(round, client) outage probability
    # Channel dynamics (repro_torch.core.scenario): None keeps the i.i.d.
    # per-round fading/dropout above; a ScenarioConfig upgrades the
    # simulator to time-correlated fading (Gauss-Markov / Jakes), bursty
    # Gilbert-Elliott outage, and deterministic SNR/mobility trajectories.
    # The default ScenarioConfig() is bit-identical to None.
    scenario: ScenarioConfig | None = None


@dataclasses.dataclass(frozen=True)
class ChannelCarry:
    """Per-fleet channel state between rounds (scenario dynamics).

    ``z`` is the Gaussian-copula AR(1) fading state and ``bad`` the
    Gilbert-Elliott outage state, one entry per fleet client.  The carry is
    a pure value: :meth:`ChannelSimulator.step_channel` maps the carry for
    round ``t-1`` plus the ``(seed, t, cid)``-keyed draws to the carry for
    round ``t`` — replaying from :meth:`ChannelSimulator.init_channel_carry`
    always reproduces the same trajectory, so realisations are independent
    of query order and cohort composition, as for the i.i.d. channel.
    """

    round_index: int  # the round this carry has evolved THROUGH (-1 = init)
    z: np.ndarray  # (N,) f64 AR(1) fading state
    bad: np.ndarray  # (N,) bool Gilbert-Elliott outage state


class ChannelSimulator:
    """Deterministic per-round channel realisation for N clients.

    ``states(round, client_ids)`` returns one :class:`ChannelState` per
    selected client.  SNR_n(t) = mean + shadowing_n + fading_n(t), with
    shadowing fixed per client (spatial) and fading redrawn per round
    (temporal), all from a seeded generator.

    Every temporal draw is keyed by ``(seed, round_index, cid)``: two
    simulators with the same seed produce identical realisations, different
    seeds produce different ones, and a client's fading/outage in a round is
    a property of THAT client and round alone — independent of which other
    clients were selected, of the cohort's ordering, and of call order.
    """

    # Stream domains: fading and outage draws must stay on disjoint keys so
    # enabling dropout never perturbs the fading realisation of a run.  The
    # scenario init states (AR(1) z_{-1}, Gilbert-Elliott stationary start)
    # live on their own domains for the same reason.
    _FADING_DOMAIN = 7
    _OUTAGE_DOMAIN = 8
    _FADING_INIT_DOMAIN = 9
    _GE_INIT_DOMAIN = 10

    def __init__(self, num_clients: int, config: ChannelConfig | None = None, *, seed: int = 0):
        self.num_clients = int(num_clients)
        self.config = config or ChannelConfig()
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        # Per-client static shadowing (log-normal in dB).
        self._shadowing_db = self._rng.normal(
            0.0, self.config.shadowing_std_db, size=self.num_clients
        )
        # Scenario replay cache: realised (snr_db, outage) arrays per round,
        # built by stepping the pure carry from round 0.  Contiguous replay
        # is what makes random-access ``states(t, ids)`` independent of the
        # order rounds are queried in.
        self._carry: ChannelCarry | None = None
        self._realised: list[tuple[np.ndarray, np.ndarray]] = []

    @property
    def scenario(self) -> ScenarioConfig | None:
        return self.config.scenario

    def _stream(self, domain: int, round_index: int, cid: int) -> np.random.Generator:
        """Fresh generator keyed by (seed, domain, round, client)."""
        return np.random.default_rng(
            np.random.SeedSequence(
                entropy=self.seed, spawn_key=(domain, int(round_index), int(cid))
            )
        )

    def _validate_query(self, round_index: int, client_ids: Sequence[int]) -> list[int]:
        """Shared hygiene for ``states``/``topk_for``: rounds are 0-based and
        a cohort is a set — silently accepting a negative round or duplicate
        ids would silently desynchronise the (seed, round, cid) keying."""
        if round_index < 0:
            raise ValueError(
                f"round_index must be >= 0, got {round_index} (rounds are "
                "0-based; the simulator has no pre-federation realisations)"
            )
        ids = [int(c) for c in client_ids]
        if len(set(ids)) != len(ids):
            dups = sorted({c for c in ids if ids.count(c) > 1})
            raise ValueError(
                f"duplicate client_ids in cohort: {dups} — a cohort selects "
                "each client at most once; duplicates would double-count "
                "budgets/payloads for one physical link"
            )
        return ids

    # -- scenario dynamics: pure carry API -------------------------------

    def init_channel_carry(self) -> ChannelCarry:
        """Fleet channel state BEFORE round 0 (stationary start).

        ``z_{-1} ~ N(0, 1)`` per client (own stream domain) makes the AR(1)
        fading chain stationary from the very first round — the round-0
        marginal already matches the i.i.d. model.  The Gilbert-Elliott
        state starts from its stationary distribution.  With no scenario
        (or the default one) both states are identically zero/False and
        never consulted.
        """
        sc = self.config.scenario or ScenarioConfig()
        n = self.num_clients
        z = np.zeros(n, dtype=np.float64)
        if self.config.fast_fading and sc.effective_rho > 0.0:
            z = uniform_to_gauss([
                self._stream(self._FADING_INIT_DOMAIN, 0, cid).random()
                for cid in range(n)
            ])
        bad = np.zeros(n, dtype=bool)
        if sc.p_gb is not None:
            pi_bad = ge_stationary_bad(*sc.ge_params(self.config.dropout_prob))
            if pi_bad > 0.0:
                bad = np.array([
                    self._stream(self._GE_INIT_DOMAIN, 0, cid).random() < pi_bad
                    for cid in range(n)
                ])
        return ChannelCarry(round_index=-1, z=z, bad=bad)

    def step_channel(
        self, carry: ChannelCarry, round_index: int
    ) -> tuple[ChannelCarry, np.ndarray, np.ndarray]:
        """Advance the fleet's channel state through one round (pure).

        Returns ``(carry', snr_db, outage)`` with per-fleet-client arrays:
        ``snr_db[cid]`` is client ``cid``'s realised SNR for ``round_index``
        (``-inf`` in outage) and ``outage`` the Gilbert-Elliott bad states.
        Draws are keyed ``(seed, round, cid)`` exactly like the i.i.d.
        simulator — same streams, same first draw — so ``rho = 0`` with the
        i.i.d.-equivalent outage chain reproduces the stateless simulator
        bit for bit.  The carry must be stepped contiguously (correlation
        makes round ``t`` depend on ``t-1``); random access goes through
        :meth:`states`, which replays and caches from round 0.
        """
        if round_index != carry.round_index + 1:
            raise ValueError(
                f"step_channel must advance contiguously: carry is at round "
                f"{carry.round_index}, got round_index {round_index}"
            )
        cfg = self.config
        sc = cfg.scenario or ScenarioConfig()
        n = self.num_clients
        snr = cfg.mean_snr_db + self._shadowing_db.astype(np.float64)
        if sc.snr_drift_db_per_round != 0.0 or sc.snr_amp_db != 0.0:
            snr = snr + np.array([
                trajectory_offset_db(sc, round_index, cid, n) for cid in range(n)
            ])
        z = carry.z
        if cfg.fast_fading:
            power = np.array([
                self._stream(self._FADING_DOMAIN, round_index, cid).exponential(1.0)
                for cid in range(n)
            ])
            rho = sc.effective_rho
            if rho > 0.0:
                # Gaussian-copula AR(1): stationary Exp(1) marginal at any
                # rho; rho = 0 keeps the RAW draw (bit-identical i.i.d.).
                z = rho * z + math.sqrt(1.0 - rho * rho) * exp_to_gauss(power)
                power = gauss_to_exp_power(z)
            snr = snr + np.array([
                10.0 * math.log10(max(1e-6, float(p))) for p in power
            ])
        bad = np.zeros(n, dtype=bool)
        if sc.p_gb is not None:
            p_gb, p_bg = sc.ge_params(cfg.dropout_prob)
            if p_gb > 0.0:
                u = np.array([
                    self._stream(self._OUTAGE_DOMAIN, round_index, cid).random()
                    for cid in range(n)
                ])
                bad = ge_step(carry.bad, u, p_gb, p_bg)
        elif cfg.dropout_prob > 0.0:
            # memoryless dropout coin — the i.i.d. simulator's exact branch
            u = np.array([
                self._stream(self._OUTAGE_DOMAIN, round_index, cid).random()
                for cid in range(n)
            ])
            bad = u < cfg.dropout_prob
        snr = np.where(bad, -np.inf, snr)
        return ChannelCarry(round_index=round_index, z=z, bad=bad), snr, bad

    def _ensure_realised(self, round_index: int) -> None:
        if self._carry is None:
            self._carry = self.init_channel_carry()
        while len(self._realised) <= round_index:
            self._carry, snr, bad = self.step_channel(
                self._carry, len(self._realised)
            )
            self._realised.append((snr, bad))

    def states(self, round_index: int, client_ids: Sequence[int]) -> list[ChannelState]:
        cfg = self.config
        client_ids = self._validate_query(round_index, client_ids)
        eta = cfg.eta if cfg.eta is not None else 1.0 / max(1, len(client_ids))
        if cfg.scenario is not None:
            if any(not 0 <= c < self.num_clients for c in client_ids):
                raise ValueError(
                    f"scenario channels track per-fleet state: client_ids "
                    f"must be in [0, {self.num_clients}), got {client_ids}"
                )
            self._ensure_realised(round_index)
            snr_all, _bad = self._realised[round_index]
            return [
                ChannelState(
                    bandwidth_hz=cfg.bandwidth_hz,
                    snr_db=float(snr_all[cid]),
                    eta=eta,
                    deadline_s=cfg.deadline_s,
                )
                for cid in client_ids
            ]
        out = []
        for cid in client_ids:
            snr = cfg.mean_snr_db + float(self._shadowing_db[cid % self.num_clients])
            if cfg.fast_fading:
                # Rayleigh power fading: 10*log10(Exp(1)) has mean ~ -2.5 dB.
                fade = self._stream(self._FADING_DOMAIN, round_index, cid)
                snr += 10.0 * math.log10(max(1e-6, fade.exponential(1.0)))
            if cfg.dropout_prob > 0.0:
                drop = self._stream(self._OUTAGE_DOMAIN, round_index, cid)
                if drop.random() < cfg.dropout_prob:
                    snr = -math.inf  # outage: zero capacity -> zero bit budget
            out.append(
                ChannelState(
                    bandwidth_hz=cfg.bandwidth_hz,
                    snr_db=snr,
                    eta=eta,
                    deadline_s=cfg.deadline_s,
                )
            )
        return out

    def states_batched(
        self, round_index: int, client_ids: Sequence[int]
    ) -> BatchedChannelState:
        """The same per-round realisation as :meth:`states`, stacked into the
        array form the batched round engine consumes."""
        return BatchedChannelState.from_states(self.states(round_index, client_ids))

    def topk_for(
        self,
        round_index: int,
        client_ids: Sequence[int],
        *,
        vocab_size: int,
        num_samples: int,
        k_min: int | None = None,
        k_max: int | None = None,
        lora_rank: int | None = None,
    ) -> list[int]:
        """Per-client adaptive k for this round (paper: 'based on real-time
        channel condition').  ``k_min`` defaults to the config's ``min_k`` so
        this agrees with the round engines' straggler semantics.

        ``lora_rank`` reserves the ``adald`` LoRA-projection bits
        (``num_samples * rank * value_bits``, §III-C) out of each client's
        budget before the (value, index) entries are counted, so the realized
        payload — projection included — respects the Shannon budget."""
        reserved = (
            float(num_samples * lora_rank * self.config.value_bits)
            if lora_rank is not None
            else 0.0
        )
        return [
            topk_budget(
                s,
                vocab_size=vocab_size,
                num_samples=num_samples,
                value_bits=self.config.value_bits,
                k_min=self.config.min_k if k_min is None else k_min,
                k_max=k_max,
                reserved_bits=reserved,
            )
            for s in self.states(round_index, client_ids)
        ]

    def scan_channel_inputs(self, num_rounds: int, *, start_round: int = 0) -> dict:
        """Host-precomputed operands for the in-scan channel replica.

        The multi-round block evolves ``(z, bad)`` round by round on the
        device from these f32 operands (:func:`repro_torch.fed.steps
        .make_channel_step_fn`): per-round copula normals ``w``, outage
        uniforms ``u`` and deterministic base SNR (mean + shadowing +
        trajectory), plus the scalar dynamics ``rho``/``p_gb``/``p_bg``/
        ``fade_scale``.  Every scenario differs only through these operands
        (``rho = 0`` is the i.i.d. case).  The draws come from the very
        streams the host realisation consumes, so the in-scan trajectory replays the host
        one (f32 vs f64 rounding aside).
        """
        if num_rounds < 0 or start_round < 0:
            raise ValueError("num_rounds and start_round must be >= 0")
        cfg = self.config
        sc = cfg.scenario or ScenarioConfig()
        n = self.num_clients
        carry = self.init_channel_carry()
        for t in range(start_round):
            carry, _snr, _bad = self.step_channel(carry, t)
        rho = sc.effective_rho if cfg.fast_fading else 0.0
        if sc.p_gb is not None:
            p_gb, p_bg = sc.ge_params(cfg.dropout_prob)
        else:
            p_gb, p_bg = float(cfg.dropout_prob), 1.0 - float(cfg.dropout_prob)
        outage_on = p_gb > 0.0
        w = np.zeros((num_rounds, n), dtype=np.float64)
        u = np.ones((num_rounds, n), dtype=np.float64)
        base = np.zeros((num_rounds, n), dtype=np.float64)
        shadow = cfg.mean_snr_db + self._shadowing_db.astype(np.float64)
        for r in range(num_rounds):
            t = start_round + r
            base[r] = shadow
            if sc.snr_drift_db_per_round != 0.0 or sc.snr_amp_db != 0.0:
                base[r] += np.array([
                    trajectory_offset_db(sc, t, cid, n) for cid in range(n)
                ])
            if cfg.fast_fading:
                p = np.array([
                    self._stream(self._FADING_DOMAIN, t, cid).exponential(1.0)
                    for cid in range(n)
                ])
                w[r] = exp_to_gauss(p)
            if outage_on:
                u[r] = np.array([
                    self._stream(self._OUTAGE_DOMAIN, t, cid).random()
                    for cid in range(n)
                ])
        return {
            "z0": carry.z.astype(np.float32),
            "bad0": carry.bad.copy(),
            "w": w.astype(np.float32),
            "u": u.astype(np.float32),
            "base_snr_db": base.astype(np.float32),
            "rho": np.float32(rho),
            "p_gb": np.float32(p_gb if outage_on else 0.0),
            "p_bg": np.float32(p_bg if outage_on else 1.0),
            "fade_scale": np.float32(1.0 if cfg.fast_fading else 0.0),
        }
