"""Declarative wireless scenarios: time-correlated fading, bursty outage,
and per-client SNR/mobility trajectories (paper §III-A generalised).

The paper's channel model draws i.i.d. Rayleigh-like fading per round; real
uplinks are time-correlated.  A :class:`ScenarioConfig` attached to
:class:`repro_torch.core.channel.ChannelConfig` upgrades the simulator to a
*stateful* channel while keeping every guarantee of the i.i.d. model:

* **Gauss-Markov fading** — an AR(1) chain through a Gaussian copula.  Let
  ``p_t ~ Exp(1)`` be the i.i.d. Rayleigh power draws the simulator already
  makes.  Map each into a standard normal ``w_t = Phi^{-1}(1 - exp(-p_t))``,
  run the stationary recursion

      z_t = rho * z_{t-1} + sqrt(1 - rho^2) * w_t,    z_{-1} ~ N(0, 1)

  and map back: ``power_t = -log(1 - Phi(z_t))``.  Because ``z_t ~ N(0,1)``
  for every ``t``, the *marginal* of ``power_t`` is exactly the Exp(1)
  Rayleigh power of the i.i.d. model at any ``rho`` — correlation changes
  the trajectory, never the per-round distribution (so Shannon budgets stay
  calibrated).  The lag-1 autocorrelation of ``z`` is exactly ``rho``.
  ``rho = 0`` short-circuits to the RAW exponential draw — bit-identical to
  the i.i.d. simulator, not merely equal in distribution.

* **Jakes Doppler correlation** — classical Clarke/Jakes fading gives the
  channel gain an autocorrelation of ``J_0(2 pi f_d tau)`` at lag ``tau``,
  with Doppler ``f_d = v * f_c / c``.  A scenario parameterised by client
  velocity and carrier frequency derives the AR(1) ``rho`` from that
  closed form (one round = one coherence slot ``slot_s``).

* **Gilbert-Elliott outage** — a two-state (good/bad) Markov chain per
  client replaces the i.i.d. dropout coin:

      P(good -> bad) = p_gb,      P(bad -> good) = p_bg

  Bad state = outage (zero capacity, k = 0).  Mean bad-burst length is the
  closed form ``1 / p_bg``; the stationary bad probability is
  ``p_gb / (p_gb + p_bg)``.  Leaving ``p_gb``/``p_bg`` unset derives the
  i.i.d.-equivalent chain ``(dropout_prob, 1 - dropout_prob)`` whose two
  transition thresholds coincide, so the chain's draws are bit-identical to
  the memoryless dropout coin.

* **Deterministic SNR/mobility trajectories** — a per-client mean-SNR
  offset ``drift * t + amp * sin(2 pi (t / period + cid / N))`` modelling
  slow approach/retreat from the base station; pure data, no randomness.

Everything here is HOST-side f64 math (numpy + stdlib, no scipy), a copy
of the reference package's scenario module.  The port drives only the
i.i.d. channel so far; the presets here are carried for the scenario
engine that a later slice brings.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

__all__ = [
    "ScenarioConfig",
    "SCENARIOS",
    "get_scenario",
    "bessel_j0",
    "jakes_rho",
    "uniform_to_gauss",
    "exp_to_gauss",
    "gauss_to_exp_power",
    "ar1_step",
    "ge_step",
    "ge_stationary_bad",
    "ge_mean_burst",
    "trajectory_offset_db",
]

_NORM = NormalDist()
# Copula clips: keep CDF values strictly inside (0, 1) so the inverse maps
# stay finite.  1 - 1e-16 is the largest f64 strictly below 1.
_U_LO = 1e-300
_U_HI = 1.0 - 1e-16
_SPEED_OF_LIGHT = 299_792_458.0


def bessel_j0(x: float) -> float:
    """Bessel function of the first kind, order zero.

    Abramowitz & Stegun 9.4.1 / 9.4.3 polynomial approximations (|err| <
    1.6e-7 over the real line) — enough for a fading correlation
    coefficient, without a scipy dependency the CI image doesn't ship.
    """
    ax = abs(float(x))
    if ax < 8.0:
        y = ax * ax
        num = 57568490574.0 + y * (-13362590354.0 + y * (651619640.7 + y * (
            -11214424.18 + y * (77392.33017 + y * -184.9052456))))
        den = 57568490411.0 + y * (1029532985.0 + y * (9494680.718 + y * (
            59272.64853 + y * (267.8532712 + y))))
        return num / den
    z = 8.0 / ax
    y = z * z
    p0 = 1.0 + y * (-0.1098628627e-2 + y * (0.2734510407e-4 + y * (
        -0.2073370639e-5 + y * 0.2093887211e-6)))
    q0 = -0.1562499995e-1 + y * (0.1430488765e-3 + y * (
        -0.6911147651e-5 + y * (0.7621095161e-6 + y * -0.934935152e-7)))
    xx = ax - 0.785398164
    return math.sqrt(0.636619772 / ax) * (
        math.cos(xx) * p0 - z * math.sin(xx) * q0
    )


def jakes_rho(velocity_mps: float, carrier_hz: float, slot_s: float) -> float:
    """AR(1) coefficient matching Jakes' Doppler autocorrelation.

    Clarke/Jakes: the fading autocorrelation at lag ``tau`` is
    ``J_0(2 pi f_d tau)`` with maximum Doppler shift ``f_d = v f_c / c``.
    One federated round advances the channel by one coherence slot
    ``slot_s``, so the round-to-round correlation is ``J_0(2 pi f_d T)``.
    Clipped to ``[0, 1)`` — past the first Bessel zero the closed form goes
    negative (anti-correlated fading), which the AR(1) surrogate does not
    model; such fast mobility is effectively i.i.d. round to round.
    """
    f_d = abs(velocity_mps) * carrier_hz / _SPEED_OF_LIGHT
    rho = bessel_j0(2.0 * math.pi * f_d * slot_s)
    return min(max(rho, 0.0), 1.0 - 1e-9)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Declarative channel-dynamics scenario.

    The default instance (``rho = 0``, no Gilbert-Elliott parameters, flat
    trajectory) reproduces the i.i.d. simulator bit for bit; every field is
    a *data* knob, so the compiled multi-round scan serves all scenarios
    from one executable.

    ``rho`` is the AR(1) fading correlation; setting ``velocity_mps``
    derives it from Jakes' model instead (``carrier_hz``/``slot_s``).
    ``p_gb``/``p_bg`` are the Gilbert-Elliott good->bad / bad->good
    transition probabilities; both-``None`` derives the i.i.d.-equivalent
    chain from ``ChannelConfig.dropout_prob``.  The trajectory fields add a
    deterministic per-client mean-SNR offset
    ``drift * t + amp * sin(2 pi (t / period + cid / num_clients))``.
    """

    name: str = "iid"
    rho: float = 0.0
    velocity_mps: float | None = None
    carrier_hz: float = 2.6e9
    slot_s: float = 5e-3
    p_gb: float | None = None
    p_bg: float | None = None
    snr_drift_db_per_round: float = 0.0
    snr_amp_db: float = 0.0
    snr_period_rounds: float = 50.0

    def __post_init__(self):
        if not (0.0 <= self.rho < 1.0):
            raise ValueError(f"rho must be in [0, 1), got {self.rho}")
        for field in ("p_gb", "p_bg"):
            v = getattr(self, field)
            if v is not None and not (0.0 <= v <= 1.0):
                raise ValueError(f"{field} must be in [0, 1], got {v}")
        if (self.p_gb is None) != (self.p_bg is None):
            raise ValueError("set p_gb and p_bg together (or neither)")
        if self.snr_period_rounds <= 0.0:
            raise ValueError("snr_period_rounds must be positive")

    @property
    def effective_rho(self) -> float:
        """AR(1) coefficient actually driving the fading chain."""
        if self.velocity_mps is not None:
            return jakes_rho(self.velocity_mps, self.carrier_hz, self.slot_s)
        return self.rho

    def ge_params(self, dropout_prob: float) -> tuple[float, float]:
        """(p_gb, p_bg), deriving the i.i.d.-equivalent chain when unset.

        ``(dropout_prob, 1 - dropout_prob)`` makes both transition
        thresholds equal to ``dropout_prob``, so the chain degenerates to
        the memoryless coin regardless of its state.
        """
        if self.p_gb is not None:
            return float(self.p_gb), float(self.p_bg)
        return float(dropout_prob), 1.0 - float(dropout_prob)

    def outage_active(self, dropout_prob: float) -> bool:
        p_gb, _ = self.ge_params(dropout_prob)
        return p_gb > 0.0


def uniform_to_gauss(u: np.ndarray | float) -> np.ndarray:
    """Map uniform draws to standard normals: ``z = Phi^{-1}(u)``."""
    u = np.clip(np.asarray(u, dtype=np.float64), _U_LO, _U_HI)
    flat = np.array([_NORM.inv_cdf(float(v)) for v in np.atleast_1d(u).ravel()])
    return flat.reshape(np.atleast_1d(u).shape)


def exp_to_gauss(p: np.ndarray | float) -> np.ndarray:
    """Map Exp(1) draws to standard normals through the shared copula:
    ``w = Phi^{-1}(1 - exp(-p))`` (f64, stdlib NormalDist — no scipy)."""
    u = np.clip(-np.expm1(-np.asarray(p, dtype=np.float64)), _U_LO, _U_HI)
    flat = np.array([_NORM.inv_cdf(float(v)) for v in np.atleast_1d(u).ravel()])
    return flat.reshape(np.atleast_1d(u).shape)


def gauss_to_exp_power(z: np.ndarray | float) -> np.ndarray:
    """Inverse copula map: ``power = -log(1 - Phi(z))`` — Exp(1) whenever
    ``z ~ N(0, 1)``, so the AR(1) chain's stationary marginal is exactly
    the i.i.d. model's Rayleigh power."""
    za = np.atleast_1d(np.asarray(z, dtype=np.float64))
    u = np.array([_NORM.cdf(float(v)) for v in za.ravel()]).reshape(za.shape)
    return -np.log1p(-np.clip(u, 0.0, _U_HI))


def ar1_step(z: np.ndarray, w: np.ndarray, rho: float) -> np.ndarray:
    """One stationary AR(1) update: ``z' = rho z + sqrt(1 - rho^2) w``."""
    return rho * np.asarray(z) + math.sqrt(max(0.0, 1.0 - rho * rho)) * np.asarray(w)


def ge_step(
    bad: np.ndarray, u: np.ndarray, p_gb: float, p_bg: float
) -> np.ndarray:
    """One Gilbert-Elliott transition from uniform draws ``u``.

    ``bad' = u < 1 - p_bg`` from the bad state (stay-bad probability),
    ``bad' = u < p_gb`` from the good state.  With the i.i.d.-equivalent
    parameters both thresholds are ``dropout_prob``, making the chain's
    draws bit-identical to the memoryless dropout coin.
    """
    return np.where(np.asarray(bad), u < 1.0 - p_bg, u < p_gb)


def ge_stationary_bad(p_gb: float, p_bg: float) -> float:
    """Stationary P(bad) = p_gb / (p_gb + p_bg) (0 when the chain never
    leaves the good state)."""
    denom = p_gb + p_bg
    return p_gb / denom if denom > 0.0 else 0.0


def ge_mean_burst(p_bg: float) -> float:
    """Closed-form mean bad-burst length: geometric escape, ``1 / p_bg``."""
    return 1.0 / p_bg if p_bg > 0.0 else math.inf


def trajectory_offset_db(
    scenario: ScenarioConfig, round_index: int, cid: int, num_clients: int
) -> float:
    """Deterministic mean-SNR offset of client ``cid`` at round ``t``:
    linear drift plus a per-client phase-shifted sinusoid (mobility around
    the cell).  Identically zero for the default scenario."""
    if scenario.snr_drift_db_per_round == 0.0 and scenario.snr_amp_db == 0.0:
        return 0.0
    phase = round_index / scenario.snr_period_rounds + cid / max(1, num_clients)
    return (
        scenario.snr_drift_db_per_round * round_index
        + scenario.snr_amp_db * math.sin(2.0 * math.pi * phase)
    )


# ---------------------------------------------------------------------------
# Named presets (the scenario suite's axes).  ``iid`` is today's behaviour;
# every other preset differs ONLY through data knobs, so all of them share
# one compiled multi-round executable.
# ---------------------------------------------------------------------------

SCENARIOS: dict[str, ScenarioConfig] = {
    # i.i.d. per-round fading + memoryless dropout — bit-identical to a
    # ChannelConfig without any scenario attached.
    "iid": ScenarioConfig(name="iid"),
    # Strongly time-correlated fading: a client in deep fade tends to stay
    # there for ~1/(1-rho) rounds (correlated stragglers).
    "gauss_markov": ScenarioConfig(name="gauss_markov", rho=0.9),
    # Pedestrian mobility at 2.6 GHz: rho = J0(2 pi f_d T) ~ 0.98 for
    # v = 1 m/s, T = 5 ms — slower-than-GM decorrelation.
    "jakes": ScenarioConfig(name="jakes", velocity_mps=1.0),
    # Bursty outage: mean bad burst 1/p_bg = 4 rounds, stationary outage
    # probability p_gb/(p_gb+p_bg) ~ 0.29.
    "gilbert_elliott": ScenarioConfig(
        name="gilbert_elliott", p_gb=0.1, p_bg=0.25
    ),
    # Correlated fading + deterministic per-client mobility: clients orbit
    # the base station (+/- 6 dB sinusoid) while slowly drifting away.
    "mobility": ScenarioConfig(
        name="mobility", rho=0.9, snr_amp_db=6.0,
        snr_drift_db_per_round=-0.05, snr_period_rounds=40.0,
    ),
}


def get_scenario(name: "str | ScenarioConfig | None") -> ScenarioConfig | None:
    """Resolve a scenario by preset name (pass-through for configs/None)."""
    if name is None or isinstance(name, ScenarioConfig):
        return name
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; known presets: {sorted(SCENARIOS)}"
        ) from None
