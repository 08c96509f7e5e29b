"""Communication protocol & byte accounting (paper §III-C + Fig. 3).

Everything a round transmits is described here, with its exact on-air size,
so the framework can reproduce the paper's Fig. 3 (communication cost to
reach accuracy thresholds) to the byte.

Paper cost model:
  * full logits upload:   samples * vocab * value_bits            (All-logits)
  * top-k upload:         samples * k * (value_bits + index_bits)
  * LoRA projection:      samples * r * value_bits                (h = A·x)
  * downlink (broadcast): samples * vocab * value_bits  (global logits)
                        + samples * r * value_bits      (global projection)

Zero-padding does not change the on-air size of a top-k upload (padding is a
server-side artifact), so "ZeroPad" and "Adaptive" differ in *rounds needed*,
not bytes/round — exactly how the paper's Fig. 3 separates them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core.channel import ChannelState, bits_per_entry

__all__ = [
    "PayloadSpec",
    "UplinkPayload",
    "RoundStats",
    "CommLedger",
    "topk_upload_bits",
    "full_logits_bits",
    "lora_projection_bits",
    "wire_uplink_bits",
    "downlink_bits",
    "total_round_bytes",
]


def full_logits_bits(num_samples: int, vocab: int, value_bits: int = 16) -> int:
    return num_samples * vocab * value_bits


def topk_upload_bits(num_samples: int, k: int, vocab: int, value_bits: int = 16) -> int:
    return num_samples * k * bits_per_entry(value_bits, vocab)


def lora_projection_bits(num_samples: int, rank: int, value_bits: int = 16) -> int:
    return num_samples * rank * value_bits


def wire_uplink_bits(
    num_samples: int, ks: Iterable[int], vocab: int, value_bits: int = 16
) -> int:
    """On-air bits of a whole cohort's sparse wire payload
    (:class:`repro_torch.core.topk.SparseWire`): only the MASKED-IN (value, index)
    entries are transmitted — the static ``k_cap`` padding is a server-side
    representation artifact, exactly like dense zero-padding, so the wire
    format costs byte-for-byte what the per-client top-k manifests say:
    ``Σ_n samples · k_n · d`` (k == 0 stragglers contribute nothing)."""
    return sum(
        topk_upload_bits(num_samples, k, vocab, value_bits) for k in ks if k > 0
    )


@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """Static description of what one client sends per round.

    ``value_bits`` prices the (value, index) top-k entries — 8 for the
    int8-quantized wire, 16 for the float wire — while ``h_value_bits``
    prices the (unquantized) LoRA projection ``h`` separately; it defaults
    to ``value_bits`` so homogeneous-precision payloads are unchanged.
    """

    num_samples: int
    vocab: int
    k: int
    lora_rank: int | None = None  # None -> no projection exchanged
    value_bits: int = 16
    h_value_bits: int | None = None  # None -> value_bits

    @property
    def uplink_bits(self) -> int:
        bits = topk_upload_bits(self.num_samples, self.k, self.vocab, self.value_bits)
        if self.lora_rank is not None:
            h_bits = self.value_bits if self.h_value_bits is None else self.h_value_bits
            bits += lora_projection_bits(self.num_samples, self.lora_rank, h_bits)
        return bits

    @property
    def uplink_bytes(self) -> float:
        return self.uplink_bits / 8.0

    def fits(self, channel: ChannelState) -> bool:
        """Does the payload respect the Shannon budget?  (enforced invariant —
        property-tested)."""
        return self.uplink_bits <= channel.bit_budget + 1e-6


@dataclasses.dataclass
class UplinkPayload:
    """One client's realized upload for a round (arrays live elsewhere;
    this is the manifest used for accounting).

    ``attempts`` is the number of HARQ transmissions actually made:
    every attempt re-spends the full payload on the air, so the ledger
    bytes are ``attempts * spec.uplink_bytes``.  ``delivered=False`` marks
    a quarantined upload whose attempts were spent without a usable copy
    arriving — the bytes still count (they were transmitted), the payload
    just contributes nothing to aggregation.
    """

    client_id: int
    spec: PayloadSpec
    snr_db: float = float("nan")
    attempts: int = 1
    delivered: bool = True

    @property
    def bytes(self) -> float:
        return self.attempts * self.spec.uplink_bytes


@dataclasses.dataclass
class RoundStats:
    """Per-round ledger entry."""

    round_index: int
    uplink_bytes: float = 0.0
    downlink_bytes: float = 0.0
    server_accuracy: float = float("nan")
    client_accuracy: float = float("nan")
    distill_loss: float = float("nan")
    mean_k: float = float("nan")
    # Clients that actually uploaded this round (straggler/dropout scenarios
    # can leave selected clients with k == 0 -> they transmit nothing and are
    # excluded from aggregation).  None -> engine predates this field.
    num_selected: int | None = None
    num_transmitters: int | None = None
    # Fault-tolerance taps (None/0.0 when fault injection is off).
    # num_quarantined counts uploads the server rejected (corruption that
    # exhausted HARQ retries, or wire validation failures) — distinct from
    # num_crashed, whose uploads never arrived at all.  fault_counts breaks
    # the losses down per reason ("crash" | "corrupt" | "invalid_wire");
    # retrans_bytes is the on-air cost beyond each delivered payload's first
    # copy (HARQ retries + quarantined attempts), already included in
    # uplink_bytes.
    num_quarantined: int | None = None
    num_crashed: int | None = None
    fault_counts: dict | None = None
    retrans_bytes: float = 0.0

    @property
    def total_bytes(self) -> float:
        return self.uplink_bytes + self.downlink_bytes


class CommLedger:
    """Accumulates communication volume across rounds (drives Fig. 3)."""

    def __init__(self) -> None:
        self.rounds: list[RoundStats] = []

    def record(self, stats: RoundStats) -> None:
        self.rounds.append(stats)

    @property
    def total_mb(self) -> float:
        return sum(r.total_bytes for r in self.rounds) / 1e6

    @property
    def uplink_mb(self) -> float:
        return sum(r.uplink_bytes for r in self.rounds) / 1e6

    def mb_to_reach(self, accuracy: float, *, which: str = "server") -> float | None:
        """MB of total communication until the (server|client) accuracy first
        reaches ``accuracy`` — the paper's Fig. 3 metric.  None if never."""
        acc_field = "server_accuracy" if which == "server" else "client_accuracy"
        total = 0.0
        for r in self.rounds:
            total += r.total_bytes
            acc = getattr(r, acc_field)
            if not math.isnan(acc) and acc >= accuracy:
                return total / 1e6
        return None

    def summary(self) -> dict[str, float]:
        return {
            "rounds": float(len(self.rounds)),
            "total_mb": self.total_mb,
            "uplink_mb": self.uplink_mb,
            "final_server_acc": (
                self.rounds[-1].server_accuracy if self.rounds else float("nan")
            ),
        }


def downlink_bits(
    num_samples: int, vocab: int, rank: int | None, value_bits: int = 16
) -> int:
    """Server broadcast: global logits (+ global projection)."""
    bits = full_logits_bits(num_samples, vocab, value_bits)
    if rank is not None:
        bits += lora_projection_bits(num_samples, rank, value_bits)
    return bits


def total_round_bytes(payloads: Iterable[UplinkPayload], downlink_bits_: int) -> float:
    return sum(p.bytes for p in payloads) + downlink_bits_ / 8.0
