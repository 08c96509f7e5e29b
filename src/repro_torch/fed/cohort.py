"""Family buckets of a (possibly mixed) client fleet — the port of
``repro/fed/cohort.py``.

The cohort engines run a cohort on one leading client axis, which needs
every stacked client to share one parameter layout.  A mixed fleet is cut
into homogeneous family buckets, the groups of clients that run the same
:class:`~repro_torch.configs.base.ModelConfig`; each bucket runs its own
client phase, and the buckets' uploads merge in the vocab-indexed logit
space, where an architecture leaves no trace.  Within a bucket the frozen
backbones may differ per client (``shared_backbone=False``): the bucket then
stacks them on the client axis, as the fleet store does for any fleet.

The cross-family contracts are the paper's own (§II): one vocabulary (the
logit exchange space) and one LoRA rank (eq. 8's projection lives in
R^r), which :func:`validate_family_contracts` checks when an engine is
built.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.fed.client import Client

__all__ = [
    "FamilyBucket",
    "partition_fleet",
    "fleet_index",
    "split_cohort",
    "validate_family_contracts",
]


@dataclasses.dataclass(frozen=True)
class FamilyBucket:
    """One homogeneous slice of the fleet: every member runs ``cfg``.
    ``client_ids`` are global fleet ids in fleet order, a client's
    bucket-local index its place in this tuple; ``shared_backbone`` is True
    iff every member's frozen tree is the same tensors."""

    index: int
    cfg: ModelConfig
    client_ids: tuple[int, ...]
    shared_backbone: bool

    @property
    def size(self) -> int:
        return len(self.client_ids)

    def local(self, global_id: int) -> int:
        """Bucket-local index of a global fleet id."""
        return self.client_ids.index(global_id)


def partition_fleet(clients: Sequence[Client]) -> list[FamilyBucket]:
    """The fleet's family buckets by config value, in order of first
    appearance (a homogeneous fleet is one bucket)."""
    from repro_torch.fed.engines.base import shared_frozen_backbone
    from repro_torch.lora import split_lora

    members: dict[ModelConfig, list[int]] = {}
    for i, c in enumerate(clients):
        members.setdefault(c.cfg, []).append(i)
    return [
        FamilyBucket(index=bi, cfg=cfg, client_ids=tuple(ids),
                     shared_backbone=shared_frozen_backbone(
                         [split_lora(clients[i].params)[1] for i in ids]))
        for bi, (cfg, ids) in enumerate(members.items())
    ]


def fleet_index(buckets: Sequence[FamilyBucket]) -> dict[int, tuple[int, int]]:
    """``global fleet id -> (bucket index, bucket-local index)``."""
    return {cid: (b.index, j) for b in buckets for j, cid in enumerate(b.client_ids)}


def split_cohort(
    buckets: Sequence[FamilyBucket], sel: Sequence[int]
) -> list[tuple[FamilyBucket, list[int], list[int]]]:
    """One round's cohort across its buckets: ``(bucket, cohort positions,
    bucket-local ids)`` for every bucket with a selected client, in cohort
    order within each bucket (a bucket's first selected client is its row
    0)."""
    where = {cid: b for b in buckets for cid in b.client_ids}
    parts = []
    for b in buckets:
        pos = [p for p, cid in enumerate(sel) if where[int(cid)] is b]
        if pos:
            parts.append((b, pos, [b.local(int(sel[p])) for p in pos]))
    return parts


def validate_family_contracts(buckets: Sequence[FamilyBucket], *,
                              server_cfg: ModelConfig | None = None) -> None:
    """The paper's cross-family contracts (§II), for the buckets and the
    server when given: one vocabulary, and one LoRA rank (or LoRA nowhere)."""
    cfgs = [b.cfg for b in buckets] + ([server_cfg] if server_cfg is not None else [])
    vocabs = {c.vocab_size for c in cfgs}
    if len(vocabs) > 1:
        raise ValueError(
            "heterogeneous fleet must share one vocabulary (the logit exchange space), got "
            f"vocab sizes {sorted(vocabs)}"
        )
    ranks = {None if c.lora is None else c.lora.rank for c in cfgs}
    if len(ranks) > 1:
        raise ValueError(
            "heterogeneous fleet must share one LoRA rank for the eq.-8 projection exchange "
            f"(or disable LoRA everywhere), got {ranks}"
        )
