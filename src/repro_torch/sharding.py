"""The federated cohort axis over processes — the port of the cohort part
of ``repro/sharding.py``.

The round engines' leading client axis is embarrassingly parallel
(Algorithm 1 runs each selected client independently).  The reference
places it over a process's devices with ``shard_map``; the port places it
over the ranks of a ``torch.distributed`` process group, one process per
device.  ``shard_clients=True`` runs the client phase on each rank's block
of the cohort, gathers the blocks into cohort order on every rank, and
runs the server phase, replicated, on the gathered cohort: every rank then
holds the state the reference's single controller sees.

A cohort that does not divide the world size is padded with duplicate
rows of its first client; they ride at ``k = 0`` and are dropped right
after the gather (:class:`CohortShard`), before anything reads them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.utils import _pytree

__all__ = ["COHORT_AXIS", "CohortShard", "cohort_mesh", "gather_cohort", "rank", "world_size"]

COHORT_AXIS = "clients"


def cohort_mesh(device: str | torch.device = "cuda"):
    """A 1-D ``DeviceMesh`` named :data:`COHORT_AXIS` over the ranks of the
    default process group: where the round engines place the selected
    cohort (``shard_clients``).  The caller that starts the processes
    initialises that group and chooses its backend; without one, a
    one-rank group is made here on a ``HashStore`` (NCCL on the card, gloo
    on the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return DeviceMesh(device.type, list(range(dist.get_world_size())),
                      mesh_dim_names=(COHORT_AXIS,))


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def gather_cohort(tree, group=None):
    """All-gather every rank's block of the cohort axis into cohort order.

    ``tree``: dicts, tuples and named tuples of tensors whose leading axis
    is this rank's block (the same shape on every rank); other leaves
    (``None``, ints) pass through.  The tensors travel as one byte buffer,
    so every dtype (bool masks, int8 wires) crosses bit for bit, in one
    collective.  gloo's path stages a card's tensors through host copies:
    the buffer is gathered on the host and copied back once."""
    leaves, spec = _pytree.tree_flatten(tree)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if not tensors:
        return tree
    device = tensors[0].device
    parts = [x.contiguous().reshape(-1).view(torch.uint8) for x in tensors]
    buf = torch.cat(parts)
    if dist.get_backend(group) == "gloo" and device.type != "cpu":
        buf = buf.cpu()
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    per_rank = torch.stack(out).to(device).split([p.numel() for p in parts], dim=1)
    gathered = iter(
        # each rank's bytes of a leaf, in rank order (the blocks in cohort
        # order), copied into storage of its own: a leaf never aliases the
        # buffer at an offset its dtype's kernels would not choose
        chunk.clone().view(x.dtype).reshape(len(out) * x.shape[0], *x.shape[1:])
        for chunk, x in zip(per_rank, tensors)
    )
    return _pytree.tree_unflatten(
        [next(gathered) if isinstance(x, torch.Tensor) else x for x in leaves], spec)


@dataclasses.dataclass(frozen=True)
class CohortShard:
    """One rank's block of a cohort of ``n`` real clients, padded by
    ``pad = (-n) % world`` duplicate rows of its first client."""

    n: int
    rank: int
    world: int
    group: object = None

    @classmethod
    def of(cls, mesh, n: int) -> "CohortShard":
        return cls(n=n, rank=mesh.get_local_rank(), world=mesh.size(), group=mesh.get_group())

    @property
    def pad(self) -> int:
        return (-self.n) % self.world

    @property
    def rows(self) -> int:
        """The rows of the padded cohort each rank computes."""
        return (self.n + self.pad) // self.world

    def padded(self, rows):
        """``rows`` (a list, or a tensor whose leading axis is the cohort)
        with the pad rows, copies of the first, appended."""
        if isinstance(rows, torch.Tensor):
            return torch.cat([rows, rows[:1].expand(self.pad, *rows.shape[1:])])
        return list(rows) + [rows[0]] * self.pad

    def block(self, rows):
        """This rank's rows of the padded cohort."""
        lo = self.rank * self.rows
        return rows[lo:lo + self.rows]

    def block_ks(self, ks_dev: torch.Tensor) -> torch.Tensor:
        """This rank's budgets: the pad rows transmit nothing (``k = 0``)."""
        return self.block(torch.cat([ks_dev, ks_dev.new_zeros(self.pad)]))

    def gather(self, tree):
        """Every rank's block, gathered into cohort order, the pad rows
        dropped: the real cohort's rows on every rank."""
        return _pytree.tree_map(lambda x: x[:self.n] if isinstance(x, torch.Tensor) else x,
                                gather_cohort(tree, self.group))
