"""Round engines — the port of ``repro/fed/engines``:

* :class:`SequentialEngine` — the reference executor: one client at a
  time through its own :class:`~repro_torch.fed.client.Client` methods.
* :class:`BatchedEngine` — every phase of the client round as one step
  over a leading client axis; the exact per-client top-k as the dense
  uplink.
* :class:`FusedEngine` — the batched engine's phases as one round
  function; the uplink is the per-row-budget bisection top-k (the CUDA
  kernel with ``use_kernels``).
* :class:`FusedE2EEngine` — the whole round, client and server phase, as
  one function call with the sparse wire between them; ``run_rounds``
  runs a block of rounds without a host round trip between them.
* :class:`HeteroClientEngine` / :class:`HeteroFusedE2EEngine` — the
  family-bucketed versions of the cohort engines for mixed fleets
  (:mod:`repro_torch.fed.cohort`).

The cohort engines keep the fleet in a fleet store
(:mod:`repro_torch.fed.store`: the device store, or the host store that
stages each cohort onto the device); all four are driven by
:func:`repro_torch.fed.rounds.run_federated`.  A client whose channel
yields ``k == 0`` transmits nothing and is left out of the aggregation.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.fed.client import Client
from repro_torch.fed.engines.base import (
    BroadcastState,
    ClientPhase,
    RoundsTrajectory,
    SequentialEngine,
    check_unique_cohort,
    cohort_budgets,
    fake_quant_dense,
    k_cap_bucket,
    shared_frozen_backbone,
)
from repro_torch.fed.engines.batched import BatchedEngine
from repro_torch.fed.engines.e2e import FusedE2EEngine
from repro_torch.fed.engines.fused import FusedEngine
from repro_torch.fed.engines.hetero import HeteroClientEngine, HeteroFusedE2EEngine
from repro_torch.models.layers import FLOAT_DTYPES

__all__ = [
    "BroadcastState",
    "ClientPhase",
    "RoundsTrajectory",
    "SequentialEngine",
    "BatchedEngine",
    "FusedEngine",
    "FusedE2EEngine",
    "HeteroClientEngine",
    "HeteroFusedE2EEngine",
    "make_engine",
    "check_unique_cohort",
    "cohort_budgets",
    "fake_quant_dense",
    "k_cap_bucket",
    "shared_frozen_backbone",
]


def make_engine(kind: str, clients: list[Client], cfg: ModelConfig, **kwargs):
    """Build a round engine, dropping the keyword arguments that ``kind``
    does not take, as the reference's ``make_engine`` does: the batched
    engine drops ``shard_clients``, ``use_kernels`` (its aggregation kernel
    runs in the Server) and ``compute_dtype``, and the sequential engine
    takes only ``value_bits`` and ``k_min`` (``shard_clients`` among what
    it drops) and keeps the reference's own refusals.  ``fused`` and
    ``fused_e2e`` take ``shard_clients`` (:mod:`repro_torch.sharding`).
    A fleet whose clients run more than one config is served by the
    family-bucketed engines for every cohort ``kind``, and natively by
    ``sequential`` (each client runs its own architecture)."""
    if kind != "fused_e2e":
        for e2e_only in ("server", "server_distill_steps", "aggregation"):
            kwargs.pop(e2e_only, None)
    if kind == "sequential":
        if kwargs.get("quantize_wire"):
            raise NotImplementedError(
                "quantize_wire is not supported by the sequential reference"
                " engine — use 'batched', 'fused' or 'fused_e2e'"
            )
        if kwargs.get("compute_dtype", "float32") != "float32":
            raise NotImplementedError(
                "compute_dtype is not supported by the sequential reference"
                " engine — use 'fused' or 'fused_e2e'"
            )
        store = kwargs.get("fleet_store", "device")
        if store != "device" and getattr(store, "kind", store) != "device":
            raise NotImplementedError(
                "fleet_store='host' is not supported by the sequential"
                " reference engine (it keeps per-client state inside the"
                " Client objects) — use 'batched', 'fused' or 'fused_e2e'"
            )
        return SequentialEngine(
            clients, cfg, value_bits=kwargs.get("value_bits", 16), k_min=kwargs.get("k_min", 1)
        )
    if kind not in ("batched", "fused", "fused_e2e"):
        raise ValueError(
            f"unknown engine: {kind!r} (expected 'sequential', 'batched', 'fused' or 'fused_e2e')"
        )
    hetero = len({c.cfg for c in clients}) > 1
    if kind == "batched":
        # the fp32 per-phase reference: the low-precision round body exists only on
        # the fused paths, and the batched engine has no kernel of its own
        for dropped in ("shard_clients", "use_kernels", "compute_dtype"):
            kwargs.pop(dropped, None)
        if hetero:
            return HeteroClientEngine(kind, clients, **kwargs)
        return BatchedEngine(clients, cfg, **kwargs)
    if kwargs.get("compute_dtype", "float32") not in FLOAT_DTYPES:
        raise ValueError(f"compute_dtype={kwargs['compute_dtype']!r}; expected one of "
                         f"{', '.join(FLOAT_DTYPES)}")
    if kind == "fused":
        if hetero:
            return HeteroClientEngine(kind, clients, **kwargs)
        return FusedEngine(clients, cfg, **kwargs)
    if hetero:
        return HeteroFusedE2EEngine(clients, **kwargs)
    return FusedE2EEngine(clients, cfg, **kwargs)
