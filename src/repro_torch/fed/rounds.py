"""Federated AdaLD round orchestration (paper Algorithm 1 + §IV setup) —
the port of ``repro/fed/rounds.py`` for the ``sequential``, ``batched``,
``fused`` and ``fused_e2e`` engines.

One communication round: the server's last broadcast {K_g, h_g} reaches
the selected clients, who distill against it, fine-tune on private data,
infer the public set and upload adaptive top-k logits (+ LoRA
projections); the server aggregates them, distills into the LLM and
recomputes the broadcast.  ``fused_e2e`` does the server's part inside its
round, from the sparse wire; the other engines hand the round loop the
transmitters' dense top-k stack for the :class:`Server`.  Host-side draws (cohorts, public batches,
channels, client batch streams) use the reference's numpy streams in the
reference's order, so both packages see identical data under one seed.

A fleet may mix model families (``client_cfg`` a sequence of configs:
client i runs ``client_cfg[i % F]``); the cohort engines then run it
through their family-bucketed forms (:mod:`repro_torch.fed.cohort`), and
``sequential`` natively.  With ``pretrain_steps > 0`` (the default) one
backbone per model family is pretrained first on a split that the run
never sees, and shared by that family's clients as the frozen W' of paper
eq. 1; the server's is LM-pretrained by default.  ``scan_rounds``
(``fused_e2e`` only) draws every round first and runs them as one block,
``FusedE2EEngine.run_rounds`` (``HeteroFusedE2EEngine.run_rounds`` on a
mixed fleet, whose block also fills ``family_client_acc``).

``FedConfig.scenario`` gives the channel time-correlated dynamics
(``repro_torch.core.scenario``), which a block also evolves on the device;
``FedConfig.faults`` injects corruption with HARQ retries, crashes and
bursty episodes (``repro_torch.core.faults``): a lost upload is forced to
k = 0 before any engine sees the round, and its bytes stay on the ledger.
``ckpt_dir`` writes a crash-safe checkpoint after every round (after the
block with ``scan_rounds``) in the reference's npz layout, a host store's
fleet as shards beside it, and ``resume=True`` continues from the newest
one, JAX-written or not, under either store.  ``fleet_store="host"`` keeps
the fleet in host memory and stages each cohort onto the device, round
r+1's under round r; ``scan_rounds`` then runs the per-round loop.

``shard_clients`` (``fused``, ``fused_e2e``) splits each round's client
phase over the ranks of the default process group
(:mod:`repro_torch.sharding`); every rank runs the whole loop and holds the
same state.  Under a group of more than one rank, rank 0 alone prints and
writes checkpoints, and every rank waits for the write; every rank reads
on resume.

What the port does not carry yet raises ``NotImplementedError`` naming its
entry in ROADMAP.md's port queue.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Literal, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.checkpoint import ckpt as ckpt_io
from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import ChannelConfig, ChannelSimulator
from repro_torch.core.faults import FaultSimulator, get_faults, validate_dense
from repro_torch.core.protocol import CommLedger, RoundStats, downlink_bits
from repro_torch.core.scenario import get_scenario
from repro_torch.data.partition import dirichlet_partition, iid_partition, split_public_private
from repro_torch.data.synthetic import IntentDataset
from repro_torch.fed.client import Client, make_upload_payload
from repro_torch.fed.engines import BroadcastState, cohort_budgets, make_engine
from repro_torch.fed.engines.base import client_axis_opt, one_model_opt
from repro_torch.fed.pretrain import pretrain_classifier, pretrain_lm
from repro_torch.fed.server import Server
from repro_torch.fed.steps import EVAL_BATCH, make_eval_fn
from repro_torch.fed.store import owned_copy
from repro_torch.models import model as model_lib

__all__ = ["FedConfig", "FedRun", "run_federated", "METHODS"]

Method = Literal["adald", "adaptive", "zeropad", "all_logits"]

METHODS: dict[str, dict] = {
    "adald": dict(aggregation="adaptive", send_h=True, adaptive_k=True),
    "adaptive": dict(aggregation="adaptive", send_h=False, adaptive_k=True),
    "zeropad": dict(aggregation="zeropad", send_h=False, adaptive_k=True),
    "all_logits": dict(aggregation="zeropad", send_h=False, adaptive_k=False),
}


@dataclasses.dataclass
class FedConfig:
    """The reference's FedConfig, field for field and default for default,
    so one configuration means the same run in both packages."""

    method: Method = "adald"
    engine: str = "batched"
    last_only: bool = True
    shard_clients: bool = False
    scan_rounds: bool = False
    fleet_store: str = "device"
    num_clients: int = 50
    clients_per_round: int = 10
    rounds: int = 20
    public_size: int = 2000
    non_iid: bool = True
    dirichlet_gamma: float = 0.5
    seed: int = 0
    temperature: float = 2.0
    lam: float = 0.03
    lr: float = 1e-3
    distill_lr: float = 3e-3
    local_steps: int = 4
    distill_steps: int = 2
    server_distill_steps: int = 12
    public_batch: int = 256
    eval_size: int = 512
    use_kernels: bool = False
    restrict_to_support: bool = False
    quantize_wire: bool = False
    compute_dtype: str = "float32"
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    scenario: object = None
    faults: object = None
    pretrain_steps: int = 80
    pretrain_frac: float = 0.12
    pretrain_lr: float = 2e-3
    server_pretrain: str = "lm"
    server_pretrain_steps: int = 60


@dataclasses.dataclass
class FedRun:
    ledger: CommLedger
    server_acc: list[float]
    client_acc: list[float]
    mean_k: list[float]
    # per round, each selected client's DELIVERED k (0: dropped, crashed or
    # quarantined)
    per_client_k: list[list[int]] = dataclasses.field(default_factory=list)
    distill_loss: list[float] = dataclasses.field(default_factory=list)
    # host wall-clock seconds of each round, its evaluation included (NaN
    # for a round restored from a checkpoint that does not record it)
    round_seconds: list[float] = dataclasses.field(default_factory=list)
    # mixed fleets' block tap: not carried by the port (always None)
    family_client_acc: list[list[float]] | None = None
    # scenario blocks only: per round, the cohort's SNR (dB, -inf in
    # outage) and outage flags from the block's channel tap
    snr_db: list[list[float]] | None = None
    outage: list[list[bool]] | None = None
    # fault-injection runs only: per round, the quarantined uploads (HARQ
    # exhausted, plus the server gate's rejections), the crashes, the bytes
    # beyond each delivered payload's first copy (in the ledger's uplink
    # too), and each selected client's ATTEMPTED k
    num_quarantined: list[int] | None = None
    num_crashed: list[int] | None = None
    retrans_bytes: list[float] | None = None
    attempted_k: list[list[int]] | None = None

    def summary(self) -> dict:
        # NaN-safe best: an all-dropped round evaluates to NaN, and max()
        # over a list with NaN in it depends on the order
        finite = [a for a in self.server_acc if np.isfinite(a)]
        return {**self.ledger.summary(), "best_server_acc": max(finite) if finite else float("nan")}


_TAPS = ("num_quarantined", "num_crashed", "retrans_bytes", "attempted_k", "family_client_acc",
         "snr_db", "outage")


def _config_fingerprint(fed: FedConfig) -> dict:
    """The FedConfig as JSON for the resume check, identical to the
    reference's for the same configuration: ``rounds`` is left out
    (extending a run is what resume is for), and so is ``fleet_store``
    (residency does not change the trajectory)."""
    d = dataclasses.asdict(fed)
    d.pop("rounds")
    d.pop("fleet_store", None)
    return json.loads(json.dumps(d, sort_keys=True, default=str))


def _check_carried(families: list[ModelConfig], fed: FedConfig) -> None:
    """Raise before any work on a model whose dtype names the port does not
    take (float32, bfloat16 and float16 it does); ``make_engine`` checks the
    engine's own options (kind, shard_clients, compute_dtype, fleet_store)."""
    for cfg in families:
        model_lib.check_supported(cfg)


def run_federated(
    client_cfg: ModelConfig | Sequence[ModelConfig],
    server_cfg: ModelConfig,
    dataset: IntentDataset,
    fed: FedConfig,
    *,
    verbose: bool = False,
    ckpt_dir: str | None = None,
    resume: bool = False,
    device: str | torch.device = "cuda",
) -> FedRun:
    """Run the whole federation on ``device`` (the card unless the caller
    asks for ``"cpu"``).  ``client_cfg`` is one config (every client runs
    it) or a sequence of family configs, client i running
    ``client_cfg[i % F]``; the families must share one vocabulary and one
    LoRA rank with the server (the paper's §II exchange contracts).  With
    ``pretrain_steps > 0`` the clients of family ``fi`` share one
    pretrained backbone (seed ``fed.seed + 17 * fi``) under their own
    adapters (seed ``fed.seed + i``), and the server starts from its own
    pretraining (``server_pretrain``: ``"lm"``, ``"supervised"`` or
    ``"none"``, seed ``fed.seed + 999``); without, each client inits its own
    backbone (seed ``fed.seed + i``) and the server inits from ``fed.seed +
    999``.

    ``ckpt_dir`` writes ``step_{r}`` after every completed round (after
    every completed block with ``scan_rounds``).  ``resume=True`` restores
    the newest valid checkpoint there and continues: the host draws and
    each selected client's batch stream are replayed through the completed
    rounds, the device state is restored, and channels and faults replay
    from their (seed, round, cid) keys, so the resumed ``FedRun`` is the
    uninterrupted run's.  With no checkpoint in ``ckpt_dir`` it starts
    from round 0.  Under a process group of more than one rank (each rank
    calls this with the same arguments), rank 0 alone prints and writes."""
    families = [client_cfg] if isinstance(client_cfg, ModelConfig) else list(client_cfg)
    if not families:
        raise ValueError("client_cfg must name at least one model config")
    _check_carried(families, fed)
    cfgs = [families[i % len(families)] for i in range(fed.num_clients)]
    ranks = sharding.world_size()
    lead = sharding.rank() == 0
    verbose = verbose and lead
    preset = METHODS[fed.method]
    rng = np.random.default_rng(fed.seed)

    fault_cfg = get_faults(fed.faults)
    if fault_cfg is not None and not fault_cfg.enabled:
        fault_cfg = None  # the "none" preset is no fault machinery at all
    if fault_cfg is not None and not preset["adaptive_k"]:
        raise ValueError(
            "fault injection requires an adaptive-k method (faulted clients are excluded "
            f"through the k = 0 transmit-mask path, which method {fed.method!r} never takes)"
        )

    if resume and ckpt_dir is None:
        raise ValueError("resume=True requires ckpt_dir")
    completed, ckpt_meta = 0, {}
    if resume:
        step = ckpt_io.latest_step(ckpt_dir)
        if step is not None:
            completed = int(step)
            ckpt_meta = ckpt_io.step_metadata(ckpt_dir, step) or {}
            stored, now = ckpt_meta.get("config"), _config_fingerprint(fed)
            if stored is not None and stored != now:
                diff = sorted(k for k in set(stored) | set(now) if stored.get(k) != now.get(k))
                raise ValueError(
                    f"checkpoint in {ckpt_dir} was written by a different FedConfig (differing "
                    f"fields: {diff}); resuming it would not reproduce the original trajectory"
                )
            if completed >= fed.rounds:
                raise ValueError(
                    f"checkpoint already holds {completed} completed rounds >= fed.rounds="
                    f"{fed.rounds}; raise fed.rounds to extend the run"
                )

    # a disjoint pretraining split first (the simulated pretrained W'): one
    # backbone per family, at fed.seed + 17 * family
    server_init = None
    client_inits: dict[ModelConfig, dict] = {}
    if fed.pretrain_steps > 0:
        n_pre = int(len(dataset) * fed.pretrain_frac)
        pre_idx = np.random.default_rng(fed.seed + 31).permutation(len(dataset))
        pretrain_ds = dataset.subset(pre_idx[:n_pre])
        dataset = dataset.subset(pre_idx[n_pre:])
        if completed:
            # resuming: the checkpoint holds every pretrained tensor, so no
            # pretraining runs; one placeholder backbone handed to every
            # client of a family rebuilds the store's shared layout before
            # the restore
            for fi, fam in enumerate(families):
                client_inits[fam] = model_lib.init(fam, fed.seed + 17 * fi, device)
        else:
            for fi, fam in enumerate(families):
                client_inits[fam] = pretrain_classifier(
                    fam, pretrain_ds, num_classes=dataset.num_classes,
                    steps=fed.pretrain_steps, lr=fed.pretrain_lr, seed=fed.seed + 17 * fi,
                    last_only=fed.last_only, verbose=verbose, device=device,
                )
            if fed.server_pretrain == "supervised":
                server_init = pretrain_classifier(
                    server_cfg, pretrain_ds, num_classes=dataset.num_classes,
                    steps=fed.server_pretrain_steps, lr=fed.pretrain_lr, seed=fed.seed + 999,
                    last_only=fed.last_only, verbose=verbose, device=device,
                )
            elif fed.server_pretrain == "lm":
                server_init = pretrain_lm(
                    server_cfg, pretrain_ds, steps=fed.server_pretrain_steps,
                    lr=fed.pretrain_lr, seed=fed.seed + 999, verbose=verbose, device=device,
                )

    public, private = split_public_private(dataset, fed.public_size, seed=fed.seed)
    if fed.non_iid:
        parts = dirichlet_partition(
            private.labels, fed.num_clients, gamma=fed.dirichlet_gamma, seed=fed.seed
        )
    else:
        parts = iid_partition(len(private), fed.num_clients, seed=fed.seed)
    clients = [
        Client(
            i, cfgs[i], private.subset(parts[i]), num_classes=dataset.num_classes,
            seed=fed.seed + i, lr=fed.lr, distill_lr=fed.distill_lr, temperature=fed.temperature,
            lam=fed.lam, local_steps=fed.local_steps, distill_steps=fed.distill_steps,
            restrict_to_support=fed.restrict_to_support, last_only=fed.last_only, device=device,
            initial_params=client_inits.get(cfgs[i]),
        )
        for i in range(fed.num_clients)
    ]
    server = Server(
        server_cfg, seed=fed.seed + 999, distill_lr=fed.distill_lr, temperature=fed.temperature,
        lam=fed.lam, aggregation=preset["aggregation"], distill_steps=fed.server_distill_steps,
        use_kernels=fed.use_kernels, restrict_to_support=fed.restrict_to_support,
        last_only=fed.last_only, device=device, initial_params=server_init,
    )
    channel_cfg = fed.channel
    if fed.scenario is not None:
        channel_cfg = dataclasses.replace(channel_cfg, scenario=get_scenario(fed.scenario))
    chan_sim = ChannelSimulator(fed.num_clients, channel_cfg, seed=fed.seed)
    fault_sim = (FaultSimulator(fed.num_clients, fault_cfg, seed=fed.seed)
                 if fault_cfg is not None else None)

    eval_idx = rng.permutation(len(private))[: fed.eval_size]
    eval_tokens = torch.as_tensor(private.tokens[eval_idx], device=device)
    eval_labels = torch.as_tensor(private.labels[eval_idx], device=device)
    evaluate = make_eval_fn(server_cfg, dataset.num_classes, last_only=fed.last_only)
    evaluate_client = {fam: make_eval_fn(fam, dataset.num_classes, last_only=fed.last_only)
                       for fam in families}

    engine = make_engine(
        fed.engine, clients, cfgs[0], num_classes=dataset.num_classes,
        lr=fed.lr, distill_lr=fed.distill_lr, temperature=fed.temperature, lam=fed.lam,
        local_steps=fed.local_steps, distill_steps=fed.distill_steps,
        restrict_to_support=fed.restrict_to_support, value_bits=fed.channel.value_bits,
        k_min=fed.channel.min_k, last_only=fed.last_only, shard_clients=fed.shard_clients,
        use_kernels=fed.use_kernels, quantize_wire=fed.quantize_wire,
        compute_dtype=fed.compute_dtype, fleet_store=fed.fleet_store,
        # fused_e2e only: the engine owns the server phase too
        server=server, server_distill_steps=fed.server_distill_steps,
        aggregation=preset["aggregation"],
    )
    handles_server = getattr(engine, "handles_server", False)

    ledger = CommLedger()
    run = FedRun(ledger=ledger, server_acc=[], client_acc=[], mean_k=[])
    if fault_sim is not None:
        run.num_quarantined, run.num_crashed, run.retrans_bytes, run.attempted_k = [], [], [], []
    pub_rng = np.random.default_rng(fed.seed + 7)

    def draw_round(rnd: int):
        """One round's host draws in the reference's canonical order:
        cohort, public batch, channel.  The per-round loop, the
        scan_rounds pre-draw and a resume's replay all go through here, so
        their rng streams cannot part."""
        sel = [int(i) for i in rng.choice(fed.num_clients, size=fed.clients_per_round,
                                          replace=False)]
        pub_tokens = torch.as_tensor(
            public.tokens[pub_rng.integers(0, len(public), size=fed.public_batch)], device=device
        )
        return sel, pub_tokens, chan_sim.states_batched(rnd, sel)

    def apply_faults(rnd, sel, states, fault_inputs=None, round_offset=0):
        """Resolve the round's deliveries and force the clients whose
        upload is lost (a crash, or corruption past the HARQ retries) to
        k = 0 before any engine sees the round, by putting their channel
        into outage (SNR -inf: no bit budget); every engine then leaves
        them out through its one transmit-mask path.  Returns ``(states',
        attempted ks, resolution, ghost manifests)``: the quarantined
        uploads' manifests, whose bytes were spent on air."""
        n_samples = fed.public_batch
        attempted = cohort_budgets(
            states, cfgs[sel[0]], n_samples, preset["adaptive_k"], len(sel), preset["send_h"],
            value_bits=fed.channel.value_bits, k_min=fed.channel.min_k,
            quantize_wire=fed.quantize_wire,
        )
        specs, payload_bits = [], []
        for i, cid in enumerate(sel):
            p = None
            if attempted[i] > 0:
                p, _rank = make_upload_payload(
                    cfgs[cid], cid, n_samples, attempted[i], send_h=preset["send_h"],
                    value_bits=fed.channel.value_bits, snr_db=float(states.snr_db[i]),
                    quantize=fed.quantize_wire,
                )
            specs.append(p)
            payload_bits.append(0.0 if p is None else float(p.spec.uplink_bits))
        budget_bits = [float(st.bit_budget) for st in states]
        if fault_inputs is not None:
            res = fault_sim.resolve_from_inputs(fault_inputs, round_offset, sel, attempted,
                                                payload_bits, budget_bits)
        else:
            res = fault_sim.resolve_round(rnd, sel, attempted, payload_bits, budget_bits)
        failed = [i for i, (k, d) in enumerate(zip(attempted, res.delivered)) if k > 0 and not d]
        if failed:
            snr = np.array(states.snr_db, dtype=np.float64)
            snr[failed] = -np.inf
            states = dataclasses.replace(states, snr_db=snr)
        ghosts = [specs[i] for i in failed if res.reasons[i] == "corrupt"]
        for i in failed:
            if res.reasons[i] == "corrupt":
                specs[i].attempts = res.attempts[i]
                specs[i].delivered = False
        return states, attempted, res, ghosts

    def fault_ledger(sel, res, ghosts, payloads):
        """Price the HARQ retries onto the delivered manifests, in place
        (so the engine's uplink bytes include them), and account the
        quarantined attempts.  Returns ``(bytes to add to the engine's
        uplink: the ghosts', the on-air bytes beyond each delivered
        payload's first copy, the RoundStats fault taps)``."""
        by_cid = {p.client_id: p for p in payloads}
        retrans = 0.0
        for i, cid in enumerate(sel):
            if res.delivered[i] and res.attempts[i] > 1:
                p = by_cid.get(cid)
                if p is not None:
                    p.attempts = res.attempts[i]
                    retrans += (res.attempts[i] - 1) * p.spec.uplink_bytes
        extra = float(sum(g.bytes for g in ghosts))
        retrans += extra
        counts: dict[str, int] = {}
        for r in res.reasons:
            if r is not None:
                counts[r] = counts.get(r, 0) + 1
        stats_kw = dict(num_quarantined=res.num_quarantined, num_crashed=res.num_crashed,
                        fault_counts=counts or None, retrans_bytes=retrans)
        return extra, retrans, stats_kw

    def record_fault_taps(attempted, res, retrans):
        run.num_quarantined.append(res.num_quarantined)
        run.num_crashed.append(res.num_crashed)
        run.retrans_bytes.append(retrans)
        run.attempted_k.append(list(attempted))

    # -- crash-safe checkpoints, in the reference's layout ---------------------
    # A host store's fleet is checkpointed as per-client-range shards beside
    # the step's npz, never as one tree: the shards first, the main npz
    # last, so a valid step file implies complete shards, and a crash while
    # the shards are written resumes from the step before.
    fleet_sharded = engine.store_kind == "host"

    def ckpt_tree(like: bool = False, include_fleet: bool = True) -> dict:
        """The federation's state as one tree: the fleet (backbone
        included), the server, and for a server-owning engine the
        broadcast carry, which ``like=True`` (the restore skeleton of a
        fresh engine) shapes from the config.  Round index and histories
        ride the JSON sidecar; channels and faults replay from their keys."""
        tree = {}
        if include_fleet:
            tree["fleet"] = engine.fleet_state()
        if handles_server:
            tree["server"] = engine.server_state()
            if like:
                bc = {"b_logits": torch.zeros((fed.public_batch, server_cfg.vocab_size),
                                              device=device)}
                if server_cfg.lora is not None:
                    bc["b_h"] = torch.zeros((fed.public_batch, server_cfg.lora.rank),
                                            device=device)
            else:
                bc = {"b_logits": engine._b_logits}
                if engine._b_h is not None:
                    bc["b_h"] = engine._b_h
            tree["bcast"] = bc
        else:
            tree["server"] = {"s_params": server.params, "s_opt": one_model_opt(server.opt)}
        return tree

    def save_ckpt(step: int) -> None:
        if lead:
            write_ckpt(step)
        if ranks > 1:  # no rank reads on before the step is whole
            dist.barrier()

    def write_ckpt(step: int) -> None:
        meta = dict(
            config=_config_fingerprint(fed), server_acc=run.server_acc,
            client_acc=run.client_acc, mean_k=run.mean_k, per_client_k=run.per_client_k,
            distill_loss=run.distill_loss,
            ledger=[dataclasses.asdict(r) for r in ledger.rounds],
            round_seconds=run.round_seconds,
        )
        for tap in _TAPS:
            if getattr(run, tap) is not None:
                meta[tap] = getattr(run, tap)
        if fleet_sharded:
            engine.save_fleet_shards(ckpt_io.fleet_shard_dir(ckpt_dir, step))
            meta["fleet_sharded"] = True
        ckpt_io.save_step(ckpt_dir, step, ckpt_tree(include_fleet=not fleet_sharded), **meta)

    bcast: BroadcastState | None = None
    if completed:
        # a checkpoint of a host store (either package's) keeps the fleet in shards
        sharded = bool(ckpt_meta.get("fleet_sharded"))
        # restored on the host: each load below copies a leaf to the device
        # once, into storage the engine owns
        tree, _ = ckpt_io.restore_step(
            ckpt_dir, ckpt_io.host_skeleton(ckpt_tree(like=True, include_fleet=not sharded)),
            completed)
        if sharded:
            engine.load_fleet_shards(ckpt_io.fleet_shard_dir(ckpt_dir, completed))
        else:
            engine.load_fleet_state(tree["fleet"])
        if handles_server:
            engine.load_server_state(tree["server"])
        else:
            server.params = {k: owned_copy(v, device)
                             for k, v in tree["server"]["s_params"].items()}
            server.opt = client_axis_opt(tree["server"]["s_opt"], device)
        # replay the host draws and each selected client's batch stream
        # through the completed rounds; device state is restored, not
        # recomputed
        last_pub = None
        for rnd in range(completed):
            sel, last_pub, _states = draw_round(rnd)
            for cid in sel:
                clients[cid].next_train_batches(fed.local_steps)
        if handles_server:
            engine.load_broadcast(last_pub, tree["bcast"]["b_logits"], tree["bcast"].get("b_h"))
            bcast = engine.broadcast_state(last_pub)
        else:
            # the broadcast is a function of the restored server and the
            # replayed public batch
            g_logits, g_h, g_bits = server.broadcast(last_pub)
            bcast = BroadcastState(tokens=last_pub, logits=g_logits, h=g_h, bits=g_bits)
        # the record of the whole run, not only of its tail
        run.server_acc[:] = [float(x) for x in ckpt_meta.get("server_acc", [])]
        run.client_acc[:] = [float(x) for x in ckpt_meta.get("client_acc", [])]
        run.mean_k[:] = [float(x) for x in ckpt_meta.get("mean_k", [])]
        run.per_client_k[:] = [[int(k) for k in ks] for ks in ckpt_meta.get("per_client_k", [])]
        run.distill_loss[:] = [float(x) for x in ckpt_meta.get("distill_loss", [])]
        run.round_seconds[:] = [float(x) for x in ckpt_meta.get("round_seconds",
                                                                [float("nan")] * completed)]
        for tap in _TAPS:
            if tap in ckpt_meta:
                setattr(run, tap, ckpt_meta[tap])
        for entry in ckpt_meta.get("ledger", []):
            ledger.record(RoundStats(**entry))

    def scan_block(start: int) -> None:
        """The ``scan_rounds`` path: rounds ``start..fed.rounds-1`` drawn first,
        in the per-round loop's order (faults resolved from the block's fault
        operands), then run as one ``run_rounds`` block with the eval tap and,
        under a channel scenario, the channel chain inside it; the record is
        filled from its trajectory, extending the taps a resumed run restored.
        The block's wall time is spread evenly over its rounds."""
        t0 = time.perf_counter()
        n_block = fed.rounds - start
        fault_inputs = (fault_sim.scan_fault_inputs(n_block, start_round=start)
                        if fault_sim is not None else None)
        sels, pubs, states, fault_rows = [], [], [], []
        for j, rnd in enumerate(range(start, fed.rounds)):
            sel, pub_tokens, st = draw_round(rnd)
            if fault_sim is not None:
                st, attempted, res, ghosts = apply_faults(rnd, sel, st, fault_inputs, j)
                fault_rows.append((attempted, res, ghosts))
            sels.append(sel)
            pubs.append(pub_tokens)
            states.append(st)
        # the tap reads the samples the host evaluator walks: whole batches only
        seen = (len(eval_tokens) // EVAL_BATCH) * EVAL_BATCH
        eval_kw = (dict(eval_tokens=eval_tokens[:seen], eval_labels=eval_labels[:seen])
                   if seen else {})
        chan_kw = ({} if chan_sim.scenario is None else
                   dict(channel_scan=chan_sim.scan_channel_inputs(n_block, start_round=start)))
        traj = engine.run_rounds(sels, pubs, states, adaptive_k=preset["adaptive_k"],
                                 send_h=preset["send_h"], **eval_kw, **chan_kw)
        engine.sync_server()
        # extend, never clobber, the taps a resumed run restored
        if traj.family_client_acc is not None:
            run.family_client_acc = (run.family_client_acc or []) + traj.family_client_acc
        if traj.snr_db is not None:
            run.snr_db = (run.snr_db or []) + traj.snr_db
            run.outage = (run.outage or []) + traj.outage
        b_rank = server_cfg.lora.rank if server_cfg.lora is not None else None
        b_bits = downlink_bits(fed.public_batch, server_cfg.vocab_size, b_rank)
        wall = time.perf_counter() - t0
        for j, rnd in enumerate(range(start, fed.rounds)):
            # an eval split under one batch gives 0.0 on the host path: mirror it
            s_acc = traj.server_acc[j] if traj.server_acc else 0.0
            c_acc = traj.client_acc[j] if traj.client_acc else 0.0
            stats_kw: dict = {}
            extra = 0.0
            if fault_rows:
                attempted, res, ghosts = fault_rows[j]
                extra, retrans, stats_kw = fault_ledger(sels[j], res, ghosts, traj.payloads[j])
                record_fault_taps(attempted, res, retrans)
            # after fault_ledger: the delivered manifests price their retries
            payloads = traj.payloads[j]
            _record(run, rnd, traj.ks[j], float(sum(p.bytes for p in payloads)) + extra,
                    b_bits * len(sels[j]) if rnd > 0 else 0, len(payloads), s_acc, c_acc,
                    traj.distill_loss[j], traj.mean_k[j], **stats_kw)
            run.round_seconds.append(wall / n_block)
            if verbose:
                _print_round(f"{fed.method}/{fed.engine}+scan", run)

    if fed.scan_rounds:
        if not handles_server:
            raise ValueError(
                f"FedConfig.scan_rounds requires engine='fused_e2e' (got {fed.engine!r})"
            )
        if engine.store_kind != "device" and verbose:
            # a block reads the whole fleet on the device, which the host
            # store's O(cohort) residency rules out: the per-round loop
            # streams the cohorts instead
            print(
                "[rounds] scan_rounds needs the device fleet store; "
                f"fleet_store={engine.store_kind!r} falls back to the per-round "
                "driver with cohort prefetch"
            )
    if fed.scan_rounds and engine.store_kind == "device":
        scan_block(completed)
        if ckpt_dir is not None:
            save_ckpt(fed.rounds)
        return run

    # Rounds are drawn ONE round ahead, so that the store can stage round
    # r+1's cohort onto the device under round r's compute.  draw_round(r)
    # still runs in increasing r, so the host rng chain is the one of a loop
    # without prefetch, and the channel and fault draws are keyed by (seed,
    # round, cid): drawing round r+1 before round r's faults resolve
    # changes nothing.
    pending = draw_round(completed) if fed.rounds > completed else None
    for rnd in range(completed, fed.rounds):
        t0 = time.perf_counter()
        sel, pub_tokens, states = pending
        pending = draw_round(rnd + 1) if rnd + 1 < fed.rounds else None
        if pending is not None:
            engine.prefetch_cohort(pending[0])
        fault_row = None
        if fault_sim is not None:
            states, attempted, res, ghosts = apply_faults(rnd, sel, states)
            fault_row = (attempted, res, ghosts)
        downlink = bcast.bits * len(sel) if bcast is not None else 0

        phase = engine.run_round(
            sel, pub_tokens, bcast, states,
            adaptive_k=preset["adaptive_k"], send_h=preset["send_h"],
        )
        stats_kw: dict = {}
        extra = 0.0
        if fault_row is not None:
            attempted, res, ghosts = fault_row
            extra, retrans, stats_kw = fault_ledger(sel, res, ghosts, phase.payloads)
            record_fault_taps(attempted, res, retrans)

        if handles_server:
            # fused_e2e: aggregation, server distillation and the broadcast
            # all ran inside the engine's round
            bcast = engine.broadcast_state(pub_tokens)
            engine.sync_server()
        else:
            dense, h_stack = phase.dense, phase.h
            if fault_sim is not None and dense is not None:
                # the server's gate on the received stack: a transmitter
                # whose upload decodes to non-finite values is quarantined
                # instead of poisoning the eq. 6-7 aggregation
                ok, _reasons = validate_dense(dense, h_stack)
                if not ok.all():
                    n_bad = int((~ok).sum())
                    for i in np.flatnonzero(~ok):
                        phase.payloads[int(i)].delivered = False
                    keep = torch.as_tensor(np.flatnonzero(ok), device=dense.device)
                    dense = dense[keep] if len(keep) else None
                    if h_stack is not None:
                        h_stack = h_stack[keep] if len(keep) else None
                    stats_kw["num_quarantined"] = (stats_kw.get("num_quarantined") or 0) + n_bad
                    counts = stats_kw.get("fault_counts") or {}
                    counts["invalid_wire"] = counts.get("invalid_wire", 0) + n_bad
                    stats_kw["fault_counts"] = counts
            if dense is not None:
                k_g, h_g = server.aggregate_dense(dense, h_stack)
                server.distill(pub_tokens, k_g, h_g)
            # else: every selected client dropped -> no aggregation, the
            # server's knowledge carries over
            g_logits, g_h, g_bits = server.broadcast(pub_tokens)
            bcast = BroadcastState(tokens=pub_tokens, logits=g_logits, h=g_h, bits=g_bits)

        s_acc = evaluate(server.params, eval_tokens, eval_labels)
        c_acc = evaluate_client[cfgs[sel[0]]](engine.client_params(sel[0]), eval_tokens,
                                              eval_labels)
        # the reference reports no server-distill loss off the e2e path
        d_loss = engine.last_distill_loss if handles_server else float("nan")
        _record(run, rnd, phase.ks, phase.uplink_bytes + extra, downlink, phase.num_transmitters,
                s_acc, c_acc, d_loss, float(np.mean(phase.ks)), **stats_kw)
        run.round_seconds.append(time.perf_counter() - t0)
        if verbose:
            _print_round(f"{fed.method}/{fed.engine}", run)
        if ckpt_dir is not None:
            save_ckpt(rnd + 1)
    return run


def _record(run: FedRun, rnd: int, ks, uplink: float, downlink: float, n_tx: int,
            s_acc: float, c_acc: float, d_loss: float, mean_k: float, **stats_kw) -> None:
    """Append one round to the run's record and its ledger (``uplink`` in
    bytes, ``downlink`` in bits; ``stats_kw``: the round's fault taps)."""
    run.server_acc.append(s_acc)
    run.client_acc.append(c_acc)
    run.mean_k.append(mean_k)
    run.per_client_k.append(list(ks))
    run.distill_loss.append(d_loss)
    run.ledger.record(
        RoundStats(
            round_index=rnd,
            uplink_bytes=uplink,
            downlink_bytes=downlink / 8.0,
            server_accuracy=s_acc,
            client_accuracy=c_acc,
            distill_loss=d_loss,
            mean_k=mean_k,
            num_selected=len(ks),
            num_transmitters=n_tx,
            **stats_kw,
        )
    )


def _print_round(tag: str, run: FedRun) -> None:
    r = run.ledger.rounds[-1]
    print(
        f"[{tag}] round {r.round_index:3d}  server_acc={r.server_accuracy:.3f} "
        f"client_acc={r.client_accuracy:.3f}  mean_k={r.mean_k:7.1f}  "
        f"uplink={r.uplink_bytes / 1e6:.2f}MB  tx={r.num_transmitters}/{r.num_selected}"
    )
