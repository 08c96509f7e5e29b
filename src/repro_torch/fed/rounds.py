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

With ``pretrain_steps > 0`` (the default) one backbone per model family is
pretrained first on a split that the run never sees, and shared by that
family's clients as the frozen W' of paper eq. 1; the server's is
LM-pretrained by default.  ``scan_rounds`` (``fused_e2e`` only) draws every
round first and runs them as one block, ``FusedE2EEngine.run_rounds``.

What the port does not carry yet raises ``NotImplementedError`` naming its
entry in ROADMAP.md's port queue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import ChannelConfig, ChannelSimulator
from repro_torch.core.protocol import CommLedger, RoundStats, downlink_bits
from repro_torch.data.partition import dirichlet_partition, iid_partition, split_public_private
from repro_torch.data.synthetic import IntentDataset
from repro_torch.fed.client import Client
from repro_torch.fed.engines import BroadcastState, make_engine
from repro_torch.fed.engines.base import not_carried
from repro_torch.fed.pretrain import pretrain_classifier, pretrain_lm
from repro_torch.fed.server import Server
from repro_torch.fed.steps import EVAL_BATCH, make_eval_fn

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
    per_client_k: list[list[int]] = dataclasses.field(default_factory=list)
    distill_loss: list[float] = dataclasses.field(default_factory=list)
    # host wall-clock seconds of each round, its evaluation included
    round_seconds: list[float] = dataclasses.field(default_factory=list)


def _check_carried(client_cfg, fed: FedConfig, ckpt_dir) -> None:
    """Raise on what the port does not carry, before any work;
    ``make_engine`` checks the engine's own options (kind, shard_clients,
    compute_dtype, fleet_store)."""
    if not isinstance(client_cfg, ModelConfig):
        raise not_carried("a mixed-family fleet", "other model families and mixed fleets")
    if fed.scenario is not None or fed.channel.scenario is not None:
        raise not_carried("a channel scenario", "scenarios and faults, then checkpoints")
    if fed.faults not in (None, "none"):
        raise not_carried("fault injection", "scenarios and faults, then checkpoints")
    if ckpt_dir is not None:
        raise not_carried("checkpoints (ckpt_dir)", "scenarios and faults, then checkpoints")


def run_federated(
    client_cfg: ModelConfig,
    server_cfg: ModelConfig,
    dataset: IntentDataset,
    fed: FedConfig,
    *,
    verbose: bool = False,
    ckpt_dir: str | None = None,
    device: str | torch.device = "cuda",
) -> FedRun:
    """Run the whole federation on ``device`` (the card unless the caller
    asks for ``"cpu"``).  Every client runs ``client_cfg``.  With
    ``pretrain_steps > 0`` the clients share one pretrained backbone (seed
    ``fed.seed``) under their own adapters (seed ``fed.seed + i``), and the
    server starts from its own pretraining (``server_pretrain``: ``"lm"``,
    ``"supervised"`` or ``"none"``, seed ``fed.seed + 999``); without, each
    client inits its own backbone (seed ``fed.seed + i``) and the server
    inits from ``fed.seed + 999``."""
    _check_carried(client_cfg, fed, ckpt_dir)
    preset = METHODS[fed.method]
    rng = np.random.default_rng(fed.seed)

    # a disjoint pretraining split first (the simulated pretrained W'): one
    # backbone per family, at fed.seed + 17 * family (the port carries one
    # family)
    server_init = client_init = None
    if fed.pretrain_steps > 0:
        n_pre = int(len(dataset) * fed.pretrain_frac)
        pre_idx = np.random.default_rng(fed.seed + 31).permutation(len(dataset))
        pretrain_ds = dataset.subset(pre_idx[:n_pre])
        dataset = dataset.subset(pre_idx[n_pre:])
        client_init = pretrain_classifier(
            client_cfg, pretrain_ds, num_classes=dataset.num_classes, steps=fed.pretrain_steps,
            lr=fed.pretrain_lr, seed=fed.seed, last_only=fed.last_only,
            verbose=verbose, device=device,
        )
        if fed.server_pretrain == "supervised":
            server_init = pretrain_classifier(
                server_cfg, pretrain_ds, num_classes=dataset.num_classes,
                steps=fed.server_pretrain_steps, lr=fed.pretrain_lr, seed=fed.seed + 999,
                last_only=fed.last_only, verbose=verbose, device=device,
            )
        elif fed.server_pretrain == "lm":
            server_init = pretrain_lm(
                server_cfg, pretrain_ds, steps=fed.server_pretrain_steps, lr=fed.pretrain_lr,
                seed=fed.seed + 999, verbose=verbose, device=device,
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
            i, client_cfg, private.subset(parts[i]), num_classes=dataset.num_classes,
            seed=fed.seed + i, lr=fed.lr, distill_lr=fed.distill_lr, temperature=fed.temperature,
            lam=fed.lam, local_steps=fed.local_steps, distill_steps=fed.distill_steps,
            restrict_to_support=fed.restrict_to_support, last_only=fed.last_only, device=device,
            initial_params=client_init,
        )
        for i in range(fed.num_clients)
    ]
    server = Server(
        server_cfg, seed=fed.seed + 999, distill_lr=fed.distill_lr, temperature=fed.temperature,
        lam=fed.lam, aggregation=preset["aggregation"], distill_steps=fed.server_distill_steps,
        use_kernels=fed.use_kernels, restrict_to_support=fed.restrict_to_support,
        last_only=fed.last_only, device=device, initial_params=server_init,
    )
    chan_sim = ChannelSimulator(fed.num_clients, fed.channel, seed=fed.seed)

    eval_idx = rng.permutation(len(private))[: fed.eval_size]
    eval_tokens = torch.as_tensor(private.tokens[eval_idx], device=device)
    eval_labels = torch.as_tensor(private.labels[eval_idx], device=device)
    evaluate = make_eval_fn(server_cfg, dataset.num_classes, last_only=fed.last_only)
    evaluate_client = make_eval_fn(client_cfg, dataset.num_classes, last_only=fed.last_only)

    engine = make_engine(
        fed.engine, clients, client_cfg, num_classes=dataset.num_classes,
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
    pub_rng = np.random.default_rng(fed.seed + 7)

    def draw_round(rnd: int):
        """One round's host draws in the reference's canonical order:
        cohort, public batch, channel.  The per-round loop and the
        scan_rounds pre-draw both go through here, so their rng streams
        cannot part."""
        sel = [int(i) for i in rng.choice(fed.num_clients, size=fed.clients_per_round,
                                          replace=False)]
        pub_tokens = torch.as_tensor(
            public.tokens[pub_rng.integers(0, len(public), size=fed.public_batch)], device=device
        )
        return sel, pub_tokens, chan_sim.states_batched(rnd, sel)

    if fed.scan_rounds:
        if not handles_server:
            raise ValueError(
                f"FedConfig.scan_rounds requires engine='fused_e2e' (got {fed.engine!r})"
            )
        return _scan_rounds(fed, preset, engine, server_cfg, draw_round, eval_tokens,
                            eval_labels, run, verbose)

    bcast: BroadcastState | None = None
    for rnd in range(fed.rounds):
        t0 = time.perf_counter()
        sel, pub_tokens, states = draw_round(rnd)
        downlink = bcast.bits * len(sel) if bcast is not None else 0

        phase = engine.run_round(
            sel, pub_tokens, bcast, states,
            adaptive_k=preset["adaptive_k"], send_h=preset["send_h"],
        )
        if handles_server:
            # fused_e2e: aggregation, server distillation and the broadcast
            # all ran inside the engine's round
            bcast = engine.broadcast_state(pub_tokens)
            engine.sync_server()
        else:
            if phase.dense is not None:
                k_g, h_g = server.aggregate_dense(phase.dense, phase.h)
                server.distill(pub_tokens, k_g, h_g)
            # else: every selected client dropped -> no aggregation, the
            # server's knowledge carries over
            g_logits, g_h, g_bits = server.broadcast(pub_tokens)
            bcast = BroadcastState(tokens=pub_tokens, logits=g_logits, h=g_h, bits=g_bits)

        s_acc = evaluate(server.params, eval_tokens, eval_labels)
        c_acc = evaluate_client(engine.client_params(sel[0]), eval_tokens, eval_labels)
        # the reference reports no server-distill loss off the e2e path
        d_loss = engine.last_distill_loss if handles_server else float("nan")
        _record(run, rnd, phase.ks, phase.uplink_bytes, downlink, phase.num_transmitters,
                s_acc, c_acc, d_loss, float(np.mean(phase.ks)))
        run.round_seconds.append(time.perf_counter() - t0)
        if verbose:
            _print_round(f"{fed.method}/{fed.engine}", run)
    return run


def _record(run: FedRun, rnd: int, ks, uplink: float, downlink: float, n_tx: int,
            s_acc: float, c_acc: float, d_loss: float, mean_k: float) -> None:
    """Append one round to the run's record and its ledger (``uplink`` in
    bytes, ``downlink`` in bits)."""
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
        )
    )


def _print_round(tag: str, run: FedRun) -> None:
    r = run.ledger.rounds[-1]
    print(
        f"[{tag}] round {r.round_index:3d}  server_acc={r.server_accuracy:.3f} "
        f"client_acc={r.client_accuracy:.3f}  mean_k={r.mean_k:7.1f}  "
        f"uplink={r.uplink_bytes / 1e6:.2f}MB  tx={r.num_transmitters}/{r.num_selected}"
    )


def _scan_rounds(fed: FedConfig, preset: dict, engine, server_cfg: ModelConfig, draw_round,
                 eval_tokens: torch.Tensor, eval_labels: torch.Tensor, run: FedRun,
                 verbose: bool) -> FedRun:
    """The ``scan_rounds`` path: every round drawn first, in the per-round
    loop's order, then the whole run as one ``run_rounds`` block with the
    eval tap inside it; the record is filled from its trajectory.  The
    block's wall time is spread evenly over its rounds."""
    t0 = time.perf_counter()
    draws = [draw_round(rnd) for rnd in range(fed.rounds)]
    sels, pubs, states = ([d[i] for d in draws] for i in range(3))
    # the tap reads the samples the host evaluator walks: whole batches only
    seen = (len(eval_tokens) // EVAL_BATCH) * EVAL_BATCH
    eval_kw = dict(eval_tokens=eval_tokens[:seen], eval_labels=eval_labels[:seen]) if seen else {}
    traj = engine.run_rounds(sels, pubs, states,
                             adaptive_k=preset["adaptive_k"], send_h=preset["send_h"], **eval_kw)
    engine.sync_server()
    b_rank = server_cfg.lora.rank if server_cfg.lora is not None else None
    b_bits = downlink_bits(fed.public_batch, server_cfg.vocab_size, b_rank)
    wall = time.perf_counter() - t0
    for rnd in range(fed.rounds):
        # an eval split under one batch gives 0.0 on the host path: mirror it
        s_acc = traj.server_acc[rnd] if traj.server_acc else 0.0
        c_acc = traj.client_acc[rnd] if traj.client_acc else 0.0
        payloads = traj.payloads[rnd]
        _record(run, rnd, traj.ks[rnd], float(sum(p.bytes for p in payloads)),
                b_bits * len(sels[rnd]) if rnd > 0 else 0, len(payloads), s_acc, c_acc,
                traj.distill_loss[rnd], traj.mean_k[rnd])
        run.round_seconds.append(wall / fed.rounds)
        if verbose:
            _print_round(f"{fed.method}/{fed.engine}+scan", run)
    return run
