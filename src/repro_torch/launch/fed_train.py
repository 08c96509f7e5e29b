"""Federated AdaLD driver — the paper's experiment as a CLI, the port of
``repro/launch/fed_train.py`` with the same flags, defaults and JSON
record, plus ``--device`` (the card unless ``--device cpu``)::

  PYTHONPATH=src python -m repro_torch.launch.fed_train --method adald --rounds 10

Reduced-scale GPT-2-family models on the synthetic Banking77-statistics
dataset; writes a JSON history (``{out}/{method}_seed{seed}.json``).
``--families gpt2-paper,mamba2-130m`` federates a mixed fleet instead
(the reference's example; any arch ids of the registry): each
arch's smoke config re-based onto the reduced experiment's vocabulary and
LoRA (:func:`family_configs`), the clients cycling through them.  An
attention-free family's eq. 8 projection comes from its head adapter; a
VLM or audio family reads the stub frontend
(:mod:`repro_torch.models.frontends`), and an audio family's encoder
adapters train with its decoder's.
``--fleet-store host --fleet-size N`` keeps the fleet in host memory and
streams each round's cohort to the device, so device memory stays
O(cohort).  ``--shard-clients`` splits each round's client phase over the
ranks of a process group, one process per device::

  python -m torch.distributed.run --nproc-per-node N \
      -m repro_torch.launch.fed_train --shard-clients --engine fused_e2e ...

Each rank takes ``cuda:{LOCAL_RANK}`` (NCCL; gloo with ``--device cpu``),
and rank 0 writes the JSON; started without ``torch.distributed.run`` it
runs on one rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT, REDUCED_SERVER
from repro_torch.data import make_banking77_like
from repro_torch.fed import FedConfig, run_federated
from repro_torch.fed.rounds import METHODS


def family_configs(spec: str, seq_len: int):
    """``--families`` as per-family model configs on the shared exchange
    contracts (one vocabulary, one LoRA rank — paper §II): each
    comma-separated arch id's smoke config re-based onto the reduced
    experiment's vocabulary and LoRA; an SSM family gets a chunk size that
    divides the sequence length.  The reference's function."""
    fams = []
    for arch in spec.split(","):
        arch = arch.strip()
        if not arch:
            continue
        smoke = get_smoke_config(arch)
        over = dict(name=f"fam-{arch}", vocab_size=REDUCED_CLIENT.vocab_size,
                    lora=REDUCED_CLIENT.lora, max_seq_len=max(seq_len, 32))
        if smoke.ssm is not None:
            chunk = next(c for c in (8, 4, 2, 1) if seq_len % c == 0)
            over["ssm"] = dataclasses.replace(smoke.ssm, chunk_size=chunk)
        fams.append(smoke.with_overrides(**over))
    if not fams:
        raise SystemExit(f"--families {spec!r} names no architectures")
    return fams


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=list(METHODS), default="adald")
    ap.add_argument("--engine", choices=["sequential", "batched", "fused", "fused_e2e"],
                    default="batched",
                    help="round executor (batched = per-phase cohort steps; fused = one "
                         "CLIENT-phase round function; fused_e2e = the WHOLE round as one "
                         "call: sparse-wire aggregation, server distill and broadcast folded in)")
    ap.add_argument("--full-head", action="store_true",
                    help="materialise full (B,T,V) logits instead of the last-only LM head")
    ap.add_argument("--shard-clients", action="store_true",
                    help="fused/fused_e2e: split each round's client phase over the ranks of "
                         "the process group (one process per device, under "
                         "torch.distributed.run; one rank without it)")
    ap.add_argument("--scan-rounds", action="store_true",
                    help="fused_e2e only: run ALL rounds as one block with the per-round "
                         "eval tapped inside it")
    ap.add_argument("--families", default=None,
                    help="comma-separated arch ids for a heterogeneous fleet: clients cycle "
                         "these families round-robin, served by the family-bucketed engines; "
                         "smoke configs are re-based onto the shared vocab/LoRA-rank "
                         "contract.  Default: homogeneous REDUCED_CLIENT")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--fleet-size", type=int, default=None,
                    help="alias for --clients aimed at fleet-scale runs (takes precedence "
                         "when both are given); pair with --fleet-store host so device memory "
                         "stays O(cohort) regardless of this number")
    ap.add_argument("--fleet-store", choices=["device", "host"], default="device",
                    help="fleet-state residency (repro_torch.fed.store): 'device' keeps the "
                         "whole fleet stacked on the device; 'host' keeps it in host memory "
                         "and streams only each round's cohort to the device, prefetching "
                         "round r+1's cohort under round r's compute")
    ap.add_argument("--per-round", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--lam", type=float, default=0.03)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--quantize-wire", action="store_true",
                    help="int8-quantize the sparse uplink wire (one fp32 scale per (client, "
                         "sample) row): entries are priced at 8 bits, so the same Shannon "
                         "budget affords a larger adaptive k at fixed SNR")
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32",
                    help="fused engines: round-body compute dtype; fp32 master LoRA/optimizer "
                         "state is kept either way")
    ap.add_argument("--scenario", default=None,
                    help="channel-dynamics preset from repro_torch.core.scenario (iid | "
                         "gauss_markov | jakes | gilbert_elliott | mobility).  Default: the "
                         "i.i.d. per-round channel")
    ap.add_argument("--faults", default=None,
                    help="fault-injection preset from repro_torch.core.faults (none | "
                         "corruption | crashes | bursty | lossy).  Default: no faults")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write an atomic round-granular checkpoint after every completed "
                         "round (a host store's fleet as shards beside it)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest valid checkpoint in --ckpt-dir; the resumed "
                         "run is the uninterrupted one (same k, bytes, accuracies)")
    ap.add_argument("--public-batch", type=int, default=128)
    ap.add_argument("--out", default="experiments/fed")
    ap.add_argument("--device", default="cuda",
                    help="where the federation runs: the card by default, 'cpu' for a run "
                         "without one")
    return ap


def fed_config(args: argparse.Namespace) -> FedConfig:
    """The reference CLI's FedConfig for the same flags."""
    return FedConfig(
        method=args.method,
        engine=args.engine,
        fleet_store=args.fleet_store,
        num_clients=args.fleet_size if args.fleet_size is not None else args.clients,
        clients_per_round=args.per_round,
        rounds=args.rounds,
        public_size=512,
        public_batch=args.public_batch,
        eval_size=512,
        non_iid=not args.iid,
        seed=args.seed,
        lam=args.lam,
        use_kernels=args.use_kernels,
        quantize_wire=args.quantize_wire,
        compute_dtype=args.compute_dtype,
        last_only=not args.full_head,
        shard_clients=args.shard_clients,
        scan_rounds=args.scan_rounds,
        scenario=args.scenario,
        faults=args.faults,
    )


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.resume and args.ckpt_dir is None:
        ap.error("--resume requires --ckpt-dir")
    device, own_group = args.device, False
    if args.shard_clients and "LOCAL_RANK" in os.environ and not dist.is_initialized():
        # one process per device, started by torch.distributed.run
        if device != "cpu":
            device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
            torch.cuda.set_device(device)
        dist.init_process_group("gloo" if device == "cpu" else "nccl")
        own_group = True
    try:
        return _run(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args: argparse.Namespace, device: str) -> int:
    seq_len = 24
    ds = make_banking77_like(vocab_size=REDUCED_CLIENT.vocab_size, seq_len=seq_len, seed=args.seed)
    fed = fed_config(args)
    client_cfg = family_configs(args.families, seq_len) if args.families else REDUCED_CLIENT
    run = run_federated(client_cfg, REDUCED_SERVER, ds, fed, verbose=True,
                        ckpt_dir=args.ckpt_dir, resume=args.resume, device=device)
    if dist.is_initialized() and dist.get_rank() != 0:
        return 0  # rank 0 writes the record

    os.makedirs(args.out, exist_ok=True)
    rec = {
        "method": args.method,
        "families": args.families,
        "family_client_acc": run.family_client_acc,
        "scenario": args.scenario,
        # scenario blocks only: the block's channel tap (-inf SNR in an
        # outage is not valid JSON: a sentinel instead)
        "snr_db": None if run.snr_db is None else [
            [x if math.isfinite(x) else -1e9 for x in row] for row in run.snr_db
        ],
        "outage": run.outage,
        "faults": args.faults,
        "num_quarantined": run.num_quarantined,
        "num_crashed": run.num_crashed,
        "retrans_bytes": run.retrans_bytes,
        "fed": {k: v for k, v in dataclasses.asdict(fed).items() if not isinstance(v, dict)},
        "server_acc": run.server_acc,
        "client_acc": run.client_acc,
        "mean_k": run.mean_k,
        # null, not a bare NaN (off the e2e path the loss is NaN, and a bare
        # NaN is not RFC 8259 JSON)
        "distill_loss": [None if math.isnan(x) else x for x in run.distill_loss],
        "uplink_mb_per_round": [r.uplink_bytes / 1e6 for r in run.ledger.rounds],
        "downlink_mb_per_round": [r.downlink_bytes / 1e6 for r in run.ledger.rounds],
        "summary": run.summary(),
    }
    path = os.path.join(args.out, f"{args.method}_seed{args.seed}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[fed] {args.method}: final server acc {run.server_acc[-1]:.3f}, "
          f"total {run.ledger.total_mb:.2f} MB -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
