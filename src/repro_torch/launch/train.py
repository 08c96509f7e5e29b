"""LM training entry point (the non-FL substrate path) — the port of
``repro/launch/train.py`` with the same flags and output, plus
``--device`` (the card unless ``--device cpu``)::

  PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --batch 8 --seq 128

Runs the architecture's smoke config (a VLM or audio model with a stub
frontend in each batch, drawn at the step's seed) through
:func:`repro_torch.launch.steps.make_train_step` (full-parameter AdamW,
next-token CE) on a synthetic LM stream, prints each step's loss and
tokens/s, and with ``--ckpt-dir`` writes the params through
:func:`repro_torch.checkpoint.save_step`.  ``--production`` builds the
full config and stops, as the reference's does: its path needs the 16x16
mesh of 256 cards, and ``python -m repro_torch.launch.dryrun`` proves it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_step
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.data import make_lm_stream
from repro_torch.launch.steps import init_train_opt, make_train_step
from repro_torch.models import init as model_init
from repro_torch.models import frontends


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHITECTURES), default="gpt2-paper")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production", action="store_true",
                    help="full config on the production mesh (256 cards)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the steps run: the card by default, 'cpu' for a run without one")
    args = ap.parse_args(argv)

    if args.production:
        get_config(args.arch)
        raise SystemExit(
            "--production needs the 16x16 production mesh of 256 cards; this run has one. "
            "The dry run (python -m repro_torch.launch.dryrun) traces this path, its train "
            "steps rematerialised as cfg.remat asks, and warns of each combo whose peak a "
            "device exceeds the card's 80 GiB."
        )
    cfg = get_smoke_config(args.arch)
    device = torch.device(args.device)

    seq = min(args.seq, cfg.max_seq_len)
    tokens = make_lm_stream(vocab_size=cfg.vocab_size, seq_len=seq,
                            num_samples=args.batch * args.steps, seed=args.seed)
    params = model_init(cfg, args.seed, device)
    opt = init_train_opt(params, cfg)
    step_fn = make_train_step(cfg, lr=args.lr)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {"tokens": torch.as_tensor(tokens[i * args.batch:(i + 1) * args.batch],
                                           device=device)}
        if cfg.frontend != "none":
            batch["frontend"] = frontends.synth_frontend_embeddings(cfg, args.batch, seed=i,
                                                                    device=device)
        t_step = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        dt_step = time.perf_counter() - t_step
        print(f"step {i:4d}  loss {losses[-1]:.4f}  {dt_step * 1e3:.1f} ms  "
              f"{args.batch * seq / dt_step:.0f} tok/s")
    dt = time.perf_counter() - t0
    print(f"[train] {args.arch}: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * seq / dt:.0f} tok/s), "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"a loss is not finite: {losses}")
    if args.ckpt_dir:
        path = save_step(args.ckpt_dir, args.steps, {"params": params})
        print(f"[train] checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
