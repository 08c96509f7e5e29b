"""Serving CLI: a thin entry point over :class:`repro_torch.serve.ServeSession`
— the port of ``repro/launch/serve.py`` with the same flags and output,
plus ``--device`` (the card unless ``--device cpu``).

Single-adapter decode::

  PYTHONPATH=src python -m repro_torch.launch.serve --tokens 32

Multi-tenant: every request gets its own tenant adapter, paged through the
AdapterCache, from a federation checkpoint (``fed_train --ckpt-dir``, whose
models are ``REDUCED_CLIENT``) or from synthetic random adapters when no
checkpoint is given::

  PYTHONPATH=src python -m repro_torch.launch.serve --adapters 8 --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --adapters 8 --from-ckpt runs/fed

The first decode step is reported apart; the throughput is the steady
decode's tokens/s after it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, get_smoke_config
from repro_torch.lora import lora_template, map_lora, split_lora
from repro_torch.models import init as model_init
from repro_torch.serve import (
    AdapterCache,
    ServeConfig,
    ServeSession,
    export_adapters,
    serving_params,
)


class _RandomAdapters:
    """Synthetic tenant population: tenant ``cid`` is an adapter with random
    A AND B (a fresh init's B is zero: the delta would vanish), drawn from a
    ``torch.Generator`` seeded from ``(seed, cid)`` (the reference draws
    from ``jax.random``: another population, ROADMAP.md "Known
    deviations")."""

    def __init__(self, params, num_adapters: int, seed: int):
        self._lora, _ = split_lora(params)
        self.num_adapters = int(num_adapters)
        self._seed = seed

    def lora_row(self, cid: int):
        seed = int(np.random.SeedSequence([self._seed, int(cid)]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)

        def rnd(x):
            return (0.05 * torch.randn(x.shape, generator=gen)).to(x.dtype)

        return map_lora(rnd, self._lora)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHITECTURES), default="gpt2-paper")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adapters", type=int, default=0,
                    help="serve this many distinct tenants (0 = single-adapter)")
    ap.add_argument("--slots", type=int, default=8,
                    help="device adapter-cache slots")
    ap.add_argument("--from-ckpt", default=None,
                    help="page tenant adapters from this fed_train --ckpt-dir "
                         "(default: synthetic random adapters)")
    ap.add_argument("--device", default="cuda",
                    help="where the session serves: the card by default, 'cpu' for a run "
                         "without one")
    args = ap.parse_args(argv)

    if args.from_ckpt is not None and args.arch == "gpt2-paper":
        # fed_train trains REDUCED_CLIENT by default: the smoke config's
        # shapes (2 layers) would not match the checkpointed backbone
        from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as cfg
    else:
        cfg = get_smoke_config(args.arch)

    params = model_init(cfg, args.seed, args.device)
    scfg = ServeConfig(model=cfg, batch=args.batch, cache_len=args.prompt_len + args.tokens,
                       temperature=args.temperature, seed=args.seed)

    adapters = None
    if args.adapters > 0:
        if cfg.lora is None:
            raise SystemExit(f"--adapters needs a LoRA-enabled arch; {args.arch} smoke config "
                             "has none")
        if args.from_ckpt is not None:
            source = export_adapters(args.from_ckpt)
            params = serving_params(source, params)
        else:
            source = _RandomAdapters(params, args.adapters, args.seed)
        adapters = AdapterCache(source, like=lora_template(params), slots=args.slots,
                                device=args.device)

    sess = ServeSession(scfg, params, adapters=adapters, device=args.device)
    if adapters is not None:
        tenant_ids = [i % source.num_adapters for i in range(args.batch)]
        slots = sess.attach(tenant_ids)
        print(f"[serve] tenants {tenant_ids} -> slots {slots.tolist()}")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)

    sess.prefill(prompts)
    gen, logits = sess.decode(args.tokens)
    if not bool(torch.isfinite(logits).all()):
        raise FloatingPointError("the decode's last logits are not finite")

    s = sess.stats()
    mode = "stacked" if sess.attached else "single"
    steady = s["steady_step_s"]
    tok_s = args.batch / steady if steady > 0 else float("inf")
    print(f"[serve] {args.arch} ({mode}): first step "
          f"{s['first_step_s'].get(mode, 0.0):.2f}s, steady decode "
          f"{steady * 1e3:.1f} ms/step = {tok_s:.1f} tok/s "
          f"({args.batch}x{args.tokens} tokens)")
    if adapters is not None:
        print(f"[serve] adapter cache: {s['adapter_cache']} "
              f"(slots={s['adapter_slots']})")
    print(f"[serve] decode executables: {s['executables']}")
    print("[serve] sample:", gen[0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
