"""Phase 6f of ``chip_smoke.py`` on its own, after the kernels' build, then
a ``torch.profiler`` trace of granite-moe-1b-a400m at full width:
``python3 tools/families_probe.py [--trace-only]`` on a machine with one
CUDA card.

Prints the card, the phase's lines (the mixed GPT-2 small and
granite-moe-1b-a400m fleet through the five engines, the dense and MoE
smoke configs' decode checks, granite's full-width prefill and decode
step, the padded union wire through kernels 1 and 2), then for granite's
(8, 1024) prefill and a decode step at batch 8: the wall time, the
card's busy time (the sum of its kernels' times, CUPTI) and the ops that
take most of it.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.models import model  # noqa: E402


def trace(label: str, fn, top: int = 8) -> None:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    kernels = sum(e.count for e in events if e.self_device_time_total > 0)
    print(f"[trace {label}] wall {wall:.1f} ms, the card busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f} %), {kernels} device ops")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[trace {label}]   {e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  "
              f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-only", action="store_true", help="skip the phase, trace only")
    args = ap.parse_args()
    t0 = time.perf_counter()
    device, card = chip_smoke.phase_device()
    if not args.trace_only:
        chip_smoke.phase_build()
        out = chip_smoke.phase_families(device, card)
        print(f"[probe] families phase launches {out['launches']}, granite {out.get('granite')}")
    cfg = chip_smoke.GRANITE
    params = model.init(cfg, 0, device)
    tokens = torch.as_tensor(np.random.default_rng(12).integers(0, cfg.vocab_size, (8, 1024)),
                             device=device)
    with torch.no_grad():
        trace("granite prefill (8, 1024)", lambda: model.prefill(params, cfg, {"tokens": tokens}))
        cache = model.init_cache(cfg, 8, 64, device=device)
        trace("granite decode step, batch 8",
              lambda: model.decode_step(params, cfg, cache, tokens[:, 0]))
    print(card)
    print(f"[probe] {time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
