"""Phase 6h of ``chip_smoke.py`` on its own, after the kernels' build:
``python3 tools/modal_probe.py`` on a machine with one CUDA card.

Prints the card and the phase's lines: GPT-2 small + internvl2 (1 layer
at its published widths) on ``fused_e2e`` and ``fused``, GPT-2 small +
seamless (24 + 24 layers) through the five engines, each family alone in
bf16 (the (8, 1024) prefill, decode steps, a timed and a traced decode
step), the ``fed_train --families`` run with both, and audio serving
stacked against solo.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    device, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    out = chip_smoke.phase_modal(device, card)
    print(f"[probe] modal phase launches {out['launches']}")
    print(card)
    print(f"[probe] {time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
