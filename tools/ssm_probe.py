"""Phase 6g of ``chip_smoke.py`` on its own, after the kernels' build:
``python3 tools/ssm_probe.py`` on a machine with one CUDA card.

Prints the card and the phase's lines: the GPT-2 small + mamba2-130m fleet
through the five engines, mamba2-130m alone in bf16 and fp32 (its (8,
1024) prefill, 16 decode steps against the forward, a timed and a traced
decode step), the SSM and hybrid smoke configs' decode checks, the
``fed_train --families`` run with the hybrid, and SSM serving stacked
against solo.
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
    out = chip_smoke.phase_ssm(device, card)
    print(f"[probe] state-space phase launches {out['launches']}")
    print(card)
    print(f"[probe] {time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
