"""``tools/kernel_probe.py`` builds its clocked copies and variants of the
port's kernels by text substitution at fixed lines of the CUDA sources, and
stops, on the card, at the first line it cannot find once.  These tests make
every copy from this checkout's sources on the CPU, so a kernel edit that
moves such a line fails here rather than in a probe run.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import kernel_probe as kp  # noqa: E402

# the clocked copies of this checkout's kernels (the earlier build's scatter
# and KL copies are made from an older checkout's sources, not these)
CLOCKED = {
    "topk": kp.topk_clocks,
    "topk_bf16": kp.topk_bf16_clocks,
    "attention_bf16 at D 64": kp.attention_bf16_clocks,
    "attention_bf16 at D 128": kp.attention_d128_clocks,
    "attention_f32 at D 128": kp.attention_f32_d128_clocks,
    "scatter_bf16": kp.scatter_bf16_clocks,
    "kl_bf16": kp.kl_bf16_clocks,
    "kl_bf16 loads only": lambda: kp.kl_bf16_clocks(loads_only=True),
}


@pytest.mark.parametrize("name", sorted(CLOCKED))
def test_clocked_copy_finds_its_lines(name):
    text = CLOCKED[name]()
    assert "clock64()" in text or "globaltimer" in text


def test_d128_clocked_copy_fills_the_columns_the_report_reads():
    """The D 128 copy writes a column for each tile phase and item phase,
    then the tile and item counts and the two globaltimer stamps, which
    ``report_phases`` reads at columns 9, 10, 11 and 12."""
    text = kp.attention_d128_clocks()
    n = len(kp.D128_TILE_PHASES) + len(kp.D128_ITEM_PHASES)
    assert n == 9
    for col in range(n):
        assert f"prof[{col}] +=" in text, col
    assert "++prof[9];" in text and "++prof[10];" in text
    assert "prof[11] = pg0; prof[12] = g1;" in text


def test_f32_d128_clocked_copy_fills_the_columns_the_report_reads():
    """The fp32 D 128 copy sums each consumer phase and each producer phase
    into a column of its own and writes, in each row, the tile and item
    counts and the globaltimer stamps where ``report_f32_phases`` reads them
    (``F32_STAMPS``), a consumer's item phases at 10-11 and the producer's Q
    waits and Q loads at 11-12."""
    text = kp.attention_f32_d128_clocks()
    assert len(kp.F32_D128_TILE_PHASES) == 5 and len(kp.F32_D128_ITEM_PHASES) == 2
    for col in range(len(kp.F32_D128_TILE_PHASES) + len(kp.F32_D128_ITEM_PHASES)):
        assert f"cp_[{col}] +=" in text, col
    for col in (0, 1, 2, 3, 4, 5, 7):
        assert f"pp_[{col}] +=" in text, col
    assert kp.F32_STAMPS == (6, 7, 8, 9)
    assert "d[6] = cp_[9]; d[7] = cp_[10]; d[8] = pg0; d[9] = g1; d[10] = cp_[5]; d[11] = cp_[6];" in text
    assert "d[6] = pp_[9]; d[7] = pp_[10]; d[8] = pg0; d[9] = g1; d[11] = pp_[7]; d[12] = pp_[10];" in text


@pytest.mark.parametrize("name", sorted(kp.VARIANTS))
def test_variant_finds_its_lines(name):
    src, pairs = kp.VARIANTS[name]
    assert kp.substituted(kp.CSRC / src, pairs) != (kp.CSRC / src).read_text()
