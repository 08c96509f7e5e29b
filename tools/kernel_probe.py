"""Measure the port's kernels against an earlier checkout on one GPU, and
break the top-k's and the bf16 kernels' time into their phases.

    python3 tools/kernel_probe.py --parent DIR [--real] [--head-dim D]
        [--kernels topk,scatter,agg,kl,attention,topk_bf16,attention_bf16,attention_f16,scatter_bf16,kl_bf16]

DIR is a checkout of an earlier commit (for example ``git archive <commit>``
unpacked into ``build/parent``); its ``topk_select.cu``, ``sparse_agg.cu``,
``distill_kl.cu`` and ``flash_attention.cu`` are built beside this
checkout's (the earlier build's ``ptxas -v`` lines are printed beside the
``[build]`` line of this one), and the two fp32 entry points are timed in
turns (earlier, this, this, earlier) in the same process, on the same
inputs, both held to the plain versions (and the KL's and attention's
outputs compared bitwise with each other); the scatter and the KL are
also timed replayed from a CUDA graph (``chip_smoke.graph_ms``: the host's
per-call work out of the way).  Only what the named probes need is built.
``--kernels`` picks which:

* the dynamic top-k at (256, 50 257) with the budgets [388, 608, 342, 428],
  on normal rows, on rows of scale 0.55 (the spread of a randomly
  initialised GPT-2's logits) and on constant rows; with ``--real`` also on
  the input of the ``fused`` float run's last round (its own budgets),
  captured as ``chip_smoke.py`` captures it, with statistics of its rows;
* both wire scatters at N 4, 64 rows, V 50 257, k_cap 128 and 1024;
* the dense adaptive aggregation at (4, 64, 50 257), a top-k-sparse stack;
* the distillation KL at (64, 50 257), T = 2, after ``chip_smoke.py``'s
  checks of the KL kernel: warm (the same inputs each launch) and cold (in
  turn over ``chip_smoke.COLD_COPIES`` copies of them);
* the causal attention at (96, 1024, D) on N(0, 1) q, k, v, D the
  ``--head-dim`` (64 unless said), after ``chip_smoke.py``'s checks of the
  attention kernel, beside fp32 SDPA in turns, with the opcode mix of this
  checkout's fp32 attention kernel at that D (``cuobjdump -sass``); an
  earlier build that refuses the head dim (one from before PR 30 at D 128,
  from before PR 33 at any D but 64 and 128) is left out of the turns.  At
  any D but 64 and 128 the three dtypes' probes time
  ``flash_attention_anyd_kernel`` (its instance for D: opcode mix in each)
  in turns against SDPA in their dtype, and its variant (``anyd_unroll_qk``:
  the Q K^T loop over D unrolled twice) in turns against it, with no
  clocked copy.
  At D = 128 the fp32 probe adds a clocked copy of an earlier
  build's kernel from before it had a Hopper design of its own (its splits
  inside its products' loops; also timed in turns with them left out), a
  clocked copy of this checkout's ``flash_attention_f32_d128_kernel`` (a
  consumer warpgroup's cycles a 64-key tile waiting for K, in Q K^T, the
  softmax, waiting for V^T and P V, and an item's epilogue and Q wait; the
  producer's first thread's waits, splits and transposition a tile) and
  its variants (the next tile prefetched into L2, O's rescale skipped),
  timed in turns against it.  Any attention probe first compares the SASS of each D = 64
  and D = 128 kernel of this checkout's attention library (fp32, bf16,
  fp16) with the earlier build's kernel, instruction by instruction;
* the bf16 top-k (``topk_mask_bf16``) on the same inputs rounded to bf16
  and on rows of one exponent bin (with ``--real``, the bf16 ``fused``
  run's input), after ``chip_smoke.py``'s checks of the bf16 top-k, both
  builds held ``torch.equal`` to the plain version; with a clocked copy of
  this checkout's bf16 kernel (load and high-digit histogram, the two
  scans and the low-digit pass, the replay, the store) and a copy that
  writes the row with plain stores instead of streaming ones, timed
  beside it;
* the bf16 attention (``flash_attention_bf16``) at (96, 1024, D), after
  ``chip_smoke.py``'s checks of the bf16 attention, both builds within the
  check and beside bf16 SDPA (a library call the port never makes), with a
  clocked copy of this checkout's kernel (at D 64 each consumer
  warpgroup's cycles waiting for K/V tiles, in Q K^T, in the softmax and
  in P V; at D 128, the persistent kernel's, also waiting for P V and in
  each item's first tile and epilogue), variants (at D 64 one block an SM;
  at D 128 three Q buffers and two V stages), and the bf16 kernel's opcode
  mix;
* the fp16 attention (``flash_attention_f16``) at (96, 1024, D), after
  ``chip_smoke.py``'s checks of the fp16 attention, as the fp32 probe;
* at ``--head-dim 128`` the fp32, bf16 and fp16 probes also run at yi-9b's
  prefill_32k shape, (32, 32 768, 128), both builds in turns and beside
  SDPA in that dtype, the plain version on two head-batches (with their
  D 128 variants);
* the bf16 wire scatter (``scatter_wire_sums_bf16``) at N 4, 64 rows, V
  50 257, k_cap 128 and 1024, after ``chip_smoke.py``'s checks of it, both
  builds ``torch.equal`` to the plain version, with clocked copies of the
  earlier build's kernel (made from DIR's source: zero-fill, index loads,
  value loads, adds, write) and of this checkout's (set-up, waiting for
  chunks, reading the slot, the adds, the write), and variants (chunk
  sizes, 512 consumer threads, the smallest tiles, no multicast);
* the bf16 KL (``distill_kl_bf16``) at (64, 50 257), T = 2, warm and cold,
  after ``chip_smoke.py``'s checks of it, both builds within tolerance,
  with clocked copies of both builds' kernels (the loop, the merges) and
  copies whose loop only loads, and variants (unrolled 4 times, plain
  ``__ldg`` loads, the slice prefetched into L2 at the start).

It also builds a copy of this checkout's ``topk_select.cu`` with clock
reads added at its fp32 kernel's phase boundaries (load, bisection, store)
and counters of its full passes, buffer counts and compactions, and prints
their medians over the 256 rows; and it runs the earlier top-k on a row
holding a NaN, to show what that kernel kept there.  The clock copies and
the variants are made by text substitution at fixed lines of the source:
when those lines change, the script stops with the line it could not find.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.core.topk import quantize_wire  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "probe"


def substituted(path: Path, pairs) -> str:
    """The source at ``path`` with each ``(old, new)`` replaced: a copy made
    by text substitution at fixed lines, which stops with the line it could
    not find once when the source changes."""
    src = path.read_text()
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"kernel_probe: source line not found once: {old!r}")
        src = src.replace(old, new)
    return src


def topk_clocks() -> str:
    """``topk_select.cu`` with per-block clocks and counters written to a
    device buffer set by ``topk_set_prof``: 16 int64 a row."""
    return substituted(CSRC / "topk_select.cu", (
        ("namespace {\n", "namespace {\n__device__ long long* g_prof;\n"),
        ("  const int r = blockIdx.x;\n  const int lane",
            "  const long long pt0 = clock64(); long long pg0;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pg0));\n"
            "  const int r = blockIdx.x;\n  const int lane"),
        ("  // -- bisection ---",
            "  const long long pt1 = clock64();\n  int pf = 0, pb = 0, pc = 0; long long pwc = 0;\n"
            "  // -- bisection ---"),
        ("        if (s.n_buf < 0) {  // a full pass\n", "        if (s.n_buf < 0) {  // a full pass\n          ++pf;\n"),
        ("        } else {  // a count over the buffer\n",
            "        } else {  // a count over the buffer\n          ++pb;\n"),
        ("          compact_row<kSmem>(", "          ++pc;\n          compact_row<kSmem>("),
        ("          warp_steps(s, buf, k);",
            "          const long long pw0 = clock64();\n          warp_steps(s, buf, k);\n"
            "          pwc = clock64() - pw0;"),
        ("  // -- the masked row ---", "  const long long pt2 = clock64();\n  // -- the masked row ---"),
        ("      outr[c] = v >= lo ? v : 0.0f;\n    }\n  }\n}\n",
            "      outr[c] = v >= lo ? v : 0.0f;\n    }\n  }\n"
            "  __syncthreads();\n"
            "  if (threadIdx.x == 0 && g_prof) { long long g1;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
            "    long long* d = g_prof + 16 * blockIdx.x;\n"
            "    d[0] = pt1 - pt0; d[1] = pt2 - pt1; d[2] = clock64() - pt2; d[3] = pf; d[4] = pb;\n"
            "    d[5] = pc; d[6] = pg0; d[7] = g1; d[8] = pwc; }\n}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid topk_set_prof(long long* p) { cudaMemcpyToSymbol(g_prof, &p, sizeof(p)); }\n'),
    ))


GLOBALTIMER = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}));'


def topk_bf16_clocks() -> str:
    """``topk_select.cu`` with per-block clocks at the bf16 kernel's phase
    boundaries written to a device buffer set by ``topk_set_prof``: 8 int64
    a row (load and high-digit histogram, scans and low-digit pass, replay,
    store; the block's globaltimer start and end)."""
    return substituted(CSRC / "topk_select.cu", (
        ("namespace {\n", "namespace {\n__device__ long long* g_prof;\n"),
        ("  const int tid = threadIdx.x;\n  const T* xr",
            "  const long long pt0 = clock64(); long long pg0;\n  " + GLOBALTIMER.format("pg0") + "\n"
            "  const int tid = threadIdx.x;\n  const T* xr"),
        ("  const bool any_nan = mn != mn;\n\n  // -- X_k",
            "  const bool any_nan = mn != mn;\n  const long long pt1 = clock64();\n\n  // -- X_k"),
        ("  // -- the 30 steps, replayed", "  const long long pt2 = clock64();\n  // -- the 30 steps, replayed"),
        ("  const typename H::T2 lo2 = H::up2(s_lo);\n",
            "  const typename H::T2 lo2 = H::up2(s_lo);\n"
            "  const long long pt3 = clock64();\n"),
        ("    for (int c = tid; c < vocab; c += kThreads) o16[c] = (uint16_t)keep2<T>(x16[c], lo2);\n  }\n}\n",
            "    for (int c = tid; c < vocab; c += kThreads) o16[c] = (uint16_t)keep2<T>(x16[c], lo2);\n  }\n"
            "  __syncthreads();\n"
            "  if (tid == 0 && g_prof) { long long g1;\n    " + GLOBALTIMER.format("g1") + "\n"
            "    long long* d = g_prof + 8 * blockIdx.x;\n"
            "    d[0] = pt1 - pt0; d[1] = pt2 - pt1; d[2] = pt3 - pt2; d[3] = clock64() - pt3;\n"
            "    d[6] = pg0; d[7] = g1; }\n}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid topk_set_prof(long long* p) { cudaMemcpyToSymbol(g_prof, &p, sizeof(p)); }\n'),
    ))


def attention_bf16_clocks() -> str:
    """``flash_attention.cu`` with the bf16 kernel's consumer cycles summed
    by phase (waiting for a K/V tile; Q K^T; the row max and the rescale;
    the exps, the P pieces and P V issued k-step by k-step, to its end) and
    written per warpgroup to a buffer set by ``attn_set_prof``: 8 int64
    each (the four sums, its tiles, its query tile, the block's globaltimer
    start and the warpgroup's end)."""
    return substituted(CSRC / "flash_attention.cu", (
        ("namespace {\n", "namespace {\n__device__ long long* g_aprof;\n"),
        ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n  // key tiles 0",
            "  long long pg0;\n  " + GLOBALTIMER.format("pg0") + "\n"
            "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n  // key tiles 0"),
        ("  mbar_wait(smem_u32(&bar_q), 0);\n",
            "  mbar_wait(smem_u32(&bar_q), 0);\n  long long cw = 0, cq = 0, csm = 0, cpv = 0;\n"),
        ("    mbar_wait(smem_u32(&bar_full[s]), (j / kStagesBf16) & 1);\n",
            "    const long long ca = clock64();\n    mbar_wait(smem_u32(&bar_full[s]), (j / kStagesBf16) & 1);\n"
            "    const long long cx = clock64();\n    cw += cx - ca;\n"),
        ("    fence_regs(sc);\n\n", "    fence_regs(sc);\n    const long long cc = clock64();\n    cq += cc - cx;\n\n"),
        ("    fence_regs(o);\n\n    // O += P V",
            "    fence_regs(o);\n    const long long cd = clock64();\n    csm += cd - cc;\n\n"
            "    // O += P V"),
        ("    fence_regs(o);\n    __syncwarp();\n",
            "    fence_regs(o);\n    cpv += clock64() - cd;\n"
            "    __syncwarp();\n"),
        ("          E::pack(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);\n  }\n}\n",
            "          E::pack(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);\n  }\n"
            "  if ((threadIdx.x & 127) == 0 && g_aprof) { long long g1;\n    " + GLOBALTIMER.format("g1") + "\n"
            "    long long* d = g_aprof + 8 * ((blockIdx.y * gridDim.x + blockIdx.x) * kConsumers + wg);\n"
            "    d[0] = cw; d[1] = cq; d[2] = csm; d[3] = cpv; d[4] = n_mine; d[5] = blockIdx.y;\n"
            "    d[6] = pg0; d[7] = g1; }\n}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid attn_set_prof(long long* p) { cudaMemcpyToSymbol(g_aprof, &p, sizeof(p)); }\n'),
    ))


# the D = 128 clocked copy's columns: cycles summed by phase over the tiles
# after each item's first, then over the items, then counts and globaltimer stamps
D128_TILE_PHASES = ("waiting for K and V", "issuing Q K^T, the rescale and P V", "waiting for Q K^T", "softmax",
                    "waiting for P V", "release and P pieces")
D128_ITEM_PHASES = ("waiting for Q", "tile 0", "the last P V and O out")


def attention_d128_clocks() -> str:
    """``flash_attention.cu`` with the D = 128 16-bit kernel's consumer
    cycles summed by phase (``D128_TILE_PHASES`` over the tiles after each
    item's first, ``D128_ITEM_PHASES`` over its items), read by each
    warpgroup's first thread and written to a buffer set by
    ``attn_set_prof``: 16 int64 a warpgroup (the nine sums, its tiles after
    the first, its items, its globaltimer start and end, 0, 0, 0)."""
    return substituted(CSRC / "flash_attention.cu", (
        ("namespace {\n", "namespace {\n__device__ long long* g_aprof;\n"),
        ("  constexpr uint64_t kTile = kD128TileBytes >> 4;  // a tile, in descriptor units\n",
            "  constexpr uint64_t kTile = kD128TileBytes >> 4;  // a tile, in descriptor units\n"
            "  long long pg0;\n  " + GLOBALTIMER.format("pg0") + "\n"
            "  long long prof[16] = {};\n"),
        ("    mbar_wait(smem_u32(&bar_qf[qb]), (n / kQB) & 1);\n",
            "    const long long i0_ = clock64();\n    mbar_wait(smem_u32(&bar_qf[qb]), (n / kQB) & 1);\n"
            "    const long long i1_ = clock64();\n    prof[6] += i1_ - i0_;\n"),
        ("    // tile j: Q K_j^T and P_{j-1} V_{j-1} issued together",
            "    prof[7] += clock64() - i1_;\n    // tile j: Q K_j^T and P_{j-1} V_{j-1} issued together"),
        ("      wait_k(tk);\n", "      const long long ka_ = clock64();\n      wait_k(tk);\n"),
        ("      __syncwarp();\n      qk_d128<E>(sc, dq, dk0 + (tk % kSK) * kTile);\n",
            "      __syncwarp();\n      const long long kb_ = clock64();\n      prof[0] += kb_ - ka_;\n"
            "      qk_d128<E>(sc, dq, dk0 + (tk % kSK) * kTile);\n"),
        ("      wgmma_wait<1>();  // Q K_j^T is done",
            "      const long long ie_ = clock64();\n      prof[1] += ie_ - kb_;\n"
            "      wgmma_wait<1>();  // Q K_j^T is done"),
        ("      online_softmax(sc, j == qt, diag_off, c, m0, m1, l0, l1, r0, r1);\n      wgmma_wait<0>();\n",
            "      const long long sa_ = clock64();\n      prof[2] += sa_ - ie_;\n"
            "      online_softmax(sc, j == qt, diag_off, c, m0, m1, l0, l1, r0, r1);\n"
            "      const long long sb_ = clock64();\n      prof[3] += sb_ - sa_;\n      wgmma_wait<0>();\n"
            "      const long long pw_ = clock64();\n      prof[4] += pw_ - sb_;\n"),
        ("      split_p<E>(sc, p_hi, p_lo);\n    }\n    // the last tile's P V, and O out\n",
            "      split_p<E>(sc, p_hi, p_lo);\n      prof[5] += clock64() - pw_;\n      ++prof[9];\n    }\n"
            "    const long long e0_ = clock64();\n    // the last tile's P V, and O out\n"),
        ("    stored = qb;\n    g += qt + 1;\n",
            "    stored = qb;\n    prof[8] += clock64() - e0_;\n    ++prof[10];\n    g += qt + 1;\n"),
        ("  if (leader) bulk_wait();  // shared memory stays until the last stores are done\n}\n",
            "  if (leader) bulk_wait();  // shared memory stays until the last stores are done\n"
            "  if (leader && g_aprof) { long long g1;\n    " + GLOBALTIMER.format("g1") + "\n"
            "    prof[11] = pg0; prof[12] = g1;\n"
            "    long long* d = g_aprof + 16 * (blockIdx.x * kConsumers + wg);\n"
            "    for (int x = 0; x < 16; ++x) d[x] = prof[x]; }\n}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid attn_set_prof(long long* p) { cudaMemcpyToSymbol(g_aprof, &p, sizeof(p)); }\n'),
    ))


# the fp32 attention's clocked copies at D = 128: cycles summed by phase, then counts
# and globaltimer stamps (``F32_STAMPS``) in each row of 16 int64
F32_SPLIT_PHASES = ("waiting for K/V (cp.async and the barrier)", "Q K^T (q's and K's splits inside)",
                    "softmax", "P V (P's and V's splits inside)", "the barrier after the tile", "epilogue")
F32_STAMPS = (6, 7, 8, 9)  # the row's tiles, its items (or query tiles), globaltimer start and end


def attention_f32_split_clocks(src: Path) -> str:
    """``flash_attention.cu`` as it was before the fp32 kernel at D = 128
    had a Hopper design of its own (``flash_attention_kernel<128>``: 32-key
    tiles on ``mma.sync``, every split inside the loops), with each warp's
    cycles by phase (``F32_SPLIT_PHASES``; the splits run inside the
    products' loops and count there) written by its lane 0 to a buffer set
    by ``attn_f32_set_prof``: 16 int64 a warp."""
    return substituted(src, (
        ("namespace {\n", "namespace {\n__device__ long long* g_fprof;\n"),
        ("  using T = Tiles32<D>;\n",
            "  using T = Tiles32<D>;\n  long long pg0;\n  " + GLOBALTIMER.format("pg0") + "\n"
            "  long long pw_ = 0, pq_ = 0, psm_ = 0, ppv_ = 0, pb_ = 0, ptiles_ = 0;\n"),
        ("  for (int it = 0; it < n_kt; ++it) {\n    if (it + 1 < n_kt) {\n",
            "  for (int it = 0; it < n_kt; ++it) {\n    const long long a0_ = clock64();\n"
            "    if (it + 1 < n_kt) {\n"),
        ("    __syncthreads();\n    const float* ks = smem + (it & 1) * kStage;\n",
            "    __syncthreads();\n    const long long a1_ = clock64();\n    pw_ += a1_ - a0_;\n"
            "    const float* ks = smem + (it & 1) * kStage;\n"),
        ("      // the causal mask, then the tile's row max across the quad\n",
            "      { float f_ = 0.f;\n#pragma unroll\n        for (int j = 0; j < kKeys / 8; ++j) f_ += s[j][0];\n"
            "        asm volatile(\"\" ::\"f\"(f_)); }\n"
            "      const long long a2_ = clock64();\n      pq_ += a2_ - a1_;\n"
            "      // the causal mask, then the tile's row max across the quad\n"),
        ("      // O += P V: the accumulators of keys (2t, 2t + 1) are the A columns\n",
            "      const long long a3_ = clock64();\n      psm_ += a3_ - a2_;\n"
            "      // O += P V: the accumulators of keys (2t, 2t + 1) are the A columns\n"),
        ("      }\n    }\n    __syncthreads();  // the tile is read before the next stage overwrites it\n  }\n",
            "      }\n      { float f_ = 0.f;\n#pragma unroll\n        for (int nd = 0; nd < D / 8; ++nd) f_ += o[nd][0];\n"
            "        asm volatile(\"\" ::\"f\"(f_)); }\n"
            "      ppv_ += clock64() - a3_;\n      ++ptiles_;\n    }\n"
            "    const long long a4_ = clock64();\n"
            "    __syncthreads();  // the tile is read before the next stage overwrites it\n"
            "    pb_ += clock64() - a4_;\n  }\n  const long long a5_ = clock64();\n"),
        ("          make_float2(o[nd][2] * inv1, o[nd][3] * inv1);\n  }\n}\n",
            "          make_float2(o[nd][2] * inv1, o[nd][3] * inv1);\n  }\n"
            "  if (lane == 0 && g_fprof && D == 128) { long long g1;\n    " + GLOBALTIMER.format("g1") + "\n"
            "    long long* d = g_fprof + 16 * ((blockIdx.y * gridDim.x + blockIdx.x) * kWarps + warp);\n"
            "    d[0] = pw_; d[1] = pq_; d[2] = psm_; d[3] = ppv_; d[4] = pb_; d[5] = clock64() - a5_;\n"
            "    d[6] = ptiles_; d[7] = 1; d[8] = pg0; d[9] = g1; }\n}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid attn_f32_set_prof(long long* p) { cudaMemcpyToSymbol(g_fprof, &p, sizeof(p)); }\n'),
    ))


# the fp32 D = 128 kernel's clocked copy: a consumer warpgroup's cycles by phase
# over its tiles, then over its items; the producer's first thread's over the
# K/V tiles and the items (``F32_STAMPS`` columns after them)
F32_D128_TILE_PHASES = ("waiting for K", "Q K^T (Q's loads and splits inside)", "softmax and P's split",
                        "waiting for V^T", "P V")
F32_D128_ITEM_PHASES = ("epilogue and the tiles past the diagonal", "waiting for Q")
F32_D128_PRODUCER_PHASES = ("waiting for K's release", "waiting for K to land",
                            "K's big and small parts, the barrier, V's load", "waiting for V^T's release",
                            "waiting for V to land", "V^T's big and small parts and the barrier",
                            "waiting for Q's release (per item)")


def attention_f32_d128_clocks() -> str:
    """``flash_attention.cu`` with ``flash_attention_f32_d128_kernel``'s
    cycles by phase written to a buffer set by ``attn_f32_set_prof``: 16
    int64 a row, three rows a block (consumer warpgroups 0 and 1: the
    ``F32_D128_TILE_PHASES`` and ``F32_D128_ITEM_PHASES`` sums; the
    producer's first thread: the ``F32_D128_PRODUCER_PHASES`` sums; then
    each row's ``F32_STAMPS``)."""
    # a row: the phases at 0-5 (a consumer's item phases at 10-11, the producer's
    # barrier at 10, its Q waits and Q loads at 11-12), then F32_STAMPS at 6-9
    rec = ("    if ({who} && g_fprof) {{ long long g1;\n      " + GLOBALTIMER.format("g1") + "\n"
           "      long long* d = g_fprof + 16 * (3 * blockIdx.x + {row});\n"
           "      for (int x_ = 0; x_ < 6; ++x_) d[x_] = {arr}[x_];\n"
           "      d[6] = {arr}[9]; d[7] = {arr}[10]; d[8] = pg0; d[9] = g1; d[10] = {arr}[6]; d[11] = {arr}[7]; }}\n")
    return substituted(CSRC / "flash_attention.cu", (
        ("namespace {\n", "namespace {\n__device__ long long* g_fprof;\n"),
        ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n\n  if (threadIdx.x == 0) {\n"
         "    for (int w = 0; w < kConsumers; ++w) {\n      mbar_init(smem_u32(&bar_qf[w]), 1);\n",
            "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n  long long pg0;\n  "
            + GLOBALTIMER.format("pg0") + "\n  long long pp_[16] = {}, cp_[16] = {};\n\n"
            "  if (threadIdx.x == 0) {\n"
            "    for (int w = 0; w < kConsumers; ++w) {\n      mbar_init(smem_u32(&bar_qf[w]), 1);\n"),
        ("          if (nq[w] > 0) mbar_wait(smem_u32(&bar_qe[w]), (nq[w] - 1) & 1);\n",
            "          const long long q0_ = clock64();\n"
            "          if (nq[w] > 0) mbar_wait(smem_u32(&bar_qe[w]), (nq[w] - 1) & 1);\n"
            "          pp_[7] += clock64() - q0_;\n          ++pp_[10];\n"),
        ("        mbar_wait(smem_u32(&bar_l), 0);\n        if (n > 0) mbar_wait(smem_u32(&bar_ke), (n - 1) & 1);\n",
            "        const long long a0_ = clock64();\n        mbar_wait(smem_u32(&bar_l), 0);\n"
            "        const long long a1_ = clock64();\n        pp_[1] += a1_ - a0_;\n"
            "        if (n > 0) mbar_wait(smem_u32(&bar_ke), (n - 1) & 1);\n"
            "        const long long a2_ = clock64();\n        pp_[0] += a2_ - a1_;\n        ++pp_[9];\n"),
        ("        landing_read();\n        if (leader) load(&tm_v, s_l, kF32Keys * j, bh, &bar_l);\n",
            "        landing_read();\n        if (leader) load(&tm_v, s_l, kF32Keys * j, bh, &bar_l);\n"
            "        const long long a3_ = clock64();\n        pp_[2] += a3_ - a2_;\n"),
        ("        mbar_wait(smem_u32(&bar_l), 1);\n        if (n > 0) mbar_wait(smem_u32(&bar_ve), (n - 1) & 1);\n",
            "        mbar_wait(smem_u32(&bar_l), 1);\n        const long long a5_ = clock64();\n"
            "        pp_[4] += a5_ - a3_;\n"
            "        if (n > 0) mbar_wait(smem_u32(&bar_ve), (n - 1) & 1);\n"
            "        const long long a6_ = clock64();\n        pp_[3] += a6_ - a5_;\n"),
        ("        landing_read();\n        if (leader) {  // the next K tile: this item's, or the next item's first\n",
            "        landing_read();\n        pp_[5] += clock64() - a6_;\n"
            "        if (leader) {  // the next K tile: this item's, or the next item's first\n"),
        ("    return;\n  }\n  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(kF32ConsumerRegs));\n",
            rec.format(who="leader", row=2, arr="pp_").replace(
                "d[10] = pp_[6]; d[11] = pp_[7];", "d[11] = pp_[7]; d[12] = pp_[10];")
            + "    return;\n  }\n  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(kF32ConsumerRegs));\n"),
        ("    if (n_mine > 0) mbar_wait(smem_u32(&bar_qf[wg]), nq & 1);\n",
            "    { const long long w0_ = clock64();\n    if (n_mine > 0) mbar_wait(smem_u32(&bar_qf[wg]), nq & 1);\n"
            "    cp_[6] += clock64() - w0_; }\n"),
        ("      mbar_wait(smem_u32(&bar_kf), (n + j) & 1);\n"
         "      __syncwarp();  // the warp converged again for the .aligned wgmma instructions\n",
            "      const long long k0_ = clock64();\n      mbar_wait(smem_u32(&bar_kf), (n + j) & 1);\n"
            "      __syncwarp();  // the warp converged again for the .aligned wgmma instructions\n"
            "      const long long k1_ = clock64();\n      cp_[0] += k1_ - k0_;\n"),
        ("      qk_f32(sb, ss, q_row, g, dk, dks);\n      fence_regs(sb);\n      fence_regs(ss);\n",
            "      qk_f32(sb, ss, q_row, g, dk, dks);\n      fence_regs(sb);\n      fence_regs(ss);\n"
            "      const long long k2_ = clock64();\n      cp_[1] += k2_ - k1_;\n"),
        ("      fence_regs(o);\n      mbar_wait(smem_u32(&bar_vf), (n + j) & 1);\n      __syncwarp();\n"
         "      pv_f32(o, pb, ps, dvt, dvts);\n      wgmma_wait<0>();\n      fence_regs(o);\n",
            "      fence_regs(o);\n      const long long k3_ = clock64();\n      cp_[2] += k3_ - k2_;\n"
            "      mbar_wait(smem_u32(&bar_vf), (n + j) & 1);\n      __syncwarp();\n"
            "      const long long k4_ = clock64();\n      cp_[3] += k4_ - k3_;\n"
            "      pv_f32(o, pb, ps, dvt, dvts);\n      wgmma_wait<0>();\n      fence_regs(o);\n"
            "      cp_[4] += clock64() - k4_;\n      ++cp_[9];\n"),
        ("    if (n_mine > 0) {  // O / l, rows past seq not written\n",
            "    const long long e0_ = clock64();\n    if (n_mine > 0) {  // O / l, rows past seq not written\n"),
        ("    n += n_item;\n  }\n}\n",
            "    cp_[5] += clock64() - e0_;\n    ++cp_[10];\n    n += n_item;\n  }\n"
            + rec.format(who="(threadIdx.x & 127) == 0", row="wg", arr="cp_").replace(
                "d[x_] = cp_[x_];", "d[x_] = x_ < 5 ? cp_[x_] : 0;").replace(
                "d[10] = cp_[6]; d[11] = cp_[7];", "d[10] = cp_[5]; d[11] = cp_[6];") + "}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid attn_f32_set_prof(long long* p) { cudaMemcpyToSymbol(g_fprof, &p, sizeof(p)); }\n'),
    ))


def attention_f32_nosplit(src: Path) -> str:
    """The same source with the split left out (big = x, small = 0: every
    product still runs, on wrong values), so that its time beside the
    kernel's is the splits' cost."""
    return substituted(src, ((
        "  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "  small = __float_as_uint(x - __uint_as_float(big));\n",
        "  big = __float_as_uint(x);\n  small = 0u;\n"),))


def gt(var: str) -> str:
    return GLOBALTIMER.format(var)


def scatter_loader_clocks(src: Path) -> str:
    """``sparse_agg.cu`` as it was before the bf16 wire scatter had a kernel
    of its own (it ran the fp32 kernel's templated body on bf16 loads), with thread 0's
    cycles by phase written for the bf16 instantiation to a buffer set by
    ``scatter_set_prof``: 8 int64 a block (zero-fill; index loads; value
    loads, waited for; the adds and the barriers between clients; the
    write; -; the block's globaltimer start and end)."""
    return substituted(src, (
        ("namespace {\n", "namespace {\n__device__ long long* g_sprof;\n"),
        ("  const int t = blockIdx.x, r = blockIdx.y;\n",
            "  long long pg0;\n  " + gt("pg0") + "\n  const long long c0_ = clock64();\n"
            "  const int t = blockIdx.x, r = blockIdx.y;\n"),
        ("  __syncthreads();\n\n  // The row's N*k entries",
            "  __syncthreads();\n  const long long c1_ = clock64();\n  long long cidx = 0, cval = 0, cadd = 0;\n\n"
            "  // The row's N*k entries"),
        ("  for (int e0 = 0; e0 < total; e0 += step) {\n",
            "  for (int e0 = 0; e0 < total; e0 += step) {\n    const long long ca_ = clock64();\n"),
        ("    float2 v[kBatch];\n",
            "    { int so = 0; for (int i = 0; i < kBatch; ++i) so += off[i]; asm volatile(\"\" ::\"r\"(so)); }\n"
            "    const long long cb_ = clock64();\n    cidx += cb_ - ca_;\n    float2 v[kBatch];\n"),
        ("    const int n_last = (min(total, e0 + step) - 1) / k;\n",
            "    { float sv = 0.f; for (int i = 0; i < kBatch; ++i) if (off[i] >= 0) sv += v[i].x + v[i].y;\n"
            "      asm volatile(\"\" ::\"f\"(sv)); }\n"
            "    const long long cc_ = clock64();\n    cval += cc_ - cb_;\n"
            "    const int n_last = (min(total, e0 + step) - 1) / k;\n"),
        ("      __syncthreads();  // client n lands before client n+1 adds\n    }\n  }\n",
            "      __syncthreads();  // client n lands before client n+1 adds\n    }\n    cadd += clock64() - cc_;\n  }\n"
            "  const long long c2_ = clock64();\n"),
        ("      if (c >= 0 && c < vocab) den_r[c] = from_f32<Out>(s_den[i]);\n    }\n  }\n}\n",
            "      if (c >= 0 && c < vocab) den_r[c] = from_f32<Out>(s_den[i]);\n    }\n  }\n"
            "  __syncthreads();\n"
            "  if (sizeof(Out) == 2 && threadIdx.x == 0 && g_sprof) { long long g1;\n    " + gt("g1") + "\n"
            "    long long* d = g_sprof + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
            "    d[0] = c1_ - c0_; d[1] = cidx; d[2] = cval; d[3] = cadd; d[4] = clock64() - c2_;\n"
            "    d[6] = pg0; d[7] = g1; }\n}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid scatter_set_prof(long long* p) { cudaMemcpyToSymbol(g_sprof, &p, sizeof(p)); }\n'),
    ))


KL_LOADER_BF16_BODY = """        const uint4 a = __ldg(t8 + i), b = __ldg(s8 + i);
        float tt[4], ss[4];
        unpack2(tt, a.x, inv_temp);
        unpack2(tt + 2, a.y, inv_temp);
        unpack2(ss, b.x, inv_temp);
        unpack2(ss + 2, b.y, inv_temp);
        add_tile<false>(st, tt, ss, 4);
        unpack2(tt, a.z, inv_temp);
        unpack2(tt + 2, a.w, inv_temp);
        unpack2(ss, b.z, inv_temp);
        unpack2(ss + 2, b.w, inv_temp);
        add_tile<false>(st, tt, ss, 4);
"""


def kl_loader_clocks(src: Path, loads_only: bool = False) -> str:
    """``distill_kl.cu`` as it was before the bf16 KL had a kernel of its own
    (it ran the fp32 kernel's body on bf16 loads), with thread 0's cycles by phase written for
    the bf16 instantiation to a buffer set by ``kl_set_prof``: 8 int64 a
    block (the streaming loop, loads and math; the warp merge; the first
    cluster barrier; the merge through distributed shared memory and the
    second barrier; the cluster rank; -; globaltimer start and end).
    ``loads_only``: the bf16 loop loads and folds its words into U without
    the math (its result is not a KL), so that its loop cycles are the
    loads'."""
    pairs = [
        ("namespace {\n", "namespace {\n__device__ long long* g_kprof;\n"),
        ("__device__ __forceinline__ void merge_and_write(KL st, cg::cluster_group& cluster, float* out) {\n",
            "__device__ __forceinline__ void merge_and_write(KL st, cg::cluster_group& cluster, float* out,\n"
            "    long long c0_, long long c1_, long long pg0, bool rec) {\n"),
        ("  st = warp_merge(st);\n  __shared__ KL part[kWarps];\n",
            "  st = warp_merge(st);\n  const long long c2_ = clock64();\n  __shared__ KL part[kWarps];\n"),
        ("  cluster.sync();  // every warp's partial is in its CTA's shared memory\n",
            "  cluster.sync();  // every warp's partial is in its CTA's shared memory\n"
            "  const long long c3_ = clock64();\n"),
        ("  cluster.sync();  // no CTA leaves while rank 0 may still read its shared memory\n}\n",
            "  cluster.sync();  // no CTA leaves while rank 0 may still read its shared memory\n"
            "  if (rec && threadIdx.x == 0 && g_kprof) { long long g1;\n    " + gt("g1") + "\n"
            "    long long* d = g_kprof + 8 * blockIdx.x;\n"
            "    d[0] = c1_ - c0_; d[1] = c2_ - c1_; d[2] = c3_ - c2_; d[3] = clock64() - c3_; d[4] = rank;\n"
            "    d[6] = pg0; d[7] = g1; }\n}\n"),
        ("  cg::cluster_group cluster = cg::this_cluster();\n  const int n_ranks = (int)cluster.num_blocks();\n",
            "  long long pg0;\n  " + gt("pg0") + "\n  const long long c0_ = clock64();\n"
            "  cg::cluster_group cluster = cg::this_cluster();\n  const int n_ranks = (int)cluster.num_blocks();\n"),
        ("  merge_and_write(st, cluster, out + r);\n",
            "  const long long c1_ = clock64();\n  merge_and_write(st, cluster, out + r, c0_, c1_, pg0, sizeof(T) == 2);\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid kl_set_prof(long long* p) { cudaMemcpyToSymbol(g_kprof, &p, sizeof(p)); }\n'),
    ]
    if loads_only:
        pairs.append((KL_LOADER_BF16_BODY,
                      "        const uint4 a = __ldg(t8 + i), b = __ldg(s8 + i);\n"
                      "        st.u += __uint_as_float(((a.x ^ b.x ^ a.y ^ b.y ^ a.z ^ b.z ^ a.w ^ b.w) & 0x007fffffu)"
                      " | 0x3f800000u);\n"))
    return substituted(src, pairs)


def scatter_bf16_clocks() -> str:
    """``sparse_agg.cu`` with consumer thread 0's cycles by phase in the
    bf16 wire scatter's own kernel, written to a buffer set by
    ``scatter_set_prof``: 8 int64 a block (set-up, clearing the marks and
    the cluster barrier; waiting for chunks to land; taking the entries out
    of the slot; handing it back, the adds and the barriers between
    clients; -; the write; the block's globaltimer start and end)."""
    return substituted(CSRC / "sparse_agg.cu", (
        ("namespace {\n", "namespace {\n__device__ long long* g_sprof;\n"),
        ("  const int t = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;\n",
            "  long long pg0;\n  " + gt("pg0") + "\n  const long long c0_ = clock64();\n"
            "  const int t = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;\n"),
        ("  consumers_sync();  // no column is marked\n",
            "  consumers_sync();  // no column is marked\n"
            "  const long long c1_ = clock64();\n  long long cw = 0, cread = 0, cadd = 0;\n"),
        ("    mbar_wait(smem_u32(&full[s]), (i / kRing) & 1);\n",
            "    const long long ca_ = clock64();\n    mbar_wait(smem_u32(&full[s]), (i / kRing) & 1);\n"
            "    const long long cb_ = clock64();\n    cw += cb_ - ca_;\n"),
        ("    __syncwarp();\n    if ((tid & 31) == 0) mbar_arrive(smem_u32(&done[s]));",
            "    { float f = 0.f; for (int q = 0; q < kPerThread; ++q) f += va[q] + vb[q] + off[q];\n"
            "      asm volatile(\"\" ::\"f\"(f)); }\n"
            "    const long long cs_ = clock64();\n    cread += cs_ - cb_;\n"
            "    __syncwarp();\n    if ((tid & 31) == 0) mbar_arrive(smem_u32(&done[s]));"),
        ("    if ((i + 1) % per_client == 0) consumers_sync();  // client n lands before client n+1 adds\n  }\n",
            "    if ((i + 1) % per_client == 0) consumers_sync();  // client n lands before client n+1 adds\n"
            "    cadd += clock64() - cs_;\n  }\n  const long long c2_ = clock64();\n"),
        ("      if (col >= 0 && col < vocab) den_r[col] = from_f32<T>(marked(s_den, marks, i));\n"
         "    }\n  }\n}\n",
            "      if (col >= 0 && col < vocab) den_r[col] = from_f32<T>(marked(s_den, marks, i));\n"
            "    }\n  }\n"
            "  consumers_sync();\n"
            "  if (tid == 0 && g_sprof) { long long g1;\n    " + gt("g1") + "\n"
            "    long long* d = g_sprof + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
            "    d[0] = c1_ - c0_; d[1] = cw; d[2] = cread; d[3] = cadd; d[5] = clock64() - c2_;\n"
            "    d[6] = pg0; d[7] = g1; }\n}\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid scatter_set_prof(long long* p) { cudaMemcpyToSymbol(g_sprof, &p, sizeof(p)); }\n'),
    ))


def kl_bf16_clocks(loads_only: bool = False) -> str:
    """``distill_kl.cu`` with thread 0's cycles by phase in the bf16 KL's own
    kernel, written to a buffer set by ``kl_set_prof``: 8 int64 a block
    (the loop; the warp and CTA merges and the store to the first CTA; the
    first CTA's wait for the cluster; its final merge; the cluster rank; -;
    globaltimer start and end).  ``loads_only``: the loop loads each granule
    pair and folds its words into U without the math."""
    rec = ("#define KL_REC(x2, x3) if (threadIdx.x == 0 && g_kprof) { long long g1; "
           + gt("g1") + " long long* d = g_kprof + 8 * blockIdx.x; d[0] = c1_ - c0_; d[1] = c2_ - c1_; "
           "d[2] = (x2); d[3] = (x3); d[4] = rank; d[6] = pg0; d[7] = g1; }\n")
    pairs = [
        ("namespace {\n", "namespace {\n__device__ long long* g_kprof;\n" + rec),
        ("__device__ __forceinline__ void push_merge_and_write(KL st, cg::cluster_group& cluster, float* out) {\n",
            "__device__ __forceinline__ void push_merge_and_write(KL st, cg::cluster_group& cluster, float* out,\n"
            "    long long c0_, long long c1_, long long pg0) {\n"),
        ("    if (lane == 0) *cluster.map_shared_rank(&slot[rank], 0) = st;\n  }\n"
         "  cluster_arrive();  // this CTA's state is in the first CTA's slot\n  if (rank != 0) return;\n"
         "  cluster_wait();\n",
            "    if (lane == 0) *cluster.map_shared_rank(&slot[rank], 0) = st;\n  }\n"
            "  const long long c2_ = clock64();\n"
            "  cluster_arrive();  // this CTA's state is in the first CTA's slot\n"
            "  if (rank != 0) { KL_REC(0, 0); return; }\n"
            "  cluster_wait();\n  const long long c3_ = clock64();\n"),
        ("      *out = st.u / st.t.z - lse_t + lse_s;\n    }\n  }\n}\n",
            "      *out = st.u / st.t.z - lse_t + lse_s;\n    }\n  }\n  KL_REC(c3_ - c2_, clock64() - c3_);\n}\n"),
        ("                         float* __restrict__ out, int vocab, float inv_temp) {\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n",
            "                         float* __restrict__ out, int vocab, float inv_temp) {\n"
            "  long long pg0;\n  " + gt("pg0") + "\n"
            "  const long long c0_ = clock64();\n  cg::cluster_group cluster = cg::this_cluster();\n"),
        ("  push_merge_and_write(st, cluster, out + r);\n",
            "  const long long c1_ = clock64();\n  push_merge_and_write(st, cluster, out + r, c0_, c1_, pg0);\n"),
        ('extern "C" {\n',
            'extern "C" {\nvoid kl_set_prof(long long* p) { cudaMemcpyToSymbol(g_kprof, &p, sizeof(p)); }\n'),
    ]
    if loads_only:
        pairs.append(("      add_granule<T>(st, load_granule(t8 + i), load_granule(s8 + i), inv_temp);\n",
                      "    { const uint4 a = load_granule(t8 + i), b = load_granule(s8 + i);\n"
                      "      st.u += __uint_as_float(((a.x ^ b.x ^ a.y ^ b.y ^ a.z ^ b.z ^ a.w ^ b.w) & 0x007fffffu)"
                      " | 0x3f800000u); }\n"))
    return substituted(CSRC / "distill_kl.cu", pairs)


# the kernels whose registers, shared memory and spills the probe prints
PTXAS_KEYS = ("topk_mask_kernel", "topk_radix_bf16_kernel", "topk_radix_16_kernel", "scatter_wire_kernel",
              "scatter_wire_bf16_kernel", "scatter_wire_16_kernel", "sparse_aggregate", "distill_kl_kernel",
              "distill_kl_bf16_kernel", "distill_kl_16_kernel", "flash_attention_kernel",
              "flash_attention_f32_d128_kernel",
              "flash_attention_bf16_kernel", "flash_attention_16_kernel", "flash_attention_anyd_kernel")
# builds of this checkout's bf16 kernels with a line or two changed, timed beside it
VARIANTS = {
    "topk_plain_stores": ("topk_select.cu", [(
        "      __stcs(reinterpret_cast<uint4*>(outr - q) + g,\n             make_uint4(",
        "      *(reinterpret_cast<uint4*>(outr - q) + g) = (\n             make_uint4(")]),
    "attention_1_block": ("flash_attention.cu", [("__launch_bounds__(kBf16Threads, 2)",
                                                  "__launch_bounds__(kBf16Threads, 1)")]),
}
VARIANTS.update({
    # the bf16 scatter's tiles halved (16 a row at V 50 257, five CTAs an SM) and doubled (4, two)
    # chunks of 512 entries in a ring of 4, and of 256 in a ring of 4 (8.3 KB: small enough for
    # more, smaller tiles in one wave at 64 rows)
    **{f"scatter_chunk_{n}": ("sparse_agg.cu", [("constexpr int kChunk = 1024;", f"constexpr int kChunk = {n};"),
                                                ("constexpr int kRing = 3;", "constexpr int kRing = 4;")])
       for n in (512, 256)},
    # 512 consumer threads instead of 256
    "scatter_512_threads": ("sparse_agg.cu", [("constexpr int k16Consumers = 256;",
                                               "constexpr int k16Consumers = 512;")]),
    # always the smallest tiles (the launch's rule where no cut fits one wave)
    "scatter_tiles_800": ("sparse_agg.cu", [("  for (int want = 1; want < most; ++want) {",
                                             "  for (int want = most; want < most; ++want) {")]),
    # no cluster: each CTA bulk-copies its row's wire itself (from L2, once a tile)
    "scatter_no_multicast": ("sparse_agg.cu", [("  t.cluster = min(kMaxCluster, want);", "  t.cluster = 1;")]),
    # the bf16 KL's loop unrolled 4 times (4 granules of each operand in flight a thread)
    "kl_unroll_4": ("distill_kl.cu", [("#pragma unroll 2\n    for (int i = b0 + threadIdx.x; i < b1; i += kThreads)\n"
                                       "      add_granule<T>(",
                                       "#pragma unroll 4\n    for (int i = b0 + threadIdx.x; i < b1; i += kThreads)\n"
                                       "      add_granule<T>(")]),
    # the bf16 KL with the CTA's slice prefetched into L2 by bulk prefetches at its start
    "kl_prefetch": ("distill_kl.cu", [(
        "    const uint4* s8 = reinterpret_cast<const uint4*>(s + head);\n#pragma unroll 2\n",
        "    const uint4* s8 = reinterpret_cast<const uint4*>(s + head);\n"
        "    if (threadIdx.x == 0)\n"
        "      for (int g = b0; g < b1; g += 1024) {\n"
        "        const unsigned bytes = 16u * (unsigned)min(1024, b1 - g);\n"
        "        asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::\"l\"(t8 + g), \"r\"(bytes) : \"memory\");\n"
        "        asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::\"l\"(s8 + g), \"r\"(bytes) : \"memory\");\n"
        "      }\n#pragma unroll 2\n")]),
    # the bf16 KL's loads as plain __ldg, no L2 fetch-size hint
    "kl_ldg": ("distill_kl.cu", [(
        '  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"\n'
        '      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));\n',
        "  v = __ldg(p);\n")]),
})
# the D = 128 16-bit kernel with three Q buffers and two V stages in the same shared memory
VARIANTS["attention_d128_q3_v2"] = ("flash_attention.cu", [(
    "constexpr int kD128QBuffers = 2, kD128KStages = 2, kD128VStages = 3;",
    "constexpr int kD128QBuffers = 3, kD128KStages = 2, kD128VStages = 2;")])
# the fp32 D = 128 kernel with parts tried and not taken: the next tile's K and V prefetched
# into L2 a tile ahead of their loads; O rescaled only where a row of the warp has a new maximum
VARIANTS["attention_f32_l2_prefetch"] = ("flash_attention.cu", [(
    "      for (int j = 0; j < n_item; ++j, ++n) {\n        // K tile j, landed,",
    "      for (int j = 0; j < n_item; ++j, ++n) {\n"
    "        if (leader) {\n          const int ni = j + 1 < n_item ? i : next_item(r);\n"
    "          const int row0 = j + 1 < n_item ? kF32Keys * (j + 1) : 0;\n"
    "          const CUtensorMap* maps[2] = {&tm_k, &tm_v};\n"
    "          for (int x = 0; ni >= 0 && x < 8; ++x)\n"
    "            asm volatile(\"cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\\n\"\n"
    "                         ::\"l\"((uint64_t)maps[x / 4]), \"r\"(32 * (x % 4)), \"r\"(row0), \"r\"(ni % n_bh)\n"
    "                         : \"memory\");\n"
    "        }\n        // K tile j, landed,")])
VARIANTS["attention_f32_rescale_skip"] = ("flash_attention.cu", [(
    "      rescale_o(o, r0, r1);\n      // P's big and small parts",
    "      if (__any_sync(0xffffffffu, r0 != 1.0f || r1 != 1.0f)) rescale_o(o, r0, r1);\n"
    "      // P's big and small parts")])
# the any-D attention with its Q K^T loop over D's 16-column steps unrolled twice (fp32 and 16-bit)
VARIANTS["anyd_unroll_qk"] = ("flash_attention.cu", [
    ("#pragma unroll 1\n    for (int m = 0; m < n16; ++m) {", "#pragma unroll 2\n    for (int m = 0; m < n16; ++m) {"),
    ("#pragma unroll 1\n    for (int kk = 0; kk < n16; ++kk) {", "#pragma unroll 2\n    for (int kk = 0; kk < n16; ++kk) {")])
# a variant that changes one head dim's instance only, built and timed at that head dim alone
# (the D = 128 attention already runs one block an SM; "any": the any-D kernel's, at any D but
# 64 and 128, in each dtype)
VARIANT_HEAD_DIM = {"attention_1_block": 64,
                    **{name: 128 for name in VARIANTS if name.startswith(("attention_d128", "attention_f32"))},
                    **{name: "any" for name in VARIANTS if name.startswith("anyd")}}
VARIANT_OF = {"topk_plain_stores": "topk_bf16", "attention_1_block": "attention_bf16",
              **{name: "attention_bf16" for name in VARIANTS if name.startswith("attention_d128")},
              **{name: "attention" for name in VARIANTS if name.startswith(("attention_f32", "anyd"))},
              **{name: "scatter_bf16" for name in VARIANTS if name.startswith("scatter")},
              **{name: "kl_bf16" for name in VARIANTS if name.startswith("kl")}}


def variant_at(name: str, d: int) -> bool:
    """Whether variant ``name`` is built and timed at head dim ``d``."""
    want = VARIANT_HEAD_DIM.get(name, d)
    return want == d or (want == "any" and d not in (64, 128))


def anyd_variants_ab(libs, ab: dict, dtype: torch.dtype) -> None:
    """The any-D kernel's variants against this build, in turns, on
    ``attention_ab``'s inputs in ``dtype``, each held to the plain version."""
    b, h, seq, d = ab["shape"]
    args, out, stream = ab["args"], ab["out"], ab["stream"]
    for name in (n for n in VARIANTS if VARIANT_HEAD_DIM.get(n) == "any" and n in libs):
        fn = c_fn(libs[name], ATTN_SYMBOL[dtype], 4, 3, 1)
        run = lambda fn=fn: fn(*args, b * h, seq, d, d**-0.5, stream)  # noqa: E731
        out.fill_(float("nan"))
        assert run() == 0, name
        torch.cuda.synchronize()
        err = cs.attention_err(out, ab["want"], ab["tol"])
        print(f"[probe] flash_attention{cs.TAG[dtype]} {name} at ({b * h}, {seq}, {d}): max |diff| {err:.3e}",
              flush=True)
        in_turns(f"flash_attention{cs.TAG[dtype]} {name} at D {d} (earlier: this build)", ab["runs"]["this"], run)


def c_fn(lib: ctypes.CDLL, symbol: str, n_ptr: int, n_int: int, n_float: int = 0):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = [P] * n_ptr + [I] * n_int + [F] * n_float + [P], I
    return fn


@contextlib.contextmanager
def smi_samples():
    """The SM clock (MHz) and the power (W) the card reports (``nvidia-smi``,
    every 50 ms) while the block runs: a list of pairs, filled on exit."""
    samples: list[tuple[float, float]] = []
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield samples
    finally:
        proc.terminate()
        out, _ = proc.communicate()
        samples += [(float(a), float(b)) for a, b in (line.split(",") for line in out.splitlines()
                                                      if line.count(",") == 1)]


@contextlib.contextmanager
def smi_clocks(label: str):
    """``smi_samples`` over the block, printed as medians."""
    with smi_samples() as got:
        yield
    if got:
        sm, watts = [a for a, _ in got], [b for _, b in got]
        print(f"[probe] {label}: SM clock median {median(sm):.0f} MHz (min {min(sm):.0f}, max {max(sm):.0f}), "
              f"power median {median(watts):.1f} W, {len(got)} samples", flush=True)


def in_turns(label: str, old, new, clocks: bool = False, **timing) -> None:
    """``old`` and ``new`` timed in turns (old, new, new, old); with
    ``clocks``, each time beside the median SM clock and power while it ran."""
    t, notes = [], []
    for f in (old, new, new, old):
        with smi_samples() if clocks else contextlib.nullcontext([]) as got:
            t.append(cs.time_ms(f, **timing) * 1e3)
        notes.append(f" ({median(a for a, _ in got):.0f} MHz, {median(b for _, b in got):.0f} W)" if got else "")
    print(f"[probe] {label}: earlier {t[0]:.2f}{notes[0]} / {t[3]:.2f}{notes[3]} us, this {t[1]:.2f}{notes[1]} / "
          f"{t[2]:.2f}{notes[2]} us", flush=True)


def scatter_ab(libs, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    new_f = ops._fn("sparse_agg", "scatter_wire_sums_f32", 5, 4)
    new_q = ops._fn("sparse_agg", "scatter_wire_sums_dequant_i8", 6, 5)
    old_f = c_fn(libs["parent_agg"], "scatter_wire_sums_f32", 5, 4)
    old_q = c_fn(libs["parent_agg"], "scatter_wire_sums_dequant_i8", 6, 5)
    for k_cap in (128, 1024):
        wire = cs.make_wire(k_cap, seed=7, device=device)
        n, rows, k = wire.values.shape
        a, b = cs.float_channels(wire, "adaptive")
        qw = quantize_wire(wire)
        num = torch.empty((rows, cs.VOCAB), device=device)
        den = torch.empty_like(num)
        fp = [t.data_ptr() for t in (a, b, wire.indices, num, den)]
        qp = [t.data_ptr() for t in (qw.values, qw.scale, qw.mask.view(torch.uint8), qw.indices, num, den)]
        for fn in (new_f, old_f):
            assert fn(*fp, n, rows, k, cs.VOCAB, stream) == 0
            torch.cuda.synchronize()
            want = ref.scatter_wire_sums_ref(a, b, wire.indices, cs.VOCAB)
            assert torch.equal(num, want[0]) and torch.equal(den, want[1])
        in_turns(f"scatter_wire_sums k_cap={k_cap}", lambda: old_f(*fp, n, rows, k, cs.VOCAB, stream),
                 lambda: new_f(*fp, n, rows, k, cs.VOCAB, stream))
        graph_turns(f"scatter_wire_sums k_cap={k_cap}", [lambda st: old_f(*fp, n, rows, k, cs.VOCAB, st)],
                    [lambda st: new_f(*fp, n, rows, k, cs.VOCAB, st)])
        in_turns(f"scatter_wire_sums_dequant k_cap={k_cap}",
                 lambda: old_q(*qp, n, rows, k, cs.VOCAB, 0, stream),
                 lambda: new_q(*qp, n, rows, k, cs.VOCAB, 0, stream))


def agg_ab(libs, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    stack = cs.dense_stack([388, 608, 342, 428], seed=13, device=device)
    n = stack.shape[0]
    out = torch.empty((cs.ROWS, cs.VOCAB), device=device)
    new = ops._fn("sparse_agg", "sparse_aggregate_f32", 2, 3)
    old = c_fn(libs["parent_agg"], "sparse_aggregate_f32", 2, 3)
    runs = {name: (lambda fn=fn: fn(stack.data_ptr(), out.data_ptr(), n, cs.ROWS, cs.VOCAB, stream))
            for name, fn in (("earlier", old), ("this", new))}
    want = ref.sparse_aggregate_ref(stack)
    for name, fn in runs.items():
        out.fill_(float("nan"))
        assert fn() == 0, name
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
    in_turns(f"sparse_aggregate at ({n}, {cs.ROWS}, {cs.VOCAB})", runs["earlier"], runs["this"])


def describe(x: torch.Tensor, kk: torch.Tensor) -> None:
    """Medians over the rows: spread, the k-th largest, and how many values
    lie between the kernel's first and last thresholds (the first chunk's
    mean + 1.75 and + 2.75 deviations)."""
    head = x[:, : x.shape[1] // 8]
    mean, sd = head.mean(dim=1, keepdim=True), head.std(dim=1, correction=0, keepdim=True)
    xk = torch.stack([torch.topk(x[r], int(kk[r])).values[-1] for r in range(x.shape[0])])
    between = ((x >= mean + 1.75 * sd) & (x < mean + 2.75 * sd)).sum(dim=1).float()
    med = lambda v: float(torch.median(v.float()))  # noqa: E731
    print(f"[probe]   rows: min {med(x.amin(1))}, max {med(x.amax(1))}, mean {med(x.mean(1))}, "
          f"std {med(x.std(1))}, X_k {med(xk)}, values between the thresholds {med(between)}", flush=True)


def topk_ab(libs, device, real=None) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rows, vocab = 4 * cs.ROWS, cs.VOCAB
    gen = torch.Generator(device=device).manual_seed(5)
    budgets = torch.tensor([388, 608, 342, 428], dtype=torch.int32, device=device).repeat_interleave(cs.ROWS)
    inputs = {"normal rows": (torch.randn((rows, vocab), generator=gen, device=device), budgets),
              "rows of scale 0.55": (0.55 * torch.randn((rows, vocab), generator=gen, device=device), budgets),
              "constant rows": (torch.full((rows, vocab), 0.5, device=device), budgets)}
    if real is not None:
        inputs["the fused run's input"] = real
    out = torch.empty((rows, vocab), device=device)
    new = ops._fn("topk_select", "topk_mask_f32", 3, 5)
    old = c_fn(libs["parent_topk"], "topk_mask_f32", 3, 5)
    clk = c_fn(libs["topk_clocks"], "topk_mask_f32", 3, 5)
    libs["topk_clocks"].topk_set_prof.argtypes = [P]
    clocks = torch.zeros((rows, 16), dtype=torch.int64, device=device)
    libs["topk_clocks"].topk_set_prof(clocks.data_ptr())
    for label, (x, kk) in inputs.items():
        args = (x.data_ptr(), kk.data_ptr(), out.data_ptr(), rows, vocab, 0, 1, 1, stream)
        want = ref.topk_mask_ref(x, kk, guard=True)
        for fn in (new, old, clk):
            assert fn(*args) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want), label
        in_turns(f"topk_mask_dynamic on {label}", lambda a=args: old(*a), lambda a=args: new(*a))
        d = clocks.cpu()
        parts = []
        for j, name in ((0, "load cycles"), (1, "bisection cycles"), (2, "store cycles"), (8, "warp cycles"),
                        (3, "full passes"), (4, "buffer counts"), (5, "compactions")):
            parts.append(f"{name} {statistics.median(d[:, j].tolist())} (max {int(d[:, j].max())})")
        span = int(d[:, 7].max() - d[:, 6].min())
        print(f"[probe]   per-row medians: {', '.join(parts)}; kernel span {span} ns "
              f"(globaltimer; block duration median {statistics.median((d[:, 7] - d[:, 6]).tolist())} ns)",
              flush=True)
        if x is not inputs["constant rows"][0]:
            describe(x, kk)
            slow = torch.argsort(d[:, 1], descending=True)[:3].tolist()
            for r in slow:
                row = x[r]
                print(f"[probe]   slow row {r}: k {int(kk[r])}, bisection cycles {int(d[r, 1])}, full passes "
                      f"{int(d[r, 3])}, buffer counts {int(d[r, 4])}, min {float(row.min())}, max "
                      f"{float(row.max())}, first-chunk range [{float(row[: vocab // 8].min())}, "
                      f"{float(row[: vocab // 8].max())}], X_k {float(torch.topk(row, int(kk[r])).values[-1])}",
                      flush=True)
    # the earlier kernel on a row holding a NaN
    x, ks = cs.topk_rows(rows, vocab, seed=vocab, device=device)
    for name, fn in (("earlier", old), ("this", new)):
        assert fn(x.data_ptr(), ks.data_ptr(), out.data_ptr(), rows, vocab, 0, 1, 1, stream) == 0
        torch.cuda.synchronize()
        print(f"[probe] {name} top-k on the NaN row (k = {int(ks[8])}): keeps {int((out[8] != 0).sum())}; "
              f"the plain version keeps {int((ref.topk_mask_ref(x, ks, guard=True)[8] != 0).sum())}",
              flush=True)


def compile_libs(parent: Path, kernels: set[str], head_dim: int = 64) -> dict[str, ctypes.CDLL]:
    """What the probes in ``kernels`` at the attention's ``head_dim`` need
    of the earlier checkout's four sources, the clocked copies and the
    variants, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    pcsrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    need = lambda *names: bool(kernels & set(names))  # noqa: E731
    sources = {name: pcsrc / src for name, src, groups in (
        ("parent_topk", "topk_select.cu", ("topk", "topk_bf16")),
        ("parent_agg", "sparse_agg.cu", ("scatter", "agg", "scatter_bf16")),
        ("parent_kl", "distill_kl.cu", ("kl", "kl_bf16")),
        ("parent_attention", "flash_attention.cu", ("attention", "attention_bf16", "attention_f16")))
        if need(*groups)}
    made = {}
    if need("topk"):
        made["topk_clocks"] = topk_clocks()
    if need("topk_bf16"):
        made["topk_bf16_clocks"] = topk_bf16_clocks()
    if need("attention_bf16") and head_dim in (64, 128):
        made["attention_bf16_clocks"] = attention_bf16_clocks() if head_dim == 64 else attention_d128_clocks()
    if need("attention") and head_dim == 128:
        try:  # the earlier build's fp32 kernel at D 128 with its splits inside the loops (before PR 32)
            made["earlier_f32_clocks"] = attention_f32_split_clocks(pcsrc / "flash_attention.cu")
            made["earlier_f32_nosplit"] = attention_f32_nosplit(pcsrc / "flash_attention.cu")
        except SystemExit as e:
            print(f"[probe] no clocked copy of the earlier fp32 attention ({e})", flush=True)
    if need("scatter_bf16"):
        made["earlier_scatter_clocks"] = scatter_loader_clocks(pcsrc / "sparse_agg.cu")
        made["this_scatter_clocks"] = scatter_bf16_clocks()
    if need("kl_bf16"):
        try:  # the earlier build's upcasting loader: a checkout from before PR 18 has it
            made["earlier_kl_clocks"] = kl_loader_clocks(pcsrc / "distill_kl.cu")
            made["earlier_kl_loads"] = kl_loader_clocks(pcsrc / "distill_kl.cu", loads_only=True)
        except SystemExit as e:
            print(f"[probe] no clocked copy of the earlier KL ({e})", flush=True)
        made["this_kl_clocks"] = kl_bf16_clocks()
        made["this_kl_loads"] = kl_bf16_clocks(loads_only=True)
    if need("attention") and head_dim == 128:
        made["this_f32_clocks"] = attention_f32_d128_clocks()
    made.update({name: substituted(CSRC / src, pairs) for name, (src, pairs) in VARIANTS.items()
                 if need(VARIANT_OF[name]) and variant_at(name, head_dim)})
    for name, text in made.items():
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(text)
    jobs = {name: (OUT / f"lib{name}.so", subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for name, src in sources.items()}
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_probe: nvcc failed on {name}\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        if name.startswith("parent_") or name in VARIANTS:  # registers and spills, beside this build's
            print(f"[probe] {name} ptxas -v: {' | '.join(cs.ptxas_report(log, PTXAS_KEYS))}", flush=True)
    return libs


def sass_histogram(lib: Path, kernel: str, top: int = 24, arg: str = "") -> str:
    """The opcode mix of the kernel of ``lib`` whose name holds ``kernel``
    (a template's instance: whose mangled name also matches the regex
    ``arg``)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    # cuobjdump prints each function after a "Function : <mangled name>" line
    sections = re.split(r"\n\s*Function : ", sass)
    sass = "\n".join(sec for sec in sections[1:]
                     if re.match(rf"\S*\d{kernel}[EI]", sec) and re.search(arg, sec.split(None, 1)[0]))
    counts: dict[str, int] = {}
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    ranked = sorted(counts.items(), key=lambda kv: -kv[1])[:top]
    return f"{sum(counts.values())} instructions: " + ", ".join(f"{k} {v}" for k, v in ranked)


def kl_ab(libs, device) -> None:
    cs.check_distill_kl(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows, vocab = cs.ROWS, cs.VOCAB
    gen = torch.Generator(device=device).manual_seed(31)
    t, s = (2.0 * torch.randn((rows, vocab), generator=gen, device=device) for _ in range(2))
    out = torch.empty(rows, device=device)
    want = ref.distill_kl_ref(t, s, 2.0)
    tol = cs.kl_tolerance(t, s, 2.0, want)
    args = (t.data_ptr(), s.data_ptr(), out.data_ptr(), rows, vocab)
    new = ops._fn("distill_kl", "distill_kl_f32", 3, 2, 1)
    old = c_fn(libs["parent_kl"], "distill_kl_f32", 3, 2, 1)
    runs = {"earlier": lambda: old(*args, 0.5, stream), "this": lambda: new(*args, 0.5, stream)}
    outs = {}
    for name, fn in runs.items():
        out.fill_(float("nan"))
        assert fn() == 0, name
        torch.cuda.synchronize()
        assert bool(((out - want).abs() <= tol).all()), name
        outs[name] = out.clone()
    print(f"[probe] distill_kl: this == earlier bitwise: {torch.equal(outs['this'], outs['earlier'])}",
          flush=True)
    in_turns(f"distill_kl at ({rows}, {vocab}), T=2, warm", runs["earlier"], runs["this"])
    copies = [(t, s)] + [(t.clone(), s.clone()) for _ in range(cs.COLD_COPIES - 1)]
    cold = {name: cs.in_turn([lambda a=a, b=b, fn=fn: fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows,
                                                         vocab, 0.5, stream) for a, b in copies])
            for name, fn in (("earlier", old), ("this", new))}
    in_turns(f"distill_kl at ({rows}, {vocab}), T=2, cold (in turn over {cs.COLD_COPIES} copies)",
             cold["earlier"], cold["this"])
    launches = {name: [lambda st, a=a, b=b, fn=fn: fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, vocab,
                                                      0.5, st) for a, b in copies]
                for name, fn in (("earlier", old), ("this", new))}
    graph_turns(f"distill_kl at ({rows}, {vocab}), T=2, warm", launches["earlier"][:1], launches["this"][:1])
    graph_turns(f"distill_kl at ({rows}, {vocab}), T=2, cold", launches["earlier"], launches["this"])


# the attention's C entry point and launch-count tag for each input dtype
ATTN_SYMBOL = {torch.float32: "flash_attention_f32", cs.BF16: "flash_attention_bf16",
               cs.F16: "flash_attention_f16"}
# the element type's name in the any-D kernel's mangled instances
ANYD_TYPE = {torch.float32: "3F32", cs.BF16: "4Bf16", cs.F16: "3F16"}


def sass_functions(lib: Path, key: str) -> dict[str, list[str]]:
    """The SASS of the functions of ``lib`` whose mangled name holds
    ``key``: each instruction's text (opcode and operands), addresses and
    encodings dropped, by mangled name."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for sec in re.split(r"\n\s*Function : ", sass)[1:]:
        name = sec.split(None, 1)[0]
        if key in name:
            out[name] = [m.group(1).strip() for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", sec)]
    return out


def attention_sass_same(parent_lib: Path) -> None:
    """Whether each D = 64 and D = 128 kernel of this build's attention
    library (fp32, bf16, fp16) is the earlier build's instruction for
    instruction."""
    lib = build.build_all(["flash_attention"])["flash_attention"]
    for kernel, tags, d in (("flash_attention_kernel", ("",), 64),
                            ("flash_attention_16_kernel", ("4Bf16", "3F16"), 64),
                            ("flash_attention_f32_d128_kernel", ("",), 128),
                            ("flash_attention_16_d128_kernel", ("4Bf16", "3F16"), 128)):
        this, earlier = sass_functions(lib, kernel), sass_functions(parent_lib, kernel)
        for tag in tags:
            # this build's kernel (no D in its name: the fp32 ones are not templates, the
            # 16-bit ones are templates on the element type alone)
            mine = [body for name, body in this.items() if tag in name]
            # an earlier build's instance at d, or its kernel from before the template on D
            theirs = [body for name, body in earlier.items() if tag in name and f"Li{d}E" in name] or [
                body for name, body in earlier.items() if tag in name and "Li" not in name]
            if len(mine) != 1 or len(theirs) != 1:
                print(f"[probe] SASS {kernel}<{tag or 'f32'}>: {len(mine)} D {d} instance(s) here, "
                      f"{len(theirs)} earlier: not compared", flush=True)
                continue
            pairs = [(i, a, b) for i, (a, b) in enumerate(zip(mine[0], theirs[0])) if a != b]
            diff = len(pairs) + abs(len(mine[0]) - len(theirs[0]))
            shown = "; ".join(f"#{i}: {a} (earlier {b})" for i, a, b in pairs[:6])
            print(f"[probe] SASS {kernel}<{tag or 'f32'}, D {d}> == the earlier build's: {diff == 0} "
                  f"({len(mine[0])} / {len(theirs[0])} instructions, {diff} differ{': ' if shown else ''}"
                  f"{shown})", flush=True)


def attention_ab(libs, device, dtype: torch.dtype, d: int, shape=(8, 12, 1024), heads=None) -> dict:
    """One attention entry point at ``shape`` (B, H, S; (96, 1024, d) unless
    said) on N(0, 1) q, k, v in ``dtype``, after ``chip_smoke.py``'s checks
    of it: this build against the earlier one (outputs compared bitwise; an
    earlier build that takes only D = 64 refuses D = 128 and is left out),
    both held to the plain version (on the head-batches ``heads`` only,
    when given), timed in turns, then beside SDPA in the same dtype in
    turns.  Returns the runs and inputs for the bf16 probe's extras."""
    tag = cs.TAG[dtype]
    b, h, seq = shape
    gen = torch.Generator(device=device).manual_seed(7)
    q4, k4, v4 = (torch.randn((b, h, seq, d), generator=gen, device=device).to(dtype) for _ in range(3))
    q, k, v = (t.reshape(b * h, seq, d) for t in (q4, k4, v4))
    out = torch.empty_like(q)
    sample = list(range(b * h)) if heads is None else list(heads)
    want = torch.cat([ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in sample]) \
        if heads is not None else ref.flash_attention_ref(q, k, v)
    tol = cs.attention_tolerance(seq, v)
    timing = {} if seq <= 4096 else dict(calls=2, reps=7, warmup=1)  # calls of many ms
    args = [x.data_ptr() for x in (q, k, v, out)]
    stream = torch.cuda.current_stream(device).cuda_stream
    fns = {"this": ops._fn("flash_attention", ATTN_SYMBOL[dtype], 4, 3, 1),
           "earlier": c_fn(libs["parent_attention"], ATTN_SYMBOL[dtype], 4, 3, 1)}
    runs = {name: (lambda fn=fn: fn(*args, b * h, seq, d, d**-0.5, stream)) for name, fn in fns.items()}
    outs = {}
    for name, fn in list(runs.items()):
        out.fill_(float("nan"))
        rc = fn()
        if rc != 0 and name == "earlier":
            print(f"[probe] flash_attention{tag} earlier build at D {d}: refused (CUDA error {rc})", flush=True)
            del runs[name]
            continue
        assert rc == 0, (name, rc)
        torch.cuda.synchronize()
        err = cs.attention_err(out[sample], want, tol)
        outs[name] = out.clone()
        print(f"[probe] flash_attention{tag} {name} at ({b * h}, {seq}, {d}): max |diff| {err:.3e} "
              f"(bound {tol:.3e})", flush=True)
    if "earlier" in runs:
        print(f"[probe] flash_attention{tag} at D {d}: this == earlier bitwise: "
              f"{torch.equal(outs['this'], outs['earlier'])}", flush=True)
        if timing:  # calls of many ms: the card first brought to its power limit, then two sets of turns
            for fn in (runs["earlier"], runs["this"]):
                cs.time_ms(fn, calls=2, reps=10, warmup=1)
        with smi_clocks(f"flash_attention{tag} at ({b * h}, {seq}, {d}) in turns"):
            for _ in range(3 if timing else 1):
                in_turns(f"flash_attention{tag} at ({b * h}, {seq}, {d})", runs["earlier"], runs["this"],
                         clocks=bool(timing), **timing)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731
    t = [cs.time_ms(f, **timing) * 1e3 for f in (sdpa, runs["this"], runs["this"], sdpa)]
    print(f"[probe] flash_attention{tag} at ({b * h}, {seq}, {d}): {dtype} SDPA {t[0]:.2f} / {t[3]:.2f} us, "
          f"this {t[1]:.2f} / {t[2]:.2f} us; bound {cs.attention_bound_ms(b * h, seq, d, dtype) * 1e3:.2f} us",
          flush=True)
    lib = build.build_all(["flash_attention"])["flash_attention"]
    if d not in (64, 128):  # the any-D kernel's instance for d
        dp, chunked = (32 * -(-d // 32), 0) if d <= 256 else (256, 1)
        arg = f"{ANYD_TYPE[dtype]}Li{dp}ELb{chunked}E"
        print(f"[probe] flash_attention{tag} SASS at D {d} (flash_attention_anyd_kernel, DP {dp}"
              f"{', chunked' if chunked else ''}): {sass_histogram(lib, 'flash_attention_anyd_kernel', arg=arg)}",
              flush=True)
    elif dtype == torch.float32:
        kernel = "flash_attention_kernel" if d == 64 else "flash_attention_f32_d128_kernel"
        print(f"[probe] flash_attention (fp32) SASS at D {d}: {sass_histogram(lib, kernel)}", flush=True)
    # the inputs too: the launches hold only their addresses
    return {"runs": runs, "args": args, "out": out, "want": want, "tol": tol, "shape": (b, h, seq, d),
            "stream": stream, "inputs": (q4, k4, v4)}


def median(values) -> float:
    return statistics.median(float(v) for v in values)


def topk_bf16_ab(libs, device, real=None) -> None:
    """The bf16 top-k, this build against the earlier one in turns on normal,
    scale-0.55, constant and one-exponent-bin rows (and the bf16 fused run's
    input), with the clocked copy's phases and the plain-stores variant."""
    cs.check_topk_16(device, cs.BF16)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows, vocab = 4 * cs.ROWS, cs.VOCAB
    gen = torch.Generator(device=device).manual_seed(5)
    budgets = torch.tensor([388, 608, 342, 428], dtype=torch.int32, device=device).repeat_interleave(cs.ROWS)
    level = torch.randint(0, 128, (rows, vocab), generator=gen, device=device)
    inputs = {"normal rows": (torch.randn((rows, vocab), generator=gen, device=device), budgets),
              "rows of scale 0.55": (0.55 * torch.randn((rows, vocab), generator=gen, device=device), budgets),
              "constant rows": (torch.full((rows, vocab), 0.5, device=device), budgets),
              "one-exponent-bin rows": (1.0 + level / 128.0, budgets)}
    if real is not None:
        inputs["the bf16 fused run's input"] = real
    out = torch.empty((rows, vocab), dtype=cs.BF16, device=device)
    new = ops._fn("topk_select", "topk_mask_bf16", 3, 5)
    old = c_fn(libs["parent_topk"], "topk_mask_bf16", 3, 5)
    clk = c_fn(libs["topk_bf16_clocks"], "topk_mask_bf16", 3, 5)
    variants = {name: c_fn(libs[name], "topk_mask_bf16", 3, 5) for name in VARIANTS if name.startswith("topk")}
    libs["topk_bf16_clocks"].topk_set_prof.argtypes = [P]
    clocks = torch.zeros((rows, 8), dtype=torch.int64, device=device)
    libs["topk_bf16_clocks"].topk_set_prof(clocks.data_ptr())
    for label, (x, kk) in inputs.items():
        x = x.to(cs.BF16)
        args = (x.data_ptr(), kk.data_ptr(), out.data_ptr(), rows, vocab, 0, 1, 1, stream)
        want = ref.topk_mask_ref(x, kk, guard=True)
        for fn in (new, old, clk, *variants.values()):
            out.zero_()
            assert fn(*args) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want), label
        in_turns(f"topk_mask_dynamic.bf16 on {label}", lambda a=args: old(*a), lambda a=args: new(*a))
        times = {name: cs.time_ms(lambda fn=fn, a=args: fn(*a)) * 1e3 for name, fn in variants.items()}
        print(f"[probe]   variants: {', '.join(f'{n} {t:.2f} us' for n, t in times.items())}", flush=True)
        d = clocks.cpu()
        phases = ", ".join(f"{name} {median(d[:, j])}" for j, name in enumerate(
            ("load+high histogram", "scans+low pass", "replay", "store")))
        span = int(d[:, 7].max() - d[:, 6].min())
        starts = d[:, 6] - d[:, 6].min()
        print(f"[probe]   per-row median cycles: {phases}; kernel span {span} ns (globaltimer), block "
              f"duration median {median(d[:, 7] - d[:, 6])} ns, last block start {int(starts.max())} ns",
              flush=True)


def attention_bf16_ab(libs, device, d: int) -> None:
    """The bf16 attention at (96, 1024, d) as ``attention_ab`` probes it,
    with the clocked copy's per-warpgroup phases, the variants at that head
    dim (at D 64 one block an SM; at D 128 three Q buffers and two V
    stages) and the kernel's opcode mix."""
    cs.check_attention_16(device, cs.BF16)
    ab = attention_ab(libs, device, cs.BF16, d)
    b, h, seq, d = ab["shape"]
    args, out, stream = ab["args"], ab["out"], ab["stream"]
    runs = {"this": ab["runs"]["this"]}
    variants = [name for name in VARIANTS
                if VARIANT_OF[name] == "attention_bf16" and VARIANT_HEAD_DIM.get(name, d) == d]
    fns = {"clocked": c_fn(libs["attention_bf16_clocks"], "flash_attention_bf16", 4, 3, 1),
           **{name: c_fn(libs[name], "flash_attention_bf16", 4, 3, 1) for name in variants}}
    for name, fn in fns.items():
        runs[name] = lambda fn=fn: fn(*args, b * h, seq, d, d**-0.5, stream)
        out.fill_(float("nan"))
        assert runs[name]() == 0, name
        torch.cuda.synchronize()
        print(f"[probe] flash_attention.bf16 {name}: max |diff| {cs.within_16(out, ab['want'], ab['tol']):.3e}",
              flush=True)
    for name in variants:
        in_turns(f"flash_attention.bf16 {name} at D {d} (earlier: this build)", runs["this"], runs[name])
    if d == 64:
        prof = attention_clock_prof(libs, runs["clocked"], b * h * (seq // 128) * 2, 8)
        report_phases(d, prof, ("waiting for K/V", "Q K^T", "max and rescale", "exps, P pieces and P V"), (),
                      4, None, (6, 7))
    else:  # the persistent kernel: one block an SM, at most one a work item
        blocks = min(torch.cuda.get_device_properties(device).multi_processor_count, b * h * (seq // 128))
        prof = attention_clock_prof(libs, runs["clocked"], blocks * 2, 16)
        report_phases(d, prof, D128_TILE_PHASES, D128_ITEM_PHASES, 9, 10, (11, 12))
    lib = build.build_all(["flash_attention"])["flash_attention"]
    kernel = "flash_attention_16_kernel" if d == 64 else "flash_attention_16_d128_kernel"
    print(f"[probe] flash_attention.bf16 SASS at D {d}: "
          f"{sass_histogram(lib, kernel, arg='4Bf16E')}", flush=True)


def attention_f32_d128_ab(libs, device, ab: dict) -> None:
    """The fp32 attention at (96, 1024, 128) after ``attention_ab``: the
    clocked copies' phases (the earlier build's, whose splits run inside
    its products' loops), and the earlier kernel with its splits left out,
    in turns against it (their difference: the splits' cost)."""
    b, h, seq, d = ab["shape"]
    args, stream = ab["args"], ab["stream"]
    if "earlier_f32_clocks" in libs:
        lib = libs["earlier_f32_clocks"]
        fn = c_fn(lib, "flash_attention_f32", 4, 3, 1)
        rows = b * h * (seq // 64) * 4  # a row a warp: 64-row blocks of 4 warps
        prof = torch.zeros((rows, 16), dtype=torch.int64, device=device)
        lib.attn_f32_set_prof.argtypes = [P]
        lib.attn_f32_set_prof(prof.data_ptr())
        assert fn(*args, b * h, seq, d, d**-0.5, stream) == 0
        torch.cuda.synchronize()
        lib.attn_f32_set_prof(None)
        err = cs.attention_err(ab["out"], ab["want"], ab["tol"])
        print(f"[probe] flash_attention earlier clocked at D {d}: max |diff| {err:.3e}", flush=True)
        report_f32_phases("earlier (32-key tiles, mma.sync; a row a warp)", prof.cpu(), F32_SPLIT_PHASES)
    if "this_f32_clocks" in libs:
        lib = libs["this_f32_clocks"]
        fn = c_fn(lib, "flash_attention_f32", 4, 3, 1)
        blocks = min(torch.cuda.get_device_properties(device).multi_processor_count, b * h * (seq // 128))
        prof = torch.zeros((3 * blocks, 16), dtype=torch.int64, device=device)
        lib.attn_f32_set_prof.argtypes = [P]
        for ptr in (None, None, prof.data_ptr()):  # two unrecorded launches first
            lib.attn_f32_set_prof(ptr)
            assert fn(*args, b * h, seq, d, d**-0.5, stream) == 0
        torch.cuda.synchronize()
        lib.attn_f32_set_prof(None)
        err = cs.attention_err(ab["out"], ab["want"], ab["tol"])
        print(f"[probe] flash_attention this clocked at D {d}: max |diff| {err:.3e}", flush=True)
        p = prof.cpu()
        cons, prod = p[torch.arange(len(p)) % 3 != 2], p[2::3]
        report_f32_phases("this, a consumer warpgroup (64 rows, 64-key tiles)", cons,
                          F32_D128_TILE_PHASES, {10: F32_D128_ITEM_PHASES[0], 11: F32_D128_ITEM_PHASES[1]})
        report_f32_phases("this, the producer's first thread (a K/V tile)", prod, F32_D128_PRODUCER_PHASES[:6])
        q_loads = int(prod[:, 12].sum())
        print(f"[probe]   the producer: {F32_D128_PRODUCER_PHASES[6]}: {float(prod[:, 11].sum()) / max(q_loads, 1):.0f} "
              f"cycles a Q load ({q_loads} loads)", flush=True)
    for name in (n for n in VARIANTS if VARIANT_OF[n] == "attention" and VARIANT_HEAD_DIM.get(n) == d):
        fn = c_fn(libs[name], "flash_attention_f32", 4, 3, 1)
        launch = lambda fn=fn: fn(*args, b * h, seq, d, d**-0.5, stream)  # noqa: E731
        ab["out"].fill_(float("nan"))
        assert launch() == 0
        torch.cuda.synchronize()
        print(f"[probe] flash_attention {name}: max |diff| {cs.attention_err(ab['out'], ab['want'], ab['tol']):.3e}",
              flush=True)
        in_turns(f"flash_attention {name} at ({b * h}, {seq}, {d}) (earlier: this build)", ab["runs"]["this"], launch)
    if "earlier_f32_nosplit" in libs:
        fn = c_fn(libs["earlier_f32_nosplit"], "flash_attention_f32", 4, 3, 1)
        in_turns(f"flash_attention at ({b * h}, {seq}, {d}), the earlier kernel (earlier) against it with its "
                 "splits left out (this; wrong values)", ab["runs"]["earlier"],
                 lambda: fn(*args, b * h, seq, d, d**-0.5, stream))


def report_f32_phases(label: str, p: torch.Tensor, phases, item_phases=None, per_tile: bool = False) -> None:
    """A clocked fp32 copy's rows (``F32_STAMPS``: tiles, items, globaltimer
    start and end after the phase columns): cycles a row-tile by phase
    (``item_phases``, {column: name}: a row-item, or with ``per_tile`` a
    row-tile), the rows' items, the kernel's span."""
    p = p[p[:, F32_STAMPS[3]] != 0]
    tiles, items = int(p[:, F32_STAMPS[0]].sum()), int(p[:, F32_STAMPS[1]].sum())
    parts = ", ".join(f"{name} {float(p[:, j].sum()) / max(tiles, 1):.0f}" for j, name in enumerate(phases))
    if item_phases:
        per = tiles if per_tile else items
        parts += f"; a row-{'tile' if per_tile else 'item'}: " + ", ".join(
            f"{name} {float(p[:, j].sum()) / max(per, 1):.0f}" for j, name in item_phases.items())
    t0, t1 = F32_STAMPS[2], F32_STAMPS[3]
    print(f"[probe] flash_attention clocked, {label}: cycles a row-tile: {parts}; {tiles} row-tiles over "
          f"{items} row-items, {len(p)} rows; kernel span {int(p[:, t1].max() - p[:, t0].min())} ns, row "
          f"duration median {median(p[:, t1] - p[:, t0])} ns", flush=True)


def attention_clock_prof(libs, launch, rows: int, cols: int) -> torch.Tensor:
    """One launch of the clocked bf16 attention, ``cols`` int64 a warpgroup,
    on the host (the warpgroups that wrote a row)."""
    prof = torch.zeros((rows, cols), dtype=torch.int64, device="cuda")
    libs["attention_bf16_clocks"].attn_set_prof.argtypes = [P]
    libs["attention_bf16_clocks"].attn_set_prof(prof.data_ptr())
    assert launch() == 0
    torch.cuda.synchronize()
    libs["attention_bf16_clocks"].attn_set_prof(None)
    prof = prof.cpu()
    return prof[prof.abs().sum(dim=1) > 0]


def report_phases(d: int, p: torch.Tensor, tile_phases, item_phases, tiles_col: int, items_col, stamps) -> None:
    """The clocked copy's cycles: ``tile_phases`` (columns 0 ..) summed over
    every warpgroup, over their tiles (column ``tiles_col``); ``item_phases``
    (the next columns) over their items (column ``items_col``); the
    kernel's span and the warpgroups' durations from the globaltimer
    columns ``stamps``."""
    tiles = p[:, tiles_col].sum()
    parts = ", ".join(f"{name} {float(p[:, j].sum() / tiles):.0f}" for j, name in enumerate(tile_phases))
    if item_phases:
        items = p[:, items_col].sum()
        parts += "; cycles a warpgroup-item: " + ", ".join(
            f"{name} {float(p[:, len(tile_phases) + j].sum() / items):.0f}" for j, name in enumerate(item_phases))
        parts += f" ({int(items)} warpgroup-items)"
    t0, t1 = stamps
    print(f"[probe] flash_attention.bf16 clocked at D {d}: cycles a warpgroup-tile: {parts}; "
          f"{int(tiles)} warpgroup-tiles; kernel span {int(p[:, t1].max() - p[:, t0].min())} ns, warpgroup "
          f"duration median {median(p[:, t1] - p[:, t0])} ns, last warpgroup start "
          f"{int((p[:, t0] - p[:, t0].min()).max())} ns", flush=True)


def graph_turns(label: str, old, new) -> None:
    """``in_turns`` for the time a launch takes replayed from a CUDA graph
    (``chip_smoke.graph_ms``): ``old`` and ``new`` are lists of launches
    taking a stream."""
    t = [cs.graph_ms(f) * 1e3 for f in (old, new, new, old)]
    print(f"[probe] {label}, from a CUDA graph: earlier {t[0]:.2f} / {t[3]:.2f} us, this {t[1]:.2f} / "
          f"{t[2]:.2f} us", flush=True)


def clock_report(label: str, prof: torch.Tensor, phases) -> None:
    """Medians over the blocks of the phases' cycles (columns 0..), the
    kernel's span and the last block's start (globaltimer, columns 6-7)."""
    d = prof.cpu()
    parts = ", ".join(f"{name} {median(d[:, j])}" for j, name in enumerate(phases) if name)
    starts = d[:, 6] - d[:, 6].min()
    print(f"[probe]   {label}: per-block median cycles: {parts}; kernel span {int(d[:, 7].max() - d[:, 6].min())} "
          f"ns, block duration median {median(d[:, 7] - d[:, 6])} ns, last block start {int(starts.max())} ns",
          flush=True)


def clocked_run(lib: ctypes.CDLL, setter: str, blocks: int, launch) -> torch.Tensor:
    """One launch of a clocked copy (after two unrecorded ones) writing 8
    int64 a block."""
    prof = torch.zeros((blocks, 8), dtype=torch.int64, device="cuda")
    fn = getattr(lib, setter)
    fn.argtypes = [P]
    for ptr in (0, 0, prof.data_ptr()):
        fn(ptr)
        assert launch() == 0
    torch.cuda.synchronize()
    fn(0)
    return prof


SCATTER_PHASES = {"earlier_scatter_clocks": ("zero-fill", "index loads", "value loads", "adds", "write"),
                  "this_scatter_clocks": ("set-up", "waiting for chunks", "reading the slot",
                                          "release, adds and barriers", "", "write")}
KL_PHASES = {"earlier": ("loop", "warp merge", "cluster barrier", "merge + barrier"),
             "this": ("loop", "warp and CTA merges, store", "first CTA waiting", "final merge")}


def scatter_bf16_ab(libs, device) -> None:
    """The bf16 wire scatter (kernel 1b) at N 4, 64 rows, V 50 257, k_cap 128
    and 1024: both builds ``torch.equal`` to the plain version, in turns
    (back-to-back C calls, then from a CUDA graph), and the clocked copies'
    phases."""
    cs.check_scatter_16(device, cs.BF16)
    stream = torch.cuda.current_stream(device).cuda_stream
    fns = {"this": ops._fn("sparse_agg", "scatter_wire_sums_bf16", 5, 4),
           "earlier": c_fn(libs["parent_agg"], "scatter_wire_sums_bf16", 5, 4)}
    clocked = {name: c_fn(libs[name], "scatter_wire_sums_bf16", 5, 4)
               for name in libs if name.endswith("_scatter_clocks")}
    variants = {name: c_fn(libs[name], "scatter_wire_sums_bf16", 5, 4) for name in libs if name in VARIANTS
                and VARIANT_OF[name] == "scatter_bf16"}
    for k_cap in (128, 1024):
        wire = cs.make_wire(k_cap, seed=7, device=device, dtype=cs.BF16)
        n, rows, k = wire.values.shape
        a, b = cs.float_channels(wire, "adaptive")
        num = torch.empty((rows, cs.VOCAB), dtype=cs.BF16, device=device)
        den = torch.empty_like(num)
        want = [x.to(cs.BF16) for x in ref.scatter_wire_sums_ref(a, b, wire.indices, cs.VOCAB)]
        ptrs = [x.data_ptr() for x in (a, b, wire.indices, num, den)]
        launch = {name: (lambda st, fn=fn: fn(*ptrs, n, rows, k, cs.VOCAB, st))
                  for name, fn in {**fns, **clocked, **variants}.items()}
        for name, fn in launch.items():
            num.fill_(float("nan"))
            den.fill_(float("nan"))
            assert fn(stream) == 0, name
            torch.cuda.synchronize()
            assert torch.equal(num, want[0]) and torch.equal(den, want[1]), (name, k_cap)
        label = f"scatter_wire_sums.bf16 k_cap={k_cap}"
        print(f"[probe] {label}: {', '.join(launch)} torch.equal to the plain version", flush=True)
        in_turns(label, lambda: launch["earlier"](stream), lambda: launch["this"](stream))
        graph_turns(label, [launch["earlier"]], [launch["this"]])
        for name in variants:
            graph_turns(f"{label} {name} (earlier: this build)", [launch["this"]], [launch[name]])
        for name in clocked:
            prof = clocked_run(libs[name], "scatter_set_prof", rows * 32, lambda name=name: launch[name](stream))
            blocks = prof[:, 7] != 0
            if not bool(blocks.any()):  # an earlier build whose bf16 scatter has no fp32-body loader
                print(f"[probe] {name}: no block ran the clocked code", flush=True)
                continue
            clock_report(f"{name} ({int(blocks.sum())} blocks)", prof[blocks], SCATTER_PHASES[name])


def kl_bf16_ab(libs, device) -> None:
    """The bf16 KL (kernel 6b) at (64, 50 257), T = 2: both builds within
    the tolerance, in turns warm and cold (in turn over
    ``chip_smoke.COLD_COPIES`` copies), from a CUDA graph too, and the
    clocked copies' phases (with a copy whose loop only loads)."""
    cs.check_kl_16(device, cs.BF16)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows, vocab = cs.ROWS, cs.VOCAB
    gen = torch.Generator(device=device).manual_seed(31)
    t, s = ((2.0 * torch.randn((rows, vocab), generator=gen, device=device)).to(cs.BF16) for _ in range(2))
    out = torch.empty(rows, device=device)
    want = ref.distill_kl_ref(t, s, 2.0)
    tol = cs.kl_tolerance(t, s, 2.0, want)
    fns = {"this": ops._fn("distill_kl", "distill_kl_bf16", 3, 2, 1),
           "earlier": c_fn(libs["parent_kl"], "distill_kl_bf16", 3, 2, 1)}
    clocked = {name: c_fn(libs[name], "distill_kl_bf16", 3, 2, 1)
               for name in libs if name.endswith(("_kl_clocks", "_kl_loads"))}
    variants = {name: c_fn(libs[name], "distill_kl_bf16", 3, 2, 1) for name in libs if name in VARIANTS
                and VARIANT_OF[name] == "kl_bf16"}
    copies = [(t, s)] + [(t.clone(), s.clone()) for _ in range(cs.COLD_COPIES - 1)]
    launches = {name: [lambda st, a=a, b=b, fn=fn: fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, vocab,
                                                      0.5, st) for a, b in copies]
                for name, fn in {**fns, **clocked, **variants}.items()}
    outs = {}
    for name, ls in launches.items():
        out.fill_(float("nan"))
        assert ls[0](stream) == 0, name
        torch.cuda.synchronize()
        if not name.endswith("_loads"):
            assert bool(((out - want).abs() <= tol).all()), name
            outs[name] = out.clone()
    print(f"[probe] distill_kl.bf16: {', '.join(outs)} within tolerance; this == earlier bitwise: "
          f"{torch.equal(outs['this'], outs['earlier'])}", flush=True)
    label = f"distill_kl.bf16 at ({rows}, {vocab}), T=2"
    warm = {name: (lambda ls=ls: ls[0](stream)) for name, ls in launches.items()}
    cold = {name: cs.in_turn([lambda f=f: f(stream) for f in ls]) for name, ls in launches.items()}
    in_turns(label + ", warm", warm["earlier"], warm["this"])
    in_turns(label + f", cold (in turn over {cs.COLD_COPIES} copies)", cold["earlier"], cold["this"])
    graph_turns(label + ", warm", launches["earlier"][:1], launches["this"][:1])
    graph_turns(label + ", cold", launches["earlier"], launches["this"])
    for name in variants:
        graph_turns(f"{label}, cold, {name} (earlier: this build)", launches["this"], launches[name])
    for name in clocked:
        for temp, ls in (("warm", launches[name][:1]), ("cold", launches[name])):
            f = cs.in_turn([lambda g=g: g(stream) for g in ls])
            for _ in range(2 * len(ls)):
                f()
            prof = clocked_run(libs[name], "kl_set_prof", rows * 8, f)
            blocks = prof[:, 7] != 0
            clock_report(f"{name}, {temp} ({int(blocks.sum())} blocks)", prof[blocks],
                         KL_PHASES[name.split("_")[0]])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True, help="a checkout of the earlier commit")
    parser.add_argument("--real", action="store_true", help="also time the fused run's own input")
    names = ("topk", "scatter", "agg", "kl", "attention", "topk_bf16", "attention_bf16", "attention_f16",
             "scatter_bf16", "kl_bf16")
    parser.add_argument("--kernels", default=",".join(names),
                        help=f"comma-separated: which of {', '.join(names)} to probe")
    parser.add_argument("--head-dim", type=int, default=64,
                        help="the attention probes' head dim, any D >= 1 (64 and 128: their kernels' "
                             "clocked copies and variants too)")
    args = parser.parse_args()
    kernels = set(args.kernels.split(","))
    if not kernels <= set(names):
        raise SystemExit(f"kernel_probe: unknown kernels {sorted(kernels)}")
    device, card = cs.phase_device()
    cs.phase_build()
    libs = compile_libs(args.parent.resolve(), kernels, args.head_dim)
    if "kl" in kernels:
        kl_ab(libs, device)
    if kernels & {"attention", "attention_bf16", "attention_f16"}:
        attention_sass_same(OUT / "libparent_attention.so")
    any_d = args.head_dim not in (64, 128)  # the any-D kernel: its variants in each dtype
    if "attention" in kernels:
        cs.check_flash_attention(device)
        ab = attention_ab(libs, device, torch.float32, args.head_dim)
        if args.head_dim == 128:
            attention_f32_d128_ab(libs, device, ab)
        if any_d:
            anyd_variants_ab(libs, ab, torch.float32)
    if "attention_bf16" in kernels:
        if not any_d:
            attention_bf16_ab(libs, device, args.head_dim)
        else:
            cs.check_attention_16(device, cs.BF16)
            anyd_variants_ab(libs, attention_ab(libs, device, cs.BF16, args.head_dim), cs.BF16)
    if "attention_f16" in kernels:
        cs.check_attention_16(device, cs.F16)
        ab = attention_ab(libs, device, cs.F16, args.head_dim)
        if any_d:
            anyd_variants_ab(libs, ab, cs.F16)
    if args.head_dim == 128:  # and at yi-9b's prefill_32k shape, (32, 32 768, 128)
        for dtype, probe in ((torch.float32, "attention"), (cs.BF16, "attention_bf16"), (cs.F16, "attention_f16")):
            if probe in kernels:
                ab = attention_ab(libs, device, dtype, 128, shape=(1, 32, cs.YI_S), heads=cs.YI_HEADS)
                # the D 128 variants at 32k too
                for name in (n for n in VARIANTS if VARIANT_HEAD_DIM.get(n) == 128 and VARIANT_OF[n] == probe):
                    fn = c_fn(libs[name], ATTN_SYMBOL[dtype], 4, 3, 1)
                    in_turns(f"flash_attention{cs.TAG[dtype]} {name} at (32, {cs.YI_S}, 128) (earlier: this build)",
                             ab["runs"]["this"], lambda fn=fn: fn(*ab["args"], 32, cs.YI_S, 128, 128**-0.5,
                                                                  ab["stream"]),
                             clocks=True, calls=2, reps=7, warmup=1)
    if "topk" in kernels:
        real = cs.phase_main_path(device, "fused", False)["topk_input"] if args.real else None
        topk_ab(libs, device, real)
    if "topk_bf16" in kernels:
        real = cs.phase_main_path(device, "fused", False, bf16=True)["topk_input"] if args.real else None
        topk_bf16_ab(libs, device, real)
    if "scatter" in kernels:
        scatter_ab(libs, device)
    if "agg" in kernels:
        agg_ab(libs, device)
    if "scatter_bf16" in kernels:
        scatter_bf16_ab(libs, device)
    if "kl_bf16" in kernels:
        kl_bf16_ab(libs, device)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
