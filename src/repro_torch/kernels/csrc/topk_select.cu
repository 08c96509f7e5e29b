// Dense top-k mask by fp32 threshold bisection (paper eqs. 3-4).
//
// Replaces the two TPU kernels of src/repro/kernels/topk_select.py:
//   topk_mask_{f32,bf16,f16} (dynamic = 1) <- topk_mask_dynamic_pallas (_topk_dynamic_kernel)
//   topk_mask_{f32,bf16,f16} (dynamic = 0) <- topk_mask_pallas (_topk_kernel)
//
// What they compute, per row r of x (rows, V) fp32 with budget k[r]:
//   lo = min(x[r]), hi = max(x[r]) + 1
//   30 times: mid = 0.5 * (lo + hi); if count(x[r] >= mid) >= k[r] then
//             lo = mid else hi = mid
//   out[r, c] = x[r, c] if x[r, c] >= lo (and k[r] > 0 when dynamic) else 0
// The dynamic kernel reads one int32 budget per row, clamps it to [0, V],
// and zeroes a k = 0 row (a dropped straggler); the static
// kernel takes one k = min(k, V) for every row and has no k > 0 guard.
// Ties at the threshold are all kept.  A NaN anywhere in the row makes min
// and max NaN (as torch.amin / jnp.min do), so lo is NaN and the row comes
// out all zero.
//
// What bounds them on H100: the row must be read once and the masked row
// written once, rows*V*8 bytes (103 MB at 256 x 50257, ~31 us at
// 3.35 TB/s).  Everything else is on-chip work, which the design keeps
// small against that.
//
// Design.  The Pallas kernel holds a block of rows in VMEM and runs the 30
// passes there.  Here one block of 512 threads owns one row.
//   * The row goes to shared memory once (rows up to ~56k floats: the row
//     plus a candidate buffer within the 227 KB a block may opt into, so
//     one block an SM: 256 rows run in two waves).  One thread issues it as
//     eight TMA bulk copies (cp.async.bulk, one mbarrier each) of whole
//     16-byte granules, and the threads reduce each chunk as it lands.  V is
//     odd, so a row starts at any float phase p of its granule: the copy
//     starts at the granule below the row, element c sits at smem[p + c],
//     and the lanes of the first and last granules that belong to the
//     neighbouring rows are masked (then overwritten with NaN, which counts
//     nowhere).
//   * What decides a step.  count(x >= mid) >= k holds iff mid <= X_k, the
//     k-th largest x of the row (k >= 1).  The block keeps a candidate
//     interval [clo, chi) that holds X_k, with the exact counts
//     cnt = #{x >= clo} >= k and above = #{x >= chi} < k.  A mid <= clo
//     takes, a mid >= chi (or NaN) does not, and only a mid inside
//     (clo, chi) needs a count, which then narrows the interval:
//         count(x >= mid) = above + #{c in buffer : mid <= c < chi}
//     for any buffer that holds every x in [clo, chi).  So each mid is the
//     same rounded fp32 value as the plain version's (__fadd_rn /
//     __fmul_rn), every decision the same, and the mask bitwise the same.
//   * Bracketing X_k as the row loads.  The load is bound by device memory
//     and leaves the ALUs idle, so every thread also counts #{x >= t} at
//     three thresholds t, at mean + {1.75, 2.25, 2.75} standard deviations
//     of the first chunk: before the first step [clo, chi) is already
//     narrow, and on the main path's rows no full pass is left.  (Eight
//     thresholds made the load ALU-bound; thresholds spread over the first
//     chunk's range moved with single outliers.)  min and max are taken
//     with min.NaN / max.NaN, so a NaN needs no test of its own.
//   * Counting.  While [clo, chi) holds more than the buffer (~7.5k values
//     at V = 50257), a count is a full pass over the row (16-byte shared
//     loads, one compare a value, one __syncthreads a step).  Once it fits,
//     one pass copies it to the buffer (each thread's count of it, a scan,
//     plain stores; at the first step the counts come from the load's
//     threshold counts, taken over the same granules in the same order),
//     counts run over the buffer, and the buffer is compacted again
//     whenever the set halves.  At 1024 values warp 0 takes them into
//     registers (32 a lane, repacked to 4 and to 1 as the set shrinks; a
//     count is a ballot and a popc a register, no barrier).  With one value
//     a lane, X_k is the one of rank k - above: [clo, chi) closes on it and
//     the remaining steps need no count at all.  Constant or all-tied rows
//     never shrink the set and keep full passes.
//   * The masked row is written from shared memory with 16-byte stores
//     (lane by lane for the two edge granules, or for the whole row if out
//     sits on another phase than x).  A k = 0 row of the dynamic kernel is
//     written as zeros without reading x; a NaN anywhere makes lo NaN and
//     the row zero, as in the plain version; at k <= 0 (static) every step
//     takes.
//   * Rows too wide for shared memory (e.g. 152k vocabularies) run the same
//     code with the row read from device memory (L2) on every pass and only
//     the candidate buffer in shared memory.  Not tuned.
//   * Ties.  A tie group at X_k never leaves [clo, chi), so the candidate
//     set never shrinks below it: bf16 rows (8 significand bits) tie in
//     groups of tens to thousands near X_k.  A group larger than the
//     buffer keeps full passes; one larger than 1024 keeps block counts
//     over the buffer; one larger than 128 (or 32) keeps warp 0 counting
//     its 32 (or 4) values a lane -- each stage's exit tests the exact size
//     cnt - above against its capacity, so no buffer ever overflows, and
//     the rank step at the end reads X_k among at most 32 values, ties
//     included.  All of these are exact, only slower.
//
// bf16 rows (topk_mask_bf16), as the reference's kernels take them: the
// Pallas kernels upcast the row, bisect in fp32 and keep the values in the
// input's dtype.  The bf16 kernel below is another design, exact as well.
//   * What decides a step, again: mid <= X_k.  A bf16 row has only 65 536
//     possible values, so X_k is found exactly, by value, before any step:
//     a radix select on the 16-bit key that orders bf16 values (flip every
//     bit of a negative value, set the top bit of a positive one), over a
//     high digit of 11 bits (sign, exponent, 2 mantissa bits) and a low one
//     of 5.  The high digit's histogram is taken while the row lands; a
//     scan from the top finds the bin holding rank k; a second pass counts
//     the low digits of that bin's values and a second scan finds X_k.
//     Ties and constant rows cost what any row costs.  -0 and +0 are two
//     keys of one value; X_k's value comes out right either way.
//   * Then one thread replays the 30 steps with no count: lo = min, hi =
//     max + 1, mid = (lo + hi) * 0.5 with __fadd_rn / __fmul_rn, and
//     take = mid <= X_k (a NaN mid never takes), so lo is bitwise the plain
//     version's.  A NaN anywhere makes min and max NaN (then lo is NaN and
//     the row is zero), and the static k <= 0 takes every step.
//   * The row stays bf16 in shared memory (100.5 KB at V 50 257), loaded by
//     eight TMA bulk copies of whole 16-byte granules (8 values) with one
//     mbarrier each, from the granule below the row (element c at p + c).
//     The high digit's histogram is taken chunk by chunk as the copies
//     land, with min and max (min.NaN / max.NaN on bf16 pairs), in one
//     shared histogram of 2048 32-bit counters: the high digit of logits
//     falls into a handful of bins, yet the compiler's warp-aggregated
//     atomics (ATOMS.POPC.INC) keep one histogram as fast as copies of it
//     kept per group of lanes (measured at 256 bins; the pass waits on the
//     load, not on its atomics).  8 KB: the row, the histogram and the rest
//     fit two blocks an SM, so 256 rows run in one wave.  The second pass xors each word with the bin's raw bits, so
//     that a half below 32 is a value of the bin and its low digit; its
//     atomics are skipped by a warp vote when no lane matches (an 11-bit
//     bin holds ~1/8 of what an 8-bit one would, so most votes skip).  The
//     two edge granules, which hold values of the neighbouring rows, are
//     taken value by value outside the passes.
//   * The masked row is written from shared memory with 16-byte streaming
//     stores (st.global.cs), each value kept with its own bits where x >=
//     lo: for a bf16 x that is x >= lo rounded up to bf16, one packed bf16
//     compare a word.  Streaming stores send the row to device memory
//     during the store, not during the next launch's loads, which then run
//     faster (tools/kernel_probe.py times plain stores in turn).
//   * Rows too wide for shared memory (V 152 064: 304 KB in bf16) run the
//     same passes on the row in device memory.  Correct, not tuned.
//
// fp16 rows (topk_mask_f16) run the same kernel, topk_radix_16_kernel<T>,
// on fp16's 16-bit key: the same map (every bit of a negative value
// flipped, the top bit of a positive one set) orders fp16 values too, its
// high digit now sign, 5 exponent bits and 5 mantissa bits.  What differs is
// per type: the exact upcast of a key's value, min and max on fp16 pairs
// (min.NaN.f16x2 / max.NaN.f16x2), and lo rounded up to fp16 for the keep
// test.  Every fp16 value, subnormals included, is exact in fp32, and so is
// hi = max + 1 up to 65 504; where lo lies above 65 504, rounding it up
// gives +inf, so only +inf values are kept, as in the plain version.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (no fast math: the value math must be IEEE).
// Plain C interface, loaded through ctypes; the entry point launches on the
// given stream and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 30;          // = BISECTION_ITERS of the plain version
constexpr int kPerThread = 16;      // buffer values a thread stages to compact in place
constexpr int kCapMax = kThreads * kPerThread;
constexpr int kMinCap = 1024;       // the least buffer the shared-memory path accepts
constexpr int kLaneRegs = 32;
constexpr int kWarpCap = 32 * kLaneRegs;  // buffer size at which warp 0 takes over
constexpr int kChunks = 8;          // TMA bulk copies per row
constexpr int kGrid = 3;            // thresholds counted while the row loads
constexpr unsigned kFull = 0xffffffffu;

// The bisection (lo, hi, it) and the candidate interval [clo, chi) that
// holds X_k, the k-th largest x of the row: cnt = #{x >= clo} >= k and
// above = #{x >= chi} < k.  A step takes (lo = mid) iff count(x >= mid) >= k,
// i.e. iff mid <= X_k; only a mid inside (clo, chi) needs a count.
struct Bisect {
  float lo, hi, clo, chi;
  int cnt, above;
  int n_buf;  // values in the buffer (a superset of [clo, chi)), -1 before any
  int it;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Granule g of a row, 16 bytes of the row in shared memory or in device
// memory.
template <bool kSmem>
__device__ __forceinline__ float4 ld4(const void* base, int g) {
  if (kSmem) return reinterpret_cast<const float4*>(base)[g];
  return __ldg(reinterpret_cast<const float4*>(base) + g);
}

// Granule g of the row (row element 4g + j - p in lane j); lanes outside
// the row are set to `fill`.
template <bool kSmem>
__device__ __forceinline__ float4 granule(const void* base, int g, int G, int p,
                                          int vocab, float fill) {
  float4 v = ld4<kSmem>(base, g);
  if (g == 0 || g == G - 1) {
    const int c = 4 * g - p;
    if (c < 0 || c >= vocab) v.x = fill;
    if (c + 1 < 0 || c + 1 >= vocab) v.y = fill;
    if (c + 2 < 0 || c + 2 >= vocab) v.z = fill;
    if (c + 3 < 0 || c + 3 >= vocab) v.w = fill;
  }
  return v;
}

// Block sums of N ints; every thread gets the totals.  One barrier; the
// partials are double-buffered by `par`, which the call flips.
template <int N>
__device__ __forceinline__ void block_sum(int (&v)[N], int (*s)[4][kWarps], int& par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int t = __reduce_add_sync(kFull, v[i]);
    if (lane == 0) s[par][i][warp] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int4* q = reinterpret_cast<const int4*>(s[par][i]);
    int tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps / 4; ++w) {
      const int4 x = q[w];
      tot += x.x + x.y + x.z + x.w;
    }
    v[i] = tot;
  }
  par ^= 1;
}

// min and max that return NaN when either input is NaN (torch.amin's rule)
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Block min and max, NaN if any value is NaN; every thread gets both.
__device__ __forceinline__ void block_minmax(float& mn, float& mx, float* s_min, float* s_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    mn = min_nan(mn, __shfl_xor_sync(kFull, mn, o));
    mx = max_nan(mx, __shfl_xor_sync(kFull, mx, o));
  }
  __syncthreads();  // the previous use of s_min / s_max is over
  if (lane == 0) {
    s_min[warp] = mn;
    s_max[warp] = mx;
  }
  __syncthreads();
  mn = s_min[0];
  mx = s_max[0];
  for (int w = 1; w < kWarps; ++w) {
    mn = min_nan(mn, s_min[w]);
    mx = max_nan(mx, s_max[w]);
  }
}

// Block sums of two floats (statistics only: their order is free).
__device__ __forceinline__ float2 block_sum_f2(float2 v, float* s_a, float* s_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, o);
    v.y += __shfl_xor_sync(kFull, v.y, o);
  }
  if (lane == 0) {
    s_a[warp] = v.x;
    s_b[warp] = v.y;
  }
  __syncthreads();
  v = make_float2(0.0f, 0.0f);
  for (int w = 0; w < kWarps; ++w) {
    v.x += s_a[w];
    v.y += s_b[w];
  }
  return v;
}

// Append the flagged values (four a lane) to the buffer: ballots give each
// its place, one shared atomic per warp reserves them.  All 32 lanes call.
__device__ __forceinline__ void warp_append(float* buf, int* fill, const float (&vals)[4],
                                            unsigned flags) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  int pos[4], total = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned m = __ballot_sync(kFull, flags >> j & 1u);
    pos[j] = total + __popc(m & lt);
    total += __popc(m);
  }
  if (total == 0) return;
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(fill, total);
  base = __shfl_sync(kFull, base, 0);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (flags >> j & 1u) buf[base + pos[j]] = vals[j];
}

__device__ __forceinline__ unsigned in_flags(const float (&e)[4], float lo, float hi) {
  unsigned flags = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) flags |= (unsigned)((e[j] >= lo) & (e[j] < hi)) << j;
  return flags;
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

// The step's decision when no count is needed: false when mid lies inside
// (clo, chi); else `take` is set (a NaN mid counts 0 < k: no).
__device__ __forceinline__ bool free_step(const Bisect& s, float mid, bool& take) {
  if (mid > s.clo && mid < s.chi) return false;
  take = mid <= s.clo;
  return true;
}

// Apply a step's outcome to the bisection.
__device__ __forceinline__ void apply(Bisect& s, float mid, bool take) {
  if (take) {
    s.lo = mid;
  } else {
    s.hi = mid;
  }
  ++s.it;
}

// A counted step (cnt = count(x >= mid)) narrows the candidate interval.
__device__ __forceinline__ void narrow(Bisect& s, float mid, int cnt, int k) {
  if (cnt >= k) {
    s.clo = mid;
    s.cnt = cnt;
  } else {
    s.chi = mid;
    s.above = cnt;
  }
}

// Steps by one warp on the candidates in v (R a lane, NaN where empty),
// until the bisection ends or [clo, chi) holds at most `limit` values.
// Returns true when it ended.
template <int R>
__device__ __forceinline__ bool warp_run(Bisect& s, const float (&v)[R], int k, int limit) {
  while (s.it < kIters) {
    if (s.cnt - s.above <= limit) return false;
    const float mid = midpoint(s.lo, s.hi);
    bool take;
    if (!free_step(s, mid, take)) {
      int cnt = s.above;
#pragma unroll
      for (int j = 0; j < R; ++j) cnt += __popc(__ballot_sync(kFull, v[j] >= mid && v[j] < s.chi));
      take = cnt >= k;
      narrow(s, mid, cnt, k);
    }
    apply(s, mid, take);
  }
  return true;
}

template <int R>
__device__ __forceinline__ void warp_load(float (&v)[R], const float* buf, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = lane + 32 * j < n ? buf[lane + 32 * j] : NAN;  // NaN never counts
}

// Write the values of v in [lo, hi) to the front of the buffer.
template <int R>
__device__ __forceinline__ void warp_keep(const float (&v)[R], float lo, float hi, float* buf) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  __syncwarp();  // every lane has read the buffer
  int total = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const bool in = v[j] >= lo && v[j] < hi;
    const unsigned m = __ballot_sync(kFull, in);
    if (in) buf[total + __popc(m & lt)] = v[j];
    total += __popc(m);
  }
  __syncwarp();
}

// The remaining steps, by warp 0 alone, on at most kWarpCap buffer values
// held in registers: 32 a lane, repacked to 4 and then to 1 as the set
// shrinks.  With one candidate a lane, X_k is the one of rank k - above:
// [clo, chi) closes on it and every later step is decided without a count.
__device__ __forceinline__ void warp_steps(Bisect& s, float* buf, int k) {
  float v32[kLaneRegs];
  warp_load(v32, buf, s.n_buf);
  if (warp_run(s, v32, k, 32 * 4)) return;
  warp_keep(v32, s.clo, s.chi, buf);
  float v4[4];
  warp_load(v4, buf, s.cnt - s.above);
  if (warp_run(s, v4, k, 32)) return;
  warp_keep(v4, s.clo, s.chi, buf);
  const float mine = s.it < kIters && (threadIdx.x & 31) < s.cnt - s.above ? buf[threadIdx.x & 31]
                                                                          : NAN;
  const int kk = k - s.above;  // 1 <= kk <= cnt - above, as above < k <= cnt
  int gt = 0, ge = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float o = __shfl_sync(kFull, mine, j);
    gt += o > mine;
    ge += o >= mine;
  }
  const unsigned who = __ballot_sync(kFull, mine == mine && gt < kk && kk <= ge);
  if (who == 0) return;  // the bisection had ended
  const float xk = __shfl_sync(kFull, mine, __ffs(who) - 1);
  s.clo = xk;
  s.chi = nextafterf(xk, INFINITY);  // every mid is now <= clo or >= chi
  while (s.it < kIters) {
    const float mid = midpoint(s.lo, s.hi);
    bool take;
    free_step(s, mid, take);
    apply(s, mid, take);
  }
}

// #{x >= mid} over the row.  The shared-memory row holds NaN in its pad
// lanes, which counts nowhere; the device-memory row masks its two edge
// granules.
template <bool kSmem>
__device__ __forceinline__ int count_row(const void* row4, int G, int p, int vocab, float mid) {
  int c = 0;
#pragma unroll 4
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const float4 v = kSmem ? ld4<true>(row4, g) : granule<false>(row4, g, G, p, vocab, NAN);
    c += (v.x >= mid) + (v.y >= mid) + (v.z >= mid) + (v.w >= mid);
  }
  return c;
}

template <bool kSmem>
__device__ __forceinline__ void row_granule(const void* row4, int g, int G, int p, int vocab,
                                            float (&e)[4]) {
  const float4 v = kSmem ? ld4<true>(row4, g) : granule<false>(row4, g, G, p, vocab, NAN);
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}

// Copy every x of the row with lo <= x < hi to the buffer: each thread's
// count of them (`mine`, or a first loop when it is not known, -1), a scan
// for where each thread's run starts, and a loop that writes them there,
// over the granules in the load's order (in which `mine` was counted).
template <bool kSmem>
__device__ __forceinline__ void compact_row(const void* row4, int G, int per_chunk, int p,
                                            int vocab, float lo, float hi, int mine, float* buf,
                                            int (*s)[4][kWarps], int& par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = kSmem ? kChunks : 1, span = kSmem ? per_chunk : G;
  float e[4];
  if (mine < 0) {
    mine = 0;
    for (int c = 0; c < chunks; ++c) {
      for (int g = c * span + threadIdx.x; g < min(G, (c + 1) * span); g += kThreads) {
        row_granule<kSmem>(row4, g, G, p, vocab, e);
        mine += __popc(in_flags(e, lo, hi));
      }
    }
  }
  int incl = mine;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s[par][0][warp] = incl;
  __syncthreads();
  int at = incl - mine;
  for (int w = 0; w < warp; ++w) at += s[par][0][w];
  par ^= 1;
  for (int c = 0; c < chunks; ++c) {
    for (int g = c * span + threadIdx.x; g < min(G, (c + 1) * span); g += kThreads) {
      row_granule<kSmem>(row4, g, G, p, vocab, e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e[j] >= lo && e[j] < hi) buf[at++] = e[j];
      }
    }
  }
  __syncthreads();  // the buffer is complete before anyone counts on it
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
    topk_mask_kernel(const float* __restrict__ x, const int32_t* __restrict__ ks,
                     float* __restrict__ out, int vocab, int k_static, int dynamic,
                     int cap) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ __align__(8) unsigned long long s_bar[kChunks];
  __shared__ float s_min[kWarps], s_max[kWarps];
  __shared__ __align__(16) int s_red[2][4][kWarps];
  __shared__ int s_fill;
  __shared__ Bisect s_state;

  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xr = x + (size_t)r * vocab;
  float* outr = out + (size_t)r * vocab;
  const int p = (int)(((uintptr_t)xr / sizeof(float)) & 3);  // the row's phase in its granule
  const int G = (p + vocab + 3) >> 2;              // granules covering the row
  const int g_max = (vocab + 6) >> 2;              // ... at the worst phase
  float* row_s = dyn;
  float* buf = kSmem ? dyn + 4 * g_max : dyn;
  const void* row4 = kSmem ? static_cast<const void*>(row_s) : static_cast<const void*>(xr - p);

  const int k = dynamic ? min(max(ks[r], 0), vocab) : k_static;
  const bool live = !dynamic || k > 0;
  const int q = (int)(((uintptr_t)outr / sizeof(float)) & 3);

  if (!live) {  // a dropped client's row: zeros, x never read
    const int Go = (q + vocab + 3) >> 2;
    for (int g = threadIdx.x; g < Go; g += kThreads) {
      if (g == 0 || g == Go - 1) {
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * g + j - q;
          if (c >= 0 && c < vocab) outr[c] = 0.0f;
        }
      } else {
        reinterpret_cast<float4*>(outr - q)[g] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // -- load (shared-memory path), min / max / NaN, threshold counts ---------
  const int per_chunk = (G + kChunks - 1) / kChunks;
  if (kSmem && threadIdx.x == 0) {
    for (int c = 0; c < kChunks; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&s_bar[c])), "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x == 0) s_fill = 0;
  __syncthreads();
  if (kSmem) {
    if (threadIdx.x == 0) {
      const float* src = xr - p;
      for (int c = 0; c < kChunks; ++c) {
        const int g0 = c * per_chunk, g1 = min(G, g0 + per_chunk);
        if (g1 <= g0) break;
        const uint32_t bytes = (uint32_t)(g1 - g0) * 16u, bar = smem_u32(&s_bar[c]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            ::"r"(smem_u32(row_s + 4 * g0)), "l"(src + 4 * g0), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
  }
  // The thresholds, at mean + {1.75, 2.25, 2.75} standard deviations of
  // the first chunk (the paper's budgets, 0.5-2 % of the vocabulary, put X_k
  // near mean + 2.3 sd on logits close to normal): their counts bracket X_k
  // before the first step.  Any thresholds are exact; good ones save full
  // passes.  (Thresholds spread over the chunk's range moved with a single
  // outlier and missed X_k on some rows.)
  float t[kGrid];
  {
    float sum = 0.0f, sq = 0.0f;
    if (kSmem) mbar_wait(smem_u32(&s_bar[0]), 0);
    for (int g = threadIdx.x; g < min(G, per_chunk); g += kThreads) {
      const float4 a = granule<kSmem>(row4, g, G, p, vocab, 0.0f);
      sum += (a.x + a.y) + (a.z + a.w);
      sq += (a.x * a.x + a.y * a.y) + (a.z * a.z + a.w * a.w);
    }
    float2 m = block_sum_f2(make_float2(sum, sq), s_min, s_max);
    const float n = (float)min(vocab, 4 * per_chunk - p);
    const float mean = m.x / n, sd = sqrtf(fmaxf(m.y / n - mean * mean, 0.0f));
    const float at[kGrid] = {1.75f, 2.25f, 2.75f};
#pragma unroll
    for (int i = 0; i < kGrid; ++i) {
      t[i] = mean + at[i] * sd;
      if (!isfinite(t[i])) t[i] = INFINITY;
    }
  }
  float lmin = INFINITY, lmax = -INFINITY;
  int gc[kGrid] = {}, mine = 0;  // this thread's counts at the thresholds, and of its values
  for (int c = 0; c < (kSmem ? kChunks : 1); ++c) {
    const int g0 = kSmem ? c * per_chunk : 0, g1 = kSmem ? min(G, g0 + per_chunk) : G;
    if (g1 <= g0) break;
    if (kSmem && c > 0) mbar_wait(smem_u32(&s_bar[c]), 0);
    for (int g = g0 + threadIdx.x; g < g1; g += kThreads) {
      const float4 a = granule<kSmem>(row4, g, G, p, vocab, NAN);  // pads: NaN, counted nowhere
      float4 lo4 = a, hi4 = a;
      if (g == 0 || g == G - 1) {  // the pads must not reach min and max
        lo4 = granule<kSmem>(row4, g, G, p, vocab, INFINITY);
        hi4 = granule<kSmem>(row4, g, G, p, vocab, -INFINITY);
        for (int j = 0; j < 4; ++j) mine += (4 * g + j - p >= 0) & (4 * g + j - p < vocab);
      } else {
        mine += 4;
      }
      lmin = min_nan(lmin, min_nan(min_nan(lo4.x, lo4.y), min_nan(lo4.z, lo4.w)));
      lmax = max_nan(lmax, max_nan(max_nan(hi4.x, hi4.y), max_nan(hi4.z, hi4.w)));
#pragma unroll
      for (int i = 0; i < kGrid; ++i)
        gc[i] += (a.x >= t[i]) + (a.y >= t[i]) + (a.z >= t[i]) + (a.w >= t[i]);
    }
  }
  if (kSmem && threadIdx.x == 0) {  // pad lanes (the neighbours' values) count nowhere
    for (int i = 0; i < p; ++i) row_s[i] = NAN;
    for (int i = p + vocab; i < 4 * G; ++i) row_s[i] = NAN;
  }
  int gc_mine[kGrid];
#pragma unroll
  for (int i = 0; i < kGrid; ++i) gc_mine[i] = gc[i];
  float mn = lmin, mx = lmax;
  block_minmax(mn, mx, s_min, s_max);
  const bool any_nan = mn != mn;
  int par = 0;
  block_sum(gc, s_red, par);

  // -- bisection -------------------------------------------------------------
  Bisect s;
  s.lo = mn;
  s.hi = __fadd_rn(mx, 1.0f);
  s.it = 0;
  if (any_nan) {  // min and max are NaN, as in the plain version: lo is NaN
    s.lo = NAN;
  } else if (k <= 0) {  // every count passes (the static kernel at k = 0)
    for (; s.it < kIters; ++s.it) s.lo = midpoint(s.lo, s.hi);
  } else {
    s.clo = mn;
    s.cnt = vocab;
    s.chi = s.hi;  // max + 1: nothing is above it, unless it rounds down to max
    s.above = 0;
    // this thread's share of [clo, chi), while those are mn / a threshold /
    // max + 1: the first compaction then needs no counting loop
    int f_lo = mine, f_hi = 0;
    bool f_known = true;
    if (!(s.hi > mx)) {  // then take +inf, and count what sits there
      f_known = false;
      int c[1] = {count_row<kSmem>(row4, G, p, vocab, INFINITY)};
      block_sum(c, s_red, par);
      s.chi = INFINITY;
      s.above = c[0];
      if (c[0] >= k) {  // X_k = +inf: every step but a NaN mid takes
        s.clo = INFINITY;
        s.cnt = c[0];
      }
    }
#pragma unroll
    for (int i = 0; i < kGrid; ++i) {
      if (gc[i] >= k && t[i] > s.clo) {
        s.clo = t[i];
        s.cnt = gc[i];
        f_lo = gc_mine[i];
      }
      if (gc[i] < k && t[i] < s.chi) {
        s.chi = t[i];
        s.above = gc[i];
        f_hi = gc_mine[i];
      }
    }
    s.n_buf = -1;
    while (s.it < kIters) {
      if (s.n_buf >= 0 && s.n_buf <= kWarpCap) {  // warp 0 takes the rest
        if (warp == 0) {
          warp_steps(s, buf, k);
          if (lane == 0) s_state = s;
        }
        __syncthreads();
        s = s_state;
        break;
      }
      const float mid = midpoint(s.lo, s.hi);
      bool take;
      if (!free_step(s, mid, take)) {
        const int size = s.cnt - s.above;
        if (s.n_buf < 0 && size <= cap) {
          compact_row<kSmem>(row4, G, per_chunk, p, vocab, s.clo, s.chi,
                                f_known ? f_lo - f_hi : -1, buf, s_red, par);
          s.n_buf = size;
        }
        int c[1];
        float e[kPerThread];
        if (s.n_buf < 0) {  // a full pass
          c[0] = count_row<kSmem>(row4, G, p, vocab, mid);
          block_sum(c, s_red, par);
        } else {  // a count over the buffer
          c[0] = 0;
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) {
            const int i = threadIdx.x + j * kThreads;
            e[j] = i < s.n_buf ? buf[i] : NAN;
            c[0] += (e[j] >= mid) & (e[j] < s.chi);
          }
          block_sum(c, s_red, par);  // every read of the buffer is behind its barrier
          c[0] += s.above;
        }
        take = c[0] >= k;
        narrow(s, mid, c[0], k);
        f_known = false;
        const int n = s.cnt - s.above;
        if (s.n_buf >= 0 && (2 * n <= s.n_buf || (n <= kWarpCap && s.n_buf > kWarpCap))) {
#pragma unroll
          for (int j = 0; j < kPerThread; j += 4) {
            const float v4[4] = {e[j], e[j + 1], e[j + 2], e[j + 3]};
            warp_append(buf, &s_fill, v4, in_flags(v4, s.clo, s.chi));
          }
          __syncthreads();
          s.n_buf = n;
          if (threadIdx.x == 0) s_fill = 0;
        }
      }
      apply(s, mid, take);
    }
  }

  // -- the masked row ----------------------------------------------------------
  const float lo = s.lo;  // NaN keeps nothing
  if (q == p) {
    for (int g = threadIdx.x; g < G; g += kThreads) {
      const float4 v = ld4<kSmem>(row4, g);
      float4 m;
      m.x = v.x >= lo ? v.x : 0.0f;
      m.y = v.y >= lo ? v.y : 0.0f;
      m.z = v.z >= lo ? v.z : 0.0f;
      m.w = v.w >= lo ? v.w : 0.0f;
      if (g == 0 || g == G - 1) {
        const float e[4] = {m.x, m.y, m.z, m.w};
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * g + j - p;
          if (c >= 0 && c < vocab) outr[c] = e[j];
        }
      } else {
        reinterpret_cast<float4*>(outr - q)[g] = m;
      }
    }
  } else {  // out on another phase than x: element by element
    const float* row = kSmem ? row_s + p : xr;
    for (int c = threadIdx.x; c < vocab; c += kThreads) {
      const float v = row[c];
      outr[c] = v >= lo ? v : 0.0f;
    }
  }
}


// -- 16-bit rows: an exact radix select of X_k, then the bisection replayed --

constexpr int kLowBits = 5;                    // the key's low digit: 5 bits
constexpr int kHighBins = 1 << (16 - kLowBits);  // its high digit: 11 bits, 2048 bins
constexpr int kLowBins = 1 << kLowBits;

// Two bf16 or fp16 values (a 32-bit word) to their 16-bit keys in value
// order: a negative value's bits all flipped, a positive value's top bit set.
__device__ __forceinline__ uint32_t keys2(uint32_t w) {
  uint32_t neg;  // 0xffff in each half that holds a negative value (prmt's sign replication)
  asm("prmt.b32 %0, %1, %2, 0xbb99;" : "=r"(neg) : "r"(w), "r"(0u));
  return w ^ (neg | 0x80008000u);
}

// What the 16-bit kernel needs of its element type: the exact fp32 value
// of raw bits; min and max of two packed pairs, NaN when either is NaN
// (torch.amin's rule); +inf and -inf in both halves; a value rounded up to
// the type in both halves; and the shift that takes 1.0's bits (the packed
// compare's true) to bit 0.
template <class T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static constexpr uint32_t kInf2 = 0x7f807f80u, kNegInf2 = 0xff80ff80u;
  static constexpr int kOneShift = 7;  // 1.0 is 0x3f80
  static __device__ __forceinline__ float value(uint32_t bits) { return __uint_as_float(bits << 16); }
  static __device__ __forceinline__ uint32_t min2_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t max2_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ T2 up2(float x) { return __bfloat162bfloat162(__float2bfloat16_ru(x)); }
};

template <>
struct Half16<__half> {
  using T2 = __half2;
  static constexpr uint32_t kInf2 = 0x7c007c00u, kNegInf2 = 0xfc00fc00u;
  static constexpr int kOneShift = 10;  // 1.0 is 0x3c00
  static __device__ __forceinline__ float value(uint32_t bits) {
    return __half2float(__ushort_as_half((unsigned short)bits));
  }
  static __device__ __forceinline__ uint32_t min2_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("min.NaN.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t max2_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ T2 up2(float x) { return __half2half2(__float2half_ru(x)); }
};

// The value of a 16-bit key, exact in fp32.
template <class T>
__device__ __forceinline__ float key_value(uint32_t key) {
  return Half16<T>::value(key ^ ((key & 0x8000u) ? 0x8000u : 0xffffu));
}

// Both values of a word kept where x >= lo, with their own bits, else +0;
// lo2 holds lo rounded up to T in both halves: for a T x, x >= lo iff x >=
// lo rounded toward +inf (a NaN lo compares false, as in fp32).  One
// packed compare a word.
template <class T>
__device__ __forceinline__ uint32_t keep2(uint32_t w, typename Half16<T>::T2 lo2) {
  using T2 = typename Half16<T>::T2;
  const T2 ge = __hge2(*reinterpret_cast<const T2*>(&w), lo2);
  const uint32_t one = *reinterpret_cast<const uint32_t*>(&ge);  // 1.0 or 0 a half
  return w & (((one >> Half16<T>::kOneShift) & 0x00010001u) * 0xffffu);
}

template <bool kSmem>
__device__ __forceinline__ uint4 granule16(const uint4* row, int g) {
  return kSmem ? row[g] : __ldg(row + g);
}

// Value j (0..7) of a granule's four words: its raw 16 bits.
__device__ __forceinline__ uint32_t bits_at(const uint4& v, int j) {
  const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return (w >> ((j & 1) << 4)) & 0xffffu;
}

// The bin d of a kN-bin histogram that holds rank kk from the top:
// above = #{in bins > d} < kk <= above + count(d).  Thread t takes kPer bins
// from the top (bins kN - 1 - kPer t ...), the threads scan their sums, and
// the one whose bins hold rank kk walks them; (d, above) land in sel.  Every
// thread calls it; 1 <= kk <= the histogram's total.
template <int kN>
__device__ void select_bin(const uint32_t* hist, int kk, int* warp_tot, int* sel) {
  constexpr int kPer = kN >= kThreads ? kN / kThreads : 1;
  constexpr int kUsed = kN / kPer;  // threads that take part: whole warps
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int top = kN - 1 - kPer * t;
  int cnt = 0, incl = 0;
  if (t < kUsed) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) cnt += (int)hist[top - i];
    incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_tot[warp] = incl;
  }
  __syncthreads();
  if (t < kUsed) {
    for (int w = 0; w < warp; ++w) incl += warp_tot[w];
    int above = incl - cnt;
    if (above < kk && kk <= incl) {
      for (int i = 0; i < kPer; ++i) {
        const int c = (int)hist[top - i];
        if (kk <= above + c) {
          sel[0] = top - i;
          sel[1] = above;
          break;
        }
        above += c;
      }
    }
  }
  __syncthreads();
}

// One block a 16-bit row (T: bf16 or fp16): the row in shared memory
// (kSmem) or read from device memory on each pass.  Same contract as
// topk_mask_kernel.  The granules 0 and G - 1, which hold values of the
// neighbouring rows, are taken value by value by threads 0 and 32, outside
// the passes' loops.
template <class T, bool kSmem>
__global__ void __launch_bounds__(kThreads, 2)
    topk_radix_16_kernel(const T* __restrict__ x, const int32_t* __restrict__ ks,
                         T* __restrict__ out, int vocab, int k_static, int dynamic) {
  using H = Half16<T>;
  extern __shared__ __align__(16) uint4 row_s[];
  __shared__ __align__(8) unsigned long long s_bar[kChunks];
  __shared__ uint32_t s_hist[kHighBins];
  __shared__ int s_warp[kWarps];
  __shared__ float s_min[kWarps], s_max[kWarps];
  __shared__ int s_sel[2];
  __shared__ float s_lo;

  const int tid = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * vocab;
  T* outr = out + (size_t)blockIdx.x * vocab;
  uint16_t* o16 = reinterpret_cast<uint16_t*>(outr);
  const int p = (int)(((uintptr_t)xr >> 1) & 7);  // the row's phase in its 16-byte granule
  const int q = (int)(((uintptr_t)outr >> 1) & 7);
  const int G = (p + vocab + 7) >> 3;  // granules covering the row
  const uint4* src = reinterpret_cast<const uint4*>(xr - p);
  const int k = dynamic ? min(max(ks[blockIdx.x], 0), vocab) : k_static;
  // this thread's edge granule (0 or G - 1), or -1
  const int edge = tid == 0 ? 0 : (tid == 32 && G > 1) ? G - 1 : -1;

  if (dynamic && k == 0) {  // a dropped client's row: zeros, x never read
    const int Go = (q + vocab + 7) >> 3;
    for (int g = tid; g < Go; g += kThreads) {
      if (g == 0 || g == Go - 1) {
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * g + j - q;
          if (c >= 0 && c < vocab) o16[c] = 0;
        }
      } else {
        reinterpret_cast<uint4*>(outr - q)[g] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  // -- load (shared-memory path), min / max, the high digit's histogram ------
  const int per_chunk = (G + kChunks - 1) / kChunks;
  for (int i = tid; i < kHighBins; i += kThreads) s_hist[i] = 0u;
  if (kSmem && tid == 0) {
    for (int c = 0; c < kChunks; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&s_bar[c])), "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kSmem && tid == 0) {
    for (int c = 0; c < kChunks; ++c) {
      const int g0 = c * per_chunk, g1 = min(G, g0 + per_chunk);
      if (g1 <= g0) break;
      const uint32_t bytes = (uint32_t)(g1 - g0) * 16u, bar = smem_u32(&s_bar[c]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(row_s + g0)), "l"(src + g0), "r"(bytes), "r"(bar)
          : "memory");
    }
  }
  const uint4* row = kSmem ? row_s : src;
  uint32_t vmin = H::kInf2, vmax = H::kNegInf2;  // two values a word: +inf, -inf
  for (int c = 0; c < (kSmem ? kChunks : 1); ++c) {
    const int g0 = kSmem ? c * per_chunk : 0, g1 = kSmem ? min(G, g0 + per_chunk) : G;
    if (g1 <= g0) break;
    if (kSmem) mbar_wait(smem_u32(&s_bar[c]), 0);
    for (int g = g0 + tid; g < g1; g += kThreads) {
      if (g == 0 || g == G - 1) continue;  // the edge granules: below
      const uint4 v = granule16<kSmem>(row, g);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vmin = H::min2_nan(vmin, w[j]);
        vmax = H::max2_nan(vmax, w[j]);
        const uint32_t kw = keys2(w[j]);
        atomicAdd(&s_hist[(kw & 0xffffu) >> kLowBits], 1u);
        atomicAdd(&s_hist[kw >> (16 + kLowBits)], 1u);
      }
    }
  }
  if (edge >= 0) {  // the edge granules, value by value
    const uint4 v = granule16<kSmem>(row, edge);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * edge + j - p;
      if (col < 0 || col >= vocab) continue;
      const uint32_t b = bits_at(v, j);
      vmin = H::min2_nan(vmin, b * 0x10001u);
      vmax = H::max2_nan(vmax, b * 0x10001u);
      atomicAdd(&s_hist[(keys2(b) & 0xffffu) >> kLowBits], 1u);
    }
  }
  float mn = min_nan(H::value(vmin & 0xffffu), H::value(vmin >> 16));
  float mx = max_nan(H::value(vmax & 0xffffu), H::value(vmax >> 16));
  block_minmax(mn, mx, s_min, s_max);  // its barriers also close the histogram
  const bool any_nan = mn != mn;

  // -- X_k: the bin of the high digit holding rank k, then the low digit ------
  float xk = 0.0f;
  if (!any_nan && k > 0) {
    select_bin<kHighBins>(s_hist, k, s_warp, s_sel);
    const uint32_t high = (uint32_t)s_sel[0];
    const int above = s_sel[1];
    if (tid < kLowBins) s_hist[tid] = 0u;
    __syncthreads();
    // w ^ m leaves a half below 2^kLowBits iff its raw bits above the low
    // digit are the bin's (a positive key: the top bit flipped; a negative
    // one: every bit), and then that half is its key's low digit
    const bool pos = high >= (uint32_t)kHighBins / 2;
    const uint32_t raw_high = high ^ (pos ? (uint32_t)kHighBins / 2 : (uint32_t)kHighBins - 1);
    const uint32_t m = ((raw_high << kLowBits) | (pos ? 0u : kLowBins - 1u)) * 0x00010001u;
    for (int g = 1 + tid; g < G - 1; g += kThreads) {
      const uint4 v = granule16<kSmem>(row, g);
      const uint32_t w[4] = {v.x ^ m, v.y ^ m, v.z ^ m, v.w ^ m};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the bin holds ~1/8 of what an 8-bit digit's would: most warps skip
        const bool m0 = (w[j] & (0xffffu ^ (kLowBins - 1u))) == 0u, m1 = w[j] < (kLowBins << 16);
        if (__any_sync(__activemask(), m0 || m1)) {
          if (m0) atomicAdd(&s_hist[w[j] & (kLowBins - 1u)], 1u);
          if (m1) atomicAdd(&s_hist[w[j] >> 16], 1u);
        }
      }
    }
    if (edge >= 0) {
      const uint4 v = granule16<kSmem>(row, edge);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * edge + j - p;
        const uint32_t b = bits_at(v, j) ^ (m & 0xffffu);
        if (col >= 0 && col < vocab && b < (uint32_t)kLowBins) atomicAdd(&s_hist[b], 1u);
      }
    }
    __syncthreads();
    select_bin<kLowBins>(s_hist, k - above, s_warp, s_sel);
    xk = key_value<T>((high << kLowBits) | (uint32_t)s_sel[0]);
  }

  // -- the 30 steps, replayed: count(x >= mid) >= k iff mid <= X_k -----------
  if (tid == 0) {
    float lo = mn, hi = __fadd_rn(mx, 1.0f);  // NaN on a row holding a NaN, as in the plain version
    if (!any_nan) {
      for (int it = 0; it < kIters; ++it) {
        const float mid = midpoint(lo, hi);
        if (k <= 0 || mid <= xk) {  // the static k <= 0 takes every step; a NaN mid, never
          lo = mid;
        } else {
          hi = mid;
        }
      }
    }
    s_lo = lo;
  }
  __syncthreads();
  // lo rounded up to T, in both halves; NaN keeps nothing
  const typename H::T2 lo2 = H::up2(s_lo);

  // -- the kept values, written back in T ----------------------------------------
  if (q == p) {
    for (int g = 1 + tid; g < G - 1; g += kThreads) {
      const uint4 v = granule16<kSmem>(row, g);
      // streaming stores: the masked row leaves the L2 for device memory now, not
      // during the next launch's loads
      __stcs(reinterpret_cast<uint4*>(outr - q) + g,
             make_uint4(keep2<T>(v.x, lo2), keep2<T>(v.y, lo2), keep2<T>(v.z, lo2),
                        keep2<T>(v.w, lo2)));
    }
    if (edge >= 0) {
      const uint4 v = granule16<kSmem>(row, edge);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * edge + j - p;
        if (col >= 0 && col < vocab) o16[col] = (uint16_t)keep2<T>(bits_at(v, j), lo2);
      }
    }
  } else {  // out on another phase than x: value by value
    const uint16_t* x16 = kSmem ? reinterpret_cast<const uint16_t*>(row_s) + p
                                : reinterpret_cast<const uint16_t*>(xr);
    for (int c = tid; c < vocab; c += kThreads) o16[c] = (uint16_t)keep2<T>(x16[c], lo2);
  }
}

// The row dtypes' codes: the kernel a code launches.
enum Dtype { kF32 = 0, kBf16 = 1, kF16 = 2 };

// The shared-memory paths' static shared memory and what a block may opt
// into, per kernel (a Dtype) and device, looked up once (the queries cost
// host time per launch).
struct SmemLimits {
  int stat, optin, granted;
};

int smem_limits(int dtype, SmemLimits*& out) {
  static SmemLimits lim[3][64];
  static bool known[3][64] = {};
  if (dtype < kF32 || dtype > kF16) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!known[dtype][dev]) {
    cudaFuncAttributes attr;
    err = dtype == kBf16  ? cudaFuncGetAttributes(&attr, topk_radix_16_kernel<__nv_bfloat16, true>)
          : dtype == kF16 ? cudaFuncGetAttributes(&attr, topk_radix_16_kernel<__half, true>)
                          : cudaFuncGetAttributes(&attr, topk_mask_kernel<true>);
    if (err != cudaSuccess) return (int)err;
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    lim[dtype][dev] = SmemLimits{(int)attr.sharedSizeBytes, optin, 0};
    known[dtype][dev] = true;
  }
  out = &lim[dtype][dev];
  return (int)cudaSuccess;
}

int launch_topk(const float* x, const int32_t* ks, float* out, int rows, int vocab, int k_static,
                int dynamic, int use_smem, void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_smem) {
    SmemLimits* lim = nullptr;
    const int lerr = smem_limits(kF32, lim);
    if (lerr != (int)cudaSuccess) return lerr;
    const int row_bytes = 16 * ((vocab + 6) >> 2);
    int cap = (lim->optin - lim->stat - row_bytes) / (int)sizeof(float);
    cap = min(cap & ~3, kCapMax);
    if (cap < kMinCap) return (int)cudaErrorInvalidValue;
    const int bytes = row_bytes + cap * (int)sizeof(float);
    if (lim->granted < bytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          topk_mask_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
      lim->granted = bytes;
    }
    topk_mask_kernel<true><<<rows, kThreads, bytes, s>>>(x, ks, out, vocab, k_static, dynamic,
                                                          cap);
  } else {
    const int bytes = kCapMax * (int)sizeof(float);
    topk_mask_kernel<false><<<rows, kThreads, bytes, s>>>(x, ks, out, vocab, k_static, dynamic,
                                                           kCapMax);
  }
  return (int)cudaGetLastError();
}

template <class T>
int launch_topk16(const T* x, const int32_t* ks, T* out, int rows, int vocab, int k_static,
                  int dynamic, int use_smem, void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_smem) {
    SmemLimits* lim = nullptr;
    const int lerr = smem_limits(std::is_same<T, __half>::value ? kF16 : kBf16, lim);
    if (lerr != (int)cudaSuccess) return lerr;
    const int bytes = 16 * ((vocab + 14) >> 3);  // the row's granules at its worst phase
    if (bytes > lim->optin - lim->stat) return (int)cudaErrorInvalidValue;
    if (lim->granted < bytes) {
      cudaError_t err = cudaFuncSetAttribute(topk_radix_16_kernel<T, true>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err == cudaSuccess)  // all of the SM's shared memory, for two blocks an SM
        err = cudaFuncSetAttribute(topk_radix_16_kernel<T, true>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout, 100);
      if (err != cudaSuccess) return (int)err;
      lim->granted = bytes;
    }
    topk_radix_16_kernel<T, true><<<rows, kThreads, bytes, s>>>(x, ks, out, vocab, k_static,
                                                                 dynamic);
  } else {
    topk_radix_16_kernel<T, false><<<rows, kThreads, 0, s>>>(x, ks, out, vocab, k_static, dynamic);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest V the shared-memory path takes, per row dtype (0: fp32, 1: bf16,
// 2: fp16).  fp32: the row (at its worst 16-byte phase) and a candidate
// buffer of at least kMinCap values; bf16 and fp16: the row alone (at its
// worst phase); each beside its kernel's static shared memory, within what
// a block may opt into.
int topk_mask_smem_max_vocab(int dtype) {
  SmemLimits* lim = nullptr;
  const int err = smem_limits(dtype, lim);
  if (err != (int)cudaSuccess) return -err;
  if (dtype != kF32) return 8 * ((lim->optin - lim->stat) / 16) - 14;
  const int floats = (lim->optin - lim->stat) / (int)sizeof(float) - kMinCap;
  return (floats / 4) * 4 - 6;
}

// x, out: (rows, vocab) fp32; ks: (rows,) int32 budgets (read only when
// dynamic); k_static: the static kernel's min(k, vocab).
int topk_mask_f32(const float* x, const int32_t* ks, float* out, int rows,
                  int vocab, int k_static, int dynamic, int use_smem,
                  void* stream) {
  return launch_topk(x, ks, out, rows, vocab, k_static, dynamic, use_smem, stream);
}

// x, out: (rows, vocab) bf16; the rest as topk_mask_f32.
int topk_mask_bf16(const __nv_bfloat16* x, const int32_t* ks, __nv_bfloat16* out, int rows,
                   int vocab, int k_static, int dynamic, int use_smem, void* stream) {
  return launch_topk16(x, ks, out, rows, vocab, k_static, dynamic, use_smem, stream);
}

// x, out: (rows, vocab) fp16; the rest as topk_mask_f32.
int topk_mask_f16(const __half* x, const int32_t* ks, __half* out, int rows, int vocab,
                  int k_static, int dynamic, int use_smem, void* stream) {
  return launch_topk16(x, ks, out, rows, vocab, k_static, dynamic, use_smem, stream);
}

}  // extern "C"
