// Fused temperature-softmax KL divergence per row (paper eq. 9):
//   out[r] = KL( softmax(t[r,:]/T) || softmax(s[r,:]/T) )
//
// Replaces the TPU kernel src/repro/kernels/distill_kl.py
//   distill_kl_{f32,bf16,f16} <- distill_kl_pallas (_kl_kernel)
//
// bf16 and fp16 rows (distill_kl_bf16, distill_kl_f16), as the reference's
// kernel takes them (it upcasts each tile), have a kernel of their own,
// distill_kl_16_kernel<T> (below; only the exact upcast of a packed pair
// and the pair's maximum differ between the two types); the result is fp32.
//
// Both compute the KL in ONE pass over the two rows, with online-rescaled
// accumulators (t~ = t/T, s~ = s/T):
//   m_t, Z_t : running max and partition  sum exp(t~ - m_t)
//   U        : sum exp(t~ - m_t) * (t~ - s~)
//   m_s, Z_s : running max and partition of the student
// and finish with  KL = U/Z_t - (m_t + log Z_t) + (m_s + log Z_s).
// Forward only, as the reference: the wrapper refuses inputs that require
// a gradient.
//
// What bounds it on H100: bytes, and at the distillation's 64 rows the
// fixed costs of a short kernel.  Each operand is read once, 2*rows*V*4
// bytes (25.7 MB at rows=64, V=50257: ~7.7 us at 3.35 TB/s), against ~15
// flops and two exps per element pair; the output is rows floats.  To
// stream at the card's rate the loads of many CTAs must be in flight, and
// a few rows (64 public samples) must still occupy the whole card.  Above
// that, a launch, the first loads' latency from HBM and the cluster merge
// cost a few microseconds whatever the width (PERF.md).
//
// Design.  A row is split over a thread-block cluster of C CTAs of 512
// threads; CTA `rank` streams the rank-th contiguous slice of the row's
// 16-byte granules, thread x the granules x, x + 512, ... of it, so a
// warp reads 512 contiguous bytes of each operand a step.  C (8, 4, 2 or
// 1) is the largest that leaves at most one CTA an SM: 2 for 64 rows on
// an H100's 132 SMs, 8 for 8 rows, 1 from 67 rows.  Larger clusters (two
// CTAs an SM, or a second wave: 8-CTA clusters fit on only 124 of the 132
// SMs) cost more in the merges than the split gains.  A granule of t and
// its granule of s are one tile of 4 element pairs, as the Pallas kernel
// treats its vocab tile: the tile's max of t~ and of s~, one rescale of
// the running state, then sums of exp(t~ - m_t), exp(t~ - m_t)(t~ - s~)
// and exp(s~ - m_s) with no per-element branch.  The loop is unrolled
// twice: two granules of each operand in flight a thread.  (Measured
// slower, read cold: one or four in flight, 8-element tiles, 1024-thread
// CTAs, two CTAs an SM; a ring of TMA bulk copies into shared memory was
// slower read warm.)  The exps are __expf, ex2.approx of x * log2(e): every
// argument is a difference to a running maximum, x <= 0, and a term's
// relative error is a few ulps plus |x| * 2^-24 from rounding the product;
// a term with |x| > 17 is below 2^-24 of the maximum's term (1), so the
// sums carry errors of a few ulps, far inside the tolerance (rtol 1e-5 plus
// 2e-6 (1 + |lse_t| + |lse_s|)).  The accurate expf was slower: the exps,
// not only the loads, are on the critical path.
// 16-byte loads need both rows on the same 16-byte phase; the head up to
// the boundary (on rank 0) and the tail after the last granule (on rank
// C - 1) are scalar and masked, never padded, and rows on different phases
// go all scalar.  The partial states merge in a fixed order: each warp's
// lanes (the maxima first, then every lane's sums rescaled to them once,
// then the sums), then warp 0 of rank 0 over every warp's partial in the
// cluster, read through distributed shared memory: no atomics and no
// second launch, so a row's result is the same on every run.  Teacher and
// student run the same code (explicitly rounded adds and multiplies), so
// t == s gives U = 0 and lse_t == lse_s bitwise: KL exactly 0.
//
// The bf16 kernel.  bf16 rows are half the bytes (12.9 MB at 64 x 50257:
// ~3.8 us at 3.35 TB/s), but run through the fp32 body above they took
// about as long as fp32 rows read warm: each 4-pair tile's own max and a
// rescale costing two more exps (2.5 a pair, a serial chain through the
// running state) added ~3.4 K cycles of math to the loop's loads, and the
// merge (two cluster barriers around rank 0 reading every warp's partial)
// ~4.4 K cycles after it (tools/kernel_probe.py's clocked copy).
// distill_kl_16_kernel keeps the row split over a cluster, the loop's
// shape (thread x on granules x, x + 512, ..., the next granules' loads in
// flight during a granule's math: it overlapped loads and math better than
// a chunk of 8 granules loaded before any math, or a ring of TMA bulk
// copies into shared memory, both tried and timed), the scalar head and
// tail and a fixed merge order, and changes two things:
//   * the math: each granule pair's exact maxima (taken on the packed bf16
//     words) rescale the running state only where they grow, so a pair
//     costs 2 exps (not 2.5), and rescales grow rarer along the row;
//   * the merge: each CTA merges its warps and stores its state into the
//     first CTA's shared memory, and only the first CTA waits, once.
// Teacher and student still run the same code, so t == s still gives
// exactly 0.  A row holding +inf gets +inf as its maximum and exp(inf -
// inf) = NaN in its sums, as the plain log-sum-exp gives NaN; a NaN, which
// the packed maxima pass over, reaches the sums through its own exp.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC.
// Plain C interface, loaded through ctypes; the entry point launches on
// the given stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size

struct Lse {  // online log-sum-exp state of one distribution
  float m, z;
};

struct KL {
  Lse t, s;
  float u;
};

// One tile of 4 element pairs into the running state: the tile's maxima,
// one rescale, then the sums.  With kMasked only the first n_valid pairs
// count (a select, not a branch, per element).
template <bool kMasked>
__device__ __forceinline__ void add_tile(KL& st, const float (&tt)[4], const float (&ss)[4],
                                         int n_valid) {
  if (kMasked && n_valid <= 0) return;
  float mt = -INFINITY, ms = -INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!kMasked || i < n_valid) {
      mt = fmaxf(mt, tt[i]);
      ms = fmaxf(ms, ss[i]);
    }
  }
  mt = fmaxf(st.t.m, mt);
  ms = fmaxf(st.s.m, ms);
  float zt = 0.0f, zs = 0.0f, u = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = !kMasked || i < n_valid;
    const float w = in ? __expf(tt[i] - mt) : 0.0f;
    zt = __fadd_rn(zt, w);
    u = __fmaf_rn(w, in ? __fsub_rn(tt[i], ss[i]) : 0.0f, u);
    zs = __fadd_rn(zs, in ? __expf(ss[i] - ms) : 0.0f);
  }
  const float rt = __expf(st.t.m - mt), rs = __expf(st.s.m - ms);  // 0 on a thread's first tile
  st.t.z = __fmaf_rn(st.t.z, rt, zt);
  st.s.z = __fmaf_rn(st.s.z, rs, zs);
  st.u = __fmaf_rn(st.u, rt, u);  // U rides on the teacher's rescale
  st.t.m = mt;
  st.s.m = ms;
}

// Merge b into a (ra, rb: the rescales of a's and b's sums).  An empty
// state (m = -inf) contributes nothing; without the guards two empty
// states would give exp(-inf - -inf) = NaN.
__device__ __forceinline__ void lse_merge(Lse& a, const Lse& b, float& ra, float& rb) {
  if (b.m == -INFINITY) {
    ra = 1.0f;
    rb = 0.0f;
  } else if (a.m == -INFINITY) {
    ra = 0.0f;
    rb = 1.0f;
    a = b;
  } else {
    const float m = fmaxf(a.m, b.m);
    ra = __expf(a.m - m);
    rb = __expf(b.m - m);
    a.z = __fmaf_rn(a.z, ra, __fmul_rn(b.z, rb));
    a.m = m;
  }
}

__device__ __forceinline__ void merge(KL& a, const KL& b) {
  float ra, rb;
  lse_merge(a.t, b.t, ra, rb);
  a.u = __fmaf_rn(a.u, ra, __fmul_rn(b.u, rb));  // an empty side has U = 0
  lse_merge(a.s, b.s, ra, rb);
}

// The 32 lanes' states merged into every lane, in a fixed order: the
// maxima first, then each lane's sums rescaled to them once, then the sums.
// An empty state (m = -inf) contributes nothing, and an all-empty warp
// stays empty (without the guard, exp(-inf - -inf) would be NaN).
__device__ __forceinline__ KL warp_merge(const KL& a) {
  KL b;
  b.t.m = a.t.m;
  b.s.m = a.s.m;
  for (int off = 16; off > 0; off >>= 1) {
    b.t.m = fmaxf(b.t.m, __shfl_xor_sync(0xffffffffu, b.t.m, off));
    b.s.m = fmaxf(b.s.m, __shfl_xor_sync(0xffffffffu, b.s.m, off));
  }
  const float rt = a.t.m == -INFINITY ? 0.0f : __expf(a.t.m - b.t.m);
  const float rs = a.s.m == -INFINITY ? 0.0f : __expf(a.s.m - b.s.m);
  b.t.z = __fmul_rn(a.t.z, rt);
  b.u = __fmul_rn(a.u, rt);
  b.s.z = __fmul_rn(a.s.z, rs);
  for (int off = 16; off > 0; off >>= 1) {
    b.t.z = __fadd_rn(b.t.z, __shfl_xor_sync(0xffffffffu, b.t.z, off));
    b.u = __fadd_rn(b.u, __shfl_xor_sync(0xffffffffu, b.u, off));
    b.s.z = __fadd_rn(b.s.z, __shfl_xor_sync(0xffffffffu, b.s.z, off));
  }
  return b;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Elements [lo, hi) one at a time, four per thread a tile, masked
template <class T>
__device__ __forceinline__ void add_scalars(KL& st, const T* t, const T* s, int lo,
                                            int hi, float inv_temp) {
  for (int c = lo + threadIdx.x; c < hi; c += 4 * kThreads) {
    float tt[4], ss[4];
    int n = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = c + i * kThreads;
      const bool in = e < hi;  // the valid elements are a prefix of the tile
      tt[i] = in ? to_f32(t[e]) * inv_temp : 0.0f;
      ss[i] = in ? to_f32(s[e]) * inv_temp : 0.0f;
      n += in;
    }
    add_tile<true>(st, tt, ss, n);
  }
}

__device__ __forceinline__ void unpack(float* dst, float4 a, float inv_temp) {
  dst[0] = a.x * inv_temp;
  dst[1] = a.y * inv_temp;
  dst[2] = a.z * inv_temp;
  dst[3] = a.w * inv_temp;
}

// What the 16-bit kernel needs of its element type T: two values (one
// 32-bit word) upcast exactly, and the larger of each pair of a word pair
// (NaN passed over, as max.f16x2 / max.bf16x2 do), exact.
template <class T>
struct Pair16;

template <>
struct Pair16<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ float2 up(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
};

template <>
struct Pair16<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ float2 up(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
};

// Two 16-bit values (one 32-bit word) upcast exactly, times inv_temp.
template <class T>
__device__ __forceinline__ void unpack2(float* dst, uint32_t w, float inv_temp) {
  const float2 f = Pair16<T>::up(w);
  dst[0] = f.x * inv_temp;
  dst[1] = f.y * inv_temp;
}

// The row's partial states merged in a fixed order and its KL written to
// *out: each warp's lanes, then warp 0 of rank 0 over every warp's partial
// in the cluster, read through distributed shared memory (lane l: warp
// l % kWarps of rank l / kWarps, then l + 32, ... merged into it in order).
__device__ __forceinline__ void merge_and_write(KL st, cg::cluster_group& cluster, float* out) {
  const int n_ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  st = warp_merge(st);
  __shared__ KL part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = st;
  cluster.sync();  // every warp's partial is in its CTA's shared memory
  if (rank == 0 && warp == 0) {
    st.t.m = st.s.m = -INFINITY;
    st.t.z = st.s.z = st.u = 0.0f;
    for (int i = lane; i < n_ranks * kWarps; i += 32)
      merge(st, *cluster.map_shared_rank(&part[i % kWarps], i / kWarps));
    st = warp_merge(st);
    if (lane == 0) {
      const float lse_t = st.t.m + logf(st.t.z);
      const float lse_s = st.s.m + logf(st.s.z);
      *out = st.u / st.t.z - lse_t + lse_s;
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its shared memory
}

// The fp32 kernel: a 16-byte granule holds 4 values, one tile.
__global__ void __launch_bounds__(kThreads)
    distill_kl_kernel(const float* __restrict__ teacher, const float* __restrict__ student,
                      float* __restrict__ out, int vocab, float inv_temp) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / n_ranks;
  const float* t = teacher + (size_t)r * vocab;
  const float* s = student + (size_t)r * vocab;
  KL st;
  st.t.m = st.s.m = -INFINITY;
  st.t.z = st.s.z = st.u = 0.0f;

  const uintptr_t pt = (uintptr_t)t, ps = (uintptr_t)s;
  if ((pt & 15) == (ps & 15) && (pt & 3) == 0) {
    const int head = min(vocab, (int)(((16 - (pt & 15)) & 15) / 4));
    const int n4 = (vocab - head) >> 2;  // whole granules
    const int chunk = (n4 + n_ranks - 1) / n_ranks;
    const int b0 = min(n4, rank * chunk), b1 = min(n4, b0 + chunk);
    if (rank == 0) add_scalars(st, t, s, 0, head, inv_temp);
    const float4* t4 = reinterpret_cast<const float4*>(t + head);
    const float4* s4 = reinterpret_cast<const float4*>(s + head);
#pragma unroll 2
    for (int i = b0 + threadIdx.x; i < b1; i += kThreads) {
      float tt[4], ss[4];
      unpack(tt, __ldg(t4 + i), inv_temp);
      unpack(ss, __ldg(s4 + i), inv_temp);
      add_tile<false>(st, tt, ss, 4);
    }
    if (rank == n_ranks - 1) add_scalars(st, t, s, head + 4 * n4, vocab, inv_temp);
  } else {  // rows on different 16-byte phases: all scalar, a slice a rank
    const int chunk = (vocab + n_ranks - 1) / n_ranks;
    const int lo = min(vocab, rank * chunk);
    add_scalars(st, t, s, lo, min(vocab, lo + chunk), inv_temp);
  }

  merge_and_write(st, cluster, out + r);
}

// -- the 16-bit kernel (bf16 and fp16) -----------------------------------------

// The larger of the 16-bit values in a word pair, exact.
template <class T>
__device__ __forceinline__ typename Pair16<T>::T2 max2(uint32_t a, uint32_t b) {
  using T2 = typename Pair16<T>::T2;
  return __hmax2(*reinterpret_cast<const T2*>(&a), *reinterpret_cast<const T2*>(&b));
}

// The largest of a granule's 8 16-bit values, times inv_temp: the max of
// the products, since rounding a product by a positive factor keeps the
// order.
template <class T>
__device__ __forceinline__ float granule_max(uint4 x, float inv_temp) {
  const typename Pair16<T>::T2 m = __hmax2(max2<T>(x.x, x.y), max2<T>(x.z, x.w));
  return to_f32(__hmax(m.x, m.y)) * inv_temp;
}

// A granule pair (8 element pairs) into the running state: its exact
// maxima; a rescale of the state only where a maximum grows (no serial
// chain through the max, a rescale rarer the further a thread gets); then
// its sums, rescale-free, added to the state's.
template <class T>
__device__ __forceinline__ void add_granule(KL& st, uint4 a, uint4 b, float inv_temp) {
  const float mt = granule_max<T>(a, inv_temp), ms = granule_max<T>(b, inv_temp);
  if (mt > st.t.m) {  // exp(-inf) = 0 on a thread's first granule
    const float rt = __expf(st.t.m - mt);
    st.t.z = __fmul_rn(st.t.z, rt);
    st.u = __fmul_rn(st.u, rt);  // U rides on the teacher's rescale
    st.t.m = mt;
  }
  if (ms > st.s.m) {
    st.s.z = __fmul_rn(st.s.z, __expf(st.s.m - ms));
    st.s.m = ms;
  }
  float tt[8], ss[8];
  unpack2<T>(tt, a.x, inv_temp);
  unpack2<T>(tt + 2, a.y, inv_temp);
  unpack2<T>(tt + 4, a.z, inv_temp);
  unpack2<T>(tt + 6, a.w, inv_temp);
  unpack2<T>(ss, b.x, inv_temp);
  unpack2<T>(ss + 2, b.y, inv_temp);
  unpack2<T>(ss + 4, b.z, inv_temp);
  unpack2<T>(ss + 6, b.w, inv_temp);
  float zt = 0.0f, zs = 0.0f, u = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float w = __expf(__fsub_rn(tt[i], st.t.m));
    zt = __fadd_rn(zt, w);
    u = __fmaf_rn(w, __fsub_rn(tt[i], ss[i]), u);
    zs = __fadd_rn(zs, __expf(__fsub_rn(ss[i], st.s.m)));
  }
  st.t.z = __fadd_rn(st.t.z, zt);
  st.s.z = __fadd_rn(st.s.z, zs);
  st.u = __fadd_rn(st.u, u);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The row's partial states merged in a fixed order and its KL written to
// *out, each CTA pushing its state to the first: each warp's lanes; the
// CTA's warps (lane w of warp 0 takes warp w); the CTA's state
// stored into the first CTA's shared memory (slot `rank`) through
// distributed shared memory, then a cluster barrier that only the first
// CTA waits on before it merges the slots (lane c takes rank c) -- the
// others leave as soon as they have stored.  Every thread arrived once at
// kernel start (cluster_arrive_relaxed), and waits for that phase before
// the store, so the first CTA has started.
__device__ __forceinline__ void push_merge_and_write(KL st, cg::cluster_group& cluster, float* out) {
  const int n_ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  __shared__ KL part[kWarps];
  __shared__ KL slot[kMaxCluster];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  KL none;
  none.t.m = none.s.m = -INFINITY;
  none.t.z = none.s.z = none.u = 0.0f;
  st = warp_merge(st);
  if (lane == 0) part[warp] = st;
  __syncthreads();
  cluster_wait();  // every CTA of the cluster has started
  if (warp == 0) {
    st = warp_merge(lane < kWarps ? part[lane] : none);
    if (lane == 0) *cluster.map_shared_rank(&slot[rank], 0) = st;
  }
  cluster_arrive();  // this CTA's state is in the first CTA's slot
  if (rank != 0) return;
  cluster_wait();
  if (warp == 0) {
    st = warp_merge(lane < n_ranks ? slot[lane] : none);
    if (lane == 0) {
      const float lse_t = st.t.m + logf(st.t.z);
      const float lse_s = st.s.m + logf(st.s.z);
      *out = st.u / st.t.z - lse_t + lse_s;
    }
  }
}

// A granule of an operand, read once: past L1, each miss fetching 256
// bytes into L2 (the next warps' granules), which streamed faster cold.
__device__ __forceinline__ uint4 load_granule(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// The 16-bit KL: the layout of distill_kl_kernel (a row over a cluster of
// C CTAs, CTA `rank` on the rank-th slice of its granules, thread x on
// granules x, x + 512, ...), each granule pair added with add_granule, the
// loop unrolled so that the next granules' loads are in flight during a
// granule's math.
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
    distill_kl_16_kernel(const T* __restrict__ teacher, const T* __restrict__ student,
                         float* __restrict__ out, int vocab, float inv_temp) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / n_ranks;
  const T* t = teacher + (size_t)r * vocab;
  const T* s = student + (size_t)r * vocab;
  cluster_arrive_relaxed();  // waited for before the merge's store to the first CTA
  KL st;
  st.t.m = st.s.m = -INFINITY;
  st.t.z = st.s.z = st.u = 0.0f;

  const uintptr_t pt = (uintptr_t)t, ps = (uintptr_t)s;
  if ((pt & 15) == (ps & 15) && (pt & 1) == 0) {
    const int head = min(vocab, (int)(((16 - (pt & 15)) & 15) / 2));
    const int n8 = (vocab - head) >> 3;  // whole granules
    const int chunk = (n8 + n_ranks - 1) / n_ranks;
    const int b0 = min(n8, rank * chunk), b1 = min(n8, b0 + chunk);
    if (rank == 0) add_scalars(st, t, s, 0, head, inv_temp);
    const uint4* t8 = reinterpret_cast<const uint4*>(t + head);
    const uint4* s8 = reinterpret_cast<const uint4*>(s + head);
#pragma unroll 2
    for (int i = b0 + threadIdx.x; i < b1; i += kThreads)
      add_granule<T>(st, load_granule(t8 + i), load_granule(s8 + i), inv_temp);
    if (rank == n_ranks - 1) add_scalars(st, t, s, head + 8 * n8, vocab, inv_temp);
  } else {  // rows on different 16-byte phases: all scalar, a slice a rank
    const int chunk = (vocab + n_ranks - 1) / n_ranks;
    const int lo = min(vocab, rank * chunk);
    add_scalars(st, t, s, lo, min(vocab, lo + chunk), inv_temp);
  }

  push_merge_and_write(st, cluster, out + r);
}

cudaLaunchConfig_t launch_config(int rows, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster size (8, 4, 2 or 1) that leaves at most one CTA an
// SM: rows * C <= the SM count.  Two CTAs an SM, or a second wave of
// clusters, cost more in the merges than the split gains.
int cluster_size(int rows, int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int c = kMaxCluster;
  while (c > 1 && (long long)rows * c > sms) c /= 2;
  *out = c;
  return (int)cudaSuccess;
}

template <class T>
int launch_kl(void (*kernel)(const T*, const T*, float*, int, float), const T* teacher,
              const T* student, float* out, int rows, int vocab, float inv_temp, void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  int c = 1;
  const int err = cluster_size(rows, &c);
  if (err != (int)cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(rows, c, (cudaStream_t)stream, &attr);
  const cudaError_t launch =
      cudaLaunchKernelEx(&cfg, kernel, teacher, student, out, vocab, inv_temp);
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// teacher, student: (rows, vocab) fp32, contiguous; out: (rows,) fp32.
int distill_kl_f32(const float* teacher, const float* student, float* out, int rows, int vocab,
                   float inv_temp, void* stream) {
  return launch_kl(distill_kl_kernel, teacher, student, out, rows, vocab, inv_temp, stream);
}

// teacher, student: (rows, vocab) bf16, contiguous; out: (rows,) fp32.
int distill_kl_bf16(const __nv_bfloat16* teacher, const __nv_bfloat16* student, float* out,
                    int rows, int vocab, float inv_temp, void* stream) {
  return launch_kl(distill_kl_16_kernel<__nv_bfloat16>, teacher, student, out, rows, vocab, inv_temp,
                   stream);
}

// teacher, student: (rows, vocab) fp16, contiguous; out: (rows,) fp32.
int distill_kl_f16(const __half* teacher, const __half* student, float* out, int rows, int vocab,
                   float inv_temp, void* stream) {
  return launch_kl(distill_kl_16_kernel<__half>, teacher, student, out, rows, vocab, inv_temp, stream);
}

}  // extern "C"
