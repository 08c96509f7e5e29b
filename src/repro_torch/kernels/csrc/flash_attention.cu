// Blockwise causal softmax attention, forward only (inference prefill):
//   out[b, i, :] = sum_{j <= i} softmax_j(q[b,i,:] . k[b,j,:] * D^-0.5) v[b,j,:]
// over fused head-batches q, k, v, out: (B*H, S, D) fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
//   flash_attention_{f32,bf16} <- flash_attention_pallas (_flash_kernel,
//                                                         _online_update)
//
// Both keep, per query row, an online max m, normaliser l and output
// accumulator over key tiles; tiles wholly above the causal diagonal are
// skipped (never loaded), the diagonal tile is masked per element, and the
// row finishes as acc / l.
//
// What bounds it on H100: operations.  The causal half of QK^T and PV is
// 2*S*S*D*(B*H) multiply-adds counted as two operations (12.9 GFLOP at
// B*H=96, S=1024, D=64) against 4*B*H*S*D*4 bytes of q, k, v and out
// (100.7 MB: 30 us at 3.35 TB/s).  On CUDA cores (67 TFLOP/s fp32) that is
// 192 us; this kernel runs both products on the tensor cores in TF32
// (495 TFLOP/s) with three products per product (below), so its bound is
// 3 * 12.9 GFLOP / 495 TFLOP/s = 78 us.
//
// Precision: 3xTF32.  One TF32 product keeps 11 bits of each operand; the
// scores then carry errors of ~2^-11 * |q||k|, which exp() turns into
// relative weight errors far above the check this kernel is held to
// (S * 2^-24 * max|v| against the plain fp32 version: ~75x over it with q
// and k of scale 4).  Each fp32 operand x is split into big = tf32(x)
// (round to nearest, ties away: cvt.rna's rounding, done with two integer
// operations, since the cvt instruction compiles to a guarded sequence
// several times longer) and small = x - big, exact in fp32, of which the
// tensor core reads the top 19 bits; a product is summed as small*big +
// big*small + big*big, the small terms first.  Only small*small (~2^-22
// relative) and small's last bits are dropped, so the products carry
// ~fp32 precision; the TF32 products are exact in the fp32 accumulators.
//
// Design.  A block owns 64 query rows of one head-batch: 4 warps of 16
// rows, each warp one m16n8k8 row tile; blocks are launched with the query
// tiles that see the most keys first, so the causal triangle leaves no
// tail of long blocks.  The q tile is staged once through shared memory,
// scaled by D^-0.5 (= 2^-3, exact) and split into big and small A
// fragments held in registers for the whole block.  K and V arrive in
// 64-key tiles through cp.async (16-byte, zero-filled past the sequence),
// double-buffered so that tile j + 1 loads while tile j computes.  S = Q K^T
// runs the 8 key n-tiles as independent accumulators over each k-step, so
// the tensor-core latency of one is hidden behind the others.  Inside each
// pair of k-steps the sum over D is taken in another order (A column t
// holds d = 16m + 4t + 2h of k-step 2m + h, column t + 4 the next d), so a
// lane reads its four K values of a step pair as one 16-byte load; K's rows
// are padded to 80 floats, V's to 68, which puts every fragment load of a
// warp on distinct banks (an unpadded 64-float row is 4- to 8-way
// conflicted).  The online softmax runs on the accumulators: the row max
// across the four lanes of a quad with shuffles, exp(x) as 2^(x log2 e) on
// the special-function unit, the row sums kept per lane and reduced once
// at the end.  On the diagonal tile a key after the query is set to -inf
// before the max, so its weight is an exact 0: it never enters the max or
// the sums, and the outputs of rows before a position do not depend on k
// or v at or after it, bit for bit.  P.V reuses the S accumulators as A
// fragments without any shuffle: the accumulator pair (2t, 2t+1) of a lane
// becomes the A columns (t, t+4), and the B fragment reads V rows 2t and
// 2t+1 to match, a permutation of the keys inside each k-step of the sum.
// 230 registers a thread (no spills): two blocks an SM; a third (168
// registers) spills and runs slower.
//
// bf16 q, k, v (flash_attention_bf16), as the reference's kernel takes
// them (it upcasts each tile and returns q's dtype).  cp.async cannot
// convert, so the block's threads load each bf16 tile (16-byte loads),
// upcast it exactly and store it into the same fp32 tile layout, one tile
// a step with no copy in flight (a simple loader); everything after that
// is the fp32 kernel's code, and the output is rounded to bf16 once, from
// the fp32 accumulator.  A bf16 value has 8 significand bits, so it is
// its own TF32 big part with small part 0, and so is q * 2^-3: in
// S = Q K^T both small terms of 3xTF32 are exact zeros, and in P V the
// term P.big * V.small is, so the kernel skips them -- one TF32 product
// per product for S and two for P V, the same sums as the fp32 kernel's
// on the upcast inputs (adding an exact 0 changes no sum).  Bound: 6.4 +
// 2 * 6.4 GFLOP at B*H = 96, S = 1024 on 495 TFLOP/s, 39 us, against
// 50.3 MB of bf16 q, k, v and out (15 us).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC.
// Plain C interface, loaded through ctypes; the entry point launches on
// the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 64;                   // head dim (GPT-2 small and large)
constexpr int kWarps = 4;               // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;      // query rows per block
constexpr int kKeys = 64;               // keys per staged tile
// shared-memory rows padded (in floats) so that a warp's fragment loads hit
// distinct banks: K's for 16-byte loads, V's for 4-byte loads
constexpr int kStrideK = D + 16;
constexpr int kStrideV = D + 4;
constexpr int kTileK = kKeys * kStrideK;  // floats of one staged K or V tile
constexpr int kTileV = kKeys * kStrideV;
constexpr int kStage = kTileK + kTileV;
constexpr int kSmemBytes = 2 * kStage * (int)sizeof(float);  // 2 stages of K and V
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows == kKeys, "the diagonal tile of a block is its last key tile");

// x = big + small to ~22 bits.  big is cvt.rna.tf32.f32(x) for finite x,
// formed with two integer operations (the cvt instruction compiles to a
// guarded sequence several times longer); small = x - big is exact, and
// the tensor core reads its top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a . b on the tensor cores, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: the small terms first, then big * big
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0, float b1) {
  uint32_t b0b, b0s, b1b, b1s;
  split(b0, b0b, b0s);
  split(b1, b1b, b1s);
  mma(c, as, b0b, b1b);
  mma(c, ab, b0s, b1s);
  mma(c, ab, b0b, b1b);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 64 rows of one (seq, D) matrix from row0 into a tile of rows padded to
// `stride` floats; rows past the sequence are zero
template <int kStride>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int seq) {
#pragma unroll
  for (int i = 0; i < kKeys * (D / 4) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (D / 4), col = 4 * (c % (D / 4));
    const bool in = row0 + r < seq;
    cp_async16(dst + r * kStride + col, src + (size_t)(in ? row0 + r : 0) * D + col, in);
  }
}

// The same tile from bf16 rows: 16-byte loads of 8 values, upcast exactly
// and stored as fp32 (the tile layout of the fp32 kernel); rows past the
// sequence are zero.
template <int kStride>
__device__ __forceinline__ void stage_bf16(float* dst, const __nv_bfloat16* src, int row0,
                                           int seq) {
#pragma unroll
  for (int i = 0; i < kKeys * (D / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (D / 8), col = 8 * (c % (D / 8));
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) w = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col));
    float4* d4 = reinterpret_cast<float4*>(dst + r * kStride + col);
    d4[0] = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                        __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
    d4[1] = make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
                        __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u));
  }
}

// 2^x on the special-function unit (2 ulp; a subnormal result flushes to 0,
// and 2^-inf is an exact 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// T: float or __nv_bfloat16, the type of q, k, v and out; the tiles in
// shared memory and all the arithmetic are fp32 in both.
template <class T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int seq,
                           float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // stage s: K, then V, at s * kStage

  const int n_qt = (seq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kRows;  // the longest query tiles first
  const size_t base = (size_t)blockIdx.x * seq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and lane in the quad
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const int n_kt = q0 / kKeys + 1;  // key tiles 0 .. the diagonal

  // the q tile through stage 1's K buffer, beside key tile 0 in stage 0
  if constexpr (kF32) {
    stage<kStrideK>(smem, k + base, 0, seq);
    stage<kStrideV>(smem + kTileK, v + base, 0, seq);
    stage<kStrideK>(smem + kStage, q + base, q0, seq);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    stage_bf16<kStrideK>(smem, k + base, 0, seq);
    stage_bf16<kStrideV>(smem + kTileK, v + base, 0, seq);
    stage_bf16<kStrideK>(smem + kStage, q + base, q0, seq);
  }
  __syncthreads();
  // A fragments of the scaled q, big and small.  The sum over D is taken in
  // another order inside each pair of k-steps (2m, 2m + 1): A column t holds
  // d = 16m + 4t + 2h of k-step 2m + h, column t + 4 the next d, and K's B
  // fragments follow, so that a lane reads its four K values as one float4.
  uint32_t qb[D / 8][4], qs[kF32 ? D / 8 : 1][4];  // bf16: the small parts are 0
  if constexpr (kF32) {
    const float* qt = smem + kStage + 16 * warp * kStrideK + 4 * t;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const float4 x0 = *reinterpret_cast<const float4*>(qt + g * kStrideK + 16 * m);
      const float4 x1 = *reinterpret_cast<const float4*>(qt + (g + 8) * kStrideK + 16 * m);
      split(x0.x * scale, qb[2 * m][0], qs[2 * m][0]);
      split(x1.x * scale, qb[2 * m][1], qs[2 * m][1]);
      split(x0.y * scale, qb[2 * m][2], qs[2 * m][2]);
      split(x1.y * scale, qb[2 * m][3], qs[2 * m][3]);
      split(x0.z * scale, qb[2 * m + 1][0], qs[2 * m + 1][0]);
      split(x1.z * scale, qb[2 * m + 1][1], qs[2 * m + 1][1]);
      split(x0.w * scale, qb[2 * m + 1][2], qs[2 * m + 1][2]);
      split(x1.w * scale, qb[2 * m + 1][3], qs[2 * m + 1][3]);
    }
  } else {
    const float* qt = smem + kStage + 16 * warp * kStrideK + 4 * t;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const float4 x0 = *reinterpret_cast<const float4*>(qt + g * kStrideK + 16 * m);
      const float4 x1 = *reinterpret_cast<const float4*>(qt + (g + 8) * kStrideK + 16 * m);
      qb[2 * m][0] = __float_as_uint(x0.x * scale);
      qb[2 * m][1] = __float_as_uint(x1.x * scale);
      qb[2 * m][2] = __float_as_uint(x0.y * scale);
      qb[2 * m][3] = __float_as_uint(x1.y * scale);
      qb[2 * m + 1][0] = __float_as_uint(x0.z * scale);
      qb[2 * m + 1][1] = __float_as_uint(x1.z * scale);
      qb[2 * m + 1][2] = __float_as_uint(x0.w * scale);
      qb[2 * m + 1][3] = __float_as_uint(x1.w * scale);
    }
  }
  __syncthreads();  // the q tile is read before key tile 1 overwrites it

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    if constexpr (kF32) {
      if (it + 1 < n_kt) {
        float* next = smem + ((it + 1) & 1) * kStage;
        stage<kStrideK>(next, k + base, (it + 1) * kKeys, seq);
        stage<kStrideV>(next + kTileK, v + base, (it + 1) * kKeys, seq);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else if (it > 0) {  // this step's tile, loaded and upcast now
      float* cur = smem + (it & 1) * kStage;
      stage_bf16<kStrideK>(cur, k + base, it * kKeys, seq);
      stage_bf16<kStrideV>(cur + kTileK, v + base, it * kKeys, seq);
    }
    __syncthreads();
    const float* ks = smem + (it & 1) * kStage;
    const float* vs = ks + kTileK;
    const int k0 = it * kKeys;
    const bool diag = it == n_kt - 1;

    // S = (q * scale) k^T, 16 rows x 64 keys a warp: the 8 key n-tiles are
    // independent accumulators, interleaved over each k-step
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float4 kr =
            *reinterpret_cast<const float4*>(ks + (8 * j + g) * kStrideK + 16 * m + 4 * t);
        if constexpr (kF32) {
          mma3(s[j], qb[2 * m], qs[2 * m], kr.x, kr.y);
          mma3(s[j], qb[2 * m + 1], qs[2 * m + 1], kr.z, kr.w);
        } else {  // exact TF32 operands: one product
          mma(s[j], qb[2 * m], __float_as_uint(kr.x), __float_as_uint(kr.y));
          mma(s[j], qb[2 * m + 1], __float_as_uint(kr.z), __float_as_uint(kr.w));
        }
      }
    }
    // the causal mask, then the tile's row max across the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (diag && key > (e < 2 ? row0 : row1)) s[j][e] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // key k0 <= every row of the block, so the new maxima are finite;
    // exp(x) = 2^(x log2 e), and exp(-inf) is an exact 0
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float r0 = exp2_approx((m0 - n0) * kLog2e);  // 0 on the first tile
    const float r1 = exp2_approx((m1 - n1) * kLog2e);
    m0 = n0;
    m1 = n1;
    const float c0 = -m0 * kLog2e, c1 = -m1 * kLog2e;
    l0 *= r0;
    l1 *= r1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= r0;
      o[nd][1] *= r0;
      o[nd][2] *= r1;
      o[nd][3] *= r1;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      s[j][0] = exp2_approx(fmaf(s[j][0], kLog2e, c0));
      s[j][1] = exp2_approx(fmaf(s[j][1], kLog2e, c0));
      s[j][2] = exp2_approx(fmaf(s[j][2], kLog2e, c1));
      s[j][3] = exp2_approx(fmaf(s[j][3], kLog2e, c1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    // O += P V: the accumulators of keys (2t, 2t + 1) are the A columns
    // (t, t + 4), so the B fragment takes V rows 2t and 2t + 1
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
      const float* vr = vs + (8 * j + 2 * t) * kStrideV + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        if constexpr (kF32) {
          mma3(o[nd], pb, ps, vr[8 * nd], vr[kStrideV + 8 * nd]);
        } else {  // V exact in TF32: P.small * V, then P.big * V
          const uint32_t b0 = __float_as_uint(vr[8 * nd]), b1 = __float_as_uint(vr[kStrideV + 8 * nd]);
          mma(o[nd], ps, b0, b1);
          mma(o[nd], pb, b0, b1);
        }
      }
    }
    __syncthreads();  // the tile is read before the next stage overwrites it
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = 8 * nd + 2 * t;
    if constexpr (kF32) {
      if (row0 < seq)
        *reinterpret_cast<float2*>(out + base + (size_t)row0 * D + col) =
            make_float2(o[nd][0] * inv0, o[nd][1] * inv0);
      if (row1 < seq)
        *reinterpret_cast<float2*>(out + base + (size_t)row1 * D + col) =
            make_float2(o[nd][2] * inv1, o[nd][3] * inv1);
    } else {  // rounded to bf16 once
      if (row0 < seq)
        *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)row0 * D + col) =
            __floats2bfloat162_rn(o[nd][0] * inv0, o[nd][1] * inv0);
      if (row1 < seq)
        *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)row1 * D + col) =
            __floats2bfloat162_rn(o[nd][2] * inv1, o[nd][3] * inv1);
    }
  }
}

template <class T>
int launch_attention(const T* q, const T* k, const T* v, T* out, int bh, int seq, int head_dim,
                     float scale, void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + kRows - 1) / kRows);
  flash_attention_kernel<T><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(q, k, v, out,
                                                                                  seq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (bh, seq, head_dim) fp32, contiguous, 16-byte aligned;
// head_dim 64 (else cudaErrorInvalidValue, nothing launched); scale: the
// caller's fp32 head_dim^-0.5.
int flash_attention_f32(const float* q, const float* k, const float* v, float* out, int bh,
                        int seq, int head_dim, float scale, void* stream) {
  return launch_attention(q, k, v, out, bh, seq, head_dim, scale, stream);
}

// q, k, v, out: (bh, seq, head_dim) bf16, contiguous, 16-byte aligned; the
// rest as flash_attention_f32.  scale must be a power of two (64^-0.5 = 2^-3)
// for q * scale to stay exact in TF32.
int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* out, int bh, int seq, int head_dim, float scale,
                         void* stream) {
  return launch_attention(q, k, v, out, bh, seq, head_dim, scale, stream);
}

}  // extern "C"
