// Blockwise causal softmax attention, forward only (inference prefill):
//   out[b, i, :] = sum_{j <= i} softmax_j(q[b,i,:] . k[b,j,:] * D^-0.5) v[b,j,:]
// over fused head-batches q, k, v, out: (B*H, S, D) fp32, bf16 or fp16, with
// head dim D 64 (GPT-2, granite, stablelm, seamless, mamba2) or 128 (yi-9b,
// command-r, llama4, internvl2, jamba, moonshot): every kernel is a template
// on D, instantiated at both; any other D launches nothing.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
//   flash_attention_{f32,bf16,f16} <- flash_attention_pallas (_flash_kernel,
//                                                             _online_update)
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
// fp32 at D = 128 (flash_attention_kernel<128>).  Twice the work a key:
// 25.8 GFLOP at B*H = 96, S = 1024, so 3 * 25.8 / 495 = 156 us.  q's split
// fragments would take 128 registers a lane and O 64, so q's tile stays in
// shared memory (rows padded to 144 floats, the same bank pattern as K's)
// and each pair of k-steps reads its two float4s and splits them there; the
// key tiles are 32 keys (S is then 16 registers), so a block of 64 query rows
// holds 2 x 35 KB of K/V stages and 37 KB of q: 105 KB, two blocks an SM
// (196 registers a thread, no spills).
// K's rows padded to 144 floats and V's to 132 keep the D = 64 bank argument
// (144 = 80 and 132 = 68 mod 32).  The block's last two key tiles take the
// causal mask; warps 0 and 1 (rows q0 .. q0 + 31) skip the last one, all of
// whose keys lie after their rows.  The scale 128^-0.5 = 2^-3.5 is not exact,
// so q is not scaled: the scale enters the exponent, as in the 16-bit kernels
// (2^(s c - m c), c = scale * log2(e)), and S = q k^T carries 3xTF32's error.
//
// bf16 q, k, v (flash_attention_bf16), as the reference's kernel takes
// them (it upcasts each tile and returns q's dtype): a kernel of its own, on
// Hopper's bf16 warpgroup products (wgmma, 989 TFLOP/s against TF32's 495).
//   * Loads.  A block owns 128 query rows of one head-batch: two consumer
//     warpgroups of 64 rows and one producer warp, two blocks an SM.  The
//     producer's lane 0 loads the q tile and then K and V in 64-key tiles
//     through a ring of 4 stages by TMA (3-D tensor maps over (bh, seq, D),
//     so rows past the sequence read as zeros, in the 128-byte swizzle that
//     wgmma reads), each stage signalled by an mbarrier when its bytes land
//     and released by another when the consumers' 8 warps are done with it.
//     The two warpgroups share every K/V tile, which halves the tiles'
//     traffic from L2 against 64-row blocks.  Query tiles run longest first.
//   * S = Q K^T: four m64n64k16 bf16 products, Q and K (as stored: the
//     K-major B) from shared memory; each bf16 x bf16 product is exact in
//     fp32, as in the plain version.  The scale enters the exponent:
//     exp(s * scale - m * scale) = 2^(s c - m c), c = scale * log2(e), one
//     fma a score, the same as scaling q by 2^-3 first (exact) for D = 64.
//   * The online softmax runs on the accumulators as the fp32 kernel does;
//     on the diagonal tile a key after the query is -inf before the max,
//     so causality stays bitwise.
//   * O += P V with P in two bf16 pieces, hi = bf16(P) and lo = bf16(P -
//     hi) (together within ~2^-17 P; one piece, as bf16 SDPA rounds it,
//     misses the check by far), two m64n64k16 products a k-step with A
//     from registers: the S accumulators of keys 16kk .. 16kk + 15 are,
//     pairwise packed, the A fragment of k-step kk, no shuffle.  V as
//     stored, (keys, D), is the MN-major (transposed) B, read straight from
//     the tile TMA loaded.
//   * The output is rounded to bf16 once, from the fp32 accumulator.
//   Bound: Q K^T one bf16 product and P V two, 6.4 + 2 * 6.4 GFLOP at
//   B*H = 96, S = 1024 on 989 TFLOP/s, 19.5 us, against 50.3 MB of bf16
//   q, k, v and out (15 us).
//   D = 128 (flash_attention_16_kernel<E, 128>): a 256-byte row is two
//   spans of the 128-byte swizzle, so TMA loads every tile as two boxes of
//   64 columns into two column blocks (Q: 2 x 16 KB, K and V: 2 x 8 KB), and
//   each descriptor steps to the second block at k-step 4 of Q K^T's eight.
//   P V runs as two m64n64k16 products a piece and k-step, one a column block
//   of V, into two 32-register halves of O.  O's 64 registers beside S's 32
//   and P's 32 need more than two blocks an SM leave a thread (113), so one
//   block an SM (up to 224 registers a thread; it takes 147, no spills, so
//   no setmaxnreg) with Q and 4 stages of K/V: 161 KB.  Bound 39.1 us
//   (design) at B*H = 96, S = 1024.
//
// fp16 q, k, v (flash_attention_f16) run the same kernel,
// flash_attention_16_kernel<E, D>, with E = F16: wgmma .f32.f16.f16, tensor
// maps of fp16, and P in two fp16 pieces (cvt.rn.f16x2.f32).  An fp16 value
// has 11 significant bits and 5 exponent bits, so it is exact in TF32 and
// fp32, and the product of two is exact in fp32: Q K^T stays exact as in
// bf16.  P is in [0, 1]: hi = fp16(P) keeps 11 bits (one piece misses the
// check by far, as bf16's does), lo = fp16(P - hi) the next 11, down to
// fp16's subnormal step 2^-24, below which a weight is dropped (at most
// 2^-25 a key, S 2^-25 max|v| in all, half the check's bound).  The output
// is rounded to fp16 once.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC.
// Plain C interface, loaded through ctypes; the entry point launches on
// the given stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;               // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;      // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

// The fp32 kernel's tiles at head dim D.  D = 64: 64-key tiles, q's split
// fragments in registers for the whole block.  D = 128: 32-key tiles, q's
// tile in shared memory beside the two K/V stages.
template <int D>
struct Tiles32 {
  static constexpr int kKeys = D == 64 ? 64 : 32;  // keys per staged tile
  // shared-memory rows padded (in floats) so that a warp's fragment loads hit
  // distinct banks: K's (and q's) for 16-byte loads, V's for 4-byte loads
  static constexpr int kStrideK = D + 16;
  static constexpr int kStrideV = D + 4;
  static constexpr int kTileK = kKeys * kStrideK;  // floats of one staged K or V tile
  static constexpr int kTileV = kKeys * kStrideV;
  static constexpr int kStage = kTileK + kTileV;
  static constexpr bool kQRegs = D == 64;  // q's fragments in registers, q scaled by 2^-3 first
  // 2 stages of K and V, and q's tile where it stays in shared memory
  static constexpr int kSmemBytes = (2 * kStage + (kQRegs ? 0 : kRows * kStrideK)) * (int)sizeof(float);
  static constexpr int kMinBlocks = kQRegs ? 1 : 2;  // D = 128: two blocks an SM, 255 registers
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static_assert(kRows % kKeys == 0, "a block's query tile is whole key tiles");
};

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

// kN rows of one (seq, D) matrix from row0 into a tile of rows padded to
// `kStride` floats; rows past the sequence are zero
template <int D, int kN, int kStride>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int seq) {
#pragma unroll
  for (int i = 0; i < kN * (D / 4) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (D / 4), col = 4 * (c % (D / 4));
    const bool in = row0 + r < seq;
    cp_async16(dst + r * kStride + col, src + (size_t)(in ? row0 + r : 0) * D + col, in);
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

template <int D>
__global__ void __launch_bounds__(kThreads, Tiles32<D>::kMinBlocks)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int seq,
                           float scale) {
  using T = Tiles32<D>;
  constexpr int kKeys = T::kKeys, kStrideK = T::kStrideK, kStrideV = T::kStrideV;
  constexpr int kTileK = T::kTileK, kStage = T::kStage;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // stage s: K, then V, at s * kStage
  float* q_tile = smem + 2 * kStage;              // D = 128: q's tile, the whole block

  const int n_qt = (seq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kRows;  // the longest query tiles first
  const size_t base = (size_t)blockIdx.x * seq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and lane in the quad
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const int n_kt = q0 / kKeys + kRows / kKeys;  // key tiles 0 .. the block's last row
  // exp(x * scale) = 2^(x c): at D = 64 q is scaled by 2^-3 first (exact) and
  // c = log2(e); at D = 128 the scale enters the exponent
  const float c = T::kQRegs ? kLog2e : scale * kLog2e;

  // D = 64: the q tile through stage 1's K buffer, beside key tile 0 in stage 0
  stage<D, kKeys, kStrideK>(smem, k + base, 0, seq);
  stage<D, kKeys, kStrideV>(smem + kTileK, v + base, 0, seq);
  stage<D, kRows, kStrideK>(T::kQRegs ? smem + kStage : q_tile, q + base, q0, seq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // D = 64: A fragments of the scaled q, big and small.  The sum over D is
  // taken in another order inside each pair of k-steps (2m, 2m + 1): A
  // column t holds d = 16m + 4t + 2h of k-step 2m + h, column t + 4 the next
  // d, and K's B fragments follow, so that a lane reads its four K values as
  // one float4.  D = 128 reads the same fragments from q's tile k-step pair
  // by k-step pair, unscaled.
  uint32_t qb[T::kQRegs ? D / 8 : 1][4], qs[T::kQRegs ? D / 8 : 1][4];
  if constexpr (T::kQRegs) {
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
    __syncthreads();  // the q tile is read before key tile 1 overwrites it
  }

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    if (it + 1 < n_kt) {
      float* next = smem + ((it + 1) & 1) * kStage;
      stage<D, kKeys, kStrideK>(next, k + base, (it + 1) * kKeys, seq);
      stage<D, kKeys, kStrideV>(next + kTileK, v + base, (it + 1) * kKeys, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = smem + (it & 1) * kStage;
    const float* vs = ks + kTileK;
    const int k0 = it * kKeys;
    // the tiles that reach past the block's first row take the causal mask
    const bool diag = kKeys == kRows ? it == n_kt - 1 : k0 >= q0;

    // D = 128: a warp whose rows all lie before the tile's keys skips it
    // (warps 0 and 1 on the last tile); key k0 <= every row it does run
    if (kKeys == kRows || k0 <= q0 + 16 * warp + 15) {
      // S = (q * scale) k^T (D = 128: q k^T), 16 rows x kKeys keys a warp:
      // the key n-tiles are independent accumulators, interleaved over each k-step
      float s[kKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int m = 0; m < D / 16; ++m) {
        uint32_t ab[2][4], as[2][4];  // D = 128: q's fragments of k-steps 2m and 2m + 1
        if constexpr (!T::kQRegs) {
          const float* qt = q_tile + 16 * warp * kStrideK + 4 * t + 16 * m;
          const float4 x0 = *reinterpret_cast<const float4*>(qt + g * kStrideK);
          const float4 x1 = *reinterpret_cast<const float4*>(qt + (g + 8) * kStrideK);
          split(x0.x, ab[0][0], as[0][0]);
          split(x1.x, ab[0][1], as[0][1]);
          split(x0.y, ab[0][2], as[0][2]);
          split(x1.y, ab[0][3], as[0][3]);
          split(x0.z, ab[1][0], as[1][0]);
          split(x1.z, ab[1][1], as[1][1]);
          split(x0.w, ab[1][2], as[1][2]);
          split(x1.w, ab[1][3], as[1][3]);
        }
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const float4 kr =
              *reinterpret_cast<const float4*>(ks + (8 * j + g) * kStrideK + 16 * m + 4 * t);
          if constexpr (T::kQRegs) {
            mma3(s[j], qb[2 * m], qs[2 * m], kr.x, kr.y);
            mma3(s[j], qb[2 * m + 1], qs[2 * m + 1], kr.z, kr.w);
          } else {
            mma3(s[j], ab[0], as[0], kr.x, kr.y);
            mma3(s[j], ab[1], as[1], kr.z, kr.w);
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
      // key k0 <= every row of the warp, so the new maxima are finite;
      // exp(x) = 2^(x log2 e), and exp(-inf) is an exact 0
      const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
      const float r0 = exp2_approx((m0 - n0) * c);  // 0 on the first tile
      const float r1 = exp2_approx((m1 - n1) * c);
      m0 = n0;
      m1 = n1;
      const float c0 = -m0 * c, c1 = -m1 * c;
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
        s[j][0] = exp2_approx(fmaf(s[j][0], c, c0));
        s[j][1] = exp2_approx(fmaf(s[j][1], c, c0));
        s[j][2] = exp2_approx(fmaf(s[j][2], c, c1));
        s[j][3] = exp2_approx(fmaf(s[j][3], c, c1));
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
        for (int nd = 0; nd < D / 8; ++nd) mma3(o[nd], pb, ps, vr[8 * nd], vr[kStrideV + 8 * nd]);
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
    if (row0 < seq)
      *reinterpret_cast<float2*>(out + base + (size_t)row0 * D + col) =
          make_float2(o[nd][0] * inv0, o[nd][1] * inv0);
    if (row1 < seq)
      *reinterpret_cast<float2*>(out + base + (size_t)row1 * D + col) =
          make_float2(o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

template <int D>
int launch_attention(const float* q, const float* k, const float* v, float* out, int bh, int seq,
                     float scale, void* stream) {
  constexpr int kSmemBytes = Tiles32<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + kRows - 1) / kRows);
  flash_attention_kernel<D><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(q, k, v, out,
                                                                                  seq, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 and fp16: both products on 16-bit wgmma, K and V fed by TMA -------

constexpr int kConsumers = 2;                    // warpgroups of 64 query rows
constexpr int kBlockRows = 64 * kConsumers;      // query rows a block
constexpr int kBf16Threads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kStagesBf16 = 4;                   // K/V tiles in flight
constexpr int kSpanBytes = 128;                  // a row of one swizzle span: 64 16-bit columns

// The 16-bit kernel's tiles at head dim D: D / 64 column blocks of one
// swizzle span each, a tile's block c at c * (its rows * 128 bytes).
template <int D>
struct Tiles16 {
  static constexpr int kBlocksPerSm = D == 64 ? 2 : 1;
  static constexpr int kTileBytes = 64 * D * 2;  // 64 rows of K or V
  static constexpr int kSmem = 1024 + kBlockRows * D * 2 + kStagesBf16 * 2 * kTileBytes;  // + alignment
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// One box of a 3-D tensor map (d, row, head-batch) from column `col` into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         int bh, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"((uint64_t)map), "r"(col), "r"(row), "r"(bh), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a tile of 128-byte rows in TMA's 128-byte swizzle
// (1024-byte aligned atoms of 8 rows): start address, leading byte offset
// 16 (unused: a row is one swizzle span), stride byte offset 1024 (the next
// 8 rows), swizzle mode 128B.  K-major A and B (Q, K: a row is one query or
// key, along D) step 32 bytes per 16-wide k-step; the MN-major B (V: a row
// is one key, the k of P V) steps 2048 bytes, 16 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pin registers that wgmma reads or writes at this point of the program:
// the compiler may not move their other uses across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The 16-bit element types: what differs between the bf16 and the fp16
// kernel is the product's input type, the tensor maps' element type, and how
// two fp32 values are rounded into one register and read back exactly.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // (lo column, hi column) -> two bf16, rounded to nearest, in one register
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
  }
  static __device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
};

struct F16 {
  using T = __half;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // (lo column, hi column) -> two fp16, rounded to nearest, in one register
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
  }
  static __device__ __forceinline__ float lo(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
};

// d (+)= A B on the tensor cores, one m64n64k16 product (E: bf16 or fp16
// inputs) of the warpgroup with fp32 accumulators: A (64 x 16) and B
// (64 x 16, K-major) from shared memory; scale_d = 0 overwrites d.
#define WGMMA_SS(TYPE)                                                                  \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      WGMMA_D : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// d += A B, one m64n64k16 product with A (64 x 16) from registers (the
// accumulator fragment layout, two values a register) and B (16 x 64,
// MN-major: transposed) from shared memory.
#define WGMMA_RS(TYPE)                                                                  \
  asm volatile(                                                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n" \
      WGMMA_D : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b))
#define WGMMA_D                                                                                       \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),       \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),           \
    "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),           \
    "+f"(d[30]), "+f"(d[31])

template <class E>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (std::is_same<E, F16>::value) {
    WGMMA_SS("f16");
  } else {
    WGMMA_SS("bf16");
  }
}

template <class E>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  if constexpr (std::is_same<E, F16>::value) {
    WGMMA_RS("f16");
  } else {
    WGMMA_RS("bf16");
  }
}

// A block owns kBlockRows query rows of one head-batch; warpgroup w of its
// consumers owns rows q0 + 64 w ...; the producer warp's lane 0 loads Q and
// then K/V tiles 0 .. the last consumer's diagonal through a ring of
// kStagesBf16 stages (full: TMA bytes landed; empty: the consumers' 8 warps
// are done with it).  c = scale * log2(e).  E: Bf16 or F16; D: 64 or 128.
template <class E, int D>
__global__ void __launch_bounds__(kBf16Threads, Tiles16<D>::kBlocksPerSm)
    flash_attention_16_kernel(__grid_constant__ const CUtensorMap tm_q,
                              __grid_constant__ const CUtensorMap tm_k,
                              __grid_constant__ const CUtensorMap tm_v,
                              typename E::T* __restrict__ out, int seq, float c) {
  constexpr int kTileBytes = Tiles16<D>::kTileBytes;
  constexpr int kCols = D / 64;                       // column blocks of a row
  constexpr int kQBlock = kBlockRows * kSpanBytes;    // bytes of one column block of Q
  constexpr int kKVBlock = 64 * kSpanBytes;           // and of K or V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[kStagesBf16], bar_empty[kStagesBf16];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t s_kv = s_q + kBlockRows * D * 2;  // stage s: K at s_kv + 2 s kTileBytes, then V

  const int n_qt = (seq + kBlockRows - 1) / kBlockRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBlockRows;  // the longest query tiles first
  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // key tiles 0 .. the diagonal of consumer w (none when its rows lie past seq)
  auto tiles = [&](int w) { return q0 + 64 * w < seq ? (q0 + 64 * w) / 64 + 1 : 0; };

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar_q), 1);
    for (int s = 0; s < kStagesBf16; ++s) {
      mbar_init(smem_u32(&bar_full[s]), 1);
      mbar_init(smem_u32(&bar_empty[s]), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer
    if (lane == 0) {
      int n_tiles = 0;
      for (int w = 0; w < kConsumers; ++w) n_tiles = max(n_tiles, tiles(w));
      mbar_expect_tx(smem_u32(&bar_q), kBlockRows * D * 2);
#pragma unroll
      for (int cb = 0; cb < kCols; ++cb)
        tma_load(s_q + cb * kQBlock, &tm_q, 64 * cb, q0, bh, smem_u32(&bar_q));
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStagesBf16;
        // a stage is reused once every consumer that reads tile j - stages is done
        // with it; tiles past a consumer's diagonal are never reused
        if (j >= kStagesBf16) mbar_wait(smem_u32(&bar_empty[s]), (j / kStagesBf16 - 1) & 1);
        const uint32_t bar = smem_u32(&bar_full[s]), k_dst = s_kv + 2 * s * kTileBytes;
        mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kCols; ++cb)
          tma_load(k_dst + cb * kKVBlock, &tm_k, 64 * cb, 64 * j, bh, bar);
#pragma unroll
        for (int cb = 0; cb < kCols; ++cb)
          tma_load(k_dst + kTileBytes + cb * kKVBlock, &tm_v, 64 * cb, 64 * j, bh, bar);
      }
    }
    return;
  }

  // this consumer warpgroup, broadcast from lane 0 so that the compiler
  // keeps what derives from it (the wgmma descriptors) in uniform registers
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int n_mine = tiles(wg);
  if (n_mine == 0) return;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and lane in the quad
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + g, row1 = row0 + 8;
  // the wgmma descriptors of this warpgroup's 64 query rows at k-step 0 and
  // of stage 0's K and V tiles; a descriptor's low bits are the address / 16
  const uint64_t dq = sw128_desc(s_q + wg * 64 * kSpanBytes), dk = sw128_desc(s_kv);
  // key - row on the diagonal tile, less 8 i + (e & 1) + 8 (e >> 1)
  const int diag_off = 2 * t - 16 * (warp & 3) - g;

  // accumulator fragment: d[4i + e] holds row (e < 2 ? row0 : row1), column
  // 8i + 2t + (e & 1) of the warpgroup's 64 x 64 tile; O's column block cb
  // is o[cb], columns 64 cb ..
  float o[kCols][32];
#pragma unroll
  for (int cb = 0; cb < kCols; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  mbar_wait(smem_u32(&bar_q), 0);

  for (int j = 0; j < n_mine; ++j) {
    const int s = j % kStagesBf16;
    const uint64_t dks = dk + 2 * s * (kTileBytes >> 4), dvs = dks + (kTileBytes >> 4);
    mbar_wait(smem_u32(&bar_full[s]), (j / kStagesBf16) & 1);
    __syncwarp();  // the warp converged again for the .aligned wgmma instructions

    // S = Q K^T: bf16 x bf16 (fp16 x fp16) is exact in fp32; 32 bytes a
    // k-step, the next column block every 4
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(sc, dq + (kk / 4) * (kQBlock >> 4) + 2 * (kk % 4),
                  dks + (kk / 4) * (kKVBlock >> 4) + 2 * (kk % 4), kk);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // the causal mask on the diagonal tile (a key after the query is -inf
    // before the max: its weight is an exact 0), then the row max over the quad
    if (j == n_mine - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * i + (e & 1) - 8 * (e >> 1) + diag_off > 0) sc[4 * i + e] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    // key 64 j <= every row here, so the new maxima are finite;
    // exp(x * scale) = 2^(x c), and 2^-inf is an exact 0
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float r0 = exp2_approx((m0 - n0) * c), r1 = exp2_approx((m1 - n1) * c);  // 0 at first
    m0 = n0;
    m1 = n1;
    const float c0 = -m0 * c, c1 = -m1 * c;
    l0 *= r0;
    l1 *= r1;
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[cb][4 * i] *= r0;
        o[cb][4 * i + 1] *= r0;
        o[cb][4 * i + 2] *= r1;
        o[cb][4 * i + 3] *= r1;
      }
      fence_regs(o[cb]);
    }

    // O += P V, k-step by k-step as its P is ready, so that the tensor cores
    // run the first k-steps while the later exps are taken.  P in two 16-bit
    // pieces, hi = T(P) and lo = T(P - hi), the small piece first: k-step
    // kk (keys 16 kk ..) takes accumulator pairs 8 kk + 2 r, 8 kk + 2 r + 1 as
    // its A register r, no shuffle; V as stored, (keys, D), is the MN-major B,
    // one m64n64k16 product a column block of V
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * kk + r;
        const float cc = (i & 1) ? c1 : c0;
        const float a = exp2_approx(fmaf(sc[2 * i], c, cc));
        const float b = exp2_approx(fmaf(sc[2 * i + 1], c, cc));
        if (i & 1) {
          l1 += a + b;
        } else {
          l0 += a + b;
        }
        p_hi[i] = E::pack(a, b);
        p_lo[i] = E::pack(a - E::lo(p_hi[i]), b - E::hi(p_hi[i]));
        asm volatile("" : "+r"(p_hi[i]), "+r"(p_lo[i])::"memory");
      }
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < kCols; ++cb) {  // 2048 bytes a k-step
        wgmma_rs<E>(o[cb], p_lo + 4 * kk, dvs + cb * (kKVBlock >> 4) + 128 * kk);
        wgmma_rs<E>(o[cb], p_hi + 4 * kk, dvs + cb * (kKVBlock >> 4) + 128 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) fence_regs(o[cb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bar_empty[s]));  // this warp is done with the stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  typename E::T* ob = out + (size_t)bh * seq * D;
#pragma unroll
  for (int cb = 0; cb < kCols; ++cb) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // rounded to T once
      const int col = 64 * cb + 8 * i + 2 * t;
      if (row0 < seq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * D + col) =
            E::pack(o[cb][4 * i] * inv0, o[cb][4 * i + 1] * inv0);
      if (row1 < seq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * D + col) =
            E::pack(o[cb][4 * i + 2] * inv1, o[cb][4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled looked up through the runtime's entry-point query
// (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (bh, seq, d) 16-bit values of `type` as a 3-D tensor map in boxes of
// `rows` rows of 64 columns (128 bytes: one span of the 128-byte swizzle; a
// 128-wide row is two boxes), rows past seq read as zeros.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int bh, int seq, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)(kSpanBytes / 2), (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class E, int D>
int launch_attention16(const typename E::T* q, const typename E::T* k, const typename E::T* v,
                       typename E::T* out, int bh, int seq, float scale, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(encode, &tm_q, E::kMapType, q, bh, seq, D, kBlockRows) ||
      !tensor_map(encode, &tm_k, E::kMapType, k, bh, seq, D, 64) ||
      !tensor_map(encode, &tm_v, E::kMapType, v, bh, seq, D, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = Tiles16<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_16_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + kBlockRows - 1) / kBlockRows);
  flash_attention_16_kernel<E, D><<<grid, kBf16Threads, kSmem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, out, seq, scale * kLog2e);
  return (int)cudaGetLastError();
}

// The head dims with a kernel: 64 and 128; any other launches nothing.
bool head_dim_taken(int head_dim) { return head_dim == 64 || head_dim == 128; }

}  // namespace

extern "C" {

// q, k, v, out: (bh, seq, head_dim) fp32, contiguous, 16-byte aligned;
// head_dim 64 or 128 (else cudaErrorInvalidValue, nothing launched); scale:
// the caller's fp32 head_dim^-0.5.
int flash_attention_f32(const float* q, const float* k, const float* v, float* out, int bh,
                        int seq, int head_dim, float scale, void* stream) {
  if (!head_dim_taken(head_dim)) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  return head_dim == 64 ? launch_attention<64>(q, k, v, out, bh, seq, scale, stream)
                        : launch_attention<128>(q, k, v, out, bh, seq, scale, stream);
}

// q, k, v, out: (bh, seq, head_dim) bf16, contiguous, 16-byte aligned; the
// rest as flash_attention_f32.
int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* out, int bh, int seq, int head_dim, float scale,
                         void* stream) {
  if (!head_dim_taken(head_dim)) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  return head_dim == 64 ? launch_attention16<Bf16, 64>(q, k, v, out, bh, seq, scale, stream)
                        : launch_attention16<Bf16, 128>(q, k, v, out, bh, seq, scale, stream);
}

// q, k, v, out: (bh, seq, head_dim) fp16, contiguous, 16-byte aligned; the
// rest as flash_attention_f32.
int flash_attention_f16(const __half* q, const __half* k, const __half* v, __half* out, int bh,
                        int seq, int head_dim, float scale, void* stream) {
  if (!head_dim_taken(head_dim)) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  return head_dim == 64 ? launch_attention16<F16, 64>(q, k, v, out, bh, seq, scale, stream)
                        : launch_attention16<F16, 128>(q, k, v, out, bh, seq, scale, stream);
}

}  // extern "C"
