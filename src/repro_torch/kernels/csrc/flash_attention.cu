// Blockwise causal softmax attention, forward only (inference prefill):
//   out[b, i, :] = sum_{j <= i} softmax_j(q[b,i,:] . k[b,j,:] * D^-0.5) v[b,j,:]
// over fused head-batches q, k, v, out: (B*H, S, D) fp32, bf16 or fp16, any
// head dim D >= 1: each dtype has a kernel of its own at D 64 (GPT-2,
// granite, stablelm, seamless, mamba2) and at D 128 (yi-9b, command-r,
// llama4, internvl2, jamba, moonshot), and one for every other D
// (flash_attention_anyd_kernel, at the end: phi-2's 80, Phi-3's 96,
// Gemma's 256, ...); D < 1 launches nothing.
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
// Design (fp32, D = 64: flash_attention_kernel).  A block owns 64 query
// rows of one head-batch: 4 warps of 16 rows, each warp one m16n8k8 row
// tile; blocks are launched with the query
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
// fp32 at D = 128: a kernel of its own for Hopper,
// flash_attention_f32_d128_kernel, on TF32 warpgroup products (wgmma: on
// Hopper only these reach the 495 TFLOP/s; mma.sync, which the D = 64 kernel
// issues warp by warp, does not).  Bound: 3 * 2 * S^2 * D * B*H / 2
// operations on 495 TFLOP/s (3xTF32 as above), 156.2 us at B*H = 96, S = 1024,
// 53.3 ms at yi-9b's prefill_32k (32, 32 768, 128).  The design before it
// (the D = 64 kernel widened: 32-key tiles, q's tile in shared memory and
// re-split each k-step pair, every K and V value split by each of 4 warps)
// ran at 31 %; clocked, its warps spent 3 600 + 3 030 cycles a 32-key tile
// in Q K^T and P V on synchronous products, two warps a scheduler, and the
// splits ~11 % of its time (PERF.md section 6).
//   The card's constraints for fp32 at D = 128:
//   * TF32 wgmma (m64nNk8): a k-step is 8 values, 32 bytes; A from registers
//     or shared memory, B from shared memory, and both shared-memory
//     operands K-major (TF32 has no transpose).  Q and K as stored are
//     K-major; V as stored, (keys, D), is MN-major, so P V's B is V^T (keys
//     along k), which someone lays out.
//   * A 512-byte fp32 row is four 128-byte swizzle spans: a tile is four TMA
//     boxes, and a K-major descriptor steps to the next column block every
//     4 k-steps.
//   * The tensor core reads an fp32 operand's top 19 bits: a tile as landed
//     is its own big part, truncated.  Truncated, small is up to 2^-10 |x|
//     (rounded: 2^-11), and the CPU model misses the bound at (3, 96, 128)
//     with q, k x4 where rounding holds (test_torch_fp32_d128_designs.py),
//     so big is rounded as at D = 64 and K and V get tiles of their own.
//   * 227 KB of shared memory a block, read at 128 bytes a cycle; an RS
//     m64nNk8 (A from registers) reads N * 32 bytes of B in N / 2 tensor
//     cycles, half that rate; 255 registers a thread, O 64 of them.
//   The design:
//   * Persistent, as flash_attention_16_d128_kernel: one block an SM walks
//     (head-batch, 128 query rows) items longest first (d128_slot); 384
//     threads, a producer warpgroup at 56 registers and two consumer
//     warpgroups of 64 rows at 224 (setmaxnreg; 128 * 56 + 256 * 224 =
//     64 512).  64-key tiles: consumer w takes tiles 0 .. its diagonal.
//   * Every value is split once a block.  The consumers hold Q's and P's A
//     fragments in registers and split them there (Q two k-steps at a time
//     from its landed tile, into two register sets the products read in
//     turn; P as the softmax leaves it, each k-step's fragment the
//     accumulators in place).  The producer's first thread loads Q (a 32 KB
//     half a consumer) and each K and V tile by TMA into one landing
//     buffer, K and V in turn; all 128 producer threads split each landed
//     K tile into K's big and small tiles (same layout) and transpose each
//     V tile into V^T's big and small tiles (row d, k position p of k-step
//     kk holding key 8 kk + 2p for p < 4 and 8 kk + 2 (p - 4) + 1 after:
//     the order in which P's fragment takes the keys).
//   * S = Q K^T in 16 k-steps of three m64n64k8 (RS): Q's small part times
//     K's big and Q's big times K's small into one accumulator, big times
//     big into another, added once; O += P V in 8 k-steps of three
//     m64n128k8 (RS), the small terms first.  The scale is in the exponent
//     (2^(s c - m c)).
//   * One stage each of K's two tiles and V^T's two tiles: the consumers
//     take Q K^T and P V in turn, and the producer refills the one while
//     they run the other.  Every consumer warp releases every tile, used or
//     not, so that no single-stage barrier runs a phase ahead of a
//     warpgroup.  O goes out from registers (rows past seq not written).
//   Budget.  Shared memory: Q 64 KB, K's tiles 64 KB, the landing buffer 32
//   KB, V^T's tiles 64 KB: 224 KB and 1 KB of alignment.  Its traffic a
//   64-key tile for both consumers: wgmma 384 KB, Q's fragment loads 64 KB,
//   the producer's splits 192 KB (K and V: 32 read, 64 written each) and
//   the TMA's writes 64 KB, 704 KB against the 6 144 tensor cycles of the
//   tile's products at 128 bytes a cycle: 92 % of the rate, were the tensor
//   cores never idle.  Times, the clocked phases and the parts tried:
//   PERF.md section 6, from tools/kernel_probe.py.

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
//   D = 128: a kernel of its own for Hopper, flash_attention_16_d128_kernel<E>,
//   replacing src/repro/kernels/flash_attention.py flash_attention_pallas at
//   that head dim in bf16 and fp16 (the kernel above takes D = 64 only).
//   Bound: Q K^T one 16-bit product and P V two, 3 * 2 * S^2 * D * B*H / 2
//   operations on 989 TFLOP/s: 39.1 us at B*H = 96, S = 1024, 13.3 ms at
//   yi-9b's prefill_32k (32, 32 768, 128).  A first design (the D = 64
//   kernel widened: 64-key tiles, 288 threads, a block of 128 query rows a
//   grid cell) ran at 38 % of it: each warpgroup took Q K^T, the softmax and
//   P V of a tile in series, and 768 blocks of 1-16 tiles each paid their
//   own set-up, Q load and epilogue.  What this kernel takes:
//   * Wider products on 128-key tiles: Q K^T as eight m64n128k16 (A and B from
//     shared memory: 6 KB in 64 tensor cycles, 75 % of the shared-memory
//     rate, where m64n64k16's 4 KB in 32 took all of it), and each P piece as
//     one m64n128k16 a k-step over both column blocks of V (the MN-major
//     descriptor's leading byte offset is the 16 KB to block 1); the row max
//     and the rescale come once per 128 keys.
//   * setmaxnreg: 384 threads, a producer warpgroup that keeps 40 registers
//     (two of its threads issue TMA: K and V, and Q) and two consumer warpgroups
//     that take 232 (128 * 40 + 256 * 232 = 64 512 of 65 536), so that O
//     (64 a thread), a tile's scores (64) and P's two pieces (64) live at once.
//   * Within a warpgroup: tile j's Q K^T and tile j - 1's P V are issued
//     together; wgmma.wait_group 1 returns with the scores, and tile j's
//     softmax runs while P V still does.  The two consumer warpgroups issue
//     as they are ready, with no order between them.
//   * Persistent: one block an SM walks (head-batch, query tile of 128 rows)
//     items longest first, in a static order (rounds of G items, forwards and
//     backwards in turn); K/V flow on from one item into the next; Q in two
//     buffers, each loaded by its own producer thread as soon as the O store
//     of the item two back has read it; O rounded once, written over its
//     warpgroup's rows of the item's Q buffer in the swizzle and stored by one
//     TMA store (two boxes) a warpgroup.
//   Shared memory: 2 Q buffers, 2 K stages and 3 V stages of 32 KB (a V tile
//   is read a step after its K tile) = 225 KB with the 1 KB alignment: one
//   block an SM.  ptxas: 168 registers at launch (the 384 threads' share),
//   40 / 232 after setmaxnreg, no spills, no wgmma serialisation
//   (chip_smoke.py prints both and fails on a serialised wgmma).  Tried and
//   not taken, each timed in turns against the kernel with it: the two
//   consumers taking turns at issuing their products (named barriers, so
//   that one's softmax runs beside the other's products) and O's rescale
//   skipped where no row of a warp grew its max (__all_sync; the factor is
//   then 2^0 = 1, no bit changes), neither faster beyond the spread; P V as
//   two m64n64k16 a piece, one a column block of V, no faster; the items as
//   one stream of steps, an item's first Q K^T issued with the last P V of
//   the item before, slower; Q K^T of warpgroup 0's diagonal tile on keys
//   0-63 only (an m64n64k16 into half the fragment made ptxas serialise
//   every wgmma of the kernel).  Times, the parts' costs and the clocked
//   phases: PERF.md section 6, from tools/kernel_probe.py.

// fp16 q, k, v (flash_attention_f16) run the same kernels,
// flash_attention_16_kernel<E> (D = 64) and flash_attention_16_d128_kernel<E>,
// with E = F16: wgmma .f32.f16.f16, tensor maps of fp16, and P in two fp16
// pieces (cvt.rn.f16x2.f32).  An fp16 value has 11 significant bits and 5
// exponent bits, so it is exact in TF32 and fp32, and the product of two is exact in fp32: Q K^T stays exact as in
// bf16.  P is in [0, 1]: hi = fp16(P) keeps 11 bits (one piece misses the
// check by far, as bf16's does), lo = fp16(P - hi) the next 11, down to
// fp16's subnormal step 2^-24, below which a weight is dropped (at most
// 2^-25 a key, S 2^-25 max|v| in all, half the check's bound).  The output
// is rounded to fp16 once.
//
// Any other head dim (flash_attention_anyd_kernel<E, DP, kChunked>, fp32,
// bf16 and fp16), replacing flash_attention_pallas at every D but 64 and 128:
// the reference's blocks span the full D, so it takes any.  Bound, as above:
// operations, 3 * 2 * S^2 * D * B*H / 2 at the TF32 rate (fp32), (1 + 2) *
// S^2 * D * B*H at the 16-bit rate (bf16, fp16): at B*H = 96, S = 1024, 97.6
// / 24.4 us at D 80, 117 / 29.3 at D 96, 312 / 78.2 at D 256.  A simple design
// on mma.sync, as the fp32 kernel at D = 64, one instance a padded width:
//   * D is padded to DP, D rounded up to a multiple of 32 (eight instances
//     up to 256 a dtype, from 32 on); a D past 256 takes the DP = 256
//     instance with kChunked: output columns in chunks of 256 on the grid's
//     third axis, each chunk's block computing the scores over all of D in
//     pieces of 256 staged through shared memory (ceil(D / 256) times the
//     Q K^T work).  Columns D .. DP of Q and K (and of V) are zeroed in shared
//     memory, so they add exact zeros to every score; V's give output columns
//     that are never stored, and whose products are skipped 16 columns at a
//     time; Q K^T stops at D rounded up to 16.  Rows past the sequence are
//     zeros.
//   * A block owns 64 query rows of one head-batch, 4 warps of 16 rows; the
//     query tiles that see the most keys launch first.  Q is staged once
//     into shared memory (a chunked block re-stages its pieces each key
//     tile); K and V arrive in tiles of 64 keys (32 where 64 would leave one
//     block an SM: fp32 from DP 96 on, 16-bit from DP 192 on), two stages
//     (one when chunked).  A row of D elements is 16-byte aligned only when
//     D * 4 (D * 2) is a multiple of 16, so neither TMA (strides of 16
//     bytes) nor the 16-byte cp.async of the D = 64 kernel can load every
//     row: each load is the widest that the row's bytes allow, 16, 8 or 4
//     bytes by cp.async (zero-filled past the sequence) and 2 by plain loads
//     (a 16-bit row of odd D), chosen at launch.
//   * fp32: 3xTF32 m16n8k8 as the D = 64 kernel (Q's and K's fragments read
//     as 16-byte loads in its k-step-pair order, P's from the accumulators
//     in place); Q's fragments come from shared memory at every k-step pair
//     and are split there (at DP 256 the output accumulator alone holds 128
//     registers a thread: Q's split parts cannot stay).  bf16 / fp16:
//     m16n8k16 with Q's and K's fragments and V's transposed ones by
//     ldmatrix, Q K^T exact in fp32, P in two 16-bit pieces (the small one
//     first), the output rounded once.  Rows padded so that every fragment
//     load of a warp hits distinct banks: fp32 Q and K rows of DP + 16
//     floats, V rows of DP + 4; 16-bit rows of DP + 8.
//   * The scale is in the exponent (2^(s c - m c), c = scale * log2(e)): D^-0.5
//     is exact only at D = 4^n.  The online softmax and the causal mask are
//     the D = 128 kernels' (online_softmax); a warp takes key tiles 0 .. its
//     own diagonal.
//   Registers, shared memory and times: PERF.md section 6 (chip_smoke.py's
//   [build] line prints ptxas's report of each instance and fails on a
//   spill).
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

// The fp32 kernel's tiles at head dim 64: 64-key tiles, q's split fragments
// in registers for the whole block.
struct Tiles32 {
  static constexpr int kD = 64;      // head dim
  static constexpr int kKeys = 64;   // keys per staged tile
  // shared-memory rows padded (in floats) so that a warp's fragment loads hit
  // distinct banks: K's for 16-byte loads, V's for 4-byte loads
  static constexpr int kStrideK = kD + 16;
  static constexpr int kStrideV = kD + 4;
  static constexpr int kTileK = kKeys * kStrideK;  // floats of one staged K or V tile
  static constexpr int kTileV = kKeys * kStrideV;
  static constexpr int kStage = kTileK + kTileV;
  static constexpr int kSmemBytes = 2 * kStage * (int)sizeof(float);  // 2 stages of K and V
  static_assert(kRows == kKeys, "a block's query tile is one key tile");
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

__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int seq,
                           float scale) {
  using T = Tiles32;
  constexpr int D = T::kD;
  constexpr int kKeys = T::kKeys, kStrideK = T::kStrideK, kStrideV = T::kStrideV;
  constexpr int kTileK = T::kTileK, kStage = T::kStage;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // stage s: K, then V, at s * kStage

  const int n_qt = (seq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kRows;  // the longest query tiles first
  const size_t base = (size_t)blockIdx.x * seq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and lane in the quad
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const int n_kt = q0 / kKeys + kRows / kKeys;  // key tiles 0 .. the block's last row
  // exp(x * scale) = 2^(x c): q is scaled by 2^-3 first (exact) and c = log2(e)
  const float c = kLog2e;

  // the q tile through stage 1's K buffer, beside key tile 0 in stage 0
  stage<D, kKeys, kStrideK>(smem, k + base, 0, seq);
  stage<D, kKeys, kStrideV>(smem + kTileK, v + base, 0, seq);
  stage<D, kRows, kStrideK>(smem + kStage, q + base, q0, seq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // A fragments of the scaled q, big and small.  The sum over D is taken in
  // another order inside each pair of k-steps (2m, 2m + 1): A column t holds
  // d = 16m + 4t + 2h of k-step 2m + h, column t + 4 the next d, and K's B
  // fragments follow, so that a lane reads its four K values as one float4.
  uint32_t qb[D / 8][4], qs[D / 8][4];
  {
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
    // the block's last key tile takes the causal mask
    const bool diag = it == n_kt - 1;

    // S = (q * scale) k^T, 16 rows x kKeys keys a warp: the key n-tiles are
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
        mma3(s[j], qb[2 * m], qs[2 * m], kr.x, kr.y);
        mma3(s[j], qb[2 * m + 1], qs[2 * m + 1], kr.z, kr.w);
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

int launch_attention(const float* q, const float* k, const float* v, float* out, int bh, int seq,
                     float scale, void* stream) {
  constexpr int kSmemBytes = Tiles32::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + kRows - 1) / kRows);
  flash_attention_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(q, k, v, out, seq,
                                                                               scale);
  return (int)cudaGetLastError();
}

// ---- bf16 and fp16: both products on 16-bit wgmma, K and V fed by TMA -------

constexpr int kConsumers = 2;                    // warpgroups of 64 query rows
constexpr int kBlockRows = 64 * kConsumers;      // query rows a block
constexpr int kBf16Threads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kStagesBf16 = 4;                   // K/V tiles in flight
constexpr int kSpanBytes = 128;                  // a row of one swizzle span: 64 16-bit columns
// The D = 64 kernel's tiles: a row is one swizzle span
constexpr int kD64TileBytes = 64 * 64 * 2;       // 64 rows of K or V
constexpr int kD64Smem = 1024 + kBlockRows * 64 * 2 + kStagesBf16 * 2 * kD64TileBytes;  // + alignment

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
// wait until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

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

// A block owns kBlockRows query rows of one head-batch at D = 64; warpgroup
// w of its consumers owns rows q0 + 64 w ...; the producer warp's lane 0
// loads Q and then K/V tiles 0 .. the last consumer's diagonal through a
// ring of kStagesBf16 stages (full: TMA bytes landed; empty: the consumers'
// 8 warps are done with it).  c = scale * log2(e).  E: Bf16 or F16.
template <class E>
__global__ void __launch_bounds__(kBf16Threads, 2)
    flash_attention_16_kernel(__grid_constant__ const CUtensorMap tm_q,
                              __grid_constant__ const CUtensorMap tm_k,
                              __grid_constant__ const CUtensorMap tm_v,
                              typename E::T* __restrict__ out, int seq, float c) {
  constexpr int kTileBytes = kD64TileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[kStagesBf16], bar_empty[kStagesBf16];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t s_kv = s_q + kBlockRows * 64 * 2;  // stage s: K at s_kv + 2 s kTileBytes, then V

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
      mbar_expect_tx(smem_u32(&bar_q), kBlockRows * 64 * 2);
      tma_load(s_q, &tm_q, 0, q0, bh, smem_u32(&bar_q));
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStagesBf16;
        // a stage is reused once every consumer that reads tile j - stages is done
        // with it; tiles past a consumer's diagonal are never reused
        if (j >= kStagesBf16) mbar_wait(smem_u32(&bar_empty[s]), (j / kStagesBf16 - 1) & 1);
        const uint32_t bar = smem_u32(&bar_full[s]), k_dst = s_kv + 2 * s * kTileBytes;
        mbar_expect_tx(bar, 2 * kTileBytes);
        tma_load(k_dst, &tm_k, 0, 64 * j, bh, bar);
        tma_load(k_dst + kTileBytes, &tm_v, 0, 64 * j, bh, bar);
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
  // 8i + 2t + (e & 1) of the warpgroup's 64 x 64 tile
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  mbar_wait(smem_u32(&bar_q), 0);

  for (int j = 0; j < n_mine; ++j) {
    const int s = j % kStagesBf16;
    const uint64_t dks = dk + 2 * s * (kTileBytes >> 4), dvs = dks + (kTileBytes >> 4);
    mbar_wait(smem_u32(&bar_full[s]), (j / kStagesBf16) & 1);
    __syncwarp();  // the warp converged again for the .aligned wgmma instructions

    // S = Q K^T: bf16 x bf16 (fp16 x fp16) is exact in fp32; 32 bytes a k-step
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<E>(sc, dq + 2 * kk, dks + 2 * kk, kk);
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
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= r0;
      o[4 * i + 1] *= r0;
      o[4 * i + 2] *= r1;
      o[4 * i + 3] *= r1;
    }
    fence_regs(o);

    // O += P V, k-step by k-step as its P is ready, so that the tensor cores
    // run the first k-steps while the later exps are taken.  P in two 16-bit
    // pieces, hi = T(P) and lo = T(P - hi), the small piece first: k-step
    // kk (keys 16 kk ..) takes accumulator pairs 8 kk + 2 r, 8 kk + 2 r + 1 as
    // its A register r, no shuffle; V as stored, (keys, D), is the MN-major B
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
      wgmma_fence();  // 2048 bytes a k-step
      wgmma_rs<E>(o, p_lo + 4 * kk, dvs + 128 * kk);
      wgmma_rs<E>(o, p_hi + 4 * kk, dvs + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bar_empty[s]));  // this warp is done with the stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  typename E::T* ob = out + (size_t)bh * seq * 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // rounded to T once
    const int col = 8 * i + 2 * t;
    if (row0 < seq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * 64 + col) =
          E::pack(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (row1 < seq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * 64 + col) =
          E::pack(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

// ---- bf16 and fp16 at D = 128: persistent, 128-key tiles, setmaxnreg -------

constexpr int kD128Keys = 128;                           // keys a K/V tile
constexpr int kD128TileBytes = kD128Keys * 128 * 2;      // a K or V tile, 32 KB
constexpr int kD128QBytes = kBlockRows * 128 * 2;        // a Q buffer (then the item's O), 32 KB
// Q buffers, and K and V tiles in flight: a V tile is read a step after its
// K tile, so V's ring is the deeper one
constexpr int kD128QBuffers = 2, kD128KStages = 2, kD128VStages = 3;
static_assert(kD128QBytes == kD128TileBytes, "Q buffers and K/V stages are laid out alike");
constexpr int kD128Smem =
    1024 + (kD128QBuffers + kD128KStages + kD128VStages) * kD128TileBytes;  // 225 KB with the alignment
// two consumer warpgroups and a producer warpgroup (two threads of which load),
// the registers moved from the producer to the consumers by setmaxnreg:
// 128 * 40 + 256 * 232 = 64 512 of the SM's 65 536
constexpr int kD128Threads = 128 * (kConsumers + 1);
constexpr int kD128ProducerRegs = 40, kD128ConsumerRegs = 232;

// d (+)= A B, one m64n128k16 product: A (64 x 16) and B (128 x 16, K-major)
// from shared memory; scale_d = 0 overwrites d.
#define WGMMA_SS128(TYPE)                                                                 \
  asm volatile(                                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "                     \
      "{" WGMMA_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                  \
      WGMMA_D64 : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// d += A B, one m64n128k16 product with A from registers (the accumulator
// fragment layout) and B (16 x 128, MN-major) from shared memory.
#define WGMMA_RS128(TYPE)                                                                 \
  asm volatile(                                                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "                     \
      "{" WGMMA_REGS64 "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"                       \
      WGMMA_D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b))
#define WGMMA_REGS64                                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_D64                                                                                   \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),     \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),           \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
    "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),         \
    "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),         \
    "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),         \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),         \
    "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

template <class E>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  if constexpr (std::is_same<E, F16>::value) {
    WGMMA_SS128("f16");
  } else {
    WGMMA_SS128("bf16");
  }
}

template <class E>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  if constexpr (std::is_same<E, F16>::value) {
    WGMMA_RS128("f16");
  } else {
    WGMMA_RS128("bf16");
  }
}

// sw128_desc with the leading byte offset `lbo`: for an MN-major B wider than
// one swizzle span, the distance from its 64 columns (N) to the next 64
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr, uint32_t lbo) {
  return (sw128_desc(addr) & ~((uint64_t)0x3fff << 16)) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One box of shared memory out to a 3-D tensor map at (col, row, bh); rows
// past the map's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row,
                                          int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"((uint64_t)map), "r"(src), "r"(col), "r"(row), "r"(bh)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// this thread's bulk stores have read their shared memory (read) or are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// order this thread's shared-memory accesses with the async proxy's (TMA, wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t value) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(value) : "memory");
}

// The persistent grid's schedule.  Item i of n_bh * n_qt is query tile
// n_qt - 1 - i / n_bh (of kBlockRows rows) of head-batch i % n_bh: the
// longest first.  Block b of G takes item slot(r, b, G) in round r, rounds
// running forwards and backwards in turn, so that each block's sum of
// tiles stays near the mean.
__device__ __forceinline__ int d128_slot(int r, int b, int G) {
  return r * G + ((r & 1) ? G - 1 - b : b);
}

// S = Q K^T over one 128-key tile: eight m64n128k16 products, 32 bytes a
// k-step, the next column block every 4; exact 16-bit products summed in fp32
template <class E>
__device__ __forceinline__ void qk_d128(float (&sc)[64], uint64_t dq, uint64_t dk) {
  constexpr int kBlock = (kD128Keys * kSpanBytes) >> 4;  // a column block, in descriptor units
  static_assert(kBlockRows == kD128Keys, "Q's and K's column blocks step alike");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss128<E>(sc, dq + (kk / 4) * kBlock + 2 * (kk % 4), dk + (kk / 4) * kBlock + 2 * (kk % 4), kk);
  wgmma_commit();
}

// O += P V over one 128-key tile: P in two 16-bit pieces, the small piece
// first at each k-step; k-step kk (keys 16 kk ..) takes A registers 4 kk ..
// of each piece, and V as stored is the MN-major B (2048 bytes a k-step),
// one m64n128k16 over both column blocks
template <class E>
__device__ __forceinline__ void pv_d128(float (&o)[64], const uint32_t (&p_hi)[32],
                                        const uint32_t (&p_lo)[32], uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs128<E>(o, p_lo + 4 * kk, dv + 128 * kk);
    wgmma_rs128<E>(o, p_hi + 4 * kk, dv + 128 * kk);
  }
  wgmma_commit();
}

// The online softmax of one tile's N / 8 x 8 scores a warpgroup row pair, in
// place.  The accumulator fragment: sc[4x + e] holds row wrow + 8 (e >> 1) of
// the query tile, key 8x + 2t + (e & 1) of the tile.  On the diagonal tile a key after the query
// is -inf before the max (its weight an exact 0); the row max over the quad;
// r = 2^((m - new m) c), the factor that takes O and l to the new max; then
// each score becomes 2^(s c - m c), summed into l.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], bool diag, int diag_off, float c,
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& r0, float& r1) {
  if (diag) {
#pragma unroll
    for (int x = 0; x < N / 4; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * x + (e & 1) - 8 * (e >> 1) + diag_off > 0) sc[4 * x + e] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int x = 0; x < N / 4; ++x) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * x], sc[4 * x + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * x + 2], sc[4 * x + 3]));
  }
  // the tile's first key is at or before every row, so the new maxima are
  // finite; 2^-inf is an exact 0 (the first tile's r)
  const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
  r0 = exp2_approx((m0 - n0) * c);
  r1 = exp2_approx((m1 - n1) * c);
  m0 = n0;
  m1 = n1;
  const float c0 = -m0 * c, c1 = -m1 * c;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int x = 0; x < N / 4; ++x) {
    sc[4 * x] = exp2_approx(fmaf(sc[4 * x], c, c0));
    sc[4 * x + 1] = exp2_approx(fmaf(sc[4 * x + 1], c, c0));
    sc[4 * x + 2] = exp2_approx(fmaf(sc[4 * x + 2], c, c1));
    sc[4 * x + 3] = exp2_approx(fmaf(sc[4 * x + 3], c, c1));
    s0 += sc[4 * x] + sc[4 * x + 1];
    s1 += sc[4 * x + 2] + sc[4 * x + 3];
  }
  l0 = l0 * r0 + s0;
  l1 = l1 * r1 + s1;
}

// P in two 16-bit pieces, hi = T(P) and lo = T(P - hi): A register q of
// k-step kk is the accumulator pair 8 kk + 2 q, 8 kk + 2 q + 1, packed (no shuffle)
template <class E>
__device__ __forceinline__ void split_p(const float (&sc)[64], uint32_t (&p_hi)[32], uint32_t (&p_lo)[32]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    p_hi[x] = E::pack(sc[2 * x], sc[2 * x + 1]);
    p_lo[x] = E::pack(sc[2 * x] - E::lo(p_hi[x]), sc[2 * x + 1] - E::hi(p_hi[x]));
  }
}

// O *= r row by row (accumulator d[4x + e]: row 0 for e < 2)
__device__ __forceinline__ void rescale_o(float (&o)[64], float r0, float r1) {
#pragma unroll
  for (int x = 0; x < 64; ++x) o[x] *= (x & 2) ? r1 : r0;
}

// O / l rounded to T once, written over this warpgroup's rows of the item's
// Q buffer at `ob` (no wgmma reads them any more) in the 128-byte swizzle
// (16-byte chunk x % 8 of row wrow at chunk (x % 8) ^ (wrow % 8)), then
// stored by the warpgroup's first thread as two TMA boxes of 64 x 64 (rows
// past seq are not written)
template <class E>
__device__ __forceinline__ void store_o(const float (&o)[64], float l0, float l1, uint32_t ob,
                                       const CUtensorMap* tm_o, int wg, int wrow, int t, int row0,
                                       int bh, bool leader) {
  constexpr int kQBlock = kBlockRows * kSpanBytes;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  fence_proxy_async();
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const uint32_t at = ob + (x / 8) * kQBlock + wrow * kSpanBytes + (((x % 8) ^ (wrow % 8)) << 4) + 4 * t;
    st_shared(at, E::pack(o[4 * x] * inv0, o[4 * x + 1] * inv0));
    st_shared(at + 8 * kSpanBytes, E::pack(o[4 * x + 2] * inv1, o[4 * x + 3] * inv1));
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (leader) {
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
      tma_store(tm_o, ob + cb * kQBlock + wg * 64 * kSpanBytes, 64 * cb, row0 + 64 * wg, bh);
    bulk_commit();
  }
}

// Each block: a producer warpgroup, whose first warp's lane 0 loads each
// item's K/V tiles 0 .. the diagonal through rings of kD128KStages and
// kD128VStages stages, K one tile ahead of V (K is released after Q K^T, V
// after P V), and whose second warp's lane 0 loads each item's Q
// into kD128QBuffers buffers as soon as one is free; and two consumer
// warpgroups of 64 query rows.  For each tile after an item's first, a
// consumer issues the tile's Q K^T with the P V of the tile before, then
// takes the tile's softmax while that P V runs; an item's O goes out through
// its Q buffer and a TMA store.  c = scale * log2(e).
template <class E>
__global__ void __launch_bounds__(kD128Threads, 1)
    flash_attention_16_d128_kernel(__grid_constant__ const CUtensorMap tm_q,
                                   __grid_constant__ const CUtensorMap tm_k,
                                   __grid_constant__ const CUtensorMap tm_v,
                                   __grid_constant__ const CUtensorMap tm_o, int n_bh, int seq,
                                   float c) {
  constexpr int kQBlock = kBlockRows * kSpanBytes;  // bytes of one column block of a Q buffer
  constexpr int kKVBlock = kD128Keys * kSpanBytes;  // and of a K or V tile
  constexpr int kQB = kD128QBuffers, kSK = kD128KStages, kSV = kD128VStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qf[kQB], bar_qe[kQB], bar_kf[kSK], bar_ke[kSK], bar_vf[kSV],
      bar_ve[kSV];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q buffer qb at s_q + qb * kD128QBytes
  const uint32_t s_k = s_q + kQB * kD128QBytes;       // K stage s at s_k + s * kD128TileBytes
  const uint32_t s_v = s_k + kSK * kD128TileBytes;    // and V's at s_v + s * kD128TileBytes

  const int n_qt = (seq + kBlockRows - 1) / kBlockRows;
  const int items = n_bh * n_qt, grid = gridDim.x, blk = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQB; ++i) {
      mbar_init(smem_u32(&bar_qf[i]), 1);
      mbar_init(smem_u32(&bar_qe[i]), kConsumers);
    }
    for (int s = 0; s < kSK; ++s) {
      mbar_init(smem_u32(&bar_kf[s]), 1);
      mbar_init(smem_u32(&bar_ke[s]), 4 * kConsumers);
    }
    for (int s = 0; s < kSV; ++s) {
      mbar_init(smem_u32(&bar_vf[s]), 1);
      mbar_init(smem_u32(&bar_ve[s]), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kD128ProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      // K or V tile t of the block's sequence into stage t % stages of its
      // ring at `ring`, once the consumers are done with tile t - stages there
      auto load = [&](const CUtensorMap* map, uint64_t* full, uint64_t* empty, uint32_t ring, int stages,
                      int t, int key0, int bh) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(smem_u32(&empty[s]), ((t / stages) - 1) & 1);
        mbar_expect_tx(smem_u32(&full[s]), kD128TileBytes);
#pragma unroll
        for (int cb = 0; cb < 2; ++cb)
          tma_load(ring + s * kD128TileBytes + cb * kKVBlock, map, 64 * cb, key0, bh, smem_u32(&full[s]));
      };
      int g = 0;  // this block's K/V tiles so far
      for (int r = 0; r * grid < items; ++r) {
        const int i = d128_slot(r, blk, grid);
        if (i >= items) continue;
        const int bh = i % n_bh, qt = n_qt - 1 - i / n_bh;
        load(&tm_k, bar_kf, bar_ke, s_k, kSK, g, 0, bh);
        for (int j = 0; j <= qt; ++j) {
          if (j < qt) load(&tm_k, bar_kf, bar_ke, s_k, kSK, g + j + 1, kD128Keys * (j + 1), bh);
          load(&tm_v, bar_vf, bar_ve, s_v, kSV, g + j, kD128Keys * j, bh);
        }
        g += qt + 1;
      }
    } else if (warp == 4 * kConsumers + 1 && lane == 0) {  // Q, as soon as a buffer is free
      int n = 0;  // this block's items so far
      for (int r = 0; r * grid < items; ++r) {
        const int i = d128_slot(r, blk, grid);
        if (i >= items) continue;
        const int bh = i % n_bh, qt = n_qt - 1 - i / n_bh, qb = n % kQB;
        // a Q buffer is reused once both warpgroups' O stores of item n - kQB have read it
        if (n >= kQB) mbar_wait(smem_u32(&bar_qe[qb]), ((n / kQB) - 1) & 1);
        mbar_expect_tx(smem_u32(&bar_qf[qb]), kD128QBytes);
#pragma unroll
        for (int cb = 0; cb < 2; ++cb)
          tma_load(s_q + qb * kD128QBytes + cb * kQBlock, &tm_q, 64 * cb, kBlockRows * qt, bh,
                   smem_u32(&bar_qf[qb]));
        ++n;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kD128ConsumerRegs));

  // this consumer warpgroup, broadcast from lane 0 so that the compiler
  // keeps what derives from it (the wgmma descriptors) in uniform registers
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int t = lane & 3;                                    // lane in the quad
  const int wrow = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // the thread's first row in the query tile
  const int diag_off = 2 * t - wrow;  // key - row on the diagonal tile, less 8 x + (e & 1) - 8 (e >> 1)
  const bool leader = (threadIdx.x & 127) == 0;
  // the wgmma descriptors of this warpgroup's rows in Q buffer 0 at k-step 0,
  // of K's stage 0, and of V's stage 0 as one MN-major B of 128 columns
  const uint64_t dq0 = sw128_desc(s_q + wg * 64 * kSpanBytes), dk0 = sw128_desc(s_k);
  const uint64_t dv0 = sw128_desc_mn(s_v, kKVBlock);
  constexpr uint64_t kTile = kD128TileBytes >> 4;  // a tile, in descriptor units
  // K tile t of the block's sequence (or V's): full, then released by this warp
  auto wait_k = [&](int tile) { mbar_wait(smem_u32(&bar_kf[tile % kSK]), (tile / kSK) & 1); };
  auto wait_v = [&](int tile) { mbar_wait(smem_u32(&bar_vf[tile % kSV]), (tile / kSV) & 1); };
  auto release = [&](uint64_t* empty, int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[slot]));
  };

  int n = 0, g = 0;  // this block's items and K/V tiles so far
  int stored = -1;   // the Q buffer of an O store not yet known to have read it
  for (int r = 0; r * grid < items; ++r) {
    const int i = d128_slot(r, blk, grid);
    if (i >= items) continue;
    const int bh = i % n_bh, qt = n_qt - 1 - i / n_bh, qb = n % kQB;
    const uint64_t dq = dq0 + qb * (kD128QBytes >> 4);

    float o[64], sc[64];
    uint32_t p_hi[32], p_lo[32];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, r0, r1;
    mbar_wait(smem_u32(&bar_qf[qb]), (n / kQB) & 1);

    // tile 0: Q K^T alone, then its softmax and P
    wait_k(g);
    __syncwarp();  // the warp converged again for the .aligned wgmma instructions
    qk_d128<E>(sc, dq, dk0 + (g % kSK) * kTile);
    wgmma_wait<0>();
    fence_regs(sc);
    release(bar_ke, g % kSK);
    if (stored >= 0) {  // the item before's O store has read its Q buffer
      if (leader) {
        bulk_wait_read();
        mbar_arrive(smem_u32(&bar_qe[stored]));
      }
      stored = -1;
    }
    online_softmax(sc, qt == 0, diag_off, c, m0, m1, l0, l1, r0, r1);
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] = 0.0f;
    split_p<E>(sc, p_hi, p_lo);

    // tile j: Q K_j^T and P_{j-1} V_{j-1} issued together, tile j's softmax
    // while the latter runs, then P_j
    for (int j = 1; j <= qt; ++j) {
      const int tk = g + j, tv = g + j - 1;
      wait_k(tk);
      wait_v(tv);
      __syncwarp();
      qk_d128<E>(sc, dq, dk0 + (tk % kSK) * kTile);
      rescale_o(o, r0, r1);  // O to tile j - 1's max, before its P V
      fence_regs(o);
      pv_d128<E>(o, p_hi, p_lo, dv0 + (tv % kSV) * kTile);
      wgmma_wait<1>();  // Q K_j^T is done; P_{j-1} V_{j-1} may still run
      fence_regs(sc);
      release(bar_ke, tk % kSK);
      online_softmax(sc, j == qt, diag_off, c, m0, m1, l0, l1, r0, r1);
      wgmma_wait<0>();
      fence_regs(o);
      release(bar_ve, tv % kSV);
      split_p<E>(sc, p_hi, p_lo);
    }
    // the last tile's P V, and O out
    const int tv = g + qt;
    wait_v(tv);
    __syncwarp();
    rescale_o(o, r0, r1);
    fence_regs(o);
    pv_d128<E>(o, p_hi, p_lo, dv0 + (tv % kSV) * kTile);
    wgmma_wait<0>();
    fence_regs(o);
    release(bar_ve, tv % kSV);
    store_o<E>(o, l0, l1, s_q + qb * kD128QBytes, &tm_o, wg, wrow, t, kBlockRows * qt, bh, leader);
    stored = qb;
    g += qt + 1;
    ++n;
  }
  if (leader) bulk_wait();  // shared memory stays until the last stores are done
}

// ---- fp32 at D = 128: 3xTF32 on TF32 warpgroup products, persistent --------

constexpr int kF32Keys = 64;                        // keys a K/V tile
constexpr int kF32Block = 64 * kSpanBytes;          // a column block (32 fp32) of 64 rows: 8 KB
constexpr int kF32Tile = 4 * kF32Block;             // 64 rows of 128 fp32: 32 KB
constexpr int kF32VtBlock = 128 * kSpanBytes;       // a column block (32 keys) of V^T's 128 rows: 16 KB
static_assert(2 * kF32VtBlock == kF32Tile, "V^T of a 64-key tile is one tile's bytes");
// Q (a 32 KB half a consumer warpgroup), K's big and small parts, the
// landing buffer (K's and V's tiles in turn), V^T's big and small parts:
// 7 x 32 KB, with the 1 KB alignment 225 KB
constexpr int kF32Smem = 1024 + 7 * kF32Tile;
constexpr int kF32Threads = 128 * (kConsumers + 1);
// the producer warpgroup splits and transposes, so it keeps more than the
// 16-bit kernel's: 128 * 56 + 256 * 224 = 64 512 of the SM's 65 536
constexpr int kF32ProducerRegs = 56, kF32ConsumerRegs = 224;

// d (+)= A B, one m64n64k8 TF32 product: A (64 x 8) from registers, fp32
// values of which the tensor core reads the top 19 bits, in the fragment
// a0 (row g, column t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of
// each warp's 16 rows; B (64 x 8, K-major) from shared memory; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t* a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      WGMMA_D : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d += A B, one m64n128k8 TF32 product: A as above, B (128 x 8, K-major).
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" WGMMA_REGS64 "}, {%64, %65, %66, %67}, %68, 1, 1, 1;\n"
      WGMMA_D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// split (above) on the four values of a float4: big and small as floats
__device__ __forceinline__ void split4(float4 x, float4& big, float4& small) {
  uint32_t b[4], s[4];
  split(x.x, b[0], s[0]);
  split(x.y, b[1], s[1]);
  split(x.z, b[2], s[2]);
  split(x.w, b[3], s[3]);
  big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                    __uint_as_float(b[3]));
  small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                      __uint_as_float(s[3]));
}

// A consumer warpgroup's key tiles of the item whose 128 query rows start at
// q0: 0 .. its diagonal, none when its 64 rows lie past seq
__device__ __forceinline__ int f32_tiles(int q0, int wg, int seq) {
  return q0 + 64 * wg < seq ? (q0 + 64 * wg) / kF32Keys + 1 : 0;
}

// S = Q K^T over one 64-key tile in 3xTF32, 16 k-steps of 8 columns: the
// small terms (Q's small part times K's big, Q's big times K's small) summed
// into ss, big times big into sb.  Q's A fragment is read from its tile as
// TMA landed it (row wrow: 16-byte chunk (2 (kk % 4) + h) ^ g of column
// block kk / 4, word t) two k-steps at a time and split there, into two sets
// of registers the tensor cores read in turn.
__device__ __forceinline__ void qk_f32(float (&sb)[32], float (&ss)[32], const float* q_row, int g,
                                       uint64_t dk, uint64_t dks) {
  constexpr int kRow8 = 8 * kSpanBytes / 4;  // 8 rows on, in floats
  uint32_t qa[2][8], qs[2][8];  // [set][4 h + register]
#pragma unroll
  for (int p = 0; p < 8; ++p) {  // k-step pairs
    const int b = p & 1;
    if (p >= 2) wgmma_wait<1>();  // the pair before last is done with set b
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 2 * p + h;
      const float* at = q_row + (kk / 4) * (kF32Block / 4);
      const int c0 = ((2 * (kk % 4)) ^ g) << 2, c1 = ((2 * (kk % 4) + 1) ^ g) << 2;
      const float x[4] = {at[c0], at[c0 + kRow8], at[c1], at[c1 + kRow8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], qa[b][4 * h + e], qs[b][4 * h + e]);
    }
    fence_regs(qa[b]);
    fence_regs(qs[b]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 2 * p + h;
      const uint64_t off = (kk / 4) * (kF32Block >> 4) + 2 * (kk % 4);  // 32 bytes a k-step
      wgmma_tf32_n64(ss, qs[b] + 4 * h, dk + off, kk);
      wgmma_tf32_n64(ss, qa[b] + 4 * h, dks + off, 1);
      wgmma_tf32_n64(sb, qa[b] + 4 * h, dk + off, kk);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
}

// O += P V over one 64-key tile in 3xTF32: 8 k-steps of 8 keys, three
// m64n128k8 products each, the small terms first.  pb and ps hold P's big
// and small parts, each k-step's A fragment in place (k-step kk: registers
// 4 kk ..): column t of the fragment is key 2t, column t + 4 key 2t + 1, and
// V^T's k positions follow.
__device__ __forceinline__ void pv_f32(float (&o)[64], const uint32_t (&pb)[32], const uint32_t (&ps)[32],
                                       uint64_t dvt, uint64_t dvts) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t off = (kk / 4) * (kF32VtBlock >> 4) + 2 * (kk % 4);
    wgmma_tf32_n128(o, ps + 4 * kk, dvt + off);
    wgmma_tf32_n128(o, pb + 4 * kk, dvts + off);
    wgmma_tf32_n128(o, pb + 4 * kk, dvt + off);
  }
  wgmma_commit();
}

// Each block: a producer warpgroup and two consumer warpgroups of 64 query
// rows, walking the (head-batch, 128 query rows) items longest first
// (d128_slot).  The producer's first thread loads each consumer's Q once it
// released the item before's, and each K and V tile (0 .. the item's last
// diagonal) by TMA into one landing buffer, K and V in turn; all 128
// producer threads split each landed K tile into its big and small tiles,
// and transpose each V tile into V^T's, after which the landing buffer takes
// the next tile.  One stage each: the consumers take Q K^T and P V in turn,
// and the producer refills the stage of the one while they run the other.
// Every consumer warp releases every tile, used or not (a tile past its
// warpgroup's diagonal is released as it is ready), so that the stages'
// barriers never run a phase ahead of a warpgroup.  c = scale * log2(e).
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_attention_f32_d128_kernel(__grid_constant__ const CUtensorMap tm_q,
                                    __grid_constant__ const CUtensorMap tm_k,
                                    __grid_constant__ const CUtensorMap tm_v, float* __restrict__ out,
                                    int n_bh, int seq, float c) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qf[kConsumers], bar_qe[kConsumers], bar_l, bar_kf, bar_ke, bar_vf,
      bar_ve;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;  // consumer w's Q rows at s_q + w * kF32Tile
  const uint32_t s_k = s_q + kConsumers * kF32Tile;  // K's big part
  const uint32_t s_ks = s_k + kF32Tile;             // K's small part
  const uint32_t s_l = s_ks + kF32Tile;             // the landing buffer: K, then V
  const uint32_t s_vt = s_l + kF32Tile;             // V^T's big part
  const uint32_t s_vts = s_vt + kF32Tile;           // V^T's small part
  float* const sm = reinterpret_cast<float*>(smem_raw + (s_q - raw));  // s_q, for plain loads and stores

  const int n_qt = (seq + kBlockRows - 1) / kBlockRows;
  const int items = n_bh * n_qt, grid = gridDim.x, blk = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w) {
      mbar_init(smem_u32(&bar_qf[w]), 1);
      mbar_init(smem_u32(&bar_qe[w]), 4);
    }
    mbar_init(smem_u32(&bar_l), 1);
    mbar_init(smem_u32(&bar_kf), 128);
    mbar_init(smem_u32(&bar_vf), 128);
    mbar_init(smem_u32(&bar_ke), 4 * kConsumers);
    mbar_init(smem_u32(&bar_ve), 4 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
    const int pt = threadIdx.x - 128 * kConsumers;
    const bool leader = pt == 0;
    // 64 rows from row0 of head-batch bh as four boxes, completing on bar
    auto load = [&](const CUtensorMap* map, uint32_t dst, int row0, int bh, uint64_t* bar) {
      mbar_expect_tx(smem_u32(bar), kF32Tile);
#pragma unroll 1
      for (int cb = 0; cb < 4; ++cb) tma_load(dst + cb * kF32Block, map, 32 * cb, row0, bh, smem_u32(bar));
    };
    // the block's item in the round after r, or -1
    auto next_item = [&](int r) {
      const int i = d128_slot(r + 1, blk, grid);
      return (r + 1) * grid < items && i < items ? i : -1;
    };
    // every producer thread has read the landing buffer: the leader loads the next tile
    auto landing_read = [&]() {
      __syncwarp();
      named_sync(3, 128);
    };
    // V^T: thread pt writes row d = pt; V as landed holds (key, d) in column
    // block d / 32 at row key, 16-byte chunk ((d % 32) / 4) ^ (key % 8)
    const float* v_in = sm + (s_l - s_q + (pt >> 5) * kF32Block + (pt & 3) * 4) / 4;
    const int dc = (pt >> 2) & 7;
    int nq[kConsumers] = {0, 0};  // Q loads of each consumer
    int n = 0;                    // K and V tiles so far: the landing buffer's phase 2n is K's, 2n + 1 V's
    if (leader) load(&tm_k, s_l, 0, blk % n_bh, &bar_l);  // the first item is blk
    for (int r = 0; r * grid < items; ++r) {
      const int i = d128_slot(r, blk, grid);
      if (i >= items) continue;
      const int bh = i % n_bh, q0 = kBlockRows * (n_qt - 1 - i / n_bh);
      const int n_item = max(f32_tiles(q0, 0, seq), f32_tiles(q0, 1, seq));
      if (leader) {
        for (int w = 0; w < kConsumers; ++w) {
          if (f32_tiles(q0, w, seq) == 0) continue;
          if (nq[w] > 0) mbar_wait(smem_u32(&bar_qe[w]), (nq[w] - 1) & 1);
          load(&tm_q, s_q + w * kF32Tile, q0 + 64 * w, bh, &bar_qf[w]);
          ++nq[w];
        }
      }
      for (int j = 0; j < n_item; ++j, ++n) {
        // K tile j, landed, into its big and small parts once every consumer
        // released the tile before
        mbar_wait(smem_u32(&bar_l), 0);
        if (n > 0) mbar_wait(smem_u32(&bar_ke), (n - 1) & 1);
#pragma unroll 4
        for (int x = pt; x < kF32Tile / 16; x += 128) {
          float4 big, small;
          split4(reinterpret_cast<const float4*>(sm)[(s_l - s_q) / 16 + x], big, small);
          reinterpret_cast<float4*>(sm)[(s_k - s_q) / 16 + x] = big;
          reinterpret_cast<float4*>(sm)[(s_ks - s_q) / 16 + x] = small;
        }
        fence_proxy_async();
        mbar_arrive(smem_u32(&bar_kf));
        landing_read();
        if (leader) load(&tm_v, s_l, kF32Keys * j, bh, &bar_l);
        // V tile j, landed, into V^T's big and small parts (keys along k in
        // the order P's fragment takes them: positions 4h .. 4h + 3 of
        // k-step kk hold keys 8 kk + 2e + h), once every consumer released
        // the tile before
        mbar_wait(smem_u32(&bar_l), 1);
        if (n > 0) mbar_wait(smem_u32(&bar_ve), (n - 1) & 1);
#pragma unroll
        for (int kk = 0; kk < kF32Keys / 8; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = 8 * kk + 2 * e + h;
              x[e] = v_in[(key * kSpanBytes + ((dc ^ (key & 7)) << 4)) / 4];
            }
            float4 big, small;
            split4(make_float4(x[0], x[1], x[2], x[3]), big, small);
            const int at =
                ((kk / 4) * kF32VtBlock + pt * kSpanBytes + (((2 * (kk % 4) + h) ^ (pt & 7)) << 4)) / 16;
            reinterpret_cast<float4*>(sm)[(s_vt - s_q) / 16 + at] = big;
            reinterpret_cast<float4*>(sm)[(s_vts - s_q) / 16 + at] = small;
          }
        }
        fence_proxy_async();
        mbar_arrive(smem_u32(&bar_vf));
        landing_read();
        if (leader) {  // the next K tile: this item's, or the next item's first
          const int ni = j + 1 < n_item ? i : next_item(r);
          if (ni >= 0) load(&tm_k, s_l, j + 1 < n_item ? kF32Keys * (j + 1) : 0, ni % n_bh, &bar_l);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));

  // this consumer warpgroup, broadcast from lane 0 so that the compiler
  // keeps what derives from it (the wgmma descriptors) in uniform registers
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int g = lane >> 2, t = lane & 3;
  const int wrow = 16 * (warp & 3) + g;  // the thread's first row among the warpgroup's 64
  const int diag_off = 2 * t - wrow;     // key - row on the diagonal tile, less 8 x + (e & 1) - 8 (e >> 1)
  const float* q_row = sm + (wg * kF32Tile + wrow * kSpanBytes) / 4 + t;
  const uint64_t dk = sw128_desc(s_k), dks = sw128_desc(s_ks), dvt = sw128_desc(s_vt),
                 dvts = sw128_desc(s_vts);
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(empty));
  };

  int nq = 0, n = 0;  // this warpgroup's Q loads; the block's K and V tiles so far
  for (int r = 0; r * grid < items; ++r) {
    const int i = d128_slot(r, blk, grid);
    if (i >= items) continue;
    const int bh = i % n_bh, q0 = kBlockRows * (n_qt - 1 - i / n_bh);
    const int n_item = max(f32_tiles(q0, 0, seq), f32_tiles(q0, 1, seq));
    const int n_mine = f32_tiles(q0, wg, seq);
    float o[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    if (n_mine > 0) mbar_wait(smem_u32(&bar_qf[wg]), nq & 1);
    for (int j = 0; j < n_mine; ++j) {
      mbar_wait(smem_u32(&bar_kf), (n + j) & 1);
      __syncwarp();  // the warp converged again for the .aligned wgmma instructions
      float sb[32], ss[32];
      qk_f32(sb, ss, q_row, g, dk, dks);
      fence_regs(sb);
      fence_regs(ss);
      release(&bar_ke);
      if (j == n_mine - 1) {  // Q is read: the next item's may land
        fence_proxy_async();
        release(&bar_qe[wg]);
      }
      float sc[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = sb[x] + ss[x];
      float r0, r1;
      online_softmax(sc, j == n_mine - 1, diag_off, c, m0, m1, l0, l1, r0, r1);
      rescale_o(o, r0, r1);
      // P's big and small parts, each k-step's A fragment in place:
      // registers 4 kk .. take the accumulators 4 kk, 4 kk + 2, 4 kk + 1, 4 kk + 3
      uint32_t pb[32], ps[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) split(sc[(x & ~3) | ((x & 1) << 1) | ((x >> 1) & 1)], pb[x], ps[x]);
      fence_regs(pb);
      fence_regs(ps);
      fence_regs(o);
      mbar_wait(smem_u32(&bar_vf), (n + j) & 1);
      __syncwarp();
      pv_f32(o, pb, ps, dvt, dvts);
      wgmma_wait<0>();
      fence_regs(o);
      release(&bar_ve);
    }
    if (n_mine > 0) {  // O / l, rows past seq not written
      ++nq;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
      const int row0 = q0 + 64 * wg + wrow;
      float* ob = out + ((size_t)bh * seq + row0) * 128 + 2 * t;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        if (row0 < seq)
          *reinterpret_cast<float2*>(ob + 8 * x) = make_float2(o[4 * x] * inv0, o[4 * x + 1] * inv0);
        if (row0 + 8 < seq)
          *reinterpret_cast<float2*>(ob + 8 * 128 + 8 * x) =
              make_float2(o[4 * x + 2] * inv1, o[4 * x + 3] * inv1);
      }
    }
    // the item's tiles past this warpgroup's diagonal: released as they land
    for (int j = n_mine; j < n_item; ++j) {
      mbar_wait(smem_u32(&bar_kf), (n + j) & 1);
      release(&bar_ke);
      mbar_wait(smem_u32(&bar_vf), (n + j) & 1);
      release(&bar_ve);
    }
    n += n_item;
  }
}

// ---- any other head dim: mma.sync on D padded to a multiple of 32 -----------

// The any-D kernel's fp32 element type (3xTF32 on m16n8k8); Bf16 and F16 run
// m16n8k16 on their own type.
struct F32 {
  using T = float;
};

constexpr int kAnyWidest = 256;  // the widest padded head dim; a wider D goes in chunks of it

// The any-D kernel's tiles for element type E at padded width DP: a Q tile
// of kRows rows, K and V tiles of kKeys keys in kStages stages, rows padded
// (in elements) so that a warp's fragment loads hit distinct banks; 64-key
// tiles where two blocks still fit an SM's 228 KB (1 KB of each reserved),
// else 32.
template <class E, int DP, bool kChunked>
struct AnyTiles {
  using T = typename E::T;
  static constexpr bool kF32 = std::is_same<E, F32>::value;
  static constexpr int kStrideQK = kF32 ? DP + 16 : DP + 8;  // fp32: 16-byte fragment loads
  static constexpr int kStrideV = kF32 ? DP + 4 : DP + 8;    // fp32: 4-byte loads; 16-bit: ldmatrix
  static constexpr int kStages = kChunked ? 1 : 2;
  static constexpr int kQ = kRows * kStrideQK;                  // elements of the Q tile
  static constexpr int kPerKey = kStages * (kStrideQK + kStrideV);  // and of a key's K and V rows
  static constexpr int kKeys = 2 * ((kQ + 64 * kPerKey) * (int)sizeof(T) + 1024) <= 228 * 1024 ? 64 : 32;
  static constexpr int kK = kKeys * kStrideQK, kV = kKeys * kStrideV;
  static constexpr int kSmemBytes = (kQ + kKeys * kPerKey) * (int)sizeof(T);
  static_assert(DP % 32 == 0 && DP <= kAnyWidest, "DP: a multiple of 32, at most 256");
  static_assert(kSmemBytes <= 227 * 1024, "one block's shared memory");
};

// cp.async of N bytes (4, 8 or 16), zeros where !in
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool in) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(N),
                 "r"(in ? N : 0));
  }
}

// Rows row0 .. row0 + kN - 1 of one (seq, d) matrix at src, its columns col0
// .. col0 + width - 1, into a tile of rows of kStride elements at dst, in
// copies of `vec` bytes (16, 8 or 4 by cp.async; 2, a 16-bit row of odd
// width, by plain loads), rows past seq as zeros; the tile's columns width ..
// DP - 1 are zeroed.  vec divides width's and d's bytes, and col0's are a
// multiple of 16.
template <class T, int kN, int kStride, int DP>
__device__ __forceinline__ void stage_any(T* dst, const T* src, int row0, int seq, int d, int col0,
                                          int width, int vec) {
  const int per = vec / (int)sizeof(T), n = width / per;
  for (int i = threadIdx.x; i < kN * n; i += kThreads) {
    const int r = i / n, col = (i - r * n) * per;
    const bool in = row0 + r < seq;
    const T* s = src + (size_t)(in ? row0 + r : 0) * d + col0 + col;
    T* t = dst + r * kStride + col;
    if (vec == 16) {
      cp_async_n<16>(t, s, in);
    } else if (vec == 8) {
      cp_async_n<8>(t, s, in);
    } else if (vec == 4) {
      cp_async_n<4>(t, s, in);
    } else {
      *reinterpret_cast<uint16_t*>(t) = in ? *reinterpret_cast<const uint16_t*>(s) : (uint16_t)0;
    }
  }
  const int pad = DP - width;
  for (int i = threadIdx.x; i < kN * pad; i += kThreads) {
    const int r = i / pad, at = r * kStride + width + (i - r * pad);
    if constexpr (sizeof(T) == 2) {
      reinterpret_cast<uint16_t*>(dst)[at] = 0;
    } else {
      dst[at] = 0.0f;
    }
  }
}

// four 8 x 8 matrices of 16-bit values from shared memory, each lane's row
// address given (lanes 8i .. 8i + 7: matrix i); .trans: transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b on the tensor cores, one m16n8k16 product of 16-bit inputs
template <class E>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<E, F16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// s += Q K^T for a warp's 16 rows (from row wrow of the Q tile) over a K
// tile, the first n16 16-column steps of D.  s[j][e]: the accumulator of
// keys 8j .. 8j + 7 (row g + 8 (e >> 1), key 8j + 2t + (e & 1)).
template <class E, int kKeys, int kStride>
__device__ __forceinline__ void qk_any(float (&s)[kKeys / 8][4], const typename E::T* sq,
                                       const typename E::T* sk, int wrow, int lane, int n16) {
  if constexpr (std::is_same<E, F32>::value) {
    // 3xTF32, the D = 64 kernel's order: in each pair of k-steps (16 columns
    // from 16m) A column t holds column 16m + 4t + 2h of k-step 2m + h,
    // column t + 4 the next, so that a lane reads its four values as a float4
    const int g = lane >> 2, t = lane & 3;
    const float* q0 = sq + (wrow + g) * kStride + 4 * t;
    const float* k0 = sk + g * kStride + 4 * t;
#pragma unroll 1
    for (int m = 0; m < n16; ++m) {
      const float4 x0 = *reinterpret_cast<const float4*>(q0 + 16 * m);
      const float4 x1 = *reinterpret_cast<const float4*>(q0 + 8 * kStride + 16 * m);
      uint32_t qb[2][4], qs[2][4];
      split(x0.x, qb[0][0], qs[0][0]);
      split(x1.x, qb[0][1], qs[0][1]);
      split(x0.y, qb[0][2], qs[0][2]);
      split(x1.y, qb[0][3], qs[0][3]);
      split(x0.z, qb[1][0], qs[1][0]);
      split(x1.z, qb[1][1], qs[1][1]);
      split(x0.w, qb[1][2], qs[1][2]);
      split(x1.w, qb[1][3], qs[1][3]);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float4 kr = *reinterpret_cast<const float4*>(k0 + 8 * j * kStride + 16 * m);
        mma3(s[j], qb[0], qs[0], kr.x, kr.y);
        mma3(s[j], qb[1], qs[1], kr.z, kr.w);
      }
    }
  } else {
    // lane l gives row l % 8 of matrix l / 8: Q's A fragment (rows +8 for
    // matrices 1 and 3, columns +8 for 2 and 3) and the B fragments of two
    // key n-tiles (columns +8 for matrices 1 and 3, keys +8 for 2 and 3)
    const typename E::T* qa = sq + (wrow + (lane & 7) + (lane & 8)) * kStride + ((lane >> 4) << 3);
    const typename E::T* ka = sk + ((lane & 7) + ((lane >> 4) << 3)) * kStride + (lane & 8);
#pragma unroll 1
    for (int kk = 0; kk < n16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + 16 * kk);
#pragma unroll
      for (int jj = 0; jj < kKeys / 16; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, ka + 16 * jj * kStride + 16 * kk);
        mma16<E>(s[2 * jj], a, b[0], b[1]);
        mma16<E>(s[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// o += P V for a warp's 16 rows over a V tile: P as the online softmax left
// it in s, V's first `width` columns (16 at a time; the rest are never stored)
template <class E, int DP, int kKeys, int kStride>
__device__ __forceinline__ void pv_any(float (&o)[DP / 8][4], const float (&s)[kKeys / 8][4],
                                       const typename E::T* sv, int lane, int width) {
  if constexpr (std::is_same<E, F32>::value) {
    // 3xTF32: the accumulators of keys (2t, 2t + 1) are the A columns (t, t + 4),
    // so the B fragment takes V rows 2t and 2t + 1
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
      const float* vr = sv + (8 * j + 2 * t) * kStride + g;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        if (8 * (nd & ~1) < width) mma3(o[nd], pb, ps, vr[8 * nd], vr[kStride + 8 * nd]);
      }
    }
  } else {
    // k-step kk (keys 16 kk ..) takes the accumulator pairs of key n-tiles 2 kk
    // and 2 kk + 1 as its A registers, no shuffle; P in two 16-bit pieces,
    // hi = T(P) and lo = T(P - hi), the small piece first; V's B fragments of
    // two column n-tiles by one transposed ldmatrix (keys +8 for matrices 1
    // and 3, columns +8 for 2 and 3)
    const typename E::T* va = sv + ((lane & 7) + (lane & 8)) * kStride + ((lane >> 4) << 3);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const float x[8] = {s[2 * kk][0], s[2 * kk][1], s[2 * kk][2], s[2 * kk][3],
                          s[2 * kk + 1][0], s[2 * kk + 1][1], s[2 * kk + 1][2], s[2 * kk + 1][3]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[r] = E::pack(x[2 * r], x[2 * r + 1]);
        lo[r] = E::pack(x[2 * r] - E::lo(hi[r]), x[2 * r + 1] - E::hi(hi[r]));
      }
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        if (16 * np < width) {
          uint32_t b[4];
          ldsm_x4_trans(b, va + 16 * kk * kStride + 16 * np);
          mma16<E>(o[2 * np], lo, b[0], b[1]);
          mma16<E>(o[2 * np], hi, b[0], b[1]);
          mma16<E>(o[2 * np + 1], lo, b[2], b[3]);
          mma16<E>(o[2 * np + 1], hi, b[2], b[3]);
        }
      }
    }
  }
}

// Two neighbouring output values of one row, rounded to T once; the second
// only where `both` (the last column of an odd D has no neighbour)
template <class E>
__device__ __forceinline__ void store_pair(typename E::T* p, float a, float b, bool both) {
  if constexpr (std::is_same<E, F32>::value) {
    p[0] = a;
    if (both) p[1] = b;
  } else {
    const uint32_t w = E::pack(a, b);
    reinterpret_cast<uint16_t*>(p)[0] = (uint16_t)(w & 0xffffu);
    if (both) reinterpret_cast<uint16_t*>(p)[1] = (uint16_t)(w >> 16);
  }
}

// A block owns kRows query rows of one head-batch (query tile blockIdx.y
// from the last) and output columns DP * blockIdx.z .. (chunked) of them;
// warp w its rows 16 w ..  c = scale * log2(e); vec: the loads' bytes.
template <class E, int DP, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_anyd_kernel(const typename E::T* __restrict__ q, const typename E::T* __restrict__ k,
                                const typename E::T* __restrict__ v, typename E::T* __restrict__ out,
                                int seq, int d, float c, int vec) {
  using L = AnyTiles<E, DP, kChunked>;
  using T = typename E::T;
  constexpr int kKeys = L::kKeys, kSQK = L::kStrideQK, kSV = L::kStrideV;
  extern __shared__ float4 smem4[];
  T* const sq = reinterpret_cast<T*>(smem4);
  T* const skv = sq + L::kQ;  // stage s: K at skv + s (kK + kV), then V

  const int n_qt = (seq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kRows;  // the longest query tiles first
  const size_t base = (size_t)blockIdx.x * seq * d;
  const int col0 = DP * (int)blockIdx.z;   // this block's output columns (chunked; else 0) ...
  const int width = min(DP, d - col0);     // ... of which this many lie in D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and lane in the quad
  const int wrow = 16 * warp;             // the warp's first row in the query tile
  const int row0 = q0 + wrow + g, row1 = row0 + 8;
  // key tiles 0 .. the block's last row; the warp's own end at its diagonal
  const int n_kt = min((q0 + kRows - 1) / kKeys + 1, (seq + kKeys - 1) / kKeys);
  const int last = q0 + wrow < seq ? (q0 + wrow) / kKeys : -1;  // none when its rows lie past seq

  if constexpr (!kChunked) {  // Q once, beside key tile 0 in stage 0
    stage_any<T, kRows, kSQK, DP>(sq, q + base, q0, seq, d, 0, d, vec);
    stage_any<T, kKeys, kSQK, DP>(skv, k + base, 0, seq, d, 0, d, vec);
    stage_any<T, kKeys, kSV, DP>(skv + L::kK, v + base, 0, seq, d, 0, d, vec);
    cp_async_commit();
  }
  float o[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kKeys;
    const bool mine = it <= last;
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const T* vs;
    if constexpr (kChunked) {
      // S = Q K^T over D in pieces of DP columns, Q's and K's staged in turn
      T* const ks = skv;
      for (int p = 0; p < d; p += DP) {
        const int w = min(DP, d - p);
        stage_any<T, kRows, kSQK, DP>(sq, q + base, q0, seq, d, p, w, vec);
        stage_any<T, kKeys, kSQK, DP>(ks, k + base, k0, seq, d, p, w, vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (mine) qk_any<E, kKeys, kSQK>(s, sq, ks, wrow, lane, (w + 15) / 16);
        __syncthreads();  // the pieces are read before the next overwrite them
      }
      T* const vt = skv + L::kK;
      stage_any<T, kKeys, kSV, DP>(vt, v + base, k0, seq, d, col0, width, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      vs = vt;
    } else {
      if (it + 1 < n_kt) {  // tile it + 1 loads while tile it computes
        T* const next = skv + ((it + 1) & 1) * (L::kK + L::kV);
        stage_any<T, kKeys, kSQK, DP>(next, k + base, k0 + kKeys, seq, d, 0, d, vec);
        stage_any<T, kKeys, kSV, DP>(next + L::kK, v + base, k0 + kKeys, seq, d, 0, d, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* ks = skv + (it & 1) * (L::kK + L::kV);
      vs = ks + L::kK;
      if (mine) qk_any<E, kKeys, kSQK>(s, sq, ks, wrow, lane, (d + 15) / 16);
    }
    if (mine) {
      // the causal mask on the warp's diagonal tile, the online softmax, O
      // rescaled to the new max, then O += P V
      float r0, r1;
      online_softmax(reinterpret_cast<float(&)[kKeys / 2]>(s), it == last, k0 + 2 * t - row0, c, m0, m1,
                     l0, l1, r0, r1);
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        o[nd][0] *= r0;
        o[nd][1] *= r0;
        o[nd][2] *= r1;
        o[nd][3] *= r1;
      }
      pv_any<E, DP, kKeys, kSV>(o, s, vs, lane, width);
    }
    __syncthreads();  // the tile is read before the next stage overwrites it
  }

  if (last < 0) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  T* const ob = out + base + col0;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = 8 * nd + 2 * t;
    if (col < width) {
      if (row0 < seq) store_pair<E>(ob + (size_t)row0 * d + col, o[nd][0] * inv0, o[nd][1] * inv0, col + 1 < width);
      if (row1 < seq) store_pair<E>(ob + (size_t)row1 * d + col, o[nd][2] * inv1, o[nd][3] * inv1, col + 1 < width);
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

// (bh, seq, d) values of `type` (`bytes` each: 2 unless said) as a 3-D
// tensor map in boxes of `rows` rows of 128 bytes (one span of the 128-byte
// swizzle: 64 16-bit or 32 fp32 columns; a row of 128 columns is two or four
// boxes), rows past seq read as zeros.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int bh, int seq, int d, int rows, int bytes = 2) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * bytes, (cuuint64_t)seq * d * bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(kSpanBytes / bytes), (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// D = 64: a block a (head-batch, query tile)
template <class E>
int launch_attention16_d64(const typename E::T* q, const typename E::T* k, const typename E::T* v,
                           typename E::T* out, int bh, int seq, float scale, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(encode, &tm_q, E::kMapType, q, bh, seq, 64, kBlockRows) ||
      !tensor_map(encode, &tm_k, E::kMapType, k, bh, seq, 64, 64) ||
      !tensor_map(encode, &tm_v, E::kMapType, v, bh, seq, 64, 64))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_16_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, kD64Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + kBlockRows - 1) / kBlockRows);
  flash_attention_16_kernel<E><<<grid, kBf16Threads, kD64Smem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, out, seq, scale * kLog2e);
  return (int)cudaGetLastError();
}

// D = 128: one block an SM, at most one a work item, each walking its items
template <class E>
int launch_attention16_d128(const typename E::T* q, const typename E::T* k, const typename E::T* v,
                            typename E::T* out, int bh, int seq, float scale, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!tensor_map(encode, &tm_q, E::kMapType, q, bh, seq, 128, kBlockRows) ||
      !tensor_map(encode, &tm_k, E::kMapType, k, bh, seq, 128, kD128Keys) ||
      !tensor_map(encode, &tm_v, E::kMapType, v, bh, seq, 128, kD128Keys) ||
      !tensor_map(encode, &tm_o, E::kMapType, out, bh, seq, 128, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_16_d128_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kD128Smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int items = bh * ((seq + kBlockRows - 1) / kBlockRows);
  flash_attention_16_d128_kernel<E><<<items < sms ? items : sms, kD128Threads, kD128Smem,
                                      (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_o, bh, seq, scale * kLog2e);
  return (int)cudaGetLastError();
}

// D = 128 in fp32: one block an SM, at most one a work item, each walking its items
int launch_attention_f32_d128(const float* q, const float* k, const float* v, float* out, int bh,
                              int seq, float scale, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(encode, &tm_q, kF32, q, bh, seq, 128, 64, 4) ||
      !tensor_map(encode, &tm_k, kF32, k, bh, seq, 128, kF32Keys, 4) ||
      !tensor_map(encode, &tm_v, kF32, v, bh, seq, 128, kF32Keys, 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_d128_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int items = bh * ((seq + kBlockRows - 1) / kBlockRows);
  flash_attention_f32_d128_kernel<<<items < sms ? items : sms, kF32Threads, kF32Smem,
                                    (cudaStream_t)stream>>>(tm_q, tm_k, tm_v, out, bh, seq,
                                                            scale * kLog2e);
  return (int)cudaGetLastError();
}

// Any other head dim: the instance of D's padded width DP (D rounded up to
// a multiple of 32), or past 256 the chunked one; each load `vec` bytes, the
// widest that divides a row's bytes (the base address is 16-byte aligned)
template <class E, int DP, bool kChunked>
int launch_anyd(const typename E::T* q, const typename E::T* k, const typename E::T* v, typename E::T* out,
                int bh, int seq, int d, float scale, int vec, void* stream) {
  constexpr int kSmem = AnyTiles<E, DP, kChunked>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(flash_attention_anyd_kernel<E, DP, kChunked>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + kRows - 1) / kRows, kChunked ? (d + DP - 1) / DP : 1);
  flash_attention_anyd_kernel<E, DP, kChunked><<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      q, k, v, out, seq, d, scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

template <class E>
int launch_attention_anyd(const typename E::T* q, const typename E::T* k, const typename E::T* v,
                          typename E::T* out, int bh, int seq, int d, float scale, void* stream) {
  const int bytes = d * (int)sizeof(typename E::T);
  const int vec = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
  switch ((d + 31) / 32) {
    case 1: return launch_anyd<E, 32, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    case 2: return launch_anyd<E, 64, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    case 3: return launch_anyd<E, 96, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    case 4: return launch_anyd<E, 128, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    case 5: return launch_anyd<E, 160, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    case 6: return launch_anyd<E, 192, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    case 7: return launch_anyd<E, 224, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    case 8: return launch_anyd<E, 256, false>(q, k, v, out, bh, seq, d, scale, vec, stream);
    default: return launch_anyd<E, kAnyWidest, true>(q, k, v, out, bh, seq, d, scale, vec, stream);
  }
}

}  // namespace

extern "C" {

// q, k, v, out: (bh, seq, head_dim) fp32, contiguous, 16-byte aligned;
// head_dim >= 1 (else cudaErrorInvalidValue, nothing launched): 64 and 128
// to their own kernels, any other to flash_attention_anyd_kernel; scale:
// the caller's fp32 head_dim^-0.5.
int flash_attention_f32(const float* q, const float* k, const float* v, float* out, int bh,
                        int seq, int head_dim, float scale, void* stream) {
  if (head_dim < 1) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  if (head_dim == 64) return launch_attention(q, k, v, out, bh, seq, scale, stream);
  if (head_dim == 128) return launch_attention_f32_d128(q, k, v, out, bh, seq, scale, stream);
  return launch_attention_anyd<F32>(q, k, v, out, bh, seq, head_dim, scale, stream);
}

// q, k, v, out: (bh, seq, head_dim) bf16, contiguous, 16-byte aligned; the
// rest as flash_attention_f32.
int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* out, int bh, int seq, int head_dim, float scale,
                         void* stream) {
  if (head_dim < 1) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  if (head_dim == 64) return launch_attention16_d64<Bf16>(q, k, v, out, bh, seq, scale, stream);
  if (head_dim == 128) return launch_attention16_d128<Bf16>(q, k, v, out, bh, seq, scale, stream);
  return launch_attention_anyd<Bf16>(q, k, v, out, bh, seq, head_dim, scale, stream);
}

// q, k, v, out: (bh, seq, head_dim) fp16, contiguous, 16-byte aligned; the
// rest as flash_attention_f32.
int flash_attention_f16(const __half* q, const __half* k, const __half* v, __half* out, int bh,
                        int seq, int head_dim, float scale, void* stream) {
  if (head_dim < 1) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  if (head_dim == 64) return launch_attention16_d64<F16>(q, k, v, out, bh, seq, scale, stream);
  if (head_dim == 128) return launch_attention16_d128<F16>(q, k, v, out, bh, seq, scale, stream);
  return launch_attention_anyd<F16>(q, k, v, out, bh, seq, head_dim, scale, stream);
}

}  // extern "C"
