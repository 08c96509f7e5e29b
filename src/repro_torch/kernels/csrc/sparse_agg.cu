// Adaptive-aggregation kernels (paper eqs. 6-7): the dense-stack kernel
// and the wire scatter-accumulate kernel for the sparse uplink.
//
// Replaces the three TPU kernels of src/repro/kernels/sparse_agg.py:
//   sparse_aggregate_{f32,bf16,f16}  <- sparse_agg_pallas (_agg_kernel)
//   scatter_wire_sums_{f32,bf16,f16} <- scatter_wire_sums_pallas (_scatter_wire_kernel)
//   scatter_wire_sums_dequant_i8 <- scatter_wire_sums_dequant_pallas
//                                   (_scatter_wire_dequant_kernel)
//
// bf16 and fp16 inputs: each 16-bit entry point reads its type, upcasts
// every value exactly, runs the fp32 arithmetic and rounds its fp32 result
// to that type once, as it writes (round to nearest even) -- what the
// reference computes: the Pallas kernels upcast inside, and its wrappers
// cast their fp32 results back to the input's dtype.  So the 16-bit outputs
// are bitwise the plain versions' fp32 results cast to their type, and the
// outputs move half the bytes.  An fp16 sum past 65 504 rounds to inf, as
// the cast does.  The 16-bit wire scatter is a kernel of its own
// (scatter_wire_16_kernel<T>, below, for T = bf16 and fp16: only the
// upcast of a value and the one rounding differ); the 16-bit aggregation
// runs the fp32 kernel's body on 16-bit loads.
//
// sparse_aggregate_f32, for a dense (N, rows, V) fp32 stack of the
// transmitters' top-k masks (zeros off each client's support):
//   out[r, c] = sum_n |x[n,r,c]| * x[n,r,c] / (sum_n |x[n,r,c]| + 1e-12)
// Bound on H100: bytes, N*rows*V*4 read + rows*V*4 written (51.5 + 12.9 MB
// at 4 x 64 x 50257, ~19 us at 3.35 TB/s), a few flops per element.
// Design: an elementwise pass, one thread per output element (r, c),
// coalesced along V; each thread walks the N clients IN ORDER with
// num += s*x and den += s written as __fmul_rn / __fadd_rn, so nvcc cannot
// contract them into an FMA, then one IEEE divide — bitwise equal to the
// plain version's ordered client loop.  (The Pallas kernel tiles
// (N, 8, 2048) blocks through VMEM; here the client axis is small and
// stays a register loop.)
//
// The wire scatter computes, for a cohort wire of N clients x rows x k
// entries:
//   num[r, idx[n,r,j]] += a[n,r,j]      den[r, idx[n,r,j]] += b[n,r,j]
// summed over the clients n = 0..N-1 IN ORDER.  Both entry points run one
// templated kernel body; only the per-entry loader differs: the float wire
// reads (a, b), the int8 wire rebuilds v = ((float)q * scale[n,r]) * mask
// and the aggregation mode's two channels, (|v|*v, |v|) for adaptive and
// (v, mask) for zeropad / mean_nonzero, in the reference's order.
//
// What bounds it on H100: bytes.  The outputs are dense, 2*rows*V*4 bytes
// (25.7 MB at rows=64, V=50257), against N*rows*k*12 bytes of wire read
// (3.1 MB at N=4, k=1024) and no arithmetic to speak of, so the least time
// is the dense write at the card's memory rate (~9 us at 3.35 TB/s).
//
// Design.  The Pallas kernel carries two (rows_blk, V) accumulators in VMEM
// across a sequential client loop; two fp32 rows of V = 50257 (402 KB) do
// not fit one Hopper block.  Here each row is cut into the fewest column
// tiles whose num and den fit the shared memory a block may opt into (two
// at V = 50257, 201 KB each: 128 blocks for 64 rows, one wave on 132 SMs),
// and a block owns one (row, tile).  It zero-fills its tile in shared
// memory; loads the row's N*k indices, kBatch a thread, all at once (every
// tile of the row reads them, from L2), then the values of the entries
// that land in its tile; adds them into shared memory one client after the
// other with a __syncthreads() between clients; and writes the tile once
// with 16-byte streaming stores.  Tiles follow the output row's 16-byte
// granules (V is odd, so row r starts at a float phase p of its granule):
// the row's first and last granules are written lane by lane, and den is
// written lane by lane too if it sits on another phase than num.
// Within one (n, r) the top-k indices are distinct; the only repeats are
// wire padding at index 0, which carries exact zeros (pad_wire).  A zero
// contribution is skipped — exactly what adding it would do, since a sum
// that starts at +0 never becomes -0 — so the adds of one client touch
// distinct addresses and need no atomics, and the result is bitwise equal
// to a plain version that scatters one client at a time.  No global
// atomics, no global zero-fill, nothing carried between blocks.  (A first
// draft with a four-block cluster adding through distributed shared memory
// took 4x longer, its cluster barriers between clients dominating.)
//
// The bf16 wire scatter (scatter_wire_sums_bf16; scatter_wire_sums_f16 is
// the same kernel on fp16) bounds the same way at half the bytes: 12.9 MB
// of 16-bit sums written against 2.1 MB of wire at N=4, k=1024 (~4.5 us at
// 3.35 TB/s).  Run through the fp32 body above,
// each CTA was a serial chain (zero-fill, the row's index loads, the
// dependent value loads, four client phases, then the write, the only
// part the bound counts); the loads took ~7 K of its ~18 K cycles
// (tools/kernel_probe.py's clocked copy).  Its own kernel:
//   * the wire from L2 once, with no dependent loads: the tiles of a row
//     form a thread-block cluster of up to 8 (a wider row is several
//     clusters), and the row's wire reaches every CTA of the cluster by
//     TMA multicast (cp.async.bulk ... multicast::cluster), chunk by
//     chunk: kChunk entries of one client's idx, a and b, through a ring of
//     kRing slots, each with its own mbarrier, so client 0's adds start
//     while later chunks are in flight, and any N and k fit.  One producer
//     thread of the cluster's first CTA issues the copies; a releaser warp
//     of each CTA hands a slot back to it (a remote mbarrier arrive) once
//     the CTA's consumer warps are through it, off their path.  Nothing
//     else crosses CTAs: each adds only into its own tile, the clients in
//     order by a CTA-local barrier after each client (no cluster barrier
//     between clients, no adds through distributed shared memory);
//   * no zero-fill: a bit a column marks the columns a contribution was
//     added to; a first add goes onto +0 (as onto a zeroed sum), and the
//     write takes 0 where no bit is set.  (Writing the untouched granules'
//     zeros early, beside the adds, was tried: 16-byte stores that skip
//     the touched granules leave 32-byte sectors half written, which L2
//     fills from memory, and ran slower by half);
//   * a thread takes its entries of a chunk out of the slot before it adds
//     them, and hands the slot back in between;
//   * tiles cut to the card: the most tiles a row whose grid the card
//     holds at once (cudaOccupancyMaxActiveClusters), down to tiles of
//     k16TileGran granules where nothing fits one wave.  At 64 rows of
//     V = 50 257 that is 2 tiles of ~201 KB of fp32 sums, one CTA an SM:
//     smaller tiles, several an SM, took a second wave (the fp32 sums of
//     all 64 rows are 25.7 MB, 85 % of the card's shared memory);
//   * bitwise the plain version: fp32 sums in shared memory, clients in
//     order, zero contributions skipped, out-of-range indices dropped, no
//     atomics on the sums, each value rounded to T once as it is written
//     with 16-byte streaming stores (the edge granules and a den on another
//     phase than num as in the fp32 kernel).
// A bulk copy takes 16-byte-aligned addresses and sizes, and a chunk of k
// entries sits anywhere (k odd, or a, b views at an offset): each copy
// moves the 16-byte granules that hold the chunk, and the adds skip the
// head bytes before its first entry.  A granule that holds a byte of the
// tensor lies in mapped memory, so the few bytes it carries from beside
// the chunk are read, never used.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (no fast math: the value math must be IEEE).
// Plain C interface, loaded through ctypes; each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kScatterThreads = 512;
constexpr int kBatch = 8;  // wire entries a thread has in flight

enum Mode { kAdaptive = 0, kZeropad = 1, kMeanNonzero = 2 };

// Exact upcast of an input value, and the one rounding of a result.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// A 16-bit value's exact upcast from its raw bits, and two fp32 values
// rounded to the type once each, packed in one word (lo in the low half).
template <class T>
__device__ __forceinline__ float from_bits(uint32_t bits);
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(uint32_t bits) {
  return __uint_as_float(bits << 16);
}
template <>
__device__ __forceinline__ float from_bits<__half>(uint32_t bits) {
  return __half2float(__ushort_as_half((unsigned short)bits));
}
template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The float wire: entry i contributes (a[i], b[i]), upcast to fp32.
template <class T>
struct FloatWire {
  const T* __restrict__ a;
  const T* __restrict__ b;
  __device__ __forceinline__ float2 operator()(size_t i, size_t) const {
    return make_float2(to_f32(__ldg(a + i)), to_f32(__ldg(b + i)));
  }
};

// The int8 wire: v = ((float)q * scale) * mask, then the mode's channels.
struct Int8Wire {
  const int8_t* __restrict__ q;
  const float* __restrict__ scale;
  const uint8_t* __restrict__ mask;
  int mode;
  __device__ __forceinline__ float2 operator()(size_t i, size_t nr) const {
    const float m = __ldg(mask + i) ? 1.0f : 0.0f;
    const float v = __fmul_rn(__fmul_rn((float)__ldg(q + i), __ldg(scale + nr)), m);
    if (mode == kAdaptive) {
      const float av = fabsf(v);
      return make_float2(__fmul_rn(av, v), av);
    }
    return make_float2(v, m);
  }
};

// Write `len` floats of shared memory `src` to granules [g0, g0 + len/4) of
// an output row whose element c sits in granule (c + p) / 4; lanes outside
// [0, vocab) belong to the neighbouring rows and are not written.
__device__ __forceinline__ void write_tile(float* dst_row, int p, const float* src, int g0,
                                           int n_gran, int vocab) {
  float4* dst4 = reinterpret_cast<float4*>(dst_row - p);
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int row_gran = (p + vocab + 3) >> 2;
  for (int g = threadIdx.x; g < n_gran; g += blockDim.x) {
    const int gg = g0 + g;
    if (gg >= row_gran) break;
    const int c = 4 * gg - p;
    if (c >= 0 && c + 3 < vocab) {
      __stcs(dst4 + gg, src4[g]);
    } else {
      for (int j = 0; j < 4; ++j)
        if (c + j >= 0 && c + j < vocab) dst_row[c + j] = src[4 * g + j];
    }
  }
}

// The same for a 16-bit output row, whose 16-byte granules hold 8 values:
// element c sits in granule (c + p) / 8, and each value is rounded once.
// Column i of the tile holds src[i] where bit i of `marks` is set, else 0.
__device__ __forceinline__ float marked(const float* src, const uint32_t* marks, int i) {
  return (marks[i >> 5] >> (i & 31)) & 1 ? src[i] : 0.0f;
}

template <class T>
__device__ __forceinline__ void write_tile(T* dst_row, int p, const float* src,
                                           const uint32_t* marks, int g0, int n_gran, int vocab, int tid,
                                           int n_threads) {
  uint4* dst4 = reinterpret_cast<uint4*>(dst_row - p);
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int row_gran = (p + vocab + 7) >> 3;
  for (int g = tid; g < n_gran; g += n_threads) {
    const int gg = g0 + g;
    if (gg >= row_gran) break;
    const int c = 8 * gg - p;
    const uint32_t m = (marks[g >> 2] >> (8 * (g & 3))) & 0xffu;  // the granule's 8 columns
    if (c >= 0 && c + 7 < vocab) {
      float v[8] = {};
      if (m) {
        const float4 lo = src4[2 * g], hi = src4[2 * g + 1];
        const float all[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (m >> j) & 1 ? all[j] : 0.0f;
      }
      __stcs(dst4 + gg, make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]),
                                   pack2<T>(v[4], v[5]), pack2<T>(v[6], v[7])));
    } else {
      for (int j = 0; j < 8; ++j)
        if (c + j >= 0 && c + j < vocab) dst_row[c + j] = from_f32<T>(marked(src, marks, 8 * g + j));
    }
  }
}

// One (row, tile) block: zero the tile, add the row's wire entries that
// land in it, clients in order, then write the tile once.  The tile sums
// in fp32 whatever the output type Out; a tile spans whole 16-byte
// granules of the output row, kG values each.
template <class Wire, class Out>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_wire_kernel(Wire wire, const int32_t* __restrict__ idx, Out* __restrict__ num,
                        Out* __restrict__ den, int n_clients, int rows, int k, int vocab,
                        int gran_per_tile) {
  constexpr int kG = 16 / (int)sizeof(Out);
  extern __shared__ __align__(16) float tile[];  // num then den, kG * gran_per_tile each
  const int t = blockIdx.x, r = blockIdx.y;
  const int width = kG * gran_per_tile;
  float* s_num = tile;
  float* s_den = tile + width;
  Out* num_r = num + (size_t)r * vocab;
  Out* den_r = den + (size_t)r * vocab;
  const int p = (int)(((uintptr_t)num_r / sizeof(Out)) & (kG - 1));
  const int c0 = t * width - p;  // column of s_num[0]

  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < kG / 2 * gran_per_tile; i += blockDim.x)
    t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // The row's N*k entries, client-major, kBatch a thread at a time: every
  // index of the batch is loaded at once, then the values of the entries
  // this tile owns, then the adds, one client after the other.
  const int total = n_clients * k, step = kBatch * blockDim.x;
  for (int e0 = 0; e0 < total; e0 += step) {
    int off[kBatch], cl[kBatch];
    size_t at[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * blockDim.x + threadIdx.x;
      off[i] = -1;
      cl[i] = e / k;
      at[i] = ((size_t)cl[i] * rows + r) * k + (e - cl[i] * k);
      if (e < total) {
        const int c = __ldg(idx + at[i]);
        // out-of-range entries are dropped
        if ((unsigned)c < (unsigned)vocab && (unsigned)(c - c0) < (unsigned)width) off[i] = c - c0;
      }
    }
    float2 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (off[i] >= 0) v[i] = wire(at[i], (size_t)cl[i] * rows + r);
    const int n_last = (min(total, e0 + step) - 1) / k;
    for (int n = e0 / k; n <= n_last; ++n) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        // a zero contribution (the padding) leaves the sum as it is; the
        // rest of one client's entries have distinct indices
        if (off[i] >= 0 && cl[i] == n && (v[i].x != 0.0f || v[i].y != 0.0f)) {
          s_num[off[i]] = __fadd_rn(s_num[off[i]], v[i].x);
          s_den[off[i]] = __fadd_rn(s_den[off[i]], v[i].y);
        }
      }
      __syncthreads();  // client n lands before client n+1 adds
    }
  }

  write_tile(num_r, p, s_num, t * gran_per_tile, gran_per_tile, vocab);
  const int pd = (int)(((uintptr_t)den_r / sizeof(Out)) & (kG - 1));
  if (pd == p) {
    write_tile(den_r, p, s_den, t * gran_per_tile, gran_per_tile, vocab);
  } else {  // den on another 16-byte phase than num: element by element
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      const int c = c0 + i;
      if (c >= 0 && c < vocab) den_r[c] = from_f32<Out>(s_den[i]);
    }
  }
}

// What a block may opt into on the current device, looked up once per
// device, and the kernel's opt-in raised to `bytes` once (both calls cost
// host time on every launch).
template <class Kernel>
cudaError_t smem_for(Kernel kern, int bytes_needed_per_gran, int gran, int& tiles, int& per_tile) {
  static int optin[64] = {}, granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    err = cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  // the fewest tiles whose num and den fit one block
  for (tiles = 1;; ++tiles) {
    per_tile = (gran + tiles - 1) / tiles;
    if (per_tile * bytes_needed_per_gran <= optin[dev]) break;
  }
  const int bytes = per_tile * bytes_needed_per_gran;
  if (granted[dev] < bytes) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    granted[dev] = bytes;
  }
  return cudaSuccess;
}

template <class Wire, class Out>
int launch_scatter(const Wire& wire, const int32_t* idx, Out* num, Out* den, int n_clients,
                   int rows, int k, int vocab, cudaStream_t stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  constexpr int kG = 16 / (int)sizeof(Out);  // values of a 16-byte output granule
  // the fp32 sums of num and den behind one output granule each
  constexpr int kGranBytes = 2 * kG * (int)sizeof(float);
  const int gran = (vocab + 2 * kG - 2) / kG;  // granules of a row at its worst phase
  auto kern = scatter_wire_kernel<Wire, Out>;
  int tiles = 0, per_tile = 0;
  const cudaError_t err = smem_for(kern, kGranBytes, gran, tiles, per_tile);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(tiles, rows), kScatterThreads, per_tile * kGranBytes, stream>>>(
      wire, idx, num, den, n_clients, rows, k, vocab, per_tile);
  return (int)cudaGetLastError();
}

// -- the 16-bit wire scatter (bf16 and fp16) ------------------------------------

constexpr int kChunk = 1024;                          // wire entries of one client a chunk
constexpr int k16Consumers = 256;                     // threads that add and write
constexpr int k16Threads = k16Consumers + 64;         // + the producer and the releaser warps
constexpr int kPerThread = (kChunk + k16Consumers - 1) / k16Consumers;  // entries a chunk
constexpr int k16TileGran = 800;                      // output granules (8 values) of the smallest tile
constexpr int kMaxCluster = 8;                        // the portable cluster size
constexpr int kRing = 3;                              // chunks in flight
constexpr int kIdxBytes = kChunk * 4 + 16;            // a chunk's granules: its entries + one
constexpr int kValBytes = kChunk * 2 + 16;
constexpr int kSlotBytes = kIdxBytes + 2 * kValBytes;
constexpr int kRingOffset = 128;                      // after the 3 * kRing mbarriers
constexpr int kMarksOffset = kRingOffset + kRing * kSlotBytes;  // a bit a column: added to

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrive on the mbarrier at `bar`'s offset in the shared memory of CTA
// `rank` of the cluster.  Its default release is the CTA's: the slot's
// reads it releases have returned their values before the barrier that
// precedes it (a release at cluster scope measured ~1.3 K cycles a chunk).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
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

// `bytes` from global `src` into shared `dst` of every CTA in `mask` (the
// same offset in each), each completing on its own mbarrier at `bar`'s offset.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, uintptr_t src, uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  if (mask == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
  }
}

// The 16-byte granules of global memory that hold `len` entries of `size`
// bytes from element `e` of `base`: the first granule's address, their
// bytes, and the bytes before entry e in the first.
struct Span {
  uintptr_t lo;
  uint32_t bytes, head;
};

__device__ __forceinline__ Span span_of(const void* base, size_t e, int len, int size) {
  const uintptr_t at = (uintptr_t)base + e * size;
  const uintptr_t lo = at & ~(uintptr_t)15, hi = (at + (size_t)len * size + 15) & ~(uintptr_t)15;
  return {lo, (uint32_t)(hi - lo), (uint32_t)(at - lo)};
}

// Chunk i of row r's wire: client n, its entries [j0, j0 + len), and their
// spans in idx, a and b.
struct Chunk {
  int n, len;
  Span idx, a, b;
};

__device__ __forceinline__ Chunk chunk_at(int i, int r, const int32_t* idx, const void* a,
                                          const void* b, int rows, int k, int per_client) {
  Chunk c;
  c.n = i / per_client;
  const int j0 = (i - c.n * per_client) * kChunk;
  c.len = min(kChunk, k - j0);
  const size_t e = ((size_t)c.n * rows + r) * k + j0;
  c.idx = span_of(idx, e, c.len, 4);
  c.a = span_of(a, e, c.len, 2);
  c.b = span_of(b, e, c.len, 2);
  return c;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(k16Consumers) : "memory");
}


__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One (row, tile) CTA of a cluster of `cluster` tiles of the row: threads
// [0, k16Consumers) add the wire's chunks into the tile's fp32 sums as
// they land, clients in order, and write the tile in T (bf16 or fp16) once;
// one thread of the cluster's first CTA feeds every CTA's ring, and one
// warp of each CTA hands its slots back as its consumer warps finish them.
template <class T>
__global__ void __launch_bounds__(k16Threads)
    scatter_wire_16_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const int32_t* __restrict__ idx, T* __restrict__ num,
                           T* __restrict__ den, int n_clients, int rows, int k, int vocab,
                           int gran_per_tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // chunk landed, one a slot
  uint64_t* done = full + kRing;                       // this CTA's consumer warps are through it
  uint64_t* empty = done + kRing;                      // released by every CTA (the first CTA's)
  const int t = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int width = 8 * gran_per_tile;
  const int mark_words = (gran_per_tile + 15) / 16 * 4;  // a byte a granule
  uint32_t* marks = reinterpret_cast<uint32_t*>(smem + kMarksOffset);
  float* s_num = reinterpret_cast<float*>(marks + mark_words);
  float* s_den = s_num + width;
  const uint32_t ring = smem_u32(smem + kRingOffset);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per_client = (k + kChunk - 1) / kChunk;
  const int n_chunks = n_clients * per_client;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&done[s]), k16Consumers / 32);
      mbar_init(smem_u32(&empty[s]), n_ranks);
    }
    for (int i = 0; i < min(kRing, n_chunks); ++i) {
      const Chunk c = chunk_at(i, r, idx, a, b, rows, k, per_client);
      mbar_expect_tx(smem_u32(&full[i]), c.idx.bytes + c.a.bytes + c.b.bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  cluster_arrive_relaxed();  // this CTA's mbarriers are set (the fence above releases them)
  if (tid < k16Consumers)  // no column marked yet: the sums need no zero-fill
    for (int i = tid; i < mark_words; i += k16Consumers) marks[i] = 0u;
  cluster_wait();  // every CTA's mbarriers are set before any chunk lands

  if (tid >= k16Consumers + 32) {  // the releaser: a slot back to the first CTA once done
    if (tid != k16Consumers + 32) return;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kRing;
      mbar_wait(smem_u32(&done[s]), (i / kRing) & 1);
      if (i + kRing < n_chunks) {
        const Chunk nc = chunk_at(i + kRing, r, idx, a, b, rows, k, per_client);
        mbar_expect_tx(smem_u32(&full[s]), nc.idx.bytes + nc.a.bytes + nc.b.bytes);
      }
      mbar_arrive_remote(smem_u32(&empty[s]), 0);
    }
    return;
  }
  if (tid >= k16Consumers) {  // the producer: one thread of the first CTA
    if (rank != 0 || tid != k16Consumers) return;
    const uint16_t mask = (uint16_t)((1u << n_ranks) - 1);
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kRing;
      if (i >= kRing) mbar_wait(smem_u32(&empty[s]), (i / kRing - 1) & 1);
      const Chunk c = chunk_at(i, r, idx, a, b, rows, k, per_client);
      const uint32_t dst = ring + s * kSlotBytes, bar = smem_u32(&full[s]);
      bulk_multicast(dst, c.idx.lo, c.idx.bytes, bar, mask);
      bulk_multicast(dst + kIdxBytes, c.a.lo, c.a.bytes, bar, mask);
      bulk_multicast(dst + kIdxBytes + kValBytes, c.b.lo, c.b.bytes, bar, mask);
    }
    // every CTA has released the last chunks: no remote arrive and no
    // multicast of this CTA's is still on its way when it exits
    for (int i = max(0, n_chunks - kRing); i < n_chunks; ++i)
      mbar_wait(smem_u32(&empty[i % kRing]), (i / kRing) & 1);
    return;
  }

  T* num_r = num + (size_t)r * vocab;
  T* den_r = den + (size_t)r * vocab;
  const int p = (int)(((uintptr_t)num_r / 2) & 7);
  const int c0 = t * width - p;  // column of s_num[0]
  consumers_sync();  // no column is marked

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kRing;
    const Chunk c = chunk_at(i, r, idx, a, b, rows, k, per_client);
    const unsigned char* slot = smem + kRingOffset + s * kSlotBytes;
    const int32_t* w_idx = reinterpret_cast<const int32_t*>(slot + c.idx.head);
    const uint16_t* w_a = reinterpret_cast<const uint16_t*>(slot + kIdxBytes + c.a.head);
    const uint16_t* w_b = reinterpret_cast<const uint16_t*>(slot + kIdxBytes + kValBytes + c.b.head);
    mbar_wait(smem_u32(&full[s]), (i / kRing) & 1);
    // this thread's entries of the chunk out of the slot first, then the
    // slot back, then the adds
    int off[kPerThread];
    float va[kPerThread], vb[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int j = tid + q * k16Consumers;
      const int col = j < c.len ? w_idx[j] : -1;
      // out-of-range entries are dropped
      off[q] = (unsigned)col < (unsigned)vocab && (unsigned)(col - c0) < (unsigned)width ? col - c0 : -1;
      va[q] = off[q] >= 0 ? from_bits<T>(w_a[j]) : 0.0f;
      vb[q] = off[q] >= 0 ? from_bits<T>(w_b[j]) : 0.0f;
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(smem_u32(&done[s]));  // this warp is through the slot
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      // a zero contribution (the padding) leaves the sum as it is; the
      // rest of one client's entries have distinct indices, so only this
      // thread tests or sets its column's mark (other bits of the word may
      // be set meanwhile)
      if (off[q] >= 0 && (va[q] != 0.0f || vb[q] != 0.0f)) {
        const int o = off[q];
        const uint32_t bit = 1u << (o & 31);
        const bool seen = marks[o >> 5] & bit;
        s_num[o] = __fadd_rn(seen ? s_num[o] : 0.0f, va[q]);  // a first add is onto +0
        s_den[o] = __fadd_rn(seen ? s_den[o] : 0.0f, vb[q]);
        if (!seen) atomicOr(&marks[o >> 5], bit);
      }
    }
    if ((i + 1) % per_client == 0) consumers_sync();  // client n lands before client n+1 adds
  }

  write_tile(num_r, p, s_num, marks, t * gran_per_tile, gran_per_tile, vocab, tid, k16Consumers);
  const int pd = (int)(((uintptr_t)den_r / 2) & 7);
  if (pd == p) {
    write_tile(den_r, p, s_den, marks, t * gran_per_tile, gran_per_tile, vocab, tid, k16Consumers);
  } else {  // den on another 16-byte phase than num: element by element
    for (int i = tid; i < width; i += k16Consumers) {
      const int col = c0 + i;
      if (col >= 0 && col < vocab) den_r[col] = from_f32<T>(marked(s_den, marks, i));
    }
  }
}

// A row cut into `tiles` column tiles of `per_tile` granules, in clusters
// of `cluster`, a CTA taking `bytes` of shared memory.
struct Tiling {
  int cluster, tiles, per_tile, bytes;
};

Tiling cut_row(int gran, int want) {
  Tiling t;
  t.cluster = min(kMaxCluster, want);
  t.tiles = (want + t.cluster - 1) / t.cluster * t.cluster;
  t.per_tile = (gran + t.tiles - 1) / t.tiles;
  t.bytes = kMarksOffset + (t.per_tile + 15) / 16 * 16 + t.per_tile * 8 * 2 * (int)sizeof(float);
  return t;
}

cudaLaunchConfig_t scatter_config(const Tiling& t, int rows, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)t.tiles, (unsigned)rows);
  cfg.blockDim = dim3(k16Threads);
  cfg.dynamicSmemBytes = (size_t)t.bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)t.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cut of a row: the most tiles (down to k16TileGran granules each)
// whose grid the card holds at once -- as many CTAs an SM as their shared
// memory allows, clusters placed within a GPC (cudaOccupancyMaxActiveClusters)
// -- so that more, smaller tiles never cost a second wave; where none does
// (many rows), tiles of k16TileGran granules.  Looked up once per device,
// shape and element type.
template <class T>
cudaError_t tiling16(int rows, int vocab, Tiling* out) {
  static int optin[64] = {};
  static int last_rows[64] = {}, last_vocab[64] = {};
  static Tiling last[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (last_rows[dev] == rows && last_vocab[dev] == vocab) {
    *out = last[dev];
    return cudaSuccess;
  }
  if (optin[dev] == 0) {  // raise the kernel's opt-in once, to all a block may have
    int bytes = 0;
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scatter_wire_16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return err;
    optin[dev] = bytes;
  }
  const int gran = (vocab + 14) / 8;  // granules of a row at its worst phase
  const int most = (gran + k16TileGran - 1) / k16TileGran;
  Tiling best = cut_row(gran, most);
  for (int want = 1; want < most; ++want) {
    const Tiling t = cut_row(gran, want);
    if (t.bytes > optin[dev]) continue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = scatter_config(t, rows, 0, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, scatter_wire_16_kernel<T>, &cfg);
    if (err != cudaSuccess) return err;
    if ((long long)rows * (t.tiles / t.cluster) <= clusters) best = t;
  }
  last_rows[dev] = rows;
  last_vocab[dev] = vocab;
  *out = last[dev] = best;
  return cudaSuccess;
}

template <class T>
int launch_scatter16(const T* a, const T* b, const int32_t* idx, T* num, T* den, int n_clients,
                     int rows, int k, int vocab, cudaStream_t stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  Tiling t;
  cudaError_t err = tiling16<T>(rows, vocab, &t);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = scatter_config(t, rows, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, scatter_wire_16_kernel<T>, a, b, idx, num, den, n_clients, rows, k,
                           vocab, t.per_tile);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class T>
__global__ void sparse_aggregate_kernel(const T* __restrict__ x, T* __restrict__ out,
                                        int n_clients, size_t elems) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= elems) return;
  float num = 0.0f, den = 0.0f;
  for (int n = 0; n < n_clients; ++n) {
    const float v = to_f32(x[(size_t)n * elems + i]);
    const float s = fabsf(v);
    num = __fadd_rn(num, __fmul_rn(s, v));
    den = __fadd_rn(den, s);
  }
  out[i] = from_f32<T>(__fdiv_rn(num, __fadd_rn(den, 1e-12f)));
}

template <class T>
int launch_aggregate(const T* x, T* out, int n_clients, int rows, int vocab, void* stream) {
  const size_t elems = (size_t)rows * vocab;
  if (elems == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((elems + kThreads - 1) / kThreads);
  sparse_aggregate_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, out, n_clients,
                                                                            elems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n_clients, rows, vocab) fp32; out: (rows, vocab) fp32.
int sparse_aggregate_f32(const float* x, float* out, int n_clients, int rows,
                         int vocab, void* stream) {
  return launch_aggregate(x, out, n_clients, rows, vocab, stream);
}

// x: (n_clients, rows, vocab) bf16; out: (rows, vocab) bf16, the fp32 result rounded.
int sparse_aggregate_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, int n_clients, int rows,
                          int vocab, void* stream) {
  return launch_aggregate(x, out, n_clients, rows, vocab, stream);
}

// x: (n_clients, rows, vocab) fp16; out: (rows, vocab) fp16, the fp32 result rounded.
int sparse_aggregate_f16(const __half* x, __half* out, int n_clients, int rows, int vocab,
                         void* stream) {
  return launch_aggregate(x, out, n_clients, rows, vocab, stream);
}

int scatter_wire_sums_f32(const float* a, const float* b, const int32_t* idx,
                          float* num, float* den, int n_clients, int rows,
                          int k, int vocab, void* stream) {
  const FloatWire<float> wire{a, b};
  return launch_scatter(wire, idx, num, den, n_clients, rows, k, vocab, (cudaStream_t)stream);
}

// a, b: (n_clients, rows, k) bf16; num, den: (rows, vocab) bf16, the fp32 sums rounded.
int scatter_wire_sums_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b, const int32_t* idx,
                           __nv_bfloat16* num, __nv_bfloat16* den, int n_clients, int rows,
                           int k, int vocab, void* stream) {
  return launch_scatter16(a, b, idx, num, den, n_clients, rows, k, vocab, (cudaStream_t)stream);
}

// a, b: (n_clients, rows, k) fp16; num, den: (rows, vocab) fp16, the fp32 sums rounded.
int scatter_wire_sums_f16(const __half* a, const __half* b, const int32_t* idx, __half* num,
                          __half* den, int n_clients, int rows, int k, int vocab, void* stream) {
  return launch_scatter16(a, b, idx, num, den, n_clients, rows, k, vocab, (cudaStream_t)stream);
}

int scatter_wire_sums_dequant_i8(const int8_t* q, const float* scale,
                                 const uint8_t* mask, const int32_t* idx,
                                 float* num, float* den, int n_clients,
                                 int rows, int k, int vocab, int mode,
                                 void* stream) {
  if (mode < kAdaptive || mode > kMeanNonzero) return (int)cudaErrorInvalidValue;
  const Int8Wire wire{q, scale, mask, mode};
  return launch_scatter(wire, idx, num, den, n_clients, rows, k, vocab, (cudaStream_t)stream);
}

}  // extern "C"
