// Adaptive-aggregation kernels (paper eqs. 6-7): the dense-stack kernel
// and the wire scatter-accumulate kernel for the sparse uplink.
//
// Replaces the three TPU kernels of src/repro/kernels/sparse_agg.py:
//   sparse_aggregate_{f32,bf16}  <- sparse_agg_pallas (_agg_kernel)
//   scatter_wire_sums_{f32,bf16} <- scatter_wire_sums_pallas (_scatter_wire_kernel)
//   scatter_wire_sums_dequant_i8 <- scatter_wire_sums_dequant_pallas
//                                   (_scatter_wire_dequant_kernel)
//
// bf16 inputs: each bf16 entry point reads bf16, upcasts every value
// exactly, runs the fp32 kernel's arithmetic and rounds its fp32 result to
// bf16 once, as it writes (round to nearest even) -- what the reference
// computes: the Pallas kernels upcast inside, and its wrappers cast their
// fp32 results back to the input's dtype.  So the bf16 outputs are
// bitwise the plain versions' fp32 results cast to bf16, and the outputs
// move half the bytes.  The fp32 entry points are the same code as before.
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
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (no fast math: the value math must be IEEE).
// Plain C interface, loaded through ctypes; each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScatterThreads = 512;
constexpr int kBatch = 8;  // wire entries a thread has in flight

enum Mode { kAdaptive = 0, kZeropad = 1, kMeanNonzero = 2 };

// Exact upcast of an input value, and the one rounding of a result.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// The same for a bf16 output row, whose 16-byte granules hold 8 values:
// element c sits in granule (c + p) / 8, and each value is rounded once.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void write_tile(__nv_bfloat16* dst_row, int p, const float* src,
                                           int g0, int n_gran, int vocab) {
  uint4* dst4 = reinterpret_cast<uint4*>(dst_row - p);
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int row_gran = (p + vocab + 7) >> 3;
  for (int g = threadIdx.x; g < n_gran; g += blockDim.x) {
    const int gg = g0 + g;
    if (gg >= row_gran) break;
    const int c = 8 * gg - p;
    if (c >= 0 && c + 7 < vocab) {
      const float4 lo = src4[2 * g], hi = src4[2 * g + 1];
      __stcs(dst4 + gg, make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                                   pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w)));
    } else {
      for (int j = 0; j < 8; ++j)
        if (c + j >= 0 && c + j < vocab) dst_row[c + j] = __float2bfloat16_rn(src[8 * g + j]);
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
  const FloatWire<__nv_bfloat16> wire{a, b};
  return launch_scatter(wire, idx, num, den, n_clients, rows, k, vocab, (cudaStream_t)stream);
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
