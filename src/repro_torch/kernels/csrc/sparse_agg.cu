// Adaptive-aggregation kernels (paper eqs. 6-7): the dense-stack kernel
// and the wire scatter-accumulate kernels for the sparse uplink.
//
// Replaces the three TPU kernels of src/repro/kernels/sparse_agg.py:
//   sparse_aggregate_f32         <- sparse_agg_pallas (_agg_kernel)
//   scatter_wire_sums_f32        <- scatter_wire_sums_pallas (_scatter_wire_kernel)
//   scatter_wire_sums_dequant_i8 <- scatter_wire_sums_dequant_pallas
//                                   (_scatter_wire_dequant_kernel)
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
// The wire kernels compute, for a cohort wire of N clients x rows x k entries:
//   num[r, idx[n,r,j]] += a[n,r,j]      den[r, idx[n,r,j]] += b[n,r,j]
// summed over the clients n = 0..N-1 IN ORDER.  The dequant variant first
// rebuilds each entry's value v = ((float)q * scale[n,r]) * mask and the
// aggregation mode's two channels: (|v|*v, |v|) for adaptive, (v, mask) for
// zeropad / mean_nonzero.
//
// What bounds them on H100: bytes.  The outputs are dense, 2*rows*V*4 bytes
// (25.7 MB at rows=64, V=50257), against N*rows*k*12 bytes of wire read
// (3.1 MB at N=4, k=1024) and no arithmetic to speak of, so the least time
// is the dense write at the card's memory rate (~9 us at 3.35 TB/s).
//
// Design.  The Pallas kernel carries two (rows_blk, V) accumulators in VMEM
// across a sequential client loop.  Two fp32 rows of V=50257 take 402 KB,
// more than the 227 KB of shared memory a Hopper block can have, so here a
// block owns one output row and accumulates IN GLOBAL MEMORY, in the rows it
// owns: it zero-fills num[r,:] and den[r,:], then walks the clients in
// order, its threads striding over the k entries of (n, r) with atomicAdd
// and a __syncthreads() between clients.  Within one (n, r) the top-k
// indices are distinct; the only repeats are wire padding at index 0, which
// carries exact zeros (pad_wire), so the atomics of one client commute
// exactly and the result is bitwise deterministic and bitwise equal to a
// plain version that scatters one client at a time.  (A plain store instead
// of atomicAdd would let a padding zero clobber a real index-0 entry.)  The
// dense write is spread over `rows` blocks of 256 threads; nothing carries
// over between blocks.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (no fast math: the value math must be IEEE).
// Plain C interface, loaded through ctypes; each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Mode { kAdaptive = 0, kZeropad = 1, kMeanNonzero = 2 };

__device__ __forceinline__ void zero_row(float* num, float* den, int vocab) {
  for (int c = threadIdx.x; c < vocab; c += blockDim.x) {
    num[c] = 0.0f;
    den[c] = 0.0f;
  }
}

__global__ void scatter_wire_f32_kernel(const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        const int32_t* __restrict__ idx,
                                        float* __restrict__ num,
                                        float* __restrict__ den, int n_clients,
                                        int rows, int k, int vocab) {
  const int r = blockIdx.x;
  float* num_r = num + (size_t)r * vocab;
  float* den_r = den + (size_t)r * vocab;
  zero_row(num_r, den_r, vocab);
  __syncthreads();
  for (int n = 0; n < n_clients; ++n) {
    const size_t base = ((size_t)n * rows + r) * k;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      const int c = idx[base + j];
      if ((unsigned)c < (unsigned)vocab) {  // out-of-range entries are dropped
        atomicAdd(num_r + c, a[base + j]);
        atomicAdd(den_r + c, b[base + j]);
      }
    }
    __syncthreads();  // client n lands before client n+1 adds
  }
}

__global__ void scatter_wire_dequant_i8_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scale,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ idx,
    float* __restrict__ num, float* __restrict__ den, int n_clients, int rows,
    int k, int vocab, int mode) {
  const int r = blockIdx.x;
  float* num_r = num + (size_t)r * vocab;
  float* den_r = den + (size_t)r * vocab;
  zero_row(num_r, den_r, vocab);
  __syncthreads();
  for (int n = 0; n < n_clients; ++n) {
    const size_t base = ((size_t)n * rows + r) * k;
    const float s = scale[(size_t)n * rows + r];
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      const int c = idx[base + j];
      if ((unsigned)c < (unsigned)vocab) {
        const float m = mask[base + j] ? 1.0f : 0.0f;
        // same order as the reference: (q * scale) * mask
        const float v = ((float)q[base + j] * s) * m;
        float ca, cb;
        if (mode == kAdaptive) {
          cb = fabsf(v);
          ca = cb * v;
        } else {
          ca = v;
          cb = m;
        }
        atomicAdd(num_r + c, ca);
        atomicAdd(den_r + c, cb);
      }
    }
    __syncthreads();
  }
}

__global__ void sparse_aggregate_f32_kernel(const float* __restrict__ x,
                                            float* __restrict__ out,
                                            int n_clients, size_t elems) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= elems) return;
  float num = 0.0f, den = 0.0f;
  for (int n = 0; n < n_clients; ++n) {
    const float v = x[(size_t)n * elems + i];
    const float s = fabsf(v);
    num = __fadd_rn(num, __fmul_rn(s, v));
    den = __fadd_rn(den, s);
  }
  out[i] = __fdiv_rn(num, __fadd_rn(den, 1e-12f));
}

}  // namespace

extern "C" {

// x: (n_clients, rows, vocab) fp32; out: (rows, vocab) fp32.
int sparse_aggregate_f32(const float* x, float* out, int n_clients, int rows,
                         int vocab, void* stream) {
  const size_t elems = (size_t)rows * vocab;
  if (elems == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((elems + kThreads - 1) / kThreads);
  sparse_aggregate_f32_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n_clients, elems);
  return (int)cudaGetLastError();
}

int scatter_wire_sums_f32(const float* a, const float* b, const int32_t* idx,
                          float* num, float* den, int n_clients, int rows,
                          int k, int vocab, void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  scatter_wire_f32_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, idx, num, den, n_clients, rows, k, vocab);
  return (int)cudaGetLastError();
}

int scatter_wire_sums_dequant_i8(const int8_t* q, const float* scale,
                                 const uint8_t* mask, const int32_t* idx,
                                 float* num, float* den, int n_clients,
                                 int rows, int k, int vocab, int mode,
                                 void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  if (mode < kAdaptive || mode > kMeanNonzero) return (int)cudaErrorInvalidValue;
  scatter_wire_dequant_i8_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      q, scale, mask, idx, num, den, n_clients, rows, k, vocab, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
