// Dense top-k mask by fp32 threshold bisection (paper eqs. 3-4).
//
// Replaces the two TPU kernels of src/repro/kernels/topk_select.py:
//   topk_mask_f32 (dynamic = 1) <- topk_mask_dynamic_pallas (_topk_dynamic_kernel)
//   topk_mask_f32 (dynamic = 0) <- topk_mask_pallas (_topk_kernel)
//
// What they compute, per row r of x (rows, V) fp32 with budget k[r]:
//   lo = min(x[r]), hi = max(x[r]) + 1
//   30 times: mid = 0.5 * (lo + hi); if count(x[r] >= mid) >= k[r] then
//             lo = mid else hi = mid
//   out[r, c] = x[r, c] if x[r, c] >= lo (and k[r] > 0 when dynamic) else 0
// The dynamic kernel reads one int32 budget per row, clamps it to [0, V],
// and zeroes a k = 0 row (a dropped straggler); the static
// kernel takes one k = min(k, V) for every row and has no k > 0 guard.
// Ties at the threshold are all kept.
//
// What bounds them on H100: the row must be read once and the masked row
// written once, rows*V*8 bytes (25.7 MB each way at 256 x 50257, ~31 us at
// 3.35 TB/s); the 30 counting passes are on-chip work on top of that.
//
// Design.  The Pallas kernel holds a block of rows in VMEM and runs the 30
// passes there.  Here one block of 1024 threads owns one row:
//   * smem path (V*4 bytes fit the 227 KB a Hopper block can opt into):
//     the row is loaded once into dynamic shared memory, the min/max and
//     the 30 counting passes read shared memory, and the masked row is
//     written from it — one read and one write of device memory per row.
//   * global path (wider rows, e.g. 152k-256k vocabularies): the same
//     kernel with every pass re-reading the row from device memory (it
//     stays in the 50 MB L2 for a handful of rows in flight).
// The wrapper picks the path from V.  Each pass's count is an integer
// block reduction (__reduce_add_sync per warp, then the warps' partials in
// shared memory), min and max are exact, and mid / max + 1 are written
// with __fadd_rn / __fmul_rn, so every step is the same rounded fp32
// operation as the plain version's and the result is bitwise equal to it
// (and to the reference's topk_mask_dynamic), whatever the thread order.
// Every thread sums the warps' partials itself, so all threads take the
// same branch without another broadcast; the partials are double-buffered
// by pass parity so one __syncthreads() per pass suffices.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC   (no fast math: the value math must be IEEE).
// Plain C interface, loaded through ctypes; the entry point launches on the
// given stream and returns a cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 30;  // = BISECTION_ITERS of the plain version

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
    topk_mask_kernel(const float* __restrict__ x, const int32_t* __restrict__ ks,
                     float* __restrict__ out, int vocab, int k_static,
                     int dynamic) {
  extern __shared__ float row_smem[];
  __shared__ float s_min[kWarps], s_max[kWarps];
  __shared__ int s_cnt[2][kWarps];

  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xr = x + (size_t)r * vocab;
  const float* row = kSmem ? row_smem : xr;

  float lmin = INFINITY, lmax = -INFINITY;
  for (int c = threadIdx.x; c < vocab; c += kThreads) {
    const float v = xr[c];
    if (kSmem) row_smem[c] = v;
    lmin = fminf(lmin, v);
    lmax = fmaxf(lmax, v);
  }
  lmin = warp_min(lmin);
  lmax = warp_max(lmax);
  if (lane == 0) {
    s_min[warp] = lmin;
    s_max[warp] = lmax;
  }
  __syncthreads();  // also publishes the row in shared memory
  float mn = s_min[0], mx = s_max[0];
  for (int w = 1; w < kWarps; ++w) {
    mn = fminf(mn, s_min[w]);
    mx = fmaxf(mx, s_max[w]);
  }
  const int k = dynamic ? min(max(ks[r], 0), vocab) : k_static;
  float lo = mn, hi = __fadd_rn(mx, 1.0f);

  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    int cnt = 0;
    for (int c = threadIdx.x; c < vocab; c += kThreads) cnt += row[c] >= mid;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) s_cnt[it & 1][warp] = cnt;
    __syncthreads();  // pass it's partials; pass it-1's buffer is free again
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_cnt[it & 1][w];
    if (total >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  const bool live = !dynamic || k > 0;
  float* outr = out + (size_t)r * vocab;
  for (int c = threadIdx.x; c < vocab; c += kThreads) {
    const float v = row[c];
    outr[c] = (live && v >= lo) ? v : 0.0f;
  }
}

}  // namespace

extern "C" {

// Largest V the shared-memory path takes: the row plus the kernel's static
// shared memory within the 227 KB (232448 bytes) a block may opt into.
int topk_mask_smem_max_vocab(void) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, topk_mask_kernel<true>);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (optin - (int)attr.sharedSizeBytes) / (int)sizeof(float);
}

// x, out: (rows, vocab) fp32; ks: (rows,) int32 budgets (read only when
// dynamic); k_static: the static kernel's min(k, vocab).
int topk_mask_f32(const float* x, const int32_t* ks, float* out, int rows,
                  int vocab, int k_static, int dynamic, int use_smem,
                  void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_smem) {
    const size_t bytes = (size_t)vocab * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        topk_mask_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    topk_mask_kernel<true><<<rows, kThreads, bytes, s>>>(x, ks, out, vocab,
                                                          k_static, dynamic);
  } else {
    topk_mask_kernel<false><<<rows, kThreads, 0, s>>>(x, ks, out, vocab,
                                                       k_static, dynamic);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
