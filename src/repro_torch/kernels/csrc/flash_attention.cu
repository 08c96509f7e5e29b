// Blockwise causal softmax attention, forward only (inference prefill):
//   out[b, i, :] = sum_{j <= i} softmax_j(q[b,i,:] . k[b,j,:] * D^-0.5) v[b,j,:]
// over fused head-batches q, k, v, out: (B*H, S, D) fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
//   flash_attention_f32 <- flash_attention_pallas (_flash_kernel,
//                                                  _online_update)
//
// Both keep, per query row, an online max m, normaliser l and output
// accumulator over key tiles; tiles wholly above the causal diagonal are
// skipped (never loaded), the diagonal tile is masked per element, and the
// row finishes as acc / l.  The score is (q . k) * D^-0.5, as the
// Pallas kernel computes it.
//
// What bounds it on H100: operations.  2*S*S*D*(B*H) fp32 operations (a
// multiply-add counts two) for the causal half of QK^T and PV (12.9 GFLOP at B*H=96, S=1024, D=64: ~192 us at
// the card's 67 TFLOP/s of fp32 outside the tensor cores) against 4*B*H*S*D*4
// bytes of q, k, v and out (100 MB: ~30 us at 3.35 TB/s).
//
// Design.  The Pallas grid is (B*H, q_blocks, kv_blocks) with the kv axis
// sequential and the accumulators in VMEM scratch.  Here a block owns 64
// query rows of one head-batch, one row per thread: the thread keeps its q
// row and its fp32 accumulator in registers (2 x 64 floats) and walks the key
// tiles 0..diagonal in order.  Each 64-key tile of K and V is staged in
// shared memory (2 x 64 x D x 4 bytes: 32 KB at D=64, under the 48 KB a
// block gets without opting in) by the block's threads with 16-byte loads;
// every thread then reads the same K/V row at once (a broadcast, no bank
// conflicts).  Keys go through the online update 16 at a time: scores of
// the chunk, its max over the keys this row may see, one rescale of l and
// acc, then p = exp(s - m) into l and acc.  A masked key is never read into
// the max or the sums, so the outputs of rows before a position do not
// depend on k or v at or after it, bit for bit.  Products run in fp32 on
// CUDA cores; wgmma and TMA are a later change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC.
// Plain C interface, loaded through ctypes; the entry point launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;   // query rows per block = threads per block
constexpr int kKeys = 64;   // keys per staged tile
constexpr int kChunk = 16;  // keys per online update
constexpr int D = 64;       // head dim (GPT-2 small and large)
constexpr int D4 = D / 4;

__global__ void __launch_bounds__(kRows)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int seq, float scale) {
  __shared__ float4 ks[kKeys][D4];
  __shared__ float4 vs[kKeys][D4];

  const size_t base = (size_t)blockIdx.y * seq * D;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + threadIdx.x;  // this thread's query row
  const bool live = qi < seq;

  float qr[D], acc[D];
  const float4* q4 = reinterpret_cast<const float4*>(q + base + (size_t)qi * D);
#pragma unroll
  for (int d = 0; d < D4; ++d) {
    const float4 x = live ? q4[d] : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * d] = x.x;
    qr[4 * d + 1] = x.y;
    qr[4 * d + 2] = x.z;
    qr[4 * d + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  const float4* k4 = reinterpret_cast<const float4*>(k + base);
  const float4* v4 = reinterpret_cast<const float4*>(v + base);
  const int last_key = min(q0 + kRows, seq) - 1;  // the block's last visible key
  for (int t0 = 0; t0 <= last_key; t0 += kKeys) {
    // stage the tile; rows past the sequence are zero and never visible
    for (int e = threadIdx.x; e < kKeys * D4; e += kRows) {
      const int row = e / D4, col = e % D4;
      const bool in = t0 + row < seq;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      ks[row][col] = in ? k4[(size_t)(t0 + row) * D4 + col] : z;
      vs[row][col] = in ? v4[(size_t)(t0 + row) * D4 + col] : z;
    }
    __syncthreads();
    if (live) {
      for (int c0 = 0; c0 < kKeys && t0 + c0 <= qi; c0 += kChunk) {
        float s[kChunk];
        float cmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          float dot = 0.0f;
#pragma unroll
          for (int d = 0; d < D4; ++d) {
            const float4 kk = ks[c0 + j][d];
            dot += qr[4 * d] * kk.x;
            dot += qr[4 * d + 1] * kk.y;
            dot += qr[4 * d + 2] * kk.z;
            dot += qr[4 * d + 3] * kk.w;
          }
          s[j] = dot * scale;
          if (t0 + c0 + j <= qi) cmax = fmaxf(cmax, s[j]);
        }
        // key t0 + c0 <= qi is visible, so cmax and m_new are finite
        const float m_new = fmaxf(m, cmax);
        const float r = expf(m - m_new);  // 0 on the row's first chunk
        l *= r;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= r;
        m = m_new;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (t0 + c0 + j <= qi) {
            const float p = expf(s[j] - m);
            l += p;
#pragma unroll
            for (int d = 0; d < D4; ++d) {
              const float4 vv = vs[c0 + j][d];
              acc[4 * d] += p * vv.x;
              acc[4 * d + 1] += p * vv.y;
              acc[4 * d + 2] += p * vv.z;
              acc[4 * d + 3] += p * vv.w;
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is read before the next one overwrites it
  }
  if (live) {
    float4* o4 = reinterpret_cast<float4*>(out + base + (size_t)qi * D);
    const float inv = 1.0f / l;
#pragma unroll
    for (int d = 0; d < D4; ++d)
      o4[d] = make_float4(acc[4 * d] * inv, acc[4 * d + 1] * inv,
                          acc[4 * d + 2] * inv, acc[4 * d + 3] * inv);
  }
}

}  // namespace

extern "C" {

// q, k, v, out: (bh, seq, head_dim) fp32, contiguous, 16-byte aligned;
// head_dim 64 (else cudaErrorInvalidValue, nothing launched); scale: the
// caller's fp32 head_dim^-0.5.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, int bh, int seq, int head_dim, float scale,
                        void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || seq <= 0) return (int)cudaSuccess;
  const dim3 grid((seq + kRows - 1) / kRows, bh);
  flash_attention_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(
      q, k, v, out, seq, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
