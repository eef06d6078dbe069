// H2O cumulative-attention scores: column sums of the scoring softmax, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scope_tpu/ops/pallas/flash_prefill.py ::
// colsum_scores (_colsum_kernel).  Given the scoring softmax's row max m2
// and normalizer l2 (from flash_prefill), it recomputes QK^T and sums, for
// each key, exp(s - m2) / l2 over the real query rows, under the same pad
// and trailing w x w tail mask.  One CUDA block owns 64 keys of one
// (batch, head) and walks the query tiles in ascending order, keeping its
// partial sums in registers; the 16 partial sums per key are then added in
// a fixed order.  No atomics: the result is the same on every run, so
// near-tied top-k picks in compress_prefill cannot flip between runs.
//
// Bound on the card: operations.  Per (batch, head) it reads O(S*D) bytes
// and does O(S^2 * D) multiply-adds plus O(S^2) exps; key tiles past
// true_len and query rows past true_len are skipped.  The products are
// float32 FMAs from shared memory (no tensor cores in this version).

#include "tile.cuh"

namespace scope {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const int* __restrict__ true_len,
              const float* __restrict__ m2, const float* __restrict__ l2,
              float* __restrict__ out, int H, int S, int w, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][TPAD]
  float* Kt = Qt + D * TPAD;                    // [D][TPAD]
  float* m2s = Kt + D * TPAD;                   // [BQ]
  float* ls = m2s + BQ;                         // [BQ] safe l2
  float* red = ls + BQ;                         // [16][BK]

  const int bh = blockIdx.y;
  const int tl = true_len[bh / H];
  const int n_real = max(0, min(tl, S));
  const int k_lo = blockIdx.x * BK;
  const size_t base = (size_t)bh * S * D;
  const size_t rbase = (size_t)bh * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (k_lo < n_real) {
    load_tile_t<T, D>(Kt, k + base, k_lo, S);
    // Rows at or past true_len contribute nothing (row_real).
    const int n_qt = (n_real + BQ - 1) / BQ;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_lo = qt * BQ;
      __syncthreads();               // last tile's readers are done
      load_tile_t<T, D>(Qt, q + base, q_lo, S);
      if (threadIdx.x < BQ) {
        const int r = q_lo + threadIdx.x;
        const float li = r < S ? l2[rbase + r] : 1.f;
        m2s[threadIdx.x] = r < S ? m2[rbase + r] : 0.f;
        ls[threadIdx.x] = li > 0.f ? li : 1.f;
      }
      __syncthreads();
      float s[4][4];
      qk_tile<D>(Qt, Kt, ty, tx, scale, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q_lo + ty * 4 + i;
        if (qi >= n_real) continue;  // row_real
        const float mi = m2s[ty * 4 + i], li = ls[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k_lo + tx * 4 + j;
          const bool in_tail = qi >= tl - w && kj >= tl - w && kj > qi;
          const float sm = (kj < n_real && !in_tail) ? s[i][j] : NEG_INF;
          const float p = sm > NEG_INF / 2 ? expf(sm - mi) : 0.f;
          acc[j] += p / li;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * BK + tx * 4 + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < BK) {
    const int kj = k_lo + threadIdx.x;
    float total = 0.f;
    for (int t = 0; t < 16; ++t) total += red[t * BK + threadIdx.x];
    if (kj < S) out[rbase + kj] = total;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const int* true_len,
                   const float* m2, const float* l2, float* out, int B, int H,
                   int S, int w, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * TPAD + 2 * BQ + 16 * BK);
  auto kernel = colsum_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BK - 1) / BK, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), true_len, m2, l2,
      out, H, S, w, scale);
  return cudaGetLastError();
}

}  // namespace scope

// q, k: [B, H, S, D] contiguous, dtype 0 = float32, 1 = bfloat16;
// true_len: [B] int32; m2, l2, out: [B, H, S] float32.  Returns the
// launch's CUDA error code (0 on success).
extern "C" int scope_colsum_scores(const void* q, const void* k,
                                   const int* true_len, const float* m2,
                                   const float* l2, float* out, int B, int H,
                                   int S, int D, int dtype, int w,
                                   float scale, cudaStream_t stream) {
  using namespace scope;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64)
    return launch<float, 64>(q, k, true_len, m2, l2, out, B, H, S, w, scale,
                             stream);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k, true_len, m2, l2, out, B, H, S, w, scale,
                              stream);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, true_len, m2, l2, out, B, H, S, w,
                                     scale, stream);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, true_len, m2, l2, out, B, H, S,
                                      w, scale, stream);
  return (int)cudaErrorInvalidValue;
}
