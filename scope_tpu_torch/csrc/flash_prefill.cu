// Causal prefill attention with the H2O scoring softmax's row statistics,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scope_tpu/ops/pallas/flash_prefill.py ::
// flash_prefill (_flash_kernel).  One CUDA block owns 64 query rows of one
// (batch, head); the TPU's sequential key-block grid axis becomes the loop
// over 64-key tiles inside the block.  Each QK^T tile is computed once and
// feeds two online softmaxes:
//   - attention: causal (plus the optional sliding window) over real keys;
//     its probabilities, rounded to the input type, multiply V;
//   - scoring: masks only pad keys and the trailing w x w causal tail, so
//     earlier rows also see future keys; only its row max m2 and
//     normalizer l2 are kept.
// Tiles wholly above the diagonal or outside the window skip the
// attention side; tiles past true_len skip both.  Masked entries are
// NEG_INF and contribute 0 through the s > NEG_INF/2 guard, empty rows
// divide by 1, and with need_scores == 0 the kernel writes m2 = 0 and
// l2 = 1, all as in the TPU kernel.  Accumulation is float32.
//
// Bound on the card: operations.  Per (batch, head) it reads O(S*D) bytes
// and does O(S^2 * D) multiply-adds plus O(S^2) exps.  This first version
// runs the products as float32 FMAs from shared memory (no tensor cores),
// so it runs at the FP32 rate, well below the bf16 tensor-core bound that
// PERF.md states.

#include "tile.cuh"

namespace scope {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ true_len, T* __restrict__ out,
                     float* __restrict__ m2_out, float* __restrict__ l2_out,
                     int H, int S, int w, int need_scores, int window,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][TPAD]
  float* Kt = Qt + D * TPAD;                    // [D][TPAD]
  float* Pt = Kt + D * TPAD;                    // [BK][TPAD] probs^T
  float* Vs = Pt + BK * TPAD;                   // [BK][D]

  constexpr int NC = D / 64;                    // 4-wide column groups
  const int bh = blockIdx.y;
  const int tl = true_len[bh / H];
  const int n_real = max(0, min(tl, S));        // keys that exist and count
  const int q_lo = blockIdx.x * BQ;
  const int q_hi = q_lo + BQ - 1;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_t<T, D>(Qt, q + base, q_lo, S);

  float m[4], l[4], m2[4], l2[4], o[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF; l[i] = 0.f; m2[i] = NEG_INF; l2[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }

  // Keys the attention side may see: below the diagonal and real.
  const int att_end = min(q_hi + 1, n_real);
  const int n_tiles = ((need_scores ? n_real : att_end) + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_lo = kt * BK, k_hi = k_lo + BK - 1;
    // Both flags are uniform over the block, so the barriers below are too.
    const bool attend = k_lo < att_end && (window <= 0 || k_hi > q_lo - window);
    const bool score = need_scores && k_lo < n_real;
    if (!attend && !score) continue;
    __syncthreads();                 // last tile's readers are done
    load_tile_t<T, D>(Kt, k + base, k_lo, S);
    if (attend) load_tile<T, D>(Vs, v + base, k_lo, S);
    __syncthreads();

    float s[4][4];
    qk_tile<D>(Qt, Kt, ty, tx, scale, s);

    if (attend) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q_lo + ty * 4 + i;
        float sa[4], mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k_lo + tx * 4 + j;
          const bool ok = kj <= qi && kj < n_real &&
                          (window <= 0 || kj > qi - window);
          sa[j] = ok ? s[i][j] : NEG_INF;
          mx = fmaxf(mx, sa[j]);
        }
        const float m_new = fmaxf(m[i], row_max16(mx));
        const float alpha = expf(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = sa[j] > NEG_INF / 2 ? expf(sa[j] - m_new) : 0.f;
          ps += e;
          p[i][j] = round_to(e, v);
        }
        l[i] = l[i] * alpha + row_sum16(ps);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * TPAD + ty * 4) =
            make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(Pt + c * TPAD + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 b =
              *reinterpret_cast<const float4*>(Vs + c * D + g * 64 + tx * 4);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[i][g][e] = fmaf(av[i], bv[e], o[i][g][e]);
        }
      }
    }

    if (score) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q_lo + ty * 4 + i;
        float sc[4], mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k_lo + tx * 4 + j;
          const bool in_tail = qi >= tl - w && kj >= tl - w && kj > qi;
          sc[j] = (kj < n_real && !in_tail) ? s[i][j] : NEG_INF;
          mx = fmaxf(mx, sc[j]);
        }
        const float m2_new = fmaxf(m2[i], row_max16(mx));
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps += sc[j] > NEG_INF / 2 ? expf(sc[j] - m2_new) : 0.f;
        l2[i] = l2[i] * expf(m2[i] - m2_new) + row_sum16(ps);
        m2[i] = m2_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q_lo + ty * 4 + i;
    if (r >= S) continue;
    const float inv = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = o[i][g][e] / inv;
      store4(out + base + (size_t)r * D + g * 64 + tx * 4, y);
    }
    if (tx == 0) {
      m2_out[(size_t)bh * S + r] = need_scores ? m2[i] : 0.f;
      l2_out[(size_t)bh * S + r] = need_scores ? l2[i] : 1.f;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* true_len, void* out, float* m2, float* l2,
                   int B, int H, int S, int w, int need_scores, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * TPAD + BK * TPAD + BK * D);
  auto kernel = flash_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), true_len, static_cast<T*>(out), m2, l2, H, S,
      w, need_scores, window, scale);
  return cudaGetLastError();
}

}  // namespace scope

// q, k, v, out: [B, H, S, D] contiguous, dtype 0 = float32, 1 = bfloat16;
// true_len: [B] int32; m2, l2: [B, H, S] float32.  window <= 0: no sliding
// window.  Returns the launch's CUDA error code (0 on success).
extern "C" int scope_flash_prefill(const void* q, const void* k,
                                   const void* v, const int* true_len,
                                   void* out, float* m2, float* l2, int B,
                                   int H, int S, int D, int dtype, int w,
                                   int need_scores, int window, float scale,
                                   cudaStream_t stream) {
  using namespace scope;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64)
    return launch<float, 64>(q, k, v, true_len, out, m2, l2, B, H, S, w,
                             need_scores, window, scale, stream);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k, v, true_len, out, m2, l2, B, H, S, w,
                              need_scores, window, scale, stream);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, true_len, out, m2, l2, B, H, S,
                                     w, need_scores, window, scale, stream);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, true_len, out, m2, l2, B, H,
                                      S, w, need_scores, window, scale,
                                      stream);
  return (int)cudaErrorInvalidValue;
}
