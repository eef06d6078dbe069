// H2O cumulative-attention scores: column sums of the scoring softmax, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scope_tpu/ops/pallas/flash_prefill.py ::
// colsum_scores (_colsum_kernel).  Given the scoring softmax's row max m2
// and normalizer l2 (from flash_prefill), it recomputes QK^T and sums, for
// each key, exp(s - m2) / l2 over the real query rows, under the same pad
// and trailing w x w tail mask.  One CUDA block owns 64 keys of one
// (batch, head) and walks the query tiles of the real rows in ascending
// order, keeping its partial sums in registers; the partial sums of a key
// are then added in a fixed order.  No atomics: the result is the same on
// every run, so near-tied top-k picks in compress_prefill cannot flip
// between runs.  Key tiles past true_len write 0 and do no work.
//
// Bound on the card.  Per (batch, head) it reads O(S*D) bytes and does
// 2*D operations and one exp per (real row, real key) pair.  At D = 64 the
// exps on the special-function unit bound it; at D = 128 the tensor-core
// operations and the exps take about equal time.
//
// bf16 inputs (colsum_tc, the main path) run on the tensor cores: one
// warpgroup computes S^T = K Q^T by wgmma (bf16 -> float32), so that a key
// is an accumulator row; K stays resident in shared memory and the Q tiles
// stream through a double buffer that TMA fills under mbarriers, in the
// swizzled layout wgmma reads (mma.cuh).  The normalizer is folded into
// one offset per row when its stats are loaded, off_i = m2_i * log2(e) +
// log2(safe l2_i), so each element costs one FMA and one ex2.approx:
// p = 2^(q.k * scale * log2(e) - off_i), with no divide.  Rows past
// true_len get off = +inf (p = 0), so only key tiles that reach the w x w
// tail or past true_len build masks.
//
// float32 inputs (colsum_kernel) keep the exact float32 FMA products from
// shared memory, within 2e-4 of the plain version.

#include "mma.cuh"

namespace scope {

template <int D>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
    load_tile_t<D>(Kt, k + base, k_lo, S);
    // Rows at or past true_len contribute nothing (row_real).
    const int n_qt = (n_real + BQ - 1) / BQ;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_lo = qt * BQ;
      __syncthreads();               // last tile's readers are done
      load_tile_t<D>(Qt, q + base, q_lo, S);
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

template <int D>
cudaError_t launch(const void* q, const void* k, const int* true_len,
                   const float* m2, const float* l2, float* out, int B, int H,
                   int S, int w, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * TPAD + 2 * BQ + 16 * BK);
  auto kernel = colsum_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BK - 1) / BK, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), true_len,
      m2, l2, out, H, S, w, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

// off_i of one query row: 2^(q.k * scale * log2(e) - off_i) is row i's
// scoring probability; rows past true_len get +inf and so contribute 0.
__device__ __forceinline__ float row_offset(bool real, float m2, float l2) {
  return real ? fmaf(m2, tc::LOG2E, log2f(l2 > 0.f ? l2 : 1.f)) : INFINITY;
}

template <int D>
__global__ void __launch_bounds__(tc::NTHREADS)
colsum_tc(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const int* __restrict__ true_len, const float* __restrict__ m2,
          const float* __restrict__ l2, float* __restrict__ out, int H,
          int S, int w, float scale) {
  using namespace tc;
  constexpr int TILE = ROWS * D * 2;             // bytes of one bf16 tile
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* gen;
  // K | Q0 Q1 | offsets [2][ROWS] | one mbarrier per stage
  const uint32_t sK = aligned_smem(smem_tc, gen);
  float* offs = reinterpret_cast<float*>(gen + 3 * TILE);
  const uint32_t bars = sK + 3 * TILE + 2 * ROWS * sizeof(float);
  const int bh = blockIdx.y;
  const int tl = true_len[bh / H];
  const int n_real = max(0, min(tl, S));
  const int k_lo = blockIdx.x * ROWS, k_hi = k_lo + ROWS - 1;
  const size_t rbase = (size_t)bh * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const int kr = k_lo + warp * 16 + (lane >> 2);  // keys kr, kr + 8

  if (k_lo >= n_real) {                          // keys past true_len
    if (tid < ROWS && k_lo + tid < S) out[rbase + k_lo + tid] = 0.f;
    return;
  }

  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {                                // K and the first Q tile
    mbar_expect(bars, 2 * TILE);
    tma_tile<D>(sK, &tk, bars, k_lo, bh);
    tma_tile<D>(sK + TILE, &tq, bars, 0, bh);
  }
  if (tid < ROWS)
    offs[tid] = row_offset(tid < n_real, tid < n_real ? m2[rbase + tid] : 0.f,
                           tid < n_real ? l2[rbase + tid] : 1.f);
  __syncthreads();

  // Only key tiles that reach the tail or pad keys need masks; pad rows
  // are masked by their +inf offsets.
  const bool edge = k_hi >= tl - w || k_hi >= n_real;
  const float c = scale * LOG2E;
  const int n_qt = (n_real + ROWS - 1) / ROWS;
  float acc[2] = {0.f, 0.f};
  for (int qt = 0; qt < n_qt; ++qt) {
    const int stage = qt & 1;
    const bool more = qt + 1 < n_qt;
    const int nr = (qt + 1) * ROWS + tid;        // a row of the next tile
    float nm = 0.f, nl = 1.f;
    if (more) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * (stage ^ 1);
        mbar_expect(bar, TILE);
        tma_tile<D>(sK + TILE * (1 + (stage ^ 1)), &tq, bar, (qt + 1) * ROWS,
                    bh);
      }
      if (tid < ROWS && nr < n_real) {           // consumed after compute
        nm = m2[rbase + nr];
        nl = l2[rbase + nr];
      }
    }
    mbar_wait(bars + 8 * stage, (qt >> 1) & 1);  // this tile has landed

    float s[8][4];                               // keys x rows, raw q.k
    mma_abt<D>(sK, sK + TILE * (1 + stage), s);
    const float* off = offs + stage * ROWS;
    if (!edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 o2 =
            *reinterpret_cast<const float2*>(off + n * 8 + 2 * t4);
        acc[0] += ex2(fmaf(s[n][0], c, -o2.x)) + ex2(fmaf(s[n][1], c, -o2.y));
        acc[1] += ex2(fmaf(s[n][2], c, -o2.x)) + ex2(fmaf(s[n][3], c, -o2.y));
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          const int qi = qt * ROWS + col, kj = kr + (e >> 1) * 8;
          const bool keep =
              kj < n_real && !(qi >= tl - w && kj >= tl - w && kj > qi);
          acc[e >> 1] += keep ? ex2(fmaf(s[n][e], c, -off[col])) : 0.f;
        }
    }
    if (more && tid < ROWS)
      offs[(stage ^ 1) * ROWS + tid] = row_offset(nr < n_real, nm, nl);
    __syncthreads();                             // stage free for reuse
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float total = quad_sum(acc[i]);        // fixed order
    const int kj = kr + i * 8;
    if (t4 == 0 && kj < S) out[rbase + kj] = total;
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const int* true_len,
                      const float* m2, const float* l2, float* out, int B,
                      int H, int S, int w, float scale, cudaStream_t stream) {
  const size_t smem = 3 * tc::ROWS * D * sizeof(__nv_bfloat16) +
                      2 * tc::ROWS * sizeof(float) + 16 + 1024;
  auto kernel = colsum_tc<D>;
  cudaError_t err = tc::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk;
  if ((err = tc::tensor_map(&tq, q, B * H, S, D)) != cudaSuccess ||
      (err = tc::tensor_map(&tk, k, B * H, S, D)) != cudaSuccess)
    return err;
  const dim3 grid((S + tc::ROWS - 1) / tc::ROWS, B * H);
  kernel<<<grid, tc::NTHREADS, smem, stream>>>(tq, tk, true_len, m2, l2, out,
                                               H, S, w, scale);
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
    return launch<64>(q, k, true_len, m2, l2, out, B, H, S, w, scale, stream);
  if (dtype == kFloat32 && D == 128)
    return launch<128>(q, k, true_len, m2, l2, out, B, H, S, w, scale, stream);
  if (dtype == kBFloat16 && D == 64)
    return launch_tc<64>(q, k, true_len, m2, l2, out, B, H, S, w, scale,
                         stream);
  if (dtype == kBFloat16 && D == 128)
    return launch_tc<128>(q, k, true_len, m2, l2, out, B, H, S, w, scale,
                          stream);
  return (int)cudaErrorInvalidValue;
}
