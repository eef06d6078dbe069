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
// attention side; tiles past true_len skip both.  Masked entries
// contribute 0, empty rows divide by 1, and with need_scores == 0 the
// kernel writes m2 = 0 and l2 = 1, all as in the TPU kernel.
// Accumulation is float32.
//
// Bound on the card.  Per (batch, head) it reads O(S*D) bytes and does
// 2*D operations per (row, key) pair on the scoring side plus 2*D per
// causal pair on the attention side.  It needs one exp per pair of the
// scoring side: below the diagonal the attention side sees the same keys
// in the same order, so its probabilities are the scoring side's times one
// factor per row, and only the diagonal tile needs exps of its own.  At
// D = 64 the exps on the special-function unit bound it (one exp costs the
// time of ~240 bf16 tensor-core operations, a pair's QK^T is 128); at
// D = 128 the tensor-core operations do.  This kernel still evaluates the
// attention side's exps apart, about 1.5 times the least count.
//
// bf16 inputs (flash_prefill_tc, the main path) run on the tensor cores:
// one warpgroup multiplies by wgmma (bf16 -> float32) from 128-byte
// swizzled bf16 tiles in shared memory, which TMA fills, one thread asking,
// into a double buffer under mbarriers (mma.cuh); the next key tile loads
// while this one is multiplied.  Q stays resident; QK^T reads both
// operands from shared memory (with Q's fragments held in registers
// instead, the compiled D = 64 kernel put P in the same registers and
// later tiles multiplied by P), and the attention probabilities become the
// bf16 register A operand of PV straight from the accumulator (the TPU
// kernel's p.astype(v.dtype)) while l sums the unrounded float32 values.
// Exps are ex2.approx with scale * log2(e) folded into one multiplier;
// the running maxima are kept in raw q.k units, so m2 is written as
// max(scale * q.k) as in JAX.  Masks are built
// only on tiles that cross the diagonal, true_len, the w x w tail or the
// window edge; q-tiles wholly past true_len do no work, and every row at
// or past true_len writes out = 0, m2 = 0, l2 = 1 (finite: pad K/V can
// reach the cache, where decode multiplies them by zero probabilities).
//
// float32 inputs (flash_prefill_kernel) keep the exact float32 FMA
// products from shared memory, so the float32 route stays within 2e-4 of
// the plain version and token-identical to the CPU.

#include "mma.cuh"

namespace scope {

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ true_len, float* __restrict__ out,
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

  load_tile_t<D>(Qt, q + base, q_lo, S);

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
    load_tile_t<D>(Kt, k + base, k_lo, S);
    if (attend) load_tile<D>(Vs, v + base, k_lo, S);
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
          p[i][j] = e;               // p.astype(float32) is exact
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* true_len, void* out, float* m2, float* l2,
                   int B, int H, int S, int w, int need_scores, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * TPAD + BK * TPAD + BK * D);
  auto kernel = flash_prefill_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), true_len, static_cast<float*>(out), m2, l2,
      H, S, w, need_scores, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

// Running max of rows (g, g + 8) over this tile's logits x (raw q.k units,
// -inf where masked), reduced over the quad.  Returns the log2-domain
// offsets mu of the new max (0 while a row has seen no key, so masked
// entries still give 2^-inf = 0) and the factor alpha that rescales the
// sums taken against the old max.
__device__ __forceinline__ void online_max(const float (&x)[8][4],
                                           float (&m)[2], float c,
                                           float (&mu)[2], float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(x[n][0], x[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(x[n][2], x[n][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    mu[i] = mx[i] == -INFINITY ? 0.f : mx[i] * c;
    alpha[i] = ex2(fmaf(m[i], c, -mu[i]));
    m[i] = mx[i];
  }
}

// x = s where keep(row, key) holds, else -inf.
template <typename Keep>
__device__ __forceinline__ void mask_tile(const float (&s)[8][4],
                                          float (&x)[8][4], int r_lo,
                                          int k_lo, Keep keep) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[n][e] = keep(r_lo + (e >> 1) * 8, k_lo + n * 8 + 2 * t4 + (e & 1))
                    ? s[n][e] : -INFINITY;
}

// Attention side of one tile: online softmax over x, then o += P V by
// wgmma, with P rounded to bf16 in registers as the A operand and V read
// from its swizzled tile.  l holds this lane's partial row sums.
template <int D>
__device__ __forceinline__ void attend_tile(const float (&x)[8][4],
                                            float (&m)[2], float (&l)[2],
                                            float (&o)[D / 64][8][4], float c,
                                            uint32_t vtile) {
  float mu[2], alpha[2];
  online_max(x, m, c, mu, alpha);
  l[0] *= alpha[0];
  l[1] *= alpha[1];
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[nb][n][0] *= alpha[0]; o[nb][n][1] *= alpha[0];
      o[nb][n][2] *= alpha[1]; o[nb][n][3] *= alpha[1];
    }
  uint32_t pa[4][4];                // A fragments of P, 4 k-steps of 16 keys
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p0 = ex2(fmaf(x[n][0], c, -mu[0]));
    const float p1 = ex2(fmaf(x[n][1], c, -mu[0]));
    const float p2 = ex2(fmaf(x[n][2], c, -mu[1]));
    const float p3 = ex2(fmaf(x[n][3], c, -mu[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb) fence_acc(o[nb]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_frag(pa[kk]);
  wgmma_fence();
  // V's tile is keys x columns, columns contiguous: keys 16 kk .. 16 kk + 15
  // are two 8-row groups (1024 bytes apart) from byte 2048 kk of the
  // 64-column block nb.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
      wgmma_rs_kn(o[nb], pa[kk],
                  wgmma_desc(vtile + nb * (ROWS * 128) + kk * 2048,
                             ROWS * 128, 1024));
  wgmma_commit_wait();
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb) fence_acc(o[nb]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_frag(pa[kk]);
}

// Scoring side of one tile: only the running max m and partial sums l.
__device__ __forceinline__ void score_tile(const float (&x)[8][4],
                                           float (&m)[2], float (&l)[2],
                                           float c) {
  float mu[2], alpha[2];
  online_max(x, m, c, mu, alpha);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    sum[0] += ex2(fmaf(x[n][0], c, -mu[0])) + ex2(fmaf(x[n][1], c, -mu[0]));
    sum[1] += ex2(fmaf(x[n][2], c, -mu[1])) + ex2(fmaf(x[n][3], c, -mu[1]));
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::NTHREADS)
flash_prefill_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const int* __restrict__ true_len,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ m2_out,
                 float* __restrict__ l2_out, int H, int S, int w,
                 int need_scores, int window, float scale) {
  using namespace tc;
  constexpr int TILE = ROWS * D * 2;             // bytes of one bf16 tile
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* gen;
  const uint32_t sQ = aligned_smem(smem_tc, gen);  // Q | K0 K1 | V0 V1
  const uint32_t bars = sQ + 5 * TILE;           // one mbarrier per stage
  const int bh = blockIdx.y;
  const int tl = true_len[bh / H];
  const int n_real = max(0, min(tl, S));
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * ROWS;  // long tiles first
  const int q_hi = q_lo + ROWS - 1;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int r_lo = q_lo + warp * 16 + (lane >> 2);  // rows r_lo, r_lo + 8

  if (q_lo >= n_real) {                          // wholly past true_len
    const int rows = min(ROWS, S - q_lo);
    uint4* dst = reinterpret_cast<uint4*>(out + base + (size_t)q_lo * D);
    for (int i = threadIdx.x; i < rows * (D / 8); i += NTHREADS)
      dst[i] = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < rows) {
      m2_out[(size_t)bh * S + q_lo + threadIdx.x] = 0.f;
      l2_out[(size_t)bh * S + q_lo + threadIdx.x] = 1.f;
    }
    return;
  }

  // Key tiles [kt0, kt1): every one feeds the scoring side (need_scores)
  // or the attention side.
  const int att_end = min(q_hi + 1, n_real);
  const int kt0 =
      need_scores || window <= 0 ? 0 : max(0, q_lo - window + 1) / ROWS;
  const int kt1 = ((need_scores ? n_real : att_end) + ROWS - 1) / ROWS;
  auto attends = [&](int kt) {
    return kt * ROWS < att_end &&
           (window <= 0 || kt * ROWS + ROWS - 1 > q_lo - window);
  };
  // Thread 0 asks for key tile kt (and Q with the first) into a stage.
  auto load_kv = [&](int kt, int stage, bool with_q) {
    const uint32_t bar = bars + 8 * stage;
    const bool att = attends(kt);
    mbar_expect(bar, (1 + att + with_q) * TILE);
    if (with_q) tma_tile<D>(sQ, &tq, bar, q_lo, bh);
    tma_tile<D>(sQ + TILE * (1 + stage), &tk, bar, kt * ROWS, bh);
    if (att) tma_tile<D>(sQ + TILE * (3 + stage), &tv, bar, kt * ROWS, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) load_kv(kt0, 0, true);

  const float c = scale * LOG2E;                 // raw q.k -> log2 units
  float m_a[2] = {-INFINITY, -INFINITY}, l_a[2] = {0.f, 0.f};
  float m_s[2] = {-INFINITY, -INFINITY}, l_s[2] = {0.f, 0.f};
  float o[D / 64][8][4];                         // [64-column block][n8]
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][n][e] = 0.f;

  auto keep_att = [&](int qi, int kj) {
    return kj <= qi && kj < n_real && (window <= 0 || kj > qi - window);
  };
  auto keep_sc = [&](int qi, int kj) {
    return kj < n_real && !(qi >= tl - w && kj >= tl - w && kj > qi);
  };

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, stage = i & 1;
    if (threadIdx.x == 0 && kt + 1 < kt1) load_kv(kt + 1, stage ^ 1, false);
    mbar_wait(bars + 8 * stage, (i >> 1) & 1);   // this tile has landed

    const int k_lo = kt * ROWS, k_hi = k_lo + ROWS - 1;
    float s[8][4], x[8][4];
    mma_abt<D>(sQ, sQ + TILE * (1 + stage), s);  // raw q.k

    if (attends(kt)) {
      const uint32_t sV = sQ + TILE * (3 + stage);
      if (k_hi <= q_lo && k_hi < n_real &&
          (window <= 0 || k_lo > q_hi - window)) {
        attend_tile<D>(s, m_a, l_a, o, c, sV);
      } else {
        mask_tile(s, x, r_lo, k_lo, keep_att);
        attend_tile<D>(x, m_a, l_a, o, c, sV);
      }
    }
    if (need_scores) {
      if (k_hi < n_real &&
          (q_hi < tl - w || k_hi < tl - w || k_hi <= q_lo)) {
        score_tile(s, m_s, l_s, c);
      } else {
        mask_tile(s, x, r_lo, k_lo, keep_sc);
        score_tile(x, m_s, l_s, c);
      }
    }
    __syncthreads();                             // stage free for reuse
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + i * 8;
    const float la = quad_sum(l_a[i]), ls = quad_sum(l_s[i]);
    if (r >= S) continue;
    const bool real = r < n_real;
    const float safe_l = la > 0.f ? la : 1.f;
    __nv_bfloat16* dst = out + base + (size_t)r * D + 2 * t4;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) =
          real ? pack_bf16(o[d >> 3][d & 7][2 * i] / safe_l,
                           o[d >> 3][d & 7][2 * i + 1] / safe_l)
               : 0u;
    if (t4 == 0) {
      const bool sc = need_scores && real;
      m2_out[(size_t)bh * S + r] =
          !sc ? 0.f : (m_s[i] == -INFINITY ? NEG_INF : m_s[i] * scale);
      l2_out[(size_t)bh * S + r] = sc ? ls : 1.f;
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* true_len, void* out, float* m2, float* l2,
                      int B, int H, int S, int w, int need_scores, int window,
                      float scale, cudaStream_t stream) {
  const size_t smem = 5 * tc::ROWS * D * sizeof(__nv_bfloat16) + 16 + 1024;
  auto kernel = flash_prefill_tc<D>;
  cudaError_t err = tc::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = tc::tensor_map(&tq, q, B * H, S, D)) != cudaSuccess ||
      (err = tc::tensor_map(&tk, k, B * H, S, D)) != cudaSuccess ||
      (err = tc::tensor_map(&tv, v, B * H, S, D)) != cudaSuccess)
    return err;
  const dim3 grid((S + tc::ROWS - 1) / tc::ROWS, B * H);
  kernel<<<grid, tc::NTHREADS, smem, stream>>>(
      tq, tk, tv, true_len, static_cast<__nv_bfloat16*>(out), m2, l2, H, S,
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
    return launch<64>(q, k, v, true_len, out, m2, l2, B, H, S, w,
                      need_scores, window, scale, stream);
  if (dtype == kFloat32 && D == 128)
    return launch<128>(q, k, v, true_len, out, m2, l2, B, H, S, w,
                       need_scores, window, scale, stream);
  if (dtype == kBFloat16 && D == 64)
    return launch_tc<64>(q, k, v, true_len, out, m2, l2, B, H, S, w,
                         need_scores, window, scale, stream);
  if (dtype == kBFloat16 && D == 128)
    return launch_tc<128>(q, k, v, true_len, out, m2, l2, B, H, S, w,
                          need_scores, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}
