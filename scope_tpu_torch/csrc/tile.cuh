// Shared tile helpers of the float32 route of the prefill kernels
// (flash_prefill.cu, colsum_scores.cu; the bf16 route is in mma.cuh).  Both
// kernels work on 64 x 64 (query x key) tiles with 256 threads laid out
// 16 x 16; a thread owns a 4 x 4 block of the tile: rows ty*4 .. ty*4+3 and
// columns tx*4 .. tx*4+3.  Operands sit in shared memory as float32, Q and
// K transposed ([D][TPAD]) so that each thread reads its four rows or
// columns as one 16-byte load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace scope {

constexpr float NEG_INF = -1e30f;   // the JAX package's NEG_INF
constexpr int BQ = 64;              // query rows per tile
constexpr int BK = 64;              // keys per tile
constexpr int THREADS = 256;        // 16 x 16, 4 x 4 outputs each
constexpr int TPAD = 68;            // row stride of a transposed tile

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Rows [row0, row0 + 64) of a row-major [S, D] matrix into Xt[D][TPAD]
// (transposed, float32); rows at or past S read as zero.
template <int D>
__device__ __forceinline__ void load_tile_t(float* Xt, const float* X,
                                            int row0, int S) {
  constexpr int CH = D / 4;
  for (int idx = threadIdx.x; idx < BQ * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(X + (size_t)(row0 + r) * D + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Xt[(c + e) * TPAD + r] = x[e];
  }
}

// Rows [row0, row0 + 64) of a row-major [S, D] matrix into Xs[64][D].
template <int D>
__device__ __forceinline__ void load_tile(float* Xs, const float* X, int row0,
                                          int S) {
  constexpr int CH = D / 4;
  for (int idx = threadIdx.x; idx < BK * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(X + (size_t)(row0 + r) * D + c, x);
    *reinterpret_cast<float4*>(Xs + r * D + c) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// s[i][j] = scale * sum_d Q[ty*4+i][d] * K[tx*4+j][d], float32 FMAs.
template <int D>
__device__ __forceinline__ void qk_tile(const float* Qt, const float* Kt,
                                        int ty, int tx, float scale,
                                        float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(Qt + d * TPAD + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Kt + d * TPAD + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= scale;
}

// Reductions over the 16 threads that share a row (one half-warp).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace scope

extern "C" const char* scope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
