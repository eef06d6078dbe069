// Tensor-core building blocks of the bf16 route of the prefill kernels
// (flash_prefill.cu, colsum_scores.cu): TMA tile loads under mbarriers into
// the 128-byte-swizzled shared-memory layout that wgmma reads, and
// warpgroup products (wgmma.mma_async m64n64k16, bf16 x bf16 -> float32).
//
// A block is one warpgroup (4 warps, 128 threads) that owns a 64-row tile
// of one operand and multiplies it against 64-row tiles of the other, 64 x
// 64 outputs per step.  wgmma reads B from shared memory once for the whole
// warpgroup (mma.sync would read it once per warp).
//
// Accumulator layout of a 64 x 64 float32 product (PTX ISA, wgmma
// m64nNk16; the same per warp as mma.m16n8k16): warp w, lane = 4 * g + t
// holds, in d[n][0..3], rows 16 w + g (elements 0, 1) and 16 w + g + 8
// (elements 2, 3) at columns 8 n + 2 t and 8 n + 2 t + 1.  wgmma's A
// operand in registers has the same layout per 16 columns, so a tile of
// probabilities converts to the A operand of the next product in place.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

#include "tile.cuh"

namespace scope {
namespace tc {

constexpr int ROWS = 64;           // rows of a tile, either operand
constexpr int NTHREADS = 128;      // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled [64][D] tile.  The
// tile is stored as D/64 blocks of 64 columns, [64][64] each (128-byte
// rows), the chunks of row r at (c ^ (r & 7)): the hardware's 128-byte
// swizzle, which wgmma reads, on 1024-byte aligned tiles.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The dynamic shared memory of a block, rounded up to 1024 bytes (the
// launch asks for 1024 bytes more): returns its shared-space address and
// sets gen to the same place as a generic pointer.
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* smem,
                                                 unsigned char*& gen) {
  const uint32_t raw = smem_addr(smem);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  gen = smem + pad;
  return raw + pad;
}

// ---- TMA tile loads under mbarriers ---------------------------------------
//
// A tensor map describes one [B*H][S][D] bf16 input as a 3-D tensor with
// 64 x 64 boxes and the 128-byte swizzle; rows at or past S read as zero.
// One thread asks for a tile; the copy engine writes it and counts its
// bytes on the stage's mbarrier, which the warpgroup waits on.

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// Make initialised mbarriers visible to the copy engine; a __syncthreads()
// must follow before other threads use them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on bar and announce `bytes` of copies that will complete on it.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of bar's phase with the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Rows [row0, row0 + 64) of head bh of a tensor map into the swizzled tile
// at dst, one box per 64 columns; completes ROWS * D * 2 bytes on bar.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int bh) {
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst + nb * ROWS * 128),
        "l"(map), "r"(nb * 64), "r"(row0), "r"(bh), "r"(bar)
        : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (PTX ISA, wgmma descriptors).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Commit the issued wgmmas and wait for all of them.
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of an accumulator, or from
// reusing the registers of an A operand, across the asynchronous wgmma
// that writes or reads them: called before wgmma_fence and after
// wgmma_commit_wait.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

#define SCOPE_WGMMA_D                                                       \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define SCOPE_WGMMA_D_LIST                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d = A (64 x 16, adesc) x B (16 x 64, bdesc) [+ d]: both operands from
// shared memory, both stored with the 16-deep K dimension contiguous.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t adesc,
                                         uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SCOPE_WGMMA_D_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SCOPE_WGMMA_D
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// d += A (64 x 16, registers: each warp's 16 rows in the accumulator
// layout) x B (16 x 64, bdesc, stored K x N with N contiguous).
__device__ __forceinline__ void wgmma_rs_kn(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SCOPE_WGMMA_D_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SCOPE_WGMMA_D
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

#undef SCOPE_WGMMA_D
#undef SCOPE_WGMMA_D_LIST

// acc = A B^T for the 64 rows of tile a and the 64 rows of tile b (both
// swizzled [64][D] tiles): acc[n] covers b's rows [8 n, 8 n + 8).
template <int D>
__device__ __forceinline__ void mma_abt(uint32_t a, uint32_t b,
                                        float (&acc)[8][4]) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns = 32 bytes along the 128-byte rows of a 64-column block.
    const uint32_t off = (kk >> 2) * (ROWS * 128) + (kk & 3) * 32;
    wgmma_ss(acc, wgmma_desc(a + off, 16, 1024), wgmma_desc(b + off, 16, 1024),
             kk > 0);
  }
  wgmma_commit_wait();
  fence_acc(acc);
}

// ---- per-row reductions and element helpers -------------------------------

// Max and sum over the four lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (one MUFU.EX2); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Host side: opt in to the dynamic shared memory a kernel needs.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Host side: the tensor map of a contiguous [BH][S][D] bf16 tensor, 64 x 64
// boxes, 128-byte swizzle (libcuda's cuTensorMapEncodeTiled, looked up
// through the runtime so that the library links against nothing more).
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int BH,
                              int S, int D) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace scope
