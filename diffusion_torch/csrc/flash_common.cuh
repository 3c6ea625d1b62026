// Shared pieces of the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): log2(e), the bf16 packing of register A
// operands, the store of a 16-row accumulator block, and the tiles of
// either head dim.
//
// Head dims: every kernel is a template over kD, instantiated at 64 and
// 128. A tile of `rows` x kD bf16 lies in shared memory as kD / 64 halves
// of rows x 64 (128 bytes a row, the widest box TMA writes with the
// 128-byte swizzle), half j holding dims 64 j .. 64 j + 63 of every row at
// `tile + j * rows * 64`. Each half is the 64-dim tile of hopper_common.cuh
// with its own descriptor: a K-major product steps k16 chunk kc through
// half kc / 4 at +32 bytes * (kc % 4); a product whose N is the head dim
// runs once per half, into an accumulator of its own (64 fp32 columns).
// At kD = 64 there is one half and every loop below is what it was.
//
// Register layouts (lane = 4 * g + t4; those of mma.sync m16n8k16, which
// the wgmma accumulators and register A operands share, hopper_common.cuh):
//  * A, 16 x 16 row-major: a0 = (row g, cols 2*t4, 2*t4+1), a1 = (row g+8,
//    same cols), a2 = (row g, cols 8+2*t4, +1), a3 = (row g+8, same cols).
//  * C, 16 x 8: c0, c1 = (row g, cols 2*t4, 2*t4+1), c2, c3 = (row g+8,
//    same cols). Two neighbouring C tiles of a score block, packed to bf16
//    (pack_bf16), are one A fragment of the next product, so scores never
//    leave registers between the two products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the first element of half j of a tile of `rows` rows
template <int kRows>
__device__ __forceinline__ const __nv_bfloat16* half_of(
    const __nv_bfloat16* tile, int j) {
  return tile + j * kRows * 64;
}

// one TMA load of tile rows `row` .. of head h of batch b into `dst` (a
// tile of kRows rows): a box of 64 dims a half
template <int kD, int kRows>
__device__ __forceinline__ void tma_load_tile(__nv_bfloat16* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row, int h,
                                              int b) {
#pragma unroll
  for (int j = 0; j < kD / 64; ++j)
    hopper::tma_load(dst + j * kRows * 64, map, bar, j * 64, row, h, b);
}

// store a warp's 16 x kD fp32 block (wgmma accumulators: the C layout
// above, 8-dim chunk dt in c[dt], the halves' accumulators one after the
// other), times (mul0, mul1), as bf16 rows r0 and r0+8 of a contiguous
// (B, S, H, kD) tensor; rows at or past S are not written
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float c[kD / 8][4], int b,
                                           int S, int H, int h, int r0,
                                           int t4, float mul0, float mul1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= S) continue;
    const float mul = half ? mul1 : mul0;
    __nv_bfloat16* row = out + (((long long)b * S + r) * H + h) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + t4 * 2) =
          __floats2bfloat162_rn(c[dt][2 * half] * mul,
                                c[dt][2 * half + 1] * mul);
  }
}

}  // namespace flash
