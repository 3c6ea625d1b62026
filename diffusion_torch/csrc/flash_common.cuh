// Shared pieces of the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): the head dim and log2(e), the bf16 packing of
// register A operands, and the store of a 16-row accumulator block.
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

namespace flash {

constexpr int kD = 64;           // head dim
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// store a warp's 16 x 64 fp32 block (a wgmma accumulator: the C layout
// above, chunk dt in c[dt]), times (mul0, mul1), as bf16 rows r0 and r0+8 of
// a contiguous (B, S, H, 64) tensor; rows at or past S are not written
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float c[8][4], int b, int S,
                                           int H, int h, int r0, int t4,
                                           float mul0, float mul1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= S) continue;
    const float mul = half ? mul1 : mul0;
    __nv_bfloat16* row = out + (((long long)b * S + r) * H + h) * kD;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + t4 * 2) =
          __floats2bfloat162_rn(c[dt][2 * half] * mul,
                                c[dt][2 * half + 1] * mul);
  }
}

}  // namespace flash
