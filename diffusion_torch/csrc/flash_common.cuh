// Shared pieces of the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): the head dim and log2(e), and, for the dQ
// kernel, tile geometry, strided (B, S, H, D) views, and the mma.sync
// m16n8k16 bf16 -> fp32 building blocks with their fragment layouts (which
// the wgmma kernels' register layouts share, hopper_common.cuh).
//
// Fragment layouts (lane = 4 * g + t4):
//  * A, 16 x 16 row-major: a0 = (row g, cols 2*t4, 2*t4+1), a1 = (row g+8,
//    same cols), a2 = (row g, cols 8+2*t4, +1), a3 = (row g+8, same cols).
//  * B, 16 x 8: b0 = (k rows 2*t4, 2*t4+1, col g), b1 = (k rows 8+2*t4, +1,
//    col g). A row-major [n][k] tile gives b0/b1 as one 32-bit load each; a
//    row-major [k][n] tile gives them through ldmatrix.trans.
//  * C, 16 x 8: c0, c1 = (row g, cols 2*t4, 2*t4+1), c2, c3 = (row g+8,
//    same cols). Two neighbouring C tiles of a 16 x 64 score block are one
//    A fragment of the next product (pack_a), so scores never leave
//    registers between the two products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kD = 64;           // head dim
constexpr int kTile = 64;        // rows of a q, k or v tile
constexpr int kWarps = 4;        // 16 rows of the block's own tile each
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;      // padded smem row (bf16): conflict-free
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                 // element strides of a (B, S, H, D) view
  long long b, s, h;
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// copy a 64 x 64 bf16 tile (rows `row0..row0+63` of a strided view) to smem
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLd],
                                         const __nv_bfloat16* src,
                                         long long row_stride, int row0) {
  for (int i = threadIdx.x; i < kTile * kD / 8; i += kThreads) {
    int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c]) = *reinterpret_cast<const uint4*>(
        src + (long long)(row0 + r) * row_stride + c);
  }
}

// A fragments of the warp's 16 rows (from `r0`) of a 64 x 64 smem tile,
// one per 16-column k-chunk
__device__ __forceinline__ void load_a_frags(uint32_t a[4][4],
                                             const __nv_bfloat16 (*t)[kLd],
                                             int r0, int g, int t4) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = lds32(&t[r0 + g][kc * 16 + t4 * 2]);
    a[kc][1] = lds32(&t[r0 + g + 8][kc * 16 + t4 * 2]);
    a[kc][2] = lds32(&t[r0 + g][kc * 16 + 8 + t4 * 2]);
    a[kc][3] = lds32(&t[r0 + g + 8][kc * 16 + 8 + t4 * 2]);
  }
}

// c[nt] += A (16 x 64, fragments `a`) times the transpose of the 64 x 64
// row-major smem tile `t`: C columns are t's rows
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[4][4],
                                        const __nv_bfloat16 (*t)[kLd], int g,
                                        int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t b0 = lds32(&t[nt * 8 + g][kc * 16 + t4 * 2]);
      uint32_t b1 = lds32(&t[nt * 8 + g][kc * 16 + 8 + t4 * 2]);
      mma_16816(c[nt], a[kc], b0, b1);
    }
  }
}

// the A fragment of k-chunk kc (columns kc*16..kc*16+15) of a 16 x 64 block
// held as eight C tiles, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t a[4], const float s[8][4],
                                       int kc) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// acc (16 x 64) += A (16 x 64 from the C tiles `s`, bf16) times the 64 x 64
// row-major smem tile `t` ([k][n]), read with ldmatrix.trans
__device__ __forceinline__ void mma_ab(float acc[8][4], const float s[8][4],
                                       const __nv_bfloat16 (*t)[kLd],
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t pa[4];
    pack_a(pa, s, kc);
#pragma unroll
    for (int dt = 0; dt < 8; dt += 2) {
      // four 8x8 blocks of t: k rows kc*16+{0,8}, n cols (dt, dt+1)*8
      const int mi = lane >> 3;
      const int row = kc * 16 + (mi & 1) * 8 + (lane & 7);
      const int col = (dt + (mi >> 1)) * 8;
      uint32_t b4[4];
      ldmatrix_x4_trans(b4, &t[row][col]);
      mma_16816(acc[dt], pa, b4[0], b4[1]);
      mma_16816(acc[dt + 1], pa, b4[2], b4[3]);
    }
  }
}

__device__ __forceinline__ void zero(float c[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// store a warp's 16 x 64 fp32 block (an mma.sync C block or a wgmma
// accumulator: the same registers), times (mul0, mul1), as bf16 rows r0 and
// r0+8 of a contiguous (B, S, H, 64) tensor; rows at or past S are not
// written
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
