// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v in, bf16 out, fp32
// logsumexp out.
//
// Replaces the TPU kernel diffusion_tpu/ops/flash_attention.py::_fwd_kernel
// (the pallas_call in `_fwd`). Same math: non-causal softmax(q k^T / sqrt(d)) v
// with an online softmax whose running max, normalizer and output stay in
// fp32; writes O and the per-row logsumexp the backward will need.
//
// What bounds it on the card: at the UNet's spatial self-attention
// (S = 1024 or 4096, d = 64) the work is 4*S^2*d flops per head against
// O(S*d) bytes, far above the card's flop-per-byte ridge point, so it is
// bound by the tensor cores and by how well their operands are fed.
//
// Design against that bound:
//  * one block per (b*h, 64-row q tile); four warps, 16 q rows each. The TPU
//    grid's sequential KV axis becomes a loop inside the block that streams
//    64-key K/V tiles through shared memory, so the S x S score matrix never
//    leaves registers.
//  * QK^T and PV run on the tensor cores as mma.sync m16n8k16 bf16 -> fp32.
//    The score accumulator's register layout is exactly the A-operand layout
//    of the PV product, so P goes from scores to the second product without a
//    trip through shared memory. V is read with ldmatrix.trans.
//  * q/k/v are read in their (B, S, H, D) layout through strides, so the
//    caller's head fold (the TPU's `_fold` transpose) costs nothing.
//  * Padded shared-memory rows (72 bf16) keep every fragment load free of
//    bank conflicts.
// Not yet done: cp.async/TMA double buffering of K/V and wgmma; the loads of
// each tile are synchronous and latency is hidden only by other resident
// blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;           // head dim
constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;      // padded smem row (bf16 elements)

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
  for (int i = threadIdx.x; i < 64 * kD / 8; i += kThreads) {
    int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c]) = *reinterpret_cast<const uint4*>(
        src + (long long)(row0 + r) * row_stride + c);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                 float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBQ][kLd];
  __shared__ __align__(16) __nv_bfloat16 sK[kBK][kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[kBK][kLd];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair
  const int wr = warp * 16;                 // this warp's first q row

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  load_tile(sQ, qb, qs.s, q0);
  __syncthreads();
  uint32_t qa[4][4];                        // A fragments of Q, 4 k-chunks
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    qa[kc][0] = lds32(&sQ[wr + g][kc * 16 + t4 * 2]);
    qa[kc][1] = lds32(&sQ[wr + g + 8][kc * 16 + t4 * 2]);
    qa[kc][2] = lds32(&sQ[wr + g][kc * 16 + 8 + t4 * 2]);
    qa[kc][3] = lds32(&sQ[wr + g + 8][kc * 16 + 8 + t4 * 2]);
  }

  float acc[8][4];                          // O rows (g, g+8) x 64 dims
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;     // running max, log2 units
  float l0 = 0.f, l1 = 0.f;                 // this thread's share of the sum

  for (int kv0 = 0; kv0 < Skv; kv0 += kBK) {
    __syncthreads();                        // previous tile fully consumed
    load_tile(sK, kb, ks.s, kv0);
    load_tile(sV, vb, vs.s, kv0);
    __syncthreads();

    float s[8][4];                          // scores: rows (g, g+8) x 64 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t b0 = lds32(&sK[nt * 8 + g][kc * 16 + t4 * 2]);
        uint32_t b1 = lds32(&sK[nt * 8 + g][kc * 16 + 8 + t4 * 2]);
        mma_16816(s[nt], qa[kc], b0, b1);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] *= scale_log2;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // a row's 64 scores sit in the 4 lanes of one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // acc += P V; P (fp32 -> bf16, as the TPU kernel casts p to v's dtype)
    // is used in place as the A operand, 16 keys per k-chunk
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 8; dt += 2) {
        // four 8x8 blocks of V: keys kc*16+{0,8}, dims (dt, dt+1)*8
        const int mi = lane >> 3;
        const int row = kc * 16 + (mi & 1) * 8 + (lane & 7);
        const int col = (dt + (mi >> 1)) * 8;
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, &sV[row][col]);
        mma_16816(acc[dt], pa, vb4[0], vb4[1]);
        mma_16816(acc[dt + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // out is a fresh contiguous (B, Sq, H, D) tensor
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* o0 = o + (((long long)b * Sq + r0) * H + h) * kD;
  __nv_bfloat16* o1 = o + (((long long)b * Sq + r1) * H + h) * kD;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
        __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
        __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (t4 == 0) {
    // natural-log lse of the scaled scores: (m + log2 l) * ln 2
    const float ln2 = 0.6931471805599453f;
    lse[(long long)bh * Sq + r0] = (m0 + log2f(l0)) * ln2;
    lse[(long long)bh * Sq + r1] = (m1 + log2f(l1)) * ln2;
  }
}

}  // namespace

// q, k, v: (B, S, H, 64) bf16 views with unit last stride; the wrapper
// (diffusion_torch/ops/flash_attention.py) checks shapes, strides and
// alignment. o: contiguous (B, Sq, H, 64) bf16; lse: contiguous (B, H, Sq)
// fp32. Sq and Skv are multiples of 64. Returns the launch's cudaError_t.
extern "C" int dt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Skv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, void* stream) {
  const float log2e = 1.4426950408889634f;
  dim3 grid(Sq / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Skv, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, scale * log2e);
  return static_cast<int>(cudaGetLastError());
}
