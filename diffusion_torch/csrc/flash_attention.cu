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

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;
constexpr int kBQ = kTile;       // q rows per block
constexpr int kBK = kTile;       // keys per K/V tile

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
  load_a_frags(qa, sQ, wr, g, t4);

  float acc[8][4];                          // O rows (g, g+8) x 64 dims
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY;     // running max, log2 units
  float l0 = 0.f, l1 = 0.f;                 // this thread's share of the sum

  for (int kv0 = 0; kv0 < Skv; kv0 += kBK) {
    __syncthreads();                        // previous tile fully consumed
    load_tile(sK, kb, ks.s, kv0);
    load_tile(sV, vb, vs.s, kv0);
    __syncthreads();

    float s[8][4];                          // scores: rows (g, g+8) x 64 keys
    zero(s);
    mma_abt(s, qa, sK, g, t4);

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
    mma_ab(acc, s, sV, lane);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // out is a fresh contiguous (B, Sq, H, D) tensor
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  store_rows(o, acc, b, Sq, H, h, r0, t4, inv0, inv1);
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
  dim3 grid(Sq / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Skv, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
