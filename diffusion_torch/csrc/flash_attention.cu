// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v in, bf16 out, fp32
// logsumexp out.
//
// Replaces the TPU kernel diffusion_tpu/ops/flash_attention.py::_fwd_kernel
// (the pallas_call in `_fwd`). Same math: non-causal softmax(q k^T / sqrt(d)) v
// with an online softmax whose running max, normalizer and output stay in
// fp32; P is rounded to bf16 before the product with V; writes O and the
// per-row logsumexp the backward will need.
//
// What bounds it on the card: at the UNet's spatial self-attention
// (S = 1024 or 4096, d = 64) the work is 4*S^2*d flops per head against
// O(S*d) bytes, far above the card's flop-per-byte ridge point, so it is
// bound by the tensor cores, and at d = 64 as much by the S^2 exponentials
// of the softmax (one per score, 16 a clock per SM, the rate at which the
// tensor cores finish the two products of 16 scores).
//
// Design against that bound (hopper_common.cuh has the building blocks):
//  * one block per (b*h, 128-row q tile), three warpgroups: two consumers
//    of 64 q rows each and one producer. The producer's single thread loads
//    Q once and streams 128-key K and V tiles through a ring of kStages
//    shared-memory stages with TMA, each stage guarded by "full" (K, V)
//    and "empty" mbarriers, so the next tiles arrive while the consumers
//    compute; the producer gives up its registers (setmaxnreg) to them.
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//    O += P V is wgmma m64n64k16 with P in registers (the accumulator
//    layout of S is the A-operand layout, so P never touches shared
//    memory) and V read MN-major through its descriptor.
//  * The softmax overlaps the products: each consumer issues tile i's
//    Q K^T and tile i-1's P V together, waits only for the scores, and
//    runs tile i's softmax while P V is still on the tensor cores (two P
//    register sets); the other consumer warpgroup fills the gaps that
//    remain. The exponentials are bare MUFU.EX2 (exp2_ftz), the scale is
//    folded into one FMA per score, and a ragged last tile is masked
//    behind a uniform branch, so each score costs one FMA, one EX2, one
//    max, one add and half a bf16 pack besides the products.
//  * q/k/v are read in their (B, S, H, D) layout through 4-D tensor maps
//    over their strides, so the caller's head fold (the TPU's `_fold`
//    transpose) costs nothing. Rows past the end read as zeros: keys at or
//    past Skv are masked to -inf before the row max, and q rows at or past
//    Sq are not stored.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using flash::kD;
using flash::kLog2e;
using flash::pack_bf16;
using hopper::exp2_ftz;

constexpr int kBM = 128;            // q rows per block: two warpgroups
constexpr int kBN = 128;            // keys per K/V tile
constexpr int kStages = 3;          // K/V ring depth
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kTileBytes = kBN * kD * 2;

struct alignas(1024) Smem {
  __nv_bfloat16 q[kBM * kD];
  __nv_bfloat16 k[kStages][kBN * kD];
  __nv_bfloat16 v[kStages][kBN * kD];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;   // + alignment slack

// Online softmax of one tile's raw scores `sc` (rows g, g+8 x kBN keys):
// updates the running max m (log2 units of the scaled scores) and this
// thread's share l of the normalizer, returns the rescale factors of what
// came before, and packs P (fp32 -> bf16, as the TPU kernel casts p to v's
// dtype) into the A fragments of P V, 16 keys per k-chunk. Skv is a
// multiple of 64, so a tile holds either 128 keys or (`half`) 64 and the
// zero rows TMA filled in, which score -inf.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], bool half,
                                             float scale_log2, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1,
                                             uint32_t (&pa)[kBN / 16][4]) {
  static_assert(kBN == 128, "a ragged tile is half a tile");
  if (half) {
#pragma unroll
    for (int i = 32; i < 64; ++i) sc[i] = -INFINITY;   // keys 64..127
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
  }
  // a row's scores sit in the 4 lanes of one quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // the scale is positive, so the max of the scaled scores is the scaled max
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  alpha0 = exp2_ftz(m0 - mn0);
  alpha1 = exp2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int kc = 0; kc < kBN / 16; ++kc) {
    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)     // exp2(s * scale - m), one FMA each
      p[j] = exp2_ftz(fmaf(sc[8 * kc + j], scale_log2,
                           (j & 2) ? -mn1 : -mn0));
    l0 += p[0] + p[1] + p[4] + p[5];
    l1 += p[2] + p[3] + p[6] + p[7];
    pa[kc][0] = pack_bf16(p[0], p[1]);
    pa[kc][1] = pack_bf16(p[2], p[3]);
    pa[kc][2] = pack_bf16(p[4], p[5]);
    pa[kc][3] = pack_bf16(p[6], p[7]);
  }
}

__device__ __forceinline__ void scale_rows(float (&acc)[32], float alpha0,
                                           float alpha1) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    acc[4 * dt] *= alpha0;
    acc[4 * dt + 1] *= alpha0;
    acc[4 * dt + 2] *= alpha1;
    acc[4 * dt + 3] *= alpha1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Skv, float scale_log2) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (Skv + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    regs_release<24>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(&sm.q_full, kBM * kD * 2);
      tma_load(sm.q, &tq, &sm.q_full, 0, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // the first pass over the ring finds every stage empty
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        tma_load(sm.k[s], &tk, &sm.k_full[s], 0, i * kBN, h, b);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        tma_load(sm.v[s], &tv, &sm.v_full[s], 0, i * kBN, h, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64*wg .. +63
    regs_claim<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const uint64_t q_desc = desc_sw128(sm.q + wg * 64 * kD);

    float acc[32];                          // O rows (g, g+8) x 64 dims
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;   // running max, log2 units
    float l0 = 0.f, l1 = 0.f;               // this thread's share of the sum
    float alpha0, alpha1;
    uint32_t pa[kBN / 16][4];               // P of the tile whose P V is next

    // S = Q K^T of tile i into sc (issued, committed; not waited for)
    auto issue_scores = [&](float (&sc)[64], int i) {
      const int s = i % kStages;
      mbar_wait(&sm.k_full[s], (i / kStages) & 1);
      const uint64_t k_desc = desc_sw128(sm.k[s]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)
        wgmma_m64n128k16_ss(sc, q_desc + kc * kDescK16,
                            k_desc + kc * kDescK16, kc > 0);
      wgmma_commit();
    };
    // O += P V of tile i (issued, committed; not waited for)
    auto issue_pv = [&](int i) {
      const int s = i % kStages;
      mbar_wait(&sm.v_full[s], (i / kStages) & 1);
      const uint64_t v_desc = desc_sw128(sm.v[s]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc)
        wgmma_m64n64k16_rs_tn(acc, pa[kc], v_desc + kc * kDescRows16);
      wgmma_commit();
    };

    mbar_wait(&sm.q_full, 0);
    {
      float sc[64];                         // scores: rows (g, g+8) x 128
      issue_scores(sc, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, Skv < kBN, scale_log2, m0, m1, l0, l1, alpha0, alpha1,
                   pa);
    }
    // Tile i's scores are computed while tile i-1's P V runs, and tile i's
    // softmax overlaps that product too: the tensor cores stay busy while
    // this warpgroup works on the exponentials.
    for (int i = 1; i < n_tiles; ++i) {
      float sc[64];
      issue_scores(sc, i);
      issue_pv(i - 1);
      wgmma_wait<1>();                      // the scores, not yet P V
      fence_regs(sc);
      uint32_t pn[kBN / 16][4];
      softmax_tile(sc, Skv - i * kBN < kBN, scale_log2, m0, m1, l0, l1,
                   alpha0, alpha1, pn);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&sm.empty[(i - 1) % kStages]);  // done with tile i-1
      scale_rows(acc, alpha0, alpha1);
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kc][j] = pn[kc][j];
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.empty[(n_tiles - 1) % kStages]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    // out is a fresh contiguous (B, Sq, H, D) tensor
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    flash::store_rows(o, reinterpret_cast<const float(*)[4]>(acc), b, Sq, H,
                      h, r0, t4, 1.f / l0, 1.f / l1);
    if (t4 == 0) {
      // natural-log lse of the scaled scores: (m + log2 l) * ln 2
      const float ln2 = 0.6931471805599453f;
      if (r0 < Sq) lse[(long long)bh * Sq + r0] = (m0 + log2f(l0)) * ln2;
      if (r1 < Sq) lse[(long long)bh * Sq + r1] = (m1 + log2f(l1)) * ln2;
    }
  }
}

}  // namespace

// q, k, v: (B, S, H, 64) bf16 views with unit last stride; the wrapper
// (diffusion_torch/ops/flash_attention.py) checks shapes, strides and
// alignment. o: contiguous (B, Sq, H, 64) bf16; lse: contiguous (B, H, Sq)
// fp32. Sq and Skv are multiples of 64. Returns the launch's cudaError_t
// (cudaErrorInvalidValue where the CUDA driver refuses a tensor map).
extern "C" int dt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Skv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!hopper::make_map(&tq, q, B, Sq, H, q_sb, q_ss, q_sh, kBM) ||
      !hopper::make_map(&tk, k, B, Skv, H, k_sb, k_ss, k_sh, kBN) ||
      !hopper::make_map(&tv, v, B, Skv, H, v_sb, v_ss, v_sh, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  dim3 grid((Sq + kBM - 1) / kBM, B * H);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H,
      Sq, Skv, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
