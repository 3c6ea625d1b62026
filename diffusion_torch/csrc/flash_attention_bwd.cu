// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of non-causal
// softmax(q k^T * scale) v from the saved output and logsumexp, bf16 in and
// out with fp32 accumulators.
//
// Replaces the TPU kernels diffusion_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (the two pallas_calls in `_bwd`).
// Same math: p = exp(s - lse) is recomputed from the saved lse (no S x S
// residual), dp = dO V^T, ds = p (dp - delta) with delta = rowsum(dO * O),
// dQ = ds K * scale, dK = ds^T Q * scale, dV = p^T dO; p and ds are rounded
// to bf16 before their products, as the TPU kernels cast them to the
// operands' dtype.
//
// What bounds it on the card: at the UNet's spatial self-attention (S = 1024
// or 4096, d = 64) the backward does 2.5x the forward's tensor-core work
// (five S x S x 64 products per head against O(S * d) bytes, and P is
// recomputed in both kernels, so seven are issued), far above the
// flop-per-byte ridge: it is bound by the tensor cores and how well they
// are fed.
//
// Design against that bound:
//  * Two kernels, as on the TPU, because CUDA blocks run in no order and a
//    sum across blocks would need atomics: dQ owns one (b*h, 64-row q tile)
//    per block and loops over K/V tiles; dK/dV owns one (b*h, 128-key tile)
//    per block and loops over Q/dO tiles. No atomics, so the result is
//    deterministic.
//  * delta is fused into the dQ kernel: each dQ block computes it for its
//    64 rows from the dO and O tiles it loads anyway and writes it out for
//    the dK/dV kernel, which runs after it on the same stream.
//  * dQ: mma.sync m16n8k16 bf16 -> fp32 with the fragment layouts of
//    flash_common.cuh: the score and dp accumulators are reused in place
//    as the A operand of the next product, so P and dS never touch shared
//    or device memory; K comes through ldmatrix.trans. Tiles are loaded
//    synchronously.
//  * dK/dV (hopper_common.cuh has the building blocks): three warpgroups,
//    two consumers of 64 keys each and one producer. TMA loads the block's
//    K and V once; the producer's single thread streams 64-query tiles of
//    Q and dO, with their 64 lse and delta values (bulk copies), through a
//    ring of kStages shared-memory stages guarded by full and empty
//    mbarriers, and gives up its registers (setmaxnreg) to the consumers.
//    Per tile each consumer runs S^T = K Q^T and dP^T = V dO^T as wgmma
//    m64n64k16 with all operands in shared memory (K and V are A, K-major;
//    Q and dO are B, K-major), makes P^T and dS^T in registers, and runs
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A operands
//    and dO and Q read MN-major from the same swizzled tiles. dK and dV are
//    64 x 64 fp32 per warpgroup, 32 registers each per thread. The
//    exponentials are bare MUFU.EX2 (exp2_ftz), the dQ kernel's exp2f: the
//    two give P the same bits except where p < 2^-126, which exp2_ftz
//    flushes to zero (the dQ kernel keeps the denormal).
//  * q/k/v/dO/O are read through their (B, S, H, D) strides (tensor maps
//    for the dK/dV kernel), so the head fold costs nothing; dQ/dK/dV are
//    written contiguous (B, S, H, 64). Key rows past Skv read as zeros and
//    are not stored.
// Not yet done: cp.async/TMA double buffering and wgmma in the dQ kernel.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    Strides dos, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sDO[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kLd];  // O, then K tiles
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kLd];
  __shared__ float sDelta[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;

  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  load_tile(sQ, q + b * qs.b + h * qs.h, qs.s, q0);
  load_tile(sDO, dout + b * dos.b + h * dos.h, dos.s, q0);
  load_tile(sK, o + b * os.b + h * os.h, os.s, q0);
  __syncthreads();
  {
    // delta = rowsum(dO * O) in fp32: two threads per row, 32 dims each
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&sDO[r][c0 + c]));
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&sK[r][c0 + c]));
      acc += a.x * w.x + a.y * w.y;
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      sDelta[r] = acc;
      delta[(long long)bh * Sq + q0 + r] = acc;
    }
  }
  uint32_t qa[4][4], da[4][4];              // A fragments of Q and dO
  load_a_frags(qa, sQ, wr, g, t4);
  load_a_frags(da, sDO, wr, g, t4);
  __syncthreads();                          // sDelta written, sK free
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  const float lse0 = lse[(long long)bh * Sq + r0] * kLog2e;
  const float lse1 = lse[(long long)bh * Sq + r1] * kLog2e;
  const float dl0 = sDelta[wr + g], dl1 = sDelta[wr + g + 8];

  float acc[8][4];                          // dQ rows (g, g+8) x 64 dims
  zero(acc);
  for (int kv0 = 0; kv0 < Skv; kv0 += kTile) {
    __syncthreads();                        // previous tile fully consumed
    load_tile(sK, kb, ks.s, kv0);
    load_tile(sV, vb, vs.s, kv0);
    __syncthreads();

    float s[8][4], dp[8][4];                // rows (g, g+8) x 64 keys
    zero(s);
    zero(dp);
    mma_abt(s, qa, sK, g, t4);              // Q K^T
    mma_abt(dp, da, sV, g, t4);             // dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {        // ds = p (dp - delta), in s
      s[nt][0] = exp2f(s[nt][0] * scale_log2 - lse0) * (dp[nt][0] - dl0);
      s[nt][1] = exp2f(s[nt][1] * scale_log2 - lse0) * (dp[nt][1] - dl0);
      s[nt][2] = exp2f(s[nt][2] * scale_log2 - lse1) * (dp[nt][2] - dl1);
      s[nt][3] = exp2f(s[nt][3] * scale_log2 - lse1) * (dp[nt][3] - dl1);
    }
    mma_ab(acc, s, sK, lane);               // dQ += ds K
  }
  store_rows(dq, acc, b, Sq, H, h, r0, t4, scale, scale);
}

constexpr int kBKeys = 128;         // keys per dK/dV block: two warpgroups
constexpr int kBQ = 64;             // queries per streamed Q/dO tile
constexpr int kStages = 3;          // Q/dO ring depth
constexpr int kConsumerThreads = 256;
constexpr int kDkvThreads = kConsumerThreads + 128;
constexpr int kQTileBytes = kBQ * kD * 2;

struct alignas(1024) DkvSmem {
  __nv_bfloat16 k[kBKeys * kD];
  __nv_bfloat16 v[kBKeys * kD];
  __nv_bfloat16 q[kStages][kBQ * kD];
  __nv_bfloat16 dout[kStages][kBQ * kD];
  float lse[kStages][kBQ];
  float delta[kStages][kBQ];
  uint64_t kv_full, full[kStages], empty[kStages];
};
constexpr int kDkvSmemBytes = sizeof(DkvSmem) + 1024;  // + alignment slack

__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv,
                     float scale, float scale_log2) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBKeys;
  const int n_tiles = Sq / kBQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    regs_release<24>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(&sm.kv_full, 2 * kBKeys * kD * 2);
      tma_load(sm.k, &tk, &sm.kv_full, 0, k0, h, b);
      tma_load(sm.v, &tv, &sm.kv_full, 0, k0, h, b);
      const float* lseb = lse + (long long)bh * Sq;
      const float* deltab = delta + (long long)bh * Sq;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // the first pass over the ring finds every stage empty
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kQTileBytes + 2 * kBQ * 4);
        tma_load(sm.q[s], &tq, &sm.full[s], 0, i * kBQ, h, b);
        tma_load(sm.dout[s], &tdo, &sm.full[s], 0, i * kBQ, h, b);
        bulk_load(sm.lse[s], lseb + i * kBQ, kBQ * 4, &sm.full[s]);
        bulk_load(sm.delta[s], deltab + i * kBQ, kBQ * 4, &sm.full[s]);
      }
    }
  } else {
    // consumers: warpgroup wg owns keys k0 + 64*wg .. +63
    regs_claim<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const uint64_t k_desc = desc_sw128(sm.k + wg * 64 * kD);
    const uint64_t v_desc = desc_sw128(sm.v + wg * 64 * kD);

    float dk_acc[32], dv_acc[32];           // key rows (g, g+8) x 64 dims
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(&sm.kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      const uint64_t q_desc = desc_sw128(sm.q[s]);
      const uint64_t do_desc = desc_sw128(sm.dout[s]);

      float st[32], dpt[32];                // key rows (g, g+8) x 64 queries
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)  // K Q^T = S^T
        wgmma_m64n64k16_ss(st, k_desc + kc * kDescK16,
                           q_desc + kc * kDescK16, kc > 0);
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)  // V dO^T = dP^T
        wgmma_m64n64k16_ss(dpt, v_desc + kc * kDescK16,
                           do_desc + kc * kDescK16, kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, packed into the A fragments of the next two
      // products: an accumulator chunk's columns are queries
      // nt*8 + 2*t4 + {0, 1}
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
        const int c = nt * 8 + t4 * 2;
        const float l0 = sm.lse[s][c] * kLog2e, l1 = sm.lse[s][c + 1] * kLog2e;
        const float d0 = sm.delta[s][c], d1 = sm.delta[s][c + 1];
        const float p0 = exp2_ftz(st[4 * nt] * scale_log2 - l0);
        const float p1 = exp2_ftz(st[4 * nt + 1] * scale_log2 - l1);
        const float p2 = exp2_ftz(st[4 * nt + 2] * scale_log2 - l0);
        const float p3 = exp2_ftz(st[4 * nt + 3] * scale_log2 - l1);
        const int kc = nt / 2, hi = (nt % 2) * 2;
        pa[kc][hi] = pack_bf16(p0, p1);
        pa[kc][hi + 1] = pack_bf16(p2, p3);
        da[kc][hi] = pack_bf16(p0 * (dpt[4 * nt] - d0),
                               p1 * (dpt[4 * nt + 1] - d1));
        da[kc][hi + 1] = pack_bf16(p2 * (dpt[4 * nt + 2] - d0),
                                   p3 * (dpt[4 * nt + 3] - d1));
      }
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) // dV += P^T dO
        wgmma_m64n64k16_rs_tn(dv_acc, pa[kc], do_desc + kc * kDescRows16);
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) // dK += dS^T Q
        wgmma_m64n64k16_rs_tn(dk_acc, da[kc], q_desc + kc * kDescRows16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&sm.empty[s]);            // this thread is done with s
    }
    const int r0 = k0 + wg * 64 + warp * 16 + g;
    store_rows(dk, reinterpret_cast<const float(*)[4]>(dk_acc), b, Skv, H, h,
               r0, t4, scale, scale);
    store_rows(dv, reinterpret_cast<const float(*)[4]>(dv_acc), b, Skv, H, h,
               r0, t4, 1.f, 1.f);
  }
}

}  // namespace

// q, k, v, o, dout: (B, S, H, 64) bf16 views with unit last stride; the
// wrapper (diffusion_torch/ops/flash_attention.py) checks shapes, strides and
// alignment. lse: contiguous (B, H, Sq) fp32 from the forward. delta:
// (B, H, Sq) fp32, written here for the dK/dV launch. dq: contiguous
// (B, Sq, H, 64) bf16. Sq and Skv are multiples of 64. Returns the launch's
// cudaError_t.
extern "C" int dt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int B, int H,
    int Sq, int Skv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, void* stream) {
  dim3 grid(Sq / kTile, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq), H, Sq, Skv,
      Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
      Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
      Strides{do_sb, do_ss, do_sh}, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// As above; delta is the dQ launch's output. dk, dv: contiguous
// (B, Skv, H, 64) bf16. Returns the launch's cudaError_t
// (cudaErrorInvalidValue where the CUDA driver refuses a tensor map).
extern "C" int dt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Skv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::make_map(&tq, q, B, Sq, H, q_sb, q_ss, q_sh, kBQ) ||
      !hopper::make_map(&tk, k, B, Skv, H, k_sb, k_ss, k_sh, kBKeys) ||
      !hopper::make_map(&tv, v, B, Skv, H, v_sb, v_ss, v_sh, kBKeys) ||
      !hopper::make_map(&tdo, dout, B, Sq, H, do_sb, do_ss, do_sh, kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  dim3 grid((Skv + kBKeys - 1) / kBKeys, B * H);
  flash_bwd_dkv_kernel<<<grid, kDkvThreads, kDkvSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
