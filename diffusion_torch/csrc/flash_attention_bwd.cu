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
//    per block and loops over K/V tiles; dK/dV owns one (b*h, 64-key tile)
//    per block and loops over Q/dO tiles. No atomics, so the result is
//    deterministic.
//  * delta is fused into the dQ kernel: each dQ block computes it for its
//    64 rows from the dO and O tiles it loads anyway and writes it out for
//    the dK/dV kernel, which runs after it on the same stream.
//  * Every product is mma.sync m16n8k16 bf16 -> fp32 with the forward's
//    fragment layouts (flash_common.cuh): the score and dp accumulators are
//    reused in place as the A operand of the next product, so P and dS never
//    touch shared or device memory. Operands whose k axis is the tile's row
//    axis (K for dQ, dO and Q for dK/dV) come through ldmatrix.trans.
//  * q/k/v/dO/O are read through their (B, S, H, D) strides, so the head
//    fold costs nothing; dQ/dK/dV are written contiguous (B, S, H, 64).
// Not yet done: cp.async/TMA double buffering and wgmma, as in the forward.

#include <math.h>

#include "flash_common.cuh"

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

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sDO[kTile][kLd];
  __shared__ float sLse[kTile], sDelta[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;                 // this warp's first key row

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  const float* lseb = lse + (long long)bh * Sq;
  const float* deltab = delta + (long long)bh * Sq;

  load_tile(sK, k + b * ks.b + h * ks.h, ks.s, k0);
  load_tile(sV, v + b * vs.b + h * vs.h, vs.s, k0);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];              // A fragments of K and V
  load_a_frags(ka, sK, wr, g, t4);
  load_a_frags(va, sV, wr, g, t4);

  float dk_acc[8][4], dv_acc[8][4];         // key rows (g, g+8) x 64 dims
  zero(dk_acc);
  zero(dv_acc);
  for (int q0 = 0; q0 < Sq; q0 += kTile) {
    __syncthreads();                        // previous tile fully consumed
    load_tile(sQ, qb, qs.s, q0);
    load_tile(sDO, dob, dos.s, q0);
    if (threadIdx.x < kTile)
      sLse[threadIdx.x] = lseb[q0 + threadIdx.x] * kLog2e;
    else
      sDelta[threadIdx.x - kTile] = deltab[q0 + threadIdx.x - kTile];
    __syncthreads();

    float st[8][4], dpt[8][4];              // key rows (g, g+8) x 64 queries
    zero(st);
    zero(dpt);
    mma_abt(st, ka, sQ, g, t4);             // K Q^T = S^T
    mma_abt(dpt, va, sDO, g, t4);           // V dO^T = dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      // a C tile's columns are queries nt*8 + 2*t4 + {0, 1}
      const int c = nt * 8 + t4 * 2;
      const float l0 = sLse[c], l1 = sLse[c + 1];
      const float d0 = sDelta[c], d1 = sDelta[c + 1];
      st[nt][0] = exp2f(st[nt][0] * scale_log2 - l0);
      st[nt][1] = exp2f(st[nt][1] * scale_log2 - l1);
      st[nt][2] = exp2f(st[nt][2] * scale_log2 - l0);
      st[nt][3] = exp2f(st[nt][3] * scale_log2 - l1);
      dpt[nt][0] = st[nt][0] * (dpt[nt][0] - d0);
      dpt[nt][1] = st[nt][1] * (dpt[nt][1] - d1);
      dpt[nt][2] = st[nt][2] * (dpt[nt][2] - d0);
      dpt[nt][3] = st[nt][3] * (dpt[nt][3] - d1);
    }
    mma_ab(dv_acc, st, sDO, lane);          // dV += P^T dO
    mma_ab(dk_acc, dpt, sQ, lane);          // dK += dS^T Q
  }
  const int r0 = k0 + wr + g;
  store_rows(dk, dk_acc, b, Skv, H, h, r0, t4, scale, scale);
  store_rows(dv, dv_acc, b, Skv, H, h, r0, t4, 1.f, 1.f);
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
// (B, Skv, H, 64) bf16. Returns the launch's cudaError_t.
extern "C" int dt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Skv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, void* stream) {
  dim3 grid(Skv / kTile, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
      Strides{do_sb, do_ss, do_sh}, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
