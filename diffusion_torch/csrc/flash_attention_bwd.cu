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
// or 4096, d = 64) the work is S x S x 64 products against O(S * d) bytes,
// far above the card's flop-per-byte ridge, so the tensor cores bound both
// kernels: three products a tile in dQ (S = Q K^T, dP = dO V^T, dQ += dS K),
// four in dK/dV, and one exponential per score in each (MUFU.EX2, 16 a clock
// per SM: two thirds of the time the tensor cores take for dQ's three
// products of the same scores), so the exponentials must overlap the
// products.
//
// Design against that bound (hopper_common.cuh has the building blocks):
//  * Two kernels, as on the TPU, because CUDA blocks run in no order and a
//    sum across blocks would need atomics: dQ owns one (b*h, 128 q rows) per
//    block and loops over K/V tiles; dK/dV owns one (b*h, 128 keys) per
//    block and loops over Q/dO tiles. No atomics, so the result is
//    deterministic. Both have three warpgroups: two consumers of 64 rows
//    each and one producer, whose single thread issues every TMA load of
//    128-byte-swizzled tiles through a ring of stages guarded by "full" and
//    "empty" mbarriers and which gives up its registers (setmaxnreg) to the
//    consumers.
//  * dQ: TMA loads the block's Q, dO and O once (O only for delta) and
//    streams 64-key K and V tiles through a 4-stage ring. Each consumer
//    first forms delta = rowsum(dO * O) for its rows from the dO and O
//    tiles in shared memory (both carry the same swizzle, so a chunk of
//    one pairs with the same chunk of the other without unswizzling),
//    keeps it in registers and writes it out for the dK/dV kernel, which
//    runs after it on the same stream; it also loads its 64 rows of Q and
//    dO once as register A fragments. Per tile it runs S = Q K^T and
//    dP = dO V^T as wgmma with Q and dO from registers and K and V read
//    K-major from shared memory, forms dS = p (dp - delta) in registers
//    and packs it to bf16 in the A-operand layout (the accumulator layout
//    of S), and runs dQ += dS K as wgmma with dS from registers and K read
//    MN-major from the same tile S read K-major. Tile i's S and dP are
//    issued together with tile i-1's dQ product, and tile i's exponentials
//    run while that product is on the tensor cores; the dS of alternate
//    tiles lives in two register sets, and a stage is released once the
//    product that reads it has completed. This plan is the fastest of
//    those measured (PERF.md): at 128-key tiles the two dS sets do not
//    fit in the registers and ptxas serializes the overlap. Where Skv is
//    a multiple of 64 no key tile is ragged; otherwise the kernel's tail
//    instance (kTail) forces dS to 0 on the last tile's padded keys
//    (p = exp(-lse) overflows where lse < -88, and inf times their zero K
//    rows is NaN). q rows past Sq read as zeros and are neither read from
//    lse nor written.
//  * dK/dV: TMA loads the block's K and V once; the producer streams
//    64-query tiles of Q and dO, with their 64 lse and delta values (bulk
//    copies), through a ring of kStages stages. Per tile each consumer runs
//    S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 with all operands in
//    shared memory (K and V are A, K-major; Q and dO are B, K-major), makes
//    P^T and dS^T in registers, and runs dV += P^T dO and dK += dS^T Q with
//    P^T and dS^T as register A operands and dO and Q read MN-major from
//    the same swizzled tiles. dK and dV are 64 x 64 fp32 per warpgroup, 32
//    registers each per thread. Where Sq is not a multiple of 64, the tail
//    instance (kTail) streams ceil(Sq / 64) tiles and reads lse and delta
//    from global memory (a bulk copy needs 16-byte aligned rows), issued
//    before the tile's products so that the loads overlap them: a query
//    past Sq reads lse = +inf and delta = 0, so its p and dS are 0 and its
//    zero Q and dO rows add nothing to dK and dV.
//  * The tail instances are launched only where a length is not a multiple
//    of 64 (the entry points below): the whole-tile path is what it was.
//  * The exponentials are bare MUFU.EX2 (exp2_ftz) in both kernels, so the
//    two give P the same bits.
//  * q/k/v/dO/O are read through their (B, S, H, D) strides (4-D tensor
//    maps), so the head fold costs nothing; dQ/dK/dV are written contiguous
//    (B, S, H, D). Rows past the end read as zeros and are not stored.
//  * Head dims 64 and 128 (template kD; flash_common.cuh has the halves a
//    128-dim tile is made of). At 128 each product over the head dim runs
//    over 8 k16 chunks in two halves, and each product whose N is the head
//    dim once per half into its own m64n64 accumulator, so dQ is 64 fp32
//    registers a thread and dK with dV 128. The tiles stay (dQ: 128 rows,
//    64-key K/V tiles; dK/dV: 128 keys, 64-query tiles). To fit, dQ reads
//    Q and dO for S and dP from shared memory (64 registers of A
//    fragments it cannot hold beside dQ's 64): both products become
//    m64n64 with operands in shared memory, as dK/dV's are. Its ring
//    holds 4 stages of 32 KB beside Q, dO and O (224 KB in all); dK/dV's
//    holds 3 of 32.5 KB beside K and V (162 KB). The dK/dV tail instance
//    reads a tile's lse and delta after its first two products complete,
//    not before: 32 more registers held across them would not fit beside
//    the 128 of dK and dV.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

constexpr int kConsumerThreads = 256;   // two consumer warpgroups

// ---- dQ ------------------------------------------------------------------

constexpr int kDqRows = 128;            // q rows per block: two warpgroups
constexpr int kDqKeys = 64;             // keys per streamed K/V tile
constexpr int kDqStages = 4;            // K/V ring depth
constexpr int kDqThreads = kConsumerThreads + 128;

template <int kD>
struct alignas(1024) DqSmem {
  __nv_bfloat16 q[kDqRows * kD];
  __nv_bfloat16 dout[kDqRows * kD];
  __nv_bfloat16 o[kDqRows * kD];
  __nv_bfloat16 k[kDqStages][kDqKeys * kD];
  __nv_bfloat16 v[kDqStages][kDqKeys * kD];
  uint64_t qo_full, full[kDqStages], empty[kDqStages];
};
template <int kD>
constexpr int kDqSmemBytes = sizeof(DqSmem<kD>) + 1024;  // + alignment slack

// d (64 rows x 64 keys, fp32) = A B^T over the 64 head dims, A from
// registers (A fragments, one per 16 dims), B (the tile's keys) K-major in
// shared memory; issued, not committed
__device__ __forceinline__ void issue_rs(float (&d)[32],
                                         const uint32_t (&a)[4][4],
                                         uint64_t b) {
  using namespace hopper;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma_m64n64k16_rs(d, a[kc], b + kc * kDescK16, kc > 0);
}

// d (64 rows x 64 keys, fp32) = A B^T over the kD head dims, A (this
// warpgroup's 64 rows of a kRows-row tile, from row a0) and B (the tile's
// keys) K-major in shared memory; issued, not committed
template <int kD, int kRows>
__device__ __forceinline__ void issue_ss(float (&d)[32],
                                         const __nv_bfloat16* a, int a0,
                                         const __nv_bfloat16* b) {
  using namespace hopper;
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc)
    wgmma_m64n64k16_ss(
        d, desc_sw128(half_of<kRows>(a, kc / 4) + a0 * 64)
               + (kc % 4) * kDescK16,
        desc_sw128(half_of<kDqKeys>(b, kc / 4)) + (kc % 4) * kDescK16,
        kc > 0);
}

// the A fragments of tile rows `row` and row + 8 (row % 8 == g) of a
// swizzled 64-dim tile: dims c of row r sit in chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const __nv_bfloat16* t, int row, int g,
                                       int t4) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {         // j & 1: row + 8; j & 2: dims + 8
      const int r = row + (j & 1) * 8;
      a[kc][j] = *reinterpret_cast<const uint32_t*>(
          t + r * 64 + ((2 * kc + (j >> 1)) ^ g) * 8 + 2 * t4);
    }
}

// rowsum(dO * O) of the tile row `row` (row % 8 == g) of kDqRows-row
// tiles, over the quad's four lanes. dO and O hold row r's 16-byte chunk c
// of each half at chunk c ^ (r % 8), so one physical chunk of each holds
// the same 8 dims. Lane t4 takes physical chunks (2 t4 + j) ^ g, j = 0, 1,
// of each half: the quad covers the row, and the 8 lanes of a quarter
// warp read 8 distinct chunks (no bank conflict).
template <int kD>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int row,
                                         int g, int t4) {
  float acc = 0.f;
#pragma unroll
  for (int hf = 0; hf < kD / 64; ++hf)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int off = hf * kDqRows * 64 + row * 64 + ((2 * t4 + j) ^ g) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(a + off);
    const uint4 y = *reinterpret_cast<const uint4*>(b + off);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 u = __bfloat1622float2(xs[e]);
      const float2 w = __bfloat1622float2(ys[e]);
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// dS = p (dp - delta), p = exp2(s * scale_log2 - lse * log2e), of one tile
// (rows g, g+8 x 64 keys), rounded to bf16 (as the TPU kernel casts ds to
// k's dtype) into the A fragments of dS K, 16 keys per k-chunk: chunk j of
// the accumulator is keys 8j..8j+7, two chunks one A fragment. nl0/nl1 are
// -lse * log2e and dl0/dl1 delta of the two rows. With kTail, keys at or
// past `valid` (the tile's real keys) take dS = 0: value j of chunk kc is
// key (2 kc + j / 4) * 8 + 2 t4 + (j & 1).
template <bool kTail>
__device__ __forceinline__ void ds_tile(const float (&s)[32],
                                        const float (&dp)[32],
                                        float scale_log2, float nl0,
                                        float nl1, float dl0, float dl1,
                                        int valid, int t4,
                                        uint32_t (&da)[kDqKeys / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < kDqKeys / 16; ++kc) {
    float d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {           // j & 2: row g+8
      const float p = hopper::exp2_ftz(
          fmaf(s[8 * kc + j], scale_log2, (j & 2) ? nl1 : nl0));
      d[j] = p * (dp[8 * kc + j] - ((j & 2) ? dl1 : dl0));
    }
    if (kTail && valid < kDqKeys) {         // uniform: the last tile only
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((2 * kc + j / 4) * 8 + 2 * t4 + (j & 1) >= valid) d[j] = 0.f;
    }
    da[kc][0] = pack_bf16(d[0], d[1]);
    da[kc][1] = pack_bf16(d[2], d[3]);
    da[kc][2] = pack_bf16(d[4], d[5]);
    da[kc][3] = pack_bf16(d[6], d[7]);
  }
}

template <int kD, bool kTail>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv,
                    float scale, float scale_log2) {
  using namespace hopper;
  constexpr int kHalves = kD / 64;
  // Q and dO as register A fragments (64 dims); at 128 they stay in
  // shared memory
  constexpr bool kRegsA = kD == 64;
  constexpr int kDqTileBytes = kDqKeys * kD * 2;
  extern __shared__ uint8_t smem_raw[];
  DqSmem<kD>& sm = *reinterpret_cast<DqSmem<kD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kDqRows;
  const int n_tiles = kTail ? (Skv + kDqKeys - 1) / kDqKeys : Skv / kDqKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
      mbar_expect_tx(&sm.qo_full, 3 * kDqRows * kD * 2);
      tma_load_tile<kD, kDqRows>(sm.q, &tq, &sm.qo_full, q0, h, b);
      tma_load_tile<kD, kDqRows>(sm.dout, &tdo, &sm.qo_full, q0, h, b);
      tma_load_tile<kD, kDqRows>(sm.o, &to, &sm.qo_full, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kDqStages;
        // the first pass over the ring finds every stage empty
        mbar_wait(&sm.empty[s], ((i / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kDqTileBytes);
        tma_load_tile<kD, kDqKeys>(sm.k[s], &tk, &sm.full[s], i * kDqKeys,
                                   h, b);
        tma_load_tile<kD, kDqKeys>(sm.v[s], &tv, &sm.full[s], i * kDqKeys,
                                   h, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64*wg .. +63
    regs_claim<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row = wg * 64 + warp * 16 + g;     // tile rows row, row + 8
    const int r0 = q0 + row, r1 = r0 + 8;
    const float* lseb = lse + (long long)bh * Sq;
    // -lse in log2 units; rows past Sq (zero Q, dO and O, not stored) take 0
    const float nl0 = r0 < Sq ? -lseb[r0] * kLog2e : 0.f;
    const float nl1 = r1 < Sq ? -lseb[r1] * kLog2e : 0.f;

    mbar_wait(&sm.qo_full, 0);
    const float dl0 = row_dot<kD>(sm.dout, sm.o, row, g, t4);
    const float dl1 = row_dot<kD>(sm.dout, sm.o, row + 8, g, t4);
    if (t4 == 0) {
      if (r0 < Sq) delta[(long long)bh * Sq + r0] = dl0;
      if (r1 < Sq) delta[(long long)bh * Sq + r1] = dl1;
    }

    // Q and dO as A fragments (64 dims only)
    uint32_t qa[kRegsA ? 4 : 1][4], doa[kRegsA ? 4 : 1][4];
    if constexpr (kRegsA) {
      load_a(qa, sm.q + wg * 64 * 64, warp * 16 + g, g, t4);
      load_a(doa, sm.dout + wg * 64 * 64, warp * 16 + g, g, t4);
    }

    float acc[kHalves][32];                 // dQ rows (g, g+8) x kD dims
#pragma unroll
    for (int j = 0; j < kHalves; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

    // S = Q K^T and dP = dO V^T of tile i (issued, committed; not waited for)
    auto issue_scores = [&](float (&s)[32], float (&dp)[32], int i) {
      const int st = i % kDqStages;
      mbar_wait(&sm.full[st], (i / kDqStages) & 1);
      wgmma_fence();
      if constexpr (kRegsA) {
        issue_rs(s, qa, desc_sw128(sm.k[st]));
        issue_rs(dp, doa, desc_sw128(sm.v[st]));
      } else {
        issue_ss<kD, kDqRows>(s, sm.q, wg * 64, sm.k[st]);
        issue_ss<kD, kDqRows>(dp, sm.dout, wg * 64, sm.v[st]);
      }
      wgmma_commit();
    };
    // dQ += dS K of tile i, dS from `da`, K read MN-major (issued, committed)
    auto issue_dq = [&](int i, const uint32_t (&da)[kDqKeys / 16][4]) {
#pragma unroll
      for (int j = 0; j < kHalves; ++j) fence_regs(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        const uint64_t k_desc =
            desc_sw128(half_of<kDqKeys>(sm.k[i % kDqStages], j));
#pragma unroll
        for (int kc = 0; kc < kDqKeys / 16; ++kc)
          wgmma_m64n64k16_rs_tn(acc[j], da[kc], k_desc + kc * kDescRows16);
      }
      wgmma_commit();
    };
    // Tile i's S and dP are issued with tile i-1's dQ product, and tile
    // i's dS is formed while that product runs. The dS of alternate tiles
    // lives in two register sets, so no register that a product in flight
    // reads is written before it completes (a copy between them made ptxas
    // serialize the products, C7513).
    auto step = [&](int i, const uint32_t (&cur)[kDqKeys / 16][4],
                    uint32_t (&next)[kDqKeys / 16][4]) {
      float s[32], dp[32];
      issue_scores(s, dp, i);
      issue_dq(i - 1, cur);
      wgmma_wait<1>();                      // S and dP, not yet dQ
      fence_regs(s);
      fence_regs(dp);
      ds_tile<kTail>(s, dp, scale_log2, nl0, nl1, dl0, dl1,
                     Skv - i * kDqKeys, t4, next);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kHalves; ++j) fence_regs(acc[j]);
      mbar_arrive(&sm.empty[(i - 1) % kDqStages]);  // done with tile i-1
    };
    uint32_t da0[kDqKeys / 16][4], da1[kDqKeys / 16][4];
    {
      float s[32], dp[32];
      issue_scores(s, dp, 0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      ds_tile<kTail>(s, dp, scale_log2, nl0, nl1, dl0, dl1, Skv, t4, da0);
    }
    int i = 1;
    for (; i + 1 < n_tiles; i += 2) {
      step(i, da0, da1);
      step(i + 1, da1, da0);
    }
    if (i < n_tiles) {
      step(i, da0, da1);
      issue_dq(i, da1);
    } else {
      issue_dq(i - 1, da0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kHalves; ++j) fence_regs(acc[j]);
    mbar_arrive(&sm.empty[(n_tiles - 1) % kDqStages]);
    store_rows<kD>(dq, reinterpret_cast<const float(*)[4]>(acc), b, Sq, H, h,
                   r0, t4, scale, scale);
  }
}

// ---- dK/dV ---------------------------------------------------------------

constexpr int kBKeys = 128;         // keys per dK/dV block: two warpgroups
constexpr int kBQ = 64;             // queries per streamed Q/dO tile
constexpr int kStages = 3;          // Q/dO ring depth
constexpr int kDkvThreads = kConsumerThreads + 128;

template <int kD>
struct alignas(1024) DkvSmem {
  __nv_bfloat16 k[kBKeys * kD];
  __nv_bfloat16 v[kBKeys * kD];
  __nv_bfloat16 q[kStages][kBQ * kD];
  __nv_bfloat16 dout[kStages][kBQ * kD];
  float lse[kStages][kBQ];
  float delta[kStages][kBQ];
  uint64_t kv_full, full[kStages], empty[kStages];
};
template <int kD>
constexpr int kDkvSmemBytes = sizeof(DkvSmem<kD>) + 1024;  // + slack

template <int kD, bool kTail>
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
  constexpr int kHalves = kD / 64;
  constexpr int kQTileBytes = kBQ * kD * 2;
  // the tail instance's lse and delta loads issued before the tile's
  // products (64 dims), or after the first two complete (128 dims)
  constexpr bool kEarlyTail = kTail && kD == 64;
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<kD>& sm = *reinterpret_cast<DkvSmem<kD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBKeys;
  const int n_tiles = kTail ? (Sq + kBQ - 1) / kBQ : Sq / kBQ;
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
      tma_load_tile<kD, kBKeys>(sm.k, &tk, &sm.kv_full, k0, h, b);
      tma_load_tile<kD, kBKeys>(sm.v, &tv, &sm.kv_full, k0, h, b);
      const float* lseb = lse + (long long)bh * Sq;
      const float* deltab = delta + (long long)bh * Sq;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // the first pass over the ring finds every stage empty
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s],
                       2 * kQTileBytes + (kTail ? 0 : 2 * kBQ * 4));
        tma_load_tile<kD, kBQ>(sm.q[s], &tq, &sm.full[s], i * kBQ, h, b);
        tma_load_tile<kD, kBQ>(sm.dout[s], &tdo, &sm.full[s], i * kBQ, h,
                               b);
        if (!kTail) {
          bulk_load(sm.lse[s], lseb + i * kBQ, kBQ * 4, &sm.full[s]);
          bulk_load(sm.delta[s], deltab + i * kBQ, kBQ * 4, &sm.full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys k0 + 64*wg .. +63
    regs_claim<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    uint64_t k_desc[kHalves], v_desc[kHalves];
#pragma unroll
    for (int j = 0; j < kHalves; ++j) {
      k_desc[j] = desc_sw128(half_of<kBKeys>(sm.k, j) + wg * 64 * 64);
      v_desc[j] = desc_sw128(half_of<kBKeys>(sm.v, j) + wg * 64 * 64);
    }
    const float* lseb = lse + (long long)bh * Sq;
    const float* deltab = delta + (long long)bh * Sq;

    float dk_acc[kHalves][32], dv_acc[kHalves][32];  // keys (g, g+8) x kD
#pragma unroll
    for (int j = 0; j < kHalves; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

    // the tail instance reads a tile's lse and delta from global memory:
    // queries past Sq read lse = +inf and delta = 0 (p = exp2(-inf) = 0,
    // dS = 0)
    auto tail_loads = [&](float (&tl)[kBQ / 8][2], float (&td)[kBQ / 8][2],
                          int i) {
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = i * kBQ + nt * 8 + t4 * 2 + e;
          tl[nt][e] = INFINITY;
          td[nt][e] = 0.f;
          if (qc < Sq) {
            tl[nt][e] = lseb[qc];
            td[nt][e] = deltab[qc];
          }
        }
    };

    mbar_wait(&sm.kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      // issued here, where they fit, so that the loads overlap the
      // products below
      float tl[kBQ / 8][2], td[kBQ / 8][2];
      if (kEarlyTail) tail_loads(tl, td, i);

      float st[32], dpt[32];                // key rows (g, g+8) x 64 queries
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)  // K Q^T = S^T
        wgmma_m64n64k16_ss(
            st, k_desc[kc / 4] + (kc % 4) * kDescK16,
            desc_sw128(half_of<kBQ>(sm.q[s], kc / 4)) + (kc % 4) * kDescK16,
            kc > 0);
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)  // V dO^T = dP^T
        wgmma_m64n64k16_ss(
            dpt, v_desc[kc / 4] + (kc % 4) * kDescK16,
            desc_sw128(half_of<kBQ>(sm.dout[s], kc / 4))
                + (kc % 4) * kDescK16,
            kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      if (kTail && !kEarlyTail) tail_loads(tl, td, i);

      // P^T and dS^T, packed into the A fragments of the next two
      // products: an accumulator chunk's columns are queries
      // nt*8 + 2*t4 + {0, 1}
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
        const int c = nt * 8 + t4 * 2;
        float l0, l1, d0, d1;
        if (kTail) {
          l0 = tl[nt][0] * kLog2e;
          l1 = tl[nt][1] * kLog2e;
          d0 = td[nt][0];
          d1 = td[nt][1];
        } else {
          l0 = sm.lse[s][c] * kLog2e;
          l1 = sm.lse[s][c + 1] * kLog2e;
          d0 = sm.delta[s][c];
          d1 = sm.delta[s][c + 1];
        }
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
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        fence_regs(dv_acc[j]);
        fence_regs(dk_acc[j]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {   // dV += P^T dO
        const uint64_t do_desc = desc_sw128(half_of<kBQ>(sm.dout[s], j));
#pragma unroll
        for (int kc = 0; kc < kBQ / 16; ++kc)
          wgmma_m64n64k16_rs_tn(dv_acc[j], pa[kc],
                                do_desc + kc * kDescRows16);
      }
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {   // dK += dS^T Q
        const uint64_t q_desc = desc_sw128(half_of<kBQ>(sm.q[s], j));
#pragma unroll
        for (int kc = 0; kc < kBQ / 16; ++kc)
          wgmma_m64n64k16_rs_tn(dk_acc[j], da[kc],
                                q_desc + kc * kDescRows16);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        fence_regs(dv_acc[j]);
        fence_regs(dk_acc[j]);
      }
      mbar_arrive(&sm.empty[s]);            // this thread is done with s
    }
    const int r0 = k0 + wg * 64 + warp * 16 + g;
    store_rows<kD>(dk, reinterpret_cast<const float(*)[4]>(dk_acc), b, Skv,
                   H, h, r0, t4, scale, scale);
    store_rows<kD>(dv, reinterpret_cast<const float(*)[4]>(dv_acc), b, Skv,
                   H, h, r0, t4, 1.f, 1.f);
  }
}

template <int kD>
int launch_dq(const CUtensorMap* maps, const void* lse, void* delta,
              void* dq, int B, int H, int Sq, int Skv, float scale,
              void* stream) {
  const auto kernel = (Sq % 64 || Skv % 64) ? flash_bwd_dq_kernel<kD, true>
                                             : flash_bwd_dq_kernel<kD, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes<kD>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  dim3 grid((Sq + kDqRows - 1) / kDqRows, B * H);
  kernel<<<grid, kDqThreads, kDqSmemBytes<kD>,
           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Sq, Skv, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dkv(const CUtensorMap* maps, const void* lse, const void* delta,
               void* dk, void* dv, int B, int H, int Sq, int Skv, float scale,
               void* stream) {
  const auto kernel = (Sq % 64 || Skv % 64)
                          ? flash_bwd_dkv_kernel<kD, true>
                          : flash_bwd_dkv_kernel<kD, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmemBytes<kD>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  dim3 grid((Skv + kBKeys - 1) / kBKeys, B * H);
  kernel<<<grid, kDkvThreads, kDkvSmemBytes<kD>,
           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout: (B, S, H, D) bf16 views with unit last stride, D 64 or
// 128; the wrapper (diffusion_torch/ops/flash_attention.py) checks shapes,
// strides and alignment. lse: contiguous (B, H, Sq) fp32 from the forward.
// delta: (B, H, Sq) fp32, written here for the dK/dV launch. dq: contiguous
// (B, Sq, H, D) bf16. Sq and Skv may be any lengths: the tail instance
// runs where one is not a multiple of 64. Returns the launch's cudaError_t
// (cudaErrorInvalidValue where D is neither or the CUDA driver refuses a
// tensor map).
extern "C" int dt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int B, int H,
    int Sq, int Skv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, void* stream) {
  CUtensorMap maps[5];
  if ((D != 64 && D != 128) ||
      !hopper::make_map(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh,
                        kDqRows) ||
      !hopper::make_map(&maps[1], k, B, Skv, H, D, k_sb, k_ss, k_sh,
                        kDqKeys) ||
      !hopper::make_map(&maps[2], v, B, Skv, H, D, v_sb, v_ss, v_sh,
                        kDqKeys) ||
      !hopper::make_map(&maps[3], o, B, Sq, H, D, o_sb, o_ss, o_sh,
                        kDqRows) ||
      !hopper::make_map(&maps[4], dout, B, Sq, H, D, do_sb, do_ss, do_sh,
                        kDqRows))
    return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? launch_dq<64>(maps, lse, delta, dq, B, H, Sq, Skv, scale,
                                 stream)
                 : launch_dq<128>(maps, lse, delta, dq, B, H, Sq, Skv, scale,
                                  stream);
}

// As above; delta is the dQ launch's output. dk, dv: contiguous
// (B, Skv, H, D) bf16. Returns the launch's cudaError_t
// (cudaErrorInvalidValue where D is neither or the CUDA driver refuses a
// tensor map).
extern "C" int dt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Skv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, void* stream) {
  CUtensorMap maps[4];
  if ((D != 64 && D != 128) ||
      !hopper::make_map(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, kBQ) ||
      !hopper::make_map(&maps[1], k, B, Skv, H, D, k_sb, k_ss, k_sh,
                        kBKeys) ||
      !hopper::make_map(&maps[2], v, B, Skv, H, D, v_sb, v_ss, v_sh,
                        kBKeys) ||
      !hopper::make_map(&maps[3], dout, B, Sq, H, D, do_sb, do_ss, do_sh,
                        kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? launch_dkv<64>(maps, lse, delta, dk, dv, B, H, Sq, Skv,
                                  scale, stream)
                 : launch_dkv<128>(maps, lse, delta, dk, dv, B, H, Sq, Skv,
                                   scale, stream);
}
