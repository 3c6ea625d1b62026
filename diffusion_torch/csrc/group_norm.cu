// GroupNorm(+SiLU) forward and backward for Hopper (sm_90a) over a
// channels-last (B, L, C) slab, in bf16 or fp32, with fp32 statistics.
//
// The forward (dt_group_norm_fwd) replaces the TPU kernel
// diffusion_tpu/ops/groupnorm.py::_fwd_kernel (the pallas_call in `_fwd`);
// it writes y in x's dtype and mean/rstd (B, G) in fp32 for the backward.
// The backward (dt_group_norm_bwd) replaces `_bwd_kernel` (the pallas_call
// in `_bwd`): the analytic GN(+SiLU) VJP from the saved (mean, rstd), with
// dscale and dbias shaped (C,) and summed over the batch.
//
// What bounds them on the card. A few flops an element, so at scale the
// bytes: the forward reads x and writes y, the backward reads x and g and
// writes dx. But most of the UNet's 61 calls move under 5 MB (L = 16..256
// at batch 16), where a call costs its launch and the latency of its
// dependent steps: the copies, the block's reductions, the cluster
// barrier, so a call is one launch. At the larger slabs the SiLU's
// exponential and reciprocal (two SFU operations an element, four in the
// backward, which recomputes them for dx) and, where a slab exceeds the
// card's shared memory, the waves of blocks bound the time.
//
// The TPU kernel holds a whole (L, C) image slab in VMEM per grid step.
// Hopper's counterpart is a thread-block cluster: up to 8 blocks (16 with
// the non-portable attribute) whose shared memories read each other
// (distributed shared memory, DSMEM). The design:
//  * The wrapper plans (diffusion_torch/ops/groupnorm.py::plan): it cuts each
//    image's slab into channel slices of whole groups, each a multiple of 16
//    bytes wide, and each slice's rows over `parts` blocks of `rows` rows,
//    by rules fitted to measured times of every feasible plan.
//  * One launch where the slice fits a cluster (every UNet shape): one
//    cluster per (slice, image). Each block copies its (rows x width) tile
//    (two tiles, x and g, in the backward) into shared memory once with
//    16-byte cp.async in four commit groups, so device memory sees each
//    input byte read once. Forward: per-group (n, mean, M2) of the block's
//    rows in two passes over shared memory, the first as the copies land;
//    the cluster's blocks read each other's partials through DSMEM and
//    each Chan-merges them in rank order (never E[x^2]-E[x]^2, so large
//    means keep their precision); per channel a = rstd * scale and
//    b = bias - mean * a, then y = SiLU(x * a + b) from shared memory, one
//    FMA an element, 16-byte stores. Backward: per-channel sums of dz and
//    dz * x-hat over the block's rows, per-group m1, m2 summed over the
//    cluster's ranks in order through DSMEM, dx from shared memory. Rank 0
//    writes its cluster's per-channel sums; the last cluster of a slice to
//    arrive (an atomic ticket after __threadfence, before its own dx) adds
//    the B images' sums in image order into dscale/dbias: one launch, no
//    float atomics, bitwise equal reruns.
//  * Two launches for slabs no cluster holds (the VAE decoder at 512px,
//    262,144 rows): a statistics launch writes per-(image, chunk, group)
//    partials, and the apply launch Chan-merges the partials of its own
//    groups (a fixed tree over the chunks) while its tile's cp.async copies
//    are in flight, then applies. x is read twice there: L2 cannot hold it.
//    The backward follows the same scheme (per-chunk channel and group sums;
//    the chunk-0 blocks take the ticket for dscale/dbias).
//  * C * itemsize not a multiple of 16 (or a misaligned pointer): the same
//    kernels with scalar loads and stores (vec = 1), slices of whole groups.
// Threads own one 16-byte column of a tile and every `RP`-th row of it, so
// the per-channel constants stay in registers, a thread reads back only
// what it copied (cp.async.wait_group, no barrier), and nothing divides per
// element. Block reductions add the row lanes' partials per channel, then
// a warp a group adds its channels in a fixed xor tree.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// dynamic shared memory a block may ask for: the H100's 232,448 bytes less
// room for the kernels' static shared memory
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kMaxCluster = 16;    // with the non-portable cluster attribute

enum Mode { kCluster = 0, kStats = 1, kApply = 2 };

// One call's plan, chosen by the wrapper.
struct Plan {
  int B, L, C, G;
  int width;     // channels per slice (whole groups)
  int parts;     // blocks per (slice, image): the cluster, or row chunks
  int rows;      // rows per block
  int act;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
}

// shared memory of one block: `tiles` (rows x width) tiles, then the
// per-group float2 pairs (2 x gs), the row lanes' partials (2 x threads x
// vec floats), the reduction's scratch (2 x (threads + width)) and two
// float2 per channel; ops/groupnorm.py::Plan.smem mirrors it
__host__ __device__ __forceinline__ int smem_bytes(int tiles, int rows,
                                                  int width, int itemsize,
                                                  int gs, int threads,
                                                  int vec) {
  return tiles * align16(rows * width * itemsize) + 16 * gs +
         4 * (2 * threads * vec + 2 * threads + 4 * width);
}

constexpr int kStages = 4;   // commit groups of a tile's copies

// The thread's tile column and row lane. A thread copies rows rp, rp + RP,
// ... of column col into the tile and is the only one to read them, so the
// copies need no barrier: cp.async.wait_group suffices.
struct Lanes {
  int V, RP, col, rp;
  bool active;
  __device__ Lanes(int width, int vec) {
    V = width / vec;
    RP = blockDim.x / V;
    col = threadIdx.x % V;
    rp = threadIdx.x / V;
    active = rp < RP;
  }
  // the thread's rows of an n-row tile
  __device__ int count(int n) const {
    return active && rp < n ? (n - 1 - rp) / RP + 1 : 0;
  }
  __device__ int row(int k) const { return rp + k * RP; }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the thread's copies of stages 0..st have landed
__device__ __forceinline__ void wait_stage(int st) {
  static_assert(kStages == 4, "one case per stage");
  if (st == 0) cp_async_wait<3>();
  else if (st == 1) cp_async_wait<2>();
  else if (st == 2) cp_async_wait<1>();
  else cp_async_wait<0>();
}

template <typename T, int VEC>
__device__ __forceinline__ void copy_row(T* tile, const T* src, int r, int C,
                                         const Lanes& ln) {
  T* dst = tile + (r * ln.V + ln.col) * VEC;
  const T* from = src + (long long)r * C + ln.col * VEC;
  if constexpr (VEC * sizeof(T) == 16) {
    cp_async16(dst, from);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = from[j];
  }
}

// copy the thread's rows of an n-row slice (row stride C elements) into a
// dense tile, and of a second one where src2 is given, in kStages commit
// groups of consecutive rows
template <typename T, int VEC>
__device__ void load_staged(T* tile, const T* src, T* tile2, const T* src2,
                            int n, int C, const Lanes& ln) {
  const int K = ln.count(n);
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    for (int k = st * K / kStages; k < (st + 1) * K / kStages; ++k) {
      copy_row<T, VEC>(tile, src, ln.row(k), C, ln);
      if (src2) copy_row<T, VEC>(tile2, src2, ln.row(k), C, ln);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> tile_at(const T* tile, int r,
                                                const Lanes& ln) {
  return reinterpret_cast<const Pack<T, VEC>*>(tile)[r * ln.V + ln.col];
}

// red[rp][c] = the thread's partial for channel c of the slice; ends
// synchronized
template <int VEC>
__device__ __forceinline__ void store_lanes(const float (&acc)[VEC],
                                            float* red, int width,
                                            const Lanes& ln) {
  if (ln.active) {
    float* dst = red + ln.rp * width + ln.col * VEC;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = acc[j];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Chan's parallel merge of (nb, mb, m2b) into (n, mean, m2)
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mb - mean, f = __fdividef(nb, nn);
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nn;
}

// cha[c] (and chb[c]) = the sums over the RP row lanes of red[rp * W + c]
// (and red2[rp * W + c]): Q = threads / W threads a channel each add every
// Q-th lane, then thread c adds their Q sums in order. Then a warp a group:
// out[2 g] (and out[2 g + 1]) = mul * the sum of (wt *) cha (and chb) over
// the group's channels, its lanes striding over them and a fixed xor tree
// adding the lanes. tmp holds 2 x Q x W <= 2 (threads + W) floats. Ends
// synchronized.
template <bool kTwo>
__device__ void block_sums(const float* red, const float* red2, int RP,
                           int W, int cgc, int gs, const float* wt, float mul,
                           float* tmp, float* cha, float* chb, float* out) {
  const int Q = max(1, (int)blockDim.x / W);
  for (int i = threadIdx.x; i < Q * W; i += blockDim.x) {
    const int q = i / W, c = i - q * W;
    float a = 0.f, b = 0.f;
    for (int r = q; r < RP; r += Q) {
      a += red[r * W + c];
      if (kTwo) b += red2[r * W + c];
    }
    tmp[i] = a;
    if (kTwo) tmp[Q * W + i] = b;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < Q; ++q) {
      a += tmp[q * W + c];
      if (kTwo) b += tmp[(Q + q) * W + c];
    }
    cha[c] = a;
    if (kTwo) chb[c] = b;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < gs; g += blockDim.x / 32) {
    float a = 0.f, b = 0.f;
    for (int j = lane; j < cgc; j += 32) {
      const float w = wt ? wt[g * cgc + j] : 1.f;
      a += w * cha[g * cgc + j];
      if (kTwo) b += w * chb[g * cgc + j];
    }
    a = warp_sum(a);
    if (kTwo) b = warp_sum(b);
    if (lane == 0) {
      out[2 * g] = a * mul;
      if (kTwo) out[2 * g + 1] = b * mul;
    }
  }
  __syncthreads();
}

// cluster barrier halves: arrive (release) early, wait (acquire) late
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int rows_of(int part, const Plan& p) {
  return max(0, min(p.rows, p.L - part * p.rows));
}

// 1 / d in one MUFU instruction (0 for d = inf)
__device__ __forceinline__ float rcp_approx(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

__device__ __forceinline__ float silu(float t) {
  return t * rcp_approx(1.f + __expf(-t));
}

// lanes per group for a merge over chunks: a power of two <= 32, so a
// group's lanes share a warp
__device__ __forceinline__ int merge_lanes(int gs) {
  int P = 32;
  while (P > 1 && gs * P > (int)blockDim.x) P >>= 1;
  return P;
}

// forward, two launches: the (mean, rstd) of the slice's gs groups of image
// b, Chan-merged from the statistics launch's per-chunk partials in a fixed
// tree (lane l takes chunks l, l + P, ..., then the lanes merge pairwise)
__device__ void merge_chunk_stats(const float2* part, int b, int s, int gs,
                                  const Plan& p, float eps, float2* fin) {
  const int cgc = p.C / p.G, P = merge_lanes(gs), l = threadIdx.x % P;
  const int per_pass = blockDim.x / P;
  for (int g0 = 0; g0 < gs; g0 += per_pass) {
    const int g = g0 + threadIdx.x / P;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    if (g < gs) {
      for (int k = l; k < p.parts; k += P) {
        const float2 q = part[((long long)b * p.parts + k) * p.G + s * gs + g];
        chan_merge(n, mean, m2, (float)(rows_of(k, p) * cgc), q.x, q.y);
      }
    }
    for (int o = 1; o < P; o <<= 1) {
      const float n2 = __shfl_down_sync(0xffffffffu, n, o, P);
      const float mean2 = __shfl_down_sync(0xffffffffu, mean, o, P);
      const float m22 = __shfl_down_sync(0xffffffffu, m2, o, P);
      if (l % (2 * o) == 0) chan_merge(n, mean, m2, n2, mean2, m22);
    }
    if (g < gs && l == 0) fin[g] = make_float2(mean, rsqrtf(m2 / n + eps));
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(512)
    gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd,
                  float2* __restrict__ part, Plan p, float eps, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cgc = p.C / p.G, W = p.width, gs = W / cgc;
  const int blk = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const Lanes ln(W, VEC);
  const int n = rows_of(blk, p), K = ln.count(n);
  T* tile = reinterpret_cast<T*>(smem);
  float2* gstat = reinterpret_cast<float2*>(
      smem + align16(p.rows * W * (int)sizeof(T)));
  float2* fin = gstat + gs;
  float* red = reinterpret_cast<float*>(fin + gs);   // threads x VEC
  float* red2 = red + blockDim.x * VEC;              // threads x VEC
  float* tmp = red2 + blockDim.x * VEC;              // 2 (threads + W)
  float* cha = tmp + 2 * (blockDim.x + W);           // W
  const long long off = ((long long)b * p.L + (long long)blk * p.rows) * p.C +
                        (long long)s * W;
  const bool clustered = mode == kCluster && p.parts > 1;

  load_staged<T, VEC>(tile, x + off, nullptr, nullptr, n, p.C, ln);
  int gidx[VEC];   // the slice's group of each of the thread's channels
#pragma unroll
  for (int j = 0; j < VEC; ++j) gidx[j] = (ln.col * VEC + j) / cgc;
  if (mode == kApply) {
    merge_chunk_stats(part, b, s, gs, p, eps, fin);
    cp_async_wait<0>();
    __syncthreads();
  } else {
    // pass 1, stage by stage as the copies land: the block's group means
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      wait_stage(st);
      for (int k = st * K / kStages; k < (st + 1) * K / kStages; ++k) {
        const Pack<T, VEC> v = tile_at<T, VEC>(tile, ln.row(k), ln);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += to_f(v.v[j]);
      }
    }
    store_lanes<VEC>(acc, red, W, ln);
    block_sums<false>(red, nullptr, ln.RP, W, cgc, gs, nullptr,
                      n ? 1.f / (float)(n * cgc) : 0.f, tmp, cha, nullptr,
                      &gstat[0].x);
    // pass 2: M2 about those means
    float mu[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = ln.active ? gstat[gidx[j]].x : 0.f;
      acc[j] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const Pack<T, VEC> v = tile_at<T, VEC>(tile, ln.row(k), ln);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_f(v.v[j]) - mu[j];
        acc[j] += d * d;
      }
    }
    store_lanes<VEC>(acc, red2, W, ln);
    block_sums<false>(red2, nullptr, ln.RP, W, cgc, gs, nullptr, 1.f, tmp,
                      cha, nullptr, &gstat[0].y);
    if (mode == kStats) {
      for (int g = threadIdx.x; g < gs; g += blockDim.x)
        part[((long long)b * p.parts + blk) * p.G + s * gs + g] = gstat[g];
      return;
    }
    // the cluster's partials, merged in rank order by every block
    if (clustered) {
      cluster_arrive();
      cluster_wait();
    }
    cg::cluster_group cluster = cg::this_cluster();
    for (int g = threadIdx.x; g < gs; g += blockDim.x) {
      float cn = 0.f, cm = 0.f, c2 = 0.f;
      for (int r0 = 0; r0 < p.parts; r0 += 4) {   // four ranks in flight
        float2 q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (r0 + k < p.parts)
            q[k] = clustered ? cluster.map_shared_rank(gstat, r0 + k)[g]
                             : gstat[g];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (r0 + k < p.parts)
            chan_merge(cn, cm, c2, (float)(rows_of(r0 + k, p) * cgc), q[k].x,
                       q[k].y);
      }
      fin[g] = make_float2(cm, rsqrtf(c2 / cn + eps));
    }
    __syncthreads();
    // done reading the other blocks' partials; wait for them at the end
    if (clustered) cluster_arrive();
  }

  if (blk == 0) {
    for (int g = threadIdx.x; g < gs; g += blockDim.x) {
      mean[b * p.G + s * gs + g] = fin[g].x;
      rstd[b * p.G + s * gs + g] = fin[g].y;
    }
  }
  if (ln.active) {
    // per channel y = x * a + b, a = rstd * scale, b = bias - mean * a
    float av[VEC], bv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = ln.col * VEC + j;
      const float2 f = fin[gidx[j]];
      av[j] = f.y * scale[s * W + c];
      bv[j] = bias[s * W + c] - f.x * av[j];
    }
    T* dst = y + off + ln.col * VEC;
    for (int k = 0; k < K; ++k) {
      const int r = ln.row(k);
      const Pack<T, VEC> v = tile_at<T, VEC>(tile, r, ln);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = fmaf(to_f(v.v[j]), av[j], bv[j]);
        o.v[j] = from_f<T>(p.act ? silu(t) : t);
      }
      *reinterpret_cast<Pack<T, VEC>*>(dst + (long long)r * p.C) = o;
    }
  }
  if (clustered) cluster_wait();
}

// dz = g * d silu(y) / dy with y = x-hat * scale + bias, or g without the act
__device__ __forceinline__ float gn_dz(float g, float xh, float sc, float bi,
                                       int act) {
  if (!act) return g;
  const float y = fmaf(xh, sc, bi);
  const float s = rcp_approx(1.f + __expf(-y));
  return g * (s * (1.f + y * (1.f - s)));
}

// backward: (sum s1, sum s2) over the statistics launch's chunks for the
// slice's gs groups of image b, in a fixed tree; m1 = s1 / N, m2 = s2 / N
__device__ void merge_chunk_sums(const float2* gpart, int b, int s, int gs,
                                 const Plan& p, float2* fin) {
  const int P = merge_lanes(gs), l = threadIdx.x % P;
  const int per_pass = blockDim.x / P;
  const float inv_n = 1.f / ((float)p.L * (float)(p.C / p.G));
  for (int g0 = 0; g0 < gs; g0 += per_pass) {
    const int g = g0 + threadIdx.x / P;
    float s1 = 0.f, s2 = 0.f;
    if (g < gs) {
      for (int k = l; k < p.parts; k += P) {
        const float2 q =
            gpart[((long long)b * p.parts + k) * p.G + s * gs + g];
        s1 += q.x;
        s2 += q.y;
      }
    }
    for (int o = 1; o < P; o <<= 1) {
      const float t1 = __shfl_down_sync(0xffffffffu, s1, o, P);
      const float t2 = __shfl_down_sync(0xffffffffu, s2, o, P);
      if (l % (2 * o) == 0) {
        s1 += t1;
        s2 += t2;
      }
    }
    if (g < gs && l == 0) fin[g] = make_float2(s1 * inv_n, s2 * inv_n);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(512)
    gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  float* __restrict__ dscale, float* __restrict__ dbias,
                  float2* __restrict__ cpart, float2* __restrict__ gpart,
                  float2* __restrict__ bpart, int* __restrict__ tickets,
                  Plan p, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cgc = p.C / p.G, W = p.width, gs = W / cgc;
  const int blk = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const Lanes ln(W, VEC);
  const int n = rows_of(blk, p), K = ln.count(n);
  const int tile_bytes = align16(p.rows * W * (int)sizeof(T));
  T* tx = reinterpret_cast<T*>(smem);
  T* tg = reinterpret_cast<T*>(smem + tile_bytes);
  float2* gstat = reinterpret_cast<float2*>(smem + 2 * tile_bytes);
  float2* fin = gstat + gs;
  float* red = reinterpret_cast<float*>(fin + gs);   // threads x VEC
  float* red2 = red + blockDim.x * VEC;              // threads x VEC
  float* tmp = red2 + blockDim.x * VEC;              // 2 (threads + W)
  float* cha = tmp + 2 * (blockDim.x + W);           // W
  float* chb = cha + W;                              // W
  const long long off = ((long long)b * p.L + (long long)blk * p.rows) * p.C +
                        (long long)s * W;
  const bool clustered = mode == kCluster && p.parts > 1;

  load_staged<T, VEC>(tx, x + off, tg, gy + off, n, p.C, ln);
  float mu[VEC], rs[VEC], sc[VEC], bi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = s * W + (ln.active ? ln.col * VEC + j : 0);
    const int grp = b * p.G + c / cgc;
    mu[j] = mean[grp];
    rs[j] = rstd[grp];
    sc[j] = scale[c];
    bi[j] = bias[c];
  }

  if (mode == kApply) {
    merge_chunk_sums(gpart, b, s, gs, p, fin);
    if (blk == 0) {   // image b's per-channel sums over the chunks, in order
      for (int c = threadIdx.x; c < W; c += blockDim.x) {
        float t1 = 0.f, t2 = 0.f;
        for (int k = 0; k < p.parts; ++k) {
          const float2 q =
              cpart[((long long)b * p.parts + k) * p.C + s * W + c];
          t1 += q.x;
          t2 += q.y;
        }
        bpart[(long long)b * p.C + s * W + c] = make_float2(t1, t2);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  } else {
    // per-channel sums of dz and dz * x-hat, stage by stage
    float a1[VEC], a2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) a1[j] = a2[j] = 0.f;
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      wait_stage(st);
      for (int k = st * K / kStages; k < (st + 1) * K / kStages; ++k) {
        const Pack<T, VEC> xv = tile_at<T, VEC>(tx, ln.row(k), ln);
        const Pack<T, VEC> gv = tile_at<T, VEC>(tg, ln.row(k), ln);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (to_f(xv.v[j]) - mu[j]) * rs[j];
          const float dz = gn_dz(to_f(gv.v[j]), xh, sc[j], bi[j], p.act);
          a1[j] += dz;
          a2[j] += dz * xh;
        }
      }
    }
    store_lanes<VEC>(a1, red, W, ln);
    store_lanes<VEC>(a2, red2, W, ln);
    // per channel sums of dz and dz x-hat; per group s1 = sum of scale *
    // sum dz, s2 = sum of scale * sum dz x-hat
    block_sums<true>(red, red2, ln.RP, W, cgc, gs, scale + s * W, 1.f, tmp,
                     cha, chb, &gstat[0].x);
    if (mode == kStats) {
      for (int c = threadIdx.x; c < W; c += blockDim.x)
        cpart[((long long)b * p.parts + blk) * p.C + s * W + c] =
            make_float2(cha[c], chb[c]);
      for (int g = threadIdx.x; g < gs; g += blockDim.x)
        gpart[((long long)b * p.parts + blk) * p.G + s * gs + g] = gstat[g];
      return;
    }
    if (clustered) {
      cluster_arrive();
      cluster_wait();
    }
    cg::cluster_group cluster = cg::this_cluster();
    const float inv_n = 1.f / ((float)p.L * (float)cgc);
    for (int g = threadIdx.x; g < gs; g += blockDim.x) {
      float s1 = 0.f, s2 = 0.f;
      for (int r0 = 0; r0 < p.parts; r0 += 4) {   // four ranks in flight
        float2 q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          q[k] = r0 + k >= p.parts ? make_float2(0.f, 0.f)
                 : clustered ? cluster.map_shared_rank(gstat, r0 + k)[g]
                             : gstat[g];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s1 += q[k].x;
          s2 += q[k].y;
        }
      }
      fin[g] = make_float2(s1 * inv_n, s2 * inv_n);
    }
    if (blk == 0) {   // the cluster's per-channel sums, in rank order
      for (int c = threadIdx.x; c < W; c += blockDim.x) {
        float t1 = 0.f, t2 = 0.f;
        for (int r0 = 0; r0 < p.parts; r0 += 4) {
          float q1[4], q2[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool on = r0 + k < p.parts;
            q1[k] = !on ? 0.f
                    : clustered ? cluster.map_shared_rank(cha, r0 + k)[c]
                                : cha[c];
            q2[k] = !on ? 0.f
                    : clustered ? cluster.map_shared_rank(chb, r0 + k)[c]
                                : chb[c];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            t1 += q1[k];
            t2 += q2[k];
          }
        }
        bpart[(long long)b * p.C + s * W + c] = make_float2(t1, t2);
      }
    }
    __syncthreads();
    if (clustered) cluster_arrive();
  }

  // dscale, dbias: the last of the slice's B writers (blocks 0, which wrote
  // their image's per-channel sums above) adds the images' sums in image
  // order, before its own dx
  __shared__ int last;
  if (blk == 0) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&tickets[s], 1) == p.B - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int c = threadIdx.x; c < W; c += blockDim.x) {
        const float2* src = bpart + s * W + c;
        float t1 = 0.f, t2 = 0.f;
        int i = 0;
        for (; i + 8 <= p.B; i += 8) {   // eight loads in flight, in order
          float2 q[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            q[k] = __ldcg(src + (long long)(i + k) * p.C);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            t1 += q[k].x;
            t2 += q[k].y;
          }
        }
        for (; i < p.B; ++i) {
          const float2 q = __ldcg(src + (long long)i * p.C);
          t1 += q.x;
          t2 += q.y;
        }
        dbias[s * W + c] = t1;
        dscale[s * W + c] = t2;
      }
      if (threadIdx.x == 0) tickets[s] = 0;   // ready for the next call
    }
  }

  if (ln.active) {
    float m1[VEC], m2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float2 f = fin[(ln.col * VEC + j) / cgc];
      m1[j] = f.x;
      m2[j] = f.y;
    }
    T* dst = dx + off + ln.col * VEC;
    for (int k = 0; k < K; ++k) {
      const int r = ln.row(k);
      const Pack<T, VEC> xv = tile_at<T, VEC>(tx, r, ln);
      const Pack<T, VEC> gv = tile_at<T, VEC>(tg, r, ln);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (to_f(xv.v[j]) - mu[j]) * rs[j];
        const float dz = gn_dz(to_f(gv.v[j]), xh, sc[j], bi[j], p.act);
        o.v[j] = from_f<T>(rs[j] * (fmaf(dz, sc[j], -m1[j]) - xh * m2[j]));
      }
      *reinterpret_cast<Pack<T, VEC>*>(dst + (long long)r * p.C) = o;
    }
  }
  if (clustered) cluster_wait();
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Plan& p, int threads, int smem, int cluster,
           cudaStream_t st, Args... args) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // clusters above the portable 8 blocks
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, cluster > 8);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.parts, p.C / p.width, p.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the plan's invariants, which the kernels rely on
bool plan_ok(const Plan& p, int threads, int split, int vec, int itemsize) {
  if (p.B < 1 || p.L < 1 || p.G < 1 || p.C % p.G || p.width < 1) return false;
  const int cgc = p.C / p.G;
  if (p.width % cgc || p.C % p.width || p.width % vec) return false;
  if (vec > 1 && (p.width * itemsize) % 16) return false;
  if (threads % 32 || threads > 512 || threads < p.width / vec) return false;
  if (p.rows < 1 || (long long)p.rows * p.parts < p.L) return false;
  if (!split && p.parts > kMaxCluster) return false;
  return p.B <= 65535 && p.C / p.width <= 65535;
}

template <typename T, int VEC>
int fwd(const void* x, const void* scale, const void* bias, void* y,
        void* mean, void* rstd, void* scratch, const Plan& p, int threads,
        int split, float eps, cudaStream_t st) {
  const int gs = p.width / (p.C / p.G);
  const int smem = smem_bytes(1, p.rows, p.width, sizeof(T), gs, threads, VEC);
  auto* k = gn_fwd_kernel<T, VEC>;
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  float2* part = static_cast<float2*>(scratch);
  if (!split)
    return launch(k, p, threads, smem, p.parts, st, xt, sc, bi, yt, mu, rs,
                  part, p, eps, static_cast<int>(kCluster));
  int rc = launch(k, p, threads, smem, 1, st, xt, sc, bi, yt, mu, rs, part, p,
                  eps, static_cast<int>(kStats));
  if (rc) return rc;
  return launch(k, p, threads, smem, 1, st, xt, sc, bi, yt, mu, rs, part, p,
                eps, static_cast<int>(kApply));
}

template <typename T, int VEC>
int bwd(const void* x, const void* gy, const void* scale, const void* bias,
        const void* mean, const void* rstd, void* dx, void* dscale,
        void* dbias, void* scratch, void* tickets, const Plan& p, int threads,
        int split, cudaStream_t st) {
  const int gs = p.width / (p.C / p.G);
  const int smem = smem_bytes(2, p.rows, p.width, sizeof(T), gs, threads, VEC);
  auto* k = gn_bwd_kernel<T, VEC>;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gy);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  T* dxt = static_cast<T*>(dx);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  int* tk = static_cast<int*>(tickets);
  float2* base = static_cast<float2*>(scratch);
  if (!split)
    return launch(k, p, threads, smem, p.parts, st, xt, gt, sc, bi, mu, rs,
                  dxt, ds, db, base, base, base, tk, p,
                  static_cast<int>(kCluster));
  const long long chunks = (long long)p.B * p.parts;
  float2* cpart = base;
  float2* gpart = cpart + chunks * p.C;
  float2* bpart = gpart + chunks * p.G;
  int rc = launch(k, p, threads, smem, 1, st, xt, gt, sc, bi, mu, rs, dxt, ds,
                  db, cpart, gpart, bpart, tk, p, static_cast<int>(kStats));
  if (rc) return rc;
  return launch(k, p, threads, smem, 1, st, xt, gt, sc, bi, mu, rs, dxt, ds,
                db, cpart, gpart, bpart, tk, p, static_cast<int>(kApply));
}

}  // namespace

// x, y: contiguous (B, L, C); scale, bias: fp32 (C,); mean, rstd: fp32
// (B, G). The plan (ops/groupnorm.py::plan): slices of `width` channels,
// `parts` blocks of `rows` rows per (slice, image), `threads` a block;
// split = 0: one launch, `parts` the cluster size; split = 1: two launches,
// `parts` row chunks, scratch holding B * parts * G float2. dtype: 0 = fp32,
// 1 = bf16. vec: 16 / itemsize when C and the pointers allow 16-byte
// access, else 1. Returns the first failing launch's cudaError_t, 1 for a
// plan the kernels do not take, or 0.
extern "C" int dt_group_norm_fwd(const void* x, const void* scale,
                                 const void* bias, void* y, void* mean,
                                 void* rstd, void* scratch, int B, int L,
                                 int C, int G, int width, int parts, int rows,
                                 int threads, int split, float eps, int act,
                                 int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{B, L, C, G, width, parts, rows, act};
  const int itemsize = dtype == 1 ? 2 : 4;
  if (!plan_ok(p, threads, split, vec, itemsize) ||
      (vec != 1 && vec != 16 / itemsize))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return vec == 1
        ? fwd<__nv_bfloat16, 1>(x, scale, bias, y, mean, rstd, scratch, p,
                                threads, split, eps, st)
        : fwd<__nv_bfloat16, 8>(x, scale, bias, y, mean, rstd, scratch, p,
                                threads, split, eps, st);
  return vec == 1 ? fwd<float, 1>(x, scale, bias, y, mean, rstd, scratch, p,
                                  threads, split, eps, st)
                  : fwd<float, 4>(x, scale, bias, y, mean, rstd, scratch, p,
                                  threads, split, eps, st);
}

// x, gy (the cotangent of y), dx: contiguous (B, L, C); scale, bias: fp32
// (C,); mean, rstd: the forward's fp32 (B, G); dscale, dbias: fp32 (C,),
// summed over the batch. The plan as for the forward; scratch holds B * C
// float2 (split = 0) or B * (parts * (C + G) + C) float2 (split = 1);
// tickets: C / width ints, zero, which the kernel leaves zero. dtype and
// vec as for the forward. Returns the first failing launch's cudaError_t,
// 1 for a plan the kernels do not take, or 0.
extern "C" int dt_group_norm_bwd(const void* x, const void* gy,
                                 const void* scale, const void* bias,
                                 const void* mean, const void* rstd, void* dx,
                                 void* dscale, void* dbias, void* scratch,
                                 void* tickets, int B, int L, int C, int G,
                                 int width, int parts, int rows, int threads,
                                 int split, int act, int dtype, int vec,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{B, L, C, G, width, parts, rows, act};
  const int itemsize = dtype == 1 ? 2 : 4;
  if (!plan_ok(p, threads, split, vec, itemsize) ||
      (vec != 1 && vec != 16 / itemsize))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return vec == 1
        ? bwd<__nv_bfloat16, 1>(x, gy, scale, bias, mean, rstd, dx, dscale,
                                dbias, scratch, tickets, p, threads, split, st)
        : bwd<__nv_bfloat16, 8>(x, gy, scale, bias, mean, rstd, dx, dscale,
                                dbias, scratch, tickets, p, threads, split, st);
  return vec == 1
      ? bwd<float, 1>(x, gy, scale, bias, mean, rstd, dx, dscale, dbias,
                      scratch, tickets, p, threads, split, st)
      : bwd<float, 4>(x, gy, scale, bias, mean, rstd, dx, dscale, dbias,
                      scratch, tickets, p, threads, split, st);
}
