// AdamW, and the EMA of the weights where the step has one, in one pass
// over every parameter, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves the update to optax,
// which XLA fuses into a few passes. On the card the same update as
// PyTorch's foreach operators makes some twenty passes over the
// parameters, each a multi-tensor kernel that reads and writes whole
// parameter-sized tensors (about 160 bytes a parameter, 180 with the EMA),
// and holds two parameter-sized temporaries. The update is a few flops an
// element, so the bytes bound it: the only gain is to move fewer. This
// kernel reads g, p, mu and nu (and e) once and writes p, mu and nu (and e)
// once: 28 bytes a parameter (24 with a bf16 mu), 36 with the EMA.
//
// The arithmetic is diffusion_torch/ops/adamw.py::adamw_reference's as
// PyTorch's foreach operators compute it on the card, in its order, every
// product, sum, quotient and root rounded on its own (the __f*_rn
// intrinsics, which nvcc never contracts) but where those operators round
// otherwise: a division by a scalar is a product with the scalar's fp32
// reciprocal, and the EMA's add_(alpha=) is one fused multiply-add.
//   g  <- g / ||g|| * c                  where a norm is given and ||g|| >= c
//   nu <- nu * b2 + (g * g) * (1 - b2)
//   mu <- mu * b1 + g * (1 - b1)         (bf16 mu: mu * b1 rounded to bf16,
//                                         with b1 rounded to bf16 by the
//                                         caller, the sum in fp32, then mu
//                                         stored as bf16)
//   u  <- (mu * (1 / bc1)) / (sqrt(nu * (1 / bc2)) + eps)
//   p  <- p + (u + p * wd) * (-lr)
//   e  <- fma(p, 1 - s, e * s)           on the updated p, where e is given
// The update uses the fp32 mu before it is stored. g is only read.
//
// The design, for a pass bound by bytes:
//  * One launch over up to kMaxTensors tensors: their pointers, sizes and
//    chunk offsets are the kernel's parameters (Hopper takes 32 KB of
//    them), so nothing is uploaded before a launch and nothing is cached.
//    The caller splits longer lists over a few launches
//    (diffusion_torch/ops/adamw.py::plan).
//  * Work: fixed chunks of kChunk elements (a tensor's last chunk may be
//    shorter); `first_chunk` numbers them across the launch's tensors. A
//    grid that fills the SMs takes them in contiguous runs, one run a block,
//    so a block finds its first tensor by one binary search and walks on.
//  * Loads and stores: 16 bytes a thread (8 for a bf16 mu) where every
//    pointer of the tensor allows, scalar otherwise and for the tail of a
//    chunk. A thread keeps its four or five loads in flight at once, and
//    several blocks an SM keep the card's memory busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxTensors = 512;
constexpr int kChunk = 16384;
constexpr int kThreads = 256;

struct AdamwArgs {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* mu[kMaxTensors];
  float* nu[kMaxTensors];
  float* e[kMaxTensors];
  long long n[kMaxTensors];
  int first_chunk[kMaxTensors + 1];
  int count;
  const float* grad_norm;  // device fp32 scalar; null: no clipping
  float clip, b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd,
      neg_lr, s, one_minus_s;
};
static_assert(sizeof(AdamwArgs) <= 32764, "kernel parameters over 32 KB");

__device__ __forceinline__ float mu_times_b1(float m, float b1, float) {
  return __fmul_rn(m, b1);
}
__device__ __forceinline__ float mu_times_b1(float m, float b1,
                                             __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(m, b1)));
}

// One element: p, mu, nu (and e) in and out, in fp32.
template <typename MuT, bool kEma>
__device__ __forceinline__ void update(const AdamwArgs& a, bool clip,
                                       float norm, float& p, float g,
                                       float& m, float& v, float& e) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), a.clip);
  v = __fadd_rn(__fmul_rn(v, a.b2),
                __fmul_rn(__fmul_rn(g, g), a.one_minus_b2));
  m = __fadd_rn(mu_times_b1(m, a.b1, MuT()), __fmul_rn(g, a.one_minus_b1));
  float u = __fmul_rn(m, a.inv_bc1);
  const float d = __fadd_rn(__fsqrt_rn(__fmul_rn(v, a.inv_bc2)), a.eps);
  u = __fdiv_rn(u, d);
  u = __fmul_rn(__fadd_rn(u, __fmul_rn(p, a.wd)), a.neg_lr);
  p = __fadd_rn(p, u);
  if (kEma) e = __fmaf_rn(p, a.one_minus_s, __fmul_rn(e, a.s));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src,
                                      float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  __nv_bfloat16 h[4];
  memcpy(h, &raw, sizeof(raw));
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(h[k]);
}
__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&v)[4]) {
  __nv_bfloat16 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __float2bfloat16_rn(v[k]);
  uint2 raw;
  memcpy(&raw, h, sizeof(raw));
  *reinterpret_cast<uint2*>(dst) = raw;
}

__device__ __forceinline__ bool aligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

template <typename MuT, bool kEma>
__global__ void __launch_bounds__(kThreads)
    adamw_ema_foreach_kernel(const __grid_constant__ AdamwArgs a) {
  const int total = a.first_chunk[a.count];
  const int lo = static_cast<int>((long long)blockIdx.x * total / gridDim.x);
  const int hi =
      static_cast<int>((long long)(blockIdx.x + 1) * total / gridDim.x);
  if (lo >= hi) return;
  bool clip = false;
  float norm = 1.0f;
  if (a.grad_norm != nullptr) {
    norm = *a.grad_norm;
    clip = norm >= a.clip;  // false for a NaN norm, as the plain version
  }
  // the tensor of chunk lo: the last t with first_chunk[t] <= lo
  int t = 0, top = a.count;
  while (top - t > 1) {
    const int mid = (t + top) >> 1;
    if (a.first_chunk[mid] <= lo) t = mid; else top = mid;
  }
  for (int c = lo; c < hi; ++c) {
    while (a.first_chunk[t + 1] <= c) ++t;  // past the tensor's last chunk
    const long long start = (long long)(c - a.first_chunk[t]) * kChunk;
    const int len = static_cast<int>(
        a.n[t] - start < kChunk ? a.n[t] - start : kChunk);
    float* p = a.p[t] + start;
    const float* g = a.g[t] + start;
    MuT* mu = static_cast<MuT*>(a.mu[t]) + start;
    float* nu = a.nu[t] + start;
    float* e = kEma ? a.e[t] + start : nullptr;
    int done = 0;
    if (aligned(p, 16) && aligned(g, 16) && aligned(nu, 16) &&
        aligned(mu, 4 * sizeof(MuT)) && (!kEma || aligned(e, 16))) {
      const int n4 = len >> 2;
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const int j = i << 2;
        float pv[4], gv[4], mv[4], vv[4], ev[4];
        load4(p + j, pv);
        load4(g + j, gv);
        load4(mu + j, mv);
        load4(nu + j, vv);
        if (kEma) load4(e + j, ev);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          update<MuT, kEma>(a, clip, norm, pv[k], gv[k], mv[k], vv[k], ev[k]);
        store4(p + j, pv);
        store4(mu + j, mv);
        store4(nu + j, vv);
        if (kEma) store4(e + j, ev);
      }
      done = n4 << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) {
      float pi = p[i], mi = to_float(mu[i]), vi = nu[i];
      float ei = kEma ? e[i] : 0.0f;
      update<MuT, kEma>(a, clip, norm, pi, g[i], mi, vi, ei);
      p[i] = pi;
      store(mu + i, mi);
      nu[i] = vi;
      if (kEma) e[i] = ei;
    }
  }
}

template <typename MuT, bool kEma>
int launch(const AdamwArgs& a, cudaStream_t stream) {
  static int grid_max = 0;  // blocks resident on the whole card at once
  if (grid_max == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_ema_foreach_kernel<MuT, kEma>, kThreads, 0);
    grid_max = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int total = a.first_chunk[a.count];
  const int grid = total < grid_max ? total : grid_max;
  adamw_ema_foreach_kernel<MuT, kEma><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over `count` (1 .. 512) tensors. ptrs: a host array of
// device pointers, list by list: p, g, mu, nu, and e with has_ema (5 *
// count pointers, else 4 * count). numels: count sizes; first_chunk: count + 1
// chunk offsets, first_chunk[t + 1] - first_chunk[t] = ceil(numels[t] /
// 16384), first_chunk[0] = 0. All fp32 and contiguous but mu, which is
// bf16 where mu_bf16. grad_norm: a device fp32 scalar, or null for no
// clipping. The scalars are fp32, as the plain version's foreach operators
// round them; inv_bc1 and inv_bc2 the fp32 reciprocals 1 / bc. Returns the launch's cudaError_t, or cudaErrorInvalidValue
// for a count or offsets the kernel does not take.
extern "C" int dt_adamw_ema_foreach(
    const void* ptrs, const void* numels, const void* first_chunk, int count,
    int mu_bf16, int has_ema, const void* grad_norm, float clip, float b1,
    float one_minus_b1, float b2, float one_minus_b2, float inv_bc1,
    float inv_bc2, float eps, float wd, float neg_lr, float s,
    float one_minus_s,
    void* stream) {
  if (count < 1 || count > kMaxTensors)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ptr = static_cast<void* const*>(ptrs);
  const auto* first = static_cast<const int*>(first_chunk);
  if (first[0] != 0 || first[count] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamwArgs a;
  for (int t = 0; t < count; ++t) {
    a.p[t] = static_cast<float*>(ptr[t]);
    a.g[t] = static_cast<const float*>(ptr[count + t]);
    a.mu[t] = ptr[2 * count + t];
    a.nu[t] = static_cast<float*>(ptr[3 * count + t]);
    a.e[t] = has_ema ? static_cast<float*>(ptr[4 * count + t]) : nullptr;
  }
  memcpy(a.n, numels, count * sizeof(long long));
  memcpy(a.first_chunk, first, (count + 1) * sizeof(int));
  a.count = count;
  a.grad_norm = static_cast<const float*>(grad_norm);
  a.clip = clip, a.b1 = b1, a.one_minus_b1 = one_minus_b1, a.b2 = b2;
  a.one_minus_b2 = one_minus_b2, a.inv_bc1 = inv_bc1, a.inv_bc2 = inv_bc2;
  a.eps = eps;
  a.wd = wd, a.neg_lr = neg_lr, a.s = s, a.one_minus_s = one_minus_s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mu_bf16)
    return has_ema ? launch<__nv_bfloat16, true>(a, st)
                   : launch<__nv_bfloat16, false>(a, st);
  return has_ema ? launch<float, true>(a, st) : launch<float, false>(a, st);
}
