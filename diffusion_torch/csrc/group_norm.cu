// GroupNorm(+SiLU) forward for Hopper (sm_90a) over a channels-last
// (B, L, C) slab: fp32 statistics per (image, group), then the affine, then
// an optional SiLU. Writes y in x's dtype (bf16 or fp32) and mean/rstd (B, G)
// in fp32 for the backward.
//
// Replaces the TPU kernel diffusion_tpu/ops/groupnorm.py::_fwd_kernel (the
// pallas_call in `_fwd`). That kernel holds one whole (L, C) image slab in
// VMEM per grid step and takes E[x^2] - E[x]^2 in one pass.
//
// What bounds it on the card: GroupNorm does a handful of flops per element,
// so it is bound by device-memory bytes. At 512px the VAE decoder's last
// slabs (262,144 x 128..256 per image, up to 128 MB in bf16) carry most of
// its bytes; they cannot sit in one block's 227 KB of shared memory, so the
// TPU's one-slab-per-step design does not carry over.
//
// Design: L is split across blocks, three launches.
//  1. partial: block (chunk, b) owns `rows` rows of one image; each thread
//     owns channels and takes a two-pass mean and M2 over its rows (reads are
//     coalesced along C; the second pass mostly hits L1/L2).
//  2. merge: block (g, b) folds the per-(chunk, channel) (n, mean, M2)
//     partials of its group with Chan's parallel formula. No E[x^2]-E[x]^2
//     anywhere, so large-mean inputs keep their precision (the plain version
//     it is held to, like the JAX `_xla_group_norm`, is two-pass too).
//  3. apply: a grid-stride pass that normalizes, applies scale/bias and the
//     SiLU, with 16-byte vector loads and stores when C allows.
// Device-memory traffic is about one read for the statistics, one read and
// one write for the output, plus B * chunks * C * 8 bytes of partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x,
                                  float2* __restrict__ part, int L, int C,
                                  int rows, int n_chunks) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * rows;
  const int n = min(rows, L - r0);
  const T* xb = x + ((long long)b * L + r0) * C;
  float2* pb = part + ((long long)b * n_chunks + chunk) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < n; ++r) s += to_f(xb[(long long)r * C + c]);
    const float mean = s / n;
    float m2 = 0.f;
#pragma unroll 8
    for (int r = 0; r < n; ++r) {
      const float d = to_f(xb[(long long)r * C + c]) - mean;
      m2 += d * d;
    }
    pb[c] = make_float2(mean, m2);
  }
}

// sum over the block; every thread gets the result
__device__ float block_sum(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  __syncthreads();                       // smem free from a previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < n_warps; ++w) t += smem[w];
  return t;
}

__global__ void gn_merge_kernel(const float2* __restrict__ part,
                                float* __restrict__ mean_out,
                                float* __restrict__ rstd_out, int L, int C,
                                int G, int rows, int n_chunks, float eps) {
  __shared__ float smem[32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const int total = n_chunks * cg;
  const float2* pb = part + (long long)b * n_chunks * C + g * cg;
  const float count = (float)L * (float)cg;

  float s = 0.f;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int chunk = i / cg, c = i - chunk * cg;
    const float n = (float)min(rows, L - chunk * rows);
    s += n * pb[(long long)chunk * C + c].x;
  }
  const float mean = block_sum(s, smem) / count;

  float m2 = 0.f;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int chunk = i / cg, c = i - chunk * cg;
    const float n = (float)min(rows, L - chunk * rows);
    const float2 p = pb[(long long)chunk * C + c];
    const float d = p.x - mean;
    m2 += p.y + n * d * d;
  }
  m2 = block_sum(m2, smem);
  if (threadIdx.x == 0) {
    mean_out[b * G + g] = mean;
    rstd_out[b * G + g] = rsqrtf(m2 / count + eps);
  }
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void gn_apply_kernel(const T* __restrict__ x,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                const float* __restrict__ mean,
                                const float* __restrict__ rstd,
                                T* __restrict__ y, long long n_vec, int L,
                                int C, int G, int act) {
  const int cg = C / G;
  const long long per_image = (long long)L * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * VEC;
    const int b = (int)(e / per_image);
    const int c0 = (int)(e % C);
    Pack<T, VEC> in = reinterpret_cast<const Pack<T, VEC>*>(x)[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = c0 + j;
      const int sg = b * G + c / cg;
      float v = (to_f(in.v[j]) - mean[sg]) * rstd[sg] * scale[c] + bias[c];
      if (act) v = v / (1.f + expf(-v));
      out.v[j] = from_f<T>(v);
    }
    reinterpret_cast<Pack<T, VEC>*>(y)[i] = out;
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* mean, void* rstd, void* partials, int B, int L, int C,
           int G, int rows, float eps, int act, int vec, cudaStream_t st) {
  const int n_chunks = (L + rows - 1) / rows;
  const int threads = C < 256 ? (C + 31) / 32 * 32 : 256;
  gn_partial_kernel<T><<<dim3(n_chunks, B), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<float2*>(partials), L, C, rows,
      n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gn_merge_kernel<<<dim3(G, B), 256, 0, st>>>(
      static_cast<const float2*>(partials), static_cast<float*>(mean),
      static_cast<float*>(rstd), L, C, G, rows, n_chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_vec = (long long)B * L * C / vec;
  const long long want = (n_vec + 255) / 256;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    gn_apply_kernel<T, kVec><<<blocks, 256, 0, st>>>(xt, sc, bi, mu, rs, yt,
                                                     n_vec, L, C, G, act);
  } else {
    gn_apply_kernel<T, 1><<<blocks, 256, 0, st>>>(xt, sc, bi, mu, rs, yt,
                                                  n_vec, L, C, G, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous (B, L, C); scale, bias: fp32 (C,); mean, rstd: fp32
// (B, G); partials: fp32 scratch of B * ceil(L / rows) * C * 2 elements.
// dtype: 0 = fp32, 1 = bf16. vec: 16 / sizeof(element) when C and the
// pointers allow 16-byte access, else 1. The wrapper
// (diffusion_torch/ops/groupnorm.py) checks all of it. Returns the first
// failing launch's cudaError_t, or 0.
extern "C" int dt_group_norm_fwd(const void* x, const void* scale,
                                 const void* bias, void* y, void* mean,
                                 void* rstd, void* partials, int B, int L,
                                 int C, int G, int rows, float eps, int act,
                                 int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, partials, B,
                                 L, C, G, rows, eps, act, vec, st);
  return launch<float>(x, scale, bias, y, mean, rstd, partials, B, L, C, G,
                       rows, eps, act, vec, st);
}
