// The bf16 working copy of the trained weights, for Hopper (sm_90a): one
// pass that casts every trained fp32 weight into its bf16 copy, and one
// that adds a bf16 weight gradient into the fp32 gradient.
//
// They replace no TPU kernel: the JAX package casts its fp32 parameters
// to the compute dtype inside the jitted step, where XLA fuses the cast
// into its consumers and the transpose's sum into the gradient. In
// PyTorch a per-call `p.to(bf16)` is three passes over the weights for
// every microbatch: the forward's cast, the backward's cast of the bf16
// gradient back to fp32 (ToCopyBackward, 6 bytes a value) and
// AccumulateGrad's add into `.grad` (12 bytes a value). Here a training
// step casts each weight once (diffusion_torch/ops/working_copy.py), and
// each microbatch's gradient reaches `.grad` in one pass: 6 bytes a value
// where `.grad` is new, 10 where it adds.
//
// Rounding is PyTorch's, so the numbers do not move:
//  * the copy: __float2bfloat16_rn, the conversion c10::BFloat16 makes on
//    sm_80 and later, so the copy equals `p.to(torch.bfloat16)` bit for
//    bit (NaN included);
//  * the gradient: float(g) is exact, and `grad + float(g)` is one fp32
//    addition rounded to nearest (__fadd_rn), which is AccumulateGrad's
//    `grad += g.float()`.
//
// The design, for passes bound by bytes:
//  * The copy is a multi-tensor launch over up to kMaxTensors weights,
//    their pointers, sizes and chunk offsets passed as kernel parameters,
//    chunked as csrc/adamw.cu's pass is (the same plan, ops/adamw.py::plan).
//    8 values a thread: two 16-byte loads, one 16-byte store. A kh x kw
//    convolution's weight (kh * kw > 1) is copied in channels_last order,
//    the order cuDNN takes it in beside channels_last activations (a
//    contiguous one it would re-lay out on every call, forward and
//    backward): a launch per weight, moved through shared memory.
//  * The gradient's pass is one launch per tensor, made from the autograd
//    backward as each gradient appears. A gradient laid out as `.grad` is
//    (contiguous) is read flat, 8 values a thread. A 4-D gradient that
//    cuDNN gives in channels_last order, (O, kh, kw, I) in memory against
//    `.grad`'s (O, I, kh, kw), is moved through shared memory: a block
//    reads `taps` (kh * kw, up to 16) rows of kTile channels of one output
//    channel, coalesced along I, and writes the kTile * taps values of
//    `.grad` they make, coalesced along its contiguous run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxTensors = 512;
constexpr int kChunk = 16384;
constexpr int kThreads = 256;
constexpr int kTile = 256;      // channels of one output channel a block moves
constexpr int kMaxTaps = 16;    // kh * kw of the kernels the tiled pass takes

struct RefreshArgs {
  const float* src[kMaxTensors];
  __nv_bfloat16* dst[kMaxTensors];
  long long n[kMaxTensors];
  int first_chunk[kMaxTensors + 1];
  int count;
};
static_assert(sizeof(RefreshArgs) <= 32764, "kernel parameters over 32 KB");

__device__ __forceinline__ bool aligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat16 a = __float2bfloat16_rn(lo);
  const __nv_bfloat16 b = __float2bfloat16_rn(hi);
  uint16_t ua, ub;
  memcpy(&ua, &a, 2);
  memcpy(&ub, &b, 2);
  return static_cast<uint32_t>(ua) | (static_cast<uint32_t>(ub) << 16);
}

__global__ void __launch_bounds__(kThreads)
    working_copy_refresh_kernel(const __grid_constant__ RefreshArgs a) {
  const int total = a.first_chunk[a.count];
  const int lo = static_cast<int>((long long)blockIdx.x * total / gridDim.x);
  const int hi =
      static_cast<int>((long long)(blockIdx.x + 1) * total / gridDim.x);
  if (lo >= hi) return;
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
    const float* src = a.src[t] + start;
    __nv_bfloat16* dst = a.dst[t] + start;
    int done = 0;
    if (aligned(src, 16) && aligned(dst, 16)) {
      const int n8 = len >> 3;
      for (int i = threadIdx.x; i < n8; i += kThreads) {
        const float4 x = reinterpret_cast<const float4*>(src)[2 * i];
        const float4 y = reinterpret_cast<const float4*>(src)[2 * i + 1];
        reinterpret_cast<uint4*>(dst)[i] =
            make_uint4(pack(x.x, x.y), pack(x.z, x.w), pack(y.x, y.y),
                       pack(y.z, y.w));
      }
      done = n8 << 3;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads)
      dst[i] = __float2bfloat16_rn(src[i]);
  }
}

// src (rows, cols, taps) fp32 -> dst (rows, taps, cols) bf16: a conv
// weight (O, I, kh, kw) into its channels_last copy. Block (x, y) moves
// channels [x * kTile, x * kTile + kTile) of output channel y: it reads
// their kTile * taps values, one contiguous run, and writes `taps` runs of
// kTile bf16.
__global__ void __launch_bounds__(kThreads)
    working_copy_refresh_tiled_kernel(const float* __restrict__ src,
                                      __nv_bfloat16* __restrict__ dst,
                                      long long cols, int taps) {
  constexpr int kPitch = kTile + 1;
  __shared__ float tile[kMaxTaps * kPitch];
  const long long row = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * kTile;
  const int width = static_cast<int>(cols - c0 < kTile ? cols - c0 : kTile);
  const float* in = src + (row * cols + c0) * taps;
  for (int j = threadIdx.x; j < width * taps; j += kThreads) {
    const int c = j / taps;
    tile[(j - c * taps) * kPitch + c] = in[j];
  }
  __syncthreads();
  __nv_bfloat16* out = dst + row * taps * cols + c0;
  if ((width & 1) == 0 && (cols & 1) == 0 && aligned(dst, 4)) {
    const int pairs = width >> 1;  // two bf16 a thread: a warp writes 128 B
    for (int j = threadIdx.x; j < taps * pairs; j += kThreads) {
      const int k = j / pairs, c = (j - k * pairs) << 1;
      *reinterpret_cast<uint32_t*>(out + (long long)k * cols + c) =
          pack(tile[k * kPitch + c], tile[k * kPitch + c + 1]);
    }
    return;
  }
  for (int j = threadIdx.x; j < taps * width; j += kThreads) {
    const int k = j / width, c = j - k * width;
    out[(long long)k * cols + c] = __float2bfloat16_rn(tile[k * kPitch + c]);
  }
}

__device__ __forceinline__ void widen(uint32_t two, float& lo, float& hi) {
  lo = __uint_as_float(two << 16);
  hi = __uint_as_float(two & 0xffff0000u);
}

// dst[i] (+)= float(src[i]) over n values, both in the same order.
template <bool kAdd>
__global__ void __launch_bounds__(kThreads)
    grad_accumulate_kernel(const __nv_bfloat16* __restrict__ src,
                           float* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (aligned(src, 16) && aligned(dst, 16)) {
    const long long n8 = n >> 3;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < n8; i += stride) {
      const uint4 g = reinterpret_cast<const uint4*>(src)[i];
      float v[8];
      widen(g.x, v[0], v[1]);
      widen(g.y, v[2], v[3]);
      widen(g.z, v[4], v[5]);
      widen(g.w, v[6], v[7]);
      float4* out = reinterpret_cast<float4*>(dst) + 2 * i;
      if (kAdd) {
        const float4 x = out[0], y = out[1];
        v[0] = __fadd_rn(x.x, v[0]), v[1] = __fadd_rn(x.y, v[1]);
        v[2] = __fadd_rn(x.z, v[2]), v[3] = __fadd_rn(x.w, v[3]);
        v[4] = __fadd_rn(y.x, v[4]), v[5] = __fadd_rn(y.y, v[5]);
        v[6] = __fadd_rn(y.z, v[6]), v[7] = __fadd_rn(y.w, v[7]);
      }
      out[0] = make_float4(v[0], v[1], v[2], v[3]);
      out[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    done = n8 << 3;
  }
  for (long long i = done + (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float g = __bfloat162float(src[i]);
    dst[i] = kAdd ? __fadd_rn(dst[i], g) : g;
  }
}

// src (rows, taps, cols) -> dst (rows, cols, taps), (+)=: block (x, y)
// moves channels [x * kTile, x * kTile + kTile) of output channel y. Reads
// go two bf16 a thread along a tap's channels (a warp reads 128 bytes);
// writes four floats a thread along dst's contiguous run.
template <bool kAdd>
__global__ void __launch_bounds__(kThreads)
    grad_accumulate_tiled_kernel(const __nv_bfloat16* __restrict__ src,
                                 float* __restrict__ dst, long long cols,
                                 int taps) {
  constexpr int kPitch = kTile + 1;
  __shared__ float tile[kMaxTaps * kPitch];
  const long long row = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * kTile;
  const int width = static_cast<int>(cols - c0 < kTile ? cols - c0 : kTile);
  const __nv_bfloat16* in = src + row * taps * cols + c0;
  if ((width & 1) == 0 && (cols & 1) == 0 && aligned(src, 4)) {
    const int pairs = width >> 1;
    for (int j = threadIdx.x; j < taps * pairs; j += kThreads) {
      const int k = j / pairs, c = (j - k * pairs) << 1;
      const uint32_t two =
          *reinterpret_cast<const uint32_t*>(in + (long long)k * cols + c);
      widen(two, tile[k * kPitch + c], tile[k * kPitch + c + 1]);
    }
  } else {
    for (int j = threadIdx.x; j < taps * width; j += kThreads) {
      const int k = j / width, c = j - k * width;
      tile[k * kPitch + c] = __bfloat162float(in[(long long)k * cols + c]);
    }
  }
  __syncthreads();
  float* out = dst + (row * cols + c0) * taps;
  const int total = width * taps;
  int done = 0;
  if ((total & 3) == 0 && aligned(out, 16)) {
    for (int q = threadIdx.x; q < (total >> 2); q += kThreads) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e, c = j / taps;
        v[e] = tile[(j - c * taps) * kPitch + c];
      }
      float4* o = reinterpret_cast<float4*>(out) + q;
      if (kAdd) {
        const float4 x = *o;
        v[0] = __fadd_rn(x.x, v[0]), v[1] = __fadd_rn(x.y, v[1]);
        v[2] = __fadd_rn(x.z, v[2]), v[3] = __fadd_rn(x.w, v[3]);
      }
      *o = make_float4(v[0], v[1], v[2], v[3]);
    }
    done = total;
  }
  for (int j = done + threadIdx.x; j < total; j += kThreads) {
    const int c = j / taps;
    const float g = tile[(j - c * taps) * kPitch + c];
    out[j] = kAdd ? __fadd_rn(out[j], g) : g;
  }
}

int grid_for(long long blocks) {
  static int grid_max = 0;  // blocks resident on the whole card at once
  if (grid_max == 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    grid_max = sms * (2048 / kThreads);
  }
  return static_cast<int>(blocks < grid_max ? blocks : grid_max);
}

}  // namespace

// One launch over `count` (1 .. 512) weights. ptrs: a host array of 2 *
// count device pointers: the fp32 weights, then their bf16 copies, each
// contiguous. numels and first_chunk as dt_adamw_ema_foreach takes them
// (first_chunk[t + 1] - first_chunk[t] = ceil(numels[t] / 16384)). Returns
// the launch's cudaError_t, or cudaErrorInvalidValue for a count or
// offsets the kernel does not take.
extern "C" int dt_working_copy_refresh(const void* ptrs, const void* numels,
                                       const void* first_chunk, int count,
                                       void* stream) {
  if (count < 1 || count > kMaxTensors)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ptr = static_cast<void* const*>(ptrs);
  const auto* first = static_cast<const int*>(first_chunk);
  if (first[0] != 0 || first[count] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RefreshArgs a;
  for (int t = 0; t < count; ++t) {
    a.src[t] = static_cast<const float*>(ptr[t]);
    a.dst[t] = static_cast<__nv_bfloat16*>(ptr[count + t]);
  }
  memcpy(a.n, numels, count * sizeof(long long));
  memcpy(a.first_chunk, first, (count + 1) * sizeof(int));
  a.count = count;
  working_copy_refresh_kernel<<<grid_for(first[count]), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dst (bf16, (rows, taps, cols)) = src (fp32, (rows, cols, taps)) rounded:
// a (O, I, kh, kw) weight's channels_last copy, taps = kh * kw (2 .. 16).
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for sizes it
// does not take.
extern "C" int dt_working_copy_refresh_tiled(const void* src, void* dst,
                                             long long rows, long long cols,
                                             int taps, void* stream) {
  if (rows < 1 || rows > 65535 || cols < 1 || taps < 2 || taps > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((cols + kTile - 1) / kTile),
                  static_cast<unsigned>(rows));
  working_copy_refresh_tiled_kernel<<<grid, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), cols,
      taps);
  return static_cast<int>(cudaGetLastError());
}

// dst (fp32) = float(src) (add = 0) or dst += float(src) (add = 1), src a
// bf16 gradient. taps = 1: both hold rows * cols values in the same order.
// taps > 1 (up to 16): src holds (rows, taps, cols) and dst (rows, cols,
// taps), contiguous: a (O, I, kh, kw) gradient in channels_last order
// against a contiguous one, taps = kh * kw. Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for sizes it does not take.
extern "C" int dt_grad_accumulate(const void* src, void* dst, long long rows,
                                  long long cols, int taps, int add,
                                  void* stream) {
  if (rows < 1 || cols < 1 || taps < 1 || taps > kMaxTaps || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* g = static_cast<const __nv_bfloat16*>(src);
  auto* out = static_cast<float*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (taps == 1) {
    const long long n = rows * cols;
    const int grid = grid_for((n + 8LL * kThreads - 1) / (8LL * kThreads));
    if (add)
      grad_accumulate_kernel<true><<<grid, kThreads, 0, st>>>(g, out, n);
    else
      grad_accumulate_kernel<false><<<grid, kThreads, 0, st>>>(g, out, n);
  } else {
    const dim3 grid(static_cast<unsigned>((cols + kTile - 1) / kTile),
                    static_cast<unsigned>(rows));
    if (add)
      grad_accumulate_tiled_kernel<true><<<grid, kThreads, 0, st>>>(
          g, out, cols, taps);
    else
      grad_accumulate_tiled_kernel<false><<<grid, kThreads, 0, st>>>(
          g, out, cols, taps);
  }
  return static_cast<int>(cudaGetLastError());
}
