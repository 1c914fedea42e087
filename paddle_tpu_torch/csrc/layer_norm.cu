// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused.py `_ln_kernel` (launched by
// `pl.pallas_call` in `_fused_ln_fwd_impl`). Same math: per row,
//   y = (x - mean) * rsqrt(var + eps) * w + b,
// mean and var two-pass in f32, y cast back to x's dtype.
//
// What bounds it on this card: bytes. Each element is read once and
// written once and costs ~8 flops, far below the H100's ~295
// flops/byte ridge, so the least time is (2 * rows * hidden + 2 * hidden)
// * sizeof(T) / 3.35 TB/s. On the serving path the rows are 1-8 (decode)
// or one prefill chunk, so most launches are latency-bound instead.
//
// Design: one block per row. The row is read from device memory ONCE
// into shared memory (as f32), both statistics and the output are
// computed from that copy, so device traffic is exactly one read and one
// write per element. Reductions are warp shuffles plus one word per warp
// in shared memory. Any row count works (the TPU kernel's
// `rows % 256 == 0 and hidden % 128 == 0` gate is gone); hidden is bounded
// only by shared memory (up to ~58k f32 values after the opt-in below).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Sum over the block; every thread gets the result. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ w,
                              const T* __restrict__ b, T* __restrict__ y,
                              int hidden, float eps) {
  extern __shared__ float smem[];
  float* red = smem;        // 32 floats for the block reductions
  float* row = smem + 32;   // the row, as f32
  const long long base = (long long)blockIdx.x * hidden;
  float s = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float v = to_f32(x[base + i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / hidden;
  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float d = row[i] - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, red) / hidden;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    y[base + i] = from_f32<T>((row[i] - mean) * rstd * to_f32(w[i])
                              + to_f32(b[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int rows, int hidden, float eps, cudaStream_t stream) {
  int threads = (hidden + 3) / 4;  // ~4 elements per thread
  threads = ((threads + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (32 + (size_t)hidden) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_fwd_kernel<T><<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), hidden, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w,
                                  const void* b, void* y, int rows,
                                  int hidden, float eps, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(x, w, b, y, rows, hidden, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, b, y, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}
