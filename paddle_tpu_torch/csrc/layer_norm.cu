// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused.py `_ln_kernel` (launched by
// `pl.pallas_call` in `_fused_ln_fwd_impl`). Same math: per row,
//   y = (x - mean) * rsqrt(var + eps) * w + b,
// mean and var two-pass in f32, y rounded once to x's dtype.
//
// What bounds it on this card: bytes. Each element is read once and
// written once and costs ~8 flops, far below the H100's ~295
// flops/byte ridge, so the least time is (2 * rows * hidden + 2 * hidden)
// * sizeof(T) / 3.35 TB/s. On the serving path the rows are 1-8 (decode)
// or one prefill chunk, so most launches are latency-bound instead.
//
// Two kernels; ops/fused.py `_ln_plan` picks one from the shape before the
// launch (variant 0 or 1 of the C entry):
//  0. `ln_fwd_warp_kernel`, the one the models run: a warp per row, 8 rows
//     to a block (fewer rows, one smaller block: decode's 1-8 rows are one
//     block). The row goes from 16-byte loads into registers
//     (layer_norm_common.cuh) and stays there: both statistics by warp
//     shuffles alone, no shared memory, no barrier; gamma and beta are read
//     once per warp as vectors and y is written as vectors. What it does
//     about the bound: every load is a full 512-byte warp segment, and each
//     warp keeps its whole row (2 KB at hidden 1024 bf16) in flight at once
//     with no block-wide barrier between the load and the store. It takes
//     a hidden that is a multiple of the vector up to 2048 with every
//     pointer 16-byte aligned.
//  1. `ln_fwd_kernel`, for every other call (a ragged hidden, a misaligned
//     view, a wider row): one block per row, the row staged once as f32 in
//     shared memory, block reductions; hidden bounded by shared memory
//     (~58k values after the opt-in below).
#include "layer_norm_common.cuh"

namespace {

using namespace ptt_ln;

template <typename T, int E>
__global__ void __launch_bounds__(256)
ln_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ y, int rows,
                   int hidden, float eps) {
  constexpr int N = kVec<T>;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: no barrier follows
  const int nvec = hidden / N;
  uint4 v[E / N];
  load_row<T, E>(x + row * hidden, nvec, lane, v);
  const float2 st = row_stats<T, E>([&](int i) { return v[i]; }, nvec, lane,
                                    hidden, eps);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* yv = reinterpret_cast<uint4*>(y + row * hidden);
#pragma unroll
  for (int i = 0; i < E / N; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      float xf[N], wf[N], bf[N];
      unpack<T>(v[i], xf);
      unpack<T>(wv[j], wf);
      unpack<T>(bv[j], bf);
#pragma unroll
      for (int k = 0; k < N; ++k)
        xf[k] = (xf[k] - st.x) * st.y * wf[k] + bf[k];
      yv[j] = pack<T>(xf);
    }
  }
}

// Sum over the block; every thread gets the result. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(v);
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
cudaError_t launch_warp(const void* x, const void* w, const void* b, void* y,
                        int rows, int hidden, int rows_per_block, int grid,
                        float eps, cudaStream_t stream) {
  const void* ptrs[] = {x, w, b, y};
  if (!rows_aligned<T>(hidden, ptrs, 4) ||
      (long long)grid * rows_per_block < rows)
    return cudaErrorInvalidValue;
  return with_lane_values(hidden, [&](auto e) {
    ln_fwd_warp_kernel<T, decltype(e)::value>
        <<<grid, 32 * rows_per_block, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(w),
            static_cast<const T*>(b), static_cast<T*>(y), rows, hidden, eps);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_block(const void* x, const void* w, const void* b,
                         void* y, int rows, int hidden, float eps,
                         cudaStream_t stream) {
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

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int rows, int hidden, int rows_per_block, int grid,
                   float eps, int variant, cudaStream_t stream) {
  if (variant == 0)
    return launch_warp<T>(x, w, b, y, rows, hidden, rows_per_block, grid,
                          eps, stream);
  if (variant == 1 && rows_per_block == 1 && grid == rows)
    return launch_block<T>(x, w, b, y, rows, hidden, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 = a warp per row (`rows_per_block` warps to a block, `grid`
// blocks), 1 = a block per row (rows_per_block 1, grid = rows), as
// ops/fused.py `_ln_plan` gives them. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. Returns a cudaError_t (0 = launched).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w,
                                  const void* b, void* y, int rows,
                                  int hidden, int rows_per_block, int grid,
                                  float eps, int dtype, int variant,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0 || rows_per_block <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, w, b, y, rows, hidden, rows_per_block,
                              grid, eps, variant, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, b, y, rows, hidden,
                                      rows_per_block, grid, eps, variant, s);
  if (dtype == 2)
    return (int)launch<__half>(x, w, b, y, rows, hidden, rows_per_block,
                               grid, eps, variant, s);
  return (int)cudaErrorInvalidValue;
}
