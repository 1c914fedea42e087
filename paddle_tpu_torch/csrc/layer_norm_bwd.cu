// LayerNorm backward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused.py `_ln_bwd_kernel` (launched by
// `pl.pallas_call` in `_fused_ln_bwd`). Same math, all in f32: per row,
// recompute mean and rstd (two-pass, as the forward), x^ = (x - mean) * rstd,
//   dx = rstd * (g*w - mean(g*w) - x^ * mean(g*w*x^)),
// and over all rows dw = sum(g * x^), db = sum(g). dx is cast to x's dtype,
// dw/db to the weight's.
//
// What bounds it on this card: bytes. x and g are read once and dx written
// once (3 * rows * hidden elements) for ~15 flops per element, far below
// the ~295 flops/byte ridge: at [8192, 1024] bf16 the least time is
// 50 MB / 3.35 TB/s = 15 us.
//
// Design. Mean and rstd are reduced in the forward kernel's order (same
// thread layout), so they equal the forward's. The TPU kernel carries
// dw/db in one VMEM block across a grid that runs in order. CUDA blocks
// run concurrently, so the sums over rows are split in two launches, with
// no float atomics and a fixed order:
//  1. `ln_bwd_rows_kernel`: block i owns rows [i*rpb, (i+1)*rpb). For each
//     row it reads x and g once into shared memory (as f32), reduces the
//     statistics and the two means with warp shuffles, writes dx, and adds
//     g*x^ and g into per-column f32 sums in shared memory (each thread
//     owns the columns tid, tid + blockDim, ...; no other thread touches
//     them, so no barrier guards them). The block writes its sums as row i
//     of f32 partials [nblocks, hidden].
//  2. `ln_bwd_reduce_kernel`: sums the partials per column in a fixed
//     order (8 stripes of partials, one per warp row, then the 8 stripe
//     sums in order), so the result does not depend on block scheduling.
// Any row count works (ragged tails included); hidden is bounded by
// shared memory (4 * hidden floats: up to ~14k columns after the opt-in).
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
  return __float2bfloat16(v);
}

// Sums of (a, b) over the block; every thread gets both. `red` holds 64.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = lane < nwarps ? red[lane] : 0.f;
  b = lane < nwarps ? red[32 + lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

template <typename T>
__global__ void ln_bwd_rows_kernel(const T* __restrict__ x,
                                   const T* __restrict__ w,
                                   const T* __restrict__ g,
                                   T* __restrict__ dx,
                                   float* __restrict__ dw_part,
                                   float* __restrict__ db_part, int rows,
                                   int hidden, int rows_per_block,
                                   float eps) {
  extern __shared__ float smem[];
  float* red = smem;           // 64 floats for the block reductions
  float* xs = red + 64;        // the row's x, then x^
  float* gs = xs + hidden;     // the row's g
  float* dwa = gs + hidden;    // this block's sum of g * x^ per column
  float* dba = dwa + hidden;   // this block's sum of g per column
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    dwa[i] = 0.f;
    dba[i] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const long long base = (long long)r * hidden;
    float s = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float v = to_f32(x[base + i]);
      xs[i] = v;
      gs[i] = to_f32(g[base + i]);
      s += v;
    }
    const float mean = block_sum2(s, 0.f, red).x / hidden;
    float ss = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float d = xs[i] - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(block_sum2(ss, 0.f, red).x / hidden + eps);
    float a = 0.f, b = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float xh = (xs[i] - mean) * rstd;
      const float gv = gs[i];
      const float gw = gv * to_f32(w[i]);
      xs[i] = xh;
      a += gw;
      b += gw * xh;
      dwa[i] += gv * xh;
      dba[i] += gv;
    }
    const float2 m = block_sum2(a, b, red);
    const float m1 = m.x / hidden, m2 = m.y / hidden;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float gw = gs[i] * to_f32(w[i]);
      dx[base + i] = from_f32<T>(rstd * (gw - m1 - xs[i] * m2));
    }
  }
  const long long out = (long long)blockIdx.x * hidden;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    dw_part[out + i] = dwa[i];
    db_part[out + i] = dba[i];
  }
}

// blockDim (32, 8): threadIdx.x is the column within a 32-column strip,
// threadIdx.y the stripe of partials (p = y, y + 8, ...) it sums.
template <typename T>
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ dw_part,
                                     const float* __restrict__ db_part,
                                     int nparts, int hidden,
                                     T* __restrict__ dw, T* __restrict__ db) {
  __shared__ float sw[8][33], sb[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (col < hidden) {
    for (int p = threadIdx.y; p < nparts; p += 8) {
      a += dw_part[(long long)p * hidden + col];
      b += db_part[(long long)p * hidden + col];
    }
  }
  sw[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && col < hidden) {
    for (int y = 1; y < 8; ++y) {
      a += sw[y][threadIdx.x];
      b += sb[y][threadIdx.x];
    }
    dw[col] = from_f32<T>(a);
    db[col] = from_f32<T>(b);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* g, void* dx,
                   float* dw_part, float* db_part, void* dw, void* db,
                   int rows, int hidden, int rows_per_block, float eps,
                   cudaStream_t stream) {
  int threads = (hidden + 3) / 4;  // ~4 columns per thread
  threads = ((threads + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (64 + 4 * (size_t)hidden) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int nblocks = (rows + rows_per_block - 1) / rows_per_block;
  ln_bwd_rows_kernel<T><<<nblocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, db_part, rows,
      hidden, rows_per_block, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd_reduce_kernel<T><<<(hidden + 31) / 32, dim3(32, 8), 0, stream>>>(
      dw_part, db_part, nblocks, hidden, static_cast<T*>(dw),
      static_cast<T*>(db));
  return cudaGetLastError();
}

}  // namespace

// Two launches: the row pass, then the fixed-order reduce of the partials.
// dw_part/db_part: f32 scratch of [ceil(rows / rows_per_block), hidden].
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int ptt_layer_norm_bwd(const void* x, const void* w,
                                  const void* g, void* dx, void* dw_part,
                                  void* db_part, void* dw, void* db,
                                  int rows, int hidden, int rows_per_block,
                                  float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  float* pw = static_cast<float*>(dw_part);
  float* pb = static_cast<float*>(db_part);
  if (dtype == 0)
    return (int)launch<float>(x, w, g, dx, pw, pb, dw, db, rows, hidden,
                              rows_per_block, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, g, dx, pw, pb, dw, db, rows,
                                      hidden, rows_per_block, eps, s);
  return (int)cudaErrorInvalidValue;
}
