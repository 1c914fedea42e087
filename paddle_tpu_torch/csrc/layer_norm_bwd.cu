// LayerNorm backward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused.py `_ln_bwd_kernel` (launched by
// `pl.pallas_call` in `_fused_ln_bwd`). Same math, all in f32: per row,
// recompute mean and rstd (two-pass, as the forward), x^ = (x - mean) * rstd,
//   dx = rstd * (g*w - mean(g*w) - x^ * mean(g*w*x^)),
// and over all rows dw = sum(g * x^), db = sum(g). dx is rounded once to x's
// dtype, dw/db to the weight's.
//
// What bounds it on this card: bytes. x and g are read once and dx written
// once (3 * rows * hidden elements) for ~15 flops per element, far below
// the ~295 flops/byte ridge: at [8192, 1024] bf16 the least time is
// 50 MB / 3.35 TB/s = 15 us.
//
// The TPU kernel carries dw/db in one VMEM block across a grid that runs in
// order. CUDA blocks run concurrently, so the sums over rows are split in
// two launches, with no float atomics and a fixed order: a row pass that
// writes one row of f32 partials [grid, hidden] per block, then
// `ln_bwd_reduce_kernel`, which sums the partials per column in a fixed
// order (32 stripes of partials, one per warp row, then the 32 stripe sums
// in order), so the result does not depend on block scheduling.
//
// Two row passes; ops/fused.py `_ln_plan` picks one from the shape before
// the launch (variant 0 or 1 of the C entry):
//  0. `ln_bwd_warp_kernel`, the one the models run: a warp per row, 8 warps
//     to a block and a grid of a few blocks per SM; each warp strides over
//     the rows. Per row, x and g come by 16-byte loads into registers
//     (layer_norm_common.cuh: the forward's layout and its `row_stats`, so
//     mean and rstd equal the forward's bit for bit). That holds up to 32
//     values a lane (hidden 1024, the models' widths); a wider row keeps x
//     and g in the lane's own slots of shared memory, which no other lane
//     reads, so no barrier guards them, and leaves the registers to the
//     sums below. The statistics and both means are warp shuffles; dx is
//     written as vectors; g * x^ and g go into per-lane f32 sums for the
//     columns the lane owns, in registers across all the warp's rows. At
//     the end the block's warps add their sums in warp order through shared
//     memory (one barrier per warp, once per block) and the last warp
//     writes the block's partial row as vectors. What it does about the
//     bound: full 512-byte warp segments, no barrier inside the row loop, a
//     row's x and g (4 KB at hidden 1024 bf16) in flight per warp, and
//     partials of one row per block (264 blocks: 2 MB at hidden 1024).
//     It takes a hidden that is a multiple of the vector up to 2048 with
//     every pointer 16-byte aligned.
//  1. `ln_bwd_rows_kernel`, for every other call: block i owns rows
//     [i*rpb, (i+1)*rpb), stages each row's x and g as f32 in shared memory,
//     reduces with block barriers, and keeps per-column sums in shared
//     memory (each thread owns the columns tid, tid + blockDim, ...). Any
//     row count; hidden bounded by shared memory (4 * hidden floats: up to
//     ~14k columns after the opt-in).
#include "layer_norm_common.cuh"

namespace {

using namespace ptt_ln;

template <typename T, int E>
__global__ void __launch_bounds__(256)
ln_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ dw_part, float* __restrict__ db_part,
                   int rows, int hidden, float eps) {
  constexpr int N = kVec<T>, NV = E / N;
  // x and g in registers up to 32 values a lane; a wider row keeps them in
  // the lane's own slots of shared memory (the dw/db sums take the
  // registers)
  constexpr bool kInRegs = E <= 32;
  // [2][E][32] f32: the block's running sums, value e of lane l at
  // e * 32 + l; then, for a row wider than 32 values a lane, each warp's
  // x and g vectors, [2][NV][32]
  extern __shared__ __align__(16) float wsmem[];
  float* sw = wsmem;
  float* sb = wsmem + E * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  uint4* rs =
      reinterpret_cast<uint4*>(wsmem + 2 * E * 32) + warp * 2 * NV * 32;
  const int nvec = hidden / N;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  float aw[E], ab[E];  // this lane's sums of g * x^ and of g
#pragma unroll
  for (int e = 0; e < E; ++e) aw[e] = ab[e] = 0.f;
  const long long stride = (long long)gridDim.x * nwarps;
  for (long long row = (long long)blockIdx.x * nwarps + warp; row < rows;
       row += stride) {
    uint4 xr[NV], gr[NV];
    if constexpr (kInRegs) {
      load_row<T, E>(x + row * hidden, nvec, lane, xr);
      load_row<T, E>(g + row * hidden, nvec, lane, gr);
    } else {
      const uint4* xp = reinterpret_cast<const uint4*>(x + row * hidden);
      const uint4* gp = reinterpret_cast<const uint4*>(g + row * hidden);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i < nvec) {
          rs[i * 32 + lane] = xp[lane + 32 * i];
          rs[(NV + i) * 32 + lane] = gp[lane + 32 * i];
        }
      }
    }
    const auto xv = [&](int i) {
      if constexpr (kInRegs) return xr[i];
      else return rs[i * 32 + lane];
    };
    const auto gv = [&](int i) {
      if constexpr (kInRegs) return gr[i];
      else return rs[(NV + i) * 32 + lane];
    };
    const float2 st = row_stats<T, E>(xv, nvec, lane, hidden, eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) {
        float xf[N], gf[N], wf[N];
        unpack<T>(xv(i), xf);
        unpack<T>(gv(i), gf);
        unpack<T>(wv[j], wf);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float xh = (xf[k] - st.x) * st.y;
          const float gw = gf[k] * wf[k];
          a += gw;
          b += gw * xh;
          aw[i * N + k] += gf[k] * xh;
          ab[i * N + k] += gf[k];
        }
      }
    }
    const float m1 = warp_sum(a) / hidden, m2 = warp_sum(b) / hidden;
    uint4* dxv = reinterpret_cast<uint4*>(dx + row * hidden);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) {
        float xf[N], gf[N], wf[N];
        unpack<T>(xv(i), xf);
        unpack<T>(gv(i), gf);
        unpack<T>(wv[j], wf);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float xh = (xf[k] - st.x) * st.y;
          xf[k] = st.y * (gf[k] * wf[k] - m1 - xh * m2);
        }
        dxv[j] = pack<T>(xf);
      }
    }
  }
  // The block's sums, in warp order: warp k adds the running sums of warps
  // 0..k-1 to its own; the last warp writes them as the block's partials.
  for (int k = 0; k < nwarps; ++k) {
    if (warp == k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (k > 0) {
          aw[e] = sw[e * 32 + lane] + aw[e];
          ab[e] = sb[e * 32 + lane] + ab[e];
        }
        if (k + 1 < nwarps) {
          sw[e * 32 + lane] = aw[e];
          sb[e * 32 + lane] = ab[e];
        }
      }
      if (k + 1 == nwarps) {
        float* pw = dw_part + (long long)blockIdx.x * hidden;
        float* pb = db_part + (long long)blockIdx.x * hidden;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int j = lane + 32 * i;
          if (j < nvec) {
#pragma unroll
            for (int q = 0; q < N / 4; ++q) {
              const int e = i * N + 4 * q;
              reinterpret_cast<float4*>(pw + j * N)[q] =
                  make_float4(aw[e], aw[e + 1], aw[e + 2], aw[e + 3]);
              reinterpret_cast<float4*>(pb + j * N)[q] =
                  make_float4(ab[e], ab[e + 1], ab[e + 2], ab[e + 3]);
            }
          }
        }
      }
    }
    if (k + 1 < nwarps) __syncthreads();
  }
}

// Sums of (a, b) over the block; every thread gets both. `red` holds 64.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
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
  return make_float2(warp_sum(a), warp_sum(b));
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

// blockDim (32, 32): threadIdx.x is the column within a 32-column strip,
// threadIdx.y the stripe of partials (p = y, y + 32, ...) it sums; then the
// 32 stripe sums in order.
template <typename T>
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ dw_part,
                                     const float* __restrict__ db_part,
                                     int nparts, int hidden,
                                     T* __restrict__ dw, T* __restrict__ db) {
  __shared__ float sw[32][33], sb[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (col < hidden) {
#pragma unroll 8  // loads ahead; the sums stay in order
    for (int p = threadIdx.y; p < nparts; p += 32) {
      a += dw_part[(long long)p * hidden + col];
      b += db_part[(long long)p * hidden + col];
    }
  }
  sw[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && col < hidden) {
    for (int y = 1; y < 32; ++y) {
      a += sw[y][threadIdx.x];
      b += sb[y][threadIdx.x];
    }
    dw[col] = from_f32<T>(a);
    db[col] = from_f32<T>(b);
  }
}

template <typename T>
cudaError_t launch_warp(const void* x, const void* w, const void* g,
                        void* dx, float* dw_part, float* db_part, int rows,
                        int hidden, int rows_per_block, int grid, float eps,
                        cudaStream_t stream) {
  const void* ptrs[] = {x, w, g, dx, dw_part, db_part};
  if (!rows_aligned<T>(hidden, ptrs, 6)) return cudaErrorInvalidValue;
  return with_lane_values(hidden, [&](auto e) {
    constexpr int E = decltype(e)::value;
    // the block's sums, then each warp's x and g vectors for a row wider
    // than 32 values a lane (as the kernel lays them out)
    const size_t smem = 2 * E * 32 * sizeof(float)
                        + (E <= 32 ? 0 : rows_per_block * 2 * (E / kVec<T>)
                                             * 32 * sizeof(uint4));
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          ln_bwd_warp_kernel<T, E>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    ln_bwd_warp_kernel<T, E><<<grid, 32 * rows_per_block, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<T*>(dx), dw_part, db_part, rows,
        hidden, eps);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_block(const void* x, const void* w, const void* g,
                         void* dx, float* dw_part, float* db_part, int rows,
                         int hidden, int rows_per_block, int grid, float eps,
                         cudaStream_t stream) {
  if ((long long)grid * rows_per_block < rows) return cudaErrorInvalidValue;
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
  ln_bwd_rows_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, db_part, rows,
      hidden, rows_per_block, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* g, void* dx,
                   float* dw_part, float* db_part, void* dw, void* db,
                   int rows, int hidden, int rows_per_block, int grid,
                   float eps, int variant, cudaStream_t stream) {
  cudaError_t e = cudaErrorInvalidValue;
  if (variant == 0)
    e = launch_warp<T>(x, w, g, dx, dw_part, db_part, rows, hidden,
                       rows_per_block, grid, eps, stream);
  else if (variant == 1)
    e = launch_block<T>(x, w, g, dx, dw_part, db_part, rows, hidden,
                        rows_per_block, grid, eps, stream);
  if (e != cudaSuccess) return e;
  ln_bwd_reduce_kernel<T><<<(hidden + 31) / 32, dim3(32, 32), 0, stream>>>(
      dw_part, db_part, grid, hidden, static_cast<T*>(dw),
      static_cast<T*>(db));
  return cudaGetLastError();
}

}  // namespace

// Two launches: a row pass, then the fixed-order reduce of the partials.
// variant: 0 = a warp per row (`rows_per_block` warps to a block, `grid`
// blocks, each warp striding over the rows), 1 = `rows_per_block`
// consecutive rows to a block, as ops/fused.py `_ln_plan` gives them.
// dw_part/db_part: f32 scratch of [grid, hidden]. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. Returns a cudaError_t (0 = launched).
extern "C" int ptt_layer_norm_bwd(const void* x, const void* w,
                                  const void* g, void* dx, void* dw_part,
                                  void* db_part, void* dw, void* db,
                                  int rows, int hidden, int rows_per_block,
                                  int grid, float eps, int dtype, int variant,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || hidden <= 0 || rows_per_block <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  float* pw = static_cast<float*>(dw_part);
  float* pb = static_cast<float*>(db_part);
  if (dtype == 0)
    return (int)launch<float>(x, w, g, dx, pw, pb, dw, db, rows, hidden,
                              rows_per_block, grid, eps, variant, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, g, dx, pw, pb, dw, db, rows,
                                      hidden, rows_per_block, grid, eps,
                                      variant, s);
  if (dtype == 2)
    return (int)launch<__half>(x, w, g, dx, pw, pb, dw, db, rows, hidden,
                               rows_per_block, grid, eps, variant, s);
  return (int)cudaErrorInvalidValue;
}
