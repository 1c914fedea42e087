// What the LayerNorm forward (layer_norm.cu) and backward (layer_norm_bwd.cu)
// share: the conversions between f32 and the element types (f32, bf16,
// fp16), and for the warp-per-row kernels the load
// of one row into registers and its two-pass statistics.
//
// Row layout of the warp kernels. A row of `hidden` values is nvec =
// hidden / VEC 16-byte vectors (VEC = 8 bf16 or fp16, or 4 f32). Lane l holds vectors
// l, l + 32, l + 64, ... below nvec, so each load instruction of the warp
// reads 512 contiguous bytes. E is the number of values a lane holds at most
// (a bucket of 8, 16, 24, 32 or 64, from `with_lane_values`); vectors
// past nvec are predicated off, so any hidden that is a multiple of VEC up
// to 64 * 32 = 2048 works. The statistics are summed per lane in the order
// of its values, then across the warp by an xor butterfly of shuffles, which
// leaves the same bits in every lane. Both kernels call `row_stats` with the
// same E for the same hidden, so the backward's recomputed mean and rstd
// equal the forward's bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace ptt_ln {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// values of T in one 16-byte vector
template <typename T> constexpr int kVec = 16 / (int)sizeof(T);

// the 16-byte vector `v` as kVec<T> floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v,
                                                      float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void unpack<__half>(const uint4& v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address is the low half
    const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = h.x;
    f[2 * i + 1] = h.y;
  }
}

// kVec<T> floats rounded once to T, as one 16-byte vector
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <> __device__ __forceinline__ uint4 pack<__half>(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's vectors of the row at `row` (16-byte aligned) into `v`.
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* row, int nvec, int lane,
                                         uint4 (&v)[E / kVec<T>]) {
  const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < E / kVec<T>; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < nvec ? p[j] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// (mean, rstd) of the row whose vectors the warp holds, two-pass in f32;
// `vec(i)` is the lane's i-th vector (from registers or shared memory).
template <typename T, int E, typename V>
__device__ __forceinline__ float2 row_stats(const V& vec, int nvec, int lane,
                                            int hidden, float eps) {
  constexpr int N = kVec<T>;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < E / N; ++i) {
    if (lane + 32 * i < nvec) {
      float f[N];
      unpack<T>(vec(i), f);
#pragma unroll
      for (int k = 0; k < N; ++k) s += f[k];
    }
  }
  const float mean = warp_sum(s) / hidden;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < E / N; ++i) {
    if (lane + 32 * i < nvec) {
      float f[N];
      unpack<T>(vec(i), f);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = f[k] - mean;
        ss += d * d;
      }
    }
  }
  return make_float2(mean, rsqrtf(warp_sum(ss) / hidden + eps));
}

// Returns `launch(std::integral_constant<int, E>())` for the smallest bucket
// E >= hidden / 32 of the values a lane holds; a row wider than 64 values
// per lane launches nothing and is an invalid value.
template <typename F>
inline cudaError_t with_lane_values(int hidden, F&& launch) {
  const int e = (hidden + 31) / 32;
  if (e <= 8) return launch(std::integral_constant<int, 8>());
  if (e <= 16) return launch(std::integral_constant<int, 16>());
  if (e <= 24) return launch(std::integral_constant<int, 24>());
  if (e <= 32) return launch(std::integral_constant<int, 32>());
  if (e <= 64) return launch(std::integral_constant<int, 64>());
  return cudaErrorInvalidValue;
}

// Whether every row of each of `ptrs` starts on 16 bytes (the pointer and
// a row pitch of `hidden` values), as the warp kernels' vector loads need.
// A guard only: ops/fused.py `_ln_plan` picks the kernels and their launch
// shape.
template <typename T>
inline bool rows_aligned(int hidden, const void* const* ptrs, int n) {
  if (hidden % kVec<T> != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

}  // namespace ptt_ln
