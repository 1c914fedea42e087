// Multi-tensor finite sweep and state fingerprint for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The reference computes its step's finite
// sweep and state fingerprint at XLA level inside the compiled step
// (paddle_tpu/core/sanitizer.py `finite_flags`, `tree_fingerprint` with
// `_xor_fold_leaf`); the port's engines run them here, one launch over
// every leaf, where the Adam kernel's check pass (adam.cu) does not
// already give the sweep.
//
// Fold mode, per leaf, in the reference's definitions:
//   sum     = f32 sum of the leaf cast to f32      (float leaves only)
//   abs_sum = f32 sum of |leaf cast to f32|        (float leaves only)
//   xor     = XOR of the leaf's raw bits as 32-bit words: 1- and 2-byte
//             elements widened (zero-extended), 4-byte ones as they are,
//             8-byte ones as two words
// and over the leaves, in table order:
//   sum = ((0 + sum_0) + sum_1) + ...          (the same for abs_sum)
//   xor = rotl1(... rotl1(rotl1(0) ^ xor_0) ^ xor_1 ...) ^ xor_{n-1}
//       = XOR_l rotl(xor_l, (n - 1 - l) mod 32)
// (rotation distributes over XOR, so every leaf's term is independent and
// the chain is one block-wide XOR reduction).
// Finite mode gives one flag per leaf: every element finite.
//
// Design. One launch over (leaf, chunk) pairs, as the Adam kernel's: a
// device table holds each leaf's pointer, size and type, a second array
// the (leaf, chunk) pairs. Each block reads its chunk in 16-byte vectors
// (a scalar tail; scalar loads for a leaf that is not 16-byte aligned),
// each thread keeps its sums in f32 and its words' XOR raw (folded to the
// widened form once, at the end: the fold is linear over XOR), and the
// block reduces them in a fixed order (xor shuffles, then warp 0 over the
// warps). One partial per block; a one-block finish reduces each leaf's
// partials in chunk order and chains the leaves. No float atomics: the
// same state gives the same bits on every call.
//
// What bounds it: bytes. It reads every leaf once: GPT-2 345M's state in
// master mode (bf16 params, f32 masters and moments) is ~5.0 GB, ~1.5 ms
// at 3.35 TB/s; BERT-base's without masters ~1.3 GB.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
// table columns (int64 each)
enum { kPtr = 0, kNumel, kType, kCols };
// element types: floats first (they have sums and a finite test)
enum { kF32 = 0, kBF16, kF16, kF64, kBits8, kBits16, kBits32, kBits64 };

__device__ __forceinline__ int type_size(int t) {
  switch (t) {
    case kF32: case kBits32: return 4;
    case kBF16: case kF16: case kBits16: return 2;
    case kF64: case kBits64: return 8;
    default: return 1;
  }
}

// The raw XOR of 32-bit words folded to the XOR of the widened elements.
__device__ __forceinline__ uint32_t fold_words(uint32_t x, int size) {
  if (size == 1) return (x ^ (x >> 8) ^ (x >> 16) ^ (x >> 24)) & 0xffu;
  if (size == 2) return (x ^ (x >> 16)) & 0xffffu;
  return x;
}

struct Acc {
  float s, a;    // sum, abs-sum
  uint32_t raw;  // XOR of whole 32-bit words
  uint32_t wid;  // XOR of widened tail elements
  int bad;       // a non-finite element
};

template <typename T>
__device__ __forceinline__ float as_f32(T x);
template <> __device__ __forceinline__ float as_f32(float x) { return x; }
template <> __device__ __forceinline__ float as_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float as_f32(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float as_f32(double x) {
  return __double2float_rn(x);
}

template <typename T>
__device__ __forceinline__ bool finite_of(T x) {
  return isfinite(as_f32(x));
}
template <> __device__ __forceinline__ bool finite_of(double x) {
  return isfinite(x);
}

// One float element: the sums (fold) or the finite test.
template <typename T, bool kFold>
__device__ __forceinline__ void take(Acc& acc, T x) {
  if constexpr (kFold) {
    const float f = as_f32(x);
    acc.s = __fadd_rn(acc.s, f);
    acc.a = __fadd_rn(acc.a, fabsf(f));
  } else if (!finite_of(x)) {
    acc.bad = 1;
  }
}

// The widened 32-bit words of one element (8-byte ones: two words XORed).
template <typename T>
__device__ __forceinline__ uint32_t widened(const T* p) {
  if constexpr (sizeof(T) == 1) {
    return *reinterpret_cast<const uint8_t*>(p);
  } else if constexpr (sizeof(T) == 2) {
    return *reinterpret_cast<const uint16_t*>(p);
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
    return sizeof(T) == 8 ? w[0] ^ w[1] : w[0];
  }
}

// This thread's share of [start, end) of a leaf of type T (a float type
// when kFloat): 16-byte vectors over the leaf's whole vectors of the chunk
// when it is 16-byte aligned, elements for the rest.
template <typename T, bool kFloat, bool kFold>
__device__ void chunk(Acc& acc, const T* __restrict__ x, long long start,
                      long long end) {
  constexpr int kVec = 16 / sizeof(T);
  long long tail = start;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const long long nvec = (end - start) / kVec;
    const uint4* v = reinterpret_cast<const uint4*>(x + start);
    for (long long j = threadIdx.x; j < nvec; j += kThreads) {
      const uint4 u = v[j];
      if constexpr (kFold) acc.raw ^= u.x ^ u.y ^ u.z ^ u.w;
      if constexpr (kFloat) {
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int k = 0; k < kVec; ++k) take<T, kFold>(acc, e[k]);
      }
    }
    tail = start + nvec * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    if constexpr (kFold) acc.wid ^= widened(x + i);
    if constexpr (kFloat) take<T, kFold>(acc, x[i]);
  }
}

template <bool kFold>
__device__ void walk(Acc& acc, int type, const void* p, long long start,
                     long long end) {
  switch (type) {
    case kF32:
      chunk<float, true, kFold>(acc, static_cast<const float*>(p), start,
                                end);
      break;
    case kBF16:
      chunk<__nv_bfloat16, true, kFold>(
          acc, static_cast<const __nv_bfloat16*>(p), start, end);
      break;
    case kF16:
      chunk<__half, true, kFold>(acc, static_cast<const __half*>(p), start,
                                 end);
      break;
    case kF64:
      chunk<double, true, kFold>(acc, static_cast<const double*>(p), start,
                                 end);
      break;
    case kBits8:
      if constexpr (kFold)
        chunk<uint8_t, false, true>(acc, static_cast<const uint8_t*>(p),
                                    start, end);
      break;
    case kBits16:
      if constexpr (kFold)
        chunk<uint16_t, false, true>(acc, static_cast<const uint16_t*>(p),
                                     start, end);
      break;
    case kBits32:
      if constexpr (kFold)
        chunk<uint32_t, false, true>(acc, static_cast<const uint32_t*>(p),
                                     start, end);
      break;
    default:
      if constexpr (kFold)
        chunk<unsigned long long, false, true>(
            acc, static_cast<const unsigned long long*>(p), start, end);
      break;
  }
}

// Fixed-order block reductions (xor shuffles, then warp 0 over the warps'
// values); thread 0 gets the result.
template <int kBlock>
__device__ float block_sum(float s) {
  __shared__ float part[kBlock / 32];
  __syncthreads();  // part may still be read by a previous reduction
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  s = 0.f;
  if (warp == 0) {
    s = lane < kBlock / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  return s;
}

template <int kBlock>
__device__ uint32_t block_xor(uint32_t x) {
  __shared__ uint32_t part[kBlock / 32];
  __syncthreads();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = x;
  __syncthreads();
  x = 0u;
  if (warp == 0) {
    x = lane < kBlock / 32 ? part[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// One block per (leaf, chunk). Fold: partials[3 * b] = (sum, abs-sum,
// xor bits); finite: partials[b] = 1 if an element is not finite.
template <bool kFold>
__global__ void __launch_bounds__(kThreads)
tree_reduce_kernel(const long long* __restrict__ tab,
                   const int* __restrict__ chunks, int chunk,
                   float* __restrict__ partials) {
  const int l = chunks[2 * blockIdx.x];
  const long long start = (long long)chunks[2 * blockIdx.x + 1] * chunk;
  const long long* e = tab + (long long)l * kCols;
  const long long n = e[kNumel];
  const long long end = start + chunk < n ? start + chunk : n;
  const int type = (int)e[kType];
  Acc acc{0.f, 0.f, 0u, 0u, 0};
  walk<kFold>(acc, type, reinterpret_cast<const void*>(e[kPtr]), start, end);
  if constexpr (kFold) {
    const uint32_t x = block_xor<kThreads>(
        fold_words(acc.raw, type_size(type)) ^ acc.wid);
    const float s = block_sum<kThreads>(acc.s);
    const float a = block_sum<kThreads>(acc.a);
    if (threadIdx.x == 0) {
      partials[3 * blockIdx.x] = s;
      partials[3 * blockIdx.x + 1] = a;
      partials[3 * blockIdx.x + 2] = __uint_as_float(x);
    }
  } else {
    const int bad = __syncthreads_or(acc.bad);
    if (threadIdx.x == 0) partials[blockIdx.x] = bad ? 1.f : 0.f;
  }
}

// One block. leaf_chunks[l] .. leaf_chunks[l + 1] are leaf l's blocks.
// Each thread reduces its leaves' partials in chunk order into leaf_sums;
// thread 0 then adds the leaves' sums in leaf order, and the rotated XOR
// terms are XOR-reduced over the block. out_sums = (sum, abs-sum); out_xor
// = the word as an int64 in [0, 2^32).
__global__ void __launch_bounds__(kFinishThreads)
tree_fold_finish_kernel(const float* __restrict__ partials,
                        const int* __restrict__ leaf_chunks, int nleaves,
                        float* __restrict__ leaf_sums,
                        float* __restrict__ out_sums,
                        long long* __restrict__ out_xor) {
  uint32_t x = 0u;
  for (int l = threadIdx.x; l < nleaves; l += kFinishThreads) {
    float s = 0.f, a = 0.f;
    uint32_t w = 0u;
    for (int b = leaf_chunks[l]; b < leaf_chunks[l + 1]; ++b) {
      s = __fadd_rn(s, partials[3 * b]);
      a = __fadd_rn(a, partials[3 * b + 1]);
      w ^= __float_as_uint(partials[3 * b + 2]);
    }
    leaf_sums[2 * l] = s;
    leaf_sums[2 * l + 1] = a;
    const int r = (nleaves - 1 - l) & 31;
    x ^= r ? (w << r) | (w >> (32 - r)) : w;
  }
  x = block_xor<kFinishThreads>(x);
  __syncthreads();  // leaf_sums written by every thread
  if (threadIdx.x == 0) {
    float s = 0.f, a = 0.f;
    for (int l = 0; l < nleaves; ++l) {
      s = __fadd_rn(s, leaf_sums[2 * l]);
      a = __fadd_rn(a, leaf_sums[2 * l + 1]);
    }
    out_sums[0] = s;
    out_sums[1] = a;
    *out_xor = (long long)x;
  }
}

// One block: flags[l] = 1 (finite) unless a block of leaf l saw a
// non-finite element.
__global__ void __launch_bounds__(kFinishThreads)
tree_finite_finish_kernel(const float* __restrict__ partials,
                          const int* __restrict__ leaf_chunks, int nleaves,
                          unsigned char* __restrict__ flags) {
  for (int l = threadIdx.x; l < nleaves; l += kFinishThreads) {
    int bad = 0;
    for (int b = leaf_chunks[l]; b < leaf_chunks[l + 1]; ++b)
      bad |= partials[b] != 0.f;
    flags[l] = bad ? 0 : 1;
  }
}

}  // namespace

// tab: device int64 [nleaves, 3] (pointer, numel, element type); chunks:
// device int32 [nchunks, 2] (leaf, chunk index), leaf by leaf;
// leaf_chunks: device int32 [nleaves + 1], the first block of each leaf;
// partials: device f32 scratch [3 * nchunks + 2 * nleaves]. mode 0 (fold)
// writes out_sums (f32 [2]) and out_xor (int64 [1]); mode 1 (finite)
// writes flags (uint8 [nleaves]). Two launches (the chunks, then the
// finish). Returns a cudaError_t (0 = launched).
extern "C" int ptt_tree_reduce(const void* tab, const void* chunks,
                               int nchunks, const void* leaf_chunks,
                               int nleaves, int chunk, int mode,
                               void* partials, void* out_sums, void* out_xor,
                               void* flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nleaves <= 0 || chunk <= 0 || chunk % 16 != 0 || nchunks < 0 ||
      mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(tab);
  const int* c = static_cast<const int*>(chunks);
  const int* lc = static_cast<const int*>(leaf_chunks);
  float* part = static_cast<float*>(partials);
  if (nchunks > 0) {
    if (mode == 0)
      tree_reduce_kernel<true><<<nchunks, kThreads, 0, s>>>(t, c, chunk, part);
    else
      tree_reduce_kernel<false><<<nchunks, kThreads, 0, s>>>(t, c, chunk,
                                                             part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (mode == 0)
    tree_fold_finish_kernel<<<1, kFinishThreads, 0, s>>>(
        part, lc, nleaves, part + 3LL * nchunks,
        static_cast<float*>(out_sums), static_cast<long long*>(out_xor));
  else
    tree_finite_finish_kernel<<<1, kFinishThreads, 0, s>>>(
        part, lc, nleaves, static_cast<unsigned char*>(flags));
  return (int)cudaGetLastError();
}
