// Multi-tensor Adam for Hopper (sm_90a), with the global-norm gradient
// clip folded in.
//
// Replaces: paddle_tpu/ops/fused.py `_adam_kernel` (launched by
// `pl.pallas_call` in `fused_adam_step`), with the engine's master-weight
// contract (`master_aware_update`, distributed/fleet/engine.py), its
// global-norm clip (`clip_grads_global_norm_raw`, nn/clip.py), the L2
// decay it folds into the grad and AdamW's decoupled decay
// (`apply_optimizer_update`, the same file). The math is `Adam._update`
// (optimizer/optimizer.py), per element in f32:
//   g = g * scale, rounded back to g's dtype   (the clip: a tensor that
//                                               takes part in it, when on)
//   lr = lr * s                          (the tensor's learning-rate scale s:
//                                         its ParamAttr learning_rate times
//                                         AdamW's lr_ratio, the reference's
//                                         `_lr_for`; 1 for most tensors)
//   g' = g + l2 * p                      (L2 decay, the tensor's own l2)
//   p = p * (1 - lr * c)                 (AdamW: the tensor's coefficient c,
//                                         0 where it is not decayed; the
//                                         scaled lr, as the reference's
//                                         AdamW.step decays with it)
//   b1p = beta1_pow * b1,  b2p = beta2_pow * b2
//   m = b1 * m + (1 - b1) * g',  v = b2 * v + (1 - b2) * g' * g'
//   lr_t = lr * sqrt(1 - b2p) / (1 - b1p)
//   p = p - lr_t * m / (sqrt(v) + eps)   (eps is NOT bias-corrected)
// where p is the f32 master (or the f32 param when there is none); the
// low-precision resident copy (bf16, or fp16 for the reference's pure-fp16
// O2 training) is written from the new master in the same pass, rounded to
// nearest even (a master beyond fp16's 65504 becomes inf, as the
// reference's `.astype(float16)` makes it). The gradient has the resident
// copy's dtype: f32, bf16 or fp16 (code 0, 1 or 2 in the table).
// Every operation is a separately rounded IEEE op (__fmul_rn & co.), so
// no FMA contraction makes the kernel differ from the plain version.
//
// The clip's scale = clip / max(||g||, clip) comes from a sum-of-squares
// pass over the same tensor table, two launches before the update: one
// block per (tensor, chunk) writes the f32 sum of g*g over its chunk, then
// one block adds those partials in a fixed order (so the norm is the same
// bits on every call) and writes (norm, scale) to a device buffer that the
// update reads through a pointer. Nothing is read back to the host.
//
// What bounds it on this card: bytes. Per element the update reads g (2 or
// 4 B), p, m, v (12 B) and writes p, m, v (12 B) plus the 2-byte copy (2 B):
// 28 B per parameter in master mode, ~9.9 GB for GPT-2 345M, so the least
// time is ~3.0 ms at 3.35 TB/s; ~20 flops per element are nothing. The
// sum-of-squares pass reads each gradient once (0.71 GB of bf16 for GPT-2
// 345M, ~0.21 ms), with 16-byte loads where the gradient is 16-byte
// aligned.
//
// The guarded step (the engines' guard_updates, the reference's in-step
// `select_if_finite`) adds a check pass before the update: the same table
// and arithmetic, nothing written, a flag per tensor for its gradient and
// for its new value, folded with the loss's into one device word that the
// update and the beta-power advance read; a 0 makes them write nothing,
// so a non-finite step keeps every bit of the state without a host sync
// or a copy. It reads g, p, m, v: 14 B per parameter in master mode, ~5.0
// GB for GPT-2 345M, ~1.5 ms.
//
// Design. One launch covers every tensor: a device table holds, per
// tensor, the pointers of p, m, v, the 2-byte copy, its two beta powers,
// its size, its gradient's dtype, its decoupled-decay and L2
// coefficients, whether it takes part in the clip and its learning-rate
// scale; a second array holds each tensor's grad pointer
// (grads are new tensors every step, the rest is not, so only that array
// is re-sent).
// The grid runs over (tensor, chunk) pairs listed in a third array, so
// small and large tensors share one launch and every block does at most
// one chunk. The per-tensor beta powers (device f32; members' step counts
// may differ) are read by every block of the update, so they are advanced
// by a second, tiny launch that runs after it on the same stream: no block
// can see a half-advanced power. lr is a device scalar.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
// columns of the tensor table (int64 each): kGDtype is the gradient's
// (and the resident copy's) dtype code, kDecay, kL2 and kLrScale hold the
// f32 bits of the tensor's decoupled-decay and L2 coefficients and of its
// learning-rate scale, kClip is 1 where the tensor takes part in the clip
enum {
  kP = 0, kM, kV, kLow, kB1p, kB2p, kN, kGDtype, kDecay, kL2, kClip,
  kLrScale, kCols
};
// dtype codes (ops/_build.py DTYPE_CODES)
enum { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// element i of a gradient of dtype code `code`, in f32
__device__ __forceinline__ float load_grad(const void* g, int code,
                                           long long i) {
  if (code == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  if (code == kF16) return __half2float(static_cast<const __half*>(g)[i]);
  return static_cast<const float*>(g)[i];
}

// x rounded to the 2-byte dtype `code` (nearest even) and back to f32;
// x itself for f32
__device__ __forceinline__ float round_to(float x, int code) {
  if (code == kBF16) return __bfloat162float(__float2bfloat16_rn(x));
  if (code == kF16) return __half2float(__float2half_rn(x));
  return x;
}

// Sum over a block in a fixed order (xor shuffles, then warp 0 over the
// warps' sums): the same inputs give the same bits. Thread 0 gets the sum.
template <int kBlock>
__device__ float block_sum(float s) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  s = 0.f;
  if (warp == 0) {
    s = lane < kBlock / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  return s;
}

// f32 sum of g*g over [start, end) of one gradient, by this thread's
// share of the block. A chunk starts at a multiple of the chunk size (a
// multiple of 8), so a 16-byte-aligned gradient is read in 16-byte
// vectors up to the chunk's last whole vector.
template <typename T>
__device__ float chunk_sumsq(const T* __restrict__ g, long long start,
                             long long end) {
  constexpr int kVec = 16 / sizeof(T);
  float s = 0.f;
  long long tail = start;
  if ((reinterpret_cast<unsigned long long>(g) & 15) == 0) {
    const long long nvec = (end - start) / kVec;
    const uint4* v = reinterpret_cast<const uint4*>(g + start);
    for (long long j = threadIdx.x; j < nvec; j += kThreads) {
      const uint4 u = v[j];
      const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float f = to_f32(x[k]);
        s = __fmaf_rn(f, f, s);
      }
    }
    tail = start + nvec * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    const float f = to_f32(g[i]);
    s = __fmaf_rn(f, f, s);
  }
  return s;
}

// One block per (tensor, chunk): the f32 sum of g*g over the chunk (0 for
// a tensor that takes no part in the clip) into partials[blockIdx.x].
__global__ void __launch_bounds__(kThreads)
grad_sumsq_kernel(const long long* __restrict__ tab,
                  const long long* __restrict__ grads,
                  const int* __restrict__ chunks, float* __restrict__ partials,
                  int chunk) {
  const int t = chunks[2 * blockIdx.x];
  const long long start = (long long)chunks[2 * blockIdx.x + 1] * chunk;
  const long long* e = tab + (long long)t * kCols;
  float s = 0.f;
  if (e[kClip] != 0) {
    const long long n = e[kN];
    const long long end = start + chunk < n ? start + chunk : n;
    const int code = (int)e[kGDtype];
    if (code == kBF16)
      s = chunk_sumsq(reinterpret_cast<const __nv_bfloat16*>(grads[t]),
                      start, end);
    else if (code == kF16)
      s = chunk_sumsq(reinterpret_cast<const __half*>(grads[t]), start, end);
    else
      s = chunk_sumsq(reinterpret_cast<const float*>(grads[t]), start, end);
  }
  s = block_sum<kThreads>(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// One block: the partials added in a fixed order; out = (norm, scale) with
// scale = clip / max(norm, clip) (a NaN norm gives a NaN scale, as the
// reference's jnp.maximum does).
__global__ void __launch_bounds__(kFinishThreads)
grad_norm_finish_kernel(const float* __restrict__ partials, int n,
                        float clip, float* __restrict__ out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kFinishThreads)
    s = __fadd_rn(s, partials[i]);
  s = block_sum<kFinishThreads>(s);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(s);
    out[0] = norm;
    out[1] = __fdiv_rn(clip, (norm >= clip || norm != norm) ? norm : clip);
  }
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const long long* __restrict__ tab,
                   const long long* __restrict__ grads,
                   const int* __restrict__ chunks, const float* lr_ptr,
                   const float* scale_ptr, const int* ok_ptr, float b1,
                   float b2, float omb1, float omb2, float eps, int chunk) {
  if (ok_ptr != nullptr && *ok_ptr == 0) return;  // a gated bad step
  const int t = chunks[2 * blockIdx.x];
  const long long start = (long long)chunks[2 * blockIdx.x + 1] * chunk;
  const long long* e = tab + (long long)t * kCols;
  float* __restrict__ p = reinterpret_cast<float*>(e[kP]);
  float* __restrict__ m = reinterpret_cast<float*>(e[kM]);
  float* __restrict__ v = reinterpret_cast<float*>(e[kV]);
  void* low = reinterpret_cast<void*>(e[kLow]);
  const float b1p = __fmul_rn(*reinterpret_cast<const float*>(e[kB1p]), b1);
  const float b2p = __fmul_rn(*reinterpret_cast<const float*>(e[kB2p]), b2);
  const long long n = e[kN];
  const int code = (int)e[kGDtype];
  const void* g_ptr = reinterpret_cast<const void*>(grads[t]);
  const float lr =
      __fmul_rn(*lr_ptr, __int_as_float((int)e[kLrScale]));
  const float lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                               __fsub_rn(1.f, b1p));
  const float coeff = __int_as_float((int)e[kDecay]);
  const float l2 = __int_as_float((int)e[kL2]);
  const bool scaled = scale_ptr != nullptr && e[kClip] != 0;
  const float scale = scaled ? *scale_ptr : 1.f;
  const float keep = __fsub_rn(1.f, __fmul_rn(lr, coeff));
  const long long end = start + chunk < n ? start + chunk : n;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    float g = load_grad(g_ptr, code, i);
    // the clipped gradient rounded back to its own dtype
    if (scaled) g = round_to(__fmul_rn(g, scale), code);
    float pv = p[i];
    if (l2 != 0.f) g = __fadd_rn(g, __fmul_rn(l2, pv));
    if (coeff != 0.f) pv = __fmul_rn(pv, keep);
    const float m1 = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, g));
    const float m2 =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(omb2, g), g));
    const float upd =
        __fdiv_rn(__fmul_rn(lr_t, m1), __fadd_rn(__fsqrt_rn(m2), eps));
    const float pn = __fsub_rn(pv, upd);
    p[i] = pn;
    m[i] = m1;
    v[i] = m2;
    if (low != nullptr) {
      if (code == kF16)
        static_cast<__half*>(low)[i] = __float2half_rn(pn);
      else
        static_cast<__nv_bfloat16*>(low)[i] = __float2bfloat16_rn(pn);
    }
  }
}

__global__ void adam_advance_pows_kernel(const long long* __restrict__ tab,
                                         int ntensors, const int* ok_ptr,
                                         float b1, float b2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntensors || (ok_ptr != nullptr && *ok_ptr == 0)) return;
  float* p1 = reinterpret_cast<float*>(tab[(long long)t * kCols + kB1p]);
  float* p2 = reinterpret_cast<float*>(tab[(long long)t * kCols + kB2p]);
  *p1 = __fmul_rn(*p1, b1);
  *p2 = __fmul_rn(*p2, b2);
}

// The guarded step's check pass: one block per (tensor, chunk) evaluates
// the update of adam_update_kernel, operation for operation, and writes
// none of it. partials[2 * b] is 1 if a gradient element of the chunk is
// not finite (the gradient as it came, before the clip's scale), and
// partials[2 * b + 1] is 1 if a new value is not finite in the
// parameter's dtype (the bf16 copy where the tensor has one): the
// reference's sweep of loss, grad and the updated param.
__global__ void __launch_bounds__(kThreads)
adam_check_kernel(const long long* __restrict__ tab,
                  const long long* __restrict__ grads,
                  const int* __restrict__ chunks, const float* lr_ptr,
                  const float* scale_ptr, float b1, float b2, float omb1,
                  float omb2, float eps, int chunk,
                  int* __restrict__ partials) {
  const int t = chunks[2 * blockIdx.x];
  const long long start = (long long)chunks[2 * blockIdx.x + 1] * chunk;
  const long long* e = tab + (long long)t * kCols;
  const float* __restrict__ p = reinterpret_cast<const float*>(e[kP]);
  const float* __restrict__ m = reinterpret_cast<const float*>(e[kM]);
  const float* __restrict__ v = reinterpret_cast<const float*>(e[kV]);
  const bool has_low = e[kLow] != 0;
  const float b1p = __fmul_rn(*reinterpret_cast<const float*>(e[kB1p]), b1);
  const float b2p = __fmul_rn(*reinterpret_cast<const float*>(e[kB2p]), b2);
  const long long n = e[kN];
  const int code = (int)e[kGDtype];
  const void* g_ptr = reinterpret_cast<const void*>(grads[t]);
  const float lr =
      __fmul_rn(*lr_ptr, __int_as_float((int)e[kLrScale]));
  const float lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                               __fsub_rn(1.f, b1p));
  const float coeff = __int_as_float((int)e[kDecay]);
  const float l2 = __int_as_float((int)e[kL2]);
  const bool scaled = scale_ptr != nullptr && e[kClip] != 0;
  const float scale = scaled ? *scale_ptr : 1.f;
  const float keep = __fsub_rn(1.f, __fmul_rn(lr, coeff));
  const long long end = start + chunk < n ? start + chunk : n;
  int g_bad = 0, p_bad = 0;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    float g = load_grad(g_ptr, code, i);
    g_bad |= !isfinite(g);
    if (scaled) g = round_to(__fmul_rn(g, scale), code);
    float pv = p[i];
    if (l2 != 0.f) g = __fadd_rn(g, __fmul_rn(l2, pv));
    if (coeff != 0.f) pv = __fmul_rn(pv, keep);
    const float m1 = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, g));
    const float m2 =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(omb2, g), g));
    const float upd =
        __fdiv_rn(__fmul_rn(lr_t, m1), __fadd_rn(__fsqrt_rn(m2), eps));
    const float pn = __fsub_rn(pv, upd);
    p_bad |= !isfinite(has_low ? round_to(pn, code) : pn);
  }
  g_bad = __syncthreads_or(g_bad);
  p_bad = __syncthreads_or(p_bad);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = g_bad;
    partials[2 * blockIdx.x + 1] = p_bad;
  }
}

// One block: each tensor's chunk flags (starts[t] .. starts[t + 1]) into
// flags = [loss, grad_0 .. grad_n-1, param_0 .. param_n-1, 1] (1 = finite;
// no loss is finite) and their AND into *ok, the word the gated update
// and the beta powers' advance read.
__global__ void __launch_bounds__(kFinishThreads)
adam_check_finish_kernel(const int* __restrict__ partials,
                         const int* __restrict__ starts, int ntensors,
                         const float* loss, unsigned char* __restrict__ flags,
                         int* __restrict__ ok) {
  int all = 1;
  for (int t = threadIdx.x; t < ntensors; t += kFinishThreads) {
    int g_bad = 0, p_bad = 0;
    for (int b = starts[t]; b < starts[t + 1]; ++b) {
      g_bad |= partials[2 * b];
      p_bad |= partials[2 * b + 1];
    }
    flags[1 + t] = g_bad ? 0 : 1;
    flags[1 + ntensors + t] = p_bad ? 0 : 1;
    all &= !(g_bad | p_bad);
  }
  if (threadIdx.x == 0) {
    const int loss_ok = loss == nullptr || isfinite(*loss);
    flags[0] = loss_ok ? 1 : 0;
    flags[1 + 2 * ntensors] = 1;
    all &= loss_ok;
  }
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) *ok = all;
}

}  // namespace

// tab: device int64 [ntensors, 12] (p, m, v, 2-byte copy or 0,
// beta1_pow, beta2_pow, numel, grad (and copy) dtype 0 = f32 / 1 = bf16 /
// 2 = fp16, the f32 bits of the decoupled-decay and of the L2 coefficient,
// 1 if the tensor is clipped, the f32 bits of its learning-rate scale);
// grads: device int64 [ntensors] grad pointers; chunks: device int32
// [nchunks, 2] (tensor, chunk index) with chunk size `chunk`; lr: device
// f32 scalar; scale: device f32 clip scale, or null for no clip; ok:
// device int32 word of the check pass (ptt_adam_check), or null: when it
// holds 0 neither launch writes anything. Two launches (the update, then
// the beta-power advance). Returns a cudaError_t (0 = launched).
extern "C" int ptt_adam_step(const void* tab, const void* grads,
                             const void* chunks, int nchunks, int ntensors,
                             const void* lr, const void* scale,
                             const void* ok, float b1, float b2, float omb1,
                             float omb2, float eps, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks <= 0 || ntensors <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(tab);
  const int* okp = static_cast<const int*>(ok);
  adam_update_kernel<<<nchunks, kThreads, 0, s>>>(
      t, static_cast<const long long*>(grads),
      static_cast<const int*>(chunks), static_cast<const float*>(lr),
      static_cast<const float*>(scale), okp, b1, b2, omb1, omb2, eps, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  adam_advance_pows_kernel<<<(ntensors + 255) / 256, 256, 0, s>>>(
      t, ntensors, okp, b1, b2);
  return (int)cudaGetLastError();
}

// The guarded step's check pass over the same table, grads, chunks, lr and
// clip scale as ptt_adam_step (which it runs before): starts is device
// int32 [ntensors + 1], the first chunk of each tensor; loss a device f32
// scalar or null; partials device int32 scratch [2 * nchunks]; flags
// device uint8 [2 * ntensors + 2]; ok a device int32 word. Two launches
// (the chunks, then the finish; only the finish when nchunks is 0).
// Returns a cudaError_t.
extern "C" int ptt_adam_check(const void* tab, const void* grads,
                              const void* chunks, int nchunks, int ntensors,
                              const void* starts, const void* lr,
                              const void* scale, const void* loss, float b1,
                              float b2, float omb1, float omb2, float eps,
                              int chunk, void* partials, void* flags,
                              void* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks < 0 || ntensors < 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (nchunks > 0) {
    adam_check_kernel<<<nchunks, kThreads, 0, s>>>(
        static_cast<const long long*>(tab),
        static_cast<const long long*>(grads), static_cast<const int*>(chunks),
        static_cast<const float*>(lr), static_cast<const float*>(scale), b1,
        b2, omb1, omb2, eps, chunk, static_cast<int*>(partials));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  adam_check_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      static_cast<const int*>(partials), static_cast<const int*>(starts),
      ntensors, static_cast<const float*>(loss),
      static_cast<unsigned char*>(flags), static_cast<int*>(ok));
  return (int)cudaGetLastError();
}

// The global gradient norm over the table's clipped tensors (the same
// tab, grads and chunks as ptt_adam_step; only numel, grad dtype and the
// clip flag are read): partials is device f32 [nchunks] scratch, out
// device f32 [2] gets (norm, clip / max(norm, clip)). Two launches (the
// per-chunk sums, then the fixed-order finish). Returns a cudaError_t.
extern "C" int ptt_grad_sumsq(const void* tab, const void* grads,
                              const void* chunks, int nchunks,
                              void* partials, void* out, float clip,
                              int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks <= 0 || chunk <= 0 || chunk % 8 != 0)
    return (int)cudaErrorInvalidValue;
  grad_sumsq_kernel<<<nchunks, kThreads, 0, s>>>(
      static_cast<const long long*>(tab),
      static_cast<const long long*>(grads), static_cast<const int*>(chunks),
      static_cast<float*>(partials), chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  grad_norm_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      static_cast<const float*>(partials), nchunks, clip,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
