// Multi-tensor Adam for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/fused.py `_adam_kernel` (launched by
// `pl.pallas_call` in `fused_adam_step`), with the engine's master-weight
// contract (`master_aware_update`, distributed/fleet/engine.py) and
// AdamW's decoupled decay (`apply_optimizer_update`, the same file) folded
// in. The math is `Adam._update` (optimizer/optimizer.py), per element in
// f32:
//   g' = g + wd * p                      (L2 decay folded into the grad)
//   p = p * (1 - lr * c)                 (AdamW: the tensor's coefficient c,
//                                         0 where it is not decayed)
//   b1p = beta1_pow * b1,  b2p = beta2_pow * b2
//   m = b1 * m + (1 - b1) * g',  v = b2 * v + (1 - b2) * g' * g'
//   lr_t = lr * sqrt(1 - b2p) / (1 - b1p)
//   p = p - lr_t * m / (sqrt(v) + eps)   (eps is NOT bias-corrected)
// where p is the f32 master (or the f32 param when there is none); the
// bf16 resident copy is written from the new master in the same pass.
// Every operation is a separately rounded IEEE op (__fmul_rn & co.), so
// no FMA contraction makes the kernel differ from the plain version.
//
// What bounds it on this card: bytes. Per element it reads g (2 or 4 B),
// p, m, v (12 B) and writes p, m, v (12 B) plus the bf16 copy (2 B):
// 28 B per parameter in master mode, ~9.9 GB for GPT-2 345M, so the least
// time is ~3.0 ms at 3.35 TB/s; ~20 flops per element are nothing.
//
// Design. One launch covers every tensor: a device table holds, per
// tensor, the pointers of p, m, v, the bf16 copy, its two beta powers,
// its size and its decoupled-decay coefficient; a second array holds each
// tensor's grad pointer (grads are new tensors every step, the rest is
// not, so only that array is re-sent).
// The grid runs over (tensor, chunk) pairs listed in a third array, so
// small and large tensors share one launch and every block does at most
// one chunk. The per-tensor beta powers (device f32; members' step counts
// may differ) are read by every block of the update, so they are advanced
// by a second, tiny launch that runs after it on the same stream: no block
// can see a half-advanced power. lr is a device scalar: nothing is read
// back to the host.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
// columns of the tensor table (int64 each)
// (kDecay holds the f32 bits of the tensor's decoupled-decay coefficient)
enum { kP = 0, kM, kV, kLow, kB1p, kB2p, kN, kGDtype, kDecay, kCols };

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const long long* __restrict__ tab,
                   const long long* __restrict__ grads,
                   const int* __restrict__ chunks, const float* lr_ptr,
                   float b1, float b2, float omb1, float omb2, float eps,
                   float wd, int chunk) {
  const int t = chunks[2 * blockIdx.x];
  const long long start = (long long)chunks[2 * blockIdx.x + 1] * chunk;
  const long long* e = tab + (long long)t * kCols;
  float* __restrict__ p = reinterpret_cast<float*>(e[kP]);
  float* __restrict__ m = reinterpret_cast<float*>(e[kM]);
  float* __restrict__ v = reinterpret_cast<float*>(e[kV]);
  __nv_bfloat16* __restrict__ low = reinterpret_cast<__nv_bfloat16*>(e[kLow]);
  const float b1p = __fmul_rn(*reinterpret_cast<const float*>(e[kB1p]), b1);
  const float b2p = __fmul_rn(*reinterpret_cast<const float*>(e[kB2p]), b2);
  const long long n = e[kN];
  const bool g_bf16 = e[kGDtype] == 1;
  const float* gf = reinterpret_cast<const float*>(grads[t]);
  const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(grads[t]);
  const float lr = *lr_ptr;
  const float lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                               __fsub_rn(1.f, b1p));
  const float coeff = __int_as_float((int)e[kDecay]);
  const float keep = __fsub_rn(1.f, __fmul_rn(lr, coeff));
  const long long end = start + chunk < n ? start + chunk : n;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    float g = g_bf16 ? __bfloat162float(gb[i]) : gf[i];
    float pv = p[i];
    if (wd != 0.f) g = __fadd_rn(g, __fmul_rn(wd, pv));
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
    if (low != nullptr) low[i] = __float2bfloat16(pn);
  }
}

__global__ void adam_advance_pows_kernel(const long long* __restrict__ tab,
                                         int ntensors, float b1, float b2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntensors) return;
  float* p1 = reinterpret_cast<float*>(tab[(long long)t * kCols + kB1p]);
  float* p2 = reinterpret_cast<float*>(tab[(long long)t * kCols + kB2p]);
  *p1 = __fmul_rn(*p1, b1);
  *p2 = __fmul_rn(*p2, b2);
}

}  // namespace

// tab: device int64 [ntensors, 9] (p, m, v, bf16 copy or 0, beta1_pow,
// beta2_pow, numel, grad dtype 0 = f32 / 1 = bf16, the f32 bits of the
// decoupled-decay coefficient); grads: device int64
// [ntensors] grad pointers; chunks: device int32 [nchunks, 2] (tensor,
// chunk index) with chunk size `chunk`; lr: device f32 scalar. Two
// launches (the update, then the beta-power advance). Returns a
// cudaError_t (0 = launched).
extern "C" int ptt_adam_step(const void* tab, const void* grads,
                             const void* chunks, int nchunks, int ntensors,
                             const void* lr, float b1, float b2, float omb1,
                             float omb2, float eps, float wd, int chunk,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks <= 0 || ntensors <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* t = static_cast<const long long*>(tab);
  adam_update_kernel<<<nchunks, kThreads, 0, s>>>(
      t, static_cast<const long long*>(grads),
      static_cast<const int*>(chunks), static_cast<const float*>(lr), b1,
      b2, omb1, omb2, eps, wd, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  adam_advance_pows_kernel<<<(ntensors + 255) / 256, 256, 0, s>>>(
      t, ntensors, b1, b2);
  return (int)cudaGetLastError();
}
