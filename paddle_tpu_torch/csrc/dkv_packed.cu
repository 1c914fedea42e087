// Causal dK/dV with one packed output, for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces: tools/experiments/dkv_packed_kernel.py `dkv_kernel` (launched
// by `pl.pallas_call` in `dkv_call`), an experiment that packs dV and dK
// into one [bk, 2d] output tile per key block. Same function, with the
// same bf16 roundings, per (batch-head, key block), looping over the q
// blocks whose queries can reach the keys (from (k0 / bq), the causal
// skip of the TPU kernel):
//   qs = bf16(q * scale),  S = qs K^T,  P = exp(S - lse) (k_pos <= q_pos),
//   dP = dO V^T,  dS = P * (dP - delta),
//   [dV | dK] += [bf16(P); bf16(dS)]^T [[dO | 0], [0 | qs]]
// with f32 accumulation, written once as bf16 into out [BH, L, 2d]
// (dV in columns 0..d, dK in d..2d). Q, K, V and dO are bf16
// [BH, L, d] (contiguous, 16-byte aligned), lse and delta f32 [BH, L].
//
// What bounds it on this card: the four L x L x d products over k <= q
// (S, dP, dV, dK) are ~4 * 2 * d * L^2 / 2 flops per head, ~34 GFLOP at
// (8, 16, 1024, 64): 0.035 ms at 989 TFLOP/s, more than the 0.030 ms its
// 102 MB take at 3.35 TB/s (each input read once, the packed output
// written once).
// Operations bound it, so the products run on the tensor cores.
//
// Design: the dK/dV loop of the causal attention backward
// (`flash_dkv_mma_kernel`, flash_attn_bwd.cu), shared through
// dkv_mma_common.cuh: `mma.sync` m16n8k16 with bf16 operands and f32
// accumulators, K and V held as register A fragments, Q / dO / lse /
// delta double-buffered by 16-byte cp.async, 16-query chunks of S^T and
// dP^T, P^T and dS^T rounded to bf16 straight into A operands. On the TPU
// the packed [p; ds]^T [[do, 0], [0, qs]] product fills the 128-lane MXU
// at d = 64, half of it zeros; here it is two products into two
// accumulators, and the packing is only the output layout: each row's dV
// and dK side by side in one [BH, L, 2d] buffer. What the experiment adds
// to the loop (the `PACKED` instance): at d = 32 and 128, Q is scaled and
// rounded to bf16 in shared memory as it lands, so S and dK take the
// reference's bf16(q * scale) (at d = 64 that rounding is exact and the
// loop runs as the causal kernel's), and the output rows are 2d wide,
// staged per warp in shared memory and stored in 16-byte chunks. Rows past
// L are masked (the TPU kernel needs L % block == 0).
#include "dkv_mma_common.cuh"

namespace {

using namespace ptt_dkv;

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_packed_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ out,
                      int L, Strides st, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the grid as the causal kernel's with one head: batch-head on y, the k
  // tile the slowest axis, tile 0 (which loops over every q tile) first.
  // (With the batch-head on x, ptxas gave the d = 64 instance 183
  // registers instead of 168: 2 blocks an SM instead of 3.) The packed
  // rows, dV in columns 0..d and dK in d..2d, go to `out`.
  dkv_mma_body<bf16, D, true, true>(smem_raw, q, k, v, dout, lse, delta, nullptr,
                              nullptr, out, L, 1, st, scale, blockIdx.y,
                              blockIdx.x, blockIdx.z);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* out, int BH, int L, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      dkv_packed_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  // [BH, L, D]: one "head" of D per row, a batch-head every L rows
  const long long sb = (long long)L * D;
  const Strides st{sb, D, sb, D, sb, D, sb, D, 0, 0};
  const dim3 grid(1, BH, (L + kBN - 1) / kBN);
  dkv_packed_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(out), L, st, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: contiguous bf16 [BH, L, D], each 16-byte aligned; lse,
// delta: contiguous f32 [BH, L]; out: bf16 [BH, L, 2 * D] = [dV | dK].
// One launch; returns a cudaError_t (0 = launched).
extern "C" int ptt_dkv_packed(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* out, int BH, int L,
                              int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || L <= 0 || BH > 65535 || (L + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;  // the grid's y and z extents
  const void* rows[] = {q, k, v, dout};  // copied by 16-byte cp.async
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorInvalidValue;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, dout, lse_f, delta_f, out, BH,
                                    L, scale, s);
    case 64: return (int)launch<64>(q, k, v, dout, lse_f, delta_f, out, BH,
                                    L, scale, s);
    case 128: return (int)launch<128>(q, k, v, dout, lse_f, delta_f, out,
                                      BH, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
