// Causal dK/dV with one packed output, for Hopper (sm_90a).
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
// [BH, L, d] (contiguous), lse and delta f32 [BH, L].
//
// What bounds it on this card: the four L x L x d products over k <= q
// (S, dP, dV, dK) are ~4 * 2 * d * L^2 / 2 flops per head, ~34 GFLOP at
// (8, 16, 1024, 64): 0.035 ms at 989 TFLOP/s, more than the ~0.01 ms the
// bytes take. This first kernel runs every product as scalar f32 FMAs out
// of shared memory, so it is limited by shared-memory reads and FMA
// issue, far from that bound, like the causal dK/dV kernel it competes
// with (csrc/flash_attn_bwd.cu). The products of two bf16 values are exact
// in f32, so the FMAs give the TPU kernel's "bf16 products, f32
// accumulation" up to the order of the sums.
//
// Design: the thread layout of flash_dkv_kernel (64 x 64 tiles, 128
// threads, each owning 4 key rows strided by 16 x 8 query columns of the
// transposed score tile and 4 rows x d/8 columns of dV and dK). On the
// TPU the packed [p; ds]^T [[do, 0], [0, qs]] product fills the 128-lane
// MXU with d = 64; an SM has no such width to fill, so here the packing
// is only the output layout: one [BH, L, 2d] buffer, each row's dV and dK
// written side by side. Rows and columns past L are masked (the TPU
// kernel needs L % block == 0).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kB = 64;  // rows of a q tile == rows of a k tile
constexpr int kThreads = 128;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Rows [r0, r0 + kB) of a dense [L, D] bf16 matrix into a padded f32 tile,
// times `mul` and rounded to bf16 when `round` (the TPU kernel's
// `(q * scale).astype(bf16)`); rows past L are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int L, float mul, bool round) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    const int l = r0 + r;
    float x = l < L ? __bfloat162float(src[(long long)l * D + dd]) * mul : 0.f;
    dst[r * DP + dd] = round ? round_bf16(x) : x;
  }
}

template <int D>
constexpr size_t smem_bytes() {  // K, V, Q, dO tiles, P, dS, lse, delta
  return (size_t)(4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_packed_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ out, int L, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int DPT = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * DP;
  float* Qs = Vs + kB * DP;
  float* dOs = Qs + kB * DP;
  float* Ps = dOs + kB * DP;
  float* dSs = Ps + kB * PP;
  float* lse_s = dSs + kB * PP;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // key rows rg + 16 * i
  const int cg = tid & 7;   // query cols cg + 8 * c, dK/dV cols cg + 8 * e
  const int kt = blockIdx.x;
  const long long bh = blockIdx.y;
  const int k0 = kt * kB;
  const int nq = (L + kB - 1) / kB;
  const long long base = bh * L * D;

  load_tile<D>(Ks, k + base, k0, L, 1.f, false);
  load_tile<D>(Vs, v + base, k0, L, 1.f, false);

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dka[i][e] = dva[i][e] = 0.f;

  // the first q tile whose queries can reach this key tile
  for (int qt = k0 / kB; qt < nq; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // previous tile's readers of Qs/dOs/stats are done
    load_tile<D>(Qs, q + base, q0, L, scale, true);
    load_tile<D>(dOs, dout + base, q0, L, 1.f, false);
    for (int r = tid; r < kB; r += kThreads) {
      const int l = q0 + r;
      lse_s[r] = l < L ? lse[bh * L + l] : 0.f;
      dl_s[r] = l < L ? delta[bh * L + l] : 0.f;
    }
    __syncthreads();

    // transposed scores: s[i][c] = S[q0 + cg + 8c][k0 + rg + 16i]
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float kv[4], vv[4], qv[8], ov[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(rg + 16 * i) * DP + dd];
        vv[i] = Vs[(rg + 16 * i) * DP + dd];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        qv[c] = Qs[(cg + 8 * c) * DP + dd];
        ov[c] = dOs[(cg + 8 * c) * DP + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[i][c] = fmaf(qv[c], kv[i], s[i][c]);
          dp[i][c] = fmaf(ov[c], vv[i], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const int kpos = k0 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = cg + 8 * c;
        const int qpos = q0 + col;
        const bool in = qpos < L && kpos < L && kpos <= qpos;
        const float p = in ? expf(s[i][c] - lse_s[col]) : 0.f;
        Ps[r * PP + col] = round_bf16(p);
        dSs[r * PP + col] = round_bf16(p * (dp[i][c] - dl_s[col]));
      }
    }
    __syncwarp();  // this warp's P / dS rows are complete

#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(rg + 16 * i) * PP + j];
        sv[i] = dSs[(rg + 16 * i) * PP + j];
      }
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float oo = dOs[j * DP + cg + 8 * e];
        const float qq = Qs[j * DP + cg + 8 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][e] = fmaf(pv[i], oo, dva[i][e]);
          dka[i][e] = fmaf(sv[i], qq, dka[i][e]);
        }
      }
    }
    __syncwarp();  // P / dS are re-written by this warp in the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + rg + 16 * i;
    if (row >= L) continue;
    __nv_bfloat16* o = out + (bh * L + row) * (2 * D);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      o[cg + 8 * e] = __float2bfloat16(dva[i][e]);
      o[D + cg + 8 * e] = __float2bfloat16(dka[i][e]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* out, int BH, int L, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      dkv_packed_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + kB - 1) / kB, BH);
  using bf = __nv_bfloat16;
  dkv_packed_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(out), L, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: contiguous bf16 [BH, L, D]; lse, delta: contiguous f32
// [BH, L]; out: bf16 [BH, L, 2 * D] = [dV | dK]. One launch; returns a
// cudaError_t (0 = launched).
extern "C" int ptt_dkv_packed(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* out, int BH, int L,
                              int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
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
