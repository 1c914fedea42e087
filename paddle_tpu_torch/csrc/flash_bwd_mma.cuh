// The tensor-core flash-attention backward, `flash_dq_mma_kernel` and
// `flash_dkv_mma_kernel` (the dK/dV loop of dkv_mma_common.cuh), as
// templates over their 2-byte element type: flash_attn_bwd.cu
// instantiates them for bf16 (and holds the design notes and the f32
// kernels), flash_attn_bwd_f16.cu for fp16, each in its own translation
// unit so that the two build in parallel. The fp16 instances are the bf16
// ones with `mma.sync ... .f16.f16` and fp16 packing: P and dS are rounded
// to fp16 as operands, dQ, dK and dV once to fp16; delta, the softmax and
// every sum stay f32.
#pragma once

#include "dkv_mma_common.cuh"

namespace ptt_bwd {

using namespace ptt_dkv;  // Strides, kBN, the dK/dV loop; ptt_mma

// dQ's 16-row slices per warp: two at d <= 64, one at d = 128
template <int D>
__host__ __device__ constexpr int dq_slices() { return D <= 64 ? 2 : 1; }

template <int D>  // query rows per dQ block: 4 warps x 16 x slices
__host__ __device__ constexpr int dq_rows() { return 64 * dq_slices<D>(); }

template <int D>
constexpr size_t dq_mma_smem_bytes() {  // Q, dO, then K and V double-buffered
  return (size_t)(2 * dq_rows<D>() + 4 * kBN) * smem_stride<D>() * 2;
}

template <typename Elem, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dq_mma_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                    const Elem* __restrict__ v, const Elem* __restrict__ o,
                    const Elem* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    const float* __restrict__ key_bias,
                    Elem* __restrict__ dq, int L, int H, Strides st,
                    float scale) {
  constexpr int MT = dq_slices<D>();
  constexpr int BM = dq_rows<D>();
  constexpr int S = smem_stride<D>();
  constexpr int T = kBN * S;  // elements of one K or V tile
  constexpr int KC = D / 16;  // 16-deep steps over the head dim
  constexpr int OB = D / 8;   // 8-wide column blocks of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* Qs = reinterpret_cast<Elem*>(smem_raw);
  Elem* dOs = Qs + BM * S;
  Elem* Ks = dOs + BM * S;  // buffers Ks, Ks + T
  Elem* Vs = Ks + 2 * T;    // buffers Vs, Vs + T

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row / column pair
  // the q tile is the slowest grid axis; causal: longest tiles first
  const int qt = CAUSAL ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = qt * BM;
  // causal: up to the tile holding the block's last row
  const int nk = ((CAUSAL ? min(q0 + BM, L) : L) + kBN - 1) / kBN;

  const Elem* qb = q + b * st.q_sb + (long long)h * D;
  const Elem* kb = k + b * st.k_sb + (long long)h * D;
  const Elem* vb = v + b * st.v_sb + (long long)h * D;
  const Elem* ob = o + b * st.o_sb + (long long)h * D;
  const Elem* gb = dout + b * st.do_sb + (long long)h * D;
  const float* bias = key_bias ? key_bias + (long long)b * L : nullptr;
  const long long stat = ((long long)b * H + h) * L;

  load_tile_async<D, BM>(Qs, qb, st.q_sl, q0, L);
  load_tile_async<D, BM>(dOs, gb, st.do_sl, q0, L);
  load_tile_async<D, kBN>(Ks, kb, st.k_sl, 0, L);
  load_tile_async<D, kBN>(Vs, vb, st.v_sl, 0, L);
  cp_async_commit();

  // this lane's rows: slice t holds r0 + 16 * t + g and r0 + 16 * t + g + 8
  const int r0 = q0 + warp * 16 * MT;
  const int rlast = r0 + 16 * MT - 1;
  float acc[MT][OB][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < OB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  // lse * log2 e and delta of this lane's rows
  float lse2[MT][2], dl[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * t + g + 8 * i;
      lse2[t][i] = row < L ? __ldg(lse + stat + row) * kLog2e : 0.f;
    }
  uint32_t qf[MT][KC][4], df[MT][KC][4];  // Q's and dO's A fragments
  const float c2 = scale * kLog2e;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose buffer now takes tile kt + 1
    __syncthreads();
    if (kt + 1 < nk) {
      load_tile_async<D, kBN>(Ks + (buf ^ 1) * T, kb, st.k_sl,
                              (kt + 1) * kBN, L);
      load_tile_async<D, kBN>(Vs + (buf ^ 1) * T, vb, st.v_sl,
                              (kt + 1) * kBN, L);
      cp_async_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          ldmatrix_x4(qf[t][kc],
                      a_addr<S>(Qs, warp * 16 * MT + 16 * t, kc * 16, lane));
          ldmatrix_x4(df[t][kc],
                      a_addr<S>(dOs, warp * 16 * MT + 16 * t, kc * 16, lane));
        }
      // delta = rowsum(dO * O) in f32: dO from this lane's fragments (row
      // g + 8i: registers i and 2 + i), O's same columns from memory
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 16 * t + g + 8 * i;
          float sum = 0.f;
          if (row < L) {
            const Elem* orow = ob + row * st.o_sl;
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
              const float2 o0 = unpack2<Elem>(*reinterpret_cast<
                  const uint32_t*>(orow + kc * 16 + 2 * tig));
              const float2 o1 = unpack2<Elem>(*reinterpret_cast<
                  const uint32_t*>(orow + kc * 16 + 8 + 2 * tig));
              const float2 d0 = unpack2<Elem>(df[t][kc][i]);
              const float2 d1 = unpack2<Elem>(df[t][kc][2 + i]);
              sum = fmaf(d0.x, o0.x, sum);
              sum = fmaf(d0.y, o0.y, sum);
              sum = fmaf(d1.x, o1.x, sum);
              sum = fmaf(d1.y, o1.y, sum);
            }
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          dl[t][i] = sum;
          if (tig == 0 && row < L) delta[stat + row] = sum;
        }
    }
    const Elem* Kt = Ks + buf * T;
    const Elem* Vt = Vs + buf * T;
    const int k0 = kt * kBN;
    // causal: a warp whose rows all precede the tile's first key skips it
    if (CAUSAL && k0 > rlast) continue;

#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const int kc0 = k0 + 16 * kk;  // the chunk's first key
      if ((CAUSAL && kc0 > rlast) || kc0 >= L) break;
      // S = Q K^T and dP = dO V^T on 16 keys: s[t][j][e] is row
      // r0 + 16t + g + 8(e >> 1), key kc0 + 8j + 2tig + (e & 1)
      float s[MT][2][4], dp[MT][2][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][j][e] = dp[t][j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, b_addr<S>(Kt, 16 * kk, kc * 16, lane));
        ldmatrix_x4(vf, b_addr<S>(Vt, 16 * kk, kc * 16, lane));
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma<Elem>(s[t][0], qf[t][kc], kf[0], kf[1]);
          mma<Elem>(s[t][1], qf[t][kc], kf[2], kf[3]);
          mma<Elem>(dp[t][0], df[t][kc], vf[0], vf[1]);
          mma<Elem>(dp[t][1], df[t][kc], vf[2], vf[3]);
        }
      }
      // P = 2^(S c + bias log2e - lse log2e), dS = P (dP - delta); only a
      // chunk that crosses the diagonal or reaches past L is masked
      float bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = kc0 + 8 * j + 2 * tig + c;
          bl[j][c] = bias != nullptr && kpos < L
                         ? __ldg(bias + kpos) * kLog2e : 0.f;
        }
      const bool edge = kc0 + 16 > L || (CAUSAL && kc0 + 15 > r0);
      uint32_t da[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        float ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2_ftz(fmaf(s[t][j][e], c2,
                                   bl[j][e & 1] - lse2[t][e >> 1]));
            if (edge) {
              const int kpos = kc0 + 8 * j + 2 * tig + (e & 1);
              const int row = r0 + 16 * t + g + 8 * (e >> 1);
              if (kpos >= L || (CAUSAL && kpos > row)) p = 0.f;
            }
            ds[j][e] = p * (dp[t][j][e] - dl[t][e >> 1]);
          }
        c_to_a<Elem>(da[t], ds[0], ds[1]);  // dS rounded to Elem
      }
      // dQ += dS K: K's 16 keys x 16 columns as the B operand, transposed
#pragma unroll
      for (int dc = 0; dc < KC; ++dc) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, a_addr<S>(Kt, 16 * kk, dc * 16, lane));
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma<Elem>(acc[t][2 * dc], da[t], kf[0], kf[1]);
          mma<Elem>(acc[t][2 * dc + 1], da[t], kf[2], kf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * t + g + 8 * i;
      if (row >= L) continue;
      Elem* orow = dq + (((long long)b * L + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < OB; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tig) =
            pack2<Elem>(acc[t][j][2 * i] * scale,
                        acc[t][j][2 * i + 1] * scale);
    }
}

template <typename Elem, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dkv_mma_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                     const Elem* __restrict__ v,
                     const Elem* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_bias,
                     Elem* __restrict__ dk, Elem* __restrict__ dv, int L,
                     int H, Strides st, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the k tile is the slowest grid axis; causal: tile 0, which loops over
  // every q tile, first
  dkv_mma_body<Elem, D, CAUSAL, false>(smem_raw, q, k, v, dout, lse, delta,
                                 key_bias, dk, dv, L, H, st, scale,
                                 blockIdx.y, blockIdx.x, blockIdx.z);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;  // the tensor-core dQ writes it; the f32 kernels and dK/dV
                 // read it
  const float* key_bias;
  void *out0, *out1;
  int B, L, H;
  Strides st;
  float scale;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename Elem, int D, bool CAUSAL>
cudaError_t launch_mma(bool dkv, const Args& a, cudaStream_t s) {
  const Elem* q = static_cast<const Elem*>(a.q);
  const Elem* k = static_cast<const Elem*>(a.k);
  const Elem* v = static_cast<const Elem*>(a.v);
  const Elem* dout = static_cast<const Elem*>(a.dout);
  cudaError_t e;
  if (dkv) {
    constexpr size_t smem = dkv_mma_smem_bytes<D>();
    if ((e = set_smem(flash_dkv_mma_kernel<Elem, D, CAUSAL>, smem)) != cudaSuccess)
      return e;
    const dim3 grid(a.H, a.B, (a.L + kBN - 1) / kBN);
    flash_dkv_mma_kernel<Elem, D, CAUSAL><<<grid, kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, a.key_bias,
        static_cast<Elem*>(a.out0), static_cast<Elem*>(a.out1), a.L, a.H,
        a.st, a.scale);
  } else {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    if ((e = set_smem(flash_dq_mma_kernel<Elem, D, CAUSAL>, smem)) != cudaSuccess)
      return e;
    const dim3 grid(a.H, a.B, (a.L + dq_rows<D>() - 1) / dq_rows<D>());
    flash_dq_mma_kernel<Elem, D, CAUSAL><<<grid, kThreads, smem, s>>>(
        q, k, v, static_cast<const Elem*>(a.o), dout, a.lse, a.delta,
        a.key_bias, static_cast<Elem*>(a.out0), a.L, a.H, a.st, a.scale);
  }
  return cudaGetLastError();
}

// Launches the Elem instance (dQ, or dK/dV when `dkv`) for head dim D
// (32, 64 or 128) in the mode `causal`; any other D is an invalid value.
template <typename Elem>
cudaError_t dispatch_mma(bool dkv, const Args& a, int D, bool causal,
                         cudaStream_t s) {
  switch (D) {
    case 32: return causal ? launch_mma<Elem, 32, true>(dkv, a, s)
                           : launch_mma<Elem, 32, false>(dkv, a, s);
    case 64: return causal ? launch_mma<Elem, 64, true>(dkv, a, s)
                           : launch_mma<Elem, 64, false>(dkv, a, s);
    case 128: return causal ? launch_mma<Elem, 128, true>(dkv, a, s)
                            : launch_mma<Elem, 128, false>(dkv, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the fp16 instances (flash_attn_bwd_f16.cu)
cudaError_t launch_f16(bool dkv, const Args& a, int D, bool causal,
                       cudaStream_t s);

}  // namespace ptt_bwd
