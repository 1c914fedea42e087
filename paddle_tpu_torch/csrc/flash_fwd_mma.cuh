// The tensor-core flash-attention forward, `flash_fwd_mma_kernel`, as a
// template over its 2-byte element type: flash_attn_fwd.cu instantiates
// it for bf16 (and holds the design notes and the f32 kernel),
// flash_attn_fwd_f16.cu for fp16, each in its own translation unit so
// that the two build in parallel. The fp16 instance is the bf16 one with
// `mma.sync ... .f16.f16` and fp16 packing: q, k and v are fp16 in shared
// memory, P is rounded to fp16 as the P.V operand, O is rounded once to
// fp16; every sum and the softmax stay f32.
#pragma once

#include "mma_sm90.cuh"

namespace ptt_fwd {

using namespace ptt_mma;

constexpr float kNegInf = -1e30f;

constexpr int kMmaBN = 64;  // keys per tile

// 16-row slices each warp owns: two at d <= 64, so every K/V fragment
// read from shared memory feeds two mma (one slice reads a fragment per
// mma, and shared-memory bandwidth, not the tensor cores, bounds it); one
// at d = 128, where two slices' accumulators would not fit in registers
template <int D>
__host__ __device__ constexpr int mma_slices() { return D <= 64 ? 2 : 1; }

template <int D>  // query rows per block: 4 warps x 16 x slices
__host__ __device__ constexpr int mma_rows() { return 64 * mma_slices<D>(); }

template <int D>
constexpr size_t mma_smem_bytes() {  // Q, then K and V double-buffered
  return (size_t)(mma_rows<D>() + 4 * kMmaBN) * smem_stride<D>() * 2;
}

template <typename Elem, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const Elem* __restrict__ q,
                     const Elem* __restrict__ k,
                     const Elem* __restrict__ v,
                     Elem* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ key_bias, int L, int H,
                     long long q_sb, long long q_sl, long long k_sb,
                     long long k_sl, long long v_sb, long long v_sl,
                     float scale) {
  constexpr int MT = mma_slices<D>();
  constexpr int BM = mma_rows<D>();
  constexpr int S = smem_stride<D>();
  constexpr int T = kMmaBN * S;   // elements of one K or V tile
  constexpr int KC = D / 16;      // 16-deep steps of Q.K^T
  constexpr int NB = kMmaBN / 8;  // 8-key column blocks of S
  constexpr int OB = D / 8;       // 8-wide column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* Qs = reinterpret_cast<Elem*>(smem_raw);
  Elem* Ks = Qs + BM * S;  // buffers Ks, Ks + T
  Elem* Vs = Ks + 2 * T;   // buffers Vs, Vs + T

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row / column pair
  // the q tile is the slowest grid axis, so blocks start in q-tile order
  // over all heads: causal, longest tiles first
  const int qt = CAUSAL ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = qt * BM;
  // causal: up to the tile holding the block's last row
  const int nk = ((CAUSAL ? min(q0 + BM, L) : L) + kMmaBN - 1) / kMmaBN;

  const Elem* qb = q + b * q_sb + (long long)h * D;
  const Elem* kb = k + b * k_sb + (long long)h * D;
  const Elem* vb = v + b * v_sb + (long long)h * D;
  const float* bias = key_bias ? key_bias + (long long)b * L : nullptr;

  load_tile_async<D, BM>(Qs, qb, q_sl, q0, L);
  load_tile_async<D, kMmaBN>(Ks, kb, k_sl, 0, L);
  load_tile_async<D, kMmaBN>(Vs, vb, v_sl, 0, L);
  cp_async_commit();

  // this lane's rows: slice t holds r0 + 16 * t + g and r0 + 16 * t + g + 8
  const int r0 = q0 + warp * 16 * MT;
  float acc[MT][OB][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < OB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  float m[MT][2], l[MT][2];  // running max of x; this lane's part of l
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[t][i] = kNegInf;
      l[t][i] = 0.f;
    }
  uint32_t qf[MT][KC][4];  // Q's A fragments, loaded once per block
  // x, the score the softmax works on: without a bias the raw f32 Q.K^T
  // (the scale is applied inside the exponent, p = 2^(x*mul - m*mul));
  // with one, the scaled score plus the bias, in log2 units (mul = 1)
  const float scale2 = scale * kLog2e;
  const float mul = bias != nullptr ? 1.f : scale2;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose buffer now takes tile kt + 1
    __syncthreads();
    if (kt + 1 < nk) {  // tile kt + 1 streams in while tile kt is used
      load_tile_async<D, kMmaBN>(Ks + (buf ^ 1) * T, kb, k_sl,
                                 (kt + 1) * kMmaBN, L);
      load_tile_async<D, kMmaBN>(Vs + (buf ^ 1) * T, vb, v_sl,
                                 (kt + 1) * kMmaBN, L);
      cp_async_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          ldmatrix_x4(qf[t][kc],
                      a_addr<S>(Qs, warp * 16 * MT + 16 * t, kc * 16, lane));
    }
    const Elem* Kt = Ks + buf * T;
    const Elem* Vt = Vs + buf * T;
    const int k0 = kt * kMmaBN;
    // causal: a warp whose rows all precede the tile's first key skips it
    if (CAUSAL && k0 > r0 + 16 * MT - 1) continue;

    // S = Q K^T: 16 * MT rows x kMmaBN keys per warp
    float x[MT][NB][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[t][j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, b_addr<S>(Kt, np * 16, kc * 16, lane));
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma<Elem>(x[t][2 * np], qf[t][kc], kf[0], kf[1]);
          mma<Elem>(x[t][2 * np + 1], qf[t][kc], kf[2], kf[3]);
        }
      }
    }

    // x[t][j][e] is row r0 + 16 * t + g + 8 * (e >> 1), key
    // k0 + 8 * j + 2 * tig + (e & 1). The bias goes onto the scaled score;
    // only a tile that reaches past L, or (causal) past the block's first
    // row, is masked.
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + 8 * j + 2 * tig + c;
          const float bl = kpos < L ? __ldg(bias + kpos) * kLog2e : 0.f;
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            x[t][j][c] = fmaf(x[t][j][c], scale2, bl);
            x[t][j][2 + c] = fmaf(x[t][j][2 + c], scale2, bl);
          }
        }
    }
    if (k0 + kMmaBN > L || (CAUSAL && k0 + kMmaBN > q0 + 1)) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
            const int row = r0 + 16 * t + g + 8 * (e >> 1);
            if (kpos >= L || (CAUSAL && kpos > row)) x[t][j][e] = kNegInf;
          }
    }

    // online softmax on the fragments; a row lives in one quad of lanes
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      float mx[2] = {m[t][0], m[t][1]};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(x[t][j][0], x[t][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(x[t][j][2], x[t][j][3]));
      }
      float corr[2], off[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        corr[i] = ex2_ftz((m[t][i] - mx[i]) * mul);
        m[t][i] = mx[i];
        off[i] = -mx[i] * mul;
        l[t][i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[t][j][e] = ex2_ftz(fmaf(x[t][j][e], mul, off[e >> 1]));
          l[t][e >> 1] += x[t][j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        acc[t][j][0] *= corr[0];
        acc[t][j][1] *= corr[0];
        acc[t][j][2] *= corr[1];
        acc[t][j][3] *= corr[1];
      }
    }

    // O += P V: P, rounded to Elem, is the A operand straight from S
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
        c_to_a<Elem>(pa[t], x[t][2 * kk], x[t][2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, a_addr<S>(Vt, kk * 16, dp * 16, lane));
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma<Elem>(acc[t][2 * dp], pa[t], vf[0], vf[1]);
          mma<Elem>(acc[t][2 * dp + 1], pa[t], vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lv = l[t][i];
      lv += __shfl_xor_sync(0xffffffffu, lv, 1);
      lv += __shfl_xor_sync(0xffffffffu, lv, 2);
      const int row = r0 + 16 * t + g + 8 * i;
      if (row >= L) continue;
      lv = fmaxf(lv, 1e-30f);
      const float inv = 1.f / lv;
      Elem* orow = o + (((long long)b * L + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < OB; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tig) =
            pack2<Elem>(acc[t][j][2 * i] * inv, acc[t][j][2 * i + 1] * inv);
      if (tig == 0)
        lse[((long long)b * H + h) * L + row] =
            (m[t][i] * mul + log2f(lv)) * kLn2;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const float* key_bias;
  int B, L, H;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
};

template <typename Elem, int D, bool CAUSAL>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<Elem, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.H, a.B, (a.L + mma_rows<D>() - 1) / mma_rows<D>());
  flash_fwd_mma_kernel<Elem, D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(a.q),
      static_cast<const Elem*>(a.k),
      static_cast<const Elem*>(a.v),
      static_cast<Elem*>(a.o), a.lse, a.key_bias, a.L, a.H, a.q_sb,
      a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.scale);
  return cudaGetLastError();
}

// Launches the Elem instance for head dim D (32, 64 or 128) in the mode
// `causal`; any other D is an invalid value.
template <typename Elem>
cudaError_t dispatch_mma(const Args& a, int D, bool causal, cudaStream_t s) {
  switch (D) {
    case 32: return causal ? launch_mma<Elem, 32, true>(a, s)
                           : launch_mma<Elem, 32, false>(a, s);
    case 64: return causal ? launch_mma<Elem, 64, true>(a, s)
                           : launch_mma<Elem, 64, false>(a, s);
    case 128: return causal ? launch_mma<Elem, 128, true>(a, s)
                            : launch_mma<Elem, 128, false>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the fp16 instance (flash_attn_fwd_f16.cu)
cudaError_t launch_f16(const Args& a, int D, bool causal, cudaStream_t s);

}  // namespace ptt_fwd
