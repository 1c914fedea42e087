// Flash-attention backward for Hopper (sm_90a), causal or over all keys:
// dQ, then dK/dV.
//
// Replaces: paddle_tpu/ops/flash_tpu.py `_dq_kernel` and `_dkv_kernel`
// (launched by `pl.pallas_call` in `_flash_bwd_rule`), the causal mode;
// and the backward of paddle_tpu/ops/attention.py `flash_attention`
// (`_flash_bwd_rule`, autodiff through `blockwise_attention`), the full
// mode: the same math with only the mask changed. Each mode has its own C
// entries, so their launches are counted apart. Same function, from the
// forward's saved lse and delta = rowsum(dO * O):
//   S = (scale * Q) K^T + bias (causal: k_pos <= q_pos),  P = exp(S - lse),
//   dS = P * (dO V^T - delta),
//   dQ = scale * dS K,  dK = dS^T (scale * Q),  dV = P^T dO.
// Q, K, V and dO are read in the projection's native [b, L, H, d] layout
// (any row and batch stride, dense [H, d]); dQ, dK, dV are written
// [b, L, H, d]; lse and delta are f32 [b, H, L]. The full mode takes the
// forward's optional key-padding bias, f32 [b, L] (null: none), and adds
// it where it recomputes S; the bias itself gets no gradient.
//
// What bounds it on this card: the five L x L x d products over k <= q
// (S, dP, dQ, dK, dV) are ~5 * 2 * d * L^2 / 2 flops per head, ~43 GFLOP
// at (8, 1024, 16, 64): 0.044 ms at 989 TFLOP/s in bf16, more than the
// ~0.01 ms the bytes take. This first kernel pair runs every product as
// scalar f32 FMAs out of shared memory (exact f32 for both input types,
// no bf16 rounding of P or dS as the TPU kernels do), so it is limited by
// shared-memory reads and FMA issue, far from that bound. It also
// recomputes S and dP in both kernels (7 products instead of 5), as the
// reference does. Moving the products onto mma/wgmma is later work. The
// full mode does each product over all L x L pairs, twice the causal work.
//
// Design (the TPU kernels' structure, rethought for an SM):
//  - two kernels, as the reference, so no float atomics: dQ owns a q tile
//    and loops over K tiles up to the diagonal (full: to the last K
//    tile); dK/dV owns a k tile and loops over q tiles from the diagonal
//    (full: from q tile 0) to the end. Both are deterministic. Causal
//    tiles are launched longest-first;
//  - 64 x 64 tiles, 128 threads; operands live in shared memory as f32
//    with one word of padding per row (conflict-free reads); each thread
//    owns 4 rows (strided by 16) x 8 columns of the 64 x 64 score tile and
//    the same 4 rows x d/8 columns of its accumulators, as in the forward
//    kernel. The P and dS rows a warp writes are the rows it consumes, so
//    only __syncwarp() separates producing them from the products;
//  - S is computed with the forward's operand order and FMA sequence, so
//    exp(S - lse) reproduces the forward's probabilities;
//  - ragged L is masked (out-of-range keys and queries get P = 0, rows
//    past L are not stored, lse/delta past L read as 0): no L % block
//    gate. In full mode no causal mask hides a tile's columns past L, so
//    these tests are what keep them out.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kB = 64;  // rows of a q tile == rows of a k tile
constexpr int kThreads = 128;

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

struct Strides {  // element strides of the batch and row axes
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl;
};

// Loads rows [r0, r0 + kB) of head h of a [b, L, H, D] operand into a
// padded f32 tile, times `mul`; rows past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long sl, int r0, int L,
                                          float mul) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    const int l = r0 + r;
    dst[r * DP + dd] = l < L ? to_f32(src[l * sl + dd]) * mul : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V tiles, dS, lse, delta
  return (size_t)(4 * kB * (D + 1) + kB * (kB + 1) + 2 * kB) * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO tiles, P, dS, lse, delta
  return (size_t)(4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB) *
         sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ key_bias, T* __restrict__ dq, int L,
                int H, Strides st, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int DPT = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * DP;
  float* Ks = dOs + kB * DP;
  float* Vs = Ks + kB * DP;
  float* dSs = Vs + kB * DP;
  float* lse_s = dSs + kB * PP;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg + 16 * i
  const int cg = tid & 7;   // score cols cg + 8 * c, dQ cols cg + 8 * e
  // causal: longest tiles first; full: every tile does the same work
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kB;
  const int nk = CAUSAL ? qt + 1 : (L + kB - 1) / kB;

  load_tile<T, D>(Qs, q + b * st.q_sb + (long long)h * D, st.q_sl, q0, L,
                  scale);
  load_tile<T, D>(dOs, dout + b * st.o_sb + (long long)h * D, st.o_sl, q0,
                  L, 1.f);
  const long long stat = ((long long)b * H + h) * L;
  for (int r = tid; r < kB; r += kThreads) {
    const int l = q0 + r;
    lse_s[r] = l < L ? lse[stat + l] : 0.f;
    dl_s[r] = l < L ? delta[stat + l] : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  const T* kb = k + b * st.k_sb + (long long)h * D;
  const T* vb = v + b * st.v_sb + (long long)h * D;
  const float* bias = key_bias ? key_bias + (long long)b * L : nullptr;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // previous tile's readers of Ks/Vs are done
    load_tile<T, D>(Ks, kb, st.k_sl, k0, L, 1.f);
    load_tile<T, D>(Vs, vb, st.v_sl, k0, L, 1.f);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], ov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(rg + 16 * i) * DP + dd];
        ov[i] = dOs[(rg + 16 * i) * DP + dd];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        kv[c] = Ks[(cg + 8 * c) * DP + dd];
        vv[c] = Vs[(cg + 8 * c) * DP + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }

    float kbias[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int kpos = k0 + cg + 8 * c;
      kbias[c] = bias != nullptr && kpos < L ? bias[kpos] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const int qpos = q0 + r;
      const float l_i = lse_s[r], d_i = dl_s[r];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + cg + 8 * c;
        const bool in =
            qpos < L && kpos < L && (!CAUSAL || kpos <= qpos);
        const float p = in ? expf(s[i][c] + kbias[c] - l_i) : 0.f;
        dSs[r * PP + cg + 8 * c] = p * (dp[i][c] - d_i);
      }
    }
    __syncwarp();  // this warp's dS rows are complete

#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(rg + 16 * i) * PP + j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float kk = Ks[j * DP + cg + 8 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(dsv[i], kk, acc[i][e]);
      }
    }
    __syncwarp();  // dS is re-written by this warp in the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= L) continue;
    T* out = dq + (((long long)b * L + row) * H + h) * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) out[cg + 8 * e] = from_f32<T>(acc[i][e] * scale);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ key_bias, T* __restrict__ dk,
                 T* __restrict__ dv, int L, int H, Strides st, float scale) {
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
  const int kt = blockIdx.x;  // causal: tile 0 loops over every q tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kB;
  const int nq = (L + kB - 1) / kB;

  load_tile<T, D>(Ks, k + b * st.k_sb + (long long)h * D, st.k_sl, k0, L,
                  1.f);
  load_tile<T, D>(Vs, v + b * st.v_sb + (long long)h * D, st.v_sl, k0, L,
                  1.f);

  float dka[4][DPT], dva[4][DPT], kbias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < DPT; ++e) dka[i][e] = dva[i][e] = 0.f;
    const int kpos = k0 + rg + 16 * i;  // this thread's key rows
    kbias[i] = key_bias != nullptr && kpos < L
                   ? key_bias[(long long)b * L + kpos] : 0.f;
  }

  const T* qb = q + b * st.q_sb + (long long)h * D;
  const T* ob = dout + b * st.o_sb + (long long)h * D;
  const long long stat = ((long long)b * H + h) * L;
  for (int qt = CAUSAL ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // previous tile's readers of Qs/dOs/stats are done
    load_tile<T, D>(Qs, qb, st.q_sl, q0, L, scale);
    load_tile<T, D>(dOs, ob, st.o_sl, q0, L, 1.f);
    for (int r = tid; r < kB; r += kThreads) {
      const int l = q0 + r;
      lse_s[r] = l < L ? lse[stat + l] : 0.f;
      dl_s[r] = l < L ? delta[stat + l] : 0.f;
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
        const bool in =
            qpos < L && kpos < L && (!CAUSAL || kpos <= qpos);
        const float p = in ? expf(s[i][c] + kbias[i] - lse_s[col]) : 0.f;
        Ps[r * PP + col] = p;
        dSs[r * PP + col] = p * (dp[i][c] - dl_s[col]);
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
    const long long off = (((long long)b * L + row) * H + h) * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      dk[off + cg + 8 * e] = from_f32<T>(dka[i][e]);
      dv[off + cg + 8 * e] = from_f32<T>(dva[i][e]);
    }
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* key_bias, void* dq, int B, int L, int H,
                      Strides st, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + kB - 1) / kB, H, B);
  flash_dq_kernel<T, D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      key_bias, static_cast<T*>(dq), L, H, st, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const float* key_bias, void* dk,
                       void* dv, int B, int L, int H, Strides st, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + kB - 1) / kB, H, B);
  flash_dkv_kernel<T, D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      key_bias, static_cast<T*>(dk), static_cast<T*>(dv), L, H, st, scale);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t dispatch(bool dkv, int D, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, const float* kb, void* out0,
                     void* out1, int B, int L, int H, Strides st, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 32:
      return dkv ? launch_dkv<T, 32, CAUSAL>(q, k, v, dout, lse, delta, kb,
                                             out0, out1, B, L, H, st, scale, s)
                 : launch_dq<T, 32, CAUSAL>(q, k, v, dout, lse, delta, kb,
                                            out0, B, L, H, st, scale, s);
    case 64:
      return dkv ? launch_dkv<T, 64, CAUSAL>(q, k, v, dout, lse, delta, kb,
                                             out0, out1, B, L, H, st, scale, s)
                 : launch_dq<T, 64, CAUSAL>(q, k, v, dout, lse, delta, kb,
                                            out0, B, L, H, st, scale, s);
    case 128:
      return dkv ? launch_dkv<T, 128, CAUSAL>(q, k, v, dout, lse, delta, kb,
                                              out0, out1, B, L, H, st, scale,
                                              s)
                 : launch_dq<T, 128, CAUSAL>(q, k, v, dout, lse, delta, kb,
                                             out0, B, L, H, st, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool CAUSAL>
int entry(bool dkv, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta,
          const void* key_bias, void* out0, void* out1, int B, int L, int H,
          int D, long long q_sb, long long q_sl, long long k_sb,
          long long k_sl, long long v_sb, long long v_sl, long long o_sb,
          long long o_sl, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (CAUSAL && key_bias != nullptr) return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl};
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const float* kb = static_cast<const float*>(key_bias);
  if (dtype == 0)
    return (int)dispatch<float, CAUSAL>(dkv, D, q, k, v, dout, lse_f,
                                        delta_f, kb, out0, out1, B, L, H, st,
                                        scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16, CAUSAL>(dkv, D, q, k, v, dout, lse_f,
                                                delta_f, kb, out0, out1, B, L,
                                                H, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements: element (b, l, h, d) of q is at
// q[b * q_sb + l * q_sl + h * D + d]; `o_*` are dO's. dQ/dK/dV are dense
// [B, L, H, D]. dtype: 0 = float32, 1 = bfloat16. key_bias: null, or the
// forward's f32 [B, L] key bias (`_full` entries only). Each entry makes
// one launch and returns a cudaError_t (0 = launched). The `_full` entries
// attend to every key, the others are causal.
#define PTT_BWD_ENTRY(NAME, CAUSAL, DKV)                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* dout, const void* lse, const void* delta,   \
                      const void* key_bias, void* out0, void* out1, int B,    \
                      int L, int H, int D, long long q_sb, long long q_sl,    \
                      long long k_sb, long long k_sl, long long v_sb,         \
                      long long v_sl, long long o_sb, long long o_sl,         \
                      float scale, int dtype, void* stream) {                 \
    return entry<CAUSAL>(DKV, q, k, v, dout, lse, delta, key_bias, out0,      \
                         out1, B, L, H, D, q_sb, q_sl, k_sb, k_sl, v_sb,      \
                         v_sl, o_sb, o_sl, scale, dtype, stream);             \
  }

// dQ: out0 = dq (out1 unused, pass 0); dK/dV: out0 = dk, out1 = dv
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dq, true, false)
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dkv, true, true)
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dq_full, false, false)
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dkv_full, false, true)
