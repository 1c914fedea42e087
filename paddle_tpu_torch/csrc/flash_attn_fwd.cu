// Flash-attention forward for Hopper (sm_90a), causal or over all keys.
//
// Replaces two TPU kernels that differ only in the mask:
//  - paddle_tpu/ops/flash_tpu.py `_fwd_kernel` (launched by `pl.pallas_call`
//    in `_fwd_call`, wrapped by `flash_attention_blhd`): causal, with lse;
//  - paddle_tpu/ops/attention.py `_flash_fwd_kernel` (launched in
//    `_flash_fwd_pallas`, wrapped by `flash_attention`): causal or full.
//    Its block_q/block_k of 256 and its d % 128 gate are TPU tiling, not
//    semantics, so one templated kernel serves both; each mode has its own
//    C entry so their launches are counted apart.
// Same function: O = softmax(Q K^T / sqrt(d)) V over k_pos <= q_pos
// (causal) or over every key (full), and lse = m + log(l), both from f32
// accumulators. Q, K and V are read in the projection's native
// [b, L, H, d] layout (any row stride, no transpose); O is written
// [b, L, H, d] and lse [b, H, L] (the full mode's TPU kernel saves no lse;
// this one writes it for the backward kernels).
//
// What bounds it on this card: a head does ~2 * d * L^2 causal flops
// against 4 * L * d elements moved, L / 4 flops per byte in bf16. At the
// served L = 1024 that sits right at the H100's ~295 flops/byte ridge, so
// bytes and tensor-core flops give about the same least time (~2.5 us for
// 16 heads); in f32 (67 TFLOP/s without tensor cores) operations bound it.
// The full mode does twice the causal flops, L / 2 per byte: at BERT's
// L = 128 that is far below the ridge, so bytes bound it there.
// This first kernel runs both products as scalar f32 FMAs out of shared
// memory (exact f32 accumulation for both input types, no TF32 rounding),
// so it is limited by shared-memory reads and FMA issue, far from either
// bound. Moving the two products onto wgmma is later work.
//
// Design (the TPU kernel's structure rethought for an SM):
//  - one block per (64-query tile, head, batch); the TPU grid's sequential
//    K loop becomes a loop inside the block, with the online-softmax
//    recurrence (running max m, running sum l, rescaled accumulator) in
//    registers, so the L x L scores never reach device memory;
//  - causal: the loop stops at the diagonal tile (upper-triangle tiles
//    are never issued) and tiles are launched longest-first to even out
//    the load; full: every block loops over all K tiles;
//  - Q (pre-scaled by 1/sqrt(d), in f32), the current K and V tiles and
//    the P tile live in shared memory as f32 with one word of padding per
//    row, so every inner-loop read is conflict-free;
//  - each of 128 threads owns 4 query rows (strided by 16) x 8 key columns
//    of S and the same 4 rows x d/8 columns of O: the row statistics are
//    reduced with three warp shuffles, and P is produced and consumed
//    inside one warp (no block barrier between softmax and P.V);
//  - ragged L is masked in the kernel (out-of-range keys score -1e30 and
//    out-of-range rows are not stored), which drops the TPU kernels'
//    L % 256 == 0 gate. In full mode nothing else hides the last K tile's
//    columns past L, so the k_pos < L test is what keeps them out.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile (== kBQ: diagonal tile == qt)
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * kBQ * (D + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int L, int H,
                 long long q_sb, long long q_sl, long long k_sb,
                 long long k_sl, long long v_sb, long long v_sl,
                 float scale) {
  constexpr int DP = D + 1;      // padded row of Q/K/V tiles
  constexpr int PP = kBK + 1;    // padded row of the P tile
  constexpr int DPT = D / 8;     // O columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * DP;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg + 16 * i
  const int cg = tid & 7;   // column group: S cols cg + 8 * c, O cols cg + 8 * e
  // causal: longest tiles first; full: every tile does the same work
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int nk = CAUSAL ? qt + 1 : (L + kBK - 1) / kBK;

  const T* qb = q + b * q_sb + (long long)h * D;
  const T* kb = k + b * k_sb + (long long)h * D;
  const T* vb = v + b * v_sb + (long long)h * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    const int l = q0 + r;
    Qs[r * DP + dd] = l < L ? to_f32(qb[l * q_sl + dd]) * scale : 0.f;
  }

  float m[4], lsum[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    lsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's readers of Ks/Vs are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, dd = idx % D;
      const int l = k0 + j;
      const bool in = l < L;
      Ks[j * DP + dd] = in ? to_f32(kb[l * k_sl + dd]) : 0.f;
      Vs[j * DP + dd] = in ? to_f32(vb[l * v_sl + dd]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg + 16 * i) * DP + dd];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = Ks[(cg + 8 * c) * DP + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + cg + 8 * c;
        if (kpos >= L || (CAUSAL && kpos > qpos)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      // the 8 threads sharing these rows are lanes 8*(rg%4) .. +7
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(s[i][c] - m_new);
        rs += p;
        Ps[(rg + 16 * i) * PP + cg + 8 * c] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      lsum[i] = lsum[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
    __syncwarp();  // this warp's P rows are complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg + 16 * i) * PP + j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float vv = Vs[j * DP + cg + 8 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
    __syncwarp();  // P is re-written by this warp in the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= L) continue;
    const float l = fmaxf(lsum[i], 1e-30f);
    const float inv = 1.f / l;
    T* orow = o + (((long long)b * L + row) * H + h) * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      orow[cg + 8 * e] = from_f32<T>(acc[i][e] * inv);
    if (cg == 0) lse[((long long)b * H + h) * L + row] = m[i] + logf(l);
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, long long q_sb,
                   long long q_sl, long long k_sb, long long k_sl,
                   long long v_sb, long long v_sl, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, q_sb, q_sl,
      k_sb, k_sl, v_sb, v_sl, scale);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int L, int H,
                       long long q_sb, long long q_sl, long long k_sb,
                       long long k_sl, long long v_sb, long long v_sl,
                       float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32, CAUSAL>(q, k, v, o, lse, B, L, H, q_sb,
                                          q_sl, k_sb, k_sl, v_sb, v_sl,
                                          scale, s);
    case 64: return launch<T, 64, CAUSAL>(q, k, v, o, lse, B, L, H, q_sb,
                                          q_sl, k_sb, k_sl, v_sb, v_sl,
                                          scale, s);
    case 128: return launch<T, 128, CAUSAL>(q, k, v, o, lse, B, L, H, q_sb,
                                            q_sl, k_sb, k_sl, v_sb, v_sl,
                                            scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool CAUSAL>
int entry(const void* q, const void* k, const void* v, void* o, void* lse,
          int B, int L, int H, int D, long long q_sb, long long q_sl,
          long long k_sb, long long k_sl, long long v_sb, long long v_sl,
          float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_d<float, CAUSAL>(D, q, k, v, o, lse_f, B, L, H,
                                          q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
                                          scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, CAUSAL>(D, q, k, v, o, lse_f, B, L,
                                                  H, q_sb, q_sl, k_sb, k_sl,
                                                  v_sb, v_sl, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements: element (b, l, h, d) of q is at
// q[b * q_sb + l * q_sl + h * D + d]. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = launched). `ptt_flash_attn_fwd` is causal,
// `ptt_flash_attn_fwd_full` attends to every key.
extern "C" int ptt_flash_attn_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int L, int H, int D, long long q_sb,
                                  long long q_sl, long long k_sb,
                                  long long k_sl, long long v_sb,
                                  long long v_sl, float scale, int dtype,
                                  void* stream) {
  return entry<true>(q, k, v, o, lse, B, L, H, D, q_sb, q_sl, k_sb, k_sl,
                     v_sb, v_sl, scale, dtype, stream);
}

extern "C" int ptt_flash_attn_fwd_full(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int L, int H, int D,
                                       long long q_sb, long long q_sl,
                                       long long k_sb, long long k_sl,
                                       long long v_sb, long long v_sl,
                                       float scale, int dtype,
                                       void* stream) {
  return entry<false>(q, k, v, o, lse, B, L, H, D, q_sb, q_sl, k_sb, k_sl,
                      v_sb, v_sl, scale, dtype, stream);
}
