// Flash-attention backward for Hopper (sm_90a), causal or over all keys:
// dQ (with delta), then dK/dV.
//
// Replaces: paddle_tpu/ops/flash_tpu.py `_dq_kernel` and `_dkv_kernel`
// (launched by `pl.pallas_call` in `_flash_bwd_rule`), the causal mode;
// and the backward of paddle_tpu/ops/attention.py `flash_attention`
// (`_flash_bwd_rule`, autodiff through `blockwise_attention`), the full
// mode: the same math with only the mask changed. Each mode has its own C
// entries, so their launches are counted apart. Same function, from the
// forward's saved out and lse:
//   delta = rowsum(dO * O),
//   S = scale * Q K^T + bias (causal: k_pos <= q_pos),  P = exp(S - lse),
//   dS = P * (dO V^T - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO.
// Q, K, V, O and dO are read in the projection's native [b, L, H, d]
// layout (any row and batch stride, dense [H, d]); dQ, dK, dV are written
// [b, L, H, d]; lse and delta are f32 [b, H, L]. The full mode takes the
// forward's optional key-padding bias, f32 [b, L] (null: none), and adds
// it where it recomputes S; the bias itself gets no gradient.
//
// What bounds it on this card: the split recomputes S and dP in both
// kernels, so it does 7 L x L x d products over the pairs k <= q (S, dP,
// dS.K in dQ; S, dP, dS^T.Q, P^T.dO in dK/dV): 7 * 2 * d * L^2 / 2 flops
// per head, ~60 GFLOP at (8, 1024, 16, 64), 0.061 ms at 989 TFLOP/s in
// bf16, against ~0.02 ms for the bytes. Operations bound it (the full
// mode does each product over all L x L pairs, twice the causal work; at
// BERT's L = 128 the bytes come close).
//
// Why two kernels and not FlashAttention-2's one: FA2 runs one block per
// k tile that also adds its dS.K into dQ with f32 atomics, so dQ's sums
// land in a different order on every run. The split keeps the
// reference's deterministic structure (dQ owns a q tile, dK/dV a k tile,
// no atomics, bit-identical reruns) for the price of S and dP computed
// twice (7 products, not 5).
//
// Two kernel pairs, by input type:
//
// bf16: `flash_dq_mma_kernel` and `flash_dkv_mma_kernel`, on the tensor
// cores, as the forward's `flash_fwd_mma_kernel` (helpers in
// mma_sm90.cuh):
//  - every product is `mma.sync` m16n8k16, bf16 operands, f32
//    accumulators. Operands stay bf16 in padded shared memory (rows of
//    D + 8 elements, conflict-free `ldmatrix`), copied with 16-byte
//    `cp.async` into a double buffer: the next K/V (dQ) or Q/dO/lse/delta
//    (dK/dV) tile is in flight while this one is multiplied, one barrier
//    per tile. Rows past L read 0 (src-size 0);
//  - dQ: a block of 4 warps per (q tile, head, batch); each warp owns two
//    16-row slices at d <= 64 (128 query rows a block), so each K/V
//    fragment read from shared memory feeds two mma, and one at d = 128
//    (registers). Its Q and dO rows are loaded into A fragments once. The
//    K/V loop is cut into 16-key chunks: S = Q K^T and dP = dO V^T (K and
//    V via `ldmatrix`), then P and dS in registers, then dQ += dS K (K via
//    `ldmatrix.trans`), with dS packed from the C fragments straight into
//    the A operand. Only the chunk's scores are live, which leaves the
//    registers for the second slice;
//  - delta is computed in the dQ kernel: before the loop each lane sums
//    f32(dO) * f32(O) over its part of its rows (dO from its A fragments,
//    O read from device memory once), two shuffles finish each row, and
//    the f32 result is used and written to `delta` [b, H, L] for the
//    dK/dV kernel, launched after it on the same stream;
//  - dK/dV: a block of 4 warps per (k tile, head, batch); each warp owns
//    16 keys, whose K (and, at d <= 64, V) rows are A fragments in
//    registers (at d = 128 dK's and dV's accumulators take 128 registers,
//    so V's fragments are re-read from shared memory per use). The q loop
//    is cut into 16-query chunks of the transposed scores: S^T = K Q^T
//    and dP^T = V dO^T (Q, dO via `ldmatrix`), P^T and dS^T in registers
//    with lse and delta read per query column from shared memory, then
//    dV += P^T dO and dK += dS^T Q (dO, Q via `ldmatrix.trans`), both A
//    operands straight from registers. The loop is `dkv_mma_body` in
//    dkv_mma_common.cuh, which the packed dK/dV experiment (dkv_packed.cu)
//    instantiates too;
//  - numerics as the reference's `_dq_kernel` / `_dkv_kernel`: S is the
//    unscaled bf16 Q K^T accumulated in f32 and scaled in f32 (the
//    forward's convention, so exp(S - lse) matches its lse); P is rounded
//    to bf16 only as the P^T.dO operand (`flash_tpu.py:141`), dS only as
//    the dS.K and dS^T.Q operand (`:107`, `:146`); scale multiplies dQ
//    and dK in f32 at the end. (The reference also rounds q * scale to
//    bf16, which is exact at d = 64.) P = 2^(S * c + bias * log2 e -
//    lse * log2 e) is one FMA and one `ex2.approx.ftz`;
//  - causal: the q (dQ) or k (dK/dV) tile is the slowest grid axis,
//    longest blocks first (dQ: the last q tile; dK/dV: k tile 0). dQ stops
//    at the tile holding its last row and a warp skips chunks of keys
//    that all follow its rows; dK/dV starts at the diagonal tile and a
//    warp skips chunks of queries that all precede its keys. Only chunks
//    that cross the diagonal or reach past L are masked. Full: every
//    tile, and only a ragged last chunk is masked (k_pos < L, q_pos < L),
//    after the key bias is added. Rows past L are not stored.
//  cp.async needs 16-byte aligned rows: the wrapper raises on a q, k, v,
//  out or dout whose pointer or row/batch stride is not a multiple of 16
//  bytes.
//
// f32: `flash_dq_kernel` and `flash_dkv_kernel`, the original scalar
// kernels: every product as scalar f32 FMAs out of padded f32 shared
// memory, exact f32 with no TF32 or bf16 rounding, bit-identical to the
// plain version. They are the checking path (the f32 gradient parity
// runs), so they keep exact arithmetic rather than speed. They take delta
// as an input: for f32 the wrapper computes it (`_delta`) and passes it
// to both kernels.
#include "flash_bwd_mma.cuh"

namespace {

using namespace ptt_bwd;  // Args, the tensor-core kernels; ptt_dkv, ptt_mma

// ---------------------------------------------------------------------------
// f32: scalar kernels
// ---------------------------------------------------------------------------
constexpr int kB = 64;  // rows of a q tile == rows of a k tile

// Loads rows [r0, r0 + kB) of head h of a [b, L, H, D] operand into a
// padded f32 tile, times `mul`; rows past L are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long sl, int r0, int L,
                                          float mul) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    const int l = r0 + r;
    dst[r * DP + dd] = l < L ? src[l * sl + dd] * mul : 0.f;
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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ key_bias, float* __restrict__ dq,
                int L, int H, Strides st, float scale) {
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

  load_tile<D>(Qs, q + b * st.q_sb + (long long)h * D, st.q_sl, q0, L,
               scale);
  load_tile<D>(dOs, dout + b * st.do_sb + (long long)h * D, st.do_sl, q0,
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

  const float* kb = k + b * st.k_sb + (long long)h * D;
  const float* vb = v + b * st.v_sb + (long long)h * D;
  const float* bias = key_bias ? key_bias + (long long)b * L : nullptr;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // previous tile's readers of Ks/Vs are done
    load_tile<D>(Ks, kb, st.k_sl, k0, L, 1.f);
    load_tile<D>(Vs, vb, st.v_sl, k0, L, 1.f);
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
    float* out = dq + (((long long)b * L + row) * H + h) * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) out[cg + 8 * e] = acc[i][e] * scale;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ key_bias, float* __restrict__ dk,
                 float* __restrict__ dv, int L, int H, Strides st,
                 float scale) {
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

  load_tile<D>(Ks, k + b * st.k_sb + (long long)h * D, st.k_sl, k0, L, 1.f);
  load_tile<D>(Vs, v + b * st.v_sb + (long long)h * D, st.v_sl, k0, L, 1.f);

  float dka[4][DPT], dva[4][DPT], kbias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < DPT; ++e) dka[i][e] = dva[i][e] = 0.f;
    const int kpos = k0 + rg + 16 * i;  // this thread's key rows
    kbias[i] = key_bias != nullptr && kpos < L
                   ? key_bias[(long long)b * L + kpos] : 0.f;
  }

  const float* qb = q + b * st.q_sb + (long long)h * D;
  const float* ob = dout + b * st.do_sb + (long long)h * D;
  const long long stat = ((long long)b * H + h) * L;
  for (int qt = CAUSAL ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // previous tile's readers of Qs/dOs/stats are done
    load_tile<D>(Qs, qb, st.q_sl, q0, L, scale);
    load_tile<D>(dOs, ob, st.do_sl, q0, L, 1.f);
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
      dk[off + cg + 8 * e] = dka[i][e];
      dv[off + cg + 8 * e] = dva[i][e];
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_f32(bool dkv, const Args& a, cudaStream_t s) {
  const dim3 grid((a.L + kB - 1) / kB, a.H, a.B);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t e;
  if (dkv) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    if ((e = set_smem(flash_dkv_kernel<D, CAUSAL>, smem)) != cudaSuccess)
      return e;
    flash_dkv_kernel<D, CAUSAL><<<grid, kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, a.key_bias,
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.L, a.H,
        a.st, a.scale);
  } else {
    constexpr size_t smem = dq_smem_bytes<D>();
    if ((e = set_smem(flash_dq_kernel<D, CAUSAL>, smem)) != cudaSuccess)
      return e;
    flash_dq_kernel<D, CAUSAL><<<grid, kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, a.key_bias,
        static_cast<float*>(a.out0), a.L, a.H, a.st, a.scale);
  }
  return cudaGetLastError();
}

template <bool CAUSAL>
int entry(bool dkv, const Args& a, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.L <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  if (CAUSAL && a.key_bias != nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)dispatch_mma<__nv_bfloat16>(dkv, a, D, CAUSAL, s);
  if (dtype == 2) return (int)launch_f16(dkv, a, D, CAUSAL, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch_f32<32, CAUSAL>(dkv, a, s);
    case 64: return (int)launch_f32<64, CAUSAL>(dkv, a, s);
    case 128: return (int)launch_f32<128, CAUSAL>(dkv, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: element (b, l, h, d) of q is at
// q[b * q_sb + l * q_sl + h * D + d]; `do_*` are dout's, `o_*` out's.
// dQ/dK/dV are dense [B, L, H, D]. dtype: 0 = float32 (scalar kernels:
// dQ reads delta, out is unused), 1 = bfloat16, 2 = float16 (tensor-core
// kernels, every operand 16-byte aligned: dQ computes delta from out and
// dout and writes it). dK/dV reads delta in both (out unused, pass 0). key_bias: null, or
// the forward's f32 [B, L] key bias (`_full` entries only). Each entry
// makes one launch and returns a cudaError_t (0 = launched). The `_full`
// entries attend to every key, the others are causal.
#define PTT_BWD_ENTRY(NAME, CAUSAL, DKV)                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* o, const void* dout, const void* lse,       \
                      void* delta, const void* key_bias, void* out0,          \
                      void* out1, int B, int L, int H, int D, long long q_sb, \
                      long long q_sl, long long k_sb, long long k_sl,         \
                      long long v_sb, long long v_sl, long long do_sb,        \
                      long long do_sl, long long o_sb, long long o_sl,        \
                      float scale, int dtype, void* stream) {                 \
    const Args a{q, k, v, o, dout, static_cast<const float*>(lse),            \
                 static_cast<float*>(delta),                                  \
                 static_cast<const float*>(key_bias), out0, out1, B, L, H,    \
                 Strides{q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb, do_sl,    \
                         o_sb, o_sl},                                         \
                 scale};                                                      \
    return entry<CAUSAL>(DKV, a, D, dtype, stream);                           \
  }

// dQ: out0 = dq (out1 unused, pass 0); dK/dV: out0 = dk, out1 = dv
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dq, true, false)
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dkv, true, true)
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dq_full, false, false)
PTT_BWD_ENTRY(ptt_flash_attn_bwd_dkv_full, false, true)
