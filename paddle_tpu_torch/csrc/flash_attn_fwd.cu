// Flash-attention forward for Hopper (sm_90a), causal or over all keys.
//
// Replaces two TPU kernels that differ only in the mask:
//  - paddle_tpu/ops/flash_tpu.py `_fwd_kernel` (launched by `pl.pallas_call`
//    in `_fwd_call`, wrapped by `flash_attention_blhd`): causal, with lse;
//  - paddle_tpu/ops/attention.py `_flash_fwd_kernel` (launched in
//    `_flash_fwd_pallas`, wrapped by `flash_attention`): causal or full.
//    Its block_q/block_k of 256 and its d % 128 gate are TPU tiling, not
//    semantics, so one pair of kernels serves both; each mode has its own
//    C entry so their launches are counted apart.
// Same function: O = softmax(Q K^T / sqrt(d) + bias) V over k_pos <= q_pos
// (causal) or over every key (full), and lse = m + log(l), both from f32
// accumulators. The full mode optionally takes a key-padding bias, f32
// [b, L] (BERT's attention mask as the reference's -1e9 additive bias,
// which `blockwise_attention` adds to the scaled scores before the
// k_pos < L mask). Q, K and V are read in the projection's native
// [b, L, H, d] layout (any row stride, no transpose); O is written
// [b, L, H, d] and lse [b, H, L] (the full mode's TPU kernel saves no lse;
// this one writes it for the backward kernels).
//
// What bounds it on this card: a head does ~2 * d * L^2 causal flops
// against 4 * L * d elements moved, L / 4 flops per byte in bf16. At the
// trained L = 1024 that sits right at the H100's ~295 flops/byte ridge,
// so bytes and tensor-core flops give about the same least time (~0.02
// ms at (8, 1024, 16, 64)). The full mode does twice the causal flops,
// L / 2 per byte: at BERT's L = 128 that is far below the ridge, so bytes
// bound it there. In f32 (67 TFLOP/s without tensor cores) operations
// bound it.
//
// Two kernels, by input type:
//
// bf16: `flash_fwd_mma_kernel`, the FlashAttention-2 structure on the
// tensor cores. The scalar kernel below, which bf16 also ran until this
// one, took 30x the card's own attention (SDPA) at GPT-2 345M's training
// shape: f32 FMAs out of f32 shared memory, 2-byte loads, no overlap of
// loads and products. This one:
//  - products on `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
//    (f32 accumulation). Not `wgmma`: its 64-row warpgroup tiles, shared-
//    memory descriptors and async fences are a larger design than could
//    be checked without a profiler on the card; mma.sync already brings
//    the causal forward to ~1.3x SDPA, and `wgmma` is the next step;
//  - a block of 4 warps per (q tile, head, batch). At d <= 64 each warp
//    owns two 16-row slices (128 query rows a block), so every K and V
//    fragment read from shared memory feeds two mma: with one slice,
//    shared-memory reads bound it. At d = 128 one slice (64 rows): two
//    slices' accumulators do not fit in registers;
//  - the TPU grid's sequential K loop is a loop inside the block over
//    64-key tiles, with the online softmax (running max m, sum l,
//    rescaled accumulator) in registers on the mma accumulator
//    fragments; a row's max and sum are reduced over its quad of lanes
//    with two shuffles;
//  - Q, K and V stay bf16 in shared memory (no f32 widening), rows padded
//    by 16 bytes so each 8-row `ldmatrix` (`.trans` for V) touches every
//    bank once; Q's fragments are loaded to registers once per block;
//  - K/V tiles are copied with 16-byte `cp.async` into a double buffer:
//    tile j + 1 is in flight while tile j is multiplied, with one barrier
//    per tile. Rows at or past L are zero-filled (src-size 0);
//  - P goes from the S accumulator straight into the A operand of P.V in
//    registers (the m16n8 C-fragment layout is the m16n8k16 A-fragment
//    layout): it never touches shared memory;
//  - the softmax spends as few instructions per score as it can, since
//    they issue between the mma: the scale (with log2 e) is applied
//    inside the exponent's FMA, p = 2^(s * c - m * c), 2^x is one
//    `ex2.approx.ftz`, and masks run only on a tile that needs them;
//  - numerics as the reference's `_fwd_kernel`: S accumulates the
//    products of the unscaled bf16 q and k in f32; the scale is applied
//    to that f32 value (with a bias: the bias is added to the scaled
//    score); l sums the unrounded f32 p; p is rounded to bf16 only as the
//    P.V operand (`flash_tpu.py:66-67` feeds the MXU bf16 P); the output
//    is rounded once and lse is the natural-log f32 value the backward
//    reads. q is never rounded after scaling, so the backward's S, which
//    it recomputes from the f32 q * scale, matches this lse;
//  - causal: the q tile is the slowest grid axis and runs longest first,
//    so the longest blocks start first over all heads; the loop stops at
//    the tile holding the block's last row (tiles above the diagonal are
//    never issued), a warp skips a tile whose keys all follow its rows,
//    and the mask runs on the diagonal tiles only. Full: every block
//    loops over all K tiles and only a ragged last tile tests k_pos < L,
//    which is what hides its columns past L. Rows past L are not stored.
//  cp.async needs 16-byte aligned rows: the wrapper raises on a q, k or v
//  whose pointer or row/batch stride is not a multiple of 16 bytes.
//
// f32: `flash_fwd_kernel`, the original scalar kernel: both products as
// scalar f32 FMAs out of padded f32 shared memory, exact f32 accumulation
// with no TF32 rounding. f32 is the checking path (the served tokens' equality
// with the dense reference, the f32 gradient parity runs), so it keeps
// exact arithmetic rather than speed.
#include "flash_fwd_mma.cuh"

namespace {

using namespace ptt_fwd;  // Args, kNegInf, the tensor-core kernel; ptt_mma

// ---------------------------------------------------------------------------
// f32: scalar kernel
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile (== kBQ: diagonal tile == qt)

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * kBQ * (D + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ key_bias,
                 int L, int H, long long q_sb, long long q_sl, long long k_sb,
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

  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)h * D;
  const float* vb = v + b * v_sb + (long long)h * D;
  const float* bias = key_bias ? key_bias + (long long)b * L : nullptr;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    const int l = q0 + r;
    Qs[r * DP + dd] = l < L ? qb[l * q_sl + dd] * scale : 0.f;
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
      Ks[j * DP + dd] = in ? kb[l * k_sl + dd] : 0.f;
      Vs[j * DP + dd] = in ? vb[l * v_sl + dd] : 0.f;
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
    float kbias[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int kpos = k0 + cg + 8 * c;
      kbias[c] = bias != nullptr && kpos < L ? bias[kpos] : 0.f;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + cg + 8 * c;
        s[i][c] += kbias[c];
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
    float* orow = o + (((long long)b * L + row) * H + h) * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) orow[cg + 8 * e] = acc[i][e] * inv;
    if (cg == 0) lse[((long long)b * H + h) * L + row] = m[i] + logf(l);
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.key_bias, a.L, a.H, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl,
      a.scale);
  return cudaGetLastError();
}

template <bool CAUSAL>
int entry(const Args& a, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.L <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  if (CAUSAL && a.key_bias != nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)dispatch_mma<__nv_bfloat16>(a, D, CAUSAL, s);
  if (dtype == 2) return (int)launch_f16(a, D, CAUSAL, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch_f32<32, CAUSAL>(a, s);
    case 64: return (int)launch_f32<64, CAUSAL>(a, s);
    case 128: return (int)launch_f32<128, CAUSAL>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: element (b, l, h, d) of q is at
// q[b * q_sb + l * q_sl + h * D + d]. dtype: 0 = float32 (scalar kernel),
// 1 = bfloat16, 2 = float16 (tensor-core kernel; q, k, v 16-byte
// aligned). key_bias:
// null, or f32 [B, L] added to the scaled scores (full mode only).
// Returns a cudaError_t (0 = launched). `ptt_flash_attn_fwd` is causal,
// `ptt_flash_attn_fwd_full` attends to every key.
#define PTT_FWD_ENTRY(NAME, CAUSAL)                                           \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      void* lse, const void* key_bias, int B, int L, int H,   \
                      int D, long long q_sb, long long q_sl, long long k_sb,  \
                      long long k_sl, long long v_sb, long long v_sl,         \
                      float scale, int dtype, void* stream) {                 \
    const Args a{q,    k,    v,    o,    static_cast<float*>(lse),            \
                 static_cast<const float*>(key_bias), B, L, H, q_sb, q_sl,    \
                 k_sb, k_sl, v_sb, v_sl, scale};                              \
    return entry<CAUSAL>(a, D, dtype, stream);                                \
  }

PTT_FWD_ENTRY(ptt_flash_attn_fwd, true)
PTT_FWD_ENTRY(ptt_flash_attn_fwd_full, false)
