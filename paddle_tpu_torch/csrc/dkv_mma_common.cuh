// The dK/dV loop on the tensor cores, shared by two kernels:
//  - `flash_dkv_mma_kernel` (flash_attn_bwd.cu): dK/dV of the causal and
//    the full attention backward, with the key-padding bias, dK and dV
//    written [b, L, H, d] (replaces flash_tpu.py `_dkv_kernel` and the
//    dK/dV of attention.py's backward);
//  - `dkv_packed_mma_kernel` (dkv_packed.cu): the packed experiment's
//    causal dK/dV, with q * scale rounded to bf16 as the operand of S and
//    dK, and dV | dK written side by side into one [BH, L, 2d] buffer
//    (replaces tools/experiments/dkv_packed_kernel.py `dkv_kernel`).
//
// One block of 4 warps per (64-key tile, batch, head); each warp owns 16
// keys, whose K (and, at d <= 64, V) rows are A fragments in registers,
// loaded once (at d = 128 dK's and dV's accumulators take 128 registers,
// so V's fragments are re-read from shared memory per use). Q, dO, lse
// and delta of one 64-query tile are copied by 16-byte `cp.async` into a
// double buffer, one barrier per tile. The tile is cut into 16-query
// chunks of the transposed scores: S^T = K Q^T and dP^T = V dO^T (Q, dO
// via `ldmatrix`), P^T and dS^T in registers with lse and delta per query
// column, then dV += P^T dO and dK += dS^T Q (dO, Q via `ldmatrix.trans`),
// both A operands packed straight from the C fragments (`c_to_a`, rounded
// to the element type). The loop is a template over its 2-byte element
// type Elem: the causal and full kernels have a bf16 and an fp16 instance
// (the fp16 one rounds P and dS to fp16 as operands), the packed
// experiment a bf16 one. Causal: the loop starts at the diagonal tile, a
// warp skips chunks whose queries all precede its keys, and only chunks
// that cross the diagonal or reach past L are masked; the k tile is the
// slowest grid axis, with tile 0 (the longest) first. Rows past L are not
// stored.
//
// The two instances differ only where `PACKED` says, at compile time:
//  - S: unpacked, S = scale * (Q K^T) in f32 (the forward's convention),
//    so P = 2^(S^T c2 + bias log2 e - lse log2 e) with c2 = scale log2 e,
//    and dK is scaled at the end. Packed at d = 32 and 128 (`ROUND_Q`),
//    each thread multiplies the chunks of a Q tile that it copied itself
//    by scale and rounds them to bf16 in place, after `cp_async_wait` and
//    before the barrier that publishes the tile (no new barrier), so
//    S = bf16(q * scale) K^T and dK = dS^T bf16(q * scale) as the
//    reference computes them, c2 = log2 e and no scale at the end. At
//    d = 64 the scale is 2^-3: bf16(q * scale) is exact, and scaling S and
//    dK in f32 gives the same bits, so the packed instance skips that pass
//    there and runs the unpacked numerics;
//  - the output: unpacked, dK and dV at (((b L + row) H + h) d), each lane
//    storing its C fragments' bf16 pairs; packed (H = 1, b = the
//    batch-head), one [BH, L, 2d] buffer (`dv`; `dk` unused) with dV at
//    (b L + row) 2d and dK d further: after a barrier each warp stages its
//    16 rows of [dV | dK] in shared memory and stores them in 16-byte
//    chunks, which on an H100 took less time than storing the pairs;
//  - packed takes no key bias.
#pragma once

#include "mma_sm90.cuh"

namespace ptt_dkv {

using namespace ptt_mma;
using bf16 = __nv_bfloat16;

constexpr int kBN = 64;  // keys per K tile (dQ), queries per q tile (dK/dV)

struct Strides {  // element strides of the batch and row axes
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb, do_sl, o_sb, o_sl;
};

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, then Q and dO double-buffered (2-byte elements); lse and delta
  // double-buffered
  return (size_t)6 * kBN * smem_stride<D>() * 2 + 4 * kBN * sizeof(float);
}

// The block (b, h, key tile kt) of the dK/dV loop, in `smem_raw`
// (dkv_mma_smem_bytes<D>() bytes). Element (b, l, h, d) of q is at
// q[b * q_sb + l * q_sl + h * D + d]; lse and delta are f32 [b, H, L];
// key_bias is null or f32 [b, L] (unpacked only).
template <typename Elem, int D, bool CAUSAL, bool PACKED>
__device__ __forceinline__ void dkv_mma_body(
    unsigned char* smem_raw, const Elem* __restrict__ q,
    const Elem* __restrict__ k, const Elem* __restrict__ v,
    const Elem* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ key_bias,
    Elem* __restrict__ dk, Elem* __restrict__ dv, int L, int H, Strides st,
    float scale, int b, int h, int kt) {
  static_assert(!PACKED || CAUSAL, "the packed dK/dV is causal");
  constexpr int S = smem_stride<D>();
  constexpr int T = kBN * S;  // elements of one 64-row tile
  constexpr int KC = D / 16;
  constexpr int OB = D / 8;
  // V's A fragments stay in registers at d <= 64; at d = 128 the two
  // accumulators take 128 registers and V's fragments are re-read
  constexpr bool VREG = D <= 64;
  Elem* Ks = reinterpret_cast<Elem*>(smem_raw);
  Elem* Vs = Ks + T;
  Elem* Qs = Vs + T;       // buffers Qs, Qs + T
  Elem* dOs = Qs + 2 * T;  // buffers dOs, dOs + T
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * T);  // 2 x kBN
  float* dl_s = lse_s + 2 * kBN;                          // 2 x kBN

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = kt * kBN;
  const int kw = k0 + 16 * warp;  // this warp's first key
  const int nq = (L + kBN - 1) / kBN;
  const int qt0 = CAUSAL ? kt : 0;

  const Elem* qb = q + b * st.q_sb + (long long)h * D;
  const Elem* gb = dout + b * st.do_sb + (long long)h * D;
  const long long stat = ((long long)b * H + h) * L;

  // starts the copy of q tile qt's Q, dO, lse and delta into buffer buf
  auto load_q_tile = [&](int qt, int buf) {
    load_tile_async<D, kBN>(Qs + buf * T, qb, st.q_sl, qt * kBN, L);
    load_tile_async<D, kBN>(dOs + buf * T, gb, st.do_sl, qt * kBN, L);
    if (tid < kBN) {
      const int l = qt * kBN + tid;
      const bool in = l < L;
      cp_async4(smem_addr(lse_s + buf * kBN + tid), lse + stat + (in ? l : 0),
                in);
      cp_async4(smem_addr(dl_s + buf * kBN + tid),
                delta + stat + (in ? l : 0), in);
    }
  };
  load_tile_async<D, kBN>(Ks, k + b * st.k_sb + (long long)h * D, st.k_sl,
                          k0, L);
  load_tile_async<D, kBN>(Vs, v + b * st.v_sb + (long long)h * D, st.v_sl,
                          k0, L);
  load_q_tile(qt0, 0);
  cp_async_commit();

  float dka[OB][4], dva[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  float kb2[2];  // key bias * log2 e of keys kw + g and kw + g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kw + g + 8 * i;
    kb2[i] = !PACKED && key_bias != nullptr && kpos < L
                 ? __ldg(key_bias + (long long)b * L + kpos) * kLog2e : 0.f;
  }
  uint32_t kf[KC][4], vf[VREG ? KC : 1][4];  // K's and V's A fragments
  // packed: a pass over each Q tile rounds q * scale to bf16, unless the
  // scale is a power of two (of 32, 64 and 128, only 1/sqrt(64))
  constexpr bool ROUND_Q = PACKED && D != 64;
  const float c2 = ROUND_Q ? kLog2e : scale * kLog2e;

  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1;
    cp_async_wait<0>();
    // Q tile qt as bf16(q * scale), each thread on the chunks it copied,
    // before the barrier publishes them
    if constexpr (ROUND_Q) scale_own_chunks<D, kBN>(Qs + buf * T, scale);
    __syncthreads();
    if (qt + 1 < nq) {
      load_q_tile(qt + 1, buf ^ 1);
      cp_async_commit();
    }
    if (qt == qt0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldmatrix_x4(kf[kc], a_addr<S>(Ks, 16 * warp, kc * 16, lane));
        if constexpr (VREG)
          ldmatrix_x4(vf[kc], a_addr<S>(Vs, 16 * warp, kc * 16, lane));
      }
    }
    const Elem* Qt = Qs + buf * T;
    const Elem* dOt = dOs + buf * T;
    const float* lt = lse_s + buf * kBN;
    const float* dt = dl_s + buf * kBN;
    const int q0 = qt * kBN;

#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      const int qc0 = q0 + 16 * c;  // the chunk's first query
      if (qc0 >= L) break;
      // causal: every query of the chunk precedes this warp's keys
      if (CAUSAL && qc0 + 15 < kw) continue;
      // S^T = K Q^T and dP^T = V dO^T on 16 queries: st[j][e] is key
      // kw + g + 8(e >> 1), query qc0 + 8j + 2tig + (e & 1)
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qfr[4], ofr[4];
        ldmatrix_x4(qfr, b_addr<S>(Qt, 16 * c, kc * 16, lane));
        ldmatrix_x4(ofr, b_addr<S>(dOt, 16 * c, kc * 16, lane));
        mma<Elem>(sT[0], kf[kc], qfr[0], qfr[1]);
        mma<Elem>(sT[1], kf[kc], qfr[2], qfr[3]);
        if constexpr (VREG) {
          mma<Elem>(dpT[0], vf[kc], ofr[0], ofr[1]);
          mma<Elem>(dpT[1], vf[kc], ofr[2], ofr[3]);
        } else {
          uint32_t va[4];
          ldmatrix_x4(va, a_addr<S>(Vs, 16 * warp, kc * 16, lane));
          mma<Elem>(dpT[0], va, ofr[0], ofr[1]);
          mma<Elem>(dpT[1], va, ofr[2], ofr[3]);
        }
      }
      // P^T and dS^T with lse and delta per query column
      const bool edge = qc0 + 16 > L || (CAUSAL && qc0 < kw + 15);
      float pT[2][4], dsT[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * c + 8 * j + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          const float dq_ = (e & 1) ? d2.y : d2.x;
          float p = ex2_ftz(fmaf(sT[j][e], c2, kb2[e >> 1] - lq * kLog2e));
          if (edge) {
            const int qpos = q0 + col + (e & 1);
            const int kpos = kw + g + 8 * (e >> 1);
            if (qpos >= L || (CAUSAL && kpos > qpos)) p = 0.f;
          }
          pT[j][e] = p;
          dsT[j][e] = p * (dpT[j][e] - dq_);
        }
      }
      uint32_t pa[4], sa[4];  // rounded to Elem as A operands
      c_to_a<Elem>(pa, pT[0], pT[1]);
      c_to_a<Elem>(sa, dsT[0], dsT[1]);
      // dV += P^T dO, dK += dS^T Q: dO's and Q's 16 queries x 16 columns
      // as B operands, transposed
#pragma unroll
      for (int dc = 0; dc < KC; ++dc) {
        uint32_t ofr[4], qfr[4];
        ldmatrix_x4_trans(ofr, a_addr<S>(dOt, 16 * c, dc * 16, lane));
        ldmatrix_x4_trans(qfr, a_addr<S>(Qt, 16 * c, dc * 16, lane));
        mma<Elem>(dva[2 * dc], pa, ofr[0], ofr[1]);
        mma<Elem>(dva[2 * dc + 1], pa, ofr[2], ofr[3]);
        mma<Elem>(dka[2 * dc], sa, qfr[0], qfr[1]);
        mma<Elem>(dka[2 * dc + 1], sa, qfr[2], qfr[3]);
      }
    }
  }

  const float dk_scale = ROUND_Q ? 1.f : scale;  // else Q was scaled
  if constexpr (PACKED) {
    // a packed row is 2d contiguous elements: the warp stages its 16 rows
    // of [dV | dK] in shared memory (free once every warp is past the
    // loop), then each lane stores whole 16-byte chunks of them
    constexpr int SP = 2 * D + 8;  // staging row, padded as the tiles
    constexpr int CPR = 2 * D / 8;  // 16-byte chunks of a packed row
    __syncthreads();
    Elem* stage = reinterpret_cast<Elem*>(smem_raw) + warp * 16 * SP;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        Elem* r = stage + (g + 8 * i) * SP + 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(r) =
            pack2<Elem>(dva[j][2 * i], dva[j][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(r + D) =
            pack2<Elem>(dka[j][2 * i] * dk_scale,
                        dka[j][2 * i + 1] * dk_scale);
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * CPR / 32; ++i) {
      const int idx = lane + 32 * i;
      const int r = idx / CPR, c = idx % CPR;
      const int row = kw + r;
      if (row < L)
        *reinterpret_cast<uint4*>(dv + ((long long)b * L + row) * (2 * D) +
                                  8 * c) =
            *reinterpret_cast<const uint4*>(stage + r * SP + 8 * c);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = kw + g + 8 * i;
      if (row >= L) continue;
      const long long off = (((long long)b * L + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * tig) =
            pack2<Elem>(dka[j][2 * i] * dk_scale,
                        dka[j][2 * i + 1] * dk_scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * tig) =
            pack2<Elem>(dva[j][2 * i], dva[j][2 * i + 1]);
      }
    }
  }
}

}  // namespace ptt_dkv
