// Tensor-core helpers shared by the bf16 and fp16 attention kernels
// (flash_attn_fwd*.cu, flash_attn_bwd*.cu, dkv_mma_common.cuh): 16-byte
// cp.async tile copies into padded shared memory, ldmatrix, mma.sync
// m16n8k16 (bf16 or fp16 operands, f32 accumulators), 2^x and the
// packing of two floats into one register of the operand type. The
// copies and ldmatrix move only bytes: they take any 2-byte element type
// T (`__nv_bfloat16` or `__half`); `mma<T>`, `pack2<T>`, `unpack2<T>`,
// `c_to_a<T>` and `scale_own_chunks<T>` round or multiply in T.
//
// Fragment layouts of m16n8k16 (g = lane / 4, tig = lane % 4):
//  - A, 16 x 16, four registers of two 16-bit values: a[0] row g, cols 2tig and
//    2tig + 1; a[1] row g + 8, the same cols; a[2] row g, cols 2tig + 8
//    and 2tig + 9; a[3] row g + 8, those cols;
//  - B, 16 x 8: b0 rows 2tig, 2tig + 1 of col g; b1 rows 2tig + 8, + 9;
//  - C, 16 x 8 f32: c[0], c[1] row g, cols 2tig, 2tig + 1; c[2], c[3]
//    row g + 8, the same cols.
// Two C fragments side by side (cols 0-7 and 8-15) hold exactly the A
// fragment of the same 16 x 16 block, so a product's result feeds the
// next product as its A operand without leaving registers.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ptt_mma {

constexpr int kThreads = 128;  // 4 warps per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2-byte elements per shared row: D plus 16 bytes, so the 8 rows one
// ldmatrix phase reads start in 8 different 16-byte bank groups
template <int D>
__host__ __device__ constexpr int smem_stride() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src-size 0 (in == false) fills the 16 bytes with 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

// 4-byte async copy (one f32); src-size 0 fills it with 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// lane l supplies the address of row l % 8 of matrix l / 8; r[i] is this
// lane's part of matrix i (row g, cols 2tig and 2tig + 1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed: r[i] holds rows 2tig, 2tig + 1 of col g
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] * b[16x8], T operands (bf16 or fp16), f32
// accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (inputs below -126 give 0, as any p that
// small is to the softmax)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to T (round to nearest even, as torch's cast) in one
// register, lo at the lower address
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                               float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two T values of one register as floats
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t r);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t r) {
  return __half22float2(*reinterpret_cast<__half2*>(&r));
}

// The A fragment of the 16 x 16 block whose two 16 x 8 halves (cols 0-7,
// 8-15) are the C fragments c0 and c1, rounded to T.
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Starts the copy of rows [r0, r0 + ROWS) of one head of a [b, L, H, D]
// operand (row stride sl) into a padded shared tile; rows past L read 0.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long sl, int r0, int L) {
  static_assert(sizeof(T) == 2, "16-byte chunks of 8 two-byte values");
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int S = smem_stride<D>();
  static_assert(ROWS * CPR % kThreads == 0, "tile must split over threads");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / CPR, c = idx % CPR;
    const int l = r0 + r;
    const bool in = l < L;
    cp_async16(smem_addr(dst + r * S + c * 8),
               src + (in ? l : 0) * sl + c * 8, in);
  }
}

// Multiplies the 16-byte chunks of a tile that this thread copied with
// `load_tile_async<D, ROWS>` (the same thread-to-chunk map) by `mul`, each
// product rounded to T, in place. Call after `cp_async_wait` has landed
// them and before the barrier that publishes the tile: no other thread
// reads or writes these chunks in between.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void scale_own_chunks(T* tile, float mul) {
  constexpr int CPR = D / 8;
  constexpr int S = smem_stride<D>();
#pragma unroll
  for (int i = 0; i < ROWS * CPR / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    uint4* p = reinterpret_cast<uint4*>(tile + (idx / CPR) * S +
                                        (idx % CPR) * 8);
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack2<T>(w[e]);
      w[e] = pack2<T>(f.x * mul, f.y * mul);
    }
    *p = u;
  }
}

// ldmatrix addresses of a 16 x 16 block at (row0, col0) of a padded tile
// (row stride S elements), for this lane:
//  - `a_addr`: matrices rows 0-7 / 8-15 of cols 0-7, then of cols 8-15.
//    With `ldmatrix_x4` that is the block as an A operand; with
//    `ldmatrix_x4_trans` it is the block as the B operand of two n-blocks
//    (rows = the k index): r[0], r[1] are n-block 0 (cols 0-7), r[2],
//    r[3] n-block 1;
//  - `b_addr`: matrices rows 0-7 of cols 0-7, cols 8-15, then rows 8-15.
//    With `ldmatrix_x4` that is the block's transpose as a B operand (its
//    rows = the n index): r[0], r[1] are n-block 0 (rows 0-7), r[2], r[3]
//    n-block 1.
template <int S, typename T>
__device__ __forceinline__ uint32_t a_addr(const T* tile,
                                           int row0, int col0, int lane) {
  const int lrow = lane & 7, lmat = lane >> 3;
  return smem_addr(tile + (row0 + lrow + (lmat & 1) * 8) * S + col0 +
                   (lmat >> 1) * 8);
}

template <int S, typename T>
__device__ __forceinline__ uint32_t b_addr(const T* tile,
                                           int row0, int col0, int lane) {
  const int lrow = lane & 7, lmat = lane >> 3;
  return smem_addr(tile + (row0 + lrow + (lmat >> 1) * 8) * S + col0 +
                   (lmat & 1) * 8);
}

}  // namespace ptt_mma
