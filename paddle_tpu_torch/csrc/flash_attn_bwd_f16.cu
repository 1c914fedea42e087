// The fp16 instances of the tensor-core flash-attention backward
// (`flash_dq_mma_kernel<__half, D, CAUSAL>` and
// `flash_dkv_mma_kernel<__half, D, CAUSAL>`, flash_bwd_mma.cuh) for D in
// {32, 64, 128}, causal and full, with the key bias: the same design and
// numerics as the bf16 instances (flash_attn_bwd.cu), with fp16 operands
// on `mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32` and P and dS
// rounded to fp16 as operands. Its own translation unit, so that nvcc
// builds it beside the bf16 one. Reached through the entries of
// flash_attn_bwd.cu with dtype 2.
#include "flash_bwd_mma.cuh"

namespace ptt_bwd {

cudaError_t launch_f16(bool dkv, const Args& a, int D, bool causal,
                       cudaStream_t s) {
  return dispatch_mma<__half>(dkv, a, D, causal, s);
}

}  // namespace ptt_bwd
