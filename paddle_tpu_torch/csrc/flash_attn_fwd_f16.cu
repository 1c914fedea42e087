// The fp16 instance of the tensor-core flash-attention forward
// (`flash_fwd_mma_kernel<__half, D, CAUSAL>`, flash_fwd_mma.cuh) for
// D in {32, 64, 128}, causal and full, with the key bias: the same design
// and numerics as the bf16 instance (flash_attn_fwd.cu), with fp16
// operands on `mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32` and P
// rounded to fp16 as the P.V operand. Its own translation unit, so that
// nvcc builds it beside the bf16 one. Reached through the entries of
// flash_attn_fwd.cu with dtype 2.
#include "flash_fwd_mma.cuh"

namespace ptt_fwd {

cudaError_t launch_f16(const Args& a, int D, bool causal, cudaStream_t s) {
  return dispatch_mma<__half>(a, D, causal, s);
}

}  // namespace ptt_fwd
