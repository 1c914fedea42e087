"""``paddle_tpu_torch.quant`` — counterpart of ``paddle_tpu.quant``, its
KV-cache part: symmetric int8 quantization of K/V slabs for the paged
KV cache (``inference.serving.kv_cache``) and the straight-through
fake-quant. Quantization-aware training and post-training quantization
(``quant_aware``, ``PostTrainingQuantization``, the int8 layers) are not
ported yet.

The scale rule is the reference's: absmax over the reduced axes, floored
at 1e-8, over ``2 ** (bits - 1) - 1``; values round half to even
(``torch.round``, as ``jnp.round``) and clip to the int8 range.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_kv", "dequantize_kv", "quant_dequant"]


def _absmax_scale(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-tensor scale: ``max(|x|)`` floored at 1e-8, over the largest
    quantized value."""
    return torch.clamp_min(x.abs().max(), 1e-8) / (2 ** (bits - 1) - 1)


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """Symmetric int8 quantization of a K/V slab: one scale per
    (*leading, head) row, reduced over the trailing head_dim only.

    x: [..., H, D] → (int8 [..., H, D], float32 scales [..., H]). The 1e-8
    floor keeps an all-zero slab from writing a zero scale."""
    qmax = 2 ** (bits - 1) - 1
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / qmax
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax - 1, qmax)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: [..., H, D] int8 and [..., H]
    scales back to ``dtype``. The paged attention calls it one page pair
    at a time, so only the pages a step reads are widened."""
    return (q.float() * scale[..., None]).to(dtype)


def quant_dequant(x: torch.Tensor, scale, bits: int = 8) -> torch.Tensor:
    """Fake quantization with a straight-through gradient: the forward is
    ``clip(round(x / scale)) * scale``, the gradient flows through the
    affine part as if rounding were the identity."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    q = x / scale + (q - x / scale).detach()
    return q * scale
