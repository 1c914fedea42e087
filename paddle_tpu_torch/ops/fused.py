"""Fused LayerNorm forward — counterpart of ``paddle_tpu.ops.fused``.

``fused_layer_norm`` launches the hand-written CUDA kernel
(``csrc/layer_norm.cu``, the port of the Pallas ``_ln_kernel``) for a
tensor on the card and runs the plain PyTorch version, ``_ln_reference``,
for a tensor on the CPU. There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

The backward kernel (``_ln_bwd_kernel``) and the fused Adam step come
with the training slice; the CUDA path here is forward-only and refuses
to run where autograd would need a gradient.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_layer_norm"]


def _ln_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm over the last axis: two-pass mean/variance in f32,
    the result cast back to ``x``'s dtype (the kernel's exact recipe)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` ([..., hidden]); ``weight``
    and ``bias`` are [hidden] in ``x``'s dtype. CUDA tensors (float32 or
    bfloat16, contiguous) go through the CUDA kernel, CPU tensors through
    ``_ln_reference``."""
    if x.device.type == "cpu":
        return _ln_reference(x, weight, bias, eps)
    hidden = x.shape[-1]
    _check_cuda_args(x, weight, bias, hidden)
    rows = x.numel() // hidden
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ptt_layer_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, hidden, float(eps), _build.DTYPE_CODES[x.dtype],
            _build.stream_of(x))
    _build.check(err, "layer_norm_fwd")
    fused_layer_norm.launches += 1
    return y


fused_layer_norm.launches = 0  # kernel launches, counted where they happen


def _check_cuda_args(x, weight, bias, hidden):
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_layer_norm: dtype {x.dtype} not supported "
                        "by the CUDA kernel (float32, bfloat16)")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"fused_layer_norm: {name} is {t.dtype} on "
                            f"{t.device}, x is {x.dtype} on {x.device}")
        if tuple(t.shape) != (hidden,) or not t.is_contiguous():
            raise ValueError(f"fused_layer_norm: {name} must be a contiguous "
                             f"[{hidden}] tensor, got {tuple(t.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise NotImplementedError(
            "fused_layer_norm: the CUDA kernel is forward-only; run under "
            "torch.no_grad() (the backward kernel comes with training)")
