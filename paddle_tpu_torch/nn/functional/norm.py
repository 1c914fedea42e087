"""Batch normalization — counterpart of
``paddle_tpu.nn.functional.norm.batch_norm`` (``_bn_stats``,
``_bn_manual``).

The reference computes it in XLA, with no Pallas kernel, so plain PyTorch
is the port: a ``torch.autograd.Function`` that mirrors ``_bn_manual``.

- Batch statistics in f32 from one pass: ``var = max(E[x²] − E[x]², 0)``,
  biased (``F.batch_norm(training=True)`` is not used: its running
  variance is unbiased, the reference's is not).
- The forward folds the normalisation and the affine into one per-channel
  scale ``k = w·rstd`` and shift ``c = b − mean·k``, and returns the
  output in the input's dtype (a bf16 activation comes out bf16, its
  statistics taken in f32).
- The backward takes ``db = Σ dy`` and ``dw = Σ dy·x̂`` (x̂ recomputed from
  the saved statistics) and centres with them:
  ``dx = k·(dy − db/n − x̂·dw/n)``.
- Running statistics: ``r = m·r + (1 − m)·batch`` with the reference's
  ``momentum`` (0.9 by default), computed in the buffer's own dtype, in
  place.

In eval mode, or with ``use_global_stats``, the running statistics
normalise: ``(x − mean)·rsqrt(var + eps)·w + b``, in the dtypes torch's
promotion gives (as the reference's does: a bf16 input over f32 statistics
comes out f32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.recording import record_opaque

__all__ = ["batch_norm"]


def _layout(x: torch.Tensor, data_format: str) -> Tuple[int, tuple, list]:
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return ch, axes, shape


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode affine BatchNorm: ``(out, mean, var)``; the batch
    statistics (f32, for the running update) carry no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, axes, shape, eps):
        xf = x.float()
        n = x.numel() // w.numel()  # values per channel
        mean = xf.sum(axes) / n
        var = torch.clamp((xf * xf).sum(axes) / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        k = w.float() * rstd
        c = b.float() - mean * k
        out = (xf * k.reshape(shape) + c.reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, w, mean, rstd)
        ctx.axes, ctx.shape, ctx.n = axes, shape, n
        ctx.w_dtype, ctx.b_dtype = w.dtype, b.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, mean, rstd = ctx.saved_tensors
        axes, shape, n = ctx.axes, ctx.shape, ctx.n
        xh = (x.float() - mean.reshape(shape)) * rstd.reshape(shape)
        dyf = dy.float()
        db = dyf.sum(axes)
        dw = (dyf * xh).sum(axes)
        k = (w.float() * rstd).reshape(shape)
        dx = (k * (dyf - (db / n).reshape(shape)
                   - xh * (dw / n).reshape(shape))).to(x.dtype)
        return (dx, dw.to(ctx.w_dtype), db.to(ctx.b_dtype), None, None,
                None)


def batch_norm(x: torch.Tensor, running_mean: Optional[torch.Tensor],
               running_var: Optional[torch.Tensor],
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, training: bool = False,
               momentum: float = 0.9, epsilon: float = 1e-05,
               data_format: str = "NCHW", use_global_stats=None,
               name=None) -> torch.Tensor:
    """BatchNorm over every axis but the channel one (axis 1 for
    ``NC*`` formats, the last otherwise). In training (unless
    ``use_global_stats``) it normalises with the batch statistics and
    updates ``running_mean`` / ``running_var`` in place when given; a
    missing ``weight`` or ``bias`` counts as 1 or 0."""
    ch, axes, shape = _layout(x, data_format)
    if training and not use_global_stats:
        c = x.shape[ch]
        w = weight if weight is not None else torch.ones(
            c, dtype=torch.float32, device=x.device)
        b = bias if bias is not None else torch.zeros(
            c, dtype=torch.float32, device=x.device)
        out, mean, var = record_opaque(_BatchNormTrain.apply, x, w, b,
                                       axes, shape, epsilon)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.copy_(momentum * running_mean + (1.0 - momentum)
                                   * mean.to(running_mean.dtype))
                running_var.copy_(momentum * running_var + (1.0 - momentum)
                                  * var.to(running_var.dtype))
        return out
    out = (x - running_mean.reshape(shape)) * torch.rsqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out
