"""Normalizations — counterpart of ``paddle_tpu.nn.functional.norm``:
``batch_norm`` (``_bn_stats``, ``_bn_manual``), ``layer_norm``,
``instance_norm``, ``group_norm`` and ``local_response_norm``.

``layer_norm`` over one trailing axis with a weight and a bias is the
LayerNorm kernel (``ops.fused.fused_layer_norm``: #5 forward, #6
backward on the card, their plain versions on the CPU), as
``nn.LayerNorm`` is; any other shape takes the reference's plain
two-pass path (mean, then the biased variance). ``instance_norm`` and
``group_norm`` are the reference's two-pass statistics over the spatial
axes (of each group of channels); ``local_response_norm`` divides by
``(k + alpha·Σx²)^beta`` over a window of ``size`` channels, as the
reference does (torch's divides ``alpha`` by ``size``, so it is not
used).

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
from ...ops import fused

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm"]


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


class _SyncBatchNormTrain(torch.autograd.Function):
    """``_BatchNormTrain`` with the statistics over a process group: the
    per-channel sums of x and x² and the counts are all-reduced before
    the one-pass mean and variance, and the backward all-reduces the
    channel sums of dy and dy·x̂, so that each rank's dx is the gradient
    of every rank's loss (the weight and bias gradients stay this rank's:
    the engines reduce them with the others)."""

    @staticmethod
    def forward(ctx, x, w, b, axes, shape, eps, pg):
        xf = x.float()
        c = w.numel()
        n = torch.full((1,), x.numel() // c, dtype=torch.float32,
                       device=x.device)
        stats = torch.cat([xf.sum(axes), (xf * xf).sum(axes), n])
        torch.distributed.all_reduce(stats, group=pg)
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        k = w.float() * rstd
        out = (xf * k.reshape(shape)
               + (b.float() - mean * k).reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, w, mean, rstd, n)
        ctx.axes, ctx.shape, ctx.pg = axes, shape, pg
        ctx.w_dtype, ctx.b_dtype = w.dtype, b.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, mean, rstd, n = ctx.saved_tensors
        axes, shape = ctx.axes, ctx.shape
        xh = (x.float() - mean.reshape(shape)) * rstd.reshape(shape)
        dyf = dy.float()
        db, dw = dyf.sum(axes), (dyf * xh).sum(axes)
        sums = torch.cat([db, dw])
        torch.distributed.all_reduce(sums, group=ctx.pg)
        c = db.numel()
        k = (w.float() * rstd).reshape(shape)
        dx = (k * (dyf - (sums[:c] / n).reshape(shape)
                   - xh * (sums[c:] / n).reshape(shape))).to(x.dtype)
        return (dx, dw.to(ctx.w_dtype), db.to(ctx.b_dtype), None, None,
                None, None)


def _data_group():
    """The process group of the innermost data-parallel scope of more
    than one rank (``distributed.parallel.data_parallel_scope``), or
    None."""
    from ...distributed.parallel import _data_scope

    if _data_scope and _data_scope[-1][0] is not None \
            and _data_scope[-1][1] > 1:
        return _data_scope[-1][0]
    return None


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
    missing ``weight`` or ``bias`` counts as 1 or 0. Inside a
    data-parallel scope of more than one rank (an engine's step over a
    mesh, ``SyncBatchNorm`` in a world) the statistics are the whole
    batch's, across the ranks (``_SyncBatchNormTrain``), as the
    reference's sharded program computes them."""
    ch, axes, shape = _layout(x, data_format)
    if training and not use_global_stats:
        c = x.shape[ch]
        w = weight if weight is not None else torch.ones(
            c, dtype=torch.float32, device=x.device)
        b = bias if bias is not None else torch.zeros(
            c, dtype=torch.float32, device=x.device)
        pg = _data_group()
        if pg is not None:
            out, mean, var = _SyncBatchNormTrain.apply(x, w, b, axes, shape,
                                                       epsilon, pg)
        else:
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


def _affine(out: torch.Tensor, weight, bias, shape) -> torch.Tensor:
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def _two_pass(x: torch.Tensor, axes):
    """``(x − mean, var)`` over ``axes``: the reference's ``jnp.mean``
    then ``jnp.var`` (biased)."""
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    return x - mean, var


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-05, name=None) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes. One axis
    with both a weight and a bias is the LayerNorm kernel
    (``fused_layer_norm``; its plain version on the CPU); otherwise the
    two-pass statistics of the reference's XLA path."""
    shape = ([int(normalized_shape)] if isinstance(normalized_shape, int)
             else [int(d) for d in normalized_shape])
    if len(shape) == 1 and weight is not None and bias is not None:
        return fused.fused_layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - len(shape), x.dim()))
    centred, var = _two_pass(x, axes)
    return _affine(centred * torch.rsqrt(var + epsilon), weight, bias,
                   shape)


def instance_norm(x: torch.Tensor, running_mean=None, running_var=None,
                  weight=None, bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, eps: float = 1e-05,
                  data_format: str = "NCHW", name=None) -> torch.Tensor:
    """Each sample's channels normalised over their spatial axes (the
    reference reads neither the running statistics nor
    ``use_input_stats``), then the per-channel affine."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = (tuple(range(2, x.dim())) if ch == 1
            else tuple(range(1, x.dim() - 1)))
    centred, var = _two_pass(x, axes)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return _affine(centred * torch.rsqrt(var + eps), weight, bias, shape)


def group_norm(x: torch.Tensor, num_groups: int, epsilon: float = 1e-05,
               weight=None, bias=None, data_format: str = "NCHW",
               name=None) -> torch.Tensor:
    """Each sample's channels in ``num_groups`` groups, each group
    normalised over its channels and spatial axes, then the per-channel
    affine; ``NHWC``-style formats are moved to channels-first and
    back."""
    last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if last else x
    c = a.shape[1]
    # the batch stays -1 and the way back is reshape_as: a recorded
    # program replays them at the fed batch size
    g = a.reshape(-1, num_groups, c // num_groups, *a.shape[2:])
    centred, var = _two_pass(g, tuple(range(2, g.dim())))
    out = (centred * torch.rsqrt(var + epsilon)).reshape_as(a)
    shape = [1] * a.dim()
    shape[1] = c
    out = _affine(out, weight, bias, shape)
    return out.movedim(1, -1) if last else out


def local_response_norm(x: torch.Tensor, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW", name=None
                        ) -> torch.Tensor:
    """``x / (k + alpha·Σ_window x²)^beta``, the window ``size`` channels
    wide (``size // 2`` before the channel, the rest after it, zeros past
    the ends)."""
    last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if last else x
    c, half = a.shape[1], size // 2
    pad = [0, 0] * (a.dim() - 2) + [half, size - half - 1]
    sq = torch.nn.functional.pad(a * a, pad)
    acc = torch.zeros_like(a)
    for i in range(size):
        acc = acc + sq.narrow(1, i, c)
    out = a / (k + alpha * acc) ** beta
    return out.movedim(1, -1) if last else out
