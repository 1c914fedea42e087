"""Common functionals — counterpart of ``paddle_tpu.nn.functional.common``:
``linear``, the dropouts, ``embedding``, ``one_hot``, ``label_smooth``,
``pad``, ``interpolate``/``upsample``, ``normalize``,
``cosine_similarity``, the pixel and channel shuffles, ``unfold``,
``fold``, ``bilinear`` and ``diag_embed``.

The reference's are XLA-level code with no Pallas kernel, so these are
plain PyTorch with the reference's arithmetic and layouts:

- ``linear`` keeps the [in, out] weight (``x @ W + b``) and is on the AMP
  white list (``amp.auto_cast`` casts ``x`` and the weight).
- The dropouts draw their masks from an explicit ``torch.Generator`` on
  the input's device (``generator=``), never from torch's global RNG; a
  call that would draw without one raises. The reference draws from its
  JAX key, so masks do not cross between the packages.
- ``embedding`` multiplies its OUTPUT by ``ids != padding_idx`` as the
  reference does (torch's ``padding_idx`` alone keeps the row's values in
  the forward); ``sparse=True`` gives the weight a row-sparse gradient
  (``core.selected_rows``), which leaves the padding lookups out.
- ``interpolate``'s nearest mode is the reference's floor index, its
  ``align_corners`` linear mode the reference's per-axis blend, and the
  linear and cubic modes without it compute ``jax.image.resize``'s
  weight matrices (half-pixel centres, Keys' cubic, a widened kernel when
  downsampling) and contract each axis with them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ...amp.auto_cast import maybe_cast_inputs

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "label_smooth", "pad", "interpolate", "upsample",
    "normalize", "cosine_similarity", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "unfold", "fold", "bilinear", "diag_embed",
]


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
           name=None) -> torch.Tensor:
    """``x @ weight + bias`` with the reference's [in, out] weight."""
    x, weight = maybe_cast_inputs("linear", x, weight)
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return TF.linear(x, weight.t(), bias)


# -- dropout -----------------------------------------------------------------
def _keep_mask(shape, p: float, x: torch.Tensor,
               generator: Optional[torch.Generator], fn: str
               ) -> torch.Tensor:
    if generator is None:
        raise ValueError(f"{fn}: pass generator= (a torch.Generator on "
                         f"{x.device}); the port never draws from torch's "
                         "global RNG")
    return torch.empty(shape, device=x.device).bernoulli_(
        1.0 - p, generator=generator)


def dropout(x: torch.Tensor, p: float = 0.5, axis=None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, *, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """The reference's dropout: in training each element (or, with
    ``axis``, each slice along the axes named) is kept with probability
    ``1 - p``, scaled by ``1/(1 - p)`` in ``upscale_in_train`` mode and not
    at all in ``downscale_in_infer`` mode, which scales by ``1 - p`` at
    inference instead."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = _keep_mask(shape, p, x, generator, "dropout").to(x.dtype)
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator=None):
    """Whole channels of [N, C, H, W] (or NHWC) dropped together."""
    ch_axis = 1 if data_format == "NCHW" else 3
    return dropout(x, p, axis=[0, ch_axis], training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator=None):
    """Whole channels of [N, C, D, H, W] (or NDHWC) dropped together."""
    ch_axis = 1 if data_format == "NCDHW" else 4
    return dropout(x, p, axis=[0, ch_axis], training=training,
                   generator=generator)


def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """SELU's dropout: a dropped element becomes the SELU's negative
    saturation, and an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    alpha_p = -alpha * scale
    keep = _keep_mask(tuple(x.shape), p, x, generator, "alpha_dropout")
    a_coef = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b_coef = -a_coef * p * alpha_p
    m = keep.to(x.dtype)
    return a_coef * (x * m + alpha_p * (1 - m)) + b_coef


# -- lookups and labels ------------------------------------------------------
def embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None,
              sparse: bool = False, name=None) -> torch.Tensor:
    """Rows ``weight[x]``; where ``x == padding_idx`` (given and >= 0) the
    output is 0, as the reference multiplies it by the mask. With
    ``sparse`` the weight's gradient is row-sparse: only the looked-up
    rows, padding lookups left out."""
    ids = x.long()
    pad = padding_idx if padding_idx is not None and padding_idx >= 0 \
        else None
    out = TF.embedding(ids, weight, padding_idx=pad, sparse=sparse)
    if pad is not None:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return out


def one_hot(x: torch.Tensor, num_classes: int, name=None) -> torch.Tensor:
    """f32 one-hot rows (the reference's default dtype)."""
    return TF.one_hot(x.long(), num_classes).to(torch.float32)


def label_smooth(label: torch.Tensor, prior_dist=None, epsilon=0.1,
                 name=None) -> torch.Tensor:
    """``(1 - epsilon) · label + epsilon · prior`` (a uniform prior over
    the last axis unless ``prior_dist`` is given)."""
    if prior_dist is not None:
        pd = torch.as_tensor(prior_dist, dtype=label.dtype,
                             device=label.device)
        return (1.0 - epsilon) * label + epsilon * pd
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


# -- shapes ------------------------------------------------------------------
def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each position of a dim of size n padded by (lo, hi)
    in ``mode`` (jnp.pad's reflect, edge and wrap)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    period = 2 * (n - 1)  # reflect: mirrored about the edges, not repeated
    if period == 0:
        return torch.zeros_like(i)
    i = i.remainder(period)
    return torch.where(i < n, i, period - i)


def pad(x: torch.Tensor, pad, mode: str = "constant", value: float = 0.0,
        data_format: str = "NCHW", name=None) -> torch.Tensor:
    """The reference's ``pad``: ``2·ndim`` values pad every dim in order;
    fewer pad the trailing spatial dims from the last inward
    ([left, right, top, bottom] pads W, then H), the last dims of an NC*
    layout or the ones before the channels of an N*C layout. ``mode`` is
    constant, reflect, replicate or circular."""
    p = [int(v) for v in (pad.tolist() if isinstance(pad, torch.Tensor)
                          else pad)]
    nd = x.dim()
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        width = [(0, 0)] * nd
        first = nd - 1 if data_format.startswith("NC") else nd - 2
        for j in range(len(p) // 2):
            width[first - j] = (p[2 * j], p[2 * j + 1])
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    if mode == "constant":
        flat = [v for lo_hi in reversed(width) for v in lo_hi]
        return TF.pad(x, flat, mode="constant", value=value)
    out = x
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            out = out.index_select(d, _pad_index(out.shape[d], lo, hi, mode,
                                                 x.device))
    return out


def _spatial_axes(x: torch.Tensor, data_format: str) -> list:
    return (list(range(2, x.dim())) if data_format.startswith("NC")
            else list(range(1, x.dim() - 1)))


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1 - x.abs()).clamp(min=0)


def _resize_weights(in_size: int, out_size: int, kernel, device
                    ) -> torch.Tensor:
    """``jax.image.resize``'s [in, out] weight matrix of one axis (scale
    out/in, no translation, antialiased), in f64."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float64, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _contract(x: torch.Tensor, axis: int, w: torch.Tensor) -> torch.Tensor:
    """``x`` with ``axis`` (size in) replaced by ``w``'s out axis."""
    moved = x.movedim(axis, -1)
    return (moved @ w.to(x.dtype)).movedim(-1, axis)


def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest", align_corners: bool = False,
                align_mode: int = 0, data_format: str = "NCHW",
                name=None) -> torch.Tensor:
    """Resize the spatial axes to ``size`` (or ``floor(in · scale)``):
    ``nearest`` (source index ``floor(i · in/out)``), ``linear``/
    ``bilinear``/``trilinear`` (and ``area``, as the reference maps it)
    and ``bicubic``; ``align_corners`` blends linearly between the corner-
    aligned neighbours in every linear mode, as the reference does."""
    axes = _spatial_axes(x, data_format)
    spatial = [x.shape[a] for a in axes]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    else:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        size = [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                for s in size]
    method = {"nearest": "nearest", "bilinear": "linear",
              "trilinear": "linear", "linear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode.lower()]
    out = x
    for a, n_out in zip(axes, size):
        n_in = out.shape[a]
        if method == "nearest":
            idx = torch.floor(torch.arange(n_out, dtype=torch.float64)
                              * (n_in / n_out)).long().clamp(0, n_in - 1)
            out = out.index_select(a, idx.to(x.device))
        elif align_corners:
            pos = (torch.zeros(n_out, dtype=torch.float64)
                   if n_out == 1 or n_in == 1 else
                   torch.arange(n_out, dtype=torch.float64)
                   * ((n_in - 1) / (n_out - 1)))
            lo = torch.floor(pos).long()
            hi = (lo + 1).clamp(0, n_in - 1)
            shape = [1] * out.dim()
            shape[a] = n_out
            w = (pos - lo).to(device=x.device, dtype=out.dtype).reshape(shape)
            out = (out.index_select(a, lo.to(x.device)) * (1 - w)
                   + out.index_select(a, hi.to(x.device)) * w)
        elif n_in != n_out:  # jax.image.resize leaves equal sizes alone
            kernel = _keys_cubic if method == "cubic" else _triangle
            out = _contract(out, a, _resize_weights(n_in, n_out, kernel,
                                                    x.device))
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def normalize(x: torch.Tensor, p=2, axis: int = 1, epsilon: float = 1e-12,
              name=None) -> torch.Tensor:
    """``x / max(‖x‖_p, epsilon)`` along ``axis``."""
    nrm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / nrm.clamp(min=epsilon)


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, axis: int = 1,
                      eps: float = 1e-8, name=None) -> torch.Tensor:
    """``x1·x2 / max(‖x1‖·‖x2‖, eps)`` along ``axis``."""
    dot = (x1 * x2).sum(dim=axis)
    na = (x1 * x1).sum(dim=axis).sqrt()
    nb = (x2 * x2).sum(dim=axis).sqrt()
    return dot / (na * nb).clamp(min=eps)


def pixel_shuffle(x: torch.Tensor, upscale_factor: int,
                  data_format: str = "NCHW", name=None) -> torch.Tensor:
    r = int(upscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        oc = c // (r * r)
        return (x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
                .reshape(n, oc, h * r, w * r))
    n, h, w, c = x.shape
    oc = c // (r * r)
    return (x.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h * r, w * r, oc))


def pixel_unshuffle(x: torch.Tensor, downscale_factor: int,
                    data_format: str = "NCHW", name=None) -> torch.Tensor:
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        oh, ow = h // r, w // r
        return (x.reshape(n, c, oh, r, ow, r).permute(0, 1, 3, 5, 2, 4)
                .reshape(n, c * r * r, oh, ow))
    n, h, w, c = x.shape
    oh, ow = h // r, w // r
    return (x.reshape(n, oh, r, ow, r, c).permute(0, 2, 4, 5, 1, 3)
            .reshape(n, oh, ow, c * r * r))


def channel_shuffle(x: torch.Tensor, groups: int, data_format: str = "NCHW",
                    name=None) -> torch.Tensor:
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return (x.reshape(n, groups, c // groups, h, w)
                .permute(0, 2, 1, 3, 4).reshape(n, c, h, w))
    n, h, w, c = x.shape
    return (x.reshape(n, h, w, groups, c // groups)
            .permute(0, 1, 2, 4, 3).reshape(n, h, w, c))


def _pair(v) -> list:
    return [v] * 2 if isinstance(v, int) else list(v)


def _pads4(paddings) -> list:
    """[top, bottom, left, right] from an int, a pair or four values."""
    pd = _pair(paddings)
    return [pd[0], pd[0], pd[1], pd[1]] if len(pd) == 2 else pd


def unfold(x: torch.Tensor, kernel_sizes, strides=1, paddings=0,
           dilations=1, name=None) -> torch.Tensor:
    """Sliding [c·kh·kw] patches of [N, C, H, W] as [N, c·kh·kw, L]
    (channel-major, as the reference's conv patches); ``paddings`` is an
    int, (h, w) or (top, bottom, left, right)."""
    pd = _pads4(paddings)
    x = TF.pad(x, [pd[2], pd[3], pd[0], pd[1]])
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))


def fold(x: torch.Tensor, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1, name=None) -> torch.Tensor:
    """``unfold``'s adjoint: [N, c·kh·kw, L] patches summed into
    [N, C, H, W] (``output_sizes``), the padding cut away."""
    os_, pd = _pair(output_sizes), _pads4(paddings)
    full = [os_[0] + pd[0] + pd[1], os_[1] + pd[2] + pd[3]]
    out = TF.fold(x, full, _pair(kernel_sizes), dilation=_pair(dilations),
                  stride=_pair(strides))
    return out[:, :, pd[0]:full[0] - pd[1], pd[2]:full[1] - pd[3]]


def bilinear(x1: torch.Tensor, x2: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    """``out[b, o] = x1[b] · weight[o] · x2[b] + bias[o]`` (weight [out,
    in1, in2])."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out + bias if bias is not None else out


def diag_embed(input: torch.Tensor, offset: int = 0, dim1: int = -2,
               dim2: int = -1) -> torch.Tensor:
    """Batched matrices with ``input``'s last axis on the ``offset``
    diagonal of the (dim1, dim2) planes."""
    if dim1 % (input.dim() + 1) == dim2 % (input.dim() + 1):
        raise ValueError("diag_embed: dim1 and dim2 must differ")
    return torch.diag_embed(input, offset, dim1, dim2)
