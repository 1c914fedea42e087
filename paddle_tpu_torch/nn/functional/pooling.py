"""Pooling — counterpart of ``paddle_tpu.nn.functional.pooling``.

The reference pools with ``lax.reduce_window`` (its backward for max is
XLA's select-and-scatter), outside any Pallas kernel; the port takes
``F.max_pool{n}d`` / ``F.avg_pool{n}d`` (cuDNN or ATen on the card) on an
input padded the reference's way, so every one of its rules holds:

- padding as an int, one int per spatial dimension, ``2·n`` ints or a list
  of (low, high) pairs, or ``'SAME'`` / ``'VALID'`` (XLA's rule, as for the
  convolutions); ``ceil_mode`` widens the high side until the last window
  fits (``ceil((in + lo + hi − k) / stride) + 1`` windows);
- max pooling pads with −inf, so a padded position never wins, and its
  gradient goes to one winner per window, as select-and-scatter's does
  (the reference's opt-in ``_manual_maxpool``, which splits ties, is a
  recorded negative result there and is not ported);
- average pooling pads with zeros and divides by the window's count of
  real positions when ``exclusive`` and there is explicit padding, else by
  the window's size (``'SAME'`` counts the pads too, as in the reference);
- ``return_mask`` gives each maximum's flat index in the unpadded input's
  spatial map (int64), for 1-3 spatial dimensions.

Adaptive pooling takes torch's, whose bins are the reference's,
``[floor(b·in/out), ceil((b+1)·in/out))``.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from .conv import _CHANNEL_LAST, _f_pad, _norm_padding, _same_pads

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _norm(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (int(v),) * n
    return tuple(int(i) for i in v)


def _pads(x, kernel, stride, padding, n, ceil_mode):
    """(pairs per spatial dimension, whether they came from a string)."""
    pad = _norm_padding(padding, n)
    if pad == "VALID":
        return [(0, 0)] * n, True
    if pad == "SAME":
        return _same_pads(x.shape[2:], kernel, stride, (1,) * n), True
    pairs: List[Tuple[int, int]] = []
    for i, (lo, hi) in enumerate(pad):
        if ceil_mode:
            size = x.shape[2 + i]
            windows = -(-(size + lo + hi - kernel[i]) // stride[i]) + 1
            hi = max(hi, (windows - 1) * stride[i] + kernel[i] - size - lo)
        pairs.append((lo, hi))
    return pairs, False


def _window_sums(x, kernel, stride, n):
    """Each window's sum (``x`` already padded)."""
    if n == 1:
        return F.avg_pool2d(x[..., None, :], (1,) + kernel, (1,) + stride,
                            divisor_override=1)[..., 0, :]
    pool = F.avg_pool2d if n == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _mask(idx, pads, size):
    """Flat indices into a padded map -> flat indices into the input's."""
    padded = [s + lo + hi for s, (lo, hi) in zip(size, pads)]
    flat = torch.zeros_like(idx)
    rest = idx
    coords = []
    for p in reversed(padded):
        coords.append(rest % p)
        rest = rest // p
    for c, (lo, _), s in zip(reversed(coords), pads, size):
        flat = flat * s + (c - lo)
    return flat


def _pool(x, kernel, stride, padding, n, op, channel_last, ceil_mode=False,
          exclusive=True, return_mask=False, divisor_override=None):
    kernel = _norm(kernel, n)
    stride = _norm(stride if stride is not None else kernel, n)
    if channel_last:
        x = x.movedim(-1, 1)
    pads, from_str = _pads(x, kernel, stride, padding, n, ceil_mode)
    if op == "max":
        if all(lo == hi <= k // 2 for (lo, hi), k in zip(pads, kernel)):
            # torch's own padding is the same -inf border
            out = _MAX[n](x, kernel, stride, [lo for lo, _ in pads],
                          return_indices=return_mask)
            out, mask = out if return_mask else (out, None)
        else:
            xp = F.pad(x, _f_pad(pads), value=float("-inf"))
            out = _MAX[n](xp, kernel, stride, return_indices=return_mask)
            if return_mask:
                out, mask = out[0], _mask(out[1], pads, x.shape[2:])
        if return_mask:
            if channel_last:
                out, mask = out.movedim(1, -1), mask.movedim(1, -1)
            return out, mask
    else:
        s = _window_sums(F.pad(x, _f_pad(pads)), kernel, stride, n)
        if divisor_override:
            out = s / divisor_override
        elif exclusive and not from_str and any(p != (0, 0) for p in pads):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = s / _window_sums(F.pad(ones, _f_pad(pads)), kernel,
                                   stride, n)
        else:
            out = s / float(math.prod(kernel))
    return out.movedim(1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "max",
                 data_format == "NLC", ceil_mode, return_mask=return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, 2, "max",
                 data_format == "NHWC", ceil_mode, return_mask=return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, "max",
                 data_format == "NDHWC", ceil_mode, return_mask=return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg",
                 data_format == "NLC", ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg",
                 data_format == "NHWC", ceil_mode, exclusive,
                 divisor_override=divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg",
                 data_format == "NDHWC", ceil_mode, exclusive,
                 divisor_override=divisor_override)


def _adaptive(x, output_size, n, op, channel_last, return_mask=False):
    if isinstance(output_size, int):
        output_size = (output_size,) * n
    if channel_last:
        x = x.movedim(-1, 1)
    size = tuple(x.shape[2 + i] if o is None else int(o)
                 for i, o in enumerate(output_size))
    if op == "avg":
        out = (F.adaptive_avg_pool1d, F.adaptive_avg_pool2d,
               F.adaptive_avg_pool3d)[n - 1](x, size)
    else:
        out = (F.adaptive_max_pool1d, F.adaptive_max_pool2d,
               F.adaptive_max_pool3d)[n - 1](x, size, return_mask)
        if return_mask:
            return out
    return out.movedim(1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format == "NDHWC")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", False, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", False, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", False, return_mask)
