"""Convolutions — counterpart of ``paddle_tpu.nn.functional.conv``.

The reference lowers every convolution to ``lax.conv_general_dilated``,
outside any Pallas kernel, as it leaves a plain GEMM to XLA; the port
takes ``F.conv{1,2,3}d`` / ``F.conv_transpose{1,2,3}d`` (cuDNN on the
card) in the same role. Weights keep the reference's layout:
``[out, in/groups, *k]`` for a convolution and ``[in, out/groups, *k]``
for a transposed one, which is torch's own, so nothing is transposed.

Padding takes every form of the reference's ``_norm_padding``: an int, one
int per spatial dimension, ``2·n`` ints as (low, high) pairs, a list of
pairs (per spatial dimension, or per dimension of the input including
batch and channel), and ``'SAME'`` / ``'VALID'``. ``'SAME'`` is XLA's:
output ``ceil(in / stride)``, the total padding split with the odd one on
the high side; a padding whose two sides differ is applied with an
explicit ``F.pad``. ``data_format`` ``NHWC`` (``NLC``, ``NDHWC``) moves
the channel axis around the convolution.

Under ``amp.auto_cast`` the convolutions (not the transposed ones, as in
the reference) cast their input and weight to the AMP dtype. On the card
an f32 convolution goes through cuDNN, which runs it in TF32 when
``torch.backends.cudnn.allow_tf32`` is True (torch's default); set it
False for f32 results.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ...amp.auto_cast import maybe_cast_inputs

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _norm_tuple(v, n: int, name: str) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    if len(v) != n:
        raise ValueError(f"{name} must have {n} elements, got {len(v)}")
    return v


def _norm_padding(padding, n: int, channel_last: bool = False
                  ) -> Union[str, List[Tuple[int, int]]]:
    """``'SAME'`` / ``'VALID'``, or one (low, high) pair per spatial
    dimension."""
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        return p
    if isinstance(padding, int):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        if len(padding) == n + 2:  # batch and channel pairs included
            padding = padding[1:-1] if channel_last else padding[2:]
        if len(padding) == n:
            return [tuple(int(i) for i in p) for p in padding]
    raise ValueError(f"cannot interpret conv padding {padding!r}")


def _same_pads(size: Sequence[int], kernel: Sequence[int],
               stride: Sequence[int], dilation: Sequence[int]
               ) -> List[Tuple[int, int]]:
    """XLA's ``'SAME'``: output ``ceil(in / stride)``, the odd pad high."""
    pads = []
    for s, k, st, d in zip(size, kernel, stride, dilation):
        eff = d * (k - 1) + 1
        out = -(-s // st)
        total = max((out - 1) * st + eff - s, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _explicit_pads(pad, size, kernel, stride, dilation):
    if pad == "VALID":
        return [(0, 0)] * len(size)
    if pad == "SAME":
        return _same_pads(size, kernel, stride, dilation)
    if any(lo < 0 or hi < 0 for lo, hi in pad):
        raise NotImplementedError(f"negative padding {pad} is not ported")
    return pad


def _f_pad(pads) -> List[int]:
    """``F.pad``'s argument (last dimension first) for spatial pairs."""
    out: List[int] = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n, "stride")
    dilation = _norm_tuple(dilation, n, "dilation")
    pad = _norm_padding(padding, n, channel_last)
    x, weight = maybe_cast_inputs(f"conv{n}d", x, weight)
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _explicit_pads(pad, x.shape[2:], weight.shape[2:], stride,
                          dilation)
    if all(lo == hi for lo, hi in pads):
        out = _CONV[n](x, weight, bias, stride, [lo for lo, _ in pads],
                       dilation, groups)
    else:
        out = _CONV[n](F.pad(x, _f_pad(pads)), weight, bias, stride, 0,
                       dilation, groups)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, fmt)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size):
    """The gradient of a convolution: the full transposed convolution
    (``(in − 1)·stride + dilation·(k − 1) + 1 + output_padding`` long),
    cut by the padding's low and high sides, then to ``output_size``."""
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n, "stride")
    dilation = _norm_tuple(dilation, n, "dilation")
    out_pad = _norm_tuple(output_padding, n, "output_padding")
    pad = _norm_padding(padding, n, channel_last)
    if pad == "SAME":
        raise ValueError("SAME padding unsupported for conv_transpose")
    pads = [(0, 0)] * n if pad == "VALID" else pad
    if channel_last:
        x = x.movedim(-1, 1)
    out = _CONV_T[n](x, weight, None, stride, 0, out_pad, groups, dilation)
    cut = [slice(None), slice(None)]
    for i, (lo, hi) in enumerate(pads):
        size = out.shape[2 + i] - hi
        if output_size is not None:
            size = min(size, lo + int(output_size[i]))
        cut.append(slice(lo, size))
    out = out[tuple(cut)]
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * n)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    fmt = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, fmt, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size)
