"""Convolution layers — counterpart of ``paddle_tpu.nn.layer.conv``.

Weights are ``[out, in/groups, *k]`` (``[in, out/groups, *k]`` for the
transposed layers), the reference's layout, so they cross over without a
transpose. Both are made from their ``ParamAttr``
(``nn.layer_base.create_parameter``) as the reference's are: by default
``Uniform(-bound, bound)`` with ``bound = 1/sqrt(in/groups · prod(k))``
(a bias given a ``ParamAttr`` without an initializer starts at 0),
drawn (weight first, then bias) from ``generator``: the model's, or, for
a layer built alone, a generator of its own seeded with 0.
``bias_attr=False`` means no bias.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import initializer as I
from ..functional import conv as C
from ..layer_base import create_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, int):
        return [int(v)] * n
    return [int(i) for i in v]


class _ConvNd(nn.Module):
    _n = 2
    _transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, generator=None, device=None,
                 dtype=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode {padding_mode!r} is not ported (zeros)")
        n = self._n
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = _ntuple(stride, n)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _ntuple(dilation, n)
        self._groups = groups
        self._data_format = data_format
        if self._transpose:
            shape = [in_channels, out_channels // groups] + self._kernel_size
        else:
            shape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        bound = 1.0 / math.sqrt(fan_in)
        gen = (generator if generator is not None
               else torch.Generator().manual_seed(0))
        kw = dict(dtype=dtype, device=device, generator=gen)
        self.weight = create_parameter(
            shape, weight_attr, default_initializer=I.Uniform(-bound, bound),
            **kw)
        self.register_parameter("bias", create_parameter(
            [out_channels], bias_attr, is_bias=True,
            default_initializer=(I.Uniform(-bound, bound) if bias_attr is None
                                 else None), **kw))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    _n = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return C.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    _n = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return C.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    _n = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return C.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    _n = 1
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x, output_size=None):
        return C.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    _n = 2
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x, output_size=None):
        return C.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)


class Conv3DTranspose(_ConvNd):
    _n = 3
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x, output_size=None):
        return C.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
