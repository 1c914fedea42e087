"""Common layers — counterpart of ``paddle_tpu.nn.layer.common``.

The signatures are the reference's (``Linear(in, out, weight_attr,
bias_attr, name)``, ``Embedding(num, dim, padding_idx, sparse,
weight_attr, name)``, ``Dropout(p=0.5, axis, mode)``, ...), with the
port's keywords after them: ``device=`` and ``dtype=`` for where a layer
makes its parameters, and ``generator=`` for the ``torch.Generator`` its
random initial values (and a dropout's masks) come from.

Parameters are made by ``nn.layer_base.create_parameter`` from their
``ParamAttr``: the reference's defaults (Xavier-uniform weights, zero
biases, Xavier-normal embeddings with the padding row zeroed) drawn on the
CPU from ``generator`` (else the initializers' own generator), so a seed
gives the same weights on every device; ``bias_attr=False`` makes no bias.
``Linear`` keeps the reference's [in, out] weight (``x @ W + b``), so
weights cross over from the reference without a transpose.

A dropout layer draws its masks from its ``generator`` (the model's),
else from a generator of its own on the input's device, seeded once from
the initializers' generator when the layer is made; never from torch's
global RNG.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F
from .. import initializer as I
from ..functional.common import linear
from ..layer_base import create_parameter

__all__ = [
    "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "CosineSimilarity", "Bilinear", "Identity", "Unfold", "Fold",
    "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "linear",
]


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(nn.Module):
    """Dense layer in the reference's layout: weight [in, out]."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.register_parameter("weight", create_parameter(
            [in_features, out_features], weight_attr, **kw))
        self.register_parameter("bias", create_parameter(
            [out_features], bias_attr, is_bias=True, **kw))

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(nn.Module):
    """Lookup table, weight [num_embeddings, embedding_dim]; lookups of
    ``padding_idx`` (a negative one counts from the end) give zeros and
    its row starts at 0; ``sparse`` gives the weight row-sparse
    gradients."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (
            None if padding_idx is None else padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self._sparse = bool(sparse)
        self.register_parameter("weight", create_parameter(
            [num_embeddings, embedding_dim], weight_attr, dtype,
            default_initializer=I.XavierNormal(), device=device,
            generator=generator))
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class _RandomLayer(nn.Module):
    """A layer that draws masks: from ``generator`` when given, else from
    a generator of its own made on the input's device at the first draw
    (seeded when the layer is made)."""

    def __init__(self, generator: Optional[torch.Generator]):
        super().__init__()
        self.generator = generator
        # its own generators' seed (None: the caller's generator is used)
        self._seed = (None if generator is not None else int(torch.randint(
            2 ** 62, (1,), generator=I._generator)))
        self._own: dict = {}

    def _gen(self, x: torch.Tensor) -> torch.Generator:
        if self._seed is None:
            return self.generator
        gen = self._own.get(x.device)
        if gen is None:
            gen = self._own[x.device] = torch.Generator(
                device=x.device).manual_seed(self._seed)
        return gen


class Dropout(_RandomLayer):
    """Dropout (``F.dropout``): the identity in eval mode (or scaled by
    ``1 - p`` in ``downscale_in_infer`` mode) or at ``p == 0``."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        drawn = self.training and self.p not in (0.0, 1.0)
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode,
                         generator=self._gen(x) if drawn else None)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(_RandomLayer):
    def __init__(self, p: float = 0.5, data_format: str = "NCHW", name=None,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        drawn = self.training and self.p not in (0.0, 1.0)
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self._gen(x) if drawn else None)


class Dropout3D(_RandomLayer):
    def __init__(self, p: float = 0.5, data_format: str = "NCDHW", name=None,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        drawn = self.training and self.p not in (0.0, 1.0)
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self._gen(x) if drawn else None)


class AlphaDropout(_RandomLayer):
    def __init__(self, p: float = 0.5, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = p

    def forward(self, x):
        drawn = self.training and self.p != 0.0
        return F.alpha_dropout(x, self.p, training=self.training,
                               generator=self._gen(x) if drawn else None)


class Flatten(nn.Module):
    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class _PadNd(nn.Module):
    _n = 2

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self._n)
        self.padding = list(padding)
        self.mode = mode
        self.value = value
        self.data_format = data_format or ("NCL", "NCHW",
                                           "NCDHW")[self._n - 1]

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)

    def extra_repr(self):
        return f"padding={self.padding}, mode={self.mode}"


class Pad1D(_PadNd):
    _n = 1


class Pad2D(_PadNd):
    _n = 2


class Pad3D(_PadNd):
    _n = 3


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(nn.Module):
    """``out[b, o] = x1[b] · W[o] · x2[b] + bias[o]``, weight [out, in1,
    in2]."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, weight_attr=None, bias_attr=None,
                 name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.register_parameter("weight", create_parameter(
            [out_features, in1_features, in2_features], weight_attr, **kw))
        self.register_parameter("bias", create_parameter(
            [out_features], bias_attr, is_bias=True, **kw))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
