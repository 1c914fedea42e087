"""MobileNetV1 and MobileNetV2 — counterpart of
``paddle_tpu.vision.models.mobilenet``: ``MobileNetV1``, ``MobileNetV2``,
``mobilenet_v1``, ``mobilenet_v2``, ``ConvBNLayer``,
``DepthwiseSeparable``, ``InvertedResidual`` and ``_make_divisible``.

Layer names and the activation are the reference's: ``ReLU``, not ReLU6
(``features.1.conv.0.conv.weight``, ``features.1.conv.0.bn._mean``);
mobilenet_v2 has 3,504,872 parameters at ``scale=1``. The depthwise
convolutions are ``Conv2D(groups=C)``, which runs cuDNN's grouped
convolution on the card, as the reference's runs XLA's. Parameters are
drawn on the CPU from a generator seeded with ``seed``; the dropout before
MobileNetV2's classifier draws its masks from a generator on the model's
device seeded with ``seed``. ``pretrained=True`` raises, as in the
reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.place import resolve_device
from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
           "ConvBNLayer", "DepthwiseSeparable", "InvertedResidual"]


class ConvBNLayer(nn.Module):
    """Convolution without bias, BatchNorm, and ReLU when ``act``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, act=True, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = Conv2D(in_channels, out_channels, kernel_size, stride,
                           padding, groups=groups, bias_attr=False,
                           generator=generator)
        self.bn = BatchNorm2D(out_channels)
        self.act = ReLU() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_channels, out_channels1, out_channels2,
                 num_groups, stride, scale, *, generator: torch.Generator):
        super().__init__()
        self.dw = ConvBNLayer(in_channels, int(out_channels1 * scale), 3,
                              stride, 1, groups=int(num_groups * scale),
                              generator=generator)
        self.pw = ConvBNLayer(int(out_channels1 * scale),
                              int(out_channels2 * scale), 1,
                              generator=generator)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, 2, 1, generator=gen)
        cfg = [
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 1024, 512, 2), (1024, 1024, 1024, 1024, 1),
        ]
        self.blocks = Sequential(*[
            DepthwiseSeparable(int(in_c * scale), c1, c2, g, s, scale,
                               generator=gen)
            for in_c, c1, c2, g, s in cfg])
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(int(1024 * scale), num_classes, generator=gen)
        self.to(dev)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, *,
                 generator: torch.Generator):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1, act=True,
                                      generator=generator))
        layers += [
            ConvBNLayer(hidden_dim, hidden_dim, 3, stride, 1,
                        groups=hidden_dim, act=True, generator=generator),
            ConvBNLayer(hidden_dim, oup, 1, act=False, generator=generator),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        features = [ConvBNLayer(3, input_channel, 3, 2, 1, generator=gen)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t,
                    generator=gen))
                input_channel = out_c
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features.append(ConvBNLayer(input_channel, self.last_channel, 1,
                                    generator=gen))
        self.features = Sequential(*features)
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2, generator=torch.Generator(
                    device=dev).manual_seed(seed)),
                Linear(self.last_channel, num_classes, generator=gen))
        self.to(dev)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _pretrained(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require network access; load a local "
            "checkpoint with Model.load or jit.functionalize."
            "load_jax_params")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
