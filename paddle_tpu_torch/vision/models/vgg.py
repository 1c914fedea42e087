"""VGG — counterpart of ``paddle_tpu.vision.models.vgg``: ``VGG``,
``make_layers`` and ``vgg11/13/16/19``, with or without BatchNorm.

Layer names are the reference's (``features.0.weight``,
``classifier.0.weight``, ``classifier.6.bias``); vgg16 has 138,357,544
parameters. Parameters are drawn on the CPU from a generator seeded with
``seed`` (the convolutions from the reference's ``Uniform(-bound,
bound)``, the linear layers Xavier-uniform), so a seed gives the same
weights on every device; the classifier's dropouts draw their masks from
a generator on the model's device seeded with ``seed``.
``pretrained=True`` raises, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.place import resolve_device
from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["VGG", "make_layers", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, *, generator=None):
    """The convolutional stack of ``cfg`` (channel counts, ``"M"`` for a
    2x2 max pool) on 3-channel input."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            conv = Conv2D(in_channels, v, 3, padding=1, generator=gen)
            if batch_norm:
                layers += [conv, BatchNorm2D(v), ReLU()]
            else:
                layers += [conv, ReLU()]
            in_channels = v
    return Sequential(*layers)


class VGG(nn.Module):
    """``features`` (from ``make_layers``), a 7x7 adaptive average pool
    when ``with_pool``, and the 4096-4096 classifier to ``num_classes``
    logits (none when 0)."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(seed)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            drop_gen = torch.Generator(device=dev).manual_seed(seed)
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, generator=gen), ReLU(),
                Dropout(0.5, generator=drop_gen),
                Linear(4096, 4096, generator=gen), ReLU(),
                Dropout(0.5, generator=drop_gen),
                Linear(4096, num_classes, generator=gen))
        self.to(dev)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, seed=0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require network access; load a local "
            "checkpoint with Model.load or jit.functionalize."
            "load_jax_params")
    gen = torch.Generator().manual_seed(seed)
    return VGG(make_layers(cfgs[cfg], batch_norm, generator=gen),
               seed=seed, generator=gen, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
