"""LeNet — counterpart of ``paddle_tpu.vision.models.lenet``.

Parameters are named as the reference's (``features.0.weight``,
``fc.2.bias``: 10 tensors) and drawn from a generator seeded with
``seed``: the convolutions from the reference's ``Uniform(-bound,
bound)``, the linear layers Xavier-uniform with zero bias. They are drawn
on the CPU, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.place import resolve_device
from ...nn.layer.activation import ReLU
from ...nn.layer.common import Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.pooling import MaxPool2D

__all__ = ["LeNet"]


class LeNet(nn.Module):
    """LeNet-5 on [N, 1, 28, 28]: two conv-ReLU-max-pool stages, then
    three linear layers to ``num_classes`` logits (none when 0)."""

    def __init__(self, num_classes: int = 10, *, seed: int = 0,
                 device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, generator=gen),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, generator=gen),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, generator=gen),
                Linear(120, 84, generator=gen),
                Linear(84, num_classes, generator=gen),
            )
        self.to(resolve_device(device))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
