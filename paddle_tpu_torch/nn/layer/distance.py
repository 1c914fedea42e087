"""Distance layers — counterpart of ``paddle_tpu.nn.layer.distance``."""
from __future__ import annotations

import math

from torch import nn

__all__ = ["PairwiseDistance"]


class PairwiseDistance(nn.Module):
    """The p-norm of ``x − y + epsilon`` over the last axis (``p = ±inf``:
    the largest or smallest ``|x − y + epsilon|``)."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = float(p)
        self.epsilon = float(epsilon)
        self.keepdim = keepdim

    def forward(self, x, y):
        d = (x - y + self.epsilon).abs()
        if self.p == math.inf:
            return d.amax(-1, keepdim=self.keepdim)
        if self.p == -math.inf:
            return d.amin(-1, keepdim=self.keepdim)
        return (d ** self.p).sum(-1, keepdim=self.keepdim) ** (1.0 / self.p)
