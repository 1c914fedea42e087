"""Normalization layers — counterpart of ``paddle_tpu.nn.layer.norm``,
kept to the LayerNorm the ported models use. It runs through
``ops.fused.fused_layer_norm``: the hand-written forward and backward
kernels on the card, their plain versions on the CPU."""
from __future__ import annotations

import torch
from torch import nn

from ...ops.fused import fused_layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; unit gain and zero bias at first."""

    def __init__(self, hidden: int, eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(hidden, **kw))
        self.bias = nn.Parameter(torch.zeros(hidden, **kw))
        self.eps = eps

    def forward(self, x):
        return fused_layer_norm(x, self.weight, self.bias, self.eps)
