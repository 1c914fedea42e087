"""Loss layers — counterpart of ``paddle_tpu.nn.layer.loss``, kept to
``CrossEntropyLoss``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..functional.loss import cross_entropy

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    """``functional.cross_entropy`` with its options fixed at
    construction."""

    def __init__(self, weight: Optional[torch.Tensor] = None,
                 ignore_index: int = -100, reduction: str = "mean",
                 soft_label: bool = False, axis: int = -1,
                 use_softmax: bool = True, label_smoothing: float = 0.0):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)
