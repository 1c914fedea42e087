"""Loss layers — counterpart of ``paddle_tpu.nn.layer.loss``: each
layer is its functional (``nn.functional.loss``) with the options fixed
at construction. ``HSigmoidLoss`` owns the tree's node weights
[C, feature_size] and biases [C, 1] (C = ``num_classes − 1`` for the
default tree, ``num_classes`` for a custom one), made on the card unless
``device=`` says otherwise."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.place import resolve_device
from ..functional import loss as L
from ..layer_base import create_parameter

__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "HingeEmbeddingLoss", "CosineEmbeddingLoss", "CTCLoss",
    "TripletMarginLoss", "HSigmoidLoss",
]


class CrossEntropyLoss(nn.Module):
    """``functional.cross_entropy`` with its options fixed at
    construction."""

    def __init__(self, weight: Optional[torch.Tensor] = None,
                 ignore_index: int = -100, reduction: str = "mean",
                 soft_label: bool = False, axis: int = -1,
                 use_softmax: bool = True, label_smoothing: float = 0.0,
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return L.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class HSigmoidLoss(nn.Module):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        if num_classes < 2 and not is_custom:
            raise ValueError("num_classes must not be less than 2 with "
                             "default tree")
        self._num_classes = num_classes
        self._is_sparse = is_sparse
        c = num_classes if is_custom else num_classes - 1
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.register_parameter("weight", create_parameter(
            [c, feature_size], weight_attr, **kw))
        self.register_parameter("bias", create_parameter(
            [c, 1], bias_attr, is_bias=True, **kw))

    def forward(self, input, label, path_table=None, path_code=None):
        return L.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code,
                               is_sparse=self._is_sparse)


class _Reduced(nn.Module):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction


class MSELoss(_Reduced):
    def forward(self, input, label):
        return L.mse_loss(input, label, self.reduction)


class L1Loss(_Reduced):
    def forward(self, input, label):
        return L.l1_loss(input, label, self.reduction)


class KLDivLoss(_Reduced):
    def forward(self, input, label):
        return L.kl_div(input, label, self.reduction)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return L.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return L.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return L.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(nn.Module):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return L.smooth_l1_loss(input, label, self.reduction, self.delta)


class _Margin(nn.Module):
    def __init__(self, margin, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction


class MarginRankingLoss(_Margin):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin, reduction)

    def forward(self, input, other, label):
        return L.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(_Margin):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin, reduction)

    def forward(self, input, label):
        return L.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(_Margin):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin, reduction)

    def forward(self, input1, input2, label):
        return L.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return L.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.p = p
        self.epsilon = epsilon
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return L.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)
