"""Normalization layers — counterpart of ``paddle_tpu.nn.layer.norm``,
kept to the LayerNorm and BatchNorms the ported models use.

``LayerNorm`` runs through ``ops.fused.fused_layer_norm``: the
hand-written forward and backward kernels on the card, their plain
versions on the CPU. The BatchNorms run ``nn.functional.batch_norm``
(plain PyTorch, as the reference's is XLA): unit weight and zero bias at
first, and the running statistics as the buffers ``_mean`` (zeros) and
``_variance`` (ones), f32, named as the reference's so that they cross
over by name (``jit.functionalize.load_jax_params(..., buffers=)``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.fused import fused_layer_norm
from ..functional import activation as A
from ..functional.norm import batch_norm

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


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


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        if weight_attr is not None or bias_attr is not None:
            raise NotImplementedError("ParamAttr is not ported")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, input):
        return batch_norm(
            input, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    """The fluid-style BatchNorm: ``act`` names an activation applied to
    its output."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False, *,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        return getattr(A, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    """BatchNorm of [N, C] or [N, C, L] (``NC``/``NCL``, or ``NLC``)."""


class BatchNorm2D(_BatchNormBase):
    """BatchNorm of [N, C, H, W] (``NCHW``, or ``NHWC``)."""


class BatchNorm3D(_BatchNormBase):
    """BatchNorm of [N, C, D, H, W] (``NCDHW``, or ``NDHWC``)."""
