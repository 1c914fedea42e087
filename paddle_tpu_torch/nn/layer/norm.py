"""Normalization layers — counterpart of ``paddle_tpu.nn.layer.norm``,
kept to the LayerNorm and BatchNorms the ported models use.

``LayerNorm`` runs through ``ops.fused.fused_layer_norm``: the
hand-written forward and backward kernels on the card, their plain
versions on the CPU. The BatchNorms run ``nn.functional.batch_norm``
(plain PyTorch, as the reference's is XLA): weight and bias made from
their ``ParamAttr`` (``nn.layer_base.create_parameter``; unit weight and
zero bias by default, ``False`` for none: the affine step then leaves
that factor out), and the running statistics as the buffers ``_mean``
(zeros) and ``_variance`` (ones), f32, named as the reference's so that
they cross over by name (``jit.functionalize.load_jax_params(...,
buffers=)``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.fused import fused_layer_norm
from .. import initializer as I
from ..functional import activation as A
from ..functional.norm import batch_norm
from ..layer_base import create_parameter

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims (flattened
    into one row for the kernel); gain and bias made from their
    ``ParamAttr`` (unit gain and zero bias by default; ``False``: none, the
    kernel then takes ones or zeros)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        shape = ([int(normalized_shape)]
                 if isinstance(normalized_shape, int)
                 else [int(d) for d in normalized_shape])
        self._normalized_shape = shape
        self.eps = epsilon
        kw = dict(dtype=dtype, device=device)
        self.register_parameter("weight", create_parameter(
            shape, weight_attr, default_initializer=I.Constant(1.0), **kw))
        self.register_parameter("bias", create_parameter(
            shape, bias_attr, is_bias=True, **kw))

    def forward(self, x):
        n = len(self._normalized_shape)
        rows = x.reshape(*x.shape[:x.dim() - n], -1) if n > 1 else x
        hidden = rows.shape[-1]
        w = (self.weight.reshape(-1) if self.weight is not None
             else torch.ones(hidden, dtype=x.dtype, device=x.device))
        b = (self.bias.reshape(-1) if self.bias is not None
             else torch.zeros(hidden, dtype=x.dtype, device=x.device))
        return fused_layer_norm(rows, w, b, self.eps).reshape(x.shape)


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(dtype=dtype, device=device)
        self.register_parameter("weight", create_parameter(
            [num_features], weight_attr,
            default_initializer=I.Constant(1.0), **kw))
        self.register_parameter("bias", create_parameter(
            [num_features], bias_attr, is_bias=True, **kw))
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
