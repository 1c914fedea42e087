"""Normalization layers — counterpart of ``paddle_tpu.nn.layer.norm``.

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

``GroupNorm``, ``InstanceNorm1D/2D/3D`` and ``LocalResponseNorm`` call
their functionals (plain PyTorch, the reference's XLA arithmetic);
``InstanceNorm``'s affine parameters are ``scale`` and ``bias``, as the
reference names them. ``SpectralNorm`` runs the reference's power
iteration from its stored ``weight_u`` / ``weight_v`` on every call and,
as the reference, never writes them back. ``SyncBatchNorm`` is
``BatchNorm`` on one process; across processes it raises (the
cross-process statistics are Queue 1 item 6). ``GroupNorm``, the
InstanceNorms, ``SpectralNorm`` and ``SyncBatchNorm`` make their
parameters on the card unless ``device=`` says otherwise.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.place import resolve_device
from ...ops.fused import fused_layer_norm
from .. import initializer as I
from ..functional import activation as A
from ..functional import norm as FN
from ..functional.norm import batch_norm
from ..layer_base import create_parameter

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


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


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm. On one process it is ``BatchNorm``; in a
    ``torch.distributed`` world larger than 1 its forward raises: the
    statistics across processes are not ported (Queue 1 item 6), and a
    per-process average would differ from the reference's without a
    word."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, None, name,
                         device=resolve_device(device), dtype=dtype)

    def forward(self, input):
        dist = torch.distributed
        if (self.training and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise NotImplementedError(
                "SyncBatchNorm across processes is not ported yet (Queue 1 "
                "item 6: the multi-device engines)")
        return super().forward(input)

    @classmethod
    def convert_sync_batchnorm(cls, layer: nn.Module) -> nn.Module:
        """``layer`` with every BatchNorm below it (itself included)
        replaced by a ``SyncBatchNorm`` holding its parameters and
        running statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            w = layer.weight if layer.weight is not None else layer._mean
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      None if layer.weight is not None else False,
                      None if layer.bias is not None else False,
                      layer._data_format, device=w.device)
            with torch.no_grad():
                for name in ("weight", "bias", "_mean", "_variance"):
                    src = getattr(layer, name)
                    if src is not None:
                        getattr(out, name).copy_(src)
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class GroupNorm(nn.Module):
    """``F.group_norm`` with a [C] ``weight`` (ones) and ``bias``
    (zeros); ``False`` for either leaves it out."""

    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.register_parameter("weight", create_parameter(
            [num_channels], weight_attr,
            default_initializer=I.Constant(1.0), **kw))
        self.register_parameter("bias", create_parameter(
            [num_channels], bias_attr, is_bias=True, **kw))

    def forward(self, input):
        return FN.group_norm(input, self._num_groups, self._epsilon,
                             self.weight, self.bias, self._data_format)


class _InstanceNormBase(nn.Module):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(dtype=dtype, device=resolve_device(device))
        affine = weight_attr is not False
        self.register_parameter("scale", create_parameter(
            [num_features], weight_attr,
            default_initializer=I.Constant(1.0), **kw) if affine else None)
        self.register_parameter("bias", create_parameter(
            [num_features], bias_attr, is_bias=True, **kw)
            if affine else None)

    def forward(self, input):
        return FN.instance_norm(input, weight=self.scale, bias=self.bias,
                                eps=self._epsilon,
                                data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    """InstanceNorm of [N, C, L]."""


class InstanceNorm2D(_InstanceNormBase):
    """InstanceNorm of [N, C, H, W]."""


class InstanceNorm3D(_InstanceNormBase):
    """InstanceNorm of [N, C, D, H, W]."""


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, input):
        return FN.local_response_norm(input, self.size, self.alpha,
                                      self.beta, self.k, self.data_format)


class SpectralNorm(nn.Module):
    """``weight / σ``, σ the largest singular value of ``weight`` (its
    ``dim`` axis first, the rest flattened) estimated by ``power_iters``
    rounds of power iteration from ``weight_u`` [h] and ``weight_v`` [w]
    (N(0, 1), no gradient). The iteration is differentiated; u and v are
    not written back, as in the reference."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", *, device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = int(weight_shape[dim])
        w = 1
        for s in weight_shape:
            w *= int(s)
        kw = dict(device=resolve_device(device),
                  default_initializer=I.Normal(0.0, 1.0))
        for name, n in (("weight_u", h), ("weight_v", w // h)):
            p = create_parameter([n], None, **kw)
            p.requires_grad_(False)
            p.trainable = False
            self.register_parameter(name, p)

    def forward(self, weight):
        dim = self._dim
        w_m = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = w_m.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = w_m @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        sigma = u @ w_m @ v
        return weight / sigma
