"""Activation functionals — counterpart of
``paddle_tpu.nn.functional.activation``.

Each is the reference's formula on torch tensors (torch's own function
where it computes the same one), differentiated by autograd. ``relu``'s
gradient at 0 is 0, as the reference's (``jax.nn.relu``) is. The
in-place forms (``relu_``, ``elu_``, ``softmax_``, ``tanh_``) write into
their argument. ``rrelu`` in training and ``gumbel_softmax`` draw from
an explicit ``generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.dtype import convert_dtype

__all__ = [
    "elu_",
    "relu", "relu_", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
    "hardsigmoid", "hardswish", "hardtanh", "hardshrink", "leaky_relu",
    "log_sigmoid", "log_softmax", "maxout", "mish", "prelu", "rrelu",
    "silu", "swish", "softmax", "softmax_", "softplus", "softshrink",
    "softsign", "tanh", "tanh_", "tanhshrink", "thresholded_relu", "glu",
    "gumbel_softmax",
]



def relu(x, name=None):
    return F.relu(x)


def relu_(x, name=None):
    return x.relu_()


def relu6(x, name=None):
    return F.relu6(x)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha)


def elu_(x, alpha=1.0, name=None):
    return F.elu_(x, alpha)


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha)


def gelu(x, approximate=False, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def leaky_relu(x, negative_slope=0.01, name=None):
    return F.leaky_relu(x, negative_slope)


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def log_softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)
    return torch.log_softmax(x if d is None else x.to(d), dim=axis)


def maxout(x, groups, axis=1, name=None):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch_axis] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None, generator: Optional[torch.Generator] = None):
    """Randomized leaky ReLU: in training each element's slope is drawn
    from U(lower, upper) with ``generator`` (required then); in eval the
    slope is their mean."""
    if training:
        if generator is None:
            raise ValueError("rrelu: training draws slopes and needs an "
                             "explicit generator")
        slope = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
            lower, upper, generator=generator)
        return torch.where(x >= 0, x, slope * x)
    mid = (lower + upper) / 2.0
    return torch.where(x >= 0, x, mid * x)


def silu(x, name=None):
    return F.silu(x)


def swish(x, name=None):
    return F.silu(x)


def softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)
    return torch.softmax(x if d is None else x.to(d), dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def softplus(x, beta=1, threshold=20, name=None):
    return F.softplus(x, beta, threshold)


def softshrink(x, threshold=0.5, name=None):
    return F.softshrink(x, threshold)


def softsign(x, name=None):
    return F.softsign(x)


def tanh(x, name=None):
    return torch.tanh(x)


def tanh_(x, name=None):
    return x.tanh_()


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def glu(x, axis=-1, name=None):
    a1, a2 = torch.chunk(x, 2, dim=axis)
    return a1 * torch.sigmoid(a2)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator: Optional[torch.Generator] = None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` drawn
    from ``generator`` (required); ``hard`` gives the one-hot of its
    argmax with the soft gradient (straight-through)."""
    if generator is None:
        raise ValueError("gumbel_softmax draws noise and needs an explicit "
                         "generator")
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        generator=generator)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(x.dtype).tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        return y_hard - y.detach() + y
    return y
