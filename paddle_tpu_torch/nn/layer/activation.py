"""Activation layers — counterpart of ``paddle_tpu.nn.layer.activation``:
each layer calls its ``nn.functional`` activation with the options it was
built with (in the reference's positional order)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import initializer as I
from ..functional import activation as A
from ..layer_base import create_parameter

__all__ = [
    "ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid", "Hardsigmoid",
    "Hardswish", "Hardtanh", "Hardshrink", "LeakyReLU", "LogSigmoid",
    "LogSoftmax", "Maxout", "Mish", "PReLU", "RReLU", "Silu", "Swish",
    "Softmax", "Softplus", "Softshrink", "Softsign", "Tanh", "Tanhshrink",
    "ThresholdedReLU", "GLU",
]


def _simple(name, fn_name, params=()):
    def __init__(self, *args, **kwargs):
        nn.Module.__init__(self)
        for i, (pname, default) in enumerate(params):
            setattr(self, pname,
                    args[i] if i < len(args) else kwargs.get(pname, default))

    def forward(self, x):
        return getattr(A, fn_name)(x, *[getattr(self, p) for p, _ in params])

    return type(name, (nn.Module,), {
        "__init__": __init__, "forward": forward, "__module__": __name__,
        "__doc__": f"Layer form of ``nn.functional.{fn_name}``."})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
ELU = _simple("ELU", "elu", [("alpha", 1.0)])
SELU = _simple("SELU", "selu",
               [("scale", 1.0507009873554804934193349852946),
                ("alpha", 1.6732632423543772848170429916717)])
CELU = _simple("CELU", "celu", [("alpha", 1.0)])
GELU = _simple("GELU", "gelu", [("approximate", False)])
Sigmoid = _simple("Sigmoid", "sigmoid")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
Hardtanh = _simple("Hardtanh", "hardtanh", [("min", -1.0), ("max", 1.0)])
Hardshrink = _simple("Hardshrink", "hardshrink", [("threshold", 0.5)])
LeakyReLU = _simple("LeakyReLU", "leaky_relu", [("negative_slope", 0.01)])
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
LogSoftmax = _simple("LogSoftmax", "log_softmax", [("axis", -1)])
Maxout = _simple("Maxout", "maxout", [("groups", 2), ("axis", 1)])
Mish = _simple("Mish", "mish")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Softmax = _simple("Softmax", "softmax", [("axis", -1)])
Softplus = _simple("Softplus", "softplus", [("beta", 1), ("threshold", 20)])
Softshrink = _simple("Softshrink", "softshrink", [("threshold", 0.5)])
Softsign = _simple("Softsign", "softsign")
Tanh = _simple("Tanh", "tanh")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu",
                          [("threshold", 1.0)])
GLU = _simple("GLU", "glu", [("axis", -1)])


class PReLU(nn.Module):
    """``prelu`` with a learned slope per channel (or one), made from
    ``weight_attr`` (by default ``Constant(init)``, as the reference's)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter(
            [num_parameters], weight_attr, dtype,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return A.prelu(x, self.weight, self._data_format)


class RReLU(nn.Module):
    """``rrelu``; in training its slopes come from ``generator``."""

    def __init__(self, lower=0.125, upper=1.0 / 3.0, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return A.rrelu(x, self.lower, self.upper, self.training,
                       generator=self.generator)
