"""Parameter initializers — counterpart of ``paddle_tpu.nn.initializer``.

An initializer makes a tensor from ``(shape, dtype, device, generator)``.
Random values are drawn on the CPU from a ``torch.Generator`` (the
caller's, else this module's, seeded 0 at import and by ``seed``) and then
moved, so a device gives the same weights as the CPU. The reference
draws from its own JAX key, so random initial values do not cross between
the packages; the weights do, by name (``static.set_program_state``) or
through ``jit.functionalize.load_jax_params``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Dirac", "Orthogonal",
           "calculate_gain", "seed"]

_generator = torch.Generator().manual_seed(0)


def seed(value: int) -> None:
    """Re-seed the generator initializers draw from by default."""
    _generator.manual_seed(int(value))


def calculate_gain(nonlinearity, param=None) -> float:
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None
                                             else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:  # [in, out], as the reference stores Linear
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        gen = generator if generator is not None else _generator
        with torch.no_grad():
            value = self._generate(shape, gen)
        return value.to(device=device, dtype=dtype)

    def _generate(self, shape, gen) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, gen):
        return torch.full(shape, float(self.value))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, gen):
        return torch.randn(shape, generator=gen) * self.std + self.mean


class TruncatedNormal(Initializer):
    """Normal values cut to two standard deviations."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, gen):
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t * self.std + self.mean


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, gen):
        return torch.empty(shape).uniform_(self.low, self.high,
                                           generator=gen)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, gen):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return torch.empty(shape).uniform_(-limit, limit, generator=gen)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, gen):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return torch.randn(shape, generator=gen) * std


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, gen):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return torch.empty(shape).uniform_(-limit, limit, generator=gen)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, gen):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return torch.randn(shape, generator=gen) * (gain / math.sqrt(fi))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _generate(self, shape, gen):
        v = self.value
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        return v.reshape(shape).clone()


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def _generate(self, shape, gen):
        out = torch.zeros(shape)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        per_group = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, ic)):
                out[(g * per_group + i, i) + centers] = 1.0
        return out


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, gen):
        rows, cols = shape[0], int(np.prod(shape[1:]))
        flat = torch.randn(max(rows, cols), min(rows, cols), generator=gen)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return (self.gain * q[:rows, :cols]).reshape(shape)

