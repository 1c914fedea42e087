"""Tensor attributes — counterpart of ``paddle_tpu.tensor.attribute``."""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ._util import as_tensor, from_host, promote

__all__ = [
    "shape", "rank", "is_floating_point", "is_integer", "is_complex", "real",
    "imag", "conj", "einsum",
]


def shape(input):
    """The shape as an int32 tensor on ``input``'s device."""
    t = as_tensor(input)
    return from_host(list(t.shape), torch.int32, t.device)


def rank(input):
    t = as_tensor(input)
    return torch.full((), t.dim(), dtype=torch.int32, device=t.device)


def is_floating_point(x):
    return dtype_mod.is_floating_point(as_tensor(x).dtype)


def is_integer(x):
    return dtype_mod.is_integer(as_tensor(x).dtype)


def is_complex(x):
    return dtype_mod.is_complex(as_tensor(x).dtype)


def real(x, name=None):
    t = as_tensor(x)
    return torch.real(t) if t.is_complex() else t.clone()


def imag(x, name=None):
    t = as_tensor(x)
    return torch.imag(t) if t.is_complex() else torch.zeros_like(t)


def conj(x, name=None):
    return torch.conj_physical(as_tensor(x))


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = operands[0]
    like = next((o for o in operands if isinstance(o, torch.Tensor)), None)
    return torch.einsum(equation, *promote(*[as_tensor(o, like)
                                             for o in operands]))
