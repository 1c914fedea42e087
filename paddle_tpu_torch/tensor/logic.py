"""Comparisons and logic — counterpart of ``paddle_tpu.tensor.logic``.

``equal_all`` and ``allclose`` return a 0-d bool tensor on the inputs'
device (no sync), as the reference returns a tensor.
"""
from __future__ import annotations

import torch

from ._util import as_tensor, pair, promote

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_xor", "logical_not", "is_empty", "is_tensor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
]


def _binary(fn):
    def op(x, y, out=None, name=None):
        return fn(*pair(x, y))

    return op


equal = _binary(torch.eq)
not_equal = _binary(torch.ne)
greater_than = _binary(torch.gt)
greater_equal = _binary(torch.ge)
less_than = _binary(torch.lt)
less_equal = _binary(torch.le)
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_xor = _binary(torch.logical_xor)
bitwise_and = _binary(torch.bitwise_and)
bitwise_or = _binary(torch.bitwise_or)
bitwise_xor = _binary(torch.bitwise_xor)


def logical_not(x, out=None, name=None):
    return torch.logical_not(as_tensor(x))


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(as_tensor(x))


def equal_all(x, y, name=None):
    a, b = pair(x, y)
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return torch.eq(a, b).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return isclose(x, y, rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = promote(*pair(x, y))
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def is_empty(x, name=None):
    t = as_tensor(x)
    return torch.full((), t.numel() == 0, dtype=torch.bool, device=t.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
