"""Creation functions — counterpart of ``paddle_tpu.tensor.creation``.

Functions that take no tensor make theirs on the current device
(``core.place.set_device``); the ``*_like`` functions on their input's.
A Python int fill gives int64, a bool gives bool, and anything else the
default float dtype, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.place import current_device
from ..core.tensor import to_tensor
from ._util import as_tensor, dtype_arg, shape_arg

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye", "diag",
    "diagflat", "tril", "triu", "meshgrid", "assign", "clone", "numel",
    "complex", "tril_indices", "triu_indices", "one_hot", "create_parameter",
]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A learnable parameter on the current device, made as ``attr`` says
    (``static.nn.create_parameter``)."""
    from ..static.nn import create_parameter as _create

    return _create(shape_arg(shape), dtype, name=name, attr=attr,
                   is_bias=is_bias,
                   default_initializer=default_initializer,
                   device=current_device())


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_arg(shape), dtype=dtype_arg(dtype),
                       device=current_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(shape_arg(shape), dtype=dtype_arg(dtype),
                      device=current_device())


def full(shape, fill_value, dtype=None, name=None):
    if dtype is None:
        v = fill_value
        if isinstance(v, torch.Tensor):
            dtype = v.dtype if not v.is_floating_point() else None
        elif isinstance(v, (bool, np.bool_)):
            dtype = torch.bool
        elif isinstance(v, (int, np.integer)):
            dtype = torch.int64
    dt = dtype_arg(dtype)
    if isinstance(fill_value, torch.Tensor):
        # a fill read on the device, no sync
        out = torch.empty(shape_arg(shape), dtype=dt, device=current_device())
        return out.copy_(fill_value.reshape(()).detach().expand_as(out))
    return torch.full(shape_arg(shape), fill_value, dtype=dt,
                      device=current_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    t = as_tensor(x)
    return torch.zeros_like(t, dtype=dtype_mod.convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    t = as_tensor(x)
    return torch.ones_like(t, dtype=dtype_mod.convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    t = as_tensor(x)
    return torch.full_like(t, _value(fill_value),
                           dtype=dtype_mod.convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    start, end, step = _value(start), _value(end), _value(step)
    if dtype is None and any(isinstance(v, float) for v in (start, end,
                                                             step)):
        dtype = dtype_mod.get_default_dtype()
    return torch.arange(start, end, step, dtype=dtype_arg(dtype,
                                                          torch.int64),
                        device=current_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_value(start), _value(stop), int(_value(num)),
                          dtype=dtype_arg(dtype), device=current_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(float(_value(start)), float(_value(stop)),
                          int(_value(num)), base=float(base),
                          dtype=dtype_arg(dtype), device=current_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=dtype_arg(dtype), device=current_device())


def diag(x, offset=0, padding_value=0, name=None):
    x = as_tensor(x)
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones(x.shape[0], dtype=torch.bool,
                                     device=x.device), offset)
        out = torch.where(mask, out, torch.full((), padding_value,
                                                dtype=out.dtype,
                                                device=out.device))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(as_tensor(x), offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(as_tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(as_tensor(x), diagonal)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.tril_indices(int(row), int(col), int(offset),
                              dtype=dtype_arg(dtype, torch.int64),
                              device=current_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              dtype=dtype_arg(dtype, torch.int64),
                              device=current_device())


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*[as_tensor(a) for a in args],
                               indexing="ij"))


def assign(x, output=None):
    """A copy of ``x`` (differentiable); written into ``output`` when one
    is given."""
    src = x if isinstance(x, torch.Tensor) else to_tensor(np.asarray(x))
    if output is not None:
        return output.copy_(src)
    return src.clone()


def clone(x, name=None):
    return x.clone()


def numel(x, name=None):
    t = as_tensor(x)
    return torch.full((), t.numel(), dtype=torch.int64, device=t.device)


def complex(real, imag, name=None):
    return torch.complex(as_tensor(real), as_tensor(imag, real))


def one_hot(x, num_classes, name=None):
    """Rows of the default float dtype, all zeros for an out-of-range
    class (a comparison on the device: no sync)."""
    x = as_tensor(x)
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.unsqueeze(-1) == classes).to(dtype_mod.get_default_dtype())
