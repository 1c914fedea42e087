"""Argument handling shared by the tensor functions."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.place import current_device
from ..core.tensor import to_tensor

_SCALARS = (bool, int, float, np.bool_, np.integer, np.floating)


def from_host(data, dtype, device) -> torch.Tensor:
    """Host data (a list or numpy array) as a tensor on ``device``: to a
    card through pinned memory, without blocking the host."""
    t = torch.as_tensor(data, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_of(*xs) -> torch.device:
    """The device of the first tensor among ``xs``, else the current
    device."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (list, tuple)):
            for v in x:
                if isinstance(v, torch.Tensor):
                    return v.device
    return current_device()


def as_tensor(x, like=None) -> torch.Tensor:
    """``x`` if it is a tensor, else ``to_tensor(x)`` on ``like``'s device
    (default: the current device)."""
    if isinstance(x, torch.Tensor):
        return x
    return to_tensor(x, place=like.device if isinstance(
        like, torch.Tensor) else None)


def scalar_as(v, t: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-d tensor beside ``t``, in ``t``'s dtype
    where the reference keeps it (a float tensor with any number, an
    integer tensor with an integer), else in the type the number gives.
    Made by a fill on the device: no host-to-device copy."""
    is_int = isinstance(v, (bool, int, np.bool_, np.integer))
    if t.is_floating_point() or t.is_complex() or (
            is_int and t.dtype != torch.bool):
        dt = t.dtype
    elif isinstance(v, (bool, np.bool_)):
        dt = torch.bool
    elif is_int:
        dt = torch.int64
    else:
        dt = dtype_mod.get_default_dtype()
    return torch.full((), v, dtype=dt, device=t.device)


def pair(x, y):
    """Both operands of a binary function as tensors, a Python scalar
    taking the other operand's dtype family (the reference's
    ``_promote_pair``)."""
    if isinstance(x, torch.Tensor) and isinstance(y, _SCALARS):
        return x, scalar_as(y, x)
    if isinstance(y, torch.Tensor) and isinstance(x, _SCALARS):
        return scalar_as(x, y), y
    if isinstance(x, torch.Tensor):
        return x, as_tensor(y, x)
    if isinstance(y, torch.Tensor):
        return as_tensor(x, y), y
    return as_tensor(x), as_tensor(y)


def promote(*ts):
    """The tensors cast to their common dtype (jnp's promotion, which
    torch's matmul family does not do)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


def int_list(v):
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(i.item()) if isinstance(i, torch.Tensor) else int(i)
            for i in v]


def axes(axis):
    """An axis argument as None, an int or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        vals = axis.reshape(-1).tolist()
        return int(vals[0]) if axis.dim() == 0 else tuple(
            int(a) for a in vals)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(axis, ndim):
    """An axis argument as a tuple of non-negative dims (all for None)."""
    ax = axes(axis)
    if ax is None:
        return tuple(range(ndim))
    if isinstance(ax, int):
        ax = (ax,)
    return tuple(a % ndim if ndim else 0 for a in ax)


def shape_arg(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def dtype_arg(dtype, default=None) -> torch.dtype:
    d = dtype_mod.convert_dtype(dtype)
    if d is None:
        d = default if default is not None else (
            dtype_mod.get_default_dtype())
    return d


def to_float(x: torch.Tensor) -> torch.Tensor:
    """``x`` if it is floating or complex, else in the default float
    dtype."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtype_mod.get_default_dtype())
