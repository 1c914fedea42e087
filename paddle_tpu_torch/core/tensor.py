"""``to_tensor`` and grad mode — the functions of ``paddle_tpu.core.tensor``.

The port's tensor is ``torch.Tensor`` itself (``Tensor``), and its
parameter ``torch.nn.Parameter``; ``stop_gradient`` is
``not requires_grad``. Nothing is added to ``torch.Tensor``: the
reference's method surface (``x.reshape(...)`` with its own argument
rules) is not copied, and the tensor functions are called as functions
(``paddle.reshape(x, ...)``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtype_mod
from .place import current_device, place_to_device

__all__ = ["Tensor", "Parameter", "to_tensor", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled"]

Tensor = torch.Tensor
Parameter = torch.nn.Parameter

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _scalars_only(seq) -> bool:
    for x in seq:
        if isinstance(x, (list, tuple)):
            if not _scalars_only(x):
                return False
        elif not isinstance(x, (bool, int, float, complex)):
            return False
    return True


def to_tensor(data, dtype=None, place=None, stop_gradient=True
              ) -> torch.Tensor:
    """A new tensor of ``data`` on ``place`` (default: the current
    device). A Python int gives int64 and a Python float the default
    float dtype; a numpy array keeps its dtype; ``dtype`` overrides.
    ``stop_gradient=False`` makes a float tensor require grad."""
    d = dtype_mod.convert_dtype(dtype)
    dev = (place_to_device(place) if place is not None
           else current_device())
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=d, copy=True)
    else:
        if isinstance(data, (bool, int, float, complex)) or (
                isinstance(data, (list, tuple)) and _scalars_only(data)):
            arr = np.asarray(data)
            if d is None and arr.dtype == np.float64:
                d = dtype_mod.get_default_dtype()
        else:
            arr = np.asarray(data)
        if arr.dtype == object:
            raise TypeError(f"to_tensor: cannot convert {type(data)}")
        out = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if dev.type == "cuda":
            # through pinned memory: the copy does not block the host
            out = out.pin_memory().to(device=dev, non_blocking=True)
        out = out.to(device=dev, dtype=d)
    if (place is not None and getattr(place, "_kind", None) == "gpu_pinned"
            and torch.cuda.is_available()):
        out = out.pin_memory()
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_(True)
    return out
