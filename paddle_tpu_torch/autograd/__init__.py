"""Autograd — counterpart of ``paddle_tpu.autograd``: ``grad``,
``backward``, ``PyLayer`` and the grad-mode switches, over torch's
autograd."""
from __future__ import annotations

from ..core.tensor import (enable_grad, is_grad_enabled, no_grad,
                           set_grad_enabled)
from .functional import backward, grad
from .py_layer import PyLayer, PyLayerContext

__all__ = [
    "no_grad",
    "enable_grad",
    "set_grad_enabled",
    "is_grad_enabled",
    "PyLayer",
    "PyLayerContext",
    "grad",
    "backward",
]
