"""Layers, functionals and gradient clips of the port (``paddle_tpu.nn``
counterpart), kept to what the ported slices use: the transformers'
layers, and the vision family's convolutions, pooling, BatchNorms,
activations and containers."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layer_all

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", *_layer_all]
