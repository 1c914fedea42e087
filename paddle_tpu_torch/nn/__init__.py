"""Layers, functionals and gradient clips of the port (``paddle_tpu.nn``
counterpart), kept to what the ported slices use."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import CrossEntropyLoss, Dropout, Embedding, LayerNorm, Linear

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "CrossEntropyLoss", "Dropout", "Embedding", "LayerNorm", "Linear"]
