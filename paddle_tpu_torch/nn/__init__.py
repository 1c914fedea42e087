"""Layers and functionals of the port (``paddle_tpu.nn`` counterpart),
kept to what the ported slices use."""
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear"]
