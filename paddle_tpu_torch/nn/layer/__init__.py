from .common import Dropout, Embedding, Linear, linear
from .norm import LayerNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "linear"]
