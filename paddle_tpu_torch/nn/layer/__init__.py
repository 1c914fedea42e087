from .common import Dropout, Embedding, Linear, linear
from .loss import CrossEntropyLoss
from .norm import LayerNorm

__all__ = ["CrossEntropyLoss", "Dropout", "Embedding", "LayerNorm", "Linear",
           "linear"]
