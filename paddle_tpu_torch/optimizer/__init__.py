from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        LarsMomentum, Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "LarsMomentum", "Adagrad",
           "Adam", "AdamW", "Adamax", "Adadelta", "RMSProp", "Lamb"]
