"""ParamAttr — counterpart of ``paddle_tpu.nn.param_attr``: a
parameter's name, initializer, learning-rate scale, regularizer and
whether it trains or is clipped. Every layer that makes a parameter
reads it (``nn.layer_base.create_parameter``), as ``static.nn`` does; the
optimizers' ``step`` scales the parameter's learning rate by its
``learning_rate``."""
from __future__ import annotations

from . import initializer as I

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"cannot interpret {attr!r} as ParamAttr")
