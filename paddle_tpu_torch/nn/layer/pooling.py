"""Pooling layers — counterpart of ``paddle_tpu.nn.layer.pooling``: each
calls its ``nn.functional`` pooling with the options it was built with."""
from __future__ import annotations

from torch import nn

from ..functional import pooling as P

__all__ = [
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D",
]


def _pool_layer(name, fn):
    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        nn.Module.__init__(self)
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kw = kw

    def forward(self, x):
        return fn(x, self.kernel_size, self.stride, self.padding, **self.kw)

    return type(name, (nn.Module,), {
        "__init__": __init__, "forward": forward, "__module__": __name__,
        "__doc__": f"Layer form of ``nn.functional.{fn.__name__}``."})


def _adaptive_layer(name, fn):
    def __init__(self, output_size, **kw):
        nn.Module.__init__(self)
        self.output_size = output_size
        self.kw = kw

    def forward(self, x):
        return fn(x, self.output_size, **self.kw)

    return type(name, (nn.Module,), {
        "__init__": __init__, "forward": forward, "__module__": __name__,
        "__doc__": f"Layer form of ``nn.functional.{fn.__name__}``."})


MaxPool1D = _pool_layer("MaxPool1D", P.max_pool1d)
MaxPool2D = _pool_layer("MaxPool2D", P.max_pool2d)
MaxPool3D = _pool_layer("MaxPool3D", P.max_pool3d)
AvgPool1D = _pool_layer("AvgPool1D", P.avg_pool1d)
AvgPool2D = _pool_layer("AvgPool2D", P.avg_pool2d)
AvgPool3D = _pool_layer("AvgPool3D", P.avg_pool3d)
AdaptiveAvgPool1D = _adaptive_layer("AdaptiveAvgPool1D",
                                    P.adaptive_avg_pool1d)
AdaptiveAvgPool2D = _adaptive_layer("AdaptiveAvgPool2D",
                                    P.adaptive_avg_pool2d)
AdaptiveAvgPool3D = _adaptive_layer("AdaptiveAvgPool3D",
                                    P.adaptive_avg_pool3d)
AdaptiveMaxPool1D = _adaptive_layer("AdaptiveMaxPool1D",
                                    P.adaptive_max_pool1d)
AdaptiveMaxPool2D = _adaptive_layer("AdaptiveMaxPool2D",
                                    P.adaptive_max_pool2d)
AdaptiveMaxPool3D = _adaptive_layer("AdaptiveMaxPool3D",
                                    P.adaptive_max_pool3d)
