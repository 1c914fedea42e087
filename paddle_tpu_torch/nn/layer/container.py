"""Container layers — counterpart of ``paddle_tpu.nn.layer.container``:
``Sequential``, ``LayerList``, ``LayerDict`` and ``ParameterList`` over
torch's ``nn.Sequential``, ``nn.ModuleList``, ``nn.ModuleDict`` and
``nn.ParameterList``.

Children are named ``"0"``, ``"1"``, … (or by the names given), so
parameters come out named as the reference's do (``features.0.weight``,
``layer1.0.conv1.weight``) and cross over by name."""
from __future__ import annotations

import collections

from torch import nn

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(nn.Sequential):
    """Layers applied in order. Takes layers, ``(name, layer)`` pairs or
    one ``OrderedDict`` of them."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if (isinstance(layer, (list, tuple)) and len(layer) == 2
                    and isinstance(layer[0], str)):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(nn.ModuleList):
    """A list of layers (``append``, ``insert``, ``extend``, indexing)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(nn.ModuleDict):
    """An ordered dict of layers."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    """A list of parameters named ``"0"``, ``"1"``, … (``append``,
    indexing, iteration)."""

    def __init__(self, parameters=None):
        super().__init__(parameters)
