"""Layers, functionals and gradient clips of the port (``paddle_tpu.nn``
counterpart), kept to what the ported slices use: the transformers'
layers, the common layers (``nn.layer.common``) and functionals
(``nn.functional.common``), and the vision family's convolutions,
pooling, BatchNorms, activations and containers; ``ParamAttr`` says how a
layer makes a parameter (``create_parameter``); ``set_state_dict`` loads
a layer's state with the reference's semantics."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layer_all
from .layer_base import create_parameter, set_state_dict
from .param_attr import ParamAttr

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "ParamAttr", "create_parameter",
           "set_state_dict", *_layer_all]
