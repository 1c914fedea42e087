"""Layers, functionals and gradient clips of the port (``paddle_tpu.nn``
counterpart): the common, convolution, pooling, normalization,
activation, loss, distance and container layers, the recurrent layers,
the Transformer and beam-search decoding, their functionals
(``nn.functional``), the weight reparametrizations of ``nn.utils``, and
``DataParallel``;
``ParamAttr`` says how a layer makes a parameter (``create_parameter``);
``set_state_dict`` loads a layer's state with the reference's
semantics."""
from . import functional, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layer_all
from .layer import loss
from .layer_base import create_parameter, set_state_dict
from .layer_dp import DataParallel
from .param_attr import ParamAttr
from .utils import remove_weight_norm, spectral_norm, weight_norm

__all__ = ["functional", "utils", "loss", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "ParamAttr",
           "create_parameter", "set_state_dict", "weight_norm",
           "remove_weight_norm", "spectral_norm", "DataParallel",
           *_layer_all]
