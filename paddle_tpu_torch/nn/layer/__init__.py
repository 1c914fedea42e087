from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation_all
from .common import *  # noqa: F401,F403
from .common import __all__ as _common_all
from .container import LayerDict, LayerList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .loss import CrossEntropyLoss
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling_all

__all__ = ["CrossEntropyLoss", "LayerNorm", "Sequential", "LayerList",
           "LayerDict", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", *_common_all, *_activation_all,
           *_pooling_all]
