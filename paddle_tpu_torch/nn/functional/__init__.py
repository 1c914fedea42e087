from . import activation, common, conv, pooling
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import cross_entropy
from .norm import batch_norm
from .pooling import *  # noqa: F401,F403

__all__ = ["cross_entropy", "batch_norm", "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           *activation.__all__, *common.__all__, *pooling.__all__]
