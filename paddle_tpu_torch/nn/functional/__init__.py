from . import activation, common, conv, loss, norm, pooling, vision
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403
from ..layer.decode import gather_tree

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "gather_tree",
           *activation.__all__, *common.__all__, *loss.__all__,
           *norm.__all__, *pooling.__all__, *vision.__all__]
