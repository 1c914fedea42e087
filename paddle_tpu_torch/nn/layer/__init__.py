from . import (activation, common, container, decode, distance, loss, norm,
               pooling, rnn, transformer)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .decode import *  # noqa: F401,F403
from .distance import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", *activation.__all__,
           *common.__all__, *container.__all__, *decode.__all__,
           *distance.__all__, *loss.__all__, *norm.__all__,
           *pooling.__all__, *rnn.__all__, *transformer.__all__]
