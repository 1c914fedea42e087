"""``paddle_tpu_torch.tensor`` — the tensor function namespace,
counterpart of ``paddle_tpu.tensor``.

Plain functions on ``torch.Tensor`` with the reference's names,
arguments and rules, differentiated by torch's autograd. Unlike the
reference, nothing is attached to the tensor class as a method:
``torch.Tensor`` keeps torch's own methods, and these are called as
functions (``paddle.reshape(x, [0, -1])``).
"""
from __future__ import annotations

from ..core.tensor import Tensor, to_tensor  # noqa: F401
from ..static.control_flow import (array_length, array_read,  # noqa: F401
                                   array_write, create_array)
from . import (attribute, creation, linalg, logic, manipulation, math,
               random, search, sequence, stat, to_string)
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .to_string import *  # noqa: F401,F403

__all__ = sorted(
    {"Tensor", "to_tensor", "array_length", "array_read", "array_write",
     "create_array"}.union(*(m.__all__ for m in (
         attribute, creation, linalg, logic, manipulation, math, random,
         search, sequence, stat, to_string))))
