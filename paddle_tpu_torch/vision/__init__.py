"""Vision (``paddle_tpu.vision`` counterpart): the models (LeNet, ResNet)
and the datasets. ``transforms`` is not ported yet."""
from . import datasets, models

__all__ = ["datasets", "models"]
