"""Vision (``paddle_tpu.vision`` counterpart): the models (LeNet, the
ResNets, VGG, MobileNet), the datasets and the transforms.
``vision/image.py`` (the PIL loader) is not ported yet."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
