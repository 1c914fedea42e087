"""Vision (``paddle_tpu.vision`` counterpart): the models (LeNet, the
ResNets, VGG, MobileNet), the datasets, the transforms, the detection
operators (``ops``) and the image loader (``image``)."""
from . import datasets, image, models, ops, transforms

__all__ = ["datasets", "image", "models", "ops", "transforms"]
