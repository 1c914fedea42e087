"""Vision models (``paddle_tpu.vision.models`` counterpart): LeNet, the
ResNet family, VGG and MobileNetV1/V2."""
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "MobileNetV1", "MobileNetV2",
           "mobilenet_v1", "mobilenet_v2"]
