"""paddle.vision.models counterpart: every name of the reference's
namespace (`paddle_tpu/vision/models/__init__.py`), re-exported from
`paddle_tpu_torch.models`."""
from ...models import (  # noqa: F401
    AlexNet, DenseNet, GoogLeNet, InceptionV3, LeNet, MobileNetV1,
    MobileNetV2, ResNet, ResNeXt, ShuffleNetV2, SqueezeNet, VGG, alexnet,
    densenet121, densenet161, densenet169, densenet201, densenet264,
    googlenet, inception_v3, mobilenet_v1, mobilenet_v2, resnet18, resnet34,
    resnet50, resnet101, resnet152, resnext50_32x4d, resnext50_64x4d,
    resnext101_32x4d, resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
    shufflenet_v2_swish, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, squeezenet1_0, squeezenet1_1, vgg11, vgg13, vgg16,
    vgg19, wide_resnet50_2, wide_resnet101_2)
