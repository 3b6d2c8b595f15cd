"""paddle.vision.models counterpart: 25 of the reference's 49 names
(`paddle_tpu/vision/models/__init__.py`), re-exported from
`paddle_tpu_torch.models`: ResNet (8), ResNeXt (7), VGG (5), MobileNet (4)
and LeNet. DenseNet, AlexNet, InceptionV3, SqueezeNet, GoogLeNet and
ShuffleNetV2 are not ported yet."""
from ...models import (  # noqa: F401
    LeNet, MobileNetV1, MobileNetV2, ResNet, ResNeXt, VGG, mobilenet_v1,
    mobilenet_v2, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d, vgg11, vgg13, vgg16, vgg19,
    wide_resnet50_2, wide_resnet101_2)
