from .ernie import (ErnieEmbeddings, ErnieForPretraining,  # noqa: F401
                    ErnieForSequenceClassification, ErnieLayer, ErnieMLP,
                    ErnieModel, ErnieScanStack, ErnieSelfAttention,
                    bert_base, bert_large, ernie_base, ernie_large,
                    ernie_titan_10b)
from .gpt import (GPTEmbeddings, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt2_medium, gpt2_small, gpt_10b,
                  gpt_pipeline_layer)
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,  # noqa: F401
                        mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     ResNeXt, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnext50_32x4d, resnext50_64x4d,
                     resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
                     resnext152_64x4d, wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .pp_ocr import PPOCRRec, pp_ocrv3_rec  # noqa: F401
from .small_nets import (AlexNet, DenseNet, GoogLeNet,  # noqa: F401
                         InceptionV3, ShuffleNetV2, SqueezeNet, alexnet,
                         densenet121, densenet161, densenet169, densenet201,
                         densenet264, googlenet, inception_v3,
                         shufflenet_v2_swish, shufflenet_v2_x0_25,
                         shufflenet_v2_x0_33, shufflenet_v2_x0_5,
                         shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                         shufflenet_v2_x2_0, squeezenet1_0, squeezenet1_1)
from .yoloe import PPYOLOE, ppyoloe_l, ppyoloe_m, ppyoloe_s  # noqa: F401
