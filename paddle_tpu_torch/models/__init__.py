from .ernie import (ErnieEmbeddings, ErnieForPretraining,  # noqa: F401
                    ErnieForSequenceClassification, ErnieLayer, ErnieMLP,
                    ErnieModel, ErnieScanStack, ErnieSelfAttention,
                    bert_base, bert_large, ernie_base, ernie_large,
                    ernie_titan_10b)
from .gpt import (GPTEmbeddings, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt2_medium, gpt2_small)
