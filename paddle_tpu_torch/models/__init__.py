from .ernie import (ErnieEmbeddings, ErnieForPretraining,  # noqa: F401
                    ErnieForSequenceClassification, ErnieLayer, ErnieMLP,
                    ErnieModel, ErnieSelfAttention, bert_base, bert_large,
                    ernie_base, ernie_large)
from .gpt import (GPTEmbeddings, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt2_medium, gpt2_small)
