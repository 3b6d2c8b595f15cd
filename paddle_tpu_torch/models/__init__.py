from .ernie import ErnieLayer, ErnieMLP, ErnieSelfAttention  # noqa: F401
from .gpt import (GPTEmbeddings, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt2_medium, gpt2_small)
