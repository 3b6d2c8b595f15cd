"""paddle.nn counterpart: the layers of the serving and training paths."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (GELU, CrossEntropyLoss, Dropout, Embedding,  # noqa: F401
                    Layer, LayerList, LayerNorm, Linear)
