from .activation import GELU, Tanh  # noqa: F401
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import LayerList  # noqa: F401
from .layers import Layer  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import LayerNorm  # noqa: F401
