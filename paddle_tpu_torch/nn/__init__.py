"""paddle.nn counterpart: every name of the reference's `paddle.nn`."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .layer.layers import Layer  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from . import utils  # noqa: F401
