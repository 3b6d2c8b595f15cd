"""paddle.optimizer counterpart: SGD, Adam, AdamW. The lr schedulers
(`optimizer/lr.py`) are not ported yet."""
from .adam import Adam, AdamW  # noqa: F401
from .optimizer import SGD, Optimizer  # noqa: F401
