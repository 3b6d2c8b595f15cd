"""paddle.optimizer counterpart: SGD, Adam, AdamW and the lr schedulers
(`optimizer.lr`)."""
from . import lr  # noqa: F401
from .adam import Adam, AdamW  # noqa: F401
from .optimizer import SGD, Optimizer  # noqa: F401
