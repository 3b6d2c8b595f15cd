"""paddle.amp counterpart (bf16 first). `GradScaler` waits: bf16 needs no
loss scaling."""
from .state import (amp_enabled, amp_state, auto_cast,  # noqa: F401
                    decorate, maybe_cast)
