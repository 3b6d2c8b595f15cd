"""paddle.amp counterpart: autocast (bf16 or fp16) and `GradScaler`, the
dynamic loss scaling that fp16 AMP needs."""
from .grad_scaler import GradScaler  # noqa: F401
from .state import (amp_enabled, amp_state, auto_cast,  # noqa: F401
                    decorate, maybe_cast)

amp_guard = auto_cast  # fluid alias
