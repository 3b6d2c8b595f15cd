"""paddle_tpu_torch.guard: the training guard plane.

Counterpart of `paddle_tpu/guard/`. The distributed substrate survives
faults of its own (elastic relaunch, the collectives' timeouts); this
package makes the training loop survive them: preemption-safe resume
(SIGTERM -> finish the in-flight step -> a crash-atomic checkpoint of the
whole loop state -> `resume()`), a step watchdog (a hung step or
collective -> `StepStalledError` with its last phase), a divergence guard
(a non-finite or spiking loss -> rollback to the last good snapshot and a
skipped batch, `DivergedError` after `FLAGS_guard_max_bad_steps`) and
cross-rank desync detection (a parameter-fingerprint vote over the
data-parallel group -> `RankDesyncError` naming the offender).
"""
from .errors import (DivergedError, GuardError, PreemptedError,  # noqa: F401
                     RankDesyncError, StepStalledError)
from .watchdog import StepWatchdog  # noqa: F401
from .desync import DesyncDetector, array_crc, fingerprint  # noqa: F401
from .checkpoint import (guard_state_version, has_guard_state,  # noqa: F401
                         load_guard_state, rollback_guard_state,
                         save_guard_state)
from .supervisor import GuardConfig, TrainGuard  # noqa: F401

__all__ = [
    "GuardError", "PreemptedError", "StepStalledError", "DivergedError",
    "RankDesyncError",
    "GuardConfig", "TrainGuard", "StepWatchdog", "DesyncDetector",
    "fingerprint", "array_crc",
    "save_guard_state", "load_guard_state", "has_guard_state",
    "rollback_guard_state", "guard_state_version",
]
