"""Typed failures of the training guard plane.

Counterpart of `paddle_tpu/guard/errors.py`: the three failures a clean
exception never covers on a long run (a preemption, a wedged step or
collective, a silent numeric or cross-rank divergence), each carrying
what a relauncher needs to choose between resume, rollback and abort
(the phase, the step, the offending ranks, the checkpoint directory).
Each registers a flight-recorder dump reason (`obs.dump_on_error`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .. import obs as _obs


class GuardError(RuntimeError):
    """Base of every guard-plane failure."""


class PreemptedError(GuardError):
    """A preemption signal (SIGTERM/SIGINT) arrived; the in-flight step
    finished and the whole loop state was committed to `ckpt_dir`.
    `TrainGuard.resume()` after the relaunch continues bit-identically
    from `cursor`."""

    def __init__(self, signum: int, ckpt_dir: Optional[str],
                 cursor: Tuple[int, int]):
        self.signum = signum
        self.ckpt_dir = ckpt_dir
        self.cursor = cursor
        where = f"epoch {cursor[0]}, batch {cursor[1]}"
        saved = f"; loop state checkpointed to {ckpt_dir}" if ckpt_dir \
            else " (no ckpt_dir configured — state NOT saved)"
        super().__init__(
            f"training preempted by signal {signum} at {where}{saved}; "
            f"call TrainGuard.resume() after relaunch")


class StepStalledError(GuardError):
    """The step watchdog's deadline expired with the step still running:
    a hung collective or a wedged device as a typed error. `phase` is the
    last phase the step reported."""

    def __init__(self, phase: str, deadline_s: float, step: int):
        self.phase = phase
        self.deadline_s = deadline_s
        self.step = step
        super().__init__(
            f"train step {step} exceeded its {deadline_s:.3f}s watchdog "
            f"deadline (last-known phase: {phase!r}); the step thread is "
            f"likely wedged in a hung collective or device transfer")


class DivergedError(GuardError):
    """`max_bad_steps` consecutive steps gave a non-finite or spiking
    loss, each rolled back to the last good snapshot: the run diverged."""

    def __init__(self, bad_steps: int, last_loss, step: int):
        self.bad_steps = bad_steps
        self.last_loss = last_loss
        self.step = step
        super().__init__(
            f"training diverged: {bad_steps} consecutive bad steps up to "
            f"step {step} (last loss {last_loss}); params were rolled back "
            f"to the last-good snapshot each time")


class RankDesyncError(GuardError):
    """Parameter fingerprints disagree across the data-parallel group.
    Names the minority side of the vote (ties broken toward the lowest
    rank's value)."""

    def __init__(self, step: int, offenders: List[int], fingerprints):
        self.step = step
        self.offenders = list(offenders)
        self.fingerprints = dict(fingerprints)
        super().__init__(
            f"cross-rank parameter desync at step {step}: rank(s) "
            f"{self.offenders} disagree with the group "
            f"(fingerprints: {self.fingerprints})")


_obs.register_dump_trigger(PreemptedError, "preempted")
_obs.register_dump_trigger(StepStalledError, "step_stalled")
_obs.register_dump_trigger(DivergedError, "diverged")
_obs.register_dump_trigger(RankDesyncError, "rank_desync")
