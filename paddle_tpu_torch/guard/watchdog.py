"""Step watchdog: a hung step becomes a typed StepStalledError.

Counterpart of `paddle_tpu/guard/watchdog.py`. A step blocked in native
code (a collective whose peer is gone, a wedged device transfer) cannot be
interrupted in place, so once a deadline exists each step runs on a
runner thread and the caller waits for it with that deadline: on expiry
the caller gets `StepStalledError` with the last phase the step reported,
and the wedged runner is abandoned (a new runner serves later steps; a
late result of the old one is dropped by its sequence number).

The deadline is `timeout_s` when set, else, once `warmup_steps` steps
completed, max(`min_timeout_s`, `factor` x their trailing median). Before
a deadline exists steps run inline on the caller's thread.
"""
from __future__ import annotations

import queue
import statistics
import threading
import time
from typing import List, Optional

from .. import monitor as _monitor
from .. import obs as _obs
from ..utils import syncwatch as _syncwatch
from .errors import StepStalledError


class StepWatchdog:
    """The deadline supervisor of one training loop (not thread-safe: one
    loop, one watchdog). `run(fn, *args)` runs fn under the current
    deadline; `phase(name)` tags progress; `close()` joins the runner and
    any wedged stragglers within a grace period."""

    def __init__(self, timeout_s: float = 0.0, warmup_steps: int = 5,
                 factor: float = 10.0, min_timeout_s: float = 30.0,
                 history: int = 64):
        self._timeout = float(timeout_s)
        self._warmup = int(warmup_steps)
        self._factor = float(factor)
        self._min_timeout = float(min_timeout_s)
        self._durations: List[float] = []
        self._history = int(history)
        self._phase = "idle"
        self._step = 0
        self._seq = 0
        self._jobs: Optional[queue.Queue] = None
        self._results: Optional[queue.Queue] = None
        self._runner: Optional[threading.Thread] = None
        self._wedged: List[threading.Thread] = []
        self._closed = False

    # ---- phase and deadline ----
    def phase(self, name: str) -> None:
        self._phase = name
        if _obs._ENABLED:
            _obs.mark(name)

    def record(self, duration_s: float) -> None:
        self._durations.append(float(duration_s))
        if len(self._durations) > self._history:
            del self._durations[:-self._history]

    def deadline(self) -> Optional[float]:
        """The per-step deadline in seconds, or None (not armed yet)."""
        if self._timeout > 0:
            return self._timeout
        if len(self._durations) >= max(1, self._warmup):
            med = statistics.median(self._durations)
            return max(self._min_timeout, self._factor * med)
        return None

    # ---- the runner thread ----
    def _ensure_runner(self) -> None:
        if self._runner is not None and self._runner.is_alive():
            return
        self._jobs = queue.Queue()
        self._results = queue.Queue()
        jobs, results = self._jobs, self._results

        def loop():
            while True:
                job = jobs.get()
                if job is None:
                    return
                seq, fn, args, kwargs = job
                try:
                    results.put((seq, True, fn(*args, **kwargs)))
                except BaseException as e:  # noqa: BLE001 (to the caller)
                    results.put((seq, False, e))

        self._runner = _syncwatch.Thread(target=loop, daemon=True,
                                        name="guard-watchdog-runner")
        self._runner.start()

    def run(self, fn, *args, **kwargs):
        """fn under the current deadline: its result, its exception, or
        StepStalledError on expiry."""
        if self._closed:
            raise RuntimeError("StepWatchdog is closed")
        self._step += 1
        dl = self.deadline()
        t0 = time.monotonic()
        if dl is None:  # not armed: inline, no thread
            out = fn(*args, **kwargs)
            self.record(time.monotonic() - t0)
            return out
        self._ensure_runner()
        self._seq += 1
        seq = self._seq
        self._jobs.put((seq, fn, args, kwargs))
        while True:
            remaining = dl - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                rseq, ok, val = self._results.get(timeout=remaining)
            except queue.Empty:
                break
            if rseq != seq:
                continue  # a stale result of a step abandoned earlier
            self.record(time.monotonic() - t0)
            if ok:
                return val
            raise val
        # expired: abandon the runner, blocked inside fn; the sentinel ends
        # its loop if fn ever returns
        self._jobs.put(None)
        self._wedged.append(self._runner)
        self._runner = None
        if _monitor._ENABLED:
            _monitor.count("guard.stalls")
        err = StepStalledError(phase=self._phase, deadline_s=dl,
                               step=self._step)
        if _obs._FR_ENABLED:
            _obs.record_event("guard.stall", phase=self._phase,
                              step=self._step, deadline_s=dl)
            _obs.dump_on_error(err)
        raise err

    # ---- lifecycle ----
    def alive_threads(self) -> List[threading.Thread]:
        out = [t for t in self._wedged if t.is_alive()]
        if self._runner is not None and self._runner.is_alive():
            out.append(self._runner)
        return out

    def close(self, grace_s: float = 5.0) -> None:
        """Stop the runner and join the stragglers within `grace_s`; a
        thread still wedged after it stays behind as a daemon."""
        self._closed = True
        if self._runner is not None and self._jobs is not None:
            self._jobs.put(None)
        deadline = time.monotonic() + grace_s
        for t in ([self._runner] if self._runner else []) + self._wedged:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._wedged = [t for t in self._wedged if t.is_alive()]
        if self._runner is not None and not self._runner.is_alive():
            self._runner = None
