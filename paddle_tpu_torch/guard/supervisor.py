"""TrainGuard: the training-loop supervisor.

Counterpart of `paddle_tpu/guard/supervisor.py`. Wraps a `jit.TrainStep`
(or anything with its `__call__`, `state_dict`, `set_state_dict` and
`named_param_arrays`) with four guards:

  1. preemption-safe resume: SIGTERM / SIGINT set a flag; the in-flight
     step finishes, then the whole loop state (parameters, optimizer
     slots, the step count and device t, every generator of
     `core.random`, the GradScaler's streaks, the LR scheduler, the
     epoch and batch cursor) is committed crash-atomically
     (`guard/checkpoint.py`) and `PreemptedError` is raised. `resume()`
     restores all of it, so an interrupted run ends with the parameters
     of an uninterrupted one, bit for bit where the step itself repeats
     bitwise (on the card: under `torch.use_deterministic_algorithms`,
     whose flash backward is the two-pass kernels);
  2. the step watchdog (`StepWatchdog`): a wedged step surfaces as
     `StepStalledError` with its last phase;
  3. the divergence guard: a non-finite loss (also `FLAGS_check_nan_inf`'s
     FloatingPointError, which TrainStep and the op dispatch raise after
     the step committed) or a spike past `loss_spike_ratio` x the trailing
     median rolls parameters, slots, step state, generators and scaler
     back to the rolling in-memory snapshot and skips the batch;
     `DivergedError` after `max_bad_steps` in a row;
  4. cross-rank desync detection: every `desync_interval` good steps the
     parameter fingerprint is voted on through the rendezvous store
     (`guard/desync.py`).

Counters (FLAGS_monitor): `guard.steps`, `guard.bad_steps`,
`guard.rollbacks`, `guard.snapshots`, `guard.checkpoints`,
`guard.stalls`, `guard.step_errors`, `guard.preempts`, `guard.resumes`,
`guard.desync_checks`, `guard.desync_errors`. Fault sites: `guard.step`
(inside the supervised step), `guard.snapshot` and `guard.snapshot.write`.

`timeline_report()` merges every rank's step timeline through the
rendezvous store (`obs/merge.py`) and names the straggler rank per phase.

Not ported with this module: the reference's `hapi.Model.fit(guard=...)`
hook (the port has no `hapi/` yet).
"""
from __future__ import annotations

import signal as _signal
import statistics
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .. import faults as _faults
from .. import monitor as _monitor
from .. import obs as _obs
from ..core import flags as _flags
from ..core import random as _rnd
from ..obs import memory as _mem
from .checkpoint import has_guard_state, load_guard_state, save_guard_state
from .desync import DesyncDetector
from .errors import DivergedError, GuardError, PreemptedError
from .watchdog import StepWatchdog


class GuardConfig:
    """The guard's knobs, seeded from FLAGS_guard_* by `from_flags`."""

    def __init__(self, step_timeout_s: float = 0.0, warmup_steps: int = 5,
                 timeout_factor: float = 10.0, min_timeout_s: float = 30.0,
                 loss_spike_ratio: float = 10.0, snapshot_interval: int = 25,
                 max_bad_steps: int = 3, desync_interval: int = 0,
                 desync_timeout_s: float = 30.0):
        self.step_timeout_s = float(step_timeout_s)
        self.warmup_steps = int(warmup_steps)
        self.timeout_factor = float(timeout_factor)
        self.min_timeout_s = float(min_timeout_s)
        self.loss_spike_ratio = float(loss_spike_ratio)
        self.snapshot_interval = int(snapshot_interval)
        self.max_bad_steps = int(max_bad_steps)
        self.desync_interval = int(desync_interval)
        self.desync_timeout_s = float(desync_timeout_s)

    @classmethod
    def from_flags(cls, **overrides) -> "GuardConfig":
        cfg = cls(
            step_timeout_s=_flags.flag("guard_step_timeout_s"),
            warmup_steps=_flags.flag("guard_warmup_steps"),
            timeout_factor=_flags.flag("guard_timeout_factor"),
            min_timeout_s=_flags.flag("guard_min_timeout_s"),
            loss_spike_ratio=_flags.flag("guard_loss_spike_ratio"),
            snapshot_interval=_flags.flag("guard_snapshot_interval"),
            max_bad_steps=_flags.flag("guard_max_bad_steps"),
            desync_interval=_flags.flag("guard_desync_interval"),
            desync_timeout_s=_flags.flag("guard_desync_timeout_s"))
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise TypeError(f"GuardConfig has no knob {k!r}")
            setattr(cfg, k, v)
        return cfg


_PREEMPT_SIGNALS = (_signal.SIGTERM, _signal.SIGINT)


class TrainGuard:
    """Supervises one training loop. Use it as a context manager, so the
    signal handlers and the watchdog's runner are always torn down:

        step = TrainStep(model, loss_fn, opt)
        with TrainGuard(step, ckpt_dir="ckpt/guard") as guard:
            start = guard.resume() or (0, 0)
            for epoch in range(epochs):
                for b, (x, y) in enumerate(batches):
                    if (epoch, b) < start:
                        continue          # fast-forward after a resume
                    guard.set_cursor(epoch, b)
                    loss = guard.step(x, y)   # None: a bad step skipped
    """

    def __init__(self, step, ckpt_dir: Optional[str] = None,
                 config: Optional[GuardConfig] = None, scaler=None,
                 store=None, rank: int = 0, world_size: int = 1,
                 signals=_PREEMPT_SIGNALS):
        self._step_fn = step
        self.ckpt_dir = ckpt_dir
        self.cfg = config or GuardConfig.from_flags()
        self.scaler = scaler
        self._signals = tuple(signals)
        self._watchdog = StepWatchdog(
            timeout_s=self.cfg.step_timeout_s,
            warmup_steps=self.cfg.warmup_steps,
            factor=self.cfg.timeout_factor,
            min_timeout_s=self.cfg.min_timeout_s)
        self._store = store
        self._rank = int(rank)
        self._world_size = int(world_size)
        self._tl_round = 0
        self._detector = None
        if store is not None and world_size > 1:
            self._detector = DesyncDetector(
                store, rank, world_size,
                timeout_s=self.cfg.desync_timeout_s)
        self._snapshot = None
        self._good_losses = []
        self._consec_bad = 0
        self._good_steps = 0
        self._desync_round = 0
        self._cursor: Tuple[int, int] = (0, 0)
        self._next_cursor: Tuple[int, int] = (0, 0)
        self.resume_cursor: Optional[Tuple[int, int]] = None
        self._preempt_signum: Optional[int] = None
        self._prev_handlers: Dict[int, object] = {}
        self._closed = False

    # ---- lifecycle ----
    def __enter__(self) -> "TrainGuard":
        self.install_signal_handlers()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def install_signal_handlers(self) -> None:
        """From the main thread only (Python delivers signals there, so a
        step on the watchdog's thread never swallows one). The handlers
        only set a flag: the in-flight step finishes before the
        checkpoint is cut."""
        for sig in self._signals:
            if sig not in self._prev_handlers:
                self._prev_handlers[sig] = _signal.getsignal(sig)
            _signal.signal(sig, self._on_signal)

    def restore_signal_handlers(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        self._preempt_signum = signum
        if _monitor._ENABLED:
            _monitor.count("guard.preempts")

    def close(self, grace_s: float = 5.0) -> None:
        if self._closed:
            return
        self._closed = True
        self.restore_signal_handlers()
        self._watchdog.close(grace_s=grace_s)

    # ---- cursor ----
    def set_cursor(self, epoch: int, batch: int) -> None:
        """The batch the next step() consumes, so a preemption checkpoint
        knows where the data loader must resume."""
        self._cursor = (int(epoch), int(batch))

    # ---- the guarded step ----
    def step(self, *batch) -> Optional[float]:
        """One supervised step: the loss as a float, or None when the
        divergence guard skipped the batch (state rolled back). Raises
        StepStalledError, DivergedError, RankDesyncError or
        PreemptedError."""
        if self._closed:
            raise RuntimeError("TrainGuard is closed")
        with _obs.step_record():
            return self._step_guarded(*batch)

    def _step_guarded(self, *batch) -> Optional[float]:
        if self._snapshot is None:
            self._maybe_first_snapshot()
        watchdog = self._watchdog

        def supervised():
            watchdog.phase("dispatch")
            if _faults._ENABLED:
                _faults.check("guard.step")
            loss_t = self._step_fn(*batch)
            watchdog.phase("host-sync")
            return float(loss_t)

        bad_reason = None
        loss = None
        try:
            loss = watchdog.run(supervised)
        except FloatingPointError as e:
            # FLAGS_check_nan_inf: the step committed a poisoned state
            bad_reason = f"non-finite (check_nan_inf): {e}"
        except GuardError:
            raise
        except Exception:
            if _monitor._ENABLED:
                _monitor.count("guard.step_errors")
            raise
        if bad_reason is None:
            if not np.isfinite(loss):
                bad_reason = f"non-finite loss {loss}"
            elif self._is_spike(loss):
                bad_reason = (f"loss spike {loss:.6g} > "
                              f"{self.cfg.loss_spike_ratio}x trailing median")
        if bad_reason is not None:
            return self._handle_bad_step(loss, bad_reason)
        # ---- a good step ----
        self._consec_bad = 0
        self._good_steps += 1
        self._good_losses.append(loss)
        if len(self._good_losses) > 64:
            del self._good_losses[:-64]
        if _monitor._ENABLED:
            _monitor.count("guard.steps")
        self._next_cursor = (self._cursor[0], self._cursor[1] + 1)
        if self.cfg.snapshot_interval > 0 and \
                self._good_steps % self.cfg.snapshot_interval == 0:
            self._take_snapshot()
        if self._detector is not None and self.cfg.desync_interval > 0 and \
                self._good_steps % self.cfg.desync_interval == 0:
            self._desync_round += 1
            with _obs.phase("desync"):
                self._detector.check(self._desync_round,
                                     self._step_fn.named_param_arrays())
        if self._preempt_signum is not None:
            signum = self._preempt_signum
            self._preempt_signum = None
            if self.ckpt_dir:
                self.checkpoint()
            err = PreemptedError(signum, self.ckpt_dir, self._next_cursor)
            if _obs._FR_ENABLED:
                _obs.record_event("guard.preempt", signum=signum,
                                  ckpt_dir=self.ckpt_dir,
                                  cursor=list(self._next_cursor))
                _obs.dump_on_error(err)
            raise err
        return loss

    def _is_spike(self, loss: float) -> bool:
        if self.cfg.loss_spike_ratio <= 0 or len(self._good_losses) < 3:
            return False
        med = statistics.median(self._good_losses)
        if med <= 0:  # only meaningful for positive losses
            return False
        return loss > self.cfg.loss_spike_ratio * med

    def _handle_bad_step(self, loss, reason: str) -> None:
        self._consec_bad += 1
        if _monitor._ENABLED:
            _monitor.count("guard.bad_steps")
        if _obs._FR_ENABLED:
            _obs.record_event("guard.bad_step", reason=reason,
                              consec_bad=self._consec_bad,
                              step=self._good_steps + 1)
        self._rollback()
        if self._consec_bad >= max(1, self.cfg.max_bad_steps):
            err = DivergedError(bad_steps=self._consec_bad, last_loss=loss,
                                step=self._good_steps + 1)
            if _obs._FR_ENABLED:
                _obs.dump_on_error(err)
            raise err
        return None

    # ---- the rolling in-memory snapshot ----
    def _maybe_first_snapshot(self) -> None:
        """A last-good snapshot must exist before the first bad step.
        TrainStep builds (and so snapshots) without a batch; a step that
        cannot raises RuntimeError, and its first snapshot comes after
        step 1."""
        try:
            self._take_snapshot()
        except RuntimeError:
            pass

    def _take_snapshot(self) -> None:
        """Host copies of the step's state, the generators and the
        scaler."""
        with _obs.phase("snapshot"):
            snap = {"step": self._step_fn.state_dict(),
                    "rng": _rnd.get_rng_state()}
            if self.scaler is not None:
                snap["scaler"] = self.scaler.state_dict()
            self._snapshot = snap
        if _mem._ENABLED:
            _mem.census()
        if _monitor._ENABLED:
            _monitor.count("guard.snapshots")

    def _rollback(self) -> None:
        if self._snapshot is None:
            return
        self._step_fn.set_state_dict(self._snapshot["step"])
        _rnd.set_rng_state(self._snapshot["rng"])
        if self.scaler is not None and "scaler" in self._snapshot:
            self.scaler.load_state_dict(self._snapshot["scaler"])
        if _monitor._ENABLED:
            _monitor.count("guard.rollbacks")
        if _obs._FR_ENABLED:
            _obs.record_event("guard.rollback", step=self._good_steps + 1)

    # ---- the durable checkpoint ----
    def _lr_scheduler(self):
        opt = getattr(self._step_fn, "optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "state_dict") else None

    def checkpoint(self) -> str:
        """Commit the whole loop state crash-atomically to ckpt_dir."""
        if not self.ckpt_dir:
            raise ValueError("TrainGuard has no ckpt_dir configured")
        with _obs.phase("checkpoint"):
            return self._checkpoint_impl()

    def _checkpoint_impl(self) -> str:
        sd = self._step_fn.state_dict()
        arrays: Dict[str, np.ndarray] = {}
        for n, v in sd["params"].items():
            arrays[f"params/{n}"] = v
        for i, s in enumerate(sd["slots"]):
            for k, v in s.items():
                arrays[f"slots/{i}/{k}"] = v
        arrays["step/t"] = sd["t"]
        # the generators' states (one list entry per card for "cuda")
        rng_lens = {}
        for name, v in sd["rng_key"].items():
            if isinstance(v, list):
                rng_lens[name] = len(v)
                for i, x in enumerate(v):
                    arrays[f"rng/{name}/{i}"] = x
            else:
                rng_lens[name] = None
                arrays[f"rng/{name}"] = v
        meta = {
            "kind": sd["kind"],
            "step_count": sd["step_count"],
            "cursor": list(self._next_cursor),
            "good_steps": self._good_steps,
            "good_losses": [float(x) for x in self._good_losses[-16:]],
            "rng": rng_lens,
            "slot_keys": [sorted(s) for s in sd["slots"]],
            "param_names": sorted(sd["params"]),
            "wallclock": time.time(),
        }
        if self.scaler is not None:
            meta["scaler"] = self.scaler.state_dict()
        sched = self._lr_scheduler()
        if sched is not None:
            meta["lr_scheduler"] = sched.state_dict()
        save_guard_state(self.ckpt_dir, arrays, meta)
        return self.ckpt_dir

    def resume(self) -> Optional[Tuple[int, int]]:
        """Restore the loop from the newest intact guard checkpoint: the
        (epoch, batch) cursor to fast-forward to, or None when there is
        no checkpoint (a fresh start)."""
        if not self.ckpt_dir or not has_guard_state(self.ckpt_dir):
            return None
        arrays, meta = load_guard_state(self.ckpt_dir)
        rng = {name: arrays[f"rng/{name}"] if n is None else
               [arrays[f"rng/{name}/{i}"] for i in range(n)]
               for name, n in meta["rng"].items()}
        sd = {"kind": meta["kind"],
              "params": {n: arrays[f"params/{n}"]
                         for n in meta["param_names"]},
              "slots": [{k: arrays[f"slots/{i}/{k}"] for k in keys}
                        for i, keys in enumerate(meta["slot_keys"])],
              "rng_key": rng, "t": arrays["step/t"],
              "step_count": meta["step_count"]}
        self._step_fn.set_state_dict(sd)
        if self.scaler is not None and "scaler" in meta:
            self.scaler.load_state_dict(meta["scaler"])
        sched = self._lr_scheduler()
        if sched is not None and "lr_scheduler" in meta:
            sched.set_state_dict(meta["lr_scheduler"])
        self._good_steps = int(meta.get("good_steps", 0))
        self._good_losses = [float(x) for x in meta.get("good_losses", [])]
        self._consec_bad = 0
        self._snapshot = None
        self.resume_cursor = tuple(meta["cursor"])
        if _monitor._ENABLED:
            _monitor.count("guard.resumes")
        if _obs._FR_ENABLED:
            _obs.record_event("guard.resume", ckpt_dir=self.ckpt_dir,
                              cursor=list(self.resume_cursor))
        return self.resume_cursor

    # ---- pod timeline (obs cross-rank merge) ----
    def timeline_report(self, timeout_s: Optional[float] = None):
        """Merge every rank's step timeline into one pod timeline and name
        the straggler rank per phase. Multi-rank (a rendezvous store was
        passed): all ranks MUST call this collectively — records are
        exchanged through the store like desync fingerprints. Single rank:
        a local merge of this process's timeline. Returns
        (merged_dict, report_str); timeline disabled -> (None, explanation).
        """
        if not _obs._TL_ENABLED:
            return None, ("step timeline disabled — set "
                          "FLAGS_obs_timeline=1 to record phases")
        records = _obs.timeline().records()
        if self._store is not None and self._world_size > 1:
            self._tl_round += 1
            per_rank = _obs.gather_timelines(
                self._store, self._rank, self._world_size, records,
                key=f"obs/tl/{self._tl_round}",
                timeout_s=timeout_s if timeout_s is not None
                else self.cfg.desync_timeout_s)
        else:
            per_rank = {self._rank: _obs.slim_records(records)}
        merged = _obs.merge_timelines(per_rank)
        return merged, _obs.straggler_report(merged)
