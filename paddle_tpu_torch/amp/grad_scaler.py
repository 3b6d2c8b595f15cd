"""Dynamic loss scaling for fp16 AMP.

Counterpart of `paddle_tpu/amp/grad_scaler.py` (:53-221), with its surface
and semantics: `scale(loss)` multiplies by the scale, held as a cached
device scalar that is copied to the device again only when the scale
changes; `step(optimizer)` skips the update when a gradient is not finite;
`update()` grows the scale by `incr_ratio` after `incr_every_n_steps` good
steps in a row and shrinks it by `decr_ratio` (not below 1) after
`decr_every_n_nan_or_inf` bad ones.

Under FLAGS_amp_fused_update (default on) `step()` hands the optimizer the
device `inv_scale`, and `Optimizer.step(inv_scale)` unscales, reduces
found_inf and gates the update on the device: no host sync lies between
the backward and the update. found_inf is read on the host once, in
`update()`, where the grow / shrink decision needs it. The explicit
`unscale_(opt) -> clip -> step(opt)` pattern keeps the legacy semantics
(found_inf read on the host in `unscale_`, then the step or the skip), as
does the flag off.

Per-optimizer states (READY, UNSCALED, STEPPED; the reference's
OptimizerState) make sure the gradients are unscaled exactly once, and
raise on `unscale_` or `step` out of order. Skipped steps and scale
changes are counted as `amp.skipped_steps` / `amp.scale_updates`
(FLAGS_monitor), as in the reference.
"""
from __future__ import annotations

import torch

from .. import monitor as _monitor
from ..core import flags as _flags
from ..optimizer.optimizer import Optimizer, unscale_grads_


def _grads_of(optimizer):
    return [p.grad for p in (optimizer._parameter_list or [])
            if p.grad is not None]


class GradScaler:
    # per-optimizer lifecycle (the reference's OptimizerState)
    _READY, _UNSCALED, _STEPPED = 0, 1, 2

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio, self._decr_ratio = incr_ratio, decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_states: dict = {}
        # the scale and its inverse as device scalars (copied again only
        # when the scale changes), and the deferred found_inf of fused
        # (gated) optimizer steps
        self._scale_cached = None
        self._scale_arr = None
        self._inv_scale_arr = None
        self._pending_found: list = []

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def _dev_scales(self, device):
        if self._scale_arr is None or self._scale_cached != self._scale or \
                self._scale_arr.device != device:
            self._scale_cached = self._scale
            self._scale_arr = torch.tensor(self._scale, dtype=torch.float32,
                                           device=device)
            self._inv_scale_arr = torch.tensor(1.0 / self._scale,
                                               dtype=torch.float32,
                                               device=device)
        return self._scale_arr, self._inv_scale_arr

    def _device_of(self, grads):
        if self._scale_arr is not None:
            return self._scale_arr.device
        return grads[0].device

    def scale(self, loss):
        """loss * scale, in the loss's dtype (an fp16 loss may overflow to
        inf, as in the reference; the step is then skipped)."""
        if not self._enable:
            return loss
        s, _ = self._dev_scales(loss.device)
        return loss * s.to(loss.dtype)

    def unscale_(self, optimizer):
        if not self._enable:
            return
        state = self._opt_states.get(id(optimizer), self._READY)
        if state == self._UNSCALED:
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update().")
        if state == self._STEPPED:
            raise RuntimeError("unscale_() is being called after step().")
        grads = _grads_of(optimizer)
        if grads:
            _, inv = self._dev_scales(self._device_of(grads))
            found = unscale_grads_(grads, inv)
            self._found_inf = bool(found) or self._found_inf  # host sync
        self._opt_states[id(optimizer)] = self._UNSCALED

    def _can_fuse(self, optimizer) -> bool:
        """The fused path: unscale and gate inside the optimizer's step.
        Needs the flag, an optimizer of this package and no sparse
        gradient (the sparse rule runs unfused, reference :121-131)."""
        return bool(_flags.flag("amp_fused_update")) and \
            isinstance(optimizer, Optimizer) and \
            not any(g.is_sparse for g in _grads_of(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer), self._READY)
        if state == self._STEPPED:
            raise RuntimeError("step() has already been called on this "
                               "optimizer since the last update().")
        grads = _grads_of(optimizer)
        if state != self._UNSCALED and grads and self._can_fuse(optimizer):
            # fused: unscale, found_inf, gate and update on the device;
            # found_inf comes back as a device flag read in update()
            _, inv = self._dev_scales(self._device_of(grads))
            found = optimizer.step(inv_scale=inv)
            if found is not None:
                self._pending_found.append(optimizer)
        else:
            if state != self._UNSCALED:
                self.unscale_(optimizer)
            if not self._found_inf:
                optimizer.step()
            elif _monitor._ENABLED:
                _monitor.count("amp.skipped_steps")
        self._opt_states[id(optimizer)] = self._STEPPED
        # the scale advances once every optimizer seen this round has
        # stepped: one still UNSCALED keeps its state (and the shared
        # found_inf) until its own step()
        if all(v == self._STEPPED for v in self._opt_states.values()):
            self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def _resolve_found(self):
        """Read the deferred found_inf of the fused steps (the fused
        path's one host sync, after the update is queued) and commit each
        optimizer's step count."""
        for opt in self._pending_found:
            if opt._resolve_pending():
                self._found_inf = True
                if _monitor._ENABLED:
                    _monitor.count("amp.skipped_steps")
        self._pending_found = []

    def update(self):
        self._resolve_found()
        self._opt_states.clear()
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
                if _monitor._ENABLED:
                    _monitor.count("amp.scale_updates")
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
                if _monitor._ENABLED:
                    _monitor.count("amp.scale_updates")
        self._found_inf = False

    def state_dict(self):
        """The whole dynamic-scaling state: the scale, both streak counters
        and the found_inf of an unscale_ whose step() / update() has not
        come yet, so a checkpoint cut between unscale_ and step resumes on
        the same trajectory."""
        self._resolve_found()
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps,
                "found_inf": bool(self._found_inf)}

    def load_state_dict(self, state_dict):
        self._scale = state_dict.get("scale", self._scale)
        self._good_steps = state_dict.get("incr_count", 0)
        self._bad_steps = state_dict.get("decr_count", 0)
        self._found_inf = bool(state_dict.get("found_inf", False))
        self._pending_found = []


__all__ = ["GradScaler"]
