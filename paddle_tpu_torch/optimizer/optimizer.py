"""Optimizer base, SGD and Momentum.

Counterpart of `paddle_tpu/optimizer/optimizer.py` (:32-419, `_clip_fn`
:421, Momentum :461). The update rules are elementwise, so they stay
PyTorch ops, as the reference leaves them to XLA: each rule is written
here over a list of parameters with `torch._foreach_*` ops, so one step
launches a few kernels for every group of parameters that share a
learning rate and a weight decay, not ~10 for each parameter. The rule, the slot names and the
`state_dict` keys are the reference's.

Where the reference donates the parameter and slot buffers to its jitted
update, the port updates them in place: `functional_update` writes the
new values into the `values` and `slots` tensors it is given and returns
them.

`step(inv_scale)` is the reference's fused loss-scaler step (:140-305),
which `amp.GradScaler.step` takes under FLAGS_amp_fused_update: the
gradients are unscaled in place and one device found_inf is reduced over
them (`torch._amp_foreach_non_finite_check_and_unscale_`, where the
reference fuses the same into its XLA update), the update runs, and a
gate keeps each parameter, its slots and the device step count
bit-unchanged when found_inf is set. The host reads found_inf only in
`_resolve_pending()`, after the update is queued. Unlike the reference,
whose update is functional, `p.grad` holds the unscaled gradient
afterwards (as after `GradScaler.unscale_`): an unscaled copy of every
gradient would cost a model's worth of memory.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                       _global_factor, _norm_factor)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is not None:
            parameters = list(parameters)
        self._parameter_list: Optional[List[torch.Tensor]] = parameters
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:  # L2Decay object
            self._weight_decay = float(getattr(weight_decay, "_coeff", 0.0))
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        # the lr and the step count t as device scalars (`_lr_scalar` /
        # `_t_scalar`), read by the scaler-gated step and by TrainStep:
        # each written in place, lr when its value changes, t when
        # `_step_count` moved other than by a step on the device (the host
        # mirror `_t_host` holds what the device t is known to be);
        # `_pending` holds (the step's t, its device found_inf) until the
        # host reads it
        self._lr_arr = self._lr_host = None
        self._t_arr = self._t_host = None
        self._pending = None

    # ---- lr ----
    def get_lr(self) -> float:
        lr = self._learning_rate
        if hasattr(lr, "get_lr"):
            return float(lr.get_lr())
        return float(lr)

    def set_lr(self, value):
        if hasattr(self._learning_rate, "get_lr"):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ---- subclass hooks ----
    def _create_slots(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _apply(self, values, grads, slots, *, lr, t, wd):
        """The update rule over a group of parameters that share lr and wd:
        writes the new values into `values` and the new slot values into
        `slots` (in place). `lr` and `t` are host floats or 0-d f32
        tensors on the values' device (see `functional_update`)."""
        raise NotImplementedError

    def _param_wd(self, p) -> float:
        """Per-parameter weight-decay coefficient (0 for excluded params)."""
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None and not fn(getattr(p, "name", None) or ""):
            return 0.0
        return self._weight_decay

    # ---- per-step device scalars (the reference's :103-121) ----
    def _lr_scalar(self, device):
        """The learning rate as a 0-d f32 tensor on `device`, filled in
        place only when its value changes (a scheduler step), so a step
        captured in a CUDA graph reads the current lr."""
        if self._lr_arr is None or self._lr_arr.device != device:
            self._lr_arr = torch.zeros((), dtype=torch.float32,
                                       device=device)
            self._lr_host = None
        lr = self.get_lr()
        if lr != self._lr_host:
            self._lr_arr.fill_(lr)
            self._lr_host = lr
        return self._lr_arr

    def _t_scalar(self, device):
        """The step count t = `_step_count` + 1 as a 0-d f32 tensor on
        `device`. A step advances it there in place (the gated step only
        where found_inf is clear) and tells `_count_steps`; it is filled
        from the host only when `_step_count` moved by another way."""
        if self._t_arr is None or self._t_arr.device != device:
            self._t_arr = torch.zeros((), dtype=torch.float32, device=device)
            self._t_host = None
        expected = float(self._step_count + 1)
        if self._t_host != expected:
            self._t_arr.fill_(expected)
            self._t_host = expected
        return self._t_arr

    def _count_steps(self, n):
        """Count n steps whose `t += 1` ran on the device."""
        self._step_count += n
        self._t_host += n

    def _resolve_pending(self):
        """Commit a scaler-gated step once its found_inf is read on the
        host (the one host sync of that path). Returns found_inf (True:
        the update was gated away) or None when nothing is pending."""
        if self._pending is None:
            return None
        expected, found_arr = self._pending
        self._pending = None
        found = bool(found_arr)
        if not found:
            self._step_count += 1
            self._t_host = expected + 1.0
        # gated: the device t stayed at `expected`, which `_t_host` holds
        return found

    # ---- eager step ----
    def step(self, inv_scale=None):
        """One update of every parameter that has a gradient (`p.grad`).

        `inv_scale` (set by `amp.GradScaler.step` under
        FLAGS_amp_fused_update): a 0-d f32 tensor, 1 / the loss scale. The
        gradients are unscaled in place, the update is gated on their
        found_inf, and the device found_inf is returned; the step count is
        committed by `_resolve_pending()`.

        Counted as `optimizer.steps` / `optimizer.step_dur` (FLAGS_monitor)
        and booked as the timeline's `optimizer` phase
        (FLAGS_obs_timeline), fenced on the current stream."""
        from .. import monitor as _monitor
        from .. import obs as _obs
        if not (_monitor._ENABLED or _obs._TL_ENABLED):
            return self._step_impl(inv_scale)
        import time as _time
        t0 = _time.time()
        try:
            with _obs.phase("optimizer"):
                found = self._step_impl(inv_scale)
                if _obs._TL_ENABLED:
                    _obs.fence(self._fence_device())
                return found
        finally:
            if _monitor._ENABLED:
                _monitor.count("optimizer.steps")
                _monitor.observe("optimizer.step_dur", _time.time() - t0)

    def _fence_device(self):
        for p in self._parameter_list or ():
            return p.device
        return None

    @torch.no_grad()
    def _step_impl(self, inv_scale=None):
        self._resolve_pending()
        params = [p for p in (self._parameter_list or [])
                  if p.requires_grad and p.grad is not None]
        for p in params:
            if id(p) not in self._accumulators:
                self._accumulators[id(p)] = self._create_slots(p)
        if not params:
            self._step_count += 1
            return None
        values, grads = [p.data for p in params], [p.grad for p in params]
        slots = [self._accumulators[id(p)] for p in params]
        if inv_scale is None:
            self.functional_update(values, grads, slots, self.get_lr(),
                                   float(self._step_count + 1),
                                   params_meta=params)
            self._step_count += 1
            return None
        device = values[0].device
        found = unscale_grads_(grads, inv_scale).to(device)
        t = self._t_scalar(device)
        self.functional_update(values, grads, slots,
                               self._lr_scalar(device), t,
                               params_meta=params, found_inf=found)
        t.add_(1.0 - found)
        self._pending = (self._t_host, found)
        return found

    def clear_grad(self, set_to_zero=True):
        for p in (self._parameter_list or []):
            p.grad = None

    # ---- state dict ----
    def state_dict(self):
        self._resolve_pending()
        sd = {"step_count": self._step_count, "accumulators": {}}
        for i, p in enumerate(self._parameter_list or []):
            acc = self._accumulators.get(id(p))
            if acc:
                sd["accumulators"][getattr(p, "name", None) or str(i)] = {
                    k: v.detach().cpu().numpy() for k, v in acc.items()}
        return sd

    def set_state_dict(self, state_dict):
        self._resolve_pending()
        self._step_count = state_dict.get("step_count", 0)
        accs = state_dict.get("accumulators", {})
        for i, p in enumerate(self._parameter_list or []):
            key = getattr(p, "name", None) or str(i)
            if key in accs:
                self._accumulators[id(p)] = {
                    k: torch.tensor(np.asarray(v), device=p.device)
                    for k, v in accs[key].items()}

    # ---- functional API (jit.TrainStep) ----
    def init_state(self, params):
        return [self._create_slots(p) for p in params]

    @torch.no_grad()
    def functional_update(self, values, grads, slots, lr, t,
                          params_meta=None, grad_clip="default",
                          found_inf=None):
        """The update over value tensors, in place: returns (values, slots)
        holding the new values.

        `params_meta` supplies the parameter objects the values belong to,
        so per-parameter coefficients (weight decay, need_clip, lr scale)
        align with them. `grad_clip=None` disables in-update clipping.

        `lr` and `t` are host numbers, or 0-d f32 tensors on the values'
        device (the counterpart of the reference's `_lr_scalar` /
        `_t_scalar`, :103-121): with tensors the bias corrections and the
        lr scaling run on the device, so a step captured in a CUDA graph
        reads the current values at every replay. Both forms run the same
        operations on the same values; no value is read back from the
        device.

        `found_inf` (a 0-d tensor on the values' device, non-zero when a
        gradient is not finite) gates the update: it runs one parameter at
        a time, and a parameter and its slots keep their old values bit for
        bit where found_inf is set. One parameter's copy is the most it
        holds at once."""
        params = list(params_meta) if params_meta is not None \
            else (self._parameter_list or [])
        if params and len(params) != len(values):
            raise InvalidArgumentError(
                f"functional_update: {len(values)} values but {len(params)} "
                "params\n  [Hint] pass params_meta matching the values")
        n = len(values)
        wds = [self._param_wd(p) for p in params] or [self._weight_decay] * n
        need_clip = [getattr(p, "need_clip", True) for p in params] \
            or [True] * n
        lrs = [getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
               for p in params] or [1.0] * n
        grads = [g.float() if g.dtype != v.dtype and v.is_floating_point()
                 else g for g, v in zip(grads, values)]
        clip = self._grad_clip if grad_clip == "default" else grad_clip
        grads = _clip_fn(clip, grads, need_clip)
        grads = [g.to(v.dtype) for g, v in zip(grads, values)]
        groups: Dict[tuple, List[int]] = {}
        for i, key in enumerate(zip(wds, lrs)):
            groups.setdefault(key, []).append(i)
        for (wd, plr), idx in groups.items():
            group_lr = lr if plr == 1.0 else lr * plr
            if not isinstance(group_lr, torch.Tensor):
                group_lr, t = float(group_lr), float(t)
            if found_inf is None:
                self._apply([values[i] for i in idx],
                            [grads[i] for i in idx], [slots[i] for i in idx],
                            lr=group_lr, t=t, wd=wd)
                continue
            skip = found_inf > 0
            for i in idx:
                state = [values[i], *slots[i].values()]
                old = [x.clone() for x in state]
                self._apply([values[i]], [grads[i]], [slots[i]],
                            lr=group_lr, t=t, wd=wd)
                for was, now in zip(old, state):
                    torch.where(skip, was, now, out=now)
        return values, slots


@torch.no_grad()
def unscale_grads_(grads, inv_scale):
    """Multiply every gradient by `inv_scale` in place and return found_inf,
    a 0-d f32 tensor on `inv_scale`'s device: 1.0 when any of them holds
    an inf or a NaN (the reference's `_fused_unscale`,
    amp/grad_scaler.py:37-44). One multi-tensor pass per device and dtype."""
    found = torch.zeros((), dtype=torch.float32, device=inv_scale.device)
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    for (device, _), gs in groups.items():
        f = found if device == found.device else \
            torch.zeros((), dtype=torch.float32, device=device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            gs, f, inv_scale.to(device))
        if f is not found:
            found = torch.maximum(found, f.to(found.device))
    return found


def _clip_fn(clip, grads, need_clip):
    if clip is None:
        return grads
    if isinstance(clip, ClipGradByValue):
        return [torch.clamp(g, clip.min, clip.max) if nc else g
                for g, nc in zip(grads, need_clip)]
    if isinstance(clip, ClipGradByNorm):
        return [g * _norm_factor(g, clip.clip_norm) if nc else g
                for g, nc in zip(grads, need_clip)]
    if isinstance(clip, ClipGradByGlobalNorm):
        clipped = [g for g, nc in zip(grads, need_clip) if nc]
        if not clipped:
            return grads
        factor = _global_factor(clipped, clip.clip_norm)
        return [g * factor.to(g.dtype) if nc else g
                for g, nc in zip(grads, need_clip)]
    return grads


def bias_correction(beta, t):
    """1 - beta ** t: on the host for a host t; for a 0-d device t on the
    device in f64 (as Python computes it on the host), then rounded to
    f32 (an f32 scalar keeps the `_foreach` ops on their fused path)."""
    if isinstance(t, torch.Tensor):
        return (1 - torch.pow(beta, t.double())).float()
    return 1 - beta ** t


def f32_views(values, grads):
    """(the values in f32 — the values themselves when f32 — and the
    gradients in f32), for the rules that update in f32."""
    return [v.float() for v in values], [g.float() for g in grads]


def write_back(values, p32):
    """Copy f32 results into values of another dtype."""
    for val, new in zip(values, p32):
        if new is not val:
            val.copy_(new)


class SGD(Optimizer):
    def _apply(self, values, grads, slots, *, lr, t, wd):
        if wd:
            grads = torch._foreach_add(grads, values, alpha=wd)
        # `alpha` takes a number only: the step is a product, then a sum
        torch._foreach_add_(values, torch._foreach_mul(grads, -lr))


class Momentum(Optimizer):
    """v = momentum * v + g (g with the L2 decay added); p -= lr * v, or
    with `use_nesterov` p -= lr * (g + momentum * v). The velocity slot
    has the parameter's dtype."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _apply(self, values, grads, slots, *, lr, t, wd):
        if wd:
            grads = torch._foreach_add(grads, values, alpha=wd)
        vel = [s["velocity"] for s in slots]
        torch._foreach_mul_(vel, self._momentum)
        torch._foreach_add_(vel, grads)
        upd = torch._foreach_add(grads, vel, alpha=self._momentum) \
            if self._use_nesterov else vel
        torch._foreach_add_(values, torch._foreach_mul(upd, -lr))


__all__ = ["Optimizer", "SGD", "Momentum", "unscale_grads_"]
