"""Optimizer base + SGD.

Counterpart of `paddle_tpu/optimizer/optimizer.py` (:32-419, `_clip_fn`
:421). The update rules are elementwise, so they stay PyTorch ops, as the
reference leaves them to XLA: each rule is written here over a list of
parameters with `torch._foreach_*` ops, so one step launches a few kernels
for every group of parameters that share a learning rate and a weight
decay, not ~10 for each parameter. The rule, the slot names and the
`state_dict` keys are the reference's.

Where the reference donates the parameter and slot buffers to its jitted
update, the port updates them in place: `functional_update` writes the
new values into the `values` and `slots` tensors it is given and returns
them.
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

    # ---- eager step ----
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient (`p.grad`)."""
        params = [p for p in (self._parameter_list or [])
                  if p.requires_grad and p.grad is not None]
        for p in params:
            if id(p) not in self._accumulators:
                self._accumulators[id(p)] = self._create_slots(p)
        if params:
            self.functional_update(
                [p.data for p in params], [p.grad for p in params],
                [self._accumulators[id(p)] for p in params], self.get_lr(),
                float(self._step_count + 1), params_meta=params)
        self._step_count += 1

    def clear_grad(self, set_to_zero=True):
        for p in (self._parameter_list or []):
            p.grad = None

    # ---- state dict ----
    def state_dict(self):
        sd = {"step_count": self._step_count, "accumulators": {}}
        for i, p in enumerate(self._parameter_list or []):
            acc = self._accumulators.get(id(p))
            if acc:
                sd["accumulators"][getattr(p, "name", None) or str(i)] = {
                    k: v.detach().cpu().numpy() for k, v in acc.items()}
        return sd

    def set_state_dict(self, state_dict):
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
                          params_meta=None, grad_clip="default"):
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
        device."""
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
            self._apply([values[i] for i in idx], [grads[i] for i in idx],
                        [slots[i] for i in idx], lr=group_lr, t=t, wd=wd)
        return values, slots


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


class SGD(Optimizer):
    def _apply(self, values, grads, slots, *, lr, t, wd):
        if wd:
            grads = torch._foreach_add(grads, values, alpha=wd)
        # `alpha` takes a number only: the step is a product, then a sum
        torch._foreach_add_(values, torch._foreach_mul(grads, -lr))


__all__ = ["Optimizer", "SGD"]
