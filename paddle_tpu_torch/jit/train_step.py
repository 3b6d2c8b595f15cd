"""Whole-train-step driver: forward, backward and optimizer update.

Counterpart of `paddle_tpu/jit/train_step.py` (TrainStep :54-396,
raise_nonfinite :33-51), with the same constructor. Where the reference
compiles forward + backward + update into one XLA executable with donated
parameter and slot buffers, the port runs them eagerly on the parameters'
device and updates the parameters and slots in place. `run()` is the
counterpart of the `lax.scan` span (:134-151): a Python loop over the
leading axis that never reads a value back between steps; the losses stay
on the device and are stacked once at the end.

Usage:
    step = TrainStep(model, loss_fn, optimizer, amp_dtype="bfloat16")
    loss = step(x, y)          # x to model.forward, y to loss_fn
    losses = step.run(xs, ys)  # xs/ys stacked along a leading n_steps axis

The monitor, timeline, compile-cache and executable hooks of the
reference are not ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import flags as _flags
from ..core.enforce import UnimplementedError
from ..core.place import resolve_device
from ..core.random import get_rng_state, set_rng_state
from .functional import amp_functional_call, split_state


def raise_nonfinite(bad, pnames, context):
    """Decode the finite flags ([P+1] or [n_steps, P+1]) and raise naming
    the offending grads. No-op when the check was off (bad is None).
    Callers must have committed params/slots/step state first."""
    if bad is None:
        return
    flags_arr = bad.cpu().numpy()
    if flags_arr.ndim == 2:              # run(): [n_steps, P+1] -> any step
        flags_arr = flags_arr.any(axis=0)
    if not flags_arr.any():
        return
    names = ["loss" if i == 0 else f"grad of {pnames[i - 1]}"
             for i in np.nonzero(flags_arr)[0]]
    raise FloatingPointError(
        f"NaN/Inf detected in {context} "
        f"(FLAGS_check_nan_inf=True): {', '.join(names)}")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 (which numpy lacks) widens exactly to f32."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class TrainStep:
    def __init__(self, model, loss_fn: Callable, optimizer, amp_dtype=None,
                 donate: bool = True, mesh=None, in_shardings=None,
                 n_model_inputs: Optional[int] = None):
        if mesh is not None or in_shardings is not None:
            raise UnimplementedError(
                "TrainStep(mesh=..., in_shardings=...): sharded steps come "
                "with the distributed slice")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_dtype = amp_dtype
        # parameters and slots are always updated in place (`donate` is
        # accepted for signature parity)
        self._donate = donate
        # step(x..., y...): first n go to model.forward, the rest to loss_fn
        self._n_model_inputs = n_model_inputs
        self._built = False

    def _build(self):
        # FLAGS_check_nan_inf is read once, at the first step
        self._nan_check = bool(_flags.flag("check_nan_inf"))
        trainable, frozen = split_state(self.model)
        self._pnames, self._bnames = list(trainable), list(frozen)
        self._ptensors = [trainable[n] for n in self._pnames]
        self._btensors = [frozen[n] for n in self._bnames]
        opt = self.optimizer
        opt._parameter_list = opt._parameter_list or self._ptensors
        self._slots = opt.init_state(self._ptensors)
        self._t = float(opt._step_count + 1)
        self._device = self._ptensors[0].device if self._ptensors \
            else resolve_device()
        self._built = True

    def _prepare(self, batch):
        """The batch on the parameters' device, split into model inputs and
        labels."""
        if not self._built:
            self._build()
        arrs = [torch.as_tensor(b, device=self._device) for b in batch]
        n_mi = self._n_model_inputs
        if n_mi is None:
            n_mi = len(arrs) if len(arrs) <= 1 else len(arrs) - 1
        return arrs[:n_mi], arrs[n_mi:]

    def _loss_and_grads(self, inputs, labels):
        """Forward and backward at the current parameters: (loss, grads),
        grads aligned with the trainable parameters. Updates nothing."""
        ps = self._ptensors
        with torch.enable_grad():
            out = amp_functional_call(self.model, self._pnames, ps,
                                      self._bnames, self._btensors, inputs,
                                      self.amp_dtype)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            loss = self.loss_fn(*outs, *labels)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        return loss.detach(), grads

    def _one_step(self, inputs, labels):
        loss, grads = self._loss_and_grads(inputs, labels)
        bad = None
        if self._nan_check:
            bad = torch.stack([~torch.isfinite(loss)]
                              + [~torch.isfinite(g).all() for g in grads])
        # in place: the reference donates these buffers to its update
        self.optimizer.functional_update(
            [p.detach() for p in self._ptensors], grads, self._slots,
            self.optimizer.get_lr(), self._t, params_meta=self._ptensors)
        self._t += 1.0
        self.optimizer._step_count += 1
        return loss, bad

    def __call__(self, *batch):
        """batch: input tensors consumed by model.forward; loss_fn receives
        the model output(s) and the remaining tensors. Returns the loss as
        a 0-d tensor on the device (no host sync)."""
        inputs, labels = self._prepare(batch)
        loss, bad = self._one_step(inputs, labels)
        raise_nonfinite(bad, self._pnames, "train step")
        return loss

    def run(self, *batch):
        """Every tensor in `batch` is stacked along a leading n_steps axis;
        runs the n optimizer steps and returns the [n] losses."""
        inputs, labels = self._prepare(batch)
        n_steps = int(inputs[0].shape[0]) if inputs \
            else int(labels[0].shape[0])
        losses, bads = [], []
        for i in range(n_steps):
            loss, bad = self._one_step([x[i] for x in inputs],
                                       [y[i] for y in labels])
            losses.append(loss)
            bads.append(bad)
        raise_nonfinite(torch.stack(bads) if self._nan_check else None,
                        self._pnames, "train step")
        return torch.stack(losses)

    # ---- full loop-state capture ----
    def state_dict(self):
        """Host copy of the loop state: params, optimizer slots, the rng
        state and the step counter. `set_state_dict` of it resumes the
        same training stream. The rng entry is torch's generator state: it
        round-trips inside the port only."""
        if not self._built:
            self._build()
        rng = get_rng_state()
        return {
            "kind": "train_step",
            "params": {n: _host(t)
                       for n, t in zip(self._pnames, self._ptensors)},
            "slots": [{k: _host(v) for k, v in s.items()}
                      for s in self._slots],
            "rng_key": {k: [x.numpy() for x in v] if isinstance(v, list)
                        else v.numpy() for k, v in rng.items()},
            "t": np.asarray(self._t, np.float32),
            "step_count": int(self.optimizer._step_count),
        }

    def set_state_dict(self, sd):
        if not self._built:
            self._build()
        params = sd["params"]
        with torch.no_grad():
            for n, t in zip(self._pnames, self._ptensors):
                if n in params:
                    t.copy_(torch.as_tensor(np.asarray(params[n])))
        self._slots = [{k: torch.tensor(np.asarray(v), device=self._device)
                        for k, v in s.items()} for s in sd["slots"]]
        set_rng_state(sd["rng_key"])
        self._t = float(sd["t"])
        self.optimizer._step_count = int(sd["step_count"])


__all__ = ["TrainStep", "raise_nonfinite"]
