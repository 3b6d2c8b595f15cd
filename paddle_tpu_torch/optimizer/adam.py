"""Adam and AdamW.

Counterpart of `paddle_tpu/optimizer/adam.py` (:14-77): f32 moments
`moment1`/`moment2`, bias correction at step `t`, epsilon outside the
square root, and for AdamW the decay decoupled from the gradient
(`upd + wd * p`). The fp32 master parameters and the moments are updated
in place, where the reference donates their buffers.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, lazy_mode=False,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _create_slots(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _decoupled(self):
        return False

    def _apply(self, values, grads, slots, *, lr, t, wd):
        b1, b2 = self._beta1, self._beta2
        if isinstance(t, torch.Tensor):
            # on the device in f64, as Python computes `1 - b ** t` on the
            # host, then rounded to f32 as the division rounds a host
            # float (an f32 scalar keeps `_foreach_div` on its fused path)
            t64 = t.double()
            bc1 = (1 - torch.pow(b1, t64)).float()
            bc2 = (1 - torch.pow(b2, t64)).float()
        else:
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        g32 = [g.float() for g in grads]
        p32 = [v.float() for v in values]  # the values themselves when f32
        if wd and not self._decoupled():
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        m = [s["moment1"] for s in slots]
        v = [s["moment2"] for s in slots]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        if wd and self._decoupled():
            torch._foreach_add_(upd, p32, alpha=wd)
        # `alpha` takes a number only: the step is a product, then a sum
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p32, upd)
        for val, new in zip(values, p32):
            if new is not val:
                val.copy_(new)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name, lazy_mode=lazy_mode)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self):
        return True


__all__ = ["Adam", "AdamW"]
