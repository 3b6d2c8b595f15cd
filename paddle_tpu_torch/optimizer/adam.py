"""Adam, AdamW, Adamax, Lamb, Adagrad, RMSProp, Adadelta and
LarsMomentum.

Counterpart of `paddle_tpu/optimizer/adam.py`: for Adam and AdamW
(:14-77) f32 moments `moment1`/`moment2`, bias correction at step `t`,
epsilon outside the square root, and for AdamW the decay decoupled from
the gradient (`upd + wd * p`); then the classic rules (:80-245) with the
reference's slot names and update order, each over a group of parameters
with `torch._foreach_*` ops, in f32. Lamb's trust ratio and LARS's local
learning rate need each parameter's norm: `torch._foreach_norm` gives
them in one launch per group, and the per-parameter scale is applied as
a list of 0-d tensors (no value read back to the host). Lamb leaves out
of the decay the parameters its `exclude_from_weight_decay_fn(param)`
names, LARS those whose `name` contains one of
`exclude_from_weight_decay`'s strings. The parameters and the slots are
updated in place, where the reference donates their buffers.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, bias_correction, f32_views, write_back


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

    def _apply_sparse(self, p, sr, slots, *, lr, t, wd):
        """Sparse adam (adam_op.h SelectedRows path). lazy_mode=True:
        moments and weights update ONLY at the gradient's rows (untouched
        rows keep stale moments). The default lazy_mode=False densifies, so
        every row's moments decay each step."""
        if self._lazy_mode:
            self._apply_rows(p, sr, slots, lr=lr, t=t, wd=wd)
        else:
            super()._apply_sparse(p, sr, slots, lr=lr, t=t, wd=wd)

    def _apply(self, values, grads, slots, *, lr, t, wd):
        b1, b2 = self._beta1, self._beta2
        bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
        p32, g32 = f32_views(values, grads)
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
        write_back(values, p32)


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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_slots(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32)}

    def _apply(self, values, grads, slots, *, lr, t, wd):
        p32, g32 = f32_views(values, grads)
        if wd:
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        m = [s["moment"] for s in slots]
        u = [s["inf_norm"] for s in slots]
        torch._foreach_mul_(m, self._beta1)
        torch._foreach_add_(m, g32, alpha=1 - self._beta1)
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(g32))
        # p -= (lr / (1 - b1 ** t)) * m / (u + eps)
        upd = torch._foreach_mul(m, lr / bias_correction(self._beta1, t))
        torch._foreach_div_(upd, torch._foreach_add(u, self._epsilon))
        torch._foreach_sub_(p32, upd)
        write_back(values, p32)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _param_wd(self, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return self._weight_decay

    def _create_slots(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _apply(self, values, grads, slots, *, lr, t, wd):
        b1, b2 = self._beta1, self._beta2
        p32, g32 = f32_views(values, grads)
        m = [s["moment1"] for s in slots]
        v = [s["moment2"] for s in slots]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1 - b2)
        # r = mhat / (sqrt(vhat) + eps) + wd * p
        denom = torch._foreach_div(v, bias_correction(b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        r = torch._foreach_div(m, bias_correction(b1, t))
        torch._foreach_div_(r, denom)
        if wd:
            torch._foreach_add_(r, p32, alpha=wd)
        w_norm = torch.stack(torch._foreach_norm(p32))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        torch._foreach_mul_(r, list((trust * -lr).unbind()))
        torch._foreach_add_(p32, r)
        write_back(values, p32)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_slots(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _apply(self, values, grads, slots, *, lr, t, wd):
        p32, g32 = f32_views(values, grads)
        if wd:
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        acc = [s["moment"] for s in slots]
        torch._foreach_addcmul_(acc, g32, g32)
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul(g32, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p32, upd)
        write_back(values, p32)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_slots(self, p):
        s = {"mean_square": torch.zeros_like(p, dtype=torch.float32),
             "momentum": torch.zeros_like(p, dtype=torch.float32)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def _apply(self, values, grads, slots, *, lr, t, wd):
        rho = self._rho
        p32, g32 = f32_views(values, grads)
        if wd:
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        ms = [s["mean_square"] for s in slots]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, g32, g32, value=1 - rho)
        if self._centered:
            mg = [s["mean_grad"] for s in slots]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, g32, alpha=1 - rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1)
        else:
            denom = torch._foreach_add(ms, 0.0)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_sqrt_(denom)
        # momentum = momentum * mom + lr * g / denom; p -= momentum
        mom = [s["momentum"] for s in slots]
        upd = torch._foreach_mul(g32, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, upd)
        torch._foreach_sub_(p32, mom)
        write_back(values, p32)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon

    def _create_slots(self, p):
        return {"avg_squared_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(p,
                                                       dtype=torch.float32)}

    def _apply(self, values, grads, slots, *, lr, t, wd):
        rho, eps = self._rho, self._epsilon
        p32, g32 = f32_views(values, grads)
        if wd:
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        asg = [s["avg_squared_grad"] for s in slots]
        asu = [s["avg_squared_update"] for s in slots]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, g32, g32, value=1 - rho)
        # upd = g * sqrt(asu + eps) / sqrt(asg + eps), with the old asu
        num = torch._foreach_add(asu, eps)
        torch._foreach_sqrt_(num)
        upd = torch._foreach_mul(g32, num)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p32, upd)
        write_back(values, p32)


class LarsMomentum(Optimizer):
    """local_lr = lr * lars_coeff * ||w|| / (||g|| + wd * ||w|| + eps)
    (lr itself where ||w|| = 0); v = momentum * v + local_lr * (g + wd *
    w); w -= v."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=1e-3,
                 lars_weight_decay=5e-4, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=1e-9, name=None):
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._epsilon = epsilon
        self._exclude_wd = list(exclude_from_weight_decay or [])

    def _param_wd(self, p):
        pname = getattr(p, "name", None) or ""
        if any(s in pname for s in self._exclude_wd):
            return 0.0
        return self._weight_decay

    def _create_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _apply(self, values, grads, slots, *, lr, t, wd):
        p32, g32 = f32_views(values, grads)
        wn = torch.stack(torch._foreach_norm(p32))
        gn = torch.stack(torch._foreach_norm(g32))
        local = lr * self._lars_coeff * wn / (gn + wd * wn + self._epsilon)
        local = torch.where(wn > 0, local, torch.full_like(local, 1.0) * lr)
        d = torch._foreach_add(g32, p32, alpha=wd) if wd else \
            torch._foreach_mul(g32, 1.0)
        torch._foreach_mul_(d, list(local.unbind()))
        vel = [s["velocity"] for s in slots]
        torch._foreach_mul_(vel, self._momentum)
        torch._foreach_add_(vel, d)
        torch._foreach_sub_(p32, vel)
        write_back(values, p32)


__all__ = ["Adam", "AdamW", "Adamax", "Lamb", "Adagrad", "RMSProp",
           "Adadelta", "LarsMomentum"]
