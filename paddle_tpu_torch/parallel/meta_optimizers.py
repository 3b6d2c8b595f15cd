"""Meta-optimizers: recompute, gradient merge, LocalSGD and DGC.

Counterpart of `paddle_tpu/parallel/meta_optimizers.py` (the reference
Paddle's `fleet/meta_optimizers/recompute_optimizer.py` with the
`fleet.utils.recompute` dygraph API, `gradient_merge_optimizer.py`,
`localsgd_optimizer.py` and `operators/dgc_op.cc`). Each optimizer wraps
an inner one (any optimizer of the port, or the `HybridParallelOptimizer`
that `fleet.distributed_optimizer` makes) and acts on the parameters'
`.grad` as the backward left it.

Which gradients they see, as in the JAX package: its eager
`DataParallel` reduces nothing (`paddle_tpu/parallel/data_parallel.py`,
`apply_collective_grads` is empty), so its LocalSGD averages parameters
that trained apart, and its DGC sparsifies the local gradient and sends
it through an injectable `allreduce` (none by default: no exchange). The
port's `DataParallel` all-reduces every backward (PR 15's Reducer), so
these wrappers are meant for a model that is not wrapped in it: under
the Reducer LocalSGD's averaging changes nothing and DGC would sparsify a
gradient that was already reduced densely. No mode beyond the JAX
package's is added.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.utils.checkpoint as _ckpt

from ..core.random import get_rng_state, set_rng_state


def recompute(function: Callable, *args, **kwargs):
    """fleet.utils.recompute: run `function` (a Layer or a callable)
    without keeping its intermediate activations, and run it again in the
    backward to rebuild them. Gradients reach the tensor arguments and,
    for a Layer, its parameters (torch's non-reentrant checkpoint, which
    also serves `torch.autograd.grad` over parameter aliases, as
    `jit.TrainStep` takes them).

    Dropout in the port draws from the package's generators
    (`core/random.py`), which torch's `preserve_rng_state` does not cover.
    So, as the reference does (:77-91), the state of every one of them is
    taken before the forward, set again around the recomputation (the
    same masks), and the surrounding state is restored after it."""
    needs_grad = torch.is_grad_enabled() and (
        any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        or any(p.requires_grad for p in getattr(function, "parameters",
                                                lambda: ())()))
    if not needs_grad:
        return function(*args, **kwargs)
    before = get_rng_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kwargs)
        cur = get_rng_state()
        set_rng_state(before)
        try:
            return function(*a, **kwargs)
        finally:
            set_rng_state(cur)

    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=False)


def _trainable(opt):
    return [p for p in (opt._parameter_list or [])
            if p.requires_grad and p.grad is not None]


def _dense(g):
    """A sparse (SelectedRows) gradient densified, as the reference's
    merge and DGC steps do (:118-123, :239-263); a dense one as it is."""
    return g.to_dense() if g.is_sparse else g


class _Wrapper:
    """The optimizer API delegated to the inner optimizer."""

    def __getattr__(self, name):
        if name == "inner_optimizer":
            raise AttributeError(name)  # before __init__ set it
        return getattr(self.inner_optimizer, name)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, *a, **kw):
        self.inner_optimizer.clear_grad(*a, **kw)


class GradientMergeOptimizer(_Wrapper):
    """Accumulate the gradients of `k_steps` micro-steps, then take one
    inner step with the merged (averaged, with `avg`) gradients
    (gradient_merge_optimizer.py)."""

    def __init__(self, inner_optimizer, k_steps: int = 1, avg: bool = True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg
        self._acc = {}  # id(param) -> (param, accumulated grad)
        self._micro = 0

    @torch.no_grad()
    def step(self):
        params = _trainable(self.inner_optimizer)
        for p in params:
            g = _dense(p.grad)
            cur = self._acc.get(id(p))
            self._acc[id(p)] = (p, g if cur is None else cur[1] + g)
        self._micro += 1
        if self._micro < self.k_steps:
            for p in params:    # a merge-only step: no inner step
                p.grad = None
            return
        scale = 1.0 / self.k_steps if self.avg else 1.0
        # every accumulated parameter gets its merged gradient, also one
        # that got none on this last micro-step
        for p, acc in self._acc.values():
            p.grad = acc * scale
        self.inner_optimizer.step()
        self._acc.clear()
        self._micro = 0


class LocalSGDOptimizer(_Wrapper):
    """Local steps, and every `k_steps` the parameters replaced by their
    mean over the replicas (localsgd_optimizer.py). `allreduce_mean(t)`
    returns the mean of a tensor; by default it is the all_reduce over the
    process world divided by its size, and the identity in a world of
    one."""

    def __init__(self, inner_optimizer, k_steps: int = 4,
                 allreduce_mean: Optional[Callable] = None):
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self._steps = 0
        self._allreduce_mean = allreduce_mean

    @staticmethod
    def _default_mean(t):
        from . import collective
        from .env import get_world_size
        n = get_world_size()
        if n <= 1:
            return t
        t = t.clone()
        collective.all_reduce(t)
        return t / n

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k_steps == 0:
            mean = self._allreduce_mean or self._default_mean
            for p in (self.inner_optimizer._parameter_list or []):
                p.copy_(mean(p.detach()))


class DGCMomentumOptimizer(_Wrapper):
    """Deep Gradient Compression (`operators/dgc_op.cc`,
    `details/sparse_all_reduce_op_handle.cc`, fleet's dgc toggle): each
    step sends only the largest `1 - sparsity` share of each parameter's
    momentum-corrected accumulation; the rest stays behind as a residual
    until it grows large enough.

    Per parameter and step: u = momentum * u + g; v = v + u; k =
    max(1, int(numel * (1 - sparsity))); the threshold is the k-th
    largest |v| (a top-k), and every entry with |v| >= it is sent (a tie
    at the threshold sends more than k); the sent entries are cleared
    from u and v. The sent tensor goes through `allreduce` (when given)
    and becomes the gradient of the inner optimizer, which must be
    momentum-free (DGC is the momentum). `sparsity` is a value or a ramp
    (a list, one entry per step after `rampup_begin_step`, the last one
    kept); through step `rampup_begin_step` the raw gradient is
    all-reduced densely with full momentum (the warm-up)."""

    def __init__(self, inner_optimizer, momentum: float = 0.9,
                 sparsity=0.999, rampup_begin_step: int = 0,
                 allreduce: Optional[Callable] = None):
        if float(getattr(inner_optimizer, "_momentum", 0.0)) > 0.0:
            raise ValueError(
                "DGCMomentumOptimizer provides momentum itself; wrap a "
                "momentum-free optimizer (e.g. SGD) and pass momentum= here")
        self.inner_optimizer = inner_optimizer
        self.momentum = float(momentum)
        if isinstance(sparsity, (list, tuple)):
            self._sparsity_ramp = [float(s) for s in sparsity] or [0.999]
        else:
            self._sparsity_ramp = [float(sparsity)]
        self.rampup_begin_step = int(rampup_begin_step)
        self._allreduce = allreduce
        self._u = {}  # momentum-corrected velocity per parameter
        self._v = {}  # local accumulation (the residual) per parameter
        self._steps = 0

    def _k(self, numel: int) -> int:
        i = min(self._steps - self.rampup_begin_step - 1,
                len(self._sparsity_ramp) - 1)
        return max(1, int(numel * (1.0 - self._sparsity_ramp[i])))

    @torch.no_grad()
    def step(self):
        self._steps += 1
        params = _trainable(self.inner_optimizer)
        if self._steps <= self.rampup_begin_step:
            for p in params:
                g = _dense(p.grad)
                if self._allreduce is not None:
                    g = self._allreduce(g)
                u = self._u.get(id(p))
                u = g if u is None else self.momentum * u + g
                self._u[id(p)] = u
                p.grad = u
            self.inner_optimizer.step()
            return
        for p in params:
            g = _dense(p.grad)
            u, v = self._u.get(id(p)), self._v.get(id(p))
            u = g if u is None else self.momentum * u + g
            v = u if v is None else v + u
            mag = v.abs()
            thresh = torch.topk(mag.reshape(-1), self._k(v.numel())).values[-1]
            mask = mag >= thresh
            zero = torch.zeros((), dtype=v.dtype, device=v.device)
            send = torch.where(mask, v, zero)
            if self._allreduce is not None:
                send = self._allreduce(send)
            p.grad = send.to(g.dtype)
            self._v[id(p)] = torch.where(mask, zero, v)
            self._u[id(p)] = torch.where(mask, zero, u)
        self.inner_optimizer.step()

    def state_dict(self):
        """The inner state and the residual and velocity buffers (with a
        high sparsity they hold most of the recent gradient), keyed by the
        parameter's index."""
        plist = self.inner_optimizer._parameter_list or []
        idx = {id(p): i for i, p in enumerate(plist)}

        def host(bufs):
            return {idx[k]: v.detach().cpu().numpy()
                    for k, v in bufs.items() if k in idx}

        return {"inner": self.inner_optimizer.state_dict(),
                "dgc_steps": self._steps,
                "dgc_u": host(self._u), "dgc_v": host(self._v)}

    def set_state_dict(self, sd):
        self.inner_optimizer.set_state_dict(sd["inner"])
        self._steps = int(sd.get("dgc_steps", 0))
        plist = self.inner_optimizer._parameter_list or []

        def dev(bufs):
            out = {}
            for i, v in bufs.items():
                p = plist[int(i)]
                out[id(p)] = torch.as_tensor(np.asarray(v), device=p.device)
            return out

        self._u = dev(sd.get("dgc_u", {}))
        self._v = dev(sd.get("dgc_v", {}))


__all__ = ["recompute", "GradientMergeOptimizer", "LocalSGDOptimizer",
           "DGCMomentumOptimizer"]
