"""ZeRO stage 3 by units: whole parameters gathered one unit at a time.

A unit is a sublayer at the granularity of the model's repeated blocks:
each entry of a `LayerList` (an `ErnieLayer`), and every other child of
the modules on the way to them (the embeddings, the head); the sharded
parameters found in none of them (the root's own) form the root group.
Within `SPMDTrainStep`'s stage-3 step:

  - a unit's whole parameters are all-gathered (one flat collective per
    dtype over the sharding group) by a forward pre-hook, right before its
    forward, and freed after it;
  - a hook on the unit's outputs gathers them again when the backward
    reaches the unit, before any of its backward nodes run;
  - once every parameter of the unit has its gradient (a post-accumulate
    hook), the gradients are reduce-scattered over the sharding group
    (one flat collective per dtype), all-reduced over the dp group and
    scaled by 1 / (sharding x dp), and the whole parameters and gradients
    are freed. What a backward leaves (unused parameters, as zeros) is
    flushed at its end, in group order.

Under AMP each whole parameter of a unit is cast to the AMP dtype inside
the unit (the pre-hook puts the cast in the module's place for the
unit's forward), where `amp_functional_call` casts every parameter before
the forward: the same values, but a cast before the forward would read
every whole parameter at once. The casts are what autograd saves for the
unit's backward, so they are freed and filled again as the whole
parameters are: freed after the unit's forward, cast again from the
regathered whole parameters before its backward, freed at its flush.

The whole parameters are bound into the forward as leaf tensors whose
storage is freed by `untyped_storage().resize_(0)` and filled again in
place: autograd keeps the views it saved for the backward (a weight's
transpose), and the refill goes through `.data`, so their version counters
do not move. This was taken over recomputing each unit under
`torch.utils.checkpoint` with the gather inside: the forward runs once, as
in the whole-gather step, and the numbers stay that step's (bit-equal on
the CPU with two-way sums, where gloo's reductions are exact).

A parameter read outside its own unit (a weight tied across units, as an
MLM head reads the word embeddings) would find its storage freed. Such
parameters are found once, by a forward under FakeTensorMode that records
which unit is running when each whole parameter is used; they join the
root group, gathered at the start of the step and freed when their
gradients are complete; under AMP their casts are made before the forward
and live for the step. `peak_bytes` is the most bytes of whole parameters
and their AMP casts alive at once in the last step; `unit_bytes` gives
each group's (both, under the last step's AMP dtype), and the peak is at
most the root group's plus the largest unit's.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.overrides import TorchFunctionMode

from ..nn.layer.container import LayerList

ROOT = -1


def find_units(model):
    """[(name prefix, module)]: every LayerList entry, and every other
    child of the modules that lead to a LayerList."""
    units = []

    def holds_list(mod):
        return any(isinstance(m, LayerList) for m in mod.modules())

    def visit(mod, prefix):
        for name, child in mod.named_children():
            full = prefix + name
            if isinstance(child, LayerList):
                for j, blk in child.named_children():
                    units.append((f"{full}.{j}", blk))
            elif holds_list(child):
                visit(child, full + ".")
            elif any(True for _ in child.parameters()):
                units.append((full, child))

    visit(model, "")
    return units


class _Track(TorchFunctionMode):
    """Records, for each op, which whole parameters it reads and which
    unit is running."""

    def __init__(self, ids, active, used):
        super().__init__()
        self.ids, self.active, self.used = ids, active, used

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        unit = self.active[-1] if self.active else ROOT
        for a in list(args) + list(kwargs.values()):
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                i = self.ids.get(id(t))
                if i is not None:
                    self.used.setdefault(i, set()).add(unit)
        return func(*args, **kwargs)


class Zero3Units:
    def __init__(self, step):
        self.step = step
        names, sharded = step._pnames, step._sharded
        self.units = find_units(step.model)
        owner = {}
        for i in sharded:
            owner[i] = ROOT
            for u, (prefix, _) in enumerate(self.units):
                if names[i].startswith(prefix + "."):
                    owner[i] = u
                    break
        self.owner = owner
        self.pinned = set()
        self.amp = None
        self._swapped = {}
        self.casts: Dict[int, torch.Tensor] = {}
        self.cast_live = set()
        self._regroup()
        self.whole = {i: self._empty_whole(i) for i in sharded}
        self.mode = "off"              # "off" | "track" | "run"
        self.fake = False
        self.active: List[int] = []
        self.handles = [m.register_forward_pre_hook(
            lambda mod, a, u=u: self._pre(u))
            for u, (_, m) in enumerate(self.units)]
        self.handles += [m.register_forward_hook(
            lambda mod, a, out, u=u: self._post(u, out))
            for u, (_, m) in enumerate(self.units)]
        self.peak_bytes = 0
        self.alive = 0

    # ---- groups ----
    def _regroup(self):
        self.groups: Dict[int, List[int]] = {ROOT: []}
        for u in range(len(self.units)):
            self.groups[u] = []
        for i, u in self.owner.items():
            self.groups[ROOT if i in self.pinned else u].append(i)
        self.group_of = {i: g for g, members in self.groups.items()
                         for i in members}
        # (submodule, attribute, i) of each unit's members, for the casts
        names = self.step._pnames
        self.slots = {}
        for u, (prefix, module) in enumerate(self.units):
            self.slots[u] = []
            for i in self.groups[u]:
                path, _, attr = names[i][len(prefix) + 1:].rpartition(".")
                sub = module.get_submodule(path) if path else module
                self.slots[u].append((sub, attr, i))

    def _held_bytes(self, i):
        """Parameter i's whole bytes and, under AMP, its cast's."""
        p = self.step._ptensors[i]
        n = int(torch.Size(self.step._shapes[i]).numel())
        cast = self.amp is not None and p.is_floating_point() and \
            p.dtype != self.amp
        return n * (p.element_size()
                    + (torch.finfo(self.amp).bits // 8 if cast else 0))

    @property
    def unit_bytes(self):
        return {g: sum(self._held_bytes(i) for i in m)
                for g, m in self.groups.items()}

    def _empty_whole(self, i):
        p = self.step._ptensors[i]
        t = torch.empty(self.step._shapes[i], dtype=p.dtype, device=p.device)
        t.untyped_storage().resize_(0)
        return t.requires_grad_(True)

    # ---- gather and free ----
    def _gather(self, g):
        members = [i for i in self.groups[g] if not self.ready[i]]
        if not members:
            return
        full = self.step._gather_slices(
            {i: self.step._shards[i] for i in members})
        with torch.no_grad():
            for i in members:
                w = self.whole[i]
                if not self.fake:
                    w.untyped_storage().resize_(
                        w.numel() * w.element_size())
                    w.data.copy_(full[i])
                self.ready[i] = True
                self.alive += self._nbytes(w)
        self.peak_bytes = max(self.peak_bytes, self.alive)

    def _free(self, members):
        for i in members:
            if self.ready[i]:
                if not self.fake:
                    self.whole[i].untyped_storage().resize_(0)
                self.ready[i] = False
                self.alive -= self._nbytes(self.whole[i])
            self._free_cast(i)

    @staticmethod
    def _nbytes(t):
        return t.numel() * t.element_size()

    def hold_cast(self, whole, cast):
        """Count an AMP cast of a whole parameter made outside the units
        (the root group's) until the step ends."""
        if cast is not whole:
            self.alive += self._nbytes(cast)
            self.peak_bytes = max(self.peak_bytes, self.alive)

    def _free_cast(self, i):
        if i in self.cast_live:
            c = self.casts[i]
            if not self.fake:
                c.untyped_storage().resize_(0)
            self.cast_live.discard(i)
            self.alive -= self._nbytes(c)

    def _recast(self, u):
        """Fill the unit's freed casts again from its whole parameters."""
        for _, _, i in self.slots[u]:
            c = self.casts.get(i)
            if c is None or i in self.cast_live:
                continue
            if not self.fake:
                c.untyped_storage().resize_(self._nbytes(c))
                with torch.no_grad():
                    c.data.copy_(self.whole[i].data.to(self.amp))
            self.cast_live.add(i)
            self.alive += self._nbytes(c)
        self.peak_bytes = max(self.peak_bytes, self.alive)

    @property
    def cast_in_unit(self):
        """The parameters whose AMP cast runs inside their unit."""
        return {i for u in self.slots for _, _, i in self.slots[u]}

    def _cast(self, u):
        """Put each member's AMP cast in its module's place (in a step,
        counted and kept in `casts` to be freed and filled again)."""
        if self.amp is None:
            return
        for sub, attr, i in self.slots[u]:
            self._swapped[(u, id(sub), attr)] = (sub, attr,
                                                sub._parameters[attr])
            w = self.whole[i]
            c = w.to(self.amp)
            sub._parameters[attr] = c
            if self.mode == "run" and c is not w:
                self.casts[i] = c
                self.cast_live.add(i)
                self.alive += self._nbytes(c)
        self.peak_bytes = max(self.peak_bytes, self.alive)

    def _uncast(self, u):
        for key in [k for k in self._swapped if k[0] == u]:
            sub, attr, orig = self._swapped.pop(key)
            sub._parameters[attr] = orig

    # ---- hooks ----
    def _pre(self, u):
        if self.mode == "track":
            self.active.append(u)
            self._cast(u)
        elif self.mode == "run":
            self._gather(u)
            self._cast(u)

    def _post(self, u, out):
        if self.mode == "track":
            self._uncast(u)
            self.active.pop()
            return
        if self.mode != "run":
            return
        self._uncast(u)
        self._free(self.groups[u])
        outs = out if isinstance(out, (list, tuple)) else [out]
        for t in outs:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(lambda grad, u=u: self._regather(u, grad))

    def _regather(self, u, grad):
        if not self.flushed[u]:
            self._gather(u)
            self._recast(u)
        return grad

    def _on_grad(self, i):
        if not self.queued:
            self.queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        g = self.group_of[i]
        self.pending[g].discard(i)
        if not self.pending[g] and not self.flushed[g]:
            self._flush(g)

    def _flush(self, g):
        members = self.groups[g]
        self.flushed[g] = True
        if not members:
            return
        grads = {}
        for i in members:
            w = self.whole[i]
            grads[i] = torch.zeros_like(w) if w.grad is None else w.grad
        self.slices.update(self.step._scatter_grads(grads, members))
        for i in members:
            self.whole[i].grad = None
        self._free(members)

    def _finish(self):
        for g in self.groups:
            if not self.flushed[g]:
                self._flush(g)

    # ---- one step ----
    def begin(self, fake=False, amp_dtype=None):
        """Bind the whole parameters for a step (fake: under
        FakeTensorMode, no storage is touched; amp_dtype: cast each unit's
        in the unit); gathers the root group."""
        self.fake = fake
        self.amp = amp_dtype
        self.ready = {i: False for i in self.whole}
        self.flushed = {g: False for g in self.groups}
        self.pending = {g: set(m) for g, m in self.groups.items()}
        self.slices = {}
        self.casts, self.cast_live = {}, set()
        self.queued = False
        self.alive, self.peak_bytes = 0, 0
        self.mode = "run"
        self.grad_handles = [self.whole[i].register_post_accumulate_grad_hook(
            lambda p, i=i: self._on_grad(i)) for i in self.whole]
        self._gather(ROOT)
        return self.whole

    def end(self):
        self.mode = "off"
        for h in self.grad_handles:
            h.remove()
        self.grad_handles = []
        self._free(list(self.whole))
        self.casts = {}
        for w in self.whole.values():
            w.grad = None
        return self.slices

    def track(self, forward, amp_dtype=None):
        """Run `forward(whole)` (under FakeTensorMode, with fake whole
        parameters) once, noting which unit reads each whole parameter; a
        parameter read outside its own unit joins the root group."""
        self.amp = amp_dtype
        real = self.whole
        self.whole = {i: torch.empty(self.step._shapes[i],
                                     dtype=real[i].dtype,
                                     device=real[i].device)
                      .requires_grad_(True) for i in real}
        used: Dict[int, set] = {}
        ids = {id(t): i for i, t in self.whole.items()}
        self.mode, self.active = "track", []
        try:
            with _Track(ids, self.active, used):
                forward(self.whole)
        finally:
            self.mode = "off"
            self.whole = real
        self.pinned = {i for i, us in used.items()
                       if us - {self.owner[i]}}
        self._regroup()

    def with_fakes(self):
        """Swap in whole parameters made under the caller's
        FakeTensorMode, for a traced step; returns the real ones."""
        real = self.whole
        self.whole = {i: torch.empty(self.step._shapes[i], dtype=w.dtype,
                                     device=w.device).requires_grad_(True)
                      for i, w in real.items()}
        return real

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


__all__ = ["Zero3Units", "find_units"]
