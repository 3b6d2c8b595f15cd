"""SPMD train step: data, tensor and ZeRO parallelism over processes.

Counterpart of `paddle_tpu/parallel/spmd.py` (SPMDTrainStep :51), with the
same constructor and call contract. The reference jits one program over
the mesh; the port runs one process per rank of the hybrid topology (dp x
pp x sharding x mp = the world, `fleet.init` / `init_parallel_env` first)
and each rank runs this step:

  - every rank is given the GLOBAL batch and takes its own rows along the
    data axes (`_batch_spec`, :124: axis 0 over ('dp', 'sharding'), or
    `batch_specs`), runs forward and backward on them, and the step
    returns the global mean loss (the reference's `lax.pmean`, :180), so
    one user script gives the same numbers in both packages. The mp ranks
    of one data coordinate share its rows: a model built of `mp_layers`
    holds the rank's slices and runs their collectives, and the
    gradients, slices or not, are reduced over the data group only (the
    ranks that share the rank's pp and mp coordinates). The pp axis is not
    a data axis here, as in the reference: its ranks are replicas;
  - stage 0: the gradients are averaged over the data ranks by the
    bucketed `Reducer`: `grad_reduction="bucketed"` through its hooks,
    overlapped with the backward; `"gspmd"` after the backward. Every
    rank then applies the same update, so the replicas stay bit-equal;
  - stages 1 and 2 shard the optimizer slots over the sharding group on
    each parameter's biggest divisible axis (`_shard_biggest_axis`, :38):
    each rank updates its slice of each such parameter and the slices are
    all-gathered (one flat collective per dtype). Stage 1 averages whole
    gradients; stage 2 reduce-scatters them (one flat collective per
    dtype), so a rank only ever holds its gradient slices;
  - stage 3 keeps only each rank's slice of those parameters between
    steps: the Parameters hold empty storage, and the step gathers the
    whole tensors one unit at a time (`zero3.py`: each repeated block,
    the embeddings, the head), right before the unit's forward and again
    before its backward, reduce-scatters the unit's gradients as soon as
    they are complete and frees it; `last_peak_gathered_bytes` is the
    most whole-parameter bytes the last step held at once. `unshard()`
    writes them back into the model (for eval or export); the next step
    frees them again;
  - a norm clip (`ClipGradByGlobalNorm`, `ClipGradByNorm`) over ZeRO-2/3
    slices or mp slices takes the norms of the whole gradients
    (`grad_clip.sharded_clip`: the squares of the rank's pieces, one
    all-reduce over the sharding group and one over mp), then scales the
    pieces; the reference clips inside its step on the logical whole
    gradients (:181);
  - `amp_dtype` (bf16 / fp16) runs the forward through
    `jit.functional.amp_functional_call` (stage 3 casts each unit's
    parameters inside the unit); FLAGS_check_nan_inf flags the
    loss and the reduced gradients (`raise_nonfinite`);
  - `state_dict` / `set_state_dict` hold whole tensors under the
    reference's keys (:330-372); `collective_signature(*batch)` traces
    the step on the batch without running it (the reference's :299-320):
    forward and backward under FakeTensorMode, every collective in
    `collective.record_only()`, no update; it returns the CollectiveDesc
    (op, axis, shape, dtype, perm) of each explicit collective in issue
    order, and works before the first step. `last_step_collectives()` is
    the (name, bytes) list the last step issued;
    `cost_analysis` / `memory_report` are one rank's; the obs plane's
    `step_record`, `h2d`, `build`, `device_compute`, `collective` and
    `optimizer` phases and the `params` / `opt_slots` census tags.

`donate` is accepted and means nothing here: parameters and slots are
updated in place. Without a process world, dp x sharding > 1 raises: start
that many processes (mp and pp axes there compute the dense layers in
one process). A sequence-parallel axis above 1 raises (ROADMAP.md Queue
1, "sp across processes").
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import monitor as _monitor
from .. import obs as _obs
from ..amp.state import auto_cast
from ..core import executable as _exe
from ..core import flags as _flags
from ..core.place import resolve_device
from ..jit.functional import (amp_functional_call, fake_of, functional_call,
                              split_state)
from ..jit.train_step import _host, _nbytes, raise_nonfinite
from ..nn.functional.norm import frozen_running_stats
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
from ..obs import memory as _mem
from ..optimizer.optimizer import _clip_fn
from . import collective
from .grad_clip import sharded_clip
from .reducer import Reducer
from .topology import get_hybrid_communicate_group, get_mesh

_DATA_AXES = ("dp", "sharding")
_MODEL_AXES = ("mp", "pp")


def _shard_biggest_axis(shape, axis_size):
    """The largest dim divisible by axis_size (ZeRO slicing), or None."""
    if not shape:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            return i
    return None


class SPMDTrainStep:
    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 sharding_stage: int = 0, amp_dtype=None, donate: bool = True,
                 batch_specs: Optional[Sequence] = None, n_model_inputs=None,
                 grad_reduction: str = "gspmd",
                 bucket_bytes: Optional[int] = None):
        from .data_parallel import DataParallel
        from .meta_parallel import TensorParallel
        # fleet's wrappers pass their state through to the wrapped layers:
        # the step binds and steps those, and reduces the gradients itself,
        # so a DataParallel's hooks come off (else any backward through
        # the net would start a second set of all-reduces)
        while isinstance(model, (DataParallel, TensorParallel)):
            if isinstance(model, DataParallel):
                model.reducer.detach_hooks()
            model = model._layers
        self.model = model
        self.loss_fn = loss_fn
        # a fleet HybridParallelOptimizer steps its inner optimizer
        self.optimizer = getattr(optimizer, "_inner_opt", optimizer)
        self.mesh = mesh or get_mesh()
        if self.mesh is None:
            raise ValueError("SPMDTrainStep requires a mesh (fleet.init or "
                             "create_mesh)")
        if grad_reduction not in ("gspmd", "bucketed"):
            raise ValueError(f"grad_reduction must be 'gspmd' or 'bucketed', "
                             f"got {grad_reduction!r}")
        if grad_reduction == "bucketed" and sharding_stage != 0:
            raise ValueError("grad_reduction='bucketed' supports the pure-DP "
                             "regime (sharding_stage=0)")
        self.sharding_stage = int(sharding_stage)
        self.amp_dtype = amp_dtype
        self._donate = donate
        self._batch_specs = batch_specs
        self._n_model_inputs = n_model_inputs
        self.grad_reduction = grad_reduction
        self._bucket_bytes = bucket_bytes
        shape = dict(self.mesh.shape)
        for ax, deg in shape.items():
            if ax not in _DATA_AXES + _MODEL_AXES and deg > 1:
                raise NotImplementedError(
                    f"SPMDTrainStep over a '{ax}' axis of {deg}: sequence "
                    "parallelism across processes is not ported (ROADMAP.md "
                    "Queue 1, \"sp across processes\")")
        self.dp_degree = int(shape.get("dp", 1))
        self.sharding_degree = int(shape.get("sharding", 1))
        self.mp_degree = int(shape.get("mp", 1))
        self.pp_degree = int(shape.get("pp", 1))
        n_data = self.dp_degree * self.sharding_degree
        hcg = get_hybrid_communicate_group()
        self._hcg = hcg if hcg is not None and \
            getattr(hcg, "process_mode", False) else None
        if n_data > 1 and self._hcg is None:
            raise RuntimeError(
                f"SPMDTrainStep over dp x sharding = {n_data} runs one "
                f"process per rank: start {n_data} processes (python -m "
                f"paddle_tpu_torch.parallel.launch --nproc_per_node {n_data} "
                "script.py, or paddle_tpu_torch.parallel.spawn) and call "
                "fleet.init / init_parallel_env in each")
        if self._hcg is not None and (
                self._hcg.dp_degree, self._hcg.sharding_degree,
                self._hcg.mp_degree, self._hcg.pp_degree) != (
                self.dp_degree, self.sharding_degree, self.mp_degree,
                self.pp_degree):
            raise ValueError(f"mesh {shape} is not the process world's "
                             f"hybrid topology")
        self.reducer = None
        self._built = False
        self._units = None
        self._units_tracked = False
        self.last_peak_gathered_bytes = None
        self._last_signature = None
        self._pending_state = None
        self._ledger = _exe.ExecutableLedger("spmd_train_step")

    # ---- the rank's place on the data axes ----
    def _coords(self):
        h = self._hcg
        if h is None:
            return {"dp": 0, "sharding": 0}
        return {"dp": h.get_data_parallel_rank(),
                "sharding": h.get_sharding_parallel_rank()}

    def _groups(self):
        """(data group, dp group, sharding group, mp group): the world and
        lone groups without a hybrid topology."""
        world = collective.get_group(0)
        h = self._hcg
        if h is None:
            return world, world, world, collective.Group([0], None)
        return h.get_data_axes_group(), h.get_data_parallel_group(), \
            h.get_sharding_parallel_group(), h.get_model_parallel_group()

    def _batch_spec(self, ndim, i):
        if self._batch_specs is not None and i < len(self._batch_specs):
            return tuple(self._batch_specs[i])
        return (_DATA_AXES,)

    def _local_rows(self, x, i):
        """This rank's block of a global batch argument under its spec."""
        spec = self._batch_spec(x.ndim, i)
        coords = self._coords()
        deg = {"dp": self.dp_degree, "sharding": self.sharding_degree}
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            parts, idx = 1, 0
            for a in axes:
                idx = idx * deg.get(a, 1) + coords.get(a, 0)
                parts *= deg.get(a, 1)
            if parts == 1:
                continue
            if x.shape[dim] % parts:
                raise ValueError(f"batch argument {i}: axis {dim} of "
                                 f"{tuple(x.shape)} does not split into "
                                 f"{parts} ranks")
            x = x.chunk(parts, dim)[idx]
        return x

    # ---- build ----
    def _build(self):
        if _monitor._ENABLED:
            _monitor.count("spmd_train_step.builds")
        self._nan_check = bool(_flags.flag("check_nan_inf"))
        trainable, frozen = split_state(self.model)
        self._pnames, self._bnames = list(trainable), list(frozen)
        self._ptensors = [trainable[n] for n in self._pnames]
        self._btensors = [frozen[n] for n in self._bnames]
        opt = self.optimizer
        opt._parameter_list = opt._parameter_list or self._ptensors
        self._device = self._ptensors[0].device if self._ptensors \
            else resolve_device()
        self._shapes = [tuple(p.shape) for p in self._ptensors]
        S = self.sharding_degree
        self._s = self._coords()["sharding"]
        self._dims = [_shard_biggest_axis(s, S)
                      if self.sharding_stage >= 1 and S > 1 else None
                      for s in self._shapes]
        self._world, self._dp_group, self._sh_group, self._mp_group = \
            self._groups()
        world = self._world
        self._sharded = [i for i, d in enumerate(self._dims) if d is not None]
        self._replicated = [i for i, d in enumerate(self._dims) if d is None]
        if self.sharding_stage >= 2:
            reduced = [self._ptensors[i] for i in self._replicated]
        else:
            reduced = self._ptensors
        self.reducer = Reducer(reduced, axis=world,
                               bucket_bytes=self._bucket_bytes,
                               find_unused_parameters=True)
        # slots shaped like each parameter's slice (the whole parameter
        # where it is not sharded)
        self._slots = opt.init_state([self._slice(p.detach(), i).contiguous()
                                      for i, p in enumerate(self._ptensors)])
        # stage 3: each rank keeps its slices; the Parameters are emptied
        self._shards = {}
        if self.sharding_stage >= 3:
            for i in self._sharded:
                p = self._ptensors[i]
                self._shards[i] = self._slice(p.detach(), i).clone()
                p.data = p.data.new_empty(0)
            if self._sharded:
                from .zero3 import Zero3Units
                self._units = Zero3Units(self)
        self._built = True
        if self._pending_state is not None:
            sd, self._pending_state = self._pending_state, None
            self._apply_state(sd)
        if _mem._ENABLED:
            self._tag_state()

    def _slice(self, t, i):
        d = self._dims[i]
        return t if d is None else t.chunk(self.sharding_degree, d)[self._s]

    def _tag_state(self):
        _mem.tag("params", [self._shards.get(i, p) for i, p in
                            enumerate(self._ptensors)], origin="SPMDTrainStep")
        _mem.tag("opt_slots", self._slots, origin="SPMDTrainStep")
        _mem.tag("model_buffers", self._btensors, origin="SPMDTrainStep")

    # ---- flat collectives over the sharded parameters ----
    def _by_dtype(self, idx, tensors):
        groups = {}
        for i in idx:
            groups.setdefault(tensors[i].dtype, []).append(i)
        return groups.values()

    def _gather_slices(self, slices: dict, dims: Optional[dict] = None) -> dict:
        """{key: this rank's slice} -> {key: the whole tensor}: one
        all_gather of the flat slices per dtype over the sharding group.
        `dims` gives each key's sharded axis (the parameter's by default)."""
        dims = dims or {i: self._dims[i] for i in slices}
        out = {}
        S = self.sharding_degree
        for idx in self._by_dtype(list(slices), slices):
            flat = torch.cat([slices[i].reshape(-1) for i in idx])
            parts = []
            collective.all_gather(parts, flat, group=self._sh_group)
            stacked = torch.stack(parts)               # [S, total]
            off = 0
            for i in idx:
                sl = slices[i]
                n = sl.numel()
                pieces = stacked[:, off:off + n].reshape((S,) + tuple(sl.shape))
                out[i] = torch.cat(list(pieces.unbind(0)), dim=dims[i])
                off += n
        return out

    def _scatter_grads(self, grads, members=None) -> dict:
        """Whole local gradients of the sharded parameters (`members`, all
        of them by default) -> {i: this rank's slice of their mean over
        the data ranks}: one flat reduce_scatter per dtype over the
        sharding group, then an all-reduce of the slices over the dp
        group."""
        out = {}
        S = self.sharding_degree
        members = self._sharded if members is None else members
        for idx in self._by_dtype(members, grads):
            rows = [torch.stack([c.reshape(-1) for c in
                                 grads[i].chunk(S, self._dims[i])])
                    for i in idx]                       # [S, n_i] each
            src = torch.cat(rows, dim=1).reshape(-1)     # row r: slices r
            mine = collective.reduce_scatter(None, src, group=self._sh_group)
            if self.dp_degree > 1:
                collective.all_reduce(mine, group=self._dp_group)
            mine.mul_(torch.tensor(1.0 / (S * self.dp_degree),
                                   dtype=mine.dtype, device=mine.device))
            off = 0
            for i in idx:
                shape = tuple(grads[i].chunk(S, self._dims[i])[self._s].shape)
                n = int(np.prod(shape))
                out[i] = mine[off:off + n].reshape(shape)
                off += n
        return out

    # ---- one step ----
    def _full_params(self, fm=None):
        """The whole parameters for this step (stage 3 gathers them; fakes
        under FakeTensorMode `fm`)."""
        if fm is not None:
            return [fake_of(fm, p) for p in self._ptensors]
        if not self._shards:
            return [p.detach() for p in self._ptensors]
        full = self._gather_slices(self._shards)
        return [full.get(i, p.detach()) for i, p in enumerate(self._ptensors)]

    def _prepare(self, batch):
        if not self._built:
            with _obs.phase("build"):
                self._build()
        with _obs.phase("h2d"):
            arrs = [self._local_rows(torch.as_tensor(b, device=self._device), i)
                    for i, b in enumerate(batch)]
            if _obs._TL_ENABLED:
                _obs.fence(self._device)
        if _mem._ENABLED:
            _mem.tag("activations", arrs, origin="SPMDTrainStep.batch")
        n_mi = self._n_model_inputs
        if n_mi is None:
            n_mi = len(arrs) if len(arrs) <= 1 else len(arrs) - 1
        if self._units is not None and not self._units_tracked:
            self._track_units(arrs[:n_mi])
        return arrs[:n_mi], arrs[n_mi:]

    def _local_loss(self, inputs, labels, full, buffers=None):
        ps = [t.detach().requires_grad_() for t in full]
        out = amp_functional_call(
            self.model, self._pnames, ps, self._bnames,
            self._btensors if buffers is None else buffers, inputs,
            self.amp_dtype)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return ps, self.loss_fn(*outs, *labels)

    def _backward(self, inputs, labels, full, buffers=None):
        """Forward and backward on this rank's rows: (local loss, local
        gradients; stage 0 bucketed: already averaged by the hooks)."""
        bucketed = self.grad_reduction == "bucketed"
        with torch.enable_grad(), frozen_running_stats():
            ps, loss = self._local_loss(inputs, labels, full, buffers)
            if bucketed:
                self.reducer.attach(ps)
            try:
                torch.autograd.backward(loss, inputs=ps)
            finally:
                if bucketed:
                    self.reducer.detach_hooks()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in ps]
        return loss.detach(), grads

    def _backward_by_units(self, inputs, labels, fm=None):
        """Stage 3: forward and backward with the whole parameters
        gathered unit by unit (`zero3.Zero3Units`): (local loss, whole
        gradients of the replicated parameters (None for the sharded),
        {i: the mean gradient slice of each sharded parameter}). Under
        FakeTensorMode `fm`, on fakes (a traced step)."""
        units = self._units
        fake = fm is not None
        if fake:
            real = units.with_fakes()
        else:
            for i in units.whole:       # after unshard(): free them again
                p = self._ptensors[i]
                if p.numel():
                    p.data = p.data.new_empty(0)
        whole = units.begin(fake=fake, amp_dtype=self._amp())
        try:
            binds = [whole[i] if i in whole else
                     fake_of(fm, p) if fake else p.detach().requires_grad_()
                     for i, p in enumerate(self._ptensors)]
            with torch.enable_grad(), frozen_running_stats():
                out = self._units_forward(binds, self._buffers_for(fm),
                                          inputs)
                outs = list(out) if isinstance(out, (list, tuple)) else [out]
                loss = self.loss_fn(*outs, *labels)
                torch.autograd.backward(loss, inputs=binds)
            grads = [None if i in whole else
                     (torch.zeros_like(b) if b.grad is None else b.grad)
                     for i, b in enumerate(binds)]
        finally:
            slices = units.end()
            if fake:
                units.whole = real
        if not fake:
            self.last_peak_gathered_bytes = units.peak_bytes
        return loss.detach(), grads, slices

    def _amp(self):
        from ..core.dtype import convert_dtype
        return None if self.amp_dtype is None else \
            convert_dtype(self.amp_dtype)

    def _units_forward(self, binds, buffers, inputs):
        """The model's forward on `binds` as `amp_functional_call` runs
        it, except that under AMP a unit's whole parameters are cast where
        the unit runs (its forward pre-hook, `zero3.py`), not before the
        forward: a cast before it would read every parameter at once."""
        dt = self._amp()
        if dt is None:
            return functional_call(self.model, self._pnames, binds,
                                   self._bnames, buffers, *inputs)
        lazy = self._units.cast_in_unit
        cast = [b if i in lazy or not b.is_floating_point() else b.to(dt)
                for i, b in enumerate(binds)]
        for i in self._units.whole:     # the root group's, cast here
            if i not in lazy:
                self._units.hold_cast(binds[i], cast[i])
        with auto_cast(enable=True, dtype=dt):
            return functional_call(self.model, self._pnames, cast,
                                   self._bnames, buffers, *inputs)

    def _buffers_for(self, fm):
        """The buffers to bind: fakes under FakeTensorMode `fm`."""
        if fm is None:
            return self._btensors
        return [fake_of(fm, b) for b in self._btensors]

    def _track_units(self, inputs):
        """Find the parameters read outside their unit (once, under
        FakeTensorMode; see zero3.py)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True) as fm, \
                collective.record_only(), torch.no_grad(), \
                frozen_running_stats():
            finputs = [fm.from_tensor(x) for x in inputs]

            def forward(whole):
                binds = [whole[i] if i in whole else fake_of(fm, p)
                         for i, p in enumerate(self._ptensors)]
                self._units_forward(binds, self._buffers_for(fm), finputs)
            self._units.track(forward, amp_dtype=self._amp())
        self._units_tracked = True

    def _reduce(self, grads, slices=None):
        """Local gradients -> (whole gradients of the replicated set or of
        all parameters, {i: slice} of the sharded ones under stage 2/3).
        `slices`: the sharded ones' mean slices, already reduced (stage 3
        by units)."""
        if slices is not None:
            rep = self.reducer.reduce([grads[i] for i in self._replicated])
            whole = [None] * len(grads)
            for i, g in zip(self._replicated, rep):
                whole[i] = g
            return whole, slices
        if self.sharding_stage >= 2:
            rep = self.reducer.reduce([grads[i] for i in self._replicated])
            whole = [None] * len(grads)
            for i, g in zip(self._replicated, rep):
                whole[i] = g
            return whole, self._scatter_grads(grads)
        if self.grad_reduction == "bucketed":
            return grads, {}
        return self.reducer.reduce(grads), {}

    def _global_loss(self, loss):
        loss = loss.float().clone()
        collective.all_reduce(loss, op=collective.ReduceOp.AVG,
                              group=self._world)
        return loss

    def _nonfinite(self, loss, whole, parts):
        gs = [parts[i] if whole[i] is None else whole[i]
              for i in range(len(whole))]
        bad = torch.stack([~torch.isfinite(loss)]
                          + [~torch.isfinite(g).all() for g in gs])
        if parts or self._mp_group.nranks > 1:
            # slices differ across ranks: agree on the flags
            flags = bad.to(torch.int32)
            collective.all_reduce(flags, op=collective.ReduceOp.MAX,
                                  group=collective.get_group(0))
            bad = flags.bool()
        return bad

    def _counted(self):
        """Whether this rank's piece of each parameter counts toward a
        norm: a piece replicated over mp counts on mp rank 0 only, and
        one replicated over the sharding group (whole at stage 2/3) on
        sharding rank 0 only."""
        mp0 = self._mp_group.rank <= 0
        sh0 = self._sh_group.rank <= 0 or self.sharding_stage < 2
        return [(getattr(p, "_mp_split", None) is not None or mp0)
                and (self._dims[i] is not None or sh0)
                for i, p in enumerate(self._ptensors)]

    def _norm_clip_pieces(self, whole, parts):
        """The norm clip over pieces split across ranks (mp slices, ZeRO-2/3
        slices): the clipped (whole, parts), or None when it does not
        apply."""
        clip = getattr(self.optimizer, "_grad_clip", None)
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            return None
        split_sh = self.sharding_stage >= 2 and bool(self._sharded)
        if self._mp_group.nranks <= 1 and not split_sh:
            return None
        pieces = [parts[i] if i in parts else whole[i]
                  for i in range(len(whole))]
        groups = [g for g in ((self._sh_group if split_sh else None),
                              self._mp_group)
                  if g is not None and g.nranks > 1]
        clipped = sharded_clip(clip, pieces, self._ptensors, groups,
                               self._counted())
        new_parts = {i: clipped[i] for i in parts}
        new_whole = [None if i in parts else clipped[i]
                     for i in range(len(whole))]
        return new_whole, new_parts

    def _clip(self, whole, parts):
        """The clip the update does not do itself: (whole, parts, the
        update's grad_clip argument)."""
        clipped = self._norm_clip_pieces(whole, parts)
        if clipped is not None:
            whole, parts = clipped
            if self.sharding_stage == 1:
                parts = {i: self._slice(whole[i], i) for i in self._sharded}
            return whole, parts, None
        if self.sharding_stage == 1 and self._sharded:
            clip = getattr(self.optimizer, "_grad_clip", None)
            need = [getattr(p, "need_clip", True) for p in self._ptensors]
            whole = _clip_fn(clip, whole, need)
            parts = {i: self._slice(whole[i], i) for i in self._sharded}
            return whole, parts, None
        return whole, parts, "default"

    def _update(self, whole, parts, clip_arg, apply=True):
        """The values to update (each parameter's slice, or the whole
        parameter), updated in place unless `apply` is False."""
        opt = self.optimizer
        values, grads = [], []
        for i, p in enumerate(self._ptensors):
            if i in self._shards:
                values.append(self._shards[i])
            elif self._dims[i] is not None:
                values.append(self._slice(p.detach(), i).contiguous())
            else:
                values.append(p.detach())
            grads.append(parts[i] if i in parts else whole[i])
        if apply:
            opt.functional_update(values, grads, self._slots, opt._lr_arr,
                                  opt._t_arr, params_meta=self._ptensors,
                                  grad_clip=clip_arg)
            opt._t_arr.add_(1.0)
        return values

    def _regather(self, values, write=True):
        """Stages 1-2: the updated slices, all-gathered into the whole
        parameters (written back unless `write` is False)."""
        if self._shards or not self._sharded:
            return
        full = self._gather_slices({i: values[i] for i in self._sharded})
        if write:
            with torch.no_grad():
                for i, t in full.items():
                    self._ptensors[i].copy_(t)

    def _step(self, inputs, labels, fm=None, novel=False):
        """The step's work in issue order: forward and backward (stage 3
        unit by unit), the gradient reduction, the global loss, the
        non-finite flags, the norm clip, the update and the regather;
        returns (global loss, the flags or None). Under FakeTensorMode `fm`
        (`collective_signature`) it runs on fakes and does not update: the
        regather gathers the slices of fakes and writes nothing."""
        traced = fm is not None
        tl = _obs._TL_ENABLED and not traced

        def phase(name):
            return contextlib.nullcontext() if traced else _obs.phase(name)

        # the booking is the device_compute phase (trace_compile for a
        # novel signature): stage 3's gathers, forward and backward (with
        # the bucketed reduction overlapped)
        with contextlib.nullcontext() if traced else \
                _exe.booking("spmd_train_step") as bk:
            if novel:
                bk.compiled()
            slices = None
            if self._units is not None:
                loss, grads, slices = self._backward_by_units(inputs, labels,
                                                              fm)
            else:
                loss, grads = self._backward(inputs, labels,
                                             self._full_params(fm),
                                             self._buffers_for(fm))
            if tl:
                _obs.fence(self._device)
        with phase("collective"):
            whole, parts = self._reduce(grads, slices)
            del grads
            gloss = self._global_loss(loss)
            bad = self._nonfinite(gloss, whole, parts) \
                if self._nan_check else None
            if tl:
                _obs.fence(self._device)
        with phase("optimizer"):
            whole, parts, clip_arg = self._clip(whole, parts)
            values = self._update(whole, parts, clip_arg, apply=not traced)
            if tl:
                _obs.fence(self._device)
        with phase("collective"):
            self._regather(values, write=not traced)
            if tl:
                _obs.fence(self._device)
        return gloss, bad

    def __call__(self, *batch):
        """batch: GLOBAL input tensors; the first `n_model_inputs` go to
        model.forward, the rest to loss_fn. Returns the global mean loss
        as a 0-d f32 tensor on the rank's device."""
        with _obs.step_record():
            first = not self._built
            inputs, labels = self._prepare(batch)
            novel = first
            if _monitor._ENABLED or _obs._TL_ENABLED:
                novel = self._ledger.note(_monitor.arg_signature(
                    inputs + labels))
            opt = self.optimizer
            opt._lr_scalar(self._device)
            opt._t_scalar(self._device)
            _mon = _monitor._ENABLED
            if _mon:
                t0 = time.time()
            with collective.capture() as seq, \
                    _exe.dispatch_guard("SPMDTrainStep",
                                        report=self._state_report):
                gloss, bad = self._step(inputs, labels, novel=novel)
            self._last_signature = list(seq)
            opt._count_steps(1)
            if _mem._ENABLED:
                self._tag_state()
            if _mon:
                _monitor.count("spmd_train_step.steps")
                _monitor.observe("spmd_train_step.dur", time.time() - t0)
            raise_nonfinite(bad, self._pnames, "SPMD train step")
            return gloss

    def loss_and_grads(self, *batch):
        """(global mean loss, the gradients of every parameter averaged
        over the data ranks, whole, in `split_state` order) at the current
        parameters, updating nothing. Every rank must call it."""
        inputs, labels = self._prepare(batch)
        loss, grads = self._backward(inputs, labels, self._full_params())
        whole, parts = self._reduce(grads)
        if parts:
            full = self._gather_slices(parts)
            whole = [full[i] if w is None else w
                     for i, w in enumerate(whole)]
        return self._global_loss(loss), whole

    def unshard(self):
        """Stage 3: write the whole parameters back into the model (one
        all_gather); the next step frees them again."""
        if not self._shards:
            return
        full = self._gather_slices(self._shards)
        for i, t in full.items():
            self._ptensors[i].data = t

    def _state_report(self):
        slots = [v for s in (self._slots or []) for v in s.values()]
        return {"param_bytes": _nbytes(self._shards.get(i, p) for i, p in
                                       enumerate(self._ptensors)),
                "slot_bytes": _nbytes(slots),
                "buffer_bytes": _nbytes(self._btensors)}

    # ---- introspection ----
    def collective_signature(self, *batch):
        """The step's collective sequence on `batch`, traced without running
        it (the reference's :299-320): the step's own body (`_step`) under
        FakeTensorMode on fakes of the parameters and the rank's rows,
        every collective in `collective.record_only()`, with no update.
        Returns the CollectiveDesc (op, axis, shape, dtype, perm) of each,
        in issue order; works before the first step (it builds the step)
        and changes no parameter, slot or count. Equal on every rank of a
        healthy world: hold two ranks' lists to find where one diverges
        before the world deadlocks on it."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        inputs, labels = self._prepare(batch)
        with FakeTensorMode(allow_non_fake_inputs=True) as fm, \
                collective.record_only() as seq:
            self._step([fm.from_tensor(x) for x in inputs],
                       [fm.from_tensor(x) for x in labels], fm)
        return list(seq)

    def last_step_collectives(self):
        """The (name, bytes) sequence of the collectives this rank issued
        in its last step, in issue order (None before a step)."""
        return None if self._last_signature is None \
            else list(self._last_signature)

    def cost_analysis(self, *batch):
        """{"flops", "bytes_accessed"} of this rank's forward + backward at
        `batch` (FlopCounterMode, as jit.TrainStep.cost_analysis; one
        rank's rows, as the reference reports one shard's). No collective,
        no update."""
        inputs, labels = self._prepare(batch)
        full = self._full_params()
        with FlopCounterMode(display=False) as counter, torch.enable_grad(), \
                frozen_running_stats():
            ps, loss = self._local_loss(inputs, labels, full)
            torch.autograd.grad(loss, ps, allow_unused=True)
        return {"flops": float(counter.get_total_flops()),
                "bytes_accessed": None}

    def memory_report(self, *batch):
        """This rank's bytes, under jit.TrainStep.memory_report's keys:
        `argument_bytes` (its parameters or slices, slots, buffers and
        rows), `alias_bytes` (parameters and slots, updated in place),
        `output_bytes`, `generated_code_bytes` (0), and on CUDA
        `temp_bytes` / `peak_bytes` of one forward + backward (None on the
        CPU). No collective, no update."""
        inputs, labels = self._prepare(batch)
        params = [self._shards.get(i, p) for i, p in
                  enumerate(self._ptensors)]
        slots = [v for s in self._slots for v in s.values()]
        state = _nbytes(itertools.chain(params, slots))
        report = {"argument_bytes": state + _nbytes(self._btensors)
                  + _nbytes(inputs + labels),
                  "alias_bytes": state, "output_bytes": state + 4,
                  "generated_code_bytes": 0, "temp_bytes": None,
                  "peak_bytes": None,
                  "param_bytes": _nbytes(params), "slot_bytes": _nbytes(slots)}
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
            base = torch.cuda.memory_allocated(self._device)
            torch.cuda.reset_peak_memory_stats(self._device)
            full = self._full_params()
            with torch.enable_grad(), frozen_running_stats():
                ps, loss = self._local_loss(inputs, labels, full)
                torch.autograd.grad(loss, ps, allow_unused=True)
            torch.cuda.synchronize(self._device)
            peak = torch.cuda.max_memory_allocated(self._device)
            report["temp_bytes"] = peak - base
            report["peak_bytes"] = peak
        return report

    # ---- loop state ----
    def state_dict(self):
        """Whole tensors (gathered; every rank must call it) of the
        parameters and optimizer slots and the step count, under the
        reference's keys."""
        if not self._built:
            raise RuntimeError("SPMDTrainStep.state_dict() requires a built "
                               "step — run at least one step first")
        params = {}
        full = self._gather_slices(self._shards) if self._shards else {}
        for i, (n, p) in enumerate(zip(self._pnames, self._ptensors)):
            params[n] = _host(full.get(i, p))
        slots = []
        keys = [(i, k) for i in self._sharded for k in self._slots[i]]
        gathered = self._gather_slices(
            {key: self._slots[key[0]][key[1]] for key in keys},
            {key: self._dims[key[0]] for key in keys}) if keys else {}
        for i, s in enumerate(self._slots):
            slots.append({k: _host(gathered.get((i, k), v))
                          for k, v in s.items()})
        return {"kind": "spmd_train_step", "params": params, "slots": slots,
                "step_count": int(self.optimizer._step_count)}

    def set_state_dict(self, sd):
        if not self._built:
            self._pending_state = sd
            self.optimizer._step_count = int(sd["step_count"])
            return
        self._apply_state(sd)

    @torch.no_grad()
    def _apply_state(self, sd):
        params = sd["params"]
        for i, (n, p) in enumerate(zip(self._pnames, self._ptensors)):
            if n not in params:
                continue
            whole = torch.as_tensor(np.asarray(params[n]), device=self._device)
            if i in self._shards:
                self._shards[i].copy_(self._slice(whole, i))
            else:
                p.copy_(whole)
        for i, (slots, saved) in enumerate(zip(self._slots, sd["slots"])):
            for k, v in slots.items():
                whole = torch.as_tensor(np.asarray(saved[k]),
                                        device=self._device)
                v.copy_(self._slice(whole, i) if self._dims[i] is not None
                        else whole)
        opt = self.optimizer
        opt._step_count = int(sd["step_count"])
        opt._t_scalar(self._device)


__all__ = ["SPMDTrainStep"]
