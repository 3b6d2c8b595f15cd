"""Whole-train-step driver: forward, backward and optimizer update.

Counterpart of `paddle_tpu/jit/train_step.py` (TrainStep :54-396,
raise_nonfinite :33-51), with the same constructor. Where the reference
compiles forward + backward + update into one XLA executable with donated
parameter and slot buffers, the port runs them on the parameters' device
and updates the parameters and slots in place. The learning rate and the
step counter are the optimizer's 0-d f32 tensors on that device
(`Optimizer._lr_scalar` / `_t_scalar`, the reference's `_lr_arr` /
`_t_arr`): the bias corrections read them there.

`run()` is the counterpart of the `lax.scan` span (:375-396, "one host
dispatch + one sync per span"). On a CUDA device it replays one CUDA graph
per step: the first step of a new signature runs eagerly, the step is
captured once, and every later step copies its batch into the graph's
static inputs and replays it. On the CPU it is a loop over the steps.

Usage:
    step = TrainStep(model, loss_fn, optimizer, amp_dtype="bfloat16")
    loss = step(x, y)          # x to model.forward, y to loss_fn
    losses = step.run(xs, ys)  # xs/ys stacked along a leading n_steps axis

`__call__` and `run()` take `Tensor` batches too (the Tensor API's
boundary): they unwrap them at entry, so the step and its CUDA graphs'
static buffers stay plain, and return the loss(es) as `Tensor` exactly when
a batch entry was one.

The reference's plane, each behind its flag's one attribute check: the
`jit.train_step.builds` / `.steps` / `.dur` counters and the signature
ledger's retrace counters (FLAGS_monitor); one step record per step with
the `build`, `h2d` and `device_compute` phases (`trace_compile` for a
novel signature's first step and for a run() capture), device_compute
fenced on the stream the step was launched on (FLAGS_obs_timeline,
`run()` included: one record per step, replays too); the `params`,
`opt_slots`, `step_state`, `model_buffers` and `activations` memory tags
(FLAGS_mem_census); `dispatch_guard("TrainStep")` around every step. The
reference's persistent compile cache waits for the `to_static` slice.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import monitor as _monitor
from .. import obs as _obs
from ..core import executable as _exe
from ..core import flags as _flags
from ..core.enforce import UnimplementedError
from ..obs import memory as _mem
from ..core.place import resolve_device
from ..core.random import get_rng_state, set_rng_state
from ..core.tensor import api
from ..nn.functional.norm import frozen_running_stats
from ..parallel.topology import get_mesh
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
    """A host copy, never a view of a CPU tensor that later steps update in
    place; bf16 (which numpy lacks) widens exactly to f32."""
    t = t.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.to("cpu", copy=True).numpy()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Captured:
    """One step captured in a CUDA graph: its static inputs, the [capacity]
    loss buffer and [capacity, P+1] flag buffer it writes at the span's
    step index, and the data pointers of the state it was captured over."""

    def __init__(self, graph, inputs, labels, losses, bads, ptrs):
        self.graph, self.inputs, self.labels = graph, inputs, labels
        self.losses, self.bads, self.ptrs = losses, bads, ptrs


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
        # signature ledger: novelty + retrace accounting (a novel signature
        # is the step's first eager run, or a run() capture)
        self._ledger = _exe.ExecutableLedger("train_step")

    def _build(self):
        if _monitor._ENABLED:
            _monitor.count("jit.train_step.builds")
        # FLAGS_check_nan_inf is read once, at the first step
        self._nan_check = bool(_flags.flag("check_nan_inf"))
        trainable, frozen = split_state(self.model)
        self._pnames, self._bnames = list(trainable), list(frozen)
        self._ptensors = [trainable[n] for n in self._pnames]
        self._btensors = [frozen[n] for n in self._bnames]
        opt = self.optimizer
        opt._parameter_list = opt._parameter_list or self._ptensors
        self._slots = opt.init_state(self._ptensors)
        self._device = self._ptensors[0].device if self._ptensors \
            else resolve_device()
        dev = self._device
        # the index of the step within a run() span, where a replayed
        # graph writes its loss
        self._i = torch.zeros(1, dtype=torch.int64, device=dev)
        self._graphs = {}
        self._built = True

    def _tag_state(self):
        """Tag the loop state for the memory census. The port updates the
        state in place (the reference's donated buffers are replaced and
        re-tagged every step), so its storages keep their tags: the tags
        are (re)made only when the census does not know them yet."""
        if self._ptensors and \
                _mem.tag_of(self._ptensors[0]) == ("params", "TrainStep"):
            return
        _mem.tag("params", self._ptensors, origin="TrainStep")
        _mem.tag("opt_slots", self._slots, origin="TrainStep")
        opt = self.optimizer
        _mem.tag("step_state", [opt._t_arr, opt._lr_arr, self._i],
                 origin="TrainStep")
        _mem.tag("model_buffers", self._btensors, origin="TrainStep")

    def _prepare(self, batch, steps_axis=False, note=True):
        """The batch on the parameters' device, split into model inputs and
        labels; and whether its signature is novel (`steps_axis`: per-step
        shapes, behind run()'s leading n_steps axis; `note=False`: a query
        that runs no step)."""
        if not self._built:
            with _obs.phase("build"):
                self._build()
        with _obs.phase("h2d"):
            arrs = [torch.as_tensor(b, device=self._device) for b in batch]
            if _obs._TL_ENABLED:
                _obs.fence(self._device)
        if _mem._ENABLED:
            _mem.tag("activations", arrs, origin="TrainStep.batch")
        n_mi = self._n_model_inputs
        if n_mi is None:
            n_mi = len(arrs) if len(arrs) <= 1 else len(arrs) - 1
        novel = False
        if note and (_monitor._ENABLED or _obs._TL_ENABLED):
            sig = _monitor.arg_signature(
                [a[0] for a in arrs] if steps_axis else arrs)
            novel = self._ledger.note((steps_axis,) + sig, detail=sig)
        return arrs[:n_mi], arrs[n_mi:], novel

    def _scalars(self):
        """The optimizer's lr and t device scalars, brought up to date
        (lr after a scheduler tick, t after `_step_count` was set) before
        a step or a span, never inside a capture; no copy from the host."""
        opt = self.optimizer
        return opt._lr_scalar(self._device), opt._t_scalar(self._device)

    def _loss_and_grads(self, inputs, labels):
        """Forward and backward at the current parameters: (loss, grads),
        grads aligned with the trainable parameters. Updates nothing: as
        in the reference's traced step, batch norm's running statistics
        stay as they are.

        The gradients are taken with respect to fresh leaf aliases of the
        parameters (`p.detach().requires_grad_()`, sharing their storage),
        so no Parameter's own autograd node is reached. A graph that an
        eager loop left alive (a loss kept with its graph) holds those
        nodes on the stream it ran on, and a CUDA-graph capture that
        reached them would have to sync with that stream."""
        ps = [p.detach().requires_grad_() for p in self._ptensors]
        with torch.enable_grad(), frozen_running_stats():
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
        """One step on the device alone: reads no value back, so it can be
        captured. The optimizer's host counter is advanced by the caller."""
        loss, grads = self._loss_and_grads(inputs, labels)
        bad = None
        if self._nan_check:
            bad = torch.stack([~torch.isfinite(loss)]
                              + [~torch.isfinite(g).all() for g in grads])
        # in place: the reference donates these buffers to its update
        opt = self.optimizer
        opt.functional_update(
            [p.detach() for p in self._ptensors], grads, self._slots,
            opt._lr_arr, opt._t_arr, params_meta=self._ptensors)
        opt._t_arr.add_(1.0)
        return loss, bad

    @api
    def __call__(self, *batch):
        """batch: input tensors consumed by model.forward; loss_fn receives
        the model output(s) and the remaining tensors. Runs eagerly and
        returns the loss as a 0-d tensor on the device (no host sync, but
        with FLAGS_obs_timeline, whose device_compute phase synchronizes
        the step's stream)."""
        with _obs.step_record():
            inputs, labels, novel = self._prepare(batch)
            _mon = _monitor._ENABLED
            if _mon:
                t0 = time.time()
            with _exe.booking("train_step") as bk:
                if novel:
                    bk.compiled()
                with _exe.dispatch_guard("TrainStep",
                                         report=self._state_report):
                    self._scalars()
                    loss, bad = self._one_step(inputs, labels)
                if _obs._TL_ENABLED:
                    _obs.fence(self._device)
            self.optimizer._count_steps(1)
            if _mem._ENABLED:
                self._tag_state()
            if _mon:
                _monitor.count("jit.train_step.steps")
                _monitor.observe("jit.train_step.dur", time.time() - t0)
            raise_nonfinite(bad, self._pnames, "train step")
            return loss

    def _state_report(self):
        """The step's resident bytes, for an OOM dump."""
        slots = [v for s in self._slots for v in s.values()]
        return {"param_bytes": _nbytes(self._ptensors),
                "slot_bytes": _nbytes(slots),
                "buffer_bytes": _nbytes(self._btensors)}

    @api
    def run(self, *batch):
        """Every tensor in `batch` is stacked along a leading n_steps axis;
        runs the n optimizer steps and returns the [n] losses.

        The lr is read once per span, as the reference fixes its
        `_lr_arr` for a span. On one CUDA device each step is one replay
        of a CUDA graph of the whole step (forward, backward, the update,
        `t += 1`, the loss and, with FLAGS_check_nan_inf, the finite flags
        written at the step's index). A graph is cached per signature (the
        per-step shapes and dtypes, the AMP dtype, the nan check, the
        deterministic-algorithms switch and the model's training flag) and
        captured again when the parameters, slots, buffers or step scalars
        no longer live where it was captured. The first step after a
        capture is the eager warm-up (on a side stream) and counts as a
        step; so `run()` of one step is that step alone. A failing capture
        or replay raises: it never carries on eagerly. The kernels'
        `.launches` counters count host calls, so a capture counts once and
        a replay not at all. Dropout draws a fresh mask at every replay.

        On the CPU, and where the parameters or the current mesh span more
        than one device (a step no four-card machine has captured yet), the
        span is a loop over the eager step.

        With FLAGS_obs_timeline every step of the span gets its own step
        record (the batch's upload lands between steps): its `h2d` phase
        copies the step's batch into the graph's static inputs, its
        `device_compute` phase (`trace_compile` for the capture) ends when
        the stream the replay was issued to is synchronized."""
        inputs, labels, _novel = self._prepare(batch, steps_axis=True)
        n_steps = int(inputs[0].shape[0]) if inputs \
            else int(labels[0].shape[0])
        self._scalars()
        _mon = _monitor._ENABLED
        if _mon:
            t0 = time.time()
        with _exe.dispatch_guard("TrainStep", report=self._state_report):
            if self._device.type == "cuda" and not self._spans_devices():
                losses, bads = self._run_graph(inputs, labels, n_steps)
            else:
                losses, bads = self._run_loop(inputs, labels, n_steps)
        self.optimizer._count_steps(n_steps)
        if _mem._ENABLED:
            self._tag_state()
        if _mon:
            _monitor.count("jit.train_step.steps", n_steps)
            _monitor.observe("jit.train_step.dur", time.time() - t0)
        raise_nonfinite(bads, self._pnames, "train step")
        return losses

    def _spans_devices(self) -> bool:
        devices = {t.device for t in itertools.chain(self._ptensors,
                                                     self._btensors)}
        mesh = get_mesh()
        if mesh is not None:
            devices.update(torch.device(d) for d in mesh.devices.reshape(-1))
        return len(devices) > 1

    def _run_loop(self, inputs, labels, n_steps):
        losses, bads = [], []
        for i in range(n_steps):
            with _obs.step_record(), _exe.booking("train_step"):
                loss, bad = self._one_step([x[i] for x in inputs],
                                           [y[i] for y in labels])
            losses.append(loss)
            bads.append(bad)
        return torch.stack(losses), \
            torch.stack(bads) if self._nan_check else None

    def _state_ptrs(self):
        slots = (v for s in self._slots for v in s.values())
        return tuple(t.data_ptr() for t in itertools.chain(
            self._ptensors, self._btensors, slots,
            (self.optimizer._t_arr, self.optimizer._lr_arr, self._i)))

    def _run_graph(self, inputs, labels, n_steps):
        key = (tuple((tuple(x.shape[1:]), x.dtype) for x in inputs),
               tuple((tuple(y.shape[1:]), y.dtype) for y in labels),
               self.amp_dtype, self._nan_check,
               torch.are_deterministic_algorithms_enabled(),
               self.model.training)
        cap = self._graphs.get(key)
        first = 0
        if cap is None or cap.losses.shape[0] < n_steps or \
                cap.ptrs != self._state_ptrs():
            # drop the stale graph (and its memory pool) before capturing
            self._graphs.pop(key, None)
            cap = None
            with _obs.step_record(), \
                    _exe.booking("train_step") as bk:
                bk.compiled()
                cap = self._capture(inputs, labels, n_steps)
                if _obs._TL_ENABLED:
                    _obs.fence(self._device)
            self._graphs[key] = cap
            if _mem._ENABLED:
                _mem.tag("activations", cap.inputs + cap.labels,
                         origin="TrainStep.run")
            first = 1
        else:
            self._i.zero_()
        tl = _obs._TL_ENABLED
        for i in range(first, n_steps):
            with _obs.step_record():
                with _obs.phase("h2d"):
                    for s, x in zip(cap.inputs, inputs):
                        s.copy_(x[i])
                    for s, y in zip(cap.labels, labels):
                        s.copy_(y[i])
                    if tl:
                        _obs.fence(self._device)
                with _exe.booking("train_step"):
                    cap.graph.replay()
                    if tl:
                        _obs.fence(self._device)
        return cap.losses[:n_steps].clone(), \
            cap.bads[:n_steps].clone() if cap.bads is not None else None

    def _record(self, loss, bad, losses, bads):
        """Write the step's loss (and flags) at the span index; advance it."""
        losses.index_copy_(0, self._i, loss.reshape(1))
        if bads is not None:
            bads.index_copy_(0, self._i, bad.reshape(1, -1))
        self._i.add_(1)

    def _capture(self, inputs, labels, n_steps):
        """Run the span's first step eagerly on a side stream (cuBLAS, the
        autograd engine and the kernels initialise lazily there), then
        capture the step over static input buffers."""
        static_in = [x[0].clone() for x in inputs]
        static_lab = [y[0].clone() for y in labels]
        self._i.zero_()
        main = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            loss, bad = self._one_step(static_in, static_lab)
        main.wait_stream(side)
        losses = torch.empty(n_steps, dtype=loss.dtype, device=self._device)
        bads = torch.empty((n_steps, bad.numel()), dtype=torch.bool,
                           device=self._device) if bad is not None else None
        self._record(loss, bad, losses, bads)
        del loss, bad
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                loss, bad = self._one_step(static_in, static_lab)
                self._record(loss, bad, losses, bads)
        except Exception as e:
            # the warm-up step was taken: count it before raising
            self.optimizer._count_steps(1)
            raise RuntimeError(
                "TrainStep.run: capturing the step in a CUDA graph failed "
                "(a host sync such as .item() or a data-dependent shape in "
                "the model or loss?); the span's first step was taken "
                "eagerly, the rest were not") from e
        return _Captured(graph, static_in, static_lab, losses, bads,
                         self._state_ptrs())

    # ---- cost and memory of one step ----
    def cost_analysis(self, *batch):
        """{"flops", "bytes_accessed"} of one step at `batch`'s signature.

        `flops`: what `torch.utils.flop_counter.FlopCounterMode` counts
        over one eager forward + backward (products, and the flash
        kernels through their registered formulas: 4·BH·S²·D forward,
        10·BH·S²·D fused backward, halved when causal). Elementwise work
        and the update are not counted. `bytes_accessed` is None: torch
        does not count the bytes a step moves. Updates nothing."""
        inputs, labels, _ = self._prepare(batch, note=False)
        with FlopCounterMode(display=False) as counter:
            self._loss_and_grads(inputs, labels)
        return {"flops": float(counter.get_total_flops()),
                "bytes_accessed": None}

    def memory_report(self, *batch):
        """The reference's keys for one step at `batch`'s signature:
        `argument_bytes` (parameters, slots, buffers, the step scalars and
        one step's batch), `output_bytes` (the new parameters and slots,
        the loss), `alias_bytes` (the parameters and slots, updated in
        place where the reference donates them), `generated_code_bytes`
        (0), and on CUDA `temp_bytes` (the peak allocated above the live
        state during one eager forward + backward, gradients included;
        the update's own scratch is not run, since it would change the
        parameters) and `peak_bytes` (`torch.cuda.max_memory_allocated`
        over that forward + backward). On the CPU `temp_bytes` and
        `peak_bytes` are None. Updates nothing."""
        inputs, labels, _ = self._prepare(batch, note=False)
        state = _nbytes(itertools.chain(
            self._ptensors, (v for s in self._slots for v in s.values())))
        scalars = _nbytes(self._scalars())
        args = state + _nbytes(self._btensors) + scalars + \
            _nbytes(inputs + labels)
        report = {"argument_bytes": args, "alias_bytes": state,
                  "generated_code_bytes": 0, "temp_bytes": None,
                  "peak_bytes": None}
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
            base = torch.cuda.memory_allocated(self._device)
            torch.cuda.reset_peak_memory_stats(self._device)
            loss, grads = self._loss_and_grads(inputs, labels)
            torch.cuda.synchronize(self._device)
            peak = torch.cuda.max_memory_allocated(self._device)
            report["temp_bytes"] = peak - base
            report["peak_bytes"] = peak
        else:
            loss, grads = self._loss_and_grads(inputs, labels)
        report["output_bytes"] = state + _nbytes([loss]) + scalars
        del loss, grads
        return report

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
            "t": _host(self._scalars()[1]),
            "step_count": int(self.optimizer._step_count),
        }

    def set_state_dict(self, sd):
        """Copies into the existing parameter, slot and step tensors in
        place, so a captured step reads the new values."""
        if not self._built:
            self._build()
        params = sd["params"]
        with torch.no_grad():
            for n, t in zip(self._pnames, self._ptensors):
                if n in params:
                    t.copy_(torch.as_tensor(np.asarray(params[n])))
            for slots, saved in zip(self._slots, sd["slots"]):
                for k, v in slots.items():
                    v.copy_(torch.as_tensor(np.asarray(saved[k])))
        opt = self.optimizer
        opt._step_count = int(sd["step_count"])
        opt._t_scalar(self._device).fill_(float(sd["t"]))
        opt._t_host = float(sd["t"])
        set_rng_state(sd["rng_key"])


__all__ = ["TrainStep", "raise_nonfinite"]
