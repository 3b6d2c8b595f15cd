"""Pipeline-parallel engine: 1F1B micro-batch pipelining.

Counterpart of `paddle_tpu/parallel/pipeline_parallel.py` (:54-359), with
its semantics:

  - each stage runs the 1F1B sequence of :188-196: min(M, S - s - 1)
    warmup forwards, steady forward/backward pairs, then the drain;
  - the backward recomputes the stage's forward from its saved input
    (:128-146; the forward runs without autograd), so a stage holds one
    boundary tensor per micro-batch in flight (`last_peak_inflight` <=
    the number of stages) and attention runs its forward twice and its
    backward once per micro-batch and layer; the recompute replays the
    forward's random draws (dropout);
  - gradients are summed over the micro-batches and scaled by 1/M, and
    the loss is the mean of the micro-batches' mean losses (:246-249);
  - `ClipGradByGlobalNorm` takes the norm over every stage's gradients,
    then the update runs with the clip off (:279-299); each stage has its
    own optimizer slots.

Two forms, chosen by the hybrid group:

  - single controller (no process world; the reference's design and its
    tests' contract): every stage's parameters live on its slot of the
    mesh's 'pp' axis (`mesh.devices[0, s, 0, 0]`), one worklist merges the
    per-stage sequences as :210-244 do, and activations and gradients
    move between slots with `Tensor.to` (peer copies on several cards).
    A stage's dp and mp run on its first slot: mp_layers compute the dense
    layers there, the numbers of the reference's GSPMD stage programs.
    Interleaved virtual stages (chain chunk c on physical stage c % P) work
    as in the reference, as does a `SharedLayerDesc` over stages, whose
    weight each stage that holds it updates with its own gradient and
    slots, one after the other (the reference's :314-331);
  - process world (pp > 1, one rank per card): each rank holds and runs
    only its stage (`PipelineLayer` builds only that stage), takes its
    rows of every micro-batch along the data axes, and runs its stage's
    sequence in Megatron's pairing: activations and gradients move over
    the pp group with `collective.send_recv`, each steady-state send
    posted together with the receive it waits on (send-forward with
    recv-backward, send-backward with recv-forward; one NCCL group, or
    gloo's isend / irecv), so no two neighbours wait on each other's
    sends. The boundary shapes and dtypes are fixed
    once per input signature by a handshake down the chain (each stage's
    forward run under `FakeTensorMode` from the shape it received). After
    the schedule the gradients are averaged over the data group (one flat
    all-reduce per bucket), the global clip norm is one all-reduce over
    the pp group (and one over mp: an mp-sharded parameter's squares
    summed over mp, a replicated one's counted once), and the last stage's
    loss, averaged over the data group, is broadcast over the pp group.
    Interleaved schedules across processes raise (ROADMAP.md Queue 1,
    "process-form interleave").

Bf16 comes from `amp.auto_cast(dtype="bfloat16")` around `train_batch`, as
in the reference: the amp state is read where each stage runs.
`collective_signature(data)` traces a rank's `train_batch` without running
it (FakeTensorMode, `collective.record_only()`): the (op, axis, shape,
dtype, perm) of every collective and point-to-point call it issues, in
issue order, with no update and no state changed.
"""
from __future__ import annotations

import collections
import contextlib
from typing import List

import numpy as np
import torch

from ..core.place import resolve_device
from ..jit.functional import fake_of, functional_call, split_state
from ..nn.clip import ClipGradByGlobalNorm
from . import collective
from .grad_clip import sharded_clip
from .pp_layers import PipelineLayer
from .topology import get_hybrid_communicate_group

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64, torch.bool, torch.uint8]


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _split(t, m, what):
    if t.shape[0] % m:
        raise ValueError(f"PipelineParallel: {what} batch of {t.shape[0]} "
                         f"rows does not split into {m} micro-batches")
    return list(t.split(t.shape[0] // m, 0))


def _rng_state(device):
    cpu = torch.get_rng_state()
    dev = torch.cuda.get_rng_state(device) if device.type == "cuda" else None
    return cpu, dev


@contextlib.contextmanager
def _replay_rng(device, state):
    """The random draws of the block replay those after `state` was taken;
    the generators are restored after it."""
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.set_rng_state(state[0])
        if state[1] is not None:
            torch.cuda.set_rng_state(state[1], device)
        yield


class PipelineParallel:
    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        self.pipeline_layer = layers
        self.hcg = hcg or get_hybrid_communicate_group()
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.num_phys_stages = layers.num_stages
        self.vpp = getattr(layers, "num_virtual_stages", 1)
        self.num_stages = layers.num_stages * self.vpp
        self.loss_fn = layers.loss_fn
        self.last_peak_inflight = 0
        self._opt_slots = None
        self._placed = False
        h = self.hcg
        self._world = h is not None and getattr(h, "process_mode", False) \
            and h.pp_degree > 1
        if self._world:
            if self.vpp > 1:
                raise NotImplementedError(
                    "PipelineParallel: interleaved virtual stages across "
                    "processes are not ported (ROADMAP.md Queue 1, "
                    "\"process-form interleave\")")
            if h.pp_degree != layers.num_stages:
                raise ValueError(f"PipelineLayer of {layers.num_stages} "
                                 f"stages on a pp degree of {h.pp_degree}")
            self.stage_id = h.get_stage_id()
            self._module = layers.get_stage_module(self.stage_id)
            self._pp = h.get_pipe_parallel_group()
            self._mp = h.get_model_parallel_group()
            self._data = h.get_data_axes_group()
            self._device = self._first_param_device(self._module)
            from .meta_parallel import broadcast_replicas
            broadcast_replicas(self._module, h)
            self._boundaries = {}
            self._reducer = None
        else:
            self.stages = layers.get_stage_modules()
            phys = self._phys_devices()
            self._stage_devices = [phys[layers.chunk_to_stage(c)]
                                   for c in range(self.num_stages)]
            self._stage_meshes = self._stage_devices

    # ---- placement ----
    @staticmethod
    def _first_param_device(mod):
        for p in mod.parameters():
            return p.device
        return resolve_device()

    def _phys_devices(self) -> List[torch.device]:
        """One device per PHYSICAL stage: its first slot of the mesh's pp
        axis (virtual chunks share it)."""
        P = self.num_phys_stages
        if self.hcg is None:
            return [resolve_device()] * P
        devs = self.hcg.get_mesh().devices
        return [devs[(0, s) + (0,) * (devs.ndim - 2)] for s in range(P)]

    def _place_stage_params(self):
        with torch.no_grad():
            for s, mod in enumerate(self.stages):
                dev = self._stage_devices[s]
                for t in list(mod.parameters()) + list(mod.buffers()):
                    if t.device != dev:
                        t.data = t.data.to(dev)
        self._placed = True

    def _stage_params(self, mod):
        trainable, _ = split_state(mod)
        return list(trainable.values())

    # ---- one stage's forward and recomputed backward ----
    def _loss_grad(self, out, labels):
        o = out.detach().requires_grad_()
        with torch.enable_grad():
            loss = self.loss_fn(o, *labels)
        g, = torch.autograd.grad(loss, o)
        return loss.detach(), g

    @staticmethod
    def _call(mod, x, state=None):
        """The stage's forward, with its state bound to `state` when given
        (the fakes of a traced step)."""
        if state is None:
            return mod(x)
        return functional_call(mod, list(state), list(state.values()), [],
                               [], x)

    @classmethod
    def _stage_bwd(cls, mod, params, x, g, rng, device, state=None):
        float_in = x.is_floating_point()
        xin = x.detach().requires_grad_(float_in)
        with torch.enable_grad(), _replay_rng(device, rng):
            out = cls._call(mod, xin, state)
        inputs = params + ([xin] if float_in else [])
        grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
        gp = [torch.zeros_like(p) if d is None else d
              for p, d in zip(params, grads[:len(params)])]
        return gp, (grads[-1] if float_in else None)

    @staticmethod
    def _split_data(data):
        if isinstance(data, (list, tuple)):
            return _as_tensor(data[0]), [_as_tensor(d) for d in data[1:]]
        return _as_tensor(data), []

    # ---- the single controller's schedule ----
    def forward_backward_pipeline(self, data, labels):
        """1F1B schedule with the recomputing backward; returns (mean loss,
        per-stage gradient lists)."""
        if self._world:
            return self._world_pipeline(data, labels)
        if not self._placed:
            self._place_stage_params()
        S, M = self.num_stages, self.accumulate_steps
        micro_x = _split(data, M, "input")
        micro_y = [_split(lab, M, "label") for lab in labels]
        params = [self._stage_params(mod) for mod in self.stages]
        seqs = []
        for s in range(S):
            warm = min(M, S - s - 1)
            seqs.append(["F"] * warm + ["F", "B"] * (M - warm) + ["B"] * warm)
        ptr, fcnt, bcnt = [0] * S, [0] * S, [0] * S
        acts = [dict() for _ in range(S)]    # acts[s][m]: input ready
        gin = [dict() for _ in range(S)]     # gin[s][m]: out-grad ready
        saved = [dict() for _ in range(S)]   # inputs awaiting backward
        grads = [None] * S
        losses = [None] * M
        for m in range(M):
            acts[0][m] = micro_x[m]
        peak, remaining = 0, 2 * S * M
        while remaining:
            progressed = False
            for s in range(S):
                if ptr[s] >= len(seqs[s]):
                    continue
                dev, mod = self._stage_devices[s], self.stages[s]
                if seqs[s][ptr[s]] == "F":
                    m = fcnt[s]
                    if m not in acts[s]:
                        continue        # upstream activation not produced
                    x = acts[s].pop(m).to(dev)
                    rng = _rng_state(dev)
                    saved[s][m] = (x, rng)
                    with torch.no_grad():
                        out = mod(x)
                    if s == S - 1:
                        lab = [y[m].to(dev) for y in micro_y]
                        losses[m], gin[s][m] = self._loss_grad(out, lab)
                    else:
                        acts[s + 1][m] = out
                    fcnt[s] += 1
                else:
                    m = bcnt[s]
                    if m not in gin[s]:
                        continue        # downstream gradient not produced
                    g = gin[s].pop(m).to(dev)
                    x, rng = saved[s].pop(m)
                    gp, gx = self._stage_bwd(mod, params[s], x, g, rng, dev)
                    grads[s] = gp if grads[s] is None else \
                        [a + b for a, b in zip(grads[s], gp)]
                    if s > 0:
                        gin[s - 1][m] = gx
                    bcnt[s] += 1
                ptr[s] += 1
                remaining -= 1
                progressed = True
                peak = max(peak, max(len(d) for d in saved))
            if not progressed:
                raise RuntimeError("pipeline schedule deadlock (bug)")
        self.last_peak_inflight = peak      # <= num_stages by construction
        grads = [[g * (1.0 / M) for g in gs] for gs in grads]
        mean_loss = sum(l.float().mean() for l in losses) / M
        return mean_loss, grads

    # ---- the process world's schedule ----
    def _rows(self, t):
        """This rank's rows of a micro-batch along the data axes."""
        n, r = self._data.nranks, max(self._data.rank, 0)
        if n == 1:
            return t
        if t.shape[0] % n:
            raise ValueError(f"PipelineParallel: a micro-batch of "
                             f"{t.shape[0]} rows does not split over {n} "
                             "data ranks")
        return t.chunk(n, 0)[r]

    def _peer(self, offset):
        g = self._pp
        return g.ranks[g.rank + offset]

    def _fake_state(self, fm):
        """{name: fake} of the stage's parameters and buffers, and the
        fakes of its trainable parameters in `_stage_params` order."""
        mod = self._module
        state = {n: fake_of(fm, t)
                 for n, t in mod.state_dict(keep_vars=True).items()}
        trainable, _ = split_state(mod)
        return state, [state[n] for n in trainable]

    def _boundary(self, x0):
        """(input shape, input dtype, output shape, output dtype) of this
        rank's stage for a micro-batch like `x0`: stage 0 reads the batch,
        every later stage receives its input's from the stage before, runs
        its forward under FakeTensorMode and sends its output's on."""
        from ..amp.state import amp_state
        st = amp_state()
        key = (tuple(x0.shape), x0.dtype, st.enabled, st.dtype)
        if key in self._boundaries:
            return self._boundaries[key]
        s, S = self.stage_id, self.num_stages
        if s == 0:
            in_shape, in_dtype = tuple(x0.shape), x0.dtype
        else:
            meta = torch.zeros(10, dtype=torch.int64)
            collective.recv(meta, src=self._peer(-1), group=self._pp)
            in_shape = tuple(int(d) for d in meta[1:1 + int(meta[0])])
            in_dtype = _DTYPES[int(meta[9])]
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True) as fm, \
                collective.record_only(), torch.no_grad():
            state, _ = self._fake_state(fm)
            out = self._call(self._module, torch.empty(
                in_shape, dtype=in_dtype, device=self._device), state)
        out_shape, out_dtype = tuple(out.shape), out.dtype
        if s < S - 1:
            meta = torch.zeros(10, dtype=torch.int64)
            meta[0] = len(out_shape)
            meta[1:1 + len(out_shape)] = torch.tensor(out_shape)
            meta[9] = _DTYPES.index(out_dtype)
            collective.send(meta, dst=self._peer(1), group=self._pp)
        res = (in_shape, in_dtype, out_shape, out_dtype)
        self._boundaries[key] = res
        return res

    def _world_pipeline(self, data, labels, fm=None):
        """The rank's 1F1B sequence; under FakeTensorMode `fm` (a traced
        step) on fakes of the stage's state."""
        s, S, M = self.stage_id, self.num_stages, self.accumulate_steps
        first, last = s == 0, s == S - 1
        dev, mod = self._device, self._module
        micro_x = [self._rows(x).to(dev) for x in _split(data, M, "input")]
        micro_y = [[self._rows(y).to(dev) for y in _split(lab, M, "label")]
                   for lab in labels]
        in_shape, in_dtype, out_shape, out_dtype = self._boundary(micro_x[0])
        recv_act = (in_shape, {"dtype": in_dtype, "device": dev})
        recv_grad = (out_shape, {"dtype": out_dtype, "device": dev})
        state = None
        if fm is None:
            params = self._stage_params(mod)
        else:
            state, params = self._fake_state(fm)
        grads = None
        losses = []
        saved = collections.deque()
        peak = 0
        nf = [0]
        loss_grads = collections.deque()

        def alloc(spec):
            shape, kw = spec
            return torch.empty(shape, **kw)

        def exchange(send=None, send_to=0, recv=None, recv_from=0):
            """A send and the receive it waits on, posted together."""
            ops, got = [], None
            if send is not None:
                ops.append(("send", send.detach().contiguous(),
                            self._peer(send_to)))
            if recv is not None:
                got = alloc(recv)
                ops.append(("recv", got, self._peer(recv_from)))
            collective.send_recv(ops, group=self._pp)
            return got

        def forward(x):
            nonlocal peak
            m = nf[0]
            nf[0] += 1
            saved.append((x, _rng_state(dev)))
            peak = max(peak, len(saved))
            with torch.no_grad():
                out = self._call(mod, x, state)
            if last:
                loss, g = self._loss_grad(out, [y[m] for y in micro_y])
                losses.append(loss)
                loss_grads.append(g)
                return None
            return out

        def backward(g):
            nonlocal grads
            x, rng = saved.popleft()
            gp, gx = self._stage_bwd(mod, params, x, g, rng, dev, state)
            grads = gp if grads is None else [a + b for a, b in zip(grads,
                                                                    gp)]
            return gx

        def recv_forward():
            if first:
                return micro_x[nf[0]]
            return exchange(recv=recv_act, recv_from=-1)

        warm = min(M, S - s - 1)
        steady = M - warm
        for _ in range(warm):
            out = forward(recv_forward())
            exchange(send=out, send_to=1)
        x = recv_forward() if steady > 0 else None
        for i in range(steady):
            out = forward(x)
            # send-forward paired with recv-backward
            g = loss_grads.popleft() if last else \
                exchange(send=out, send_to=1, recv=recv_grad, recv_from=1)
            gx = backward(g)
            if i == steady - 1:
                if not first:
                    exchange(send=gx, send_to=-1)
            elif first:
                x = micro_x[nf[0]]
            else:
                # send-backward paired with recv-forward
                x = exchange(send=gx, send_to=-1, recv=recv_act,
                             recv_from=-1)
        for _ in range(warm):
            g = exchange(recv=recv_grad, recv_from=1)
            gx = backward(g)
            if not first:
                exchange(send=gx, send_to=-1)
        self.last_peak_inflight = peak
        grads = [g * (1.0 / M) for g in grads]
        if last:
            loss = (sum(l.float().mean() for l in losses) / M).reshape(())
            collective.all_reduce(loss, op=collective.ReduceOp.AVG,
                                  group=self._data)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
        collective.broadcast(loss, src=self._pp.ranks[-1], group=self._pp)
        if self._data.nranks > 1:
            if self._reducer is None:
                from .reducer import Reducer
                self._reducer = Reducer(params, axis=self._data)
            grads = self._reducer.reduce(grads)
        return loss, [grads]

    # ---- the step ----
    def train_batch(self, data, optimizer=None, lr_scheduler=None,
                    scaler=None):
        """One step over `accumulate_steps` micro-batches of `data`
        ([inputs, labels...]): the mean loss (a 0-d f32 tensor; in a
        process world every rank returns the last stage's). With an
        optimizer its update follows, then `lr_scheduler.step()` when one
        is given (the reference takes and drops it)."""
        if scaler is not None:
            raise NotImplementedError(
                "PipelineParallel.train_batch(scaler=...): fp16 loss scaling "
                "in the pipeline is not ported (ROADMAP.md Queue 1, "
                "\"fp16 loss scaling in the pipeline\")")
        x, labels = self._split_data(data)
        loss, grads = self.forward_backward_pipeline(x, labels)
        if optimizer is not None:
            self._update(optimizer, grads)
            if lr_scheduler is not None:
                lr_scheduler.step()
        return loss

    def _stage_ptensors(self):
        mods = [self._module] if self._world else self.stages
        return [self._stage_params(mod) for mod in mods]

    def _update(self, optimizer, grads):
        opt = getattr(optimizer, "_inner_opt", optimizer)
        stage_pts = self._stage_ptensors()
        if self._opt_slots is None:
            self._opt_slots = [opt.init_state(pts) for pts in stage_pts]
        lr, t = opt.get_lr(), float(opt._step_count + 1)
        grads, clip_arg = self._clip(opt, stage_pts, grads)
        for s, pts in enumerate(stage_pts):
            opt.functional_update([p.data for p in pts], grads[s],
                                  self._opt_slots[s], lr, t,
                                  params_meta=pts, grad_clip=clip_arg)
        opt._step_count += 1

    def _clip(self, opt, stage_pts, grads):
        """The clip the update does not do itself: (per-stage gradients,
        the update's grad_clip argument)."""
        clip = getattr(opt, "_grad_clip", None)
        if self._world and clip is not None and not hasattr(clip, "min"):
            # a norm clip: over every stage (pp) and every mp slice
            mp, pp = self._norm_groups()
            return [sharded_clip(clip, grads[0], stage_pts[0], mp,
                                 self._counted(stage_pts[0]), pp)], None
        if isinstance(clip, ClipGradByGlobalNorm):
            # the norm over ALL stages' gradients, then no in-update clip
            sq = 0.0
            for pts, gs in zip(stage_pts, grads):
                parts = [torch.sum(g.float() ** 2) for p, g in zip(pts, gs)
                         if getattr(p, "need_clip", True)]
                if parts:       # one reduce and one host read per stage
                    sq += float(sum(p.to(parts[0].device) for p in parts))
            factor = clip.clip_norm / max(sq ** 0.5, clip.clip_norm)
            if factor < 1.0:
                grads = [[g * factor if getattr(p, "need_clip", True) else g
                          for p, g in zip(pts, gs)]
                         for pts, gs in zip(stage_pts, grads)]
            return grads, None
        return grads, "default"

    def _norm_groups(self):
        """(the groups that sum per-parameter squares: mp; those that sum
        the global total: pp)."""
        return ([g for g in (self._mp,) if g.nranks > 1],
                [g for g in (self._pp,) if g.nranks > 1])

    def _counted(self, pts):
        """Whether this rank's piece of each parameter counts toward a norm:
        an mp slice always, a parameter replicated over mp on mp rank 0."""
        first = self._mp.rank <= 0
        return [getattr(p, "_mp_split", None) is not None or first
                for p in pts]

    def eval_batch(self, data, compute_loss=True):
        x, labels = self._split_data(data)
        if self._world:
            raise NotImplementedError(
                "PipelineParallel.eval_batch across processes: use "
                "train_batch without an optimizer")
        if not self._placed:
            self._place_stage_params()
        with torch.no_grad():
            for s, mod in enumerate(self.stages):
                x = mod(x.to(self._stage_devices[s]))
            if compute_loss and self.loss_fn is not None and labels:
                return self.loss_fn(x, *[lab.to(x.device) for lab in labels])
        return x

    # ---- introspection ----
    def collective_signature(self, data, optimizer=None):
        """The CollectiveDesc sequence (op, axis, shape, dtype, perm) this
        rank's `train_batch(data, optimizer)` issues, in issue order:
        traced under FakeTensorMode with `collective.record_only()`, so
        nothing runs, nothing is sent and no state changes (a process world
        settles its boundary shapes first, once per input signature). Equal
        on the ranks of one stage; the single controller issues none."""
        if not self._world:
            return []
        from torch._subclasses.fake_tensor import FakeTensorMode
        x, labels = self._split_data(data)
        self._boundary(self._rows(_split(x, self.accumulate_steps,
                                         "input")[0]).to(self._device))
        peak = self.last_peak_inflight
        with FakeTensorMode(allow_non_fake_inputs=True) as fm, \
                collective.record_only() as seq:
            fx = fm.from_tensor(x)
            flabs = [fm.from_tensor(lab) for lab in labels]
            _, grads = self._world_pipeline(fx, flabs, fm)
            if optimizer is not None:
                self._clip(getattr(optimizer, "_inner_opt", optimizer),
                           self._stage_ptensors(), grads)
        self.last_peak_inflight = peak
        return list(seq)


__all__ = ["PipelineParallel"]
