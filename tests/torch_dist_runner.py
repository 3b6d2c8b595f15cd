"""The ranks of the port's multi-process parity tests.

Each job runs in every rank of a world started by
`paddle_tpu_torch.parallel.spawn` (or by the launcher, when this file is
run as a script: `torch_dist_runner.py JOB OUTDIR`), on the CPU over gloo.
It reads its inputs from OUTDIR (written by the test), imports only the
port, and writes `<job>_<rank>.npz` (and, for some jobs, a JSON file)
back to OUTDIR for the test to hold against the JAX package.
"""
import json
import os
import sys
import time

import numpy as np

ERNIE_CFG = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=128,
                 hidden_dropout_prob=0.0)
# AdamW's epsilon in the tiny ERNIE runs: the key bias's gradient is zero
# in exact arithmetic (the softmax ignores a shift of every score of a
# row), so both packages hold rounding noise there, and Adam scales noise
# up by 1/(|noise| + epsilon); 1e-5 keeps three such steps below 1e-5
ERNIE_EPS = 1e-5


def _setup():
    """The port, on the CPU when the ranks were started for it
    (`device="cpu"`), else on the rank's card with TF32 off."""
    import torch
    import paddle_tpu_torch as pt
    if os.environ.get("PADDLE_DISTRI_DEVICE") == "cpu":
        pt.set_device("cpu")
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return pt


def _np(t):
    return t.detach().float().cpu().numpy()


def mlp(pt, classes=4):
    """tests/test_parallel.py's MLP on the port's layers (`classes`
    outputs; 4 there)."""
    nn = pt.nn

    class MLP(nn.Layer):
        def __init__(self, d=16):
            super().__init__()
            self.fc1 = nn.Linear(d, 4 * d)
            self.fc2 = nn.Linear(4 * d, d)
            self.act = nn.GELU()
            self.head = nn.Linear(d, classes)

        def forward(self, x):
            return self.head(self.fc2(self.act(self.fc1(x))))

    return MLP()


def ernie_loss(pt):
    ce = pt.nn.CrossEntropyLoss()

    def loss_fn(logits, nsp_logits, ids, nsp):
        v = logits.shape[-1]
        return ce(logits.reshape(-1, v), ids.reshape(-1)) + ce(nsp_logits, nsp)

    return loss_fn


def _load(pt, model, path):
    from paddle_tpu_torch.utils import load_numpy_state
    with np.load(path) as z:
        load_numpy_state(model, {k: z[k] for k in z.files})
    return model


def _params(model):
    return {k: _np(v).copy() for k, v in model.state_dict().items()}


def _save(outdir, job, rank, **arrays):
    np.savez(os.path.join(outdir, f"{job}_{rank}.npz"), **arrays)


def job_collectives(outdir):
    """Every collective of parallel.collective on rank r's row of the
    seeded global input (see test_torch_collective.py), on the rank's
    device."""
    pt = _setup()
    import torch
    from paddle_tpu_torch import distributed as dist
    pt.set_flags({"FLAGS_monitor": True})
    dist.init_parallel_env()
    r, n = dist.get_rank(), dist.get_world_size()
    dev = dist.ParallelEnv().device
    with np.load(os.path.join(outdir, "coll_in.npz")) as z:
        x = z["x"]
        common = z["common"]

    def mine():
        return torch.from_numpy(x[r].copy()).to(dev)

    out = {}
    for name, op in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX),
                     ("min", dist.ReduceOp.MIN), ("prod", dist.ReduceOp.PROD),
                     ("avg", dist.ReduceOp.AVG)):
        t = mine()
        got = dist.all_reduce(t, op=op)
        assert got is t
        out[f"all_reduce_{name}"] = _np(t)
    t = mine()
    task = dist.all_reduce(t, sync_op=False)
    task.wait()
    out["all_reduce_async"] = _np(t)
    b = mine().to(torch.bfloat16)
    dist.all_reduce(b)
    out["all_reduce_bf16"] = _np(b)
    parts = []
    out["all_gather"] = _np(dist.all_gather(parts, mine()))
    out["all_gather_list"] = np.stack([_np(p) for p in parts])
    out["all_gather_axis1"] = _np(dist.all_gather(None, mine(), axis=1))
    out["reduce_scatter"] = _np(dist.reduce_scatter(None, mine()))
    buf = torch.empty(x.shape[1] // n, device=dev)
    dist.reduce_scatter(buf, list(mine().chunk(n)))
    out["reduce_scatter_list"] = _np(buf)
    for src in (0, n - 1):
        t = mine()
        dist.broadcast(t, src=src)
        out[f"broadcast_{src}"] = _np(t)
    t = mine()
    dist.reduce(t, dst=0)
    out["reduce"] = _np(t)
    t = torch.empty(common.shape[1:], dtype=torch.float32, device=dev)
    dist.scatter(t, [torch.from_numpy(c.copy()).to(dev) for c in common],
                 src=0)
    out["scatter"] = _np(t)
    outs = []
    out["alltoall"] = _np(dist.alltoall(list(mine().reshape(n, -1)), outs))
    out["alltoall_list"] = np.stack([_np(o) for o in outs])
    out["alltoall_single"] = _np(dist.alltoall_single(mine()))
    if n > 1:                            # no rank sends to itself
        t = mine()
        task = dist.isend(t, dst=(r + 1) % n)
        got = torch.empty_like(t)
        dist.recv(got, src=(r - 1) % n)
        task.wait()
        out["send_recv"] = _np(got)
    out["p2p_shift_1"] = _np(dist.p2p_shift(mine(), group=None))
    out["p2p_shift_2"] = _np(dist.p2p_shift(mine(), group=None, shift=2))
    objs = dist.all_gather_object([], {"rank": r, "tag": "x" * r})
    assert objs == [{"rank": i, "tag": "x" * i} for i in range(n)], objs
    dist.barrier()
    dist.wait(t)
    if n >= 4:
        g = dist.new_group([0, 2])
        t = mine()
        if r in (0, 2):
            dist.all_reduce(t, group=g)
        out["new_group_sum"] = _np(t)
        assert (g.rank, g.nranks) == ((0 if r == 0 else 1 if r == 2 else -1),
                                      2)
    assert dist.get_group(0).nranks == n
    out["backend"] = np.array(dist.get_backend())
    out["device"] = np.array(str(dev))
    counters = pt.monitor.snapshot()["counters"]
    out["counters"] = np.array(json.dumps(
        {k: v for k, v in counters.items() if k.startswith("collective.")}))
    _save(outdir, "collectives", r, **out)


def job_reducer(outdir):
    """The Reducer's reduce() on rank r's gradients; the eager
    DataParallel loop against SPMDTrainStep on the same data, with the
    monitor and the flight recorder on; an unused parameter."""
    pt = _setup()
    import torch
    from paddle_tpu_torch import distributed as dist, obs
    from paddle_tpu_torch.parallel import (DataParallel, HybridCommunicateGroup,
                                           Reducer, SPMDTrainStep, fleet)
    fleet.init(is_collective=True)
    r, n = dist.get_rank(), dist.get_world_size()
    with np.load(os.path.join(outdir, "red_in.npz")) as z:
        shapes = json.loads(str(z["shapes"]))
        grads = [z[f"g{i}"][r] for i in range(len(shapes))]
        x, y = z["x"], z["y"]
        bucket_bytes = int(z["bucket_bytes"])
    red = Reducer([np.zeros(s, np.float32) for s in shapes],
                  bucket_bytes=bucket_bytes)
    reduced = red.reduce([torch.from_numpy(g.copy()) for g in grads])
    out = {f"reduced{i}": g.numpy() for i, g in enumerate(reduced)}
    out["layout"] = np.array(json.dumps(red.bucket_layout()))

    # eager DataParallel: each rank's rows, backward(), the hooks, step()
    rows = x.shape[0] // n
    xb = torch.from_numpy(x[r * rows:(r + 1) * rows].copy())
    yb = torch.from_numpy(y[r * rows:(r + 1) * rows].copy())
    ce = pt.nn.CrossEntropyLoss()
    net = _load(pt, mlp(pt), os.path.join(outdir, "mlp_init.npz"))
    model = DataParallel(net)
    opt = pt.optimizer.Adam(parameters=model.parameters(),
                            learning_rate=1e-2)
    eager = []
    for _ in range(3):
        loss = ce(model(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(float(loss))
    out["eager_params"] = np.array(json.dumps(
        {k: v.tolist() for k, v in _params(net).items()}))
    out["eager_local_losses"] = np.array(eager)

    pt.set_flags({"FLAGS_monitor": True, "FLAGS_obs_flight_recorder": True,
                  "FLAGS_obs_timeline": True})
    pt.monitor.reset()
    obs.reset()
    net2 = _load(pt, mlp(pt), os.path.join(outdir, "mlp_init.npz"))
    hcg = HybridCommunicateGroup(hybrid_configs={"dp_degree": n})
    opt2 = pt.optimizer.Adam(parameters=net2.parameters(), learning_rate=1e-2)
    step = SPMDTrainStep(net2, ce, opt2, mesh=hcg.get_mesh(),
                         grad_reduction="bucketed", bucket_bytes=1024)
    spmd = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
            for _ in range(3)]
    out["spmd_losses"] = np.array(spmd)
    out["spmd_params"] = np.array(json.dumps(
        {k: v.tolist() for k, v in _params(net2).items()}))
    counters = pt.monitor.snapshot()["counters"]
    out["n_buckets"] = np.array(len(step.reducer.bucket_layout()))
    out["bucket_count"] = np.array(
        counters.get("collective.c_allreduce_bucket.count", 0))
    out["signature"] = np.array(json.dumps(step.last_step_collectives()))
    out["phases"] = np.array(json.dumps(
        [sorted(rec["phases"]) for rec in obs.timeline().records()]))
    obs.dump(os.path.join(outdir, f"fr_{r}.json"), reason="test")
    pt.set_flags({"FLAGS_monitor": False, "FLAGS_obs_flight_recorder": False,
                  "FLAGS_obs_timeline": False})

    # a parameter that gets no gradient
    class Two(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.used = pt.nn.Linear(4, 4)
            self.unused = pt.nn.Linear(4, 4)

        def forward(self, v):
            return self.used(v)

    raised = ""
    try:
        DataParallel(Two())(torch.ones(2, 4)).sum().backward()
    except RuntimeError as e:
        raised = str(e)
    out["unused_raised"] = np.array(raised)
    m = Two()
    DataParallel(m, find_unused_parameters=True)(torch.ones(2, 4)) \
        .sum().backward()
    out["unused_grad"] = m.unused.weight.grad.numpy()
    _save(outdir, "reducer", r, **out)


def _spmd_run(pt, outdir, cfg, stage, reduction, steps, tag, out):
    import torch
    from paddle_tpu_torch.parallel import HybridCommunicateGroup, SPMDTrainStep
    hcg = HybridCommunicateGroup(hybrid_configs=cfg)
    net = _load(pt, mlp(pt), os.path.join(outdir, "mlp_init.npz"))
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=1e-2)
    step = SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt,
                         mesh=hcg.get_mesh(), sharding_stage=stage,
                         grad_reduction=reduction, donate=False)
    with np.load(os.path.join(outdir, "mlp_data.npz")) as z:
        x, y = torch.from_numpy(z["x"]), torch.from_numpy(z["y"])
    out[f"{tag}_losses"] = np.array([float(step(x, y)) for _ in range(steps)])
    sd = step.state_dict()
    for k, v in sd["params"].items():
        out[f"{tag}_p_{k}"] = v
    out[f"{tag}_slot_bytes"] = np.array(step.memory_report(x, y)["slot_bytes"])
    out[f"{tag}_signature"] = np.array(json.dumps(
        step.last_step_collectives()))
    if stage == 3:
        out[f"{tag}_freed"] = np.array(all(
            net.state_dict()[k].numel() == 0 for k in ("fc1.weight",
                                                       "fc2.weight")))
        step.unshard()
        out[f"{tag}_unsharded"] = net.fc1.weight.detach().numpy()
        out[f"{tag}_after_unshard"] = np.array(float(step(x, y)))
    return step


def job_spmd(outdir):
    """tests/test_parallel.py's MLP through SPMDTrainStep: dp over the
    world (gspmd and bucketed) and sharding stages 1-3."""
    pt = _setup()
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env()
    r, n = dist.get_rank(), dist.get_world_size()
    out = {}
    _spmd_run(pt, outdir, {"dp_degree": n}, 0, "gspmd", 8, "dp", out)
    _spmd_run(pt, outdir, {"dp_degree": n}, 0, "bucketed", 8, "dpb", out)
    for stage in (1, 2, 3):
        _spmd_run(pt, outdir, {"sharding_degree": n}, stage, "gspmd", 8,
                  f"z{stage}", out)
    z1 = _spmd_run(pt, outdir, {"dp_degree": 2, "sharding_degree": n // 2},
                   1, "gspmd", 4, "hyb1", out)
    _spmd_run(pt, outdir, {"dp_degree": 2, "sharding_degree": n // 2}, 2,
              "gspmd", 8, "hyb", out)
    import torch
    from paddle_tpu_torch.parallel import SPMDTrainStep
    with np.load(os.path.join(outdir, "mlp_data.npz")) as z:
        x, y = torch.from_numpy(z["x"]), torch.from_numpy(z["y"])
    # a stage-1 state resumed by a stage-3 step from its state dict
    sd = z1.state_dict()
    net = mlp(pt)
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=1e-2)
    z3 = SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt, mesh=z1.mesh,
                       sharding_stage=3)
    z3.set_state_dict(sd)
    out["resume"] = np.array([float(z1(x, y)), float(z3(x, y))])
    # the whole state, gathered from stage 3's slices, written by rank 0
    from paddle_tpu_torch.parallel import save_group_sharded_model
    save_group_sharded_model(net, os.path.join(outdir, "z3"), opt, step=z3)
    dist.barrier()
    saved = pt.load(os.path.join(outdir, "z3.pdparams"))
    out["saved_fc1"] = _np(torch.as_tensor(np.asarray(saved["fc1.weight"])))
    out["saved_fc1_now"] = z3.state_dict()["params"]["fc1.weight"]
    # FLAGS_check_nan_inf: every rank raises on a non-finite input
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        step = _spmd_run(pt, outdir, {"sharding_degree": n}, 2, "gspmd", 1,
                         "nan", {})
        bad = x.clone()
        bad[0, 0] = float("nan")
        try:
            step(bad, y)
            out["nan_raised"] = np.array("")
        except FloatingPointError as e:
            out["nan_raised"] = np.array(str(e))
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    _save(outdir, "spmd", r, **out)


def job_ernie(outdir):
    """A tiny ErnieForPretraining with dp over the world, 3 fp32 steps."""
    pt = _setup()
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import (DistributedStrategy, SPMDTrainStep,
                                           fleet)
    strategy = DistributedStrategy()
    strategy.hybrid_configs["dp_degree"] = int(os.environ[
        "PADDLE_TRAINERS_NUM"])
    hcg = fleet.init(is_collective=True, strategy=strategy)
    r = dist.get_rank()
    dev = dist.ParallelEnv().device
    with np.load(os.path.join(outdir, "ernie_data.npz")) as z:
        ids = torch.from_numpy(z["ids"]).to(dev)
        nsp = torch.from_numpy(z["nsp"]).to(dev)
    out = {}
    for reduction in ("bucketed", "gspmd"):
        net = _load(pt, pt.models.ErnieForPretraining(
            pt.models.ErnieModel(**ERNIE_CFG)),
            os.path.join(outdir, "ernie_init.npz"))
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
            parameters=net.parameters(), learning_rate=1e-3, epsilon=ERNIE_EPS))
        step = SPMDTrainStep(model, ernie_loss(pt), opt,
                             mesh=hcg.get_mesh(), n_model_inputs=1,
                             grad_reduction=reduction)
        # the step reduces the gradients: the wrapper's hooks came off
        out[f"{reduction}_wrapper_hooks"] = np.array(
            len(model.reducer._handles))
        out[f"{reduction}_losses"] = np.array(
            [float(step(ids, ids, nsp)) for _ in range(3)])
        out[f"{reduction}_device"] = np.array(
            str(next(net.parameters()).device))
        for k, v in _params(net).items():
            out[f"{reduction}_p_{k}"] = v
    _save(outdir, "ernie", r, **out)


def job_env(outdir):
    """The launcher's environment, the rank's view and its hybrid
    coordinates."""
    pt = _setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import DistributedStrategy, fleet
    env = dist.ParallelEnv()
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_RANK_IN_NODE",
            "PADDLE_CURRENT_ENDPOINT", "PADDLE_TRAINER_ENDPOINTS",
            "PADDLE_DISTRI_BACKEND", "PADDLE_DISTRI_DEVICE",
            "FLAGS_selected_gpus")
    strategy = DistributedStrategy()
    n = int(os.environ["PADDLE_TRAINERS_NUM"])
    strategy.hybrid_configs.update(dp_degree=2, sharding_degree=n // 2)
    hcg = fleet.init(is_collective=True, strategy=strategy)
    import torch
    t = torch.ones(1) * (dist.get_rank() + 1)
    dist.all_reduce(t, group=hcg.get_data_parallel_group())
    s = torch.ones(1) * (dist.get_rank() + 1)
    dist.all_reduce(s, group=hcg.get_sharding_parallel_group())
    rec = {"env": {k: os.environ.get(k) for k in keys},
           "rank": dist.get_rank(), "world": dist.get_world_size(),
           "local_rank": env.local_rank, "device": str(env.device),
           "backend": dist.get_backend(),
           "dp_rank": hcg.get_data_parallel_rank(),
           "sharding_rank": hcg.get_sharding_parallel_rank(),
           "dp_ranks": hcg.get_data_parallel_group().ranks,
           "sharding_ranks": hcg.get_sharding_parallel_group().ranks,
           "dp_sum": float(t), "sharding_sum": float(s),
           "first": fleet.is_first_worker(), "index": fleet.worker_index()}
    with open(os.path.join(outdir, f"env_{dist.get_rank()}.json"), "w") as f:
        json.dump(rec, f)


def job_fail(outdir):
    """Rank 1 raises; the others wait in a barrier it never reaches."""
    _setup()
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env()
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def job_hang(outdir):
    """Every rank sleeps past any test's timeout."""
    time.sleep(600)


# ---- tensor and pipeline parallelism (tests/test_torch_mp_world.py,
# test_torch_zero_repairs.py, test_torch_pp_world.py) ----
def mlp_mp(pt, d=16, hidden=None):
    """tests/test_parallel.py's MLP(use_mp=True) on the port's layers."""
    from paddle_tpu_torch.parallel import (ColumnParallelLinear,
                                           RowParallelLinear)
    nn = pt.nn
    hidden = hidden or 4 * d

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = ColumnParallelLinear(d, hidden, gather_output=False)
            self.fc2 = RowParallelLinear(hidden, d, input_is_parallel=True)
            self.act = nn.GELU()
            self.head = nn.Linear(d, 4)

        def forward(self, x):
            return self.head(self.fc2(self.act(self.fc1(x))))

    return MLP()


def _whole_grads(model):
    """{name: the whole gradient}, mp slices gathered over their group."""
    from paddle_tpu_torch.parallel.mp_layers import gather_whole
    out = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else p.detach() * 0
        split = getattr(p, "_mp_split", None)
        out[n] = _np(gather_whole(g, split) if split is not None else g)
    return out


def _descs(seq):
    return [[d.op, d.axis, list(d.shape), d.dtype,
             None if d.perm is None else [list(x) if isinstance(x, tuple)
                                          else x for x in d.perm]]
            for d in seq]


def job_mp(outdir):
    """mp = 4: each mp layer against the dense reference layer, the
    models with use_mp, SPMDTrainStep over mp, its collective signature
    and a rank whose sequence diverges."""
    pt = _setup()
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import (
        ColumnParallelLinear, HybridCommunicateGroup, ParallelCrossEntropy,
        RowParallelLinear, SPMDTrainStep, VocabParallelEmbedding, collective)
    dist.init_parallel_env()
    r = dist.get_rank()
    hcg = HybridCommunicateGroup(hybrid_configs={"mp_degree": 4})
    z = dict(np.load(os.path.join(outdir, "mp_in.npz")))
    out = {"mp_rank": np.array(hcg.get_model_parallel_rank())}

    def run(tag, layer, x, g, x_parallel=False, out_parallel=False):
        layer.set_state_dict({k[len(tag) + 1:]: v for k, v in z.items()
                              if k.startswith(tag + ".")})
        xt = torch.from_numpy(x).requires_grad_()
        xin = xt.chunk(4, -1)[r] if x_parallel else xt
        y = layer(xin)
        gt = torch.from_numpy(g)
        if out_parallel:
            gt = gt.chunk(4, -1)[r]
        (y * gt).sum().backward()
        out[f"{tag}_out"] = _np(y)
        out[f"{tag}_dx"] = _np(xt.grad)
        for k, v in _whole_grads(layer).items():
            out[f"{tag}_g_{k}"] = v
        out[f"{tag}_shapes"] = np.array(json.dumps(
            {k: list(p.shape) for k, p in layer.named_parameters()}))
        out[f"{tag}_state"] = np.array(json.dumps(
            {k: list(v.shape) for k, v in layer.state_dict().items()}))

    x16, x32 = z["x16"], z["x32"]
    run("col_g", ColumnParallelLinear(16, 32, gather_output=True), x16,
        z["g32"])
    run("col_s", ColumnParallelLinear(16, 32, gather_output=False), x16,
        z["g32"], out_parallel=True)
    run("row_s", RowParallelLinear(32, 16, input_is_parallel=False), x32,
        z["g16"])
    run("row_p", RowParallelLinear(32, 16, input_is_parallel=True), x32,
        z["g16"], x_parallel=True)
    emb = VocabParallelEmbedding(16, 8)
    emb.set_state_dict({"weight": z["emb.weight"]})
    ids = torch.from_numpy(z["ids"])
    e = emb(ids)
    (e * torch.from_numpy(z["g_emb"])).sum().backward()
    out["emb_out"] = _np(e)
    out["emb_g_weight"] = _whole_grads(emb)["weight"]
    logits = torch.from_numpy(z["logits"]).requires_grad_()
    ce = ParallelCrossEntropy()(logits.chunk(4, -1)[r],
                                torch.from_numpy(z["labels"]))
    ce.sum().backward()
    out["ce_out"] = _np(ce)
    out["ce_dlogits"] = _np(logits.grad)

    # the models with use_mp, the whole state loaded by name
    for tag, make in (
            ("gpt", lambda: pt.models.GPTForCausalLM(pt.models.GPTModel(
                **json.loads(str(z["gpt_cfg"])), use_mp=True))),
            ("ernie", lambda: pt.models.ErnieModel(
                **json.loads(str(z["ernie_cfg"])), use_mp=True))):
        net = make()
        state = {k[len(tag) + 1:]: v for k, v in z.items()
                 if k.startswith(tag + ".")}
        _, unexpected = net.set_state_dict(state)
        assert not unexpected, unexpected
        tok = torch.from_numpy(z["tok"])
        if tag == "gpt":
            crit = pt.models.GPTPretrainingCriterion(use_parallel_ce=True)
            logits = net(tok)
            loss = crit(logits, tok)
            loss.backward()
            out["gpt_loss"] = _np(loss)
            out["gpt_local_vocab"] = np.array(logits.shape[-1])
            for k, v in _whole_grads(net).items():
                out[f"gpt_g_{k}"] = v
        else:
            seq, pooled = net(tok)
            out["ernie_seq"] = _np(seq)
            out["ernie_pooled"] = _np(pooled)
        whole = net.state_dict()
        out[f"{tag}_roundtrip"] = np.array(all(
            np.array_equal(_np(whole[k]), state[k]) for k in state))

    # SPMDTrainStep over mp = 4 (tests/test_parallel.py:81-84, :99-112)
    with np.load(os.path.join(outdir, "mlp_data.npz")) as d:
        x, y = torch.from_numpy(d["x"]), torch.from_numpy(d["y"])
    init = dict(np.load(os.path.join(outdir, "mlp_mp_init.npz")))
    net = mlp_mp(pt)
    net.set_state_dict(init)
    out["fc1_shard"] = np.array(list(net.fc1.weight.shape))
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=1e-2)
    step = SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt,
                         mesh=hcg.get_mesh(), donate=False)
    before = {k: _np(v).copy() for k, v in net.state_dict().items()}
    sig = step.collective_signature(x, y)
    after = {k: _np(v) for k, v in net.state_dict().items()}
    out["sig_unchanged"] = np.array(
        all(np.array_equal(before[k], after[k]) for k in before)
        and opt._step_count == 0)
    out["signature"] = np.array(json.dumps(_descs(sig)))
    with collective.trace() as issued:
        first = float(step(x, y))
    out["issued"] = np.array(json.dumps(_descs(issued)))
    out["spmd_losses"] = np.array(
        [first] + [float(step(x, y)) for _ in range(7)])
    for k, v in net.state_dict().items():
        out[f"spmd_p_{k}"] = _np(v)
    # norm clips over mp slices: one SGD step each, whose update is the
    # clipped gradient (fc2's bias and the head stay whole over mp)
    for clip in ("none", "global", "norm"):
        net = mlp_mp(pt)
        net.set_state_dict(init)
        c = {"none": None, "global": pt.nn.ClipGradByGlobalNorm(0.05),
             "norm": pt.nn.ClipGradByNorm(0.05)}[clip]
        opt = pt.optimizer.SGD(parameters=net.parameters(), learning_rate=0.5,
                               grad_clip=c)
        SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt,
                      mesh=hcg.get_mesh())(x, y)
        for k, v in net.state_dict().items():
            out[f"clip_{clip}_p1_{k}"] = _np(v)
    # rank 3 builds a wider hidden layer: its sequence diverges
    pt.seed(1)
    other = mlp_mp(pt, hidden=128 if r == 3 else 64)
    opt2 = pt.optimizer.Adam(parameters=other.parameters())
    step2 = SPMDTrainStep(other, pt.nn.CrossEntropyLoss(), opt2,
                          mesh=hcg.get_mesh())
    seqs = dist.all_gather_object([], _descs(step2.collective_signature(
        x, y)))
    out["diverged"] = np.array(json.dumps(seqs))
    _save(outdir, "mp", r, **out)


def _zero_net(pt, cfg, tied):
    if tied:
        return pt.models.ErnieForPretraining(pt.models.ErnieModel(**cfg))
    return pt.models.ErnieModel(**cfg)


def _zero_loss(pt, tied):
    if tied:
        return ernie_loss(pt)

    def loss_fn(seq, pooled, target):
        return ((pooled - target) ** 2).mean() + (seq ** 2).mean()
    return loss_fn


def job_zero(outdir):
    """dp 2 x sharding 2: norm clips at ZeRO-2/3 against the reference and
    against the clip of the whole gradients; ZeRO-3 by units against
    stage 1 (sharding 2 x pp 2: two-way sums); collective signatures
    before any step."""
    pt = _setup()
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import (HybridCommunicateGroup,
                                           SPMDTrainStep, collective)
    dist.init_parallel_env()
    r = dist.get_rank()
    out = {}
    with np.load(os.path.join(outdir, "mlp_data.npz")) as d:
        x, y = torch.from_numpy(d["x"]), torch.from_numpy(d["y"])
        lr = float(d["clip_lr"])
    hyb = HybridCommunicateGroup(hybrid_configs={"dp_degree": 2,
                                                 "sharding_degree": 2})
    # SGD: its update is the clipped gradient itself. The MLP's head has
    # 5 outputs, so its bias stays whole (replicated) over sharding 2.
    for stage, clip in ((1, "none"), (1, "global"), (1, "norm"),
                        (2, "global"), (2, "norm"), (3, "global"),
                        (3, "norm")):
        net = _load(pt, mlp(pt, classes=5),
                    os.path.join(outdir, "clip_init.npz"))
        c = {"none": None, "global": pt.nn.ClipGradByGlobalNorm(0.05),
             "norm": pt.nn.ClipGradByNorm(0.05)}[clip]
        opt = pt.optimizer.SGD(parameters=net.parameters(),
                               learning_rate=lr, grad_clip=c)
        step = SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt,
                             mesh=hyb.get_mesh(), sharding_stage=stage)
        tag = f"clip_{clip}_{stage}"
        losses = [float(step(x, y))]
        for k, v in step.state_dict()["params"].items():
            out[f"{tag}_p1_{k}"] = v
        losses += [float(step(x, y)) for _ in range(3)]
        out[tag] = np.array(losses)
        for k, v in step.state_dict()["params"].items():
            out[f"{tag}_p_{k}"] = v
        out[f"{tag}_replicated"] = np.array(json.dumps(
            [step._pnames[i] for i in step._replicated]))

    # ZeRO-3 by units against stage 1, from one state: the data group is
    # the two sharding ranks (the pp ranks replicate), whose two-way sums
    # are exact in both
    hz = HybridCommunicateGroup(hybrid_configs={"sharding_degree": 2,
                                                "pp_degree": 2})
    cfg = json.loads(str(np.load(os.path.join(outdir, "zero_in.npz"))["cfg"]))
    with np.load(os.path.join(outdir, "zero_in.npz")) as d:
        ids, target = torch.from_numpy(d["ids"]), torch.from_numpy(d["target"])
        nsp = torch.from_numpy(d["nsp"])
    for tied, amp in ((False, None), (True, None), (True, "bfloat16")):
        res = {}
        for stage in (3, 1):
            pt.seed(3)
            net = _zero_net(pt, cfg, tied)
            opt = pt.optimizer.AdamW(parameters=net.parameters(),
                                     learning_rate=1e-3)
            step = SPMDTrainStep(net, _zero_loss(pt, tied), opt,
                                 mesh=hz.get_mesh(), sharding_stage=stage,
                                 n_model_inputs=1, amp_dtype=amp)
            batch = (ids, ids, nsp) if tied else (ids, target)
            losses = [float(step(*batch)) for _ in range(3)]
            res[stage] = (losses, step.state_dict()["params"], step)
        tag = ("tied" if tied else "untied") + ("_bf16" if amp else "")
        (lu, pu, su), (lw, pw, _) = res[3], res[1]
        out[f"{tag}_losses"] = np.array([lu, lw])
        out[f"{tag}_max_diff"] = np.array(max(
            float(np.abs(pu[k] - pw[k]).max()) for k in pu))
        out[f"{tag}_bit_equal"] = np.array(
            lu == lw and all(np.array_equal(pu[k], pw[k]) for k in pu))
        units = su._units
        out[f"{tag}_peak"] = np.array(su.last_peak_gathered_bytes)
        out[f"{tag}_unit_bytes"] = np.array(json.dumps(
            {str(g): b for g, b in units.unit_bytes.items()}))
        out[f"{tag}_pinned"] = np.array(json.dumps(sorted(
            su._pnames[i] for i in units.pinned)))

    # signatures before any step: dp (bucketed), ZeRO 1-3
    cases = [("dpb", {"dp_degree": 4}, 0, "bucketed"),
             ("z1", {"sharding_degree": 4}, 1, "gspmd"),
             ("z2", {"dp_degree": 2, "sharding_degree": 2}, 2, "gspmd"),
             ("z3", {"sharding_degree": 4}, 3, "gspmd")]
    for tag, cfg_, stage, red in cases:
        h = HybridCommunicateGroup(hybrid_configs=cfg_)
        net = _load(pt, mlp(pt), os.path.join(outdir, "mlp_init.npz"))
        opt = pt.optimizer.Adam(parameters=net.parameters(),
                                learning_rate=1e-2,
                                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        step = SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt,
                             mesh=h.get_mesh(), sharding_stage=stage,
                             grad_reduction=red)
        before = {k: _np(v).copy() for k, v in net.state_dict().items()}
        sig = step.collective_signature(x, y)
        shards = {i: _np(t).copy() for i, t in step._shards.items()}
        slots = [{k: _np(v).copy() for k, v in s.items()}
                 for s in step._slots]
        sig2 = step.collective_signature(x, y)
        unchanged = opt._step_count == 0 and sig == sig2 and all(
            np.array_equal(_np(step._shards[i]), v)
            for i, v in shards.items()) and all(
            np.array_equal(_np(s[k]), v) for s, d in zip(step._slots, slots)
            for k, v in d.items())
        if stage < 3:
            unchanged = unchanged and all(
                np.array_equal(_np(v), before[k])
                for k, v in net.state_dict().items())
        with collective.trace() as issued:
            step(x, y)
        out[f"{tag}_unchanged"] = np.array(unchanged)
        out[f"{tag}_signature"] = np.array(json.dumps(_descs(sig)))
        out[f"{tag}_issued"] = np.array(json.dumps(_descs(issued)))
    _save(outdir, "zero", r, **out)


def job_hybrid(outdir):
    """dp 2 x mp 2 x sharding 2, ZeRO-1, 8 Adam steps (tests/
    test_parallel.py:95-98)."""
    pt = _setup()
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import HybridCommunicateGroup, SPMDTrainStep
    dist.init_parallel_env()
    r = dist.get_rank()
    hcg = HybridCommunicateGroup(hybrid_configs={
        "dp_degree": 2, "mp_degree": 2, "sharding_degree": 2})
    with np.load(os.path.join(outdir, "mlp_data.npz")) as d:
        x, y = torch.from_numpy(d["x"]), torch.from_numpy(d["y"])
    net = mlp_mp(pt)
    net.set_state_dict(dict(np.load(os.path.join(outdir,
                                                  "mlp_mp_init.npz"))))
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=1e-2)
    step = SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt,
                         mesh=hcg.get_mesh(), sharding_stage=1, donate=False)
    out = {"losses": np.array([float(step(x, y)) for _ in range(8)]),
           "coord": np.array(list(hcg._coord))}
    for k, v in net.state_dict().items():
        out[f"p_{k}"] = _np(v)
    _save(outdir, "hybrid", r, **out)


def _pp_run(pt, outdir, cfg, tag, out):
    """A tiny gpt_pipeline_layer through fleet: init -> distributed_model
    -> distributed_optimizer -> 3 SGD train_batch steps with a global-norm
    clip, from the reference's state."""
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import (DistributedStrategy,
                                           PipelineParallel, collective,
                                           fleet)
    z = dict(np.load(os.path.join(outdir, "pp_in.npz")))
    model_cfg = json.loads(str(z["cfg"]))
    st = DistributedStrategy()
    st.hybrid_configs.update(cfg)
    st.pipeline_configs["accumulate_steps"] = int(z["micro"])
    hcg = fleet.init(is_collective=True, strategy=st)
    pl = pt.models.gpt_pipeline_layer(
        num_stages=cfg["pp_degree"], use_mp=cfg.get("mp_degree", 1) > 1,
        **model_cfg)
    engine = fleet.distributed_model(pl)
    assert isinstance(engine, PipelineParallel)
    _, unexpected = pl.set_state_dict({k: v for k, v in z.items()
                                       if k[0].isdigit()})
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        parameters=pl.parameters(), learning_rate=float(z["lr"]),
        grad_clip=pt.nn.ClipGradByGlobalNorm(float(z["clip"]))))
    ids = torch.from_numpy(z["ids"])
    sig = engine.collective_signature([ids, ids], opt)
    with collective.trace() as issued:
        first = float(engine.train_batch([ids, ids], opt))
    losses = [first] + [float(engine.train_batch([ids, ids], opt))
                        for _ in range(2)]
    out[f"{tag}_losses"] = np.array(losses)
    out[f"{tag}_stage"] = np.array(hcg.get_stage_id())
    out[f"{tag}_mp_rank"] = np.array(hcg.get_model_parallel_rank())
    out[f"{tag}_peak"] = np.array(engine.last_peak_inflight)
    out[f"{tag}_signature"] = np.array(json.dumps(_descs(sig)))
    out[f"{tag}_issued"] = np.array(json.dumps(_descs(issued)))
    out[f"{tag}_device"] = np.array(str(engine._device))
    for k, v in pl.state_dict().items():
        out[f"{tag}_p_{k}"] = _np(v)
    dist.barrier()


def job_pp(outdir):
    """pp 2 x mp 2, then pp 2 x dp 2, over four ranks."""
    pt = _setup()
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env()
    out = {}
    _pp_run(pt, outdir, {"pp_degree": 2, "mp_degree": 2}, "ppmp", out)
    _pp_run(pt, outdir, {"pp_degree": 2, "dp_degree": 2}, "ppdp", out)
    # what still raises across processes, each naming ROADMAP.md
    from paddle_tpu_torch.parallel import (HybridCommunicateGroup,
                                           LayerDesc, PipelineLayer,
                                           PipelineParallel,
                                           SharedLayerDesc)
    raised = {}

    def expect(name, fn):
        try:
            fn()
            raised[name] = ""
        except NotImplementedError as e:
            raised[name] = str(e)

    hcg = HybridCommunicateGroup(hybrid_configs={"pp_degree": 2,
                                                 "dp_degree": 2})
    expect("interleave", lambda: PipelineParallel(
        pt.models.gpt_pipeline_layer(num_stages=2, num_layers=2,
                                     hidden_size=8, num_heads=2,
                                     vocab_size=16, max_seq_len=8,
                                     num_virtual_pipeline_stages=2), hcg))
    expect("shared", lambda: PipelineLayer(
        [SharedLayerDesc("t", pt.nn.Linear, None, "weight", 4, 4),
         LayerDesc(pt.nn.Linear, 4, 4),
         SharedLayerDesc("t", pt.nn.Linear, None, "weight", 4, 4),
         LayerDesc(pt.nn.Linear, 4, 4)], num_stages=2))
    expect("sp", lambda: HybridCommunicateGroup(
        hybrid_configs={"sp_degree": 4}))
    out["raised"] = np.array(json.dumps(raised))
    _save(outdir, "pp", dist.get_rank(), **out)


def run(job, outdir):
    """The spawn entry: run `job` (a name of this module's job_* ones)."""
    globals()[f"job_{job}"](outdir)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    run(sys.argv[1], sys.argv[2])
