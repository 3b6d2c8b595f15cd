"""The single-controller `PipelineParallel` (one process, the stages on
the slots of a mesh of CPU devices) against the JAX package's on its
8-device CPU mesh, from one state, and the rest of the slice that runs in
one process: `PipelineLayer` segmentation, `SharedLayerDesc`,
`fleet.distributed_model`, `gpt_pipeline_layer`, `gpt_10b`, and the
raises that remain.

The reference's TestPipelineParallel and TestInterleavedPipeline cases
(tests/test_parallel.py:179-340) run in both packages on the same numpy
data: losses and parameters within the reference's own 1e-5 / 2e-5
(parameters of the port against the reference's, and of the port's
1F1B with a global clip against one micro-batch). A tiny
`gpt_pipeline_layer(use_mp=True)` at pp 2 x mp 2 (the dryrun's
`pipeline_mp_step`, __graft_entry__.py:335-352) takes 3 SGD steps in both
within 1e-5 (1 + |ref|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import models as jmodels
from paddle_tpu.parallel import HybridCommunicateGroup as JHCG
from paddle_tpu.parallel import topology as jtopo
from paddle_tpu.parallel.pp_layers import LayerDesc as JLD
from paddle_tpu.parallel.pp_layers import PipelineLayer as JPL
from paddle_tpu.parallel.pipeline_parallel import PipelineParallel as JPP
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import (LayerDesc, PipelineLayer,
                                       PipelineParallel, SharedLayerDesc,
                                       TensorParallel, fleet)
from paddle_tpu_torch.parallel import topology as ttopo

from torch_parity import carry_state, dev, state_of

GPT = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=2,
           max_seq_len=16, dropout=0.0)


@pytest.fixture(autouse=True)
def _fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


def _data(rows, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((rows, 8), dtype=np.float32), \
        rng.integers(0, 2, (rows,))


def _pair(pp=2, dp=1, n_layers=4, d=8, vpp=1, seed=7):
    """(reference engine, its PipelineLayer, port engine, its layer), the
    port's carrying the reference's weights."""
    paddle.seed(seed)
    engines = []
    for mod, ld, pl_, pp_, hcg_ in (
            (jnn, JLD, JPL, JPP, lambda c: JHCG(hybrid_configs=c)),
            (pt.nn, LayerDesc, PipelineLayer, PipelineParallel,
             lambda c: ttopo.HybridCommunicateGroup(
                 hybrid_configs=c, devices=["cpu"] * (pp * dp)))):
        hcg = hcg_({"dp_degree": dp, "pp_degree": pp})
        descs = [ld(mod.Linear, d, d) for _ in range(n_layers - 1)]
        descs.append(ld(mod.Linear, d, 2))
        pl = pl_(descs, num_stages=pp, loss_fn=mod.CrossEntropyLoss(),
                 num_virtual_pipeline_stages=vpp)
        engines += [pp_(pl, hcg, None), pl]
    je, jpl, te, tpl = engines
    carry_state(jpl, tpl)
    return je, jpl, te, tpl


def _train(je, jpl, te, tpl, x, y, steps, micro, lr, clip=None):
    je.accumulate_steps = te.accumulate_steps = micro
    jo = paddle.optimizer.SGD(parameters=jpl.parameters(), learning_rate=lr,
                              grad_clip=None if clip is None else
                              jnn.ClipGradByGlobalNorm(clip))
    to = pt.optimizer.SGD(parameters=tpl.parameters(), learning_rate=lr,
                          grad_clip=None if clip is None else
                          pt.nn.ClipGradByGlobalNorm(clip))
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(je.train_batch([paddle.to_tensor(x),
                                        paddle.to_tensor(y)], jo)))
        tl.append(float(te.train_batch([torch.from_numpy(x),
                                        torch.from_numpy(y)], to)))
    return np.array(jl), np.array(tl)


def _params_close(jpl, tpl, tol=2e-5):
    want = state_of(jpl)
    got = {k: v.detach().numpy() for k, v in tpl.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol)


def test_pipeline_trains_like_the_reference():
    je, jpl, te, tpl = _pair(pp=2, dp=2)
    x, y = _data(8)
    jl, tl = _train(je, jpl, te, tpl, x, y, 10, 2, 0.1)
    assert tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    _params_close(jpl, tpl)
    # each stage on its slot of the mesh's pp axis
    assert te._stage_devices == [torch.device("cpu")] * 2


def test_pipeline_matches_sequential():
    je, jpl, te, tpl = _pair(pp=2, dp=1)
    x, _ = _data(4)
    out_seq = tpl(torch.from_numpy(x))
    out_pipe = te.eval_batch([torch.from_numpy(x)], compute_loss=False)
    np.testing.assert_allclose(out_pipe.numpy(), out_seq.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    want = je.eval_batch([paddle.to_tensor(x)], compute_loss=False)
    assert dev(out_pipe.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("method", ["uniform", "layer:Linear"])
def test_segmentation_matches_the_reference(method):
    for k in (1, 2, 4):
        descs = [LayerDesc(pt.nn.Linear, 4, 4) for _ in range(7)]
        jdescs = [JLD(jnn.Linear, 4, 4) for _ in range(7)]
        pl = PipelineLayer(descs, num_stages=k, seg_method=method)
        jpl = JPL(jdescs, num_stages=k, seg_method=method)
        assert pl.segments == jpl.segments
        sizes = [hi - lo for lo, hi in pl.segments]
        assert sum(sizes) == 7
        if method == "uniform":
            assert max(sizes) - min(sizes) <= 1
    gp = pt.models.gpt_pipeline_layer(num_stages=2, **GPT)
    gp._segment()
    jgp = jmodels.gpt_pipeline_layer(num_stages=2, **GPT)
    assert gp.segments == jgp.segments
    for pl_ in (gp, jgp):
        pl_.seg_method = "layer:ErnieLayer"
        pl_._segment()
    assert gp.segments == jgp.segments == [(0, 3), (3, 6)]


def test_1f1b_inflight_bounded_by_stages():
    _, _, te, tpl = _pair(pp=2, dp=1)
    te.accumulate_steps = 8
    opt = pt.optimizer.SGD(parameters=tpl.parameters(), learning_rate=0.1)
    x, y = _data(16)
    te.train_batch([torch.from_numpy(x), torch.from_numpy(y)], opt)
    assert 1 <= te.last_peak_inflight <= te.num_stages


def test_1f1b_with_a_global_clip_matches_one_micro_batch_and_the_reference():
    x, y = _data(8, seed=1)
    results = []
    for micro in (1, 4):
        je, jpl, te, tpl = _pair(pp=2, dp=1)
        _train(je, jpl, te, tpl, x, y, 1, micro, 0.5, clip=0.05)
        _params_close(jpl, tpl)
        results.append([p.detach().numpy().copy()
                        for p in tpl.parameters()])
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_interleaved_chunks_and_devices():
    _, jpl, te, tpl = _pair(pp=2, vpp=2, n_layers=8)
    assert len(tpl.segments) == 4 and tpl.segments == jpl.segments
    assert te.num_stages == 4 and te.num_phys_stages == 2
    assert te._stage_meshes[0] is te._stage_meshes[2]
    assert te._stage_meshes[1] is te._stage_meshes[3]
    assert [tpl.chunk_to_stage(c) for c in range(4)] == [0, 1, 0, 1]


def test_interleaved_trains_like_the_reference_and_the_plain_pipeline():
    x, y = _data(8, seed=2)
    je, jpl, te, tpl = _pair(vpp=2, n_layers=8, seed=11)
    jl, tl = _train(je, jpl, te, tpl, x, y, 10, 4, 0.1)
    assert tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    _params_close(jpl, tpl)
    results = []
    for vpp in (1, 2):
        _, _, te, tpl = _pair(vpp=vpp, n_layers=8, seed=11)
        te.accumulate_steps = 2
        opt = pt.optimizer.SGD(parameters=tpl.parameters(),
                               learning_rate=0.5)
        te.train_batch([torch.from_numpy(x), torch.from_numpy(y)], opt)
        results.append([p.detach().numpy().copy()
                        for p in tpl.parameters()])
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_interleaved_eval_matches_sequential():
    _, _, te, tpl = _pair(vpp=2, n_layers=8, seed=13)
    x, _ = _data(4)
    out_seq = tpl(torch.from_numpy(x)).detach().numpy()
    out_pipe = te.eval_batch([torch.from_numpy(x)], compute_loss=False)
    np.testing.assert_allclose(out_pipe.numpy(), out_seq, rtol=1e-5,
                               atol=1e-5)


def test_gpt_pipeline_layer_pp2_mp2_matches_the_reference():
    """The dryrun's pipeline x mp step (__graft_entry__.py:335-352) in
    one process: mp_layers compute the dense layers on each stage's first
    slot, as the reference's GSPMD stage programs compute them."""
    paddle.seed(3)
    jpl = jmodels.gpt_pipeline_layer(num_stages=2, use_mp=True, **GPT)
    jhcg = JHCG(hybrid_configs={"dp_degree": 2, "mp_degree": 2,
                                "pp_degree": 2})
    je = JPP(jpl, jhcg, None)
    thcg = ttopo.HybridCommunicateGroup(
        hybrid_configs={"dp_degree": 2, "mp_degree": 2, "pp_degree": 2},
        devices=["cpu"] * 8)
    tpl = pt.models.gpt_pipeline_layer(num_stages=2, use_mp=True, **GPT)
    carry_state(jpl, tpl)
    te = PipelineParallel(tpl, thcg, None)
    ids = np.random.default_rng(4).integers(0, 64, (8, 16)).astype(np.int32)
    je.accumulate_steps = te.accumulate_steps = 2
    jo = paddle.optimizer.SGD(parameters=jpl.parameters(), learning_rate=0.1)
    to = pt.optimizer.SGD(parameters=tpl.parameters(), learning_rate=0.1)
    for _ in range(3):
        lj = float(je.train_batch([paddle.to_tensor(ids)] * 2, jo))
        lt = float(te.train_batch([torch.from_numpy(ids)] * 2, to))
        assert dev(lt, lj) <= 1e-5
    want = state_of(jpl)
    for k, v in tpl.state_dict().items():
        assert dev(v.detach().numpy(), want[k]) <= 1e-5, k


def test_shared_layer_desc_updates_once_per_stage_as_the_reference():
    """A reference behaviour kept on purpose (ROADMAP Queue 3 item 7):
    the single controller updates a weight shared by two stages once per
    stage, each with that stage's gradient and its own optimizer slots,
    one after the other (pipeline_parallel.py:314-331), where one update
    with the summed gradient would be right. Under Adam's first step each
    update moves an element by about lr, so the shared weight moves by
    0 or 2 lr where every other weight moves by lr. (The reference itself
    cannot run this model on its mesh: it places the shared weight on
    both stages' devices, and its stage program then sees parameters on
    two device sets.)"""
    pt.seed(9)
    descs = [SharedLayerDesc("tied", pt.nn.Linear, None, "weight", 8, 8),
             LayerDesc(pt.nn.Linear, 8, 8),
             SharedLayerDesc("tied", pt.nn.Linear, None, "weight", 8, 8),
             LayerDesc(pt.nn.Linear, 8, 2)]
    pl = PipelineLayer(descs, num_stages=2, loss_fn=pt.nn.CrossEntropyLoss())
    te = PipelineParallel(pl, ttopo.HybridCommunicateGroup(
        hybrid_configs={"pp_degree": 2}, devices=["cpu"] * 2), None)
    shared, other = pl._built_layers[0], pl._built_layers[1]
    assert shared is pl._built_layers[2]
    w0, o0 = (m.weight.detach().numpy().copy() for m in (shared, other))
    lr = 1e-3
    opt = pt.optimizer.Adam(parameters=pl.parameters(), learning_rate=lr)
    x, y = _data(4, seed=3)
    te.train_batch([torch.from_numpy(x), torch.from_numpy(y)], opt)
    moved = np.abs(shared.weight.detach().numpy() - w0) / lr
    assert np.all((np.abs(moved) < 0.01) | (np.abs(moved - 2) < 0.01))
    assert np.any(np.abs(moved - 2) < 0.01)
    np.testing.assert_allclose(
        np.abs(other.weight.detach().numpy() - o0) / lr, 1.0, atol=0.01)
    # both stages hold slots for it
    assert all(len(s) == 4 for s in te._opt_slots)


def test_fleet_distributed_model_in_one_process():
    st = pt.parallel.DistributedStrategy()
    st.hybrid_configs.update(pp_degree=2, dp_degree=1)
    hcg = ttopo.HybridCommunicateGroup(st, devices=["cpu"] * 2)
    fleet._FLEET.update(init=True, strategy=st, hcg=hcg)
    try:
        pl = pt.models.gpt_pipeline_layer(num_stages=1, **GPT)
        engine = fleet.distributed_model(pl)
        assert isinstance(engine, PipelineParallel)
        assert pl.num_stages == 2 and len(pl.segments) == 2
        with pytest.raises(TypeError, match="PipelineLayer"):
            fleet.distributed_model(pt.nn.Linear(4, 4))
        st2 = pt.parallel.DistributedStrategy()
        st2.hybrid_configs.update(mp_degree=2)
        fleet._FLEET.update(strategy=st2, hcg=ttopo.HybridCommunicateGroup(
            st2, devices=["cpu"] * 2))
        net = pt.nn.Linear(4, 4)
        wrapped = fleet.distributed_model(net)
        assert isinstance(wrapped, TensorParallel)
        assert list(wrapped.state_dict()) == list(net.state_dict())
    finally:
        fleet._FLEET.update(init=False, strategy=None, hcg=None)


def test_gpt_10b_is_the_references_configuration(monkeypatch):
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as tgpt
    seen = []
    for mod in (jgpt, tgpt):
        monkeypatch.setattr(mod, "GPTModel", lambda **kw: seen.append(kw))
        mod.gpt_10b(use_mp=True)
    assert seen[0] == seen[1] == dict(hidden_size=4096, num_layers=48,
                                      num_heads=64, max_seq_len=2048,
                                      use_mp=True)
    assert pt.models.gpt_10b is tgpt.gpt_10b


def test_remaining_raises_name_roadmap():
    _, _, te, tpl = _pair()
    opt = pt.optimizer.SGD(parameters=tpl.parameters(), learning_rate=0.1)
    x, y = _data(4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        te.train_batch([torch.from_numpy(x), torch.from_numpy(y)], opt,
                       scaler=pt.amp.GradScaler())
    hcg = ttopo.HybridCommunicateGroup(hybrid_configs={"sp_degree": 2},
                                       devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="sp across processes"):
        pt.parallel.SPMDTrainStep(pt.nn.Linear(4, 4), pt.nn.MSELoss(),
                                  pt.optimizer.SGD(), mesh=hcg.get_mesh())
    # the meta-optimizer toggles no longer raise: they wrap the optimizer
    st = pt.parallel.DistributedStrategy()
    st.gradient_merge = True
    from paddle_tpu_torch.parallel.meta_optimizers import \
        GradientMergeOptimizer
    assert isinstance(fleet.distributed_optimizer(pt.optimizer.SGD(),
                                                  strategy=st),
                      GradientMergeOptimizer)
    # the parameter-server surface no longer raises: it is ported
    srv = fleet.init_server()
    try:
        assert srv.port > 0
    finally:
        srv.stop()
        fleet._PS_CTX[0] = None
    try:
        assert fleet.init(is_collective=False) is not None
    finally:
        fleet._FLEET.update(init=False, strategy=None, hcg=None)
