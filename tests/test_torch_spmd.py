"""`paddle_tpu_torch.parallel.SPMDTrainStep` over gloo ranks on the CPU
against the JAX package's SPMDTrainStep on its 8-device CPU mesh.

tests/test_parallel.py's MLP with Adam(1e-2), 8 steps on one global batch
(tests/torch_dist_runner.py `job_spmd`, four ranks): dp over four ranks
(the gradients reduced after the backward, and by the bucket hooks during
it) within 1e-5 relative of the reference's {"dp_degree": 4}; ZeRO stages
1, 2 and 3 on {"sharding_degree": 4} within the reference's own 2e-3 /
2e-4 of its stage on the same mesh (tests/test_parallel.py:85-93), and
stage 2 on {"dp_degree": 2, "sharding_degree": 2}; the stage-1 slots at a
quarter of dp's, stage 3's parameters freed between steps and whole again
after `unshard()`. A tiny ErnieForPretraining with dp = 2 through
`fleet.init` -> `distributed_model` -> SPMDTrainStep, 3 fp32 AdamW steps
(`job_ernie`): losses and final parameters within 1e-5 of the reference's.
Without a process world, dp > 1 raises.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import models as jmodels
from paddle_tpu.parallel import HybridCommunicateGroup as JHCG
from paddle_tpu.parallel import SPMDTrainStep as JSPMD
from paddle_tpu.parallel import topology as jtopo
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import spawn, topology as ttopo

import torch_dist_runner as runner

STEPS = 8


@pytest.fixture(autouse=True)
def _cpu_and_fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


class MLP(jnn.Layer):
    def __init__(self, d=16):
        super().__init__()
        self.fc1 = jnn.Linear(d, 4 * d)
        self.fc2 = jnn.Linear(4 * d, d)
        self.act = jnn.GELU()
        self.head = jnn.Linear(d, 4)

    def forward(self, x):
        return self.head(self.fc2(self.act(self.fc1(x))))


def _mlp_and_data():
    """The reference test's model and batch (test_parallel.py:63-74)."""
    paddle.seed(42)
    np.random.seed(42)
    model = MLP()
    x = np.random.rand(16, 16).astype("float32")
    y = np.random.randint(0, 4, (16,))
    return model, x, y


def _ref_train(cfg, stage):
    model, x, y = _mlp_and_data()
    hcg = JHCG(hybrid_configs=cfg)
    opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                learning_rate=1e-2)
    step = JSPMD(model, jnn.CrossEntropyLoss(), opt, mesh=hcg.get_mesh(),
                 sharding_stage=stage, donate=False)
    xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
    losses = [float(step(xt, yt)) for _ in range(STEPS)]
    params = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    return np.array(losses), params


@pytest.fixture(scope="module")
def mlp_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("spmd")
    model, x, y = _mlp_and_data()
    np.savez(out / "mlp_init.npz", **{k: np.asarray(v._value) for k, v in
                                     model.state_dict().items()})
    np.savez(out / "mlp_data.npz", x=x, y=y)
    spawn(runner.run, args=("spmd", str(out)), nprocs=4, backend="gloo",
          device="cpu", timeout=300)
    res = []
    for r in range(4):
        with np.load(out / f"spmd_{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


def _params_of(r, tag):
    return {k[len(tag) + 3:]: v for k, v in r.items()
            if k.startswith(f"{tag}_p_")}


@pytest.mark.parametrize("tag", ["dp", "dpb"])
def test_dp_over_four_ranks_matches_the_reference(mlp_ranks, tag):
    want_losses, want_params = _ref_train({"dp_degree": 4}, 0)
    for r in mlp_ranks:
        np.testing.assert_allclose(r[f"{tag}_losses"], want_losses,
                                   rtol=1e-5)
        got = _params_of(r, tag)
        assert sorted(got) == sorted(want_params)
        # Adam moves each weight by ~1e-2 a step whatever its gradient's
        # size, so summation-order noise in a near-zero gradient shows at
        # 1e-3 of one step
        for k, v in want_params.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5)
    assert want_losses[-1] < want_losses[0]
    # the replicas stay bit-equal
    for r in mlp_ranks[1:]:
        for k, v in _params_of(mlp_ranks[0], tag).items():
            np.testing.assert_array_equal(_params_of(r, tag)[k], v)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_match_the_reference(mlp_ranks, stage):
    want_losses, want_params = _ref_train({"sharding_degree": 4}, stage)
    for r in mlp_ranks:
        np.testing.assert_allclose(r[f"z{stage}_losses"], want_losses,
                                   rtol=2e-3, atol=2e-4)
        got = _params_of(r, f"z{stage}")
        for k, v in want_params.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=2e-4)
        # and the port's stages agree with its dp much closer than that
        np.testing.assert_allclose(r[f"z{stage}_losses"], r["dp_losses"],
                                   rtol=1e-5)


def test_hybrid_dp_and_sharding_stage2_matches_the_reference(mlp_ranks):
    want_losses, _ = _ref_train({"dp_degree": 2, "sharding_degree": 2}, 2)
    for r in mlp_ranks:
        np.testing.assert_allclose(r["hyb_losses"], want_losses, rtol=2e-3,
                                   atol=2e-4)


def test_zero_memory_and_stage3_lifecycle(mlp_ranks):
    for r in mlp_ranks:
        dp, z1 = int(r["dp_slot_bytes"]), int(r["z1_slot_bytes"])
        # every MLP weight and bias splits four ways
        assert z1 * 4 == dp, (z1, dp)
        assert int(r["z3_slot_bytes"]) == z1
        assert bool(r["z3_freed"])
        np.testing.assert_allclose(r["z3_unsharded"],
                                   _params_of(r, "z3")["fc1.weight"])
        assert np.isfinite(r["z3_after_unshard"])
        for tag in ("dp", "z1", "z2", "z3"):
            assert r[f"{tag}_signature"] == mlp_ranks[0][f"{tag}_signature"]
        names = [s[0] for s in json.loads(str(r["z2_signature"]))]
        assert names == ["c_reducescatter", "c_allreduce", "c_allgather"]


def test_state_dict_resume_and_nonfinite_flags(mlp_ranks):
    for r in mlp_ranks:
        # a stage-1 step's state dict (dp 2 x sharding 2) resumes in a
        # stage-3 step: the next steps agree
        a, b = r["resume"]
        np.testing.assert_allclose(b, a, rtol=1e-6)
        # save_group_sharded_model wrote the whole weights, not the slices
        assert r["saved_fc1"].shape == (16, 64)
        np.testing.assert_array_equal(r["saved_fc1"], r["saved_fc1_now"])
        msg = str(r["nan_raised"])
        assert "NaN/Inf detected in SPMD train step" in msg
        assert "loss" in msg


def _ernie_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, runner.ERNIE_CFG["vocab_size"], (4, 32)).astype(
        np.int32)
    nsp = rng.integers(0, 2, (4,)).astype(np.int32)
    return ids, nsp


def test_tiny_ernie_dp2_matches_the_reference(tmp_path):
    paddle.seed(0)
    jm = jmodels.ErnieForPretraining(jmodels.ErnieModel(**runner.ERNIE_CFG))
    np.savez(tmp_path / "ernie_init.npz",
             **{k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    ids, nsp = _ernie_batch()
    np.savez(tmp_path / "ernie_data.npz", ids=ids, nsp=nsp)
    spawn(runner.run, args=("ernie", str(tmp_path)), nprocs=2,
          backend="gloo", device="cpu", timeout=300)

    ce = jnn.CrossEntropyLoss()

    def loss_fn(logits, nsp_logits, ids, nsp):
        v = logits.shape[-1]
        return ce(logits.reshape([-1, v]), ids.reshape([-1])) + \
            ce(nsp_logits, nsp)

    hcg = JHCG(hybrid_configs={"dp_degree": 2})
    opt = paddle.optimizer.AdamW(parameters=jm.parameters(),
                                 learning_rate=1e-3,
                                 epsilon=runner.ERNIE_EPS)
    step = JSPMD(jm, loss_fn, opt, mesh=hcg.get_mesh(), n_model_inputs=1)
    batch = [paddle.to_tensor(ids), paddle.to_tensor(ids),
             paddle.to_tensor(nsp)]
    want = np.array([float(step(*batch)) for _ in range(3)])
    want_params = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for r in range(2):
        with np.load(tmp_path / f"ernie_{r}.npz") as z:
            for red in ("bucketed", "gspmd"):
                np.testing.assert_allclose(z[f"{red}_losses"], want,
                                           rtol=1e-5)
                assert str(z[f"{red}_device"]) == "cpu"
                assert int(z[f"{red}_wrapper_hooks"]) == 0
                for k, v in want_params.items():
                    np.testing.assert_allclose(z[f"{red}_p_{k}"], v,
                                               rtol=1e-5, atol=1e-5)
    assert want[-1] < want[0]


def test_dp_without_a_process_world_raises():
    hcg = ttopo.HybridCommunicateGroup(hybrid_configs={"dp_degree": 2},
                                       devices=["cpu"] * 2)
    net = runner.mlp(pt)
    opt = pt.optimizer.Adam(parameters=net.parameters())
    with pytest.raises(RuntimeError, match="start 2 processes"):
        pt.parallel.SPMDTrainStep(net, pt.nn.CrossEntropyLoss(), opt,
                                  mesh=hcg.get_mesh())


def test_step_over_a_data_parallel_takes_off_its_hooks():
    """fleet.distributed_model's DataParallel has its Reducer's hooks on
    the parameters; SPMDTrainStep reduces the gradients itself, so it
    takes them off and steps as it does on the bare net."""
    hcg = ttopo.HybridCommunicateGroup(hybrid_configs={"dp_degree": 1},
                                       devices=["cpu"])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((16, 16), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (16,)))
    losses = []
    for wrap in (False, True):
        pt.seed(0)
        net = runner.mlp(pt)
        model = pt.parallel.DataParallel(net) if wrap else net
        if wrap:
            assert model.reducer._handles
        opt = pt.optimizer.Adam(parameters=net.parameters(),
                                learning_rate=1e-2)
        step = pt.parallel.SPMDTrainStep(model, pt.nn.CrossEntropyLoss(),
                                         opt, mesh=hcg.get_mesh())
        if wrap:
            assert model.reducer._handles == []
        losses.append([float(step(x, y)) for _ in range(3)])
    assert losses[0] == losses[1]
