"""Slice 15 on cards: the collectives and data-parallel training over
processes on CUDA tensors.

Every test is marked `cuda` and skips without a CUDA device; the CPU
tests (test_torch_collective.py, test_torch_reducer.py,
test_torch_spmd.py) hold the port to the JAX package. The world is one
NCCL rank per card with two or four cards, else two gloo ranks on cuda:0
(NCCL takes no two ranks on one card). The ranks run
tests/torch_dist_runner.py's jobs; this file imports neither jax nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dist_cuda.py
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import spawn
from paddle_tpu_torch.utils import load_numpy_state

import torch_dist_runner as runner


@pytest.fixture()
def world():
    """(ranks, backend, gpus) of the card world this machine allows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the ranks' cards")
    n = torch.cuda.device_count()
    if n >= 4:
        return 4, "nccl", "0,1,2,3"
    if n >= 2:
        return 2, "nccl", "0,1"
    return 2, "gloo", "0,0"


@pytest.mark.cuda
def test_collectives_on_cards(world, tmp_path):
    n, backend, gpus = world
    rng = np.random.default_rng(0)
    x = rng.integers(1, 4, (n, 8)).astype(np.float32)
    common = rng.integers(0, 9, (n, 3)).astype(np.float32)
    np.savez(tmp_path / "coll_in.npz", x=x, common=common)
    spawn(runner.run, args=("collectives", str(tmp_path)), nprocs=n,
          backend=backend, gpus=gpus, timeout=300)
    res = [dict(np.load(tmp_path / f"collectives_{r}.npz"))
           for r in range(n)]
    for r, got in enumerate(res):
        assert str(got["backend"]) == backend
        assert str(got["device"]).startswith("cuda:"), got["device"]
        for name, want in (("sum", x.sum(0)), ("max", x.max(0)),
                           ("min", x.min(0)), ("prod", x.prod(0)),
                           ("avg", x.mean(0))):
            np.testing.assert_array_equal(got[f"all_reduce_{name}"], want)
        np.testing.assert_array_equal(got["all_reduce_bf16"], x.sum(0))
        np.testing.assert_array_equal(got["all_gather"], x)
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      x.sum(0).reshape(n, -1)[r])
        np.testing.assert_array_equal(got["broadcast_0"], x[0])
        np.testing.assert_array_equal(got["scatter"], common[r])
        np.testing.assert_array_equal(
            got["alltoall"], x.reshape(n, n, -1)[:, r])
        np.testing.assert_array_equal(got["send_recv"], x[(r - 1) % n])
        np.testing.assert_array_equal(got["p2p_shift_1"], x[(r - 1) % n])


@pytest.mark.cuda
def test_two_rank_dp_step_on_cards_matches_one_process(world, tmp_path):
    n, backend, gpus = world
    pt.set_device("gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.seed(0)
    net = pt.models.ErnieForPretraining(pt.models.ErnieModel(
        **runner.ERNIE_CFG))
    state = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    np.savez(tmp_path / "ernie_init.npz", **state)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, runner.ERNIE_CFG["vocab_size"], (4, 32)).astype(
        np.int32)
    nsp = rng.integers(0, 2, (4,)).astype(np.int32)
    np.savez(tmp_path / "ernie_data.npz", ids=ids, nsp=nsp)
    spawn(runner.run, args=("ernie", str(tmp_path)), nprocs=2,
          backend=backend, gpus=",".join(gpus.split(",")[:2]), timeout=300)
    load_numpy_state(net, state)
    opt = pt.optimizer.AdamW(parameters=net.parameters(), learning_rate=1e-3,
                             epsilon=runner.ERNIE_EPS)
    step = pt.jit.TrainStep(net, runner.ernie_loss(pt), opt,
                            n_model_inputs=1)
    batch = [torch.from_numpy(a).cuda() for a in (ids, ids, nsp)]
    want = np.array([float(step(*batch)) for _ in range(3)])
    for r in range(2):
        got = np.load(tmp_path / f"ernie_{r}.npz")
        for red in ("bucketed", "gspmd"):
            assert str(got[f"{red}_device"]).startswith("cuda:"), \
                got[f"{red}_device"]
            np.testing.assert_allclose(got[f"{red}_losses"], want, rtol=1e-5)
            for k, v in net.state_dict().items():
                np.testing.assert_allclose(got[f"{red}_p_{k}"],
                                           v.detach().cpu().numpy(),
                                           rtol=1e-5, atol=1e-5)
    pt.set_device("cpu")
