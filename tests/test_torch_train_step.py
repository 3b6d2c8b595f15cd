"""The port's `jit.TrainStep` + `AdamW` + `GPTPretrainingCriterion` against
the JAX package's, on a tiny GPT carried across by name.

Both packages start from one JAX state dict and take the same steps on
the same token ids; losses, every parameter and the Adam slots are held
against each other. Both run on the CPU; attention takes the einsum path
in both at these sizes.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core import flags as jflags
from paddle_tpu.jit import TrainStep as JTrainStep
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.utils import load_numpy_state

CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
           max_seq_len=128, dropout=0.0)
LR = 1e-3
# epsilon 1e-6 rather than Adam's 1e-8: some gradients are zero in exact
# arithmetic (the key bias shifts every score of a row equally, and the
# softmax ignores it), so both packages compute rounding noise there, and
# with a tiny epsilon Adam scales that noise up to steps of +-lr whose sign
# is the noise's. 1e-6 keeps those steps below 1e-5.
EPS = 1e-6
STEPS = 3


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _ids(seed=0, n=2):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (n, CFG["max_seq_len"])).astype(np.int32)


def _jax_pair(amp, eps=EPS):
    paddle.seed(0)
    jm = jmodels.GPTForCausalLM(jmodels.gpt.GPTModel(**CFG))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=LR, epsilon=eps,
                                 parameters=jm.parameters())
    step = JTrainStep(jm, jmodels.GPTPretrainingCriterion(), opt,
                      amp_dtype=amp)
    return jm, step, state


def _torch_step(state, amp, eps=EPS):
    tm = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(tm, state)
    opt = pt.optimizer.AdamW(learning_rate=LR, epsilon=eps,
                             parameters=tm.parameters())
    return tm, pt.jit.TrainStep(tm, pt.models.GPTPretrainingCriterion(), opt,
                                amp_dtype=amp)


def _train_both(amp):
    jm, jstep, state = _jax_pair(amp)
    tm, tstep = _torch_step(state, amp)
    ids = _ids()
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids)))
          for _ in range(STEPS)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids)))
          for _ in range(STEPS)]
    jparams = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tparams = {k: v.detach().float().numpy()
               for k, v in tm.state_dict().items()}
    assert jstep._pnames == tstep._pnames
    return state, jl, tl, jparams, tparams, jstep, tstep


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return 1.0 if na == nb == 0 else float(a @ b / (na * nb))


def test_fp32_steps_match_the_jax_train_step():
    _, jl, tl, jparams, tparams, jstep, tstep = _train_both(None)
    # fp32 throughout: XLA and PyTorch differ in summation order only;
    # three AdamW steps of lr 1e-3 keep every weight within 5e-5
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert tl[-1] < tl[0]
    for k, want in jparams.items():
        np.testing.assert_allclose(tparams[k], want, rtol=0, atol=5e-5,
                                   err_msg=k)
    for name, js, ts in zip(tstep._pnames, jstep._slots, tstep._slots):
        assert sorted(ts) == sorted(js) == ["moment1", "moment2"]
        for slot in ("moment1", "moment2"):
            want = np.asarray(js[slot])
            # moments are sums of (squared) gradients: 1e-4 of the slot's
            # largest entry
            np.testing.assert_allclose(
                ts[slot].numpy(), want, rtol=0,
                atol=1e-4 * np.abs(want).max(), err_msg=f"{name} {slot}")


def test_bf16_amp_steps_match_the_jax_train_step():
    state, jl, tl, jparams, tparams, jstep, tstep = _train_both("bfloat16")
    # bf16 AMP: every parameter, activation, logit and the loss itself are
    # bf16 in both packages, and they round at different places (XLA's
    # fused layer norm and softmax vs PyTorch's f32-internal kernels): the
    # loss agrees to a few of bf16's 2^-8 steps, the gradients (moment1)
    # and their squares (moment2) in direction, the updates overall
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert tl[-1] < tl[0]
    for name, js, ts in zip(tstep._pnames, jstep._slots, tstep._slots):
        for slot in ("moment1", "moment2"):
            assert _cos(ts[slot].numpy(), np.asarray(js[slot])) >= 0.99, \
                (name, slot)
    jupd = np.concatenate([(jparams[k] - state[k]).ravel() for k in state])
    tupd = np.concatenate([(tparams[k] - state[k]).ravel() for k in state])
    assert _cos(tupd, jupd) >= 0.99
    for k in state:  # the master weights stay f32
        assert tstep.model.state_dict()[k].dtype == torch.float32


def test_run_equals_repeated_calls():
    state = _jax_pair(None)[2]
    tm_a, step_a = _torch_step(state, None)
    tm_b, step_b = _torch_step(state, None)
    ids = [_ids(i) for i in range(STEPS)]
    want = [step_a(torch.from_numpy(x), torch.from_numpy(x)) for x in ids]
    stacked = torch.from_numpy(np.stack(ids))
    got = step_b.run(stacked, stacked)
    assert got.shape == (STEPS,)
    np.testing.assert_array_equal(got.numpy(), torch.stack(want).numpy())
    for (k, a), b in zip(tm_a.state_dict().items(),
                         tm_b.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert step_a.optimizer._step_count == step_b.optimizer._step_count \
        == STEPS


def test_state_dict_resumes_the_same_losses(tmp_path):
    state = _jax_pair(None)[2]
    _, step = _torch_step(state, None)
    ids = torch.from_numpy(_ids())
    for _ in range(2):
        step(ids, ids)
    path = str(tmp_path / "loop.pdparams")
    pt.save(step.state_dict(), path)
    first = [float(step(ids, ids)) for _ in range(2)]
    _, fresh = _torch_step(state, None)
    fresh.set_state_dict(pt.load(path))
    again = [float(fresh(ids, ids)) for _ in range(2)]
    assert again == first
    assert fresh.optimizer._step_count == 4


@pytest.fixture
def nan_flag():
    old_j, old_t = jflags.flag("check_nan_inf"), tflags.flag("check_nan_inf")
    jflags.set_flags({"check_nan_inf": True})
    pt.set_flags({"FLAGS_check_nan_inf": True})
    yield
    jflags.set_flags({"check_nan_inf": old_j})
    tflags.set_flags({"check_nan_inf": old_t})


def _poisoned(state):
    state = dict(state)
    w = state["gpt.layers.1.mlp.fc2.weight"].copy()
    w[0, 0] = np.nan
    state["gpt.layers.1.mlp.fc2.weight"] = w
    return state


@pytest.mark.parametrize("path", ["call", "run"])
def test_check_nan_inf_raises_naming_the_parameters(nan_flag, path):
    jm, jstep, state = _jax_pair(None)
    jm.set_state_dict(_poisoned(state))
    _, tstep = _torch_step(_poisoned(state), None)
    ids = _ids()
    with pytest.raises(FloatingPointError) as jerr:
        x = paddle.to_tensor(ids if path == "call" else ids[None])
        (jstep if path == "call" else jstep.run)(x, x)
    with pytest.raises(FloatingPointError) as terr:
        x = torch.from_numpy(ids if path == "call" else ids[None])
        (tstep if path == "call" else tstep.run)(x, x)
    assert "FLAGS_check_nan_inf" in str(terr.value)
    assert "grad of gpt.layers.1.mlp.fc2.weight" in str(terr.value)
    # the same loss and parameters are named, in the same order
    assert str(terr.value).split(": ", 1)[1] == \
        str(jerr.value).split(": ", 1)[1]
    # state was committed before the raise
    assert tstep.optimizer._step_count == 1
