"""The slice as a whole on the CPU: a paddle user's dygraph loop
(`to_tensor`, Tensor methods, `loss.backward()`, `opt.step()`,
`opt.clear_grad()`) on a tiny GPT in both packages, and the earlier entry
points (TrainStep, Predictor, LLMEngine, ServingEngine) given `Tensor`
inputs against the same calls with plain tensors.

The GPT (2 layers, hidden 64) is built in the JAX package and carried
into the port by name (`utils.convert.load_numpy_state`); both take 3
AdamW steps in fp32 from it on the same ids. Losses and every parameter
within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
import paddle_tpu_torch as pt
from paddle_tpu_torch.utils import load_numpy_state

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0)
LR = 1e-3
# some gradients are zero in exact arithmetic (the key bias shifts every
# score of a row equally, and the softmax ignores it), so both packages
# compute rounding noise there (~1e-8), and Adam divides it by
# sqrt(v) + eps: 1e-4 keeps those steps under 1e-7 (at Adam's 1e-8 they
# are steps of +-lr whose sign is the noise's)
EPS = 1e-4
STEPS = 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _ids(seed=0, b=2, s=32):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (b, s)).astype(np.int32)


def _models():
    paddle.seed(0)
    jm = jmodels.GPTForCausalLM(jmodels.gpt.GPTModel(**CFG))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(tm, state)
    return jm, tm, state


def _dygraph_loss(pkg, model, ids):
    vocab = CFG["vocab_size"]
    logits = model(ids)
    loss = pkg.nn.functional.cross_entropy(
        logits[:, :-1].reshape([-1, vocab]).astype("float32"),
        ids[:, 1:].reshape([-1])).mean()
    return logits, loss


def test_dygraph_loop_matches_the_reference():
    jm, tm, _ = _models()
    jopt = paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                  parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                              parameters=tm.parameters())
    jids, tids = paddle.to_tensor(_ids()), pt.to_tensor(_ids())
    assert isinstance(tids, pt.Tensor) and tids.dtype == pt.int32
    assert tids.place == pt.CPUPlace(0)
    jl, tl = [], []
    for _ in range(STEPS):
        _, jloss = _dygraph_loss(paddle, jm, jids)
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        logits, tloss = _dygraph_loss(pt, tm, tids)
        assert isinstance(logits, pt.Tensor) and isinstance(tloss, pt.Tensor)
        tloss.backward()
        assert all(p.grad is not None for p in tm.parameters())
        topt.step()
        topt.clear_grad()
        assert all(p.grad is None for p in tm.parameters())
        jl.append(float(jloss))
        tl.append(tloss.item())
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tl[-1] < tl[0]
    jp = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), jp[k], rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_dygraph_step_equals_the_same_loop_on_plain_tensors():
    """The Tensor layer changes no number: the loop on `Tensor` ids and
    the loop on plain torch ids give bit-equal losses and parameters."""
    _, tm, state = _models()
    tm2 = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(tm2, state)
    o1 = pt.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters())
    o2 = pt.optimizer.AdamW(learning_rate=LR, parameters=tm2.parameters())
    ids = _ids(1)
    for _ in range(2):
        _, l1 = _dygraph_loss(pt, tm, pt.to_tensor(ids))
        l1.backward()
        o1.step()
        o1.clear_grad()
        plain = torch.from_numpy(ids)
        logits = tm2(plain)
        assert type(logits) is torch.Tensor
        l2 = pt.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, CFG["vocab_size"]).float(),
            plain[:, 1:].reshape(-1)).mean()
        assert type(l2) is torch.Tensor
        l2.backward()
        o2.step()
        o2.clear_grad()
        assert l1.item() == l2.item()
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)


def test_train_step_takes_tensor_batches():
    _, tm, state = _models()
    tm2 = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(tm2, state)
    crit = pt.models.GPTPretrainingCriterion()
    s1 = pt.jit.TrainStep(tm, crit, pt.optimizer.AdamW(
        learning_rate=LR, parameters=tm.parameters()))
    s2 = pt.jit.TrainStep(tm2, crit, pt.optimizer.AdamW(
        learning_rate=LR, parameters=tm2.parameters()))
    ids = _ids(2)
    wrapped = s1(pt.to_tensor(ids), pt.to_tensor(ids))
    plain = s2(torch.from_numpy(ids), torch.from_numpy(ids))
    assert type(wrapped) is pt.Tensor and type(plain) is torch.Tensor
    assert wrapped.item() == plain.item()
    span = np.stack([_ids(3), _ids(4)])
    lw = s1.run(pt.to_tensor(span), pt.to_tensor(span))
    lp = s2.run(torch.from_numpy(span), torch.from_numpy(span))
    assert type(lw) is pt.Tensor and lw.shape == [2]
    np.testing.assert_array_equal(lw.numpy(), lp.numpy())


def test_predictor_and_serving_engine_take_tensor_inputs():
    _, tm, _ = _models()
    tm.eval()
    pred = pt.inference.Predictor(tm, device="cpu")
    ids = _ids(5)
    got = pred.run([pt.to_tensor(ids)])
    want = pred.run([torch.from_numpy(ids)])
    assert type(got[0]) is pt.Tensor and type(want[0]) is torch.Tensor
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    eng = pt.serving.ServingEngine(
        pt.inference.Predictor(tm, device="cpu"),
        pt.serving.EngineConfig(max_batch_size=2, batch_sizes=(1, 2),
                                batch_timeout_ms=1, warmup_on_start=False))
    futs = [eng.submit([pt.to_tensor(ids[:1])]),
            eng.submit([ids[:1]])]
    eng.start()
    try:
        outs = [f.result(timeout=60)[0] for f in futs]
    finally:
        eng.stop()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_llm_engine_takes_a_tensor_prompt():
    _, tm, _ = _models()
    tm.eval()
    eng = pt.serving.LLMEngine(tm, pt.serving.LLMConfig(
        num_slots=2, max_len=32, max_new_tokens=4), device="cpu").start()
    try:
        prompt = [3, 9, 4, 1]
        a = eng.submit(pt.to_tensor(prompt)).result(60.0)
        b = eng.submit(prompt).result(60.0)
    finally:
        eng.stop()
    assert a == b
