"""The port's ERNIE (`ErnieForPretraining`) against the JAX package's, on a
small model carried across by name.

One JAX state dict feeds both packages. Logits and NSP logits are held
against each other with and without sequence parallelism (the ring over
four slots: the JAX mesh's CPU devices, the port's four CPU slots, with
the flash ring at 128 tokens per slot), the attention mask is held without
it, and three `TrainStep` + AdamW steps with `use_sp=True` on sp = 4 give
the same losses and parameters in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import nn as jnn
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit.functional import functional_call as jfunctional_call
from paddle_tpu.jit.functional import split_state as jsplit_state
from paddle_tpu.parallel import topology as jtopo
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import topology as ttopo
from paddle_tpu_torch.utils import load_numpy_state

CFG = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=256,
           hidden_dropout_prob=0.0)
B, S = 2, 512            # 128 tokens per slot over sp = 4: the flash ring
LR = 1e-3
# as in test_torch_train_step.py: Adam's epsilon above the rounding noise
# of gradients that are zero in exact arithmetic (the key bias)
EPS = 1e-6


@pytest.fixture(autouse=True)
def _cpu_and_fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


def _meshes():
    jtopo.HybridCommunicateGroup(hybrid_configs={"sp_degree": 4})
    ttopo.HybridCommunicateGroup(hybrid_configs={"sp_degree": 4},
                                 devices=["cpu"] * 4)


def _pair(use_sp):
    paddle.seed(0)
    jm = jmodels.ErnieForPretraining(jmodels.ErnieModel(**CFG, use_sp=use_sp))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = pt.models.ErnieForPretraining(pt.models.ErnieModel(**CFG,
                                                            use_sp=use_sp))
    load_numpy_state(tm, state)
    return jm, tm, state


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    return ids, nsp


def _jax_logits(jm, ids, mask=None):
    # the JAX forward traced once under jit (the ring's Pallas kernels in
    # interpret mode are slow op by op)
    pnames, params = zip(*((n, p._value) for n, p in
                           jsplit_state(jm)[0].items()))
    fn = jax.jit(lambda ps, ids, mask: jfunctional_call(
        jm, list(pnames), ps, [], [], ids, attention_mask=mask))
    logits, nsp = fn(list(params), jnp.asarray(ids),
                     None if mask is None else jnp.asarray(mask))
    return np.asarray(logits), np.asarray(nsp)


def _torch_logits(tm, ids, mask=None):
    with torch.no_grad():
        logits, nsp = tm(torch.from_numpy(ids), attention_mask=None
                         if mask is None else torch.from_numpy(mask))
    return logits.numpy(), nsp.numpy()


def test_state_dict_names_and_layouts_match():
    jm, tm, state = _pair(False)
    tstate = tm.state_dict()
    assert list(state) == list(tstate)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(tstate[k].shape), k


@pytest.mark.parametrize("use_sp", [False, True])
def test_pretraining_logits_match_the_jax_model(use_sp):
    if use_sp:
        _meshes()
    jm, tm, _ = _pair(use_sp)
    ids, _ = _batch()
    want, want_nsp = _jax_logits(jm, ids)
    got, got_nsp = _torch_logits(tm, ids)
    assert got.shape == (B, S, CFG["vocab_size"]) and got_nsp.shape == (B, 2)
    # fp32 through two post-LN layers and the tied head (logits ~10): XLA
    # and PyTorch differ in summation order, the ring in its hop merge
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_nsp, want_nsp, rtol=1e-4, atol=1e-4)


def test_attention_mask_matches_the_jax_model():
    jm, tm, _ = _pair(False)
    ids, _ = _batch(1)
    mask = np.ones((B, S), np.int32)
    mask[0, 400:] = 0
    mask[1, 17:90] = 0
    want, want_nsp = _jax_logits(jm, ids, mask)
    got, got_nsp = _torch_logits(tm, ids, mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_nsp, want_nsp, rtol=1e-4, atol=1e-4)
    assert not np.allclose(got, _torch_logits(tm, ids)[0], atol=1e-3)


def _loss_fns():
    jce, tce = jnn.CrossEntropyLoss(), pt.nn.CrossEntropyLoss()

    def jloss(logits, nsp_logits, ids, nsp):
        v = logits.shape[-1]
        return jce(logits.reshape([-1, v]), ids.reshape([-1])) + \
            jce(nsp_logits, nsp)

    def tloss(logits, nsp_logits, ids, nsp):
        v = logits.shape[-1]
        return tce(logits.reshape(-1, v), ids.reshape(-1)) + \
            tce(nsp_logits, nsp)

    return jloss, tloss


def test_sp_train_steps_match_the_jax_train_step():
    _meshes()
    jm, tm, state = _pair(True)
    jloss, tloss = _loss_fns()
    jopt = paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                  parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                              parameters=tm.parameters())
    jstep = JTrainStep(jm, jloss, jopt, n_model_inputs=1)
    tstep = pt.jit.TrainStep(tm, tloss, topt, n_model_inputs=1)
    ids, nsp = _batch(2)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids),
                      paddle.to_tensor(nsp))) for _ in range(3)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids),
                      torch.from_numpy(nsp))) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    jparams = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        # three AdamW steps of lr 1e-3 from the same weights
        np.testing.assert_allclose(v.numpy(), jparams[k], rtol=1e-4,
                                   atol=5e-5, err_msg=k)
        assert not np.array_equal(v.numpy(), state[k]) or "bias" in k, k


def test_classification_head_and_configs():
    jm = jmodels.ErnieForSequenceClassification(jmodels.ErnieModel(**CFG),
                                                num_classes=3)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = pt.models.ErnieForSequenceClassification(
        pt.models.ErnieModel(**CFG), num_classes=3)
    load_numpy_state(tm, state)
    jm.eval()
    tm.eval()
    ids, _ = _batch(3)
    ids = ids[:, :64]
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for name in ("ernie_base", "ernie_large", "bert_base", "bert_large"):
        assert getattr(pt.models, name) is not None
    assert pt.models.bert_base is pt.models.ernie_base


@pytest.mark.parametrize("layer", ["ErnieModel", "ErnieEmbeddings",
                                   "ErnieForPretraining"])
def test_tensor_parallelism_raises_naming_the_distributed_slice(layer):
    """use_mp=True no longer raises (the name is the test's since the
    slice that raised here): without a process world of mp > 1 the
    mp_layers compute the dense layers, as the reference's GSPMD regime
    does, so the reference's use_mp model carries over by name and gives
    the same outputs within 1e-5."""
    paddle.seed(0)
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    if layer == "ErnieModel":
        jm = jmodels.ErnieModel(**CFG, use_mp=True)
        tm = pt.models.ErnieModel(**CFG, use_mp=True)
    elif layer == "ErnieEmbeddings":
        from paddle_tpu.models.ernie import ErnieEmbeddings
        jm = ErnieEmbeddings(256, 128, use_mp=True)
        tm = pt.models.ErnieEmbeddings(256, 128, use_mp=True)
    else:
        jm = jmodels.ErnieForPretraining(
            jmodels.ErnieModel(**CFG, use_mp=True), use_mp=True)
        tm = pt.models.ErnieForPretraining(
            pt.models.ErnieModel(**CFG, use_mp=True), use_mp=True)
    load_numpy_state(tm, {k: np.asarray(v._value)
                          for k, v in jm.state_dict().items()})
    jm.eval()                       # the embeddings' default dropout
    tm.eval()
    want = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


# the flagship as bench.py trains it, at its CPU configuration
# (bench.py:196-199): ErnieForPretraining without sp, 8 x 64 tokens
FLAGSHIP = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=512,
                hidden_dropout_prob=0.0)
FB, FS, FSTEPS = 8, 64, 5


def _flagship_pair(amp):
    """Both packages' flagship TrainStep (bench.py:201-210) from one JAX
    checkpoint."""
    from paddle_tpu_torch.utils.bench import flagship_step
    paddle.seed(0)
    jm = jmodels.ErnieForPretraining(jmodels.ErnieModel(**FLAGSHIP))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    jloss, _ = _loss_fns()
    jstep = JTrainStep(jm, jloss, paddle.optimizer.AdamW(
        parameters=jm.parameters(), learning_rate=1e-4), amp_dtype=amp,
        n_model_inputs=1)
    tstep = flagship_step(pt, FLAGSHIP)
    tstep.amp_dtype = amp
    load_numpy_state(tstep.model, state)
    return jstep, tstep


def _flagship_batches(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, FLAGSHIP["vocab_size"], (FSTEPS, FB, FS)).astype(
        np.int32)
    nsp = rng.integers(0, 2, (FSTEPS, FB)).astype(np.int32)
    return ids, nsp


@pytest.mark.parametrize("amp,rtol", [(None, 1e-4), ("bfloat16", 2e-2)])
def test_flagship_run_matches_the_jax_run(amp, rtol):
    jstep, tstep = _flagship_pair(amp)
    ids, nsp = _flagship_batches()
    want = np.asarray(jstep.run(paddle.to_tensor(ids), paddle.to_tensor(ids),
                                paddle.to_tensor(nsp))._value, np.float32)
    got = tstep.run(torch.from_numpy(ids), torch.from_numpy(ids),
                    torch.from_numpy(nsp)).float().numpy()
    # fp32: summation order only; bf16 AMP: both round every activation,
    # logit and the loss to bf16 (2^-8), at different places
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]
    assert tstep.optimizer._step_count == FSTEPS


def test_flagship_run_is_the_loop_of_calls():
    """On the CPU run() is bit-equal to the same steps through __call__."""
    _, a = _flagship_pair("bfloat16")
    _, b = _flagship_pair("bfloat16")
    ids, nsp = _flagship_batches(1)
    calls = [a(torch.from_numpy(i), torch.from_numpy(i), torch.from_numpy(n))
             for i, n in zip(ids, nsp)]
    span = b.run(torch.from_numpy(ids), torch.from_numpy(ids),
                 torch.from_numpy(nsp))
    assert torch.equal(span, torch.stack(calls))
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k


def test_flagship_cost_analysis_counts_the_formulas_products():
    """cost_analysis counts the products the step runs: bench.py's formula
    (:258-262) less what it counts that no product computes, the position
    and token-type lookups, and the pooler and NSP products at every token
    where the model applies them to the first only."""
    from paddle_tpu_torch.utils.bench import flagship_flops_per_sample
    _, tstep = _flagship_pair("bfloat16")
    ids, nsp = _flagship_batches()
    cost = tstep.cost_analysis(torch.from_numpy(ids[0]),
                               torch.from_numpy(ids[0]),
                               torch.from_numpy(nsp[0]))
    net = tstep.model
    formula = flagship_flops_per_sample(net, FS) * FB
    emb, h = net.ernie.embeddings, FLAGSHIP["hidden_size"]
    lookups = emb.position_embeddings.weight.numel() + \
        emb.token_type_embeddings.weight.numel()
    first_token = net.ernie.pooler.weight.numel() + net.nsp.weight.numel()
    products = formula - 6 * FB * (lookups * FS + first_token * (FS - 1))
    assert cost["flops"] == products, (cost["flops"], products, formula)
    assert cost["bytes_accessed"] is None
    assert 0.85 < cost["flops"] / formula < 0.9  # 6·S·(512+2)·h of lookups
    assert tstep.optimizer._step_count == 0
