"""The port's loss, gradient clipping and optimizers against the JAX
package's, from the same seeded numpy inputs, in fp32 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt

# fp32 on both sides; the two differ in summation order only
TOL = 1e-5

N, C = 12, 7
CASES = {
    "mean": dict(),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "ignore_index": dict(ignore_index=3),
    "weight": dict(weight=True),
    "weight_ignore_none": dict(weight=True, ignore_index=2,
                               reduction="none"),
    "smoothing": dict(label_smoothing=0.1),
    "column_labels_none": dict(column=True, reduction="none"),
    "no_softmax": dict(use_softmax=False, probs=True),
    "soft": dict(soft_label=True),
    "soft_weight_smoothing": dict(soft_label=True, weight=True,
                                  label_smoothing=0.2),
}


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _inputs(seed, case):
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, C).astype(np.float32) * 3
    if case.get("probs"):
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if case.get("soft_label"):
        label = rng.rand(N, C).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.randint(0, C, (N, 1) if case.get("column") else (N,))
    weight = rng.rand(C).astype(np.float32) + 0.5
    return logits, label, weight


@pytest.mark.parametrize("name", sorted(CASES))
def test_cross_entropy_matches_the_jax_package(name):
    case = CASES[name]
    logits, label, weight = _inputs(len(name), case)
    kw = {k: v for k, v in case.items()
          if k in ("reduction", "ignore_index", "label_smoothing",
                   "soft_label", "use_softmax")}
    want = JF.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label),
        weight=paddle.to_tensor(weight) if case.get("weight") else None,
        **kw).numpy()
    got = tnn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label),
        weight=torch.from_numpy(weight) if case.get("weight") else None,
        **kw)
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_cross_entropy_loss_layer_and_its_gradient():
    logits, label, _ = _inputs(0, {})
    layer = jnn.CrossEntropyLoss(ignore_index=1)
    want = layer(paddle.to_tensor(logits), paddle.to_tensor(label)).numpy()
    t = torch.from_numpy(logits).requires_grad_()
    got = tnn.CrossEntropyLoss(ignore_index=1)(t, torch.from_numpy(label))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL)
    got.backward()
    # d/dlogits of the mean loss: (softmax - onehot) / n_kept, 0 on ignored
    keep = label != 1
    ref = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ref[np.arange(N), label] -= 1
    ref = ref * keep[:, None] / keep.sum()
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4, atol=TOL)


SHAPES = [(6, 5), (5,), (3, 4, 2)]


def _params_grads(seed):
    rng = np.random.RandomState(seed)
    values = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 0.3 for s in SHAPES]
             for _ in range(3)]
    return values, grads


def _clips(kind):
    if kind is None:
        return None, None
    cls, arg = {"value": ("ClipGradByValue", 0.2),
                "norm": ("ClipGradByNorm", 0.5),
                "global_norm": ("ClipGradByGlobalNorm", 1.0)}[kind]
    return getattr(jnn, cls)(arg), getattr(tnn, cls)(arg)


def _make(name, jclip, tclip):
    if name == "SGD":
        return (jopt.SGD(learning_rate=0.1, weight_decay=0.01,
                         grad_clip=jclip),
                topt.SGD(learning_rate=0.1, weight_decay=0.01,
                         grad_clip=tclip), {})
    kw = dict(learning_rate=0.01, beta1=0.8, beta2=0.95, epsilon=1e-6)
    wd = 0.05 if name == "AdamW" else 0.01
    return (getattr(jopt, name)(weight_decay=wd, grad_clip=jclip, **kw),
            getattr(topt, name)(weight_decay=wd, grad_clip=tclip, **kw),
            {"moment1": None, "moment2": None})


CLIPS = [None, "value", "norm", "global_norm"]
OPTIMIZERS = ["Adam", "AdamW", "SGD"]


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_functional_update_matches_the_jax_package(name, clip):
    values, grads = _params_grads(10 * OPTIMIZERS.index(name)
                                  + CLIPS.index(clip))
    jclip, tclip = _clips(clip)
    jo, to, slot_names = _make(name, jclip, tclip)
    jv = [jnp.asarray(v) for v in values]
    js = [{k: jnp.zeros_like(v) for k in slot_names} for v in jv]
    tv = [torch.from_numpy(v.copy()) for v in values]
    ts = [{k: torch.zeros_like(v) for k in slot_names} for v in tv]
    for step, g in enumerate(grads, start=1):
        jv, js = jo.functional_update(jv, [jnp.asarray(x) for x in g], js,
                                      jnp.asarray(jo.get_lr(), jnp.float32),
                                      jnp.asarray(step, jnp.float32))
        out, ts_out = to.functional_update(
            tv, [torch.from_numpy(x) for x in g], ts, to.get_lr(), step)
        # the port updates in place and returns the same tensors
        assert all(a is b for a, b in zip(out, tv))
        assert all(a is b for a, b in zip(ts_out, ts))
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    for a, b in zip(ts, js):
        for k in slot_names:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clip_classes_match_the_jax_package(clip):
    _, grads = _params_grads(7)
    jclip, tclip = _clips(clip)
    want = jclip([(None, jnp.asarray(g)) for g in grads[0]])
    got = tclip([(None, torch.from_numpy(g)) for g in grads[0]])
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=1e-7)


def test_eager_step_and_state_dict():
    values, grads = _params_grads(3)
    params = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    opt = topt.AdamW(learning_rate=0.01, parameters=params)
    ref = [torch.from_numpy(v.copy()) for v in values]
    ref_slots = opt.init_state(ref)
    for step, g in enumerate(grads, start=1):
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        opt.clear_grad()
        opt.functional_update(ref, [torch.from_numpy(x) for x in g],
                              ref_slots, 0.01, step)
    assert all(p.grad is None for p in params)
    for p, r in zip(params, ref):
        np.testing.assert_array_equal(p.detach().numpy(), r.numpy())
    sd = opt.state_dict()
    assert sd["step_count"] == 3
    assert sorted(sd["accumulators"]) == ["0", "1", "2"]
    assert sorted(sd["accumulators"]["0"]) == ["moment1", "moment2"]
    fresh = topt.AdamW(learning_rate=0.01, parameters=params)
    fresh.set_state_dict(sd)
    assert fresh._step_count == 3
    np.testing.assert_array_equal(
        fresh._accumulators[id(params[1])]["moment2"].numpy(),
        sd["accumulators"]["1"]["moment2"])
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5


def test_amp_casts_white_list_inputs_only_inside_auto_cast():
    x = torch.randn(2, 4)
    w = torch.randn(4, 3)
    assert tnn.functional.linear(x, w).dtype == torch.float32
    with pt.amp.auto_cast(dtype="bfloat16"):
        assert pt.amp.amp_enabled()
        assert tnn.functional.linear(x, w).dtype == torch.bfloat16
        assert pt.amp.maybe_cast(torch.arange(3)).dtype == torch.int64
    assert not pt.amp.amp_enabled()
