"""The port's optimizer zoo (Momentum, Adamax, Lamb, Adagrad, RMSProp,
Adadelta, LarsMomentum) against the JAX package's, on the CPU.

One seeded numpy state (parameters, and three steps of gradients) goes
through both packages' eager `step()`: with a float weight decay,
`L2Decay`, `L1Decay` (which the reference reads as an L2 coefficient:
Queue 3) and a global-norm grad clip, over parameters of which one has a
`ParamAttr` learning-rate scale of 0.5 (`optimize_attr`) and one has
`need_clip=False`. Parameters and slots agree within 1e-5 (1e-6 absolute
on the slots); `state_dict` has the reference's keys and slot names and
resumes the same trajectory; each rule also runs through
`functional_update` with the lr and t as device-style 0-d tensors (the
`TrainStep` form) and under `GradScaler`'s fused gated step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.core import flags as jflags
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import flags as tflags

TOL = 1e-5
SHAPES = [(6, 5), (5,), (3, 4, 2), (4,)]
NAMES = ["w0", "b0", "w1", "norm.bias"]


def _state(seed):
    rng = np.random.default_rng(seed)
    values = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.3
              for s in SHAPES] for _ in range(3)]
    return values, grads


def _params(pkg, values):
    out = []
    for v, name in zip(values, NAMES):
        if pkg is jp:
            p = jp.Parameter(v.copy())
        else:
            p = pt.Parameter(torch.from_numpy(v.copy()))
        p.name = name
        out.append(p)
    out[1].optimize_attr["learning_rate"] = 0.5     # a ParamAttr lr scale
    out[2].need_clip = False
    return out


def _decay(pkg, kind):
    return {None: None, "float": 0.02,
            "L2Decay": pkg.optimizer.L2Decay(0.02) if kind == "L2Decay"
            else None,
            "L1Decay": pkg.optimizer.L1Decay(0.02) if kind == "L1Decay"
            else None}[kind]


def _make(pkg, name, params, decay, clip):
    o = pkg.optimizer
    gc = pkg.nn.ClipGradByGlobalNorm(1.0) if clip else None
    wd = _decay(pkg, decay)
    if name == "Momentum":
        return o.Momentum(0.1, 0.9, params, weight_decay=wd, grad_clip=gc)
    if name == "Momentum_nesterov":
        return o.Momentum(0.1, 0.8, params, use_nesterov=True,
                          weight_decay=wd, grad_clip=gc)
    if name == "Adamax":
        return o.Adamax(0.05, 0.8, 0.95, 1e-6, params, weight_decay=wd,
                        grad_clip=gc)
    if name == "Lamb":
        return o.Lamb(0.05, 0.02 if decay else 0.0, 0.8, 0.95, 1e-6, params,
                      grad_clip=gc,
                      exclude_from_weight_decay_fn=lambda p: p.name.endswith(
                          "bias"))
    if name == "Adagrad":
        return o.Adagrad(0.1, 1e-6, params, weight_decay=wd, grad_clip=gc,
                         initial_accumulator_value=0.1)
    if name == "RMSProp":
        return o.RMSProp(0.05, 0.9, 1e-6, parameters=params,
                         weight_decay=wd, grad_clip=gc)
    if name == "RMSProp_centered":
        return o.RMSProp(0.05, 0.9, 1e-6, 0.5, True, params,
                         weight_decay=wd, grad_clip=gc)
    if name == "Adadelta":
        return o.Adadelta(1.0, 1e-6, 0.9, params, weight_decay=wd,
                          grad_clip=gc)
    if name == "LarsMomentum":
        return o.LarsMomentum(0.1, 0.9, 0.01, 0.02 if decay else 0.0, params,
                              grad_clip=gc,
                              exclude_from_weight_decay=["bias"])
    raise KeyError(name)


RULES = ["Momentum", "Momentum_nesterov", "Adamax", "Lamb", "Adagrad",
         "RMSProp", "RMSProp_centered", "Adadelta", "LarsMomentum"]
SLOTS = {"Momentum": ["velocity"], "Momentum_nesterov": ["velocity"],
         "Adamax": ["inf_norm", "moment"], "Lamb": ["moment1", "moment2"],
         "Adagrad": ["moment"], "RMSProp": ["mean_square", "momentum"],
         "RMSProp_centered": ["mean_grad", "mean_square", "momentum"],
         "Adadelta": ["avg_squared_grad", "avg_squared_update"],
         "LarsMomentum": ["velocity"]}


def _set_grads(jparams, tparams, grads):
    for jpar, tpar, g in zip(jparams, tparams, grads):
        jpar.grad = jp.to_tensor(g)._value
        tpar.grad = torch.from_numpy(g.copy())


def _check(jparams, tparams, jo, to, name):
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=f"{name} {a.name}")
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert tsd["step_count"] == jsd["step_count"]
    assert sorted(tsd["accumulators"]) == sorted(jsd["accumulators"])
    for pname, slots in jsd["accumulators"].items():
        assert sorted(tsd["accumulators"][pname]) == sorted(slots) == \
            SLOTS[name]
        for k, v in slots.items():
            np.testing.assert_allclose(tsd["accumulators"][pname][k],
                                       np.asarray(v), rtol=TOL, atol=1e-6,
                                       err_msg=f"{name} {pname}.{k}")


# Lamb and LARS take their own float decay, not a decay object
_STEP_CASES = [(name, decay, clip) for name in RULES
               for decay, clip in ((None, False), ("float", True),
                                   ("L2Decay", False), ("L1Decay", True))
               if decay in (None, "float")
               or name not in ("Lamb", "LarsMomentum")]


@pytest.mark.parametrize("name,decay,clip", _STEP_CASES)
def test_three_steps_match_the_reference(name, decay, clip):
    values, grads = _state(RULES.index(name))
    jparams, tparams = _params(jp, values), _params(pt, values)
    jo = _make(jp, name, jparams, decay, clip)
    to = _make(pt, name, tparams, decay, clip)
    for g in grads:
        _set_grads(jparams, tparams, g)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        _check(jparams, tparams, jo, to, name)


@pytest.mark.parametrize("name", RULES)
def test_state_dict_round_trip_resumes_the_trajectory(name):
    values, grads = _state(7)
    jparams, tparams = _params(jp, values), _params(pt, values)
    jo, to = _make(jp, name, jparams, "float", False), \
        _make(pt, name, tparams, "float", False)
    for g in grads[:2]:
        _set_grads(jparams, tparams, g)
        jo.step()
        to.step()
    sd = to.state_dict()
    assert sorted(sd["accumulators"]) == sorted(NAMES)
    fresh_params = [pt.Parameter(p.detach().clone()) for p in tparams]
    for fp, p in zip(fresh_params, tparams):
        fp.name, fp.optimize_attr, fp.need_clip = p.name, p.optimize_attr, \
            p.need_clip
    fresh = _make(pt, name, fresh_params, "float", False)
    fresh.set_state_dict(sd)
    assert fresh._step_count == 2
    for opt, ps in ((to, tparams), (fresh, fresh_params)):
        for p, g in zip(ps, grads[2]):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    _set_grads(jparams, tparams, grads[2])
    jo.step()
    for a, b in zip(fresh_params, tparams):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    _check(jparams, fresh_params, jo, fresh, name)


@pytest.mark.parametrize("name", RULES)
def test_functional_update_with_device_scalars(name):
    """The TrainStep form: lr and t as 0-d f32 tensors give the eager
    step's values."""
    values, grads = _state(11)
    tparams = _params(pt, values)
    to = _make(pt, name, tparams, "float", True)
    ref = [torch.from_numpy(v.copy()) for v in values]
    slots = to.init_state(tparams)
    lr = torch.tensor(to.get_lr())
    for step, g in enumerate(grads, start=1):
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x.copy())
        to.step()
        to.functional_update(ref, [torch.from_numpy(x.copy()) for x in g],
                             slots, lr, torch.tensor(float(step)),
                             params_meta=tparams)
    for a, b in zip(ref, tparams):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_l1_decay_acts_as_an_l2_term():
    """The reference reads only `_coeff` (optimizer.py:45): L1Decay(c)
    adds c * p to the gradient, not c * sign(p). Kept (Queue 3)."""
    values, grads = _state(3)
    outs = []
    for decay in ("L1Decay", "L2Decay"):
        tparams = _params(pt, values)
        to = _make(pt, "Momentum", tparams, decay, False)
        for p, g in zip(tparams, grads[0]):
            p.grad = torch.from_numpy(g.copy())
        to.step()
        outs.append([p.detach().numpy() for p in tparams])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(params=[True, False], ids=["fused", "legacy"])
def fused(request):
    saved = jflags.flag("amp_fused_update"), tflags.flag("amp_fused_update")
    jflags.set_flags({"amp_fused_update": request.param})
    tflags.set_flags({"amp_fused_update": request.param})
    yield request.param
    jflags.set_flags({"amp_fused_update": saved[0]})
    tflags.set_flags({"amp_fused_update": saved[1]})


@pytest.mark.parametrize("name", ["Momentum", "Lamb", "LarsMomentum"])
def test_grad_scaler_step_with_an_inf(fused, name):
    """Under `GradScaler.step` (the gated step when fused): a good step, a
    step with an inf gradient (skipped, the parameters and slots
    bit-unchanged, the scale halved), a good step; against the
    reference's scaler on the same optimizer."""
    values, grads = _state(5)
    jparams, tparams = _params(jp, values), _params(pt, values)
    jo, to = _make(jp, name, jparams, "float", False), \
        _make(pt, name, tparams, "float", False)
    js = jp.amp.GradScaler(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
    ts = pt.amp.GradScaler(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
    for step, g in enumerate(grads):
        g = [x.copy() for x in g]
        if step == 1:
            g[2].flat[0] = np.inf
        s = ts.get_loss_scaling()
        assert s == js.get_loss_scaling()
        _set_grads(jparams, tparams, [(x * np.float32(s)).astype(np.float32)
                                      for x in g])
        before = [p.detach().clone() for p in tparams]
        js.step(jo)
        ts.step(to)
        if step == 1:
            for p, b in zip(tparams, before):
                assert torch.equal(p.detach(), b)
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       rtol=TOL, atol=TOL)
    assert ts.state_dict() == js.state_dict()
    assert to._step_count == jo._step_count == 2
