"""The port's `amp.GradScaler` + `Optimizer.step(inv_scale)` against the JAX
package's `paddle_tpu.amp.GradScaler` and fused optimizer step.

One seeded numpy state (parameters, and gradients as a scaled loss's
backward would leave them) goes through both packages on SGD and AdamW,
with FLAGS_amp_fused_update on (the gated device step) and off (the
legacy unscale_-then-step path). Parameters agree within 1e-6; the scale
and both streak counters exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.core import flags as jflags
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import flags as tflags

TOL = 1e-6
SHAPES = [(5, 3), (7,), (2, 4)]


@pytest.fixture(params=[True, False], ids=["fused", "legacy"])
def fused(request):
    saved = jflags.flag("amp_fused_update"), tflags.flag("amp_fused_update")
    jflags.set_flags({"amp_fused_update": request.param})
    tflags.set_flags({"amp_fused_update": request.param})
    yield request.param
    jflags.set_flags({"amp_fused_update": saved[0]})
    tflags.set_flags({"amp_fused_update": saved[1]})


def _values(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


class Pair:
    """The same parameters, optimizer and scaler in both packages."""

    def __init__(self, opt_name, seed=0, clip=None, **scaler_kw):
        self.values = _values(seed)
        self.jparams = [jp.Parameter(v.copy()) for v in self.values]
        self.tparams = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                        for v in self.values]
        jclip = tclip = None
        if clip is not None:
            jclip = jp.nn.ClipGradByGlobalNorm(clip)
            tclip = pt.nn.ClipGradByGlobalNorm(clip)
        if opt_name == "SGD":
            kw = dict(learning_rate=0.1, weight_decay=0.01)
            self.jopt = jp.optimizer.SGD(parameters=self.jparams,
                                         grad_clip=jclip, **kw)
            self.topt = pt.optimizer.SGD(parameters=self.tparams,
                                         grad_clip=tclip, **kw)
        else:
            kw = dict(learning_rate=0.01, beta1=0.8, beta2=0.95,
                      epsilon=1e-6, weight_decay=0.05)
            self.jopt = jp.optimizer.AdamW(parameters=self.jparams,
                                           grad_clip=jclip, **kw)
            self.topt = pt.optimizer.AdamW(parameters=self.tparams,
                                           grad_clip=tclip, **kw)
        self.js = jp.amp.GradScaler(**scaler_kw)
        self.ts = pt.amp.GradScaler(**scaler_kw)

    def set_grads(self, grads):
        """Gradients as a scaled loss's backward leaves them: g * scale."""
        s = self.js.get_loss_scaling()
        assert s == self.ts.get_loss_scaling()
        for jparam, tparam, g in zip(self.jparams, self.tparams, grads):
            sg = (g * np.float32(s)).astype(np.float32)
            jparam.grad = jp.to_tensor(sg)._value
            tparam.grad = torch.from_numpy(sg.copy())

    def both(self, method, *args):
        getattr(self.js, method)(self.jopt, *args)
        getattr(self.ts, method)(self.topt, *args)

    def check(self):
        for a, b in zip(self.tparams, self.jparams):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       rtol=TOL, atol=TOL)
        assert self.ts.state_dict() == self.js.state_dict()
        assert self.topt._step_count == self.jopt._step_count


def _grads(rng, inf_at=None):
    g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    if inf_at is not None:
        g[inf_at].flat[0] = np.inf
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_scale_multiplies_the_loss_by_the_scale(dtype):
    js, ts = jp.amp.GradScaler(init_loss_scaling=1024.0), \
        pt.amp.GradScaler(init_loss_scaling=1024.0)
    loss = np.float32(1.7)
    want = js.scale(jp.to_tensor(np.asarray(loss, np.float32)))
    got = ts.scale(torch.tensor(loss).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().item(), float(want.numpy()),
                               rtol=1e-3)
    # the device scalar is cached until the scale changes
    first = ts._scale_arr
    ts.scale(torch.tensor(loss))
    assert ts._scale_arr is first
    off = pt.amp.GradScaler(enable=False)
    x = torch.tensor(3.0)
    assert off.scale(x) is x and off.get_loss_scaling() == 1.0


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_a_step_with_an_inf_leaves_params_slots_and_count(fused, opt_name):
    pair = Pair(opt_name, seed=1, decr_every_n_nan_or_inf=1,
                init_loss_scaling=8.0)
    rng = np.random.default_rng(2)
    pair.set_grads(_grads(rng))
    pair.both("step")                     # a good step first: slots exist
    pair.check()
    before = [p.detach().clone() for p in pair.tparams]
    slots = [{k: v.clone() for k, v in pair.topt._accumulators[id(p)].items()}
             for p in pair.tparams]
    t_before = None if pair.topt._t_arr is None else pair.topt._t_arr.clone()
    pair.set_grads(_grads(rng, inf_at=1))
    pair.both("step")
    for p, b, s in zip(pair.tparams, before, slots):
        assert torch.equal(p.detach(), b)                # bit-unchanged
        for k, v in pair.topt._accumulators[id(p)].items():
            assert torch.equal(v, s[k])
    if t_before is not None:
        assert torch.equal(pair.topt._t_arr, t_before)  # the device t too
    assert pair.topt._step_count == 1
    assert pair.ts.get_loss_scaling() == 4.0             # shrunk after 1
    pair.check()
    pair.set_grads(_grads(rng))            # the next step counts as step 2
    pair.both("step")
    assert pair.topt._step_count == 2
    pair.check()


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_unscale_then_clip_then_step_unscales_once(fused, opt_name):
    pair = Pair(opt_name, seed=3, init_loss_scaling=16.0)
    g = _grads(np.random.default_rng(4))
    pair.set_grads(g)
    pair.both("unscale_")
    for p, x in zip(pair.tparams, g):
        np.testing.assert_allclose(p.grad.numpy(), x, rtol=1e-7, atol=0)
    # the user's clip between unscale_ and step, then the step: no second
    # unscale
    for jparam, tparam in zip(pair.jparams, pair.tparams):
        jparam.grad = jparam.grad * 0.5
        tparam.grad = tparam.grad * 0.5
    pair.both("step")
    pair.check()
    ref = [torch.from_numpy(v.copy()) for v in pair.values]
    fresh = type(pair.topt)(parameters=[torch.nn.Parameter(r) for r in ref],
                            learning_rate=pair.topt.get_lr(),
                            weight_decay=pair.topt._weight_decay,
                            **({} if opt_name == "SGD" else dict(
                                beta1=0.8, beta2=0.95, epsilon=1e-6)))
    for p, x in zip(fresh._parameter_list, g):
        p.grad = torch.from_numpy(x * 0.5)
    fresh.step()
    for a, b in zip(pair.tparams, fresh._parameter_list):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_twelve_steps_with_infs_follow_the_reference(fused, opt_name):
    # grow every 3 good steps, shrink after 2 bad ones in a row; infs at
    # steps 4, 5 (two in a row: shrink), 9 (one: no shrink) and 12
    pair = Pair(opt_name, seed=5, clip=1.0, init_loss_scaling=64.0,
                incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    rng = np.random.default_rng(6)
    scales = []
    for step in range(1, 13):
        inf_at = {4: 0, 5: 2, 9: 1, 12: 0}.get(step)
        pair.set_grads(_grads(rng, inf_at))
        pair.both("step")
        pair.check()
        scales.append(pair.ts.get_loss_scaling())
    assert scales == [64.0, 64.0, 128.0, 128.0, 64.0, 64.0, 64.0, 128.0,
                      128.0, 128.0, 128.0, 128.0]
    assert pair.topt._step_count == 8


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_state_dict_cut_between_unscale_and_step(fused, opt_name):
    pair = Pair(opt_name, seed=7, init_loss_scaling=32.0,
                decr_every_n_nan_or_inf=2)
    rng = np.random.default_rng(8)
    pair.set_grads(_grads(rng))
    pair.both("step")
    pair.set_grads(_grads(rng, inf_at=2))
    pair.both("unscale_")
    jsd, tsd = pair.js.state_dict(), pair.ts.state_dict()
    assert tsd == jsd and tsd["found_inf"] is True
    for scaler, sd in ((jp.amp.GradScaler(), jsd),
                       (pt.amp.GradScaler(), tsd)):
        scaler.load_state_dict(sd)
        assert scaler.state_dict() == sd
    resumed = pt.amp.GradScaler()
    resumed.load_state_dict(tsd)
    pair.both("step")                     # skipped: found_inf carried over
    pair.check()
    assert pair.ts.state_dict()["decr_count"] == 1
    # the resumed scaler takes the same update from the same state
    resumed.update()
    assert resumed.state_dict() == pair.ts.state_dict()


def test_out_of_order_calls_raise_as_the_reference(fused):
    pair = Pair("SGD", seed=9)
    pair.set_grads(_grads(np.random.default_rng(10)))
    for scaler, opt in ((pair.js, pair.jopt), (pair.ts, pair.topt)):
        scaler.unscale_(opt)
        with pytest.raises(RuntimeError, match="already been called"):
            scaler.unscale_(opt)
    # a second optimizer keeps the round open: step() does not update()
    other = Pair("SGD", seed=11)
    other.set_grads(_grads(np.random.default_rng(12)))
    for scaler, opt, opt2 in ((pair.js, pair.jopt, other.jopt),
                              (pair.ts, pair.topt, other.topt)):
        scaler.unscale_(opt2)
        scaler.step(opt)
        with pytest.raises(RuntimeError, match="after step"):
            scaler.unscale_(opt)
        with pytest.raises(RuntimeError, match="step\\(\\) has already"):
            scaler.step(opt)
        scaler.step(opt2)                  # the round closes: update()
        assert scaler._opt_states == {}


def test_two_optimizers_on_one_scaler(fused):
    # one scaler over AdamW and SGD, an inf in the first one's gradients at
    # the middle step: the steps taken or skipped, the found_inf each sees
    # and when the scale moves all follow the reference
    a, b = Pair("AdamW", seed=13), Pair("SGD", seed=14)
    kw = dict(init_loss_scaling=16.0, decr_every_n_nan_or_inf=1)
    js, ts = jp.amp.GradScaler(**kw), pt.amp.GradScaler(**kw)
    a.js = b.js = js
    a.ts = b.ts = ts
    rng = np.random.default_rng(15)
    for inf in (False, True, False):
        a.set_grads(_grads(rng, inf_at=0 if inf else None))
        b.set_grads(_grads(rng))
        for pair in (a, b):
            pair.both("step")
            pair.check()
    assert ts.get_loss_scaling() == js.get_loss_scaling() < 16.0
    assert a.topt._step_count == 2
