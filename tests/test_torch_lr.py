"""The port's lr schedulers against the JAX package's: every scheduler of
`paddle_tpu/optimizer/lr.py`, stepped 60 times in both packages (the
plateau scheduler fed the same metrics), gives the same learning rates to
1e-12, and an optimizer reads a scheduler through `get_lr`."""
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
import paddle_tpu_torch as pt
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 60

# (name, constructor arguments): one or more per scheduler
CASES = [
    ("NoamDecay", dict(d_model=512, warmup_steps=10, learning_rate=2.0)),
    ("PiecewiseDecay", dict(boundaries=[5, 20, 40],
                            values=[0.1, 0.05, 0.01, 0.001])),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.2)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=25,
                             end_lr=0.001, power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=25,
                             end_lr=0.001, power=1.0, cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=10, start_lr=0.0,
                          end_lr=0.1)),
    ("ExponentialDecay", dict(learning_rate=0.3, gamma=0.93)),
    ("MultiStepDecay", dict(learning_rate=0.3, milestones=[10, 30, 45],
                            gamma=0.5)),
    ("StepDecay", dict(learning_rate=0.3, step_size=7, gamma=0.7)),
    ("LambdaDecay", dict(learning_rate=0.2,
                         lr_lambda=lambda e: 0.95 ** e + 0.01 * (e % 3))),
    ("MultiplicativeDecay", dict(learning_rate=0.2,
                                 lr_lambda=lambda e: 0.97)),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=25,
                                  eta_min=0.001)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=STEPS)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=8)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=5, step_size_down=9, mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=6, mode="exp_range", exp_gamma=0.97)),
]


def _trace(mod, name, kw):
    sched = getattr(mod, name)(**kw)
    out = [sched.get_lr(), sched()]
    for _ in range(STEPS):
        sched.step()
        out += [sched.get_lr(), sched.last_lr]
    return out, sched


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_scheduler_matches_the_jax_package(name, kw):
    want, jsched = _trace(jlr, name, kw)
    got, tsched = _trace(tlr, name, kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert tsched.state_dict() == jsched.state_dict()


def test_linear_warmup_around_a_scheduler():
    def trace(mod):
        inner = mod.CosineAnnealingDecay(learning_rate=0.1, T_max=30)
        sched = mod.LinearWarmup(inner, warmup_steps=8, start_lr=0.001,
                                 end_lr=0.1)
        out = []
        for _ in range(STEPS):
            sched.step()
            out.append(sched.last_lr)
        return out, sched.state_dict()

    (got, tstate), (want, jstate) = trace(tlr), trace(jlr)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert tstate["inner"] == jstate["inner"]


@pytest.mark.parametrize("mode,threshold_mode,metric_dtype", [
    ("min", "rel", "float"), ("max", "abs", "tensor")])
def test_reduce_on_plateau_matches_the_jax_package(mode, threshold_mode,
                                                   metric_dtype):
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 15),
                              0.5 + 0.01 * rng.standard_normal(45)])
    if mode == "max":
        metrics = -metrics
    kw = dict(learning_rate=0.1, mode=mode, factor=0.5, patience=3,
              threshold=1e-3, threshold_mode=threshold_mode, cooldown=2,
              min_lr=1e-4)
    js, ts = jlr.ReduceOnPlateau(**kw), tlr.ReduceOnPlateau(**kw)
    got, want = [], []
    for m in metrics:
        tm = torch.tensor(m) if metric_dtype == "tensor" else float(m)
        want.append(js.step(float(m)))
        got.append(ts.step(tm))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert min(got) < 0.1          # the plateau lowered the rate
    assert ts.step() == got[-1]    # no metric: no change


def test_optimizer_reads_its_scheduler():
    pt.set_device("cpu")
    sched = tlr.StepDecay(learning_rate=0.5, step_size=2, gamma=0.1)
    opt = pt.optimizer.SGD(learning_rate=1.0,
                           parameters=[torch.nn.Parameter(torch.ones(2))])
    opt.set_lr_scheduler(sched)
    lrs = []
    for _ in range(5):
        lrs.append(opt.get_lr())
        sched.step()
    np.testing.assert_allclose(lrs, [0.5, 0.5, 0.05, 0.05, 0.005],
                               rtol=1e-12)
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
