"""A conv net of the port against the reference's on the CPU, as
`tests/test_torch_vision_models.py` checks them: the net built in JAX from
one seed and carried across by name; in training mode (batch statistics)
the outputs within 5e-3 relative L2 and every running statistic within
1e-3 (1 + |ref|); in eval mode, on seeded running statistics, the outputs
and every parameter's gradient of sum(out * g) within 1e-4 (1 + |ref|).
A net may return a list of outputs (GoogLeNet, PP-YOLOE). Dropout layers
stay in eval mode in the training pass."""
import numpy as np
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu_torch import nn as pt_nn
from paddle_tpu_torch.utils import load_numpy_state
from torch_parity import dev, state_of

TOL = 1e-4
TRAIN_OUT_TOL = 5e-3
TRAIN_STAT_TOL = 1e-3


def _list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def statistics(net, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0.5, 1.5, tuple(b.shape)).astype(np.float32)
            for k, b in sorted(net.named_buffers())}


def check_convnet(make_ref, make_port, x, tol=TOL):
    """make_ref() / make_port() build the same net in each package; x is
    the numpy input."""
    paddle.seed(0)
    j = make_ref()
    t = make_port()
    state = state_of(j)
    assert sorted(t.state_dict()) == sorted(state)
    load_numpy_state(t, state)
    rng = np.random.default_rng(1)

    # training mode: batch statistics, running statistics written; the
    # dropouts in eval mode (their draws differ between the packages and
    # are held to the reference in test_torch_nn_functional.py)
    for net, drop in ((j, paddle.nn.Dropout), (t, pt_nn.Dropout)):
        for layer in net.sublayers():
            if isinstance(layer, drop):
                layer.eval()
    train = [o.numpy() for o in _list(j(paddle.to_tensor(x)))]
    with torch.no_grad():
        got = [o.numpy() for o in _list(t(torch.from_numpy(x)))]
    for a, b in zip(got, train):
        assert rel_l2(a, b) <= TRAIN_OUT_TOL
    jbufs = dict(j.named_buffers())
    tbufs = dict(t.named_buffers())
    assert sorted(jbufs) == sorted(tbufs)
    for k, b in jbufs.items():
        assert dev(tbufs[k].numpy(), np.asarray(b._value)) <= TRAIN_STAT_TOL

    # eval mode on seeded statistics: outputs and every gradient
    for k, v in statistics(j).items():
        jbufs[k]._value = jnp.asarray(v)
        with torch.no_grad():
            tbufs[k].copy_(torch.from_numpy(v))
    j.eval()
    t.eval()
    jout = _list(j(paddle.to_tensor(x)))
    tout = _list(t(torch.from_numpy(x)))
    gs = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
          for o in jout]
    for a, b in zip(tout, jout):
        assert dev(a.detach().numpy(), b.numpy()) <= tol
    sum(paddle.sum(o * paddle.to_tensor(g)) for o, g in zip(jout, gs)) \
        .backward()
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(tout, gs)) \
        .backward()
    jp = dict(j.named_parameters())
    for k, p in t.named_parameters():
        assert dev(p.grad.numpy(), jp[k].gradient()) <= tol, k
    return j, t
