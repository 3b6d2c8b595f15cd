"""Helpers shared by the port's parity tests of its sequence and vision
slice: seeded inputs, the (1 + |ref|) deviation, a reference layer and
its port built with the same weights, and one call of both compared in
its outputs and its gradients."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.utils import load_numpy_state


def n_(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def dev(got, want):
    """max |got - want| / (1 + |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size == 0:
        return 0.0
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def state_of(jlayer):
    return {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}


def pair(make, jmod=jnn, tmod=tnn):
    """(reference layer, port layer) built by make(module), the port's
    carrying the reference's weights under the same names."""
    paddle.seed(0)
    j = make(jmod)
    t = make(tmod)
    state = state_of(j)
    assert list(t.state_dict()) == list(state)
    load_numpy_state(t, state)
    return j, t


def leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in leaves(v)]
    return [] if x is None else [x]


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def run_both(j, t, inputs, call=None, grads=True, seed=1, tol=1e-5,
             grad_tol=None):
    """Run j and t on the same numpy inputs (other values passed as they
    are); every output leaf within tol (1 + |ref|) and, with grads, the
    gradients of sum(leaf * g) over the leaves for every parameter and
    float input within grad_tol (tol by default)."""
    grad_tol = tol if grad_tol is None else grad_tol
    call = call or (lambda layer, *a: layer(*a))

    def wants_grad(a):
        return grads and isinstance(a, np.ndarray) and a.dtype.kind == "f"

    jin = [paddle.to_tensor(a, stop_gradient=not wants_grad(a))
           if isinstance(a, np.ndarray) else a for a in inputs]
    tin = [torch.tensor(a, requires_grad=wants_grad(a))
           if isinstance(a, np.ndarray) else a for a in inputs]
    jout, tout = leaves(call(j, *jin)), leaves(call(t, *tin))
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert dev(as_np(b), as_np(a)) <= tol
    if not grads:
        return jout, tout
    rng = np.random.default_rng(seed)
    gs = [rng.standard_normal(tuple(a.shape)).astype(np.float32)
          for a in jout]
    sum(paddle.sum(a * paddle.to_tensor(g))
        for a, g in zip(jout, gs)).backward()
    sum((b * torch.from_numpy(g)).sum() for b, g in zip(tout, gs)).backward()
    jp = dict(j.named_parameters())
    for name, p in t.named_parameters():
        if p.grad is None:
            assert jp[name].grad is None or not np.any(
                jp[name].gradient()), name
            continue
        assert dev(p.grad.numpy(), jp[name].gradient()) <= grad_tol, name
    for a, b in zip(jin, tin):
        if isinstance(b, torch.Tensor) and b.requires_grad:
            assert dev(b.grad.numpy(), a.gradient()) <= grad_tol
    return jout, tout
