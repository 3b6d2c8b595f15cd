"""The autograd surface of the Tensor API, on torch.autograd.

Counterpart of the public part of `paddle_tpu/core/autograd.py`
(`no_grad`, `enable_grad`, `set_grad_enabled`, `is_grad_enabled`,
`backward`) and of `paddle.grad` (`paddle_tpu/__init__.py:69`). The
reference records its own tape (nodes, cached VJPs, a fused backward
walk); the port's ops are torch ops, so torch's autograd records them and
none of that tape is copied.
"""
from __future__ import annotations

import torch

from .tensor import Tensor, to_torch, wrap_tree

_DISABLE = torch._C.DisableTorchFunctionSubclass


class no_grad(torch.no_grad):
    """Context manager and decorator (`@no_grad()` or `@no_grad`):
    nothing inside is recorded for backward."""


class enable_grad(torch.enable_grad):
    pass


set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def backward(root, grad=None, retain_graph: bool = False):
    """Gradients of `root` into the `.grad` of every leaf it depends on
    (`Tensor.backward`)."""
    if isinstance(root, Tensor):
        return root.backward(grad, retain_graph)
    torch.autograd.backward(root, to_torch(grad), retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    without touching any `.grad`; a list with one entry per input (None
    for an unused one with allow_unused). With create_graph the results
    are on the autograd graph, for higher-order gradients."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    gos = [None] * len(outs) if grad_outputs is None else \
        list(grad_outputs) if isinstance(grad_outputs, (list, tuple)) \
        else [grad_outputs]
    outs = [to_torch(o) for o in outs]
    # a missing cotangent is ones, as in the reference
    gos = [torch.ones_like(o) if g is None else to_torch(g)
           for o, g in zip(outs, gos)]
    with _DISABLE():       # the inputs themselves, not aliases of them
        gs = torch.autograd.grad(
            outs, ins, grad_outputs=gos,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=allow_unused)
    return [None if g is None else wrap_tree(to_torch(g)) for g in gs]

