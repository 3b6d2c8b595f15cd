"""nn.utils: parameter-vector helpers and the hook-based weight
reparametrisations.

Counterpart of `paddle_tpu/nn/utils/__init__.py`. `weight_norm` and
`spectral_norm` replace a layer's `weight` parameter by derived
parameters (`weight_g` / `weight_v`, `weight_orig`) and a forward
pre-hook that recomputes the effective weight from them before every
forward, so the optimizer trains the derived parameters. The effective
weight is a plain attribute of the layer, as in the reference (:46-57):
the parameter first leaves `_parameters`, since a torch module refuses a
plain tensor under a parameter's name. Spectral norm's power iteration
runs on the host from persistent u / v vectors (no gradient, as in the
reference's op); the division by sigma = u^T W v is differentiable.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Parameter
from ..clip import clip_grad_norm_  # noqa: F401


def parameters_to_vector(parameters, name=None):
    """The parameters' values flattened into one vector (no gradient
    link, as the reference builds it from the values)."""
    return torch.cat([p.detach().reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    off = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[off:off + n].reshape(p.shape).to(p.dtype))
        off += n


def _norm_except_dim(v, dim):
    """The L2 norm over every axis but `dim` (kept), in f32, cast back;
    dim=None: the whole norm."""
    if dim is None:
        return torch.sqrt(torch.sum(v.float() ** 2)).to(v.dtype)
    axes = [i for i in range(v.ndim) if i != dim]
    return torch.sqrt(torch.sum(v.float() ** 2, dim=axes,
                                keepdim=True)).to(v.dtype)


class _WeightNorm:
    def __init__(self, name, dim):
        self.name, self.dim = name, dim

    def compute_weight(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        return v * (g / _norm_except_dim(v, self.dim))

    def __call__(self, layer, inputs):
        object.__setattr__(layer, self.name, self.compute_weight(layer))


def weight_norm(layer, name="weight", dim=0):
    """w = g * v / ||v|| with g = ||w|| along `dim` (None: one norm)."""
    if name not in layer._parameters:
        raise ValueError(f"weight_norm: layer has no parameter {name!r}")
    for h in layer._forward_pre_hooks.values():
        if isinstance(h, _WeightNorm) and h.name == name:
            raise RuntimeError(f"weight_norm already applied to {name!r}")
    w = layer._parameters.pop(name)
    fn = _WeightNorm(name, dim)
    layer.register_parameter(name + "_g",
                             Parameter(_norm_except_dim(w.detach(), dim)))
    layer.register_parameter(name + "_v", Parameter(w.detach()))
    fn._handle = layer.register_forward_pre_hook(fn)
    fn(layer, None)          # the effective weight exists before a forward
    return layer


def remove_weight_norm(layer, name="weight"):
    for key, h in list(layer._forward_pre_hooks.items()):
        if isinstance(h, _WeightNorm) and h.name == name:
            w = h.compute_weight(layer).detach()
            del layer._forward_pre_hooks[key]
            del layer._parameters[name + "_g"]
            del layer._parameters[name + "_v"]
            layer.__dict__.pop(name, None)
            layer.register_parameter(name, Parameter(w))
            return layer
    raise ValueError(f"weight_norm of {name!r} not found in {layer}")


def _spectral_mat(w, dim):
    """Matricise with `dim` leading."""
    if dim != 0:
        w = w.permute([dim] + [i for i in range(w.ndim) if i != dim])
    return w.reshape(w.shape[0], -1)


def spectral_normalize(w, u, *, dim, n_power_iterations, eps):
    """(w / sigma, new u, new v): the power iteration on the host from u,
    then sigma = u^T W v on w's device, differentiable in w."""
    wm = _spectral_mat(w.detach().float().cpu(), dim).numpy()
    uv = np.asarray(u, dtype=np.float32)
    vv = None
    for _ in range(max(n_power_iterations, 1)):
        vv = wm.T @ uv
        vv = vv / max(float(np.linalg.norm(vv)), eps)
        uv = wm @ vv
        uv = uv / max(float(np.linalg.norm(uv)), eps)
    uc = torch.from_numpy(uv).to(w.device)
    vc = torch.from_numpy(vv).to(w.device)
    w32 = w.float()
    sigma = uc @ (_spectral_mat(w32, dim) @ vc)
    return (w32 / sigma).to(w.dtype), uv, vv


class _SpectralNorm:
    def __init__(self, name, n_power_iterations, eps, dim):
        self.name, self.n, self.eps, self.dim = name, n_power_iterations, \
            eps, dim

    def compute_weight(self, layer):
        out, new_u, _ = spectral_normalize(
            getattr(layer, self.name + "_orig"),
            getattr(layer, "_" + self.name + "_u"), dim=self.dim,
            n_power_iterations=self.n, eps=self.eps)
        object.__setattr__(layer, "_" + self.name + "_u", new_u)
        return out

    def __call__(self, layer, inputs):
        object.__setattr__(layer, self.name, self.compute_weight(layer))


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """w / sigma_max(w) by power iteration; `dim` defaults to 1 for Linear
    and the transposed convs (their output axis is second), else 0."""
    if name not in layer._parameters:
        raise ValueError(f"spectral_norm: layer has no parameter {name!r}")
    if dim is None:
        from ..layer.common import Linear
        from ..layer.conv import (Conv1DTranspose, Conv2DTranspose,
                                  Conv3DTranspose)
        dim = 1 if isinstance(layer, (Linear, Conv1DTranspose,
                                      Conv2DTranspose, Conv3DTranspose)) \
            else 0
    w = layer._parameters.pop(name)
    fn = _SpectralNorm(name, n_power_iterations, eps, dim)
    layer.register_parameter(name + "_orig", Parameter(w.detach()))
    h = _spectral_mat(w.detach(), dim).shape[0]
    u0 = np.random.RandomState(0).randn(h).astype(np.float32)  # tpu-lint: disable=stdlib-random (fixed-seed host init, runs once)
    object.__setattr__(layer, "_" + name + "_u", u0 / np.linalg.norm(u0))
    fn._handle = layer.register_forward_pre_hook(fn)
    fn(layer, None)
    return layer


__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm", "clip_grad_norm_"]
