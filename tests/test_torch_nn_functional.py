"""The port's `nn.functional` (`paddle_tpu_torch.nn.functional`) against
the JAX package's, one case list per functional name, on the CPU.

Each case takes the same seeded numpy inputs through both packages as
Tensors (`to_tensor`) and holds the outputs' values, shapes and dtypes to
the reference: fp32 within 1e-5 unless the case states otherwise (1e-4
for the convolutions, whose sums run in another order), integer outputs
exactly. For the differentiable arguments it also holds the gradients of
`sum(first output)` to the reference's tape, within the same tolerance.
The random functionals (the dropouts, rrelu, gumbel_softmax,
class_center_sample) compare what does not depend on the bits: eval
values exactly, the mask's structure, the kept fraction within a
binomial 5-sigma band at one seed, and the kept values. Reference
behaviours that differ from paddle's documentation are pinned here as
the reference has them (ROADMAP Queue 3).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core.dtype import dtype_name

ATOL = 1e-5          # fp32, elementwise and reductions
CONV_TOL = 1e-4      # fp32 convolutions: other summation orders


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    """The reference's op cache keys closure constants by value (2 == 2.0);
    each test starts from an empty one (see test_torch_ops.py)."""
    jautograd._JIT_CACHE.clear()


class C:
    """args / kw (or plain keywords): ndarrays become tensors (in kw
    never differentiated); grad: the positions to differentiate sum(first
    output) by; post: maps each package's numpy outputs before the
    comparison."""

    def __init__(self, *args, kw=None, grad=(), tol=ATOL, post=None,
                 **keywords):
        self.args, self.grad, self.tol = args, grad, tol
        self.kw = dict(kw or {}, **keywords)
        self.post = post


def _rng(seed):
    return np.random.default_rng(seed)


def n_(*shape, seed=0, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def u(*shape, lo=-1.0, hi=1.0, seed=0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def i32(*shape, lo=0, hi=5, seed=0):
    return _rng(seed).integers(lo, hi, shape).astype(np.int32)


def sign(*shape, seed=0):
    return np.where(_rng(seed).random(shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


X = n_(3, 4)
Y = n_(3, 4, seed=1)
PROB = u(3, 4, lo=0.05, hi=0.95)
Y01 = (u(3, 4, seed=2) > 0).astype(np.float32)
IMG = n_(2, 3, 7, 7)
IMG_NHWC = np.ascontiguousarray(IMG.transpose(0, 2, 3, 1))
W33 = n_(4, 3, 3, 3, seed=1, scale=0.3)
B4 = n_(4, seed=2)
LOGITS = n_(5, 6)
LABELS = i32(5, hi=6, seed=3)


def _softmax_np(a, axis=-1):
    e = np.exp(a - a.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _logsoftmax_np(a, axis=-1):
    return np.log(_softmax_np(a, axis)).astype(np.float32)


def _csr(b, h, s, seed=0):
    """A random CSR pattern (the same for every head, the diagonal always
    present)."""
    rng = _rng(seed)
    dense = np.broadcast_to((rng.random((s, s)) < 0.4) | np.eye(s, dtype=bool),
                            (b, h, s, s))
    counts = dense.sum(-1)
    off = np.concatenate([np.zeros((b, h, 1), np.int32),
                          np.cumsum(counts, -1).astype(np.int32)], -1)
    cols = np.stack([np.concatenate([np.nonzero(dense[i, j, r])[0]
                                     for r in range(s)])
                     for i in range(b) for j in range(h)])
    return off, cols.reshape(b, h, -1).astype(np.int32)


def _gather_tree_inputs():
    rng = _rng(5)
    ids = rng.integers(0, 10, (4, 2, 3)).astype(np.int32)
    parents = rng.integers(0, 3, (4, 2, 3)).astype(np.int32)
    return ids, parents


CSR_OFF, CSR_COL = _csr(1, 2, 6)
GT_IDS, GT_PAR = _gather_tree_inputs()
POOL_X = n_(2, 3, 8, 9)
POOL_MASK = np.asarray(JF.max_pool2d(paddle.to_tensor(POOL_X), 2,
                                     return_mask=True)[1]._value)
POOL_VALS = n_(2, 3, 4, 4, seed=7)
POOL1_MASK = np.asarray(JF.max_pool1d(paddle.to_tensor(n_(2, 3, 9)), 3,
                                      return_mask=True)[1]._value)
POOL3_MASK = np.asarray(JF.max_pool3d(paddle.to_tensor(n_(1, 2, 4, 4, 4)), 2,
                                      return_mask=True)[1]._value)

CASES = {
    # ---- activation ----
    "relu": [C(X, grad=(0,))],
    "relu6": [C(X * 4, grad=(0,))],
    "sigmoid": [C(X, grad=(0,))],
    "tanh": [C(X, grad=(0,))],
    "silu": [C(X, grad=(0,))],
    "swish": [C(X, grad=(0,))],
    "mish": [C(X * 3, grad=(0,))],
    "hardswish": [C(X * 4, grad=(0,))],
    "hardsigmoid": [C(X * 4, grad=(0,))],
    "tanhshrink": [C(X, grad=(0,))],
    "softsign": [C(X, grad=(0,))],
    "log_sigmoid": [C(X * 5, grad=(0,))],
    "gelu": [C(X, grad=(0,)), C(X, True, grad=(0,))],
    "leaky_relu": [C(X, grad=(0,)), C(X, 0.2, grad=(0,))],
    "elu": [C(X, grad=(0,)), C(X, 0.5, grad=(0,))],
    "celu": [C(X, 0.7, grad=(0,))],
    "selu": [C(X, grad=(0,)), C(X, 1.2, 1.5, grad=(0,))],
    "hardtanh": [C(X * 2, grad=(0,)), C(X * 2, -0.5, 0.75, grad=(0,))],
    "hardshrink": [C(X, grad=(0,)), C(X, 0.8, grad=(0,))],
    "softshrink": [C(X, grad=(0,)), C(X, 0.3, grad=(0,))],
    "softplus": [C(X, grad=(0,)), C(X * 30, 2.0, 20.0, grad=(0,))],
    "prelu": [C(IMG, np.array([0.25], np.float32), grad=(0, 1)),
              C(IMG, u(3, lo=0.0, hi=0.5), grad=(0, 1)),
              C(IMG_NHWC, u(3, lo=0.0, hi=0.5), "NHWC", grad=(0, 1))],
    "rrelu": [C(X, 0.1, 0.3, False, grad=(0,))],
    "softmax": [C(X, grad=(0,)), C(X, 0, grad=(0,)),
                C(X, kw={"dtype": "float64"}, grad=(0,))],
    "log_softmax": [C(X, grad=(0,)), C(X, 0, grad=(0,))],
    "maxout": [C(n_(2, 6, 3, 3), 3, grad=(0,)),
               C(n_(2, 3, 3, 4), 2, 3, grad=(0,))],
    "glu": [C(n_(3, 6), grad=(0,)), C(n_(4, 3), 0, grad=(0,))],
    "thresholded_relu": [C(X * 2, grad=(0,)), C(X * 2, 0.5, grad=(0,))],
    # ---- common ----
    "linear": [C(n_(3, 4), n_(4, 5, seed=1), n_(5, seed=2), grad=(0, 1, 2)),
               C(n_(2, 3, 4), n_(4, 5, seed=1), grad=(0, 1))],
    "embedding": [C(i32(3, 4, hi=7), n_(7, 5), grad=(1,)),
                  C(i32(3, 4, hi=7), n_(7, 5), kw={"padding_idx": 2},
                    grad=(1,))],
    "dropout": [C(X, 0.25, kw={"training": False}),
                C(X, 0.25, kw={"training": False,
                               "mode": "downscale_in_infer"}, grad=(0,)),
                C(X, 0.0, kw={"mode": "downscale_in_infer"})],
    "dropout2d": [C(IMG, 0.5, False)],
    "dropout3d": [C(n_(2, 3, 2, 2, 2), 0.5, False)],
    "alpha_dropout": [C(X, 0.5, False)],
    "one_hot": [C(i32(5, hi=4), 4), C(i32(2, 3, hi=6), 6)],
    "label_smooth": [C(np.eye(4, dtype=np.float32)[[0, 2, 3]], grad=(0,)),
                     C(np.eye(4, dtype=np.float32)[[1, 2]],
                       kw={"epsilon": 0.2}, grad=(0,)),
                     C(np.eye(4, dtype=np.float32)[[1, 2]],
                       np.full((1, 4), 0.25, np.float32), grad=(0,))],
    "interpolate": [
        C(IMG, [14, 11], grad=(0,)),                        # nearest
        C(IMG, [5, 4]),                                     # nearest down
        C(IMG, [12, 10], kw={"mode": "bilinear"}, grad=(0,)),
        C(IMG, [4, 3], kw={"mode": "bilinear"}, grad=(0,)),  # antialiased
        C(IMG, kw={"scale_factor": 2, "mode": "bicubic"}, grad=(0,)),
        C(IMG_NHWC, [9, 10], kw={"mode": "bilinear", "data_format": "NHWC"},
          grad=(0,)),
        C(IMG, kw={"scale_factor": [1.5, 0.5], "mode": "bilinear",
                   "align_corners": True}),
        C(n_(2, 3, 6), [9], kw={"mode": "linear", "data_format": "NCW"},
          grad=(0,)),
        C(n_(1, 2, 3, 4, 5), [5, 6, 3], kw={"mode": "trilinear",
                                            "data_format": "NCDHW"})],
    "upsample": [C(IMG, [10, 9], kw={"mode": "bilinear"}, grad=(0,))],
    "pixel_shuffle": [C(n_(2, 8, 3, 3), 2, grad=(0,)),
                      C(n_(2, 3, 3, 8), 2, "NHWC", grad=(0,))],
    "pixel_unshuffle": [C(n_(2, 2, 4, 6), 2, grad=(0,))],
    "unfold": [C(IMG, 3, grad=(0,)), C(IMG, [2, 3], 2, 1, 1, grad=(0,)),
               C(IMG, 3, 1, [1, 0, 2, 1], grad=(0,))],
    "fold": [C(n_(2, 12, 9), [4, 4], 2, grad=(0,)),
             C(n_(2, 12, 9), [5, 5], 2, 2, 1, grad=(0,))],
    "cosine_similarity": [C(X, Y, grad=(0, 1)), C(X, Y, 0, grad=(0, 1))],
    "bilinear": [C(n_(3, 4), n_(3, 5, seed=1), n_(6, 4, 5, seed=2),
                   n_(6, seed=3), grad=(0, 1, 2, 3)),
                 C(n_(3, 4), n_(3, 5, seed=1), n_(6, 4, 5, seed=2),
                   grad=(0, 1, 2))],
    "normalize": [C(X, grad=(0,)), C(X, 1, 0, grad=(0,))],
    "pad": [C(IMG, [1, 2, 0, 1], grad=(0,)),
            C(IMG, [1, 1, 2, 2], "reflect", grad=(0,)),
            C(IMG, [2, 1, 1, 0], "replicate", grad=(0,)),
            C(IMG, [1, 1, 1, 1], "constant", 0.5)],
    "zeropad2d": [C(IMG, [1, 0, 2, 1], grad=(0,)),
                  C(IMG_NHWC, [0, 1, 1, 2], "NHWC", grad=(0,))],
    "sequence_mask": [C(i32(4, lo=1, hi=6), 6), C(i32(2, 3, lo=0, hi=4)),
                      C(i32(4, lo=1, hi=6), 7, "float32")],
    "diag_embed": [C(n_(2, 3), grad=(0,)), C(n_(2, 3), 1, grad=(0,)),
                   C(n_(2, 3), -1, 0, 2, grad=(0,))],
    "gather_tree": [C(GT_IDS, GT_PAR)],
    "sparse_attention": [C(n_(1, 2, 6, 4), n_(1, 2, 6, 4, seed=1),
                           n_(1, 2, 6, 4, seed=2), CSR_OFF, CSR_COL,
                           grad=(0, 1, 2))],
    # ---- conv ----
    "conv2d": [C(IMG, W33, B4, grad=(0, 1, 2), tol=CONV_TOL),
               C(IMG, W33, B4, 2, 1, grad=(0, 1, 2), tol=CONV_TOL),
               C(IMG, W33, None, 1, [1, 2], tol=CONV_TOL, grad=(0, 1)),
               C(IMG, W33, B4, 1, [1, 2, 0, 1], tol=CONV_TOL, grad=(0, 1)),
               C(IMG, W33, B4, 1, [[0, 1], [2, 1]], tol=CONV_TOL,
                 grad=(0, 1)),
               C(IMG, W33, B4, 2, "SAME", tol=CONV_TOL, grad=(0, 1)),
               C(n_(2, 3, 8, 8), W33, B4, 3, "SAME", tol=CONV_TOL,
                 grad=(0, 1)),
               C(IMG, W33, B4, 1, "VALID", tol=CONV_TOL, grad=(0, 1)),
               C(IMG, W33, B4, 1, 2, 2, tol=CONV_TOL, grad=(0, 1)),
               C(n_(2, 4, 7, 7), n_(6, 2, 3, 3, seed=1), n_(6, seed=2), 1,
                 1, 1, 2, tol=CONV_TOL, grad=(0, 1, 2)),
               C(IMG_NHWC, W33, B4, 2, 1, 1, 1, "NHWC", tol=CONV_TOL,
                 grad=(0, 1, 2))],
    "conv1d": [C(n_(2, 3, 10), n_(4, 3, 3, seed=1), B4, 1, 1, tol=CONV_TOL,
                 grad=(0, 1, 2)),
               C(n_(2, 10, 3), n_(4, 3, 3, seed=1), B4, 2, "SAME",
                 kw={"data_format": "NLC"}, tol=CONV_TOL, grad=(0, 1))],
    "conv3d": [C(n_(1, 2, 5, 5, 5), n_(3, 2, 3, 3, 3, seed=1), n_(3, seed=2),
                 1, 1, tol=CONV_TOL, grad=(0, 1, 2))],
    "conv2d_transpose": [
        C(IMG, n_(3, 4, 3, 3, seed=1), B4, 2, 1, 1, tol=CONV_TOL,
          grad=(0, 1, 2)),
        C(IMG, n_(3, 4, 3, 3, seed=1), None, 1, 0, tol=CONV_TOL,
          grad=(0, 1)),
        C(IMG, n_(3, 4, 3, 3, seed=1), B4, 2, [1, 0], kw={"dilation": 2},
          tol=CONV_TOL, grad=(0, 1)),
        C(IMG, n_(3, 4, 3, 3, seed=1), B4, 2, [[1, 0], [0, 2]],
          tol=CONV_TOL, grad=(0, 1)),
        C(n_(2, 4, 5, 5), n_(4, 3, 3, 3, seed=1), n_(6, seed=2), 2, 1, 1, 2,
          tol=CONV_TOL, grad=(0, 1, 2)),
        # output_size is not read by the reference (nor by the port)
        C(IMG, n_(3, 4, 3, 3, seed=1), B4, 2, 1, 0, kw={"output_size": [14,
                                                                      14]},
          tol=CONV_TOL, grad=(0, 1)),
        C(IMG_NHWC, n_(3, 4, 3, 3, seed=1), B4, 2, 1, 1,
          kw={"data_format": "NHWC"}, tol=CONV_TOL, grad=(0, 1, 2))],
    "conv1d_transpose": [C(n_(2, 3, 6), n_(3, 4, 3, seed=1), B4, 2, 1, 1,
                           tol=CONV_TOL, grad=(0, 1, 2))],
    "conv3d_transpose": [C(n_(1, 2, 3, 3, 3), n_(2, 3, 2, 2, 2, seed=1),
                           n_(3, seed=2), 2, tol=CONV_TOL, grad=(0, 1, 2))],
    # ---- pooling ----
    "max_pool2d": [C(POOL_X, 2, grad=(0,)), C(POOL_X, 3, 2, 1, grad=(0,)),
                   C(POOL_X, 3, 1, 2, grad=(0,)),          # pad > k // 2
                   C(POOL_X, 3, 2, [[1, 0], [0, 2]], grad=(0,)),
                   C(POOL_X, 3, 2, "SAME", grad=(0,)),
                   C(POOL_X, 2, padding="VALID", grad=(0,)),
                   # ceil_mode is not read without a mask (Queue 3)
                   C(POOL_X, 2, ceil_mode=True, grad=(0,)),
                   C(np.ascontiguousarray(POOL_X.transpose(0, 2, 3, 1)), 3, 2,
                     1, kw={"data_format": "NHWC"}, grad=(0,)),
                   C(POOL_X, 2, return_mask=True, grad=(0,)),
                   C(POOL_X, 3, 2, 1, return_mask=True, grad=(0,)),
                   C(POOL_X, 2, return_mask=True, ceil_mode=True,
                     grad=(0,))],
    "max_pool1d": [C(n_(2, 3, 9), 3, grad=(0,)),
                   C(n_(2, 3, 9), 3, 2, 1, return_mask=True, grad=(0,))],
    "max_pool3d": [C(n_(1, 2, 5, 5, 5), 2, grad=(0,)),
                   C(n_(1, 2, 5, 5, 5), 3, 2, 1, grad=(0,)),
                   C(n_(1, 2, 4, 4, 4), 2, return_mask=True, grad=(0,))],
    "avg_pool2d": [C(POOL_X, 2, grad=(0,)),
                   C(POOL_X, 3, 2, 1, grad=(0,)),            # exclusive
                   C(POOL_X, 3, 2, 1, exclusive=False, grad=(0,)),
                   C(POOL_X, 3, 1, 2, grad=(0,)),
                   C(POOL_X, 3, 2, "SAME", grad=(0,)),
                   C(POOL_X, 3, 2, "SAME", exclusive=False, grad=(0,)),
                   C(POOL_X, 2, ceil_mode=True, grad=(0,)),
                   C(np.ascontiguousarray(POOL_X.transpose(0, 2, 3, 1)), 3, 2,
                     1, kw={"data_format": "NHWC"}, grad=(0,))],
    "avg_pool1d": [C(n_(2, 3, 9), 3, 2, 1, grad=(0,)),
                   C(n_(2, 3, 9), 3, 2, 1, False, grad=(0,))],
    "avg_pool3d": [C(n_(1, 2, 5, 5, 5), 3, 2, 1, grad=(0,))],
    "adaptive_avg_pool1d": [C(n_(2, 3, 10), 4, grad=(0,)),
                            C(n_(2, 3, 10), 5, grad=(0,))],
    "adaptive_avg_pool2d": [C(POOL_X, [3, 4], grad=(0,)),
                            C(POOL_X, 4, grad=(0,)),
                            C(np.ascontiguousarray(POOL_X.transpose(
                                0, 2, 3, 1)), [3, 4], "NHWC", grad=(0,))],
    "adaptive_avg_pool3d": [C(n_(1, 2, 5, 6, 7), [2, 3, 3], grad=(0,))],
    "adaptive_max_pool1d": [C(n_(2, 3, 10), 4, grad=(0,))],
    # return_mask is not read: one output, as in the reference (Queue 3)
    "adaptive_max_pool2d": [C(POOL_X, [3, 4], grad=(0,)),
                            C(POOL_X, [3, 4], True, grad=(0,))],
    "adaptive_max_pool3d": [C(n_(1, 2, 5, 6, 7), [2, 3, 3], grad=(0,))],
    "max_unpool2d": [C(POOL_VALS, POOL_MASK, 2, grad=(0,)),
                     C(POOL_VALS, POOL_MASK, 2, output_size=[8, 9],
                       grad=(0,))],
    "max_unpool1d": [C(n_(2, 3, 3, seed=4), POOL1_MASK, 3, grad=(0,))],
    "max_unpool3d": [C(n_(1, 2, 2, 2, 2, seed=4), POOL3_MASK, 2, grad=(0,))],
    # ---- norm ----
    "batch_norm": [C(IMG, np.zeros(3, np.float32), np.ones(3, np.float32),
                     u(3, lo=0.5, hi=1.5), n_(3, seed=1), grad=(0, 3, 4)),
                   C(IMG, n_(3, seed=4), u(3, lo=0.5, hi=2.0, seed=5),
                     u(3, lo=0.5, hi=1.5), n_(3, seed=1), grad=(0, 3, 4))],
    "layer_norm": [C(n_(2, 3, 8), 8, n_(8, seed=1), n_(8, seed=2),
                     grad=(0, 2, 3)),
                   C(n_(2, 3, 8), [3, 8], grad=(0,))],
    "instance_norm": [C(IMG, kw={"weight": u(3, lo=0.5, hi=1.5),
                                 "bias": n_(3, seed=1)}, grad=(0,)),
                      C(IMG_NHWC, kw={"data_format": "NHWC"}, grad=(0,))],
    "group_norm": [C(n_(2, 6, 3, 3), 3, 1e-5, u(6, lo=0.5, hi=1.5),
                     n_(6, seed=1), grad=(0, 3, 4)),
                   C(n_(2, 3, 3, 6), 2, kw={"data_format": "NHWC"},
                     grad=(0,))],
    "local_response_norm": [C(n_(2, 7, 3, 3), 3, grad=(0,)),
                            C(n_(2, 7, 3, 3), 4, 1e-3, 0.5, 2.0,
                              grad=(0,))],
    "rms_norm": [C(X, u(4, lo=0.5, hi=1.5), grad=(0, 1)),
                 C(X, kw={"epsilon": 1e-3}, grad=(0,))],
    # ---- loss ----
    "cross_entropy": [C(LOGITS, LABELS, grad=(0,)),
                      C(LOGITS, LABELS.reshape(5, 1), kw={"reduction":
                                                          "none"},
                        grad=(0,)),
                      C(LOGITS, LABELS, kw={"weight": u(6, lo=0.5, hi=2.0),
                                            "ignore_index": 2}, grad=(0,)),
                      C(LOGITS, _softmax_np(n_(5, 6, seed=9)),
                        kw={"soft_label": True}, grad=(0,)),
                      C(LOGITS, LABELS, kw={"label_smoothing": 0.1,
                                            "reduction": "sum"},
                        grad=(0,))],
    "softmax_with_cross_entropy": [
        C(LOGITS, LABELS.reshape(5, 1), grad=(0,)),
        C(LOGITS, LABELS.reshape(5, 1), kw={"return_softmax": True},
          grad=(0,)),
        C(LOGITS, _softmax_np(n_(5, 6, seed=9)), True, grad=(0,))],
    "mse_loss": [C(X, Y, grad=(0, 1)), C(X, Y, "sum", grad=(0,)),
                 C(X, Y, "none", grad=(0,))],
    "l1_loss": [C(X, Y, grad=(0, 1)), C(X, Y, "none", grad=(0,))],
    "smooth_l1_loss": [C(X, Y, grad=(0, 1)),
                       C(X, Y, "sum", 0.5, grad=(0, 1))],
    "nll_loss": [C(_logsoftmax_np(LOGITS), LABELS, grad=(0,)),
                 C(_logsoftmax_np(LOGITS), LABELS, u(6, lo=0.5, hi=2.0),
                   grad=(0,)),
                 C(_logsoftmax_np(LOGITS), LABELS, kw={"ignore_index": 2,
                                                       "reduction": "sum"},
                   grad=(0,)),
                 C(_logsoftmax_np(n_(2, 6, 3)), i32(2, 3, hi=6),
                   kw={"reduction": "none"}, grad=(0,))],
    "binary_cross_entropy": [C(PROB, Y01, grad=(0,)),
                             C(PROB, Y01, u(3, 4, lo=0.5, hi=2.0), "sum",
                               grad=(0,))],
    "binary_cross_entropy_with_logits": [
        C(X * 3, Y01, grad=(0,)),
        C(X * 3, Y01, None, "none", u(4, lo=0.5, hi=3.0), grad=(0,)),
        C(X * 3, Y01, u(3, 4, lo=0.5, hi=2.0), "sum", grad=(0,))],
    "kl_div": [C(_logsoftmax_np(X), _softmax_np(Y), grad=(0,)),
               C(_logsoftmax_np(X), _softmax_np(Y), "batchmean", grad=(0,)),
               C(_logsoftmax_np(X), _softmax_np(Y), "none", grad=(0,))],
    "margin_ranking_loss": [C(n_(6), n_(6, seed=1), sign(6), grad=(0, 1)),
                            C(n_(6), n_(6, seed=1), sign(6), 0.5, "sum",
                              grad=(0, 1))],
    "hinge_embedding_loss": [C(X, sign(3, 4), grad=(0,)),
                             C(X, sign(3, 4), 0.5, "none", grad=(0,))],
    "cosine_embedding_loss": [C(X, Y, sign(3), grad=(0, 1)),
                              C(X, Y, sign(3), 0.2, "sum", grad=(0, 1))],
    "triplet_margin_loss": [C(X, Y, n_(3, 4, seed=2), grad=(0, 1, 2)),
                            C(X, Y, n_(3, 4, seed=2), 0.5, 1.0, 1e-6, True,
                              "sum", grad=(0, 1, 2))],
    "square_error_cost": [C(X, Y, grad=(0, 1))],
    "sigmoid_focal_loss": [C(X * 2, Y01, grad=(0,)),
                           C(X * 2, Y01, np.array([3.0], np.float32), 0.3,
                             1.5, "mean", grad=(0,))],
    "margin_cross_entropy": [
        C(u(4, 6, lo=-0.9, hi=0.9), i32(4, hi=6), grad=(0,), tol=1e-4),
        C(u(4, 6, lo=-0.9, hi=0.9), i32(4, hi=6), 1.0, 0.3, 0.1, 16.0,
          kw={"return_softmax": True, "reduction": "none"}, grad=(0,),
          tol=1e-4)],
    "dice_loss": [C(_softmax_np(n_(2, 3, 4)), i32(2, 3, 1, hi=4),
                    grad=(0,))],
    "log_loss": [C(u(4, 1, lo=0.05, hi=0.95), (u(4, 1, seed=1) > 0).astype(
        np.float32), grad=(0,))],
    "npair_loss": [C(n_(4, 5), n_(4, 5, seed=1),
                     np.array([0, 1, 0, 2], np.float32), grad=(0, 1))],
    "hsigmoid_loss": [
        C(n_(4, 5), i32(4, hi=6), 6, n_(5, 5, seed=1), n_(5, 1, seed=2),
          grad=(0, 3, 4)),
        C(n_(4, 5), i32(4, hi=6), 6, n_(5, 5, seed=1),
          kw={"path_table": np.array([[0, 1, -1], [0, 2, 3], [1, 4, -1],
                                      [0, -1, -1]], np.int32),
              "path_code": np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0],
                                     [0, 0, 0]], np.float32)},
          grad=(0, 3))],
    # ---- vision ----
    "grid_sample": [
        C(IMG, u(2, 5, 6, 2, lo=-1.2, hi=1.2), grad=(0, 1)),
        C(IMG, u(2, 5, 6, 2, lo=-1.2, hi=1.2), "bilinear", "border", False,
          grad=(0, 1)),
        C(IMG, u(2, 5, 6, 2, lo=-1.5, hi=1.5), "bilinear", "reflection",
          True, grad=(0, 1)),
        C(IMG, u(2, 5, 6, 2, lo=-1.5, hi=1.5), "bilinear", "reflection",
          False, grad=(0, 1)),
        C(IMG, u(2, 5, 6, 2, lo=-1.2, hi=1.2), "nearest", grad=(0,))],
    "affine_grid": [C(n_(2, 2, 3), [2, 3, 4, 5], grad=(0,)),
                    C(n_(2, 2, 3), [2, 3, 4, 5], False, grad=(0,))],
    "temporal_shift": [C(n_(4, 8, 2, 2), 2, grad=(0,)),
                       C(n_(6, 2, 2, 8), 3, 0.25, data_format="NHWC",
                         grad=(0,))],
}
# functionals with tests of their own below: random ones and the in-place
# forms
RANDOM = {"class_center_sample", "gumbel_softmax", "relu_", "elu_",
          "softmax_", "tanh_"}


def _tensor(pkg, a, grad):
    return pkg.to_tensor(a, stop_gradient=not grad)


def _make(pkg, case):
    args, leaves = [], []
    for i, a in enumerate(case.args):
        if isinstance(a, np.ndarray):
            t = _tensor(pkg, a, i in case.grad)
            args.append(t)
            leaves.append(t if i in case.grad else None)
        else:
            args.append(a)
            leaves.append(None)
    kw = {k: _tensor(pkg, v, False) if isinstance(v, np.ndarray) else v
          for k, v in case.kw.items()}
    return args, kw, leaves


def _np(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    return np.asarray(o._value)


def _dtype(o):
    if isinstance(o, torch.Tensor):
        return dtype_name(o.dtype)
    return np.dtype(o._value.dtype).name


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _compare(name, got, want, tol, post=None):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), f"{name}: {len(g)} outputs vs {len(w)}"
    for k, (a, b) in enumerate(zip(g, w)):
        assert isinstance(a, pt.Tensor), f"{name}: output {k} {type(a)}"
        assert _dtype(a) == _dtype(b), \
            f"{name} output {k}: dtype {_dtype(a)} vs {_dtype(b)}"
        an, bn = _np(a), _np(b)
        if post is not None:
            an, bn = post(an), post(bn)
        assert an.shape == bn.shape, \
            f"{name} output {k}: shape {an.shape} vs {bn.shape}"
        if bn.dtype.kind == "f":
            np.testing.assert_allclose(an, bn, rtol=tol, atol=tol,
                                       err_msg=f"{name} output {k}")
        else:
            np.testing.assert_array_equal(an, bn,
                                          err_msg=f"{name} output {k}")


def _run_case(name, case):
    jargs, jkw, jleaves = _make(paddle, case)
    targs, tkw, tleaves = _make(pt, case)
    want = getattr(JF, name)(*jargs, **jkw)
    got = getattr(TF, name)(*targs, **tkw)
    _compare(name, got, want, case.tol, case.post)
    if not case.grad:
        return
    paddle.sum(_flat(want)[0]).backward()
    pt.sum(_flat(got)[0]).backward()
    for i in case.grad:
        jg, tg = jleaves[i].gradient(), tleaves[i].gradient()
        if jg is None or tg is None:
            assert not np.any(jg) and not np.any(tg), \
                f"{name}: gradient of arg {i}: {tg} vs {jg}"
            continue
        np.testing.assert_allclose(tg, jg, rtol=case.tol, atol=case.tol,
                                   err_msg=f"{name} grad of arg {i}")


FAMILIES = {
    "activation": "paddle_tpu.nn.functional.activation",
    "common": "paddle_tpu.nn.functional.common",
    "conv": "paddle_tpu.nn.functional.conv",
    "pooling": "paddle_tpu.nn.functional.pooling",
    "norm": "paddle_tpu.nn.functional.norm",
    "loss": "paddle_tpu.nn.functional.loss",
    "vision": "paddle_tpu.nn.functional.vision",
}
_REF_NAMES = {}
for _n in dir(JF):
    _v = getattr(JF, _n)
    _mod = getattr(_v, "__module__", "") or ""
    if callable(_v) and not _n.startswith("_") and _mod in FAMILIES.values():
        _REF_NAMES[_n] = [f for f, m in FAMILIES.items() if m == _mod][0]
# the public names the reference's namespace lists (its star imports also
# re-export helpers such as run_op): those of reference_api_all.json
with open(os.path.join(os.path.dirname(__file__),
                       "reference_api_all.json")) as _f:
    _LISTED = set(json.load(_f)["paddle.nn.functional"])
NAMES = {n: f for n, f in _REF_NAMES.items()
         if (n in _LISTED or n in ("rms_norm", "pixel_unshuffle"))
         and n != "ctc_loss"}
_PARAMS = [pytest.param(fam, nm, id=f"{fam}-{nm}")
           for nm, fam in sorted(NAMES.items(), key=lambda kv: (kv[1], kv[0]))
           if nm not in RANDOM]


@pytest.mark.parametrize("family,name", _PARAMS)
def test_functional_matches_the_reference(family, name):
    assert name in CASES, f"no case for {family} functional {name}"
    for case in CASES[name]:
        _run_case(name, case)


def test_every_reference_functional_is_exported_with_a_case():
    missing = sorted(n for n in _LISTED if not hasattr(TF, n))
    assert not missing, f"functionals the port does not export: {missing}"
    # ctc_loss's cases are in test_torch_ctc.py
    uncovered = sorted(n for n in _LISTED
                       if n not in CASES and n not in RANDOM
                       and n not in ("scaled_dot_product_attention",
                                     "ctc_loss"))
    assert not uncovered, f"functionals without a case: {uncovered}"


# ---- dropout: the repaired fault and the random functionals ----------------
def _t(a, grad=False):
    return pt.to_tensor(a, stop_gradient=not grad)


def _band(n, p_keep):
    """The kept count's 5-sigma binomial band."""
    mean = n * p_keep
    half = 5 * math.sqrt(n * p_keep * (1 - p_keep))
    return mean - half, mean + half


def test_dropout_downscale_in_infer_eval_scales_by_one_minus_p():
    x = n_(4, 5)
    want = JF.dropout(paddle.to_tensor(x), 0.25, training=False,
                      mode="downscale_in_infer").numpy()
    got = TF.dropout(_t(x), 0.25, training=False,
                     mode="downscale_in_infer").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x * np.float32(0.75))
    layer = pt.nn.Dropout(0.25, mode="downscale_in_infer")
    layer.eval()
    np.testing.assert_array_equal(layer(_t(x)).numpy(), want)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_training_keeps_values_by_mode(mode):
    """Every entry is 0 or its kept value: x / (1 - p) under
    upscale_in_train (the division in x's dtype, as the reference's), x
    under downscale_in_infer; the kept fraction lies in the binomial
    5-sigma band at one seed."""
    p = 0.3
    x = u(64, 128, lo=0.5, hi=1.5)
    pt.seed(7)
    out = TF.dropout(_t(x), p, training=True, mode=mode).numpy()
    kept = out != 0
    want = x / np.float32(1 - p) if mode == "upscale_in_train" else x
    np.testing.assert_array_equal(out[kept], want[kept])
    lo, hi = _band(x.size, 1 - p)
    assert lo <= kept.sum() <= hi, (kept.sum(), lo, hi)
    # the reference draws the same kind of mask
    ref = JF.dropout(paddle.to_tensor(x), p, training=True, mode=mode).numpy()
    rk = ref != 0
    np.testing.assert_allclose(ref[rk], want[rk], rtol=1e-6)
    assert lo <= rk.sum() <= hi


@pytest.mark.parametrize("axis", [0, 1, [0, 2], [1, 2]])
def test_dropout_axis_draws_one_mask_over_the_listed_axes(axis):
    """The mask varies only along `axis` and is broadcast over the other
    axes, as the reference's `shape = (s if i in axes else 1)`."""
    p = 0.5
    x = u(6, 7, 8, lo=0.5, hi=1.5)
    axes = [axis] if isinstance(axis, int) else axis
    for pkg_out in (TF.dropout(_t(x), p, axis=axis).numpy(),
                    JF.dropout(paddle.to_tensor(x), p, axis=axis).numpy()):
        kept = pkg_out != 0
        for ax in range(3):
            if ax in axes:
                continue
            first = np.take(kept, [0], axis=ax)
            assert (kept == first).all(), f"mask varies along axis {ax}"
        np.testing.assert_allclose(pkg_out[kept], (x / np.float32(1 - p))[
            kept], rtol=1e-6)
    pt.seed(3)
    kept = TF.dropout(_t(x), p, axis=axis).numpy() != 0
    n = int(np.prod([x.shape[a] for a in axes]))
    lo, hi = _band(n, 1 - p)
    sl = tuple(slice(None) if a in axes else 0 for a in range(3))
    assert lo <= kept[sl].sum() <= hi


def test_dropout2d_and_3d_drop_whole_channels():
    x = u(8, 16, 5, 5, lo=0.5, hi=1.5)
    out = TF.dropout2d(_t(x), 0.5).numpy()
    per_plane = (out != 0).reshape(8, 16, -1)
    assert (per_plane.all(-1) | ~per_plane.any(-1)).all()
    np.testing.assert_allclose(out[out != 0], (x * 2)[out != 0], rtol=1e-6)
    nhwc = TF.dropout2d(_t(np.ascontiguousarray(x.transpose(0, 2, 3, 1))),
                        0.5, data_format="NHWC").numpy()
    planes = (nhwc != 0).transpose(0, 3, 1, 2).reshape(8, 16, -1)
    assert (planes.all(-1) | ~planes.any(-1)).all()
    x3 = u(4, 6, 2, 3, 3, lo=0.5, hi=1.5)
    out3 = (TF.dropout3d(_t(x3), 0.5).numpy() != 0).reshape(4, 6, -1)
    assert (out3.all(-1) | ~out3.any(-1)).all()
    pt.seed(1)
    kept = per_plane.any(-1).sum()
    lo, hi = _band(8 * 16, 0.5)
    assert lo <= kept <= hi


def test_alpha_dropout_values_and_moments():
    p = 0.2
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    q = 1 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    x = n_(200, 100)
    pt.seed(0)
    out = TF.alpha_dropout(_t(x), p).numpy()
    kept = np.isclose(out, a * x + b, rtol=1e-5, atol=1e-6)
    dropped = np.isclose(out, a * alpha_p + b, rtol=1e-5, atol=1e-6)
    assert (kept | dropped).all()
    lo, hi = _band(x.size, q)
    assert lo <= kept.sum() <= hi
    # SELU's fixed point (mean 0, variance 1) survives
    assert abs(out.mean()) < 0.05 and abs(out.std() - 1) < 0.05
    np.testing.assert_array_equal(TF.alpha_dropout(_t(x), p,
                                                   training=False).numpy(), x)


def test_rrelu_training_slopes_in_range():
    x = n_(50, 40)
    pt.seed(0)
    out = TF.rrelu(_t(x), 0.1, 0.3, training=True).numpy()
    neg = x < 0
    np.testing.assert_array_equal(out[~neg], x[~neg])
    slope = out[neg] / x[neg]
    assert (slope >= 0.1 - 1e-6).all() and (slope <= 0.3 + 1e-6).all()
    assert abs(slope.mean() - 0.2) < 0.01


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_rows(hard):
    x = n_(64, 10)
    pt.seed(0)
    t = _t(x, grad=True)
    out = TF.gumbel_softmax(t, 0.5, hard=hard)
    o = out.numpy()
    np.testing.assert_allclose(o.sum(-1), 1.0, rtol=1e-5)
    if hard:   # y_hard + y - stop_gradient(y): one-hot up to rounding
        assert (np.isclose(o, 0, atol=1e-6) | np.isclose(o, 1, atol=1e-6)
                ).all()
        assert (np.isclose(o, 1, atol=1e-6).sum(-1) == 1).all()
    ref = JF.gumbel_softmax(paddle.to_tensor(x), 0.5, hard=hard).numpy()
    np.testing.assert_allclose(ref.sum(-1), 1.0, rtol=1e-5)
    pt.sum(out * _t(n_(64, 10, seed=1))).backward()
    assert np.isfinite(t.gradient()).all() and np.abs(t.gradient()).sum() > 0


def test_class_center_sample_keeps_positives_and_remaps():
    label = np.array([3, 7, 3, 11, 0, 7], np.int64)
    pt.seed(0)
    remap, sampled = TF.class_center_sample(_t(label.astype(np.int32)), 20, 8)
    r, s = remap.numpy(), sampled.numpy()
    jr, js = JF.class_center_sample(paddle.to_tensor(label), 20, 8)
    for rr, ss in ((r, s), (np.asarray(jr._value), np.asarray(js._value))):
        assert len(ss) == 8 and (np.diff(ss) > 0).all()
        assert set(np.unique(label)) <= set(ss.tolist())
        np.testing.assert_array_equal(ss[rr], label)
    assert remap.dtype == torch.int32 and sampled.dtype == torch.int32
    # more positives than num_samples: all of them, no negatives
    _, s2 = TF.class_center_sample(_t(np.arange(10, dtype=np.int32)), 20, 4)
    np.testing.assert_array_equal(s2.numpy(), np.arange(10))
    pt.seed(0)
    again = TF.class_center_sample(_t(label.astype(np.int32)), 20, 8)[1]
    np.testing.assert_array_equal(again.numpy(), s)


@pytest.mark.parametrize("name,args", [
    ("relu_", ()), ("elu_", (0.5,)), ("softmax_", (0,)), ("tanh_", ())])
def test_inplace_activations_write_into_their_input(name, args):
    x = n_(3, 4)
    jx = paddle.to_tensor(x)
    tx = _t(x)
    jr = getattr(JF, name)(jx, *args)
    tr = getattr(TF, name)(tx, *args)
    np.testing.assert_allclose(tx.numpy(), jx.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), jr.numpy(), rtol=1e-6, atol=1e-6)


# ---- batch norm: the running statistics ------------------------------------
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_running_stats_over_three_training_calls(data_format):
    """Paddle's momentum (the old statistic's weight) and the biased batch
    variance, written into the buffers in place; then eval on them and
    use_global_stats in training."""
    c = 3
    rm_j = paddle.to_tensor(np.zeros(c, np.float32))
    rv_j = paddle.to_tensor(np.ones(c, np.float32))
    rm_t = torch.zeros(c)
    rv_t = torch.ones(c)
    w, b = u(c, lo=0.5, hi=1.5), n_(c, seed=1)
    for step in range(3):
        x = n_(4, c, 5, 5, seed=10 + step) * (step + 1) + step
        if data_format == "NHWC":
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        want = JF.batch_norm(paddle.to_tensor(x), rm_j, rv_j,
                             paddle.to_tensor(w), paddle.to_tensor(b),
                             training=True, momentum=0.8,
                             data_format=data_format).numpy()
        got = TF.batch_norm(_t(x), rm_t, rv_t, _t(w), _t(b), training=True,
                            momentum=0.8, data_format=data_format).numpy()
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(rm_t.numpy(), rm_j.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(rv_t.numpy(), rv_j.numpy(), rtol=1e-6,
                                   atol=1e-6)
    x = n_(4, c, 5, 5, seed=20)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for kw in ({"training": False}, {"training": True,
                                     "use_global_stats": True}):
        before = rm_t.clone()
        want = JF.batch_norm(paddle.to_tensor(x), rm_j, rv_j,
                             paddle.to_tensor(w), paddle.to_tensor(b),
                             data_format=data_format, **kw).numpy()
        got = TF.batch_norm(_t(x), rm_t, rv_t, _t(w), _t(b),
                            data_format=data_format, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
        assert torch.equal(before, rm_t)


def test_batch_norm_bf16_input_with_fp32_parameters_promotes():
    """An AMP activation against fp32 parameters gives fp32, as the
    reference's promotion does. The reference normalises in bf16 and
    promotes at the affine step; the port promotes first and normalises
    in one fused fp32 pass (Queue 3: a deviation of rounding), so the two
    agree within bf16's rounding."""
    x = n_(4, 3, 5, 5)
    w, b = u(3, lo=0.5, hi=1.5), n_(3, seed=1)
    jx = paddle.to_tensor(x).astype("bfloat16")
    want = JF.batch_norm(jx, paddle.to_tensor(np.zeros(3, np.float32)),
                         paddle.to_tensor(np.ones(3, np.float32)),
                         paddle.to_tensor(w), paddle.to_tensor(b),
                         training=True)
    got = TF.batch_norm(_t(x).astype("bfloat16"), torch.zeros(3),
                        torch.ones(3), _t(w), _t(b), training=True)
    assert _dtype(got) == _dtype(want) == "float32"
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-2,
                               atol=3e-2)


# ---- kept reference behaviours (ROADMAP Queue 3) ----------------------------
def test_max_pool_ceil_mode_is_read_only_with_a_mask():
    """The reference's `_pool` ignores ceil_mode; its masked routine reads
    it: at 8 x 9 with k = s = 2 the two give 4 x 4 and 4 x 5."""
    x = _t(POOL_X)
    plain = TF.max_pool2d(x, 2, ceil_mode=True)
    masked, mask = TF.max_pool2d(x, 2, ceil_mode=True, return_mask=True)
    assert plain.shape == [2, 3, 4, 4] and masked.shape == [2, 3, 4, 5]
    jx = paddle.to_tensor(POOL_X)
    assert JF.max_pool2d(jx, 2, ceil_mode=True).shape == plain.shape
    assert JF.max_pool2d(jx, 2, ceil_mode=True,
                         return_mask=True)[0].shape == masked.shape


def test_max_unpool_round_trip():
    """Positive inputs: unpooling writes each window's maximum back at its
    index and zeros elsewhere, so pooling again gives the same values and
    indices."""
    pos = np.abs(POOL_X) + 0.1
    x = _t(pos)
    out, mask = TF.max_pool2d(x, 2, return_mask=True)
    back = TF.max_unpool2d(out, mask, 2, output_size=[8, 9]).numpy()
    again, mask2 = TF.max_pool2d(_t(back), 2, return_mask=True)
    np.testing.assert_array_equal(again.numpy(), out.numpy())
    np.testing.assert_array_equal(mask2.numpy(), mask.numpy())
    nz = back != 0
    np.testing.assert_array_equal(back[nz], pos[nz])
    assert nz.reshape(2, 3, -1).sum(-1).max() <= 16


def test_softmax_dtype_argument_is_not_read():
    """The reference's softmax takes `dtype` and does not cast: the output
    keeps the input's dtype."""
    got = TF.softmax(_t(X), dtype="float64")
    want = JF.softmax(paddle.to_tensor(X), dtype="float64")
    assert _dtype(got) == _dtype(want) == "float32"
