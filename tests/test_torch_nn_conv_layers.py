"""The port's `nn` layers of the convolutional slice, `ParamAttr` /
`Parameter`, the initializers, `nn.utils` and the containers, against
the JAX package on the CPU.

Every layer name of the reference's `paddle.nn` (but the RNN, transformer
and decode families and CTCLoss) is built in both packages with the same
arguments: the `state_dict` keys, shapes and buffers must be equal; the
reference's values are loaded into the port (`load_numpy_state`) and the
forward must agree within 1e-5 (1e-4 for the convolutions), in train
and in eval mode where they differ, with the gradients of the sum for
the layer's parameters. Initializers are held to the reference's values
where they are deterministic and to its moments where they are drawn
(at one seed: means within 5 standard errors, stds within 2%).
"""
import collections
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.jit.functional import split_state
from paddle_tpu_torch.utils import load_numpy_state

TOL = 1e-5
CONV_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def n_(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def u(*shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def i32(*shape, hi=5, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(
        np.int32)


def _state(jlayer):
    return {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}


X = n_(3, 4)
IMG = n_(2, 3, 7, 7)
POOL_X = n_(2, 3, 8, 9)
SIGN = np.where(n_(3, 4, seed=5) > 0, 1.0, -1.0).astype(np.float32)
MASK2 = np.asarray(paddle.nn.functional.max_pool2d(
    paddle.to_tensor(POOL_X), 2, return_mask=True)[1]._value)
MASK1 = np.asarray(paddle.nn.functional.max_pool1d(
    paddle.to_tensor(n_(2, 3, 9)), 3, return_mask=True)[1]._value)
MASK3 = np.asarray(paddle.nn.functional.max_pool3d(
    paddle.to_tensor(n_(1, 2, 4, 4, 4)), 2, return_mask=True)[1]._value)


def _logp(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return np.log(e / e.sum(-1, keepdims=True)).astype(np.float32)


def _prob(a):
    return np.exp(_logp(a)).astype(np.float32)


class L:
    """A layer case: constructor arguments and forward inputs (ndarrays
    become tensors; those at `grad` positions are differentiated)."""

    def __init__(self, args=(), kw=None, inputs=(X,), grad=(0,), tol=TOL):
        self.args, self.kw = args, kw or {}
        self.inputs, self.grad, self.tol = inputs, grad, tol


_ACT = {n: [L()] for n in (
    "ReLU", "ReLU6", "Sigmoid", "Silu", "Swish", "Mish", "Hardswish",
    "Hardsigmoid", "Tanhshrink", "Softsign", "LogSigmoid", "Tanh", "GELU")}
LAYERS = dict(_ACT, **{
    "LeakyReLU": [L((0.2,))], "ELU": [L((0.5,))], "CELU": [L((0.7,))],
    "SELU": [L()], "Hardtanh": [L((-0.5, 0.5))], "Hardshrink": [L((0.3,))],
    "Softshrink": [L((0.3,))], "Softplus": [L((2.0, 10.0))],
    "PReLU": [L(inputs=(IMG,)), L((3, 0.1), inputs=(IMG,))],
    "Softmax": [L((0,))], "LogSoftmax": [L()],
    "Maxout": [L((3,), inputs=(n_(2, 6, 3, 3),))],
    "ThresholdedReLU": [L((0.5,))],
    # common
    "Linear": [L((4, 5))],
    "Embedding": [L((7, 5), {"padding_idx": 1}, inputs=(i32(3, 4, hi=7),),
                    grad=())],
    "Dropout": [L((0.3,))], "Dropout2D": [L((0.3,), inputs=(IMG,))],
    "Dropout3D": [L((0.3,), inputs=(n_(2, 3, 2, 2, 2),))],
    "AlphaDropout": [L((0.3,))],
    "Flatten": [L(inputs=(IMG,))],
    "Upsample": [L((None, 2, "bilinear"), inputs=(IMG,))],
    "UpsamplingNearest2D": [L(([10, 9],), inputs=(IMG,))],
    "UpsamplingBilinear2D": [L((None, 1.5), inputs=(IMG,))],
    "Pad1D": [L(([1, 2],), inputs=(n_(2, 3, 5),))],
    "Pad2D": [L(([1, 0, 2, 1], "reflect"), inputs=(IMG,))],
    "Pad3D": [L(([1, 0, 0, 1, 1, 1],), inputs=(n_(1, 2, 3, 3, 3),))],
    "ZeroPad2D": [L(([1, 2, 0, 1],), inputs=(IMG,))],
    "CosineSimilarity": [L((0,), inputs=(X, n_(3, 4, seed=1)), grad=(0, 1))],
    "Bilinear": [L((4, 5, 6), inputs=(X, n_(3, 5, seed=1)), grad=(0, 1))],
    "Unfold": [L((3, 1, 1), inputs=(IMG,))],
    "Fold": [L(([4, 4], 2), inputs=(n_(2, 12, 9),))],
    "PixelShuffle": [L((2,), inputs=(n_(2, 8, 3, 3),))],
    "PairwiseDistance": [L(inputs=(X, n_(3, 4, seed=1)), grad=(0, 1)),
                         L((1.0, 1e-6, True), inputs=(X, n_(3, 4, seed=1)))],
    # conv
    "Conv1D": [L((3, 4, 3), {"padding": 1}, inputs=(n_(2, 3, 10),),
                 tol=CONV_TOL)],
    "Conv2D": [L((3, 4, 3), {"stride": 2, "padding": 1}, inputs=(IMG,),
                 tol=CONV_TOL),
               L((3, 6, 3), {"groups": 3, "padding": "SAME",
                             "bias_attr": False}, inputs=(IMG,),
                 tol=CONV_TOL),
               L((3, 4, 3), {"padding": 1, "data_format": "NHWC"},
                 inputs=(np.ascontiguousarray(IMG.transpose(0, 2, 3, 1)),),
                 tol=CONV_TOL)],
    "Conv3D": [L((2, 3, 3), {"padding": 1}, inputs=(n_(1, 2, 5, 5, 5),),
                 tol=CONV_TOL)],
    "Conv1DTranspose": [L((3, 4, 3), {"stride": 2, "padding": 1},
                          inputs=(n_(2, 3, 6),), tol=CONV_TOL)],
    "Conv2DTranspose": [L((3, 4, 3), {"stride": 2, "padding": 1,
                                      "output_padding": 1}, inputs=(IMG,),
                          tol=CONV_TOL),
                        L((3, 6, 3), {"groups": 3}, inputs=(IMG,),
                          tol=CONV_TOL)],
    "Conv3DTranspose": [L((2, 3, 2), {"stride": 2},
                          inputs=(n_(1, 2, 3, 3, 3),), tol=CONV_TOL)],
    # pooling
    "MaxPool1D": [L((3, 2, 1), inputs=(n_(2, 3, 9),))],
    "MaxPool2D": [L((3, 2, 1), inputs=(POOL_X,)), L((2,), inputs=(POOL_X,))],
    "MaxPool3D": [L((2,), inputs=(n_(1, 2, 4, 4, 4),))],
    "AvgPool1D": [L((3, 2, 1), inputs=(n_(2, 3, 9),))],
    "AvgPool2D": [L((3, 2, 1), inputs=(POOL_X,))],
    "AvgPool3D": [L((3, 2, 1), inputs=(n_(1, 2, 5, 5, 5),))],
    "AdaptiveAvgPool1D": [L((4,), inputs=(n_(2, 3, 10),))],
    "AdaptiveAvgPool2D": [L(([3, 4],), inputs=(POOL_X,))],
    "AdaptiveAvgPool3D": [L(([2, 3, 3],), inputs=(n_(1, 2, 5, 6, 7),))],
    "AdaptiveMaxPool1D": [L((4,), inputs=(n_(2, 3, 10),))],
    "AdaptiveMaxPool2D": [L(([3, 4],), inputs=(POOL_X,))],
    "AdaptiveMaxPool3D": [L(([2, 3, 3],), inputs=(n_(1, 2, 5, 6, 7),))],
    "MaxUnPool1D": [L((3,), inputs=(n_(2, 3, 3, seed=4), MASK1))],
    "MaxUnPool2D": [L((2,), inputs=(n_(2, 3, 4, 4, seed=4), MASK2))],
    "MaxUnPool3D": [L((2,), inputs=(n_(1, 2, 2, 2, 2, seed=4), MASK3))],
    # norm
    "BatchNorm": [L((3,), inputs=(IMG,))],
    "BatchNorm1D": [L((3,), inputs=(n_(4, 3, 5),))],
    "BatchNorm2D": [L((3,), {"momentum": 0.8}, inputs=(IMG,)),
                    L((3,), {"data_format": "NHWC"},
                      inputs=(np.ascontiguousarray(IMG.transpose(0, 2, 3,
                                                                 1)),))],
    "BatchNorm3D": [L((2,), inputs=(n_(2, 2, 3, 3, 3),))],
    "SyncBatchNorm": [L((3,), inputs=(IMG,))],
    "LayerNorm": [L((4,))],
    "GroupNorm": [L((3, 6), inputs=(n_(2, 6, 3, 3),))],
    "InstanceNorm1D": [L((3,), inputs=(n_(2, 3, 6),))],
    "InstanceNorm2D": [L((3,), inputs=(IMG,))],
    "InstanceNorm3D": [L((2,), inputs=(n_(2, 2, 3, 3, 3),))],
    "LocalResponseNorm": [L((3,), inputs=(n_(2, 7, 3, 3),))],
    "SpectralNorm": [L(([4, 6],), {"power_iters": 3},
                       inputs=(n_(4, 6, seed=3),))],
    # loss
    "CrossEntropyLoss": [L(inputs=(n_(5, 6), i32(5, hi=6)), grad=(0,))],
    "MSELoss": [L(inputs=(X, n_(3, 4, seed=1)), grad=(0, 1))],
    "L1Loss": [L(("sum",), inputs=(X, n_(3, 4, seed=1)), grad=(0, 1))],
    "SmoothL1Loss": [L(("mean", 0.5), inputs=(X, n_(3, 4, seed=1)),
                       grad=(0, 1))],
    "NLLLoss": [L(inputs=(_logp(n_(5, 6)), i32(5, hi=6)), grad=(0,))],
    "BCELoss": [L(inputs=(u(3, 4, lo=0.05, hi=0.95), (SIGN > 0).astype(
        np.float32)), grad=(0,))],
    "BCEWithLogitsLoss": [L(inputs=(X, (SIGN > 0).astype(np.float32)),
                            grad=(0,))],
    "KLDivLoss": [L(("batchmean",), inputs=(_logp(X), _prob(n_(3, 4,
                                                                seed=1))),
                    grad=(0,))],
    "MarginRankingLoss": [L((0.1,), inputs=(n_(6), n_(6, seed=1),
                                            SIGN.reshape(-1)[:6]),
                            grad=(0, 1))],
    "HingeEmbeddingLoss": [L(inputs=(X, SIGN), grad=(0,))],
    "HSigmoidLoss": [L((5, 6), inputs=(n_(4, 5), i32(4, hi=6)), grad=(0,))],
})
# containers and the clip objects have tests of their own below
OWN_TESTS = {"Sequential", "LayerList", "LayerDict", "ParameterList",
             "Layer", "ClipGradByNorm", "ClipGradByValue",
             "ClipGradByGlobalNorm"}
# the sequence slice's names, held to the reference in
# test_torch_rnn.py, test_torch_transformer.py, test_torch_decode.py and
# test_torch_ctc.py
SEQUENCE_SLICE = {"RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
                  "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
                  "dynamic_decode", "MultiHeadAttention", "Transformer",
                  "TransformerEncoder", "TransformerEncoderLayer",
                  "TransformerDecoder", "TransformerDecoderLayer",
                  "BeamSearchDecoder", "CTCLoss"}
with open(os.path.join(os.path.dirname(__file__),
                       "reference_api_all.json")) as _f:
    NN_NAMES = [n for n in json.load(_f)["paddle.nn"]
                if n not in SEQUENCE_SLICE]
# modes that change a layer's forward
MODAL = {"Dropout", "Dropout2D", "Dropout3D", "AlphaDropout", "BatchNorm",
         "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm"}
RANDOM_IN_TRAINING = {"Dropout", "Dropout2D", "Dropout3D", "AlphaDropout"}


def _inputs(pkg, case):
    out = []
    for i, a in enumerate(case.inputs):
        out.append(pkg.to_tensor(a, stop_gradient=i not in case.grad)
                   if isinstance(a, np.ndarray) else a)
    return out


def _np(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    return np.asarray(o._value)


def _pair(name, case):
    pt.seed(0)
    paddle.seed(0)
    j = getattr(jnn, name)(*case.args, **case.kw)
    t = getattr(tnn, name)(*case.args, **case.kw)
    return j, t


def _check_state(name, j, t):
    js, ts = _state(j), t.state_dict()
    assert sorted(js) == sorted(ts), f"{name}: keys {sorted(ts)} vs " \
                                     f"{sorted(js)}"
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, f"{name}.{k} shape"
    jb = sorted(k for k, _ in j.named_buffers())
    tb = sorted(k for k, _ in t.named_buffers())
    assert jb == tb, f"{name}: buffers {tb} vs {jb}"


def _forward(name, j, t, case, grads=True):
    ji, ti = _inputs(paddle, case), _inputs(pt, case)
    want, got = j(*ji), t(*ti)
    wo = want[0] if isinstance(want, (list, tuple)) else want
    go = got[0] if isinstance(got, (list, tuple)) else got
    np.testing.assert_allclose(_np(go), _np(wo), rtol=case.tol,
                               atol=case.tol, err_msg=name)
    if not grads or not (case.grad or list(t.parameters())):
        return
    if not any(not p.stop_gradient for p in j.parameters()) and \
            not case.grad:
        return
    paddle.sum(wo).backward()
    pt.sum(go).backward()
    for i in case.grad:
        np.testing.assert_allclose(ti[i].gradient(), ji[i].gradient(),
                                   rtol=case.tol, atol=case.tol,
                                   err_msg=f"{name} input grad {i}")
    jp = dict(j.named_parameters())
    for k, p in t.named_parameters():
        if jp[k].grad is None:
            assert p.grad is None or not p.grad.any(), f"{name}.{k} grad"
            continue
        np.testing.assert_allclose(p.gradient(), jp[k].gradient(),
                                   rtol=case.tol, atol=case.tol,
                                   err_msg=f"{name}.{k} grad")


@pytest.mark.parametrize("name", [n for n in NN_NAMES
                                  if n not in OWN_TESTS])
def test_layer_matches_the_reference(name):
    assert name in LAYERS, f"no case for layer {name}"
    for case in LAYERS[name]:
        j, t = _pair(name, case)
        _check_state(name, j, t)
        load_numpy_state(t, _state(j))
        if name in MODAL:
            j.eval()
            t.eval()
            _forward(name, j, t, case)
            j.train()
            t.train()
        if name in RANDOM_IN_TRAINING:
            continue
        _forward(name, j, t, case)
        if name in MODAL:    # the running statistics after training calls
            for _ in range(2):
                _forward(name, j, t, case, grads=False)
            ts = {k: v.numpy() for k, v in t.state_dict().items()}
            for k, v in _state(j).items():
                np.testing.assert_allclose(ts[k], v, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name}.{k}")


def test_every_reference_layer_is_exported():
    missing = [n for n in NN_NAMES + sorted(SEQUENCE_SLICE)
               if not hasattr(tnn, n)]
    assert not missing, f"layers the port does not export: {missing}"


@pytest.mark.parametrize("name", ["Dropout", "Dropout2D", "Dropout3D",
                                  "AlphaDropout"])
def test_dropout_layers_switch_with_train_and_eval(name):
    case = LAYERS[name][0]
    t = getattr(tnn, name)(*case.args)
    x = pt.to_tensor(np.abs(case.inputs[0]) + 0.5)
    t.eval()
    np.testing.assert_array_equal(t(x).numpy(), x.numpy())
    t.train()
    pt.seed(0)
    out = t(x).numpy()
    assert not np.array_equal(out, x.numpy())


# ---- ParamAttr, Parameter, create_parameter --------------------------------
def test_param_attr_initializer_learning_rate_and_trainable():
    for pkg, nn_ in ((paddle, jnn), (pt, tnn)):
        lin = nn_.Linear(
            3, 4, weight_attr=pkg.ParamAttr(
                initializer=nn_.initializer.Constant(0.3),
                learning_rate=0.5),
            bias_attr=pkg.ParamAttr(trainable=False,
                                    initializer=nn_.initializer.Constant(2.)))
        w, b = lin.weight, lin.bias
        np.testing.assert_array_equal(_np(w), np.full((3, 4), 0.3,
                                                      np.float32))
        np.testing.assert_array_equal(_np(b), np.full(4, 2.0, np.float32))
        assert w.optimize_attr["learning_rate"] == 0.5
        assert not w.stop_gradient and w.trainable
        assert b.stop_gradient and not b.trainable
        assert b.optimize_attr["learning_rate"] == 1.0
    assert isinstance(lin.weight, torch.nn.Parameter)
    assert isinstance(lin.weight, pt.Parameter)
    trainable, frozen = split_state(lin)
    assert list(trainable) == ["weight"] and list(frozen) == ["bias"]


def test_parameter_surface():
    p = pt.create_parameter([2, 3], "float32", name="w0")
    assert isinstance(p, torch.nn.Parameter) and p.name == "w0"
    assert p.persistable and p.need_clip and p.regularizer is None
    assert p.gradient() is None
    p.stop_gradient = True
    assert not p.requires_grad
    p.stop_gradient = False
    (p * 2).sum().backward()
    np.testing.assert_array_equal(p.gradient(), np.full((2, 3), 2.0))
    # torch's own code sees a plain tensor: paddle's split is not called
    assert len(torch.split(p, 1)) == 2
    assert type(p + 1) is torch.Tensor
    j = paddle.create_parameter([2, 3], "float32", name="w0")
    assert j.name == p.name and j.shape == list(p.shape)


def test_global_initializer_overrides_defaults_not_param_attr():
    for pkg, nn_ in ((paddle, jnn), (pt, tnn)):
        I = nn_.initializer
        I.set_global_initializer(I.Constant(0.7), I.Constant(-0.2))
        try:
            lin = nn_.Linear(3, 4)
            conv = nn_.Conv2D(2, 3, 3)
            own = nn_.Linear(3, 4, weight_attr=pkg.ParamAttr(
                initializer=I.Constant(1.5)))
        finally:
            I.set_global_initializer(None, None)
        for p, v in ((lin.weight, 0.7), (lin.bias, -0.2),
                     (conv.weight, 0.7), (conv.bias, -0.2),
                     (own.weight, 1.5), (own.bias, -0.2)):
            np.testing.assert_array_equal(_np(p), np.full(p.shape, v,
                                                          np.float32))
        after = nn_.Linear(3, 4)
        assert np.abs(_np(after.bias)).max() == 0.0
        assert np.abs(_np(after.weight)).std() > 0


# ---- initializers ------------------------------------------------------------
def _draw(pkg, nn_, init, shape):
    pkg.seed(0)
    if pkg is pt:
        return init(shape).numpy()
    p = jnn.Linear(1, 1).create_parameter(list(shape),
                                          default_initializer=init)
    return np.asarray(p._value)


@pytest.mark.parametrize("name,args,kw,shape", [
    ("Normal", (0.5, 2.0), {}, (400, 300)),
    ("TruncatedNormal", (0.1, 0.5), {}, (400, 300)),
    ("Uniform", (-0.3, 0.7), {}, (400, 300)),
    ("XavierNormal", (), {}, (300, 200)),
    ("XavierUniform", (), {}, (300, 200)),
    ("XavierUniform", (), {"fan_in": 50, "fan_out": 70}, (300, 200)),
    ("KaimingNormal", (), {}, (64, 32, 3, 3)),
    ("KaimingUniform", (), {"fan_in": 27}, (64, 32, 3, 3)),
    ("KaimingUniform", (), {"negative_slope": 0.2}, (200, 300)),
])
def test_drawn_initializer_moments_match(name, args, kw, shape):
    j = _draw(paddle, jnn, getattr(jnn.initializer, name)(*args, **kw), shape)
    t = _draw(pt, tnn, getattr(tnn.initializer, name)(*args, **kw), shape)
    assert t.shape == j.shape and t.dtype == j.dtype
    # the means within 5 standard errors of their difference, the stds
    # within 2%
    se = j.std() * np.sqrt(2.0 / j.size)
    assert abs(t.mean() - j.mean()) < 5 * se, (t.mean(), j.mean())
    assert abs(t.std() - j.std()) < 2e-2 * j.std(), (t.std(), j.std())
    assert abs(t.min() - j.min()) < 0.1 * (j.max() - j.min())
    assert abs(t.max() - j.max()) < 0.1 * (j.max() - j.min())


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.25,), (3, 4)),
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), (3, 4)),
    ("Assign", (np.arange(12, dtype=np.float32),), (3, 4)),
    ("Dirac", (), (4, 3, 3, 3)),
    ("Dirac", (), (2, 5, 3)),
])
def test_deterministic_initializers_match(name, args, shape):
    j = _draw(paddle, jnn, getattr(jnn.initializer, name)(*args), shape)
    t = _draw(pt, tnn, getattr(tnn.initializer, name)(*args), shape)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("shape", [(4, 4, 3, 3), (2, 3, 4, 4)])
def test_bilinear_initializer_matches(shape):
    want = np.asarray(jnn.initializer.Bilinear()(shape))
    got = tnn.initializer.Bilinear()(shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,gain", [((6, 10), 1.0), ((10, 4), 2.0),
                                        ((4, 2, 3), 0.5)])
def test_orthogonal_initializer(shape, gain):
    t = _draw(pt, tnn, tnn.initializer.Orthogonal(gain), shape)
    j = _draw(paddle, jnn, jnn.initializer.Orthogonal(gain), shape)
    m = t.reshape(shape[0], -1)
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    np.testing.assert_allclose(gram, gain ** 2 * np.eye(gram.shape[0]),
                               atol=1e-5)
    jm = j.reshape(shape[0], -1)
    jg = jm @ jm.T if jm.shape[0] <= jm.shape[1] else jm.T @ jm
    np.testing.assert_allclose(jg, gram, atol=1e-5)


def test_calculate_gain_and_initializer_call_forms():
    for nl, param in (("tanh", None), ("relu", None), ("leaky_relu", None),
                      ("leaky_relu", 0.2), ("selu", None), ("conv2d", None)):
        assert tnn.initializer.calculate_gain(nl, param) == \
            jnn.initializer.calculate_gain(nl, param)
    with pytest.raises(ValueError):
        tnn.initializer.calculate_gain("swish")
    names = json.load(open(os.path.join(os.path.dirname(__file__),
                                        "reference_api_all.json")))[
        "paddle.nn.initializer"]
    assert all(hasattr(tnn.initializer, n) for n in names)
    p = pt.create_parameter([2, 2], "float32")
    assert tnn.initializer.Constant(3.0)(p) is p
    np.testing.assert_array_equal(p.detach().numpy(), np.full((2, 2), 3.0))


# ---- nn.utils ------------------------------------------------------------------
@pytest.mark.parametrize("make,dim", [
    (lambda nn_: nn_.Linear(4, 5), 0),
    (lambda nn_: nn_.Linear(4, 5), 1),
    (lambda nn_: nn_.Linear(4, 5), None),
    (lambda nn_: nn_.Conv2D(3, 4, 3), 0)])
def test_weight_norm(make, dim):
    pt.seed(0)
    j, t = make(jnn), make(tnn)
    load_numpy_state(t, _state(j))
    x = n_(2, 3, 5, 5) if isinstance(t, tnn.Conv2D) else n_(3, 4)
    jnn.utils.weight_norm(j, dim=dim)
    tnn.utils.weight_norm(t, dim=dim)
    assert sorted(t.state_dict()) == sorted(_state(j)) == \
        ["bias", "weight_g", "weight_v"]
    for k, v in _state(j).items():
        np.testing.assert_allclose(t.state_dict()[k].numpy(), v, rtol=1e-6,
                                   atol=1e-6)
    jx, tx = paddle.to_tensor(x), pt.to_tensor(x)
    want, got = j(jx), t(tx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CONV_TOL,
                               atol=CONV_TOL)
    paddle.sum(want * want).backward()
    pt.sum(got * got).backward()
    jp = dict(j.named_parameters())
    for k, p in t.named_parameters():
        np.testing.assert_allclose(p.gradient(), jp[k].gradient(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    jnn.utils.remove_weight_norm(j)
    tnn.utils.remove_weight_norm(t)
    assert sorted(t.state_dict()) == ["bias", "weight"]
    np.testing.assert_allclose(t.weight.detach().numpy(),
                               np.asarray(j.weight._value), rtol=1e-5,
                               atol=1e-6)
    assert isinstance(t.weight, pt.Parameter)


@pytest.mark.parametrize("make", [lambda nn_: nn_.Linear(4, 5),
                                  lambda nn_: nn_.Conv2D(3, 4, 3),
                                  lambda nn_: nn_.Conv2DTranspose(3, 4, 3)])
def test_spectral_norm(make):
    pt.seed(0)
    j, t = make(jnn), make(tnn)
    load_numpy_state(t, _state(j))
    x = n_(3, 4) if isinstance(t, tnn.Linear) else n_(2, 3, 5, 5)
    jnn.utils.spectral_norm(j, n_power_iterations=2)
    tnn.utils.spectral_norm(t, n_power_iterations=2)
    assert sorted(t.state_dict()) == sorted(_state(j)) == \
        ["bias", "weight_orig"]
    for _ in range(2):
        want, got = j(paddle.to_tensor(x)), t(pt.to_tensor(x))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CONV_TOL,
                                   atol=CONV_TOL)
    np.testing.assert_allclose(t._weight_u, j._weight_u, rtol=1e-5,
                               atol=1e-6)


def test_parameters_to_vector_round_trip():
    pt.seed(0)
    t = tnn.Linear(3, 4)
    j = jnn.Linear(3, 4)
    load_numpy_state(t, _state(j))
    v = tnn.utils.parameters_to_vector(t.parameters())
    jv = jnn.utils.parameters_to_vector(j.parameters())
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv._value))
    tnn.utils.vector_to_parameters(v * 2, t.parameters())
    np.testing.assert_array_equal(t.weight.detach().numpy(),
                                  2 * np.asarray(j.weight._value))


def test_clip_grad_norm_():
    g = [n_(3, 4), n_(5, seed=1)]
    for norm_type in (2.0, float("inf"), 1.0):
        tps = [pt.create_parameter(list(a.shape), "float32") for a in g]
        jps = [paddle.create_parameter(list(a.shape), "float32") for a in g]
        for tp, jp, a in zip(tps, jps, g):
            tp.grad = torch.from_numpy(a.copy())
            jp.grad = paddle.to_tensor(a)._value
        tot = tnn.utils.clip_grad_norm_(tps, 0.5, norm_type)
        jtot = jnn.utils.clip_grad_norm_(jps, 0.5, norm_type)
        np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-6)
        for tp, jp in zip(tps, jps):
            np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad),
                                       rtol=1e-6, atol=1e-7)


# ---- containers and the Layer surface ----------------------------------------
def _seq(nn_, form):
    a, b, c = nn_.Linear(3, 4), nn_.ReLU(), nn_.Linear(4, 2)
    if form == "positional":
        return nn_.Sequential(a, b, c)
    if form == "tuples":
        return nn_.Sequential(("fc1", a), ("act", b), ("fc2", c))
    return nn_.Sequential(collections.OrderedDict(
        [("fc1", a), ("act", b), ("fc2", c)]))


@pytest.mark.parametrize("form", ["positional", "tuples", "ordered_dict"])
def test_sequential_forms_and_names(form):
    j, t = _seq(jnn, form), _seq(tnn, form)
    assert sorted(t.state_dict()) == sorted(_state(j))
    load_numpy_state(t, _state(j))
    x = n_(5, 3)
    np.testing.assert_allclose(t(pt.to_tensor(x)).numpy(),
                               j(paddle.to_tensor(x)).numpy(), rtol=TOL,
                               atol=TOL)
    assert len(t) == len(j) == 3
    assert type(t[1]).__name__ == "ReLU" and len(t[1:]) == 2
    assert [type(m).__name__ for m in t] == [type(m).__name__ for m in j]
    if form != "positional":
        assert type(t["fc2"]).__name__ == "Linear"
    outer_j = jnn.Sequential(("features", j), ("head", jnn.Linear(2, 2)))
    outer_t = tnn.Sequential(("features", t), ("head", tnn.Linear(2, 2)))
    assert sorted(outer_t.state_dict()) == sorted(_state(outer_j))


def test_layer_dict_and_parameter_list_names():
    jd = jnn.LayerDict({"a": jnn.Linear(2, 3), "b": jnn.Linear(3, 1)})
    td = tnn.LayerDict({"a": tnn.Linear(2, 3), "b": tnn.Linear(3, 1)})
    assert sorted(td.state_dict()) == sorted(_state(jd))
    td["c"] = tnn.ReLU()
    assert list(td.keys()) == ["a", "b", "c"] and "c" in td and len(td) == 3
    assert type(td.pop("c")).__name__ == "ReLU"
    td.update([("d", tnn.Tanh())])
    assert list(td) == ["a", "b", "d"]
    params = [n_(2, 2), n_(3, seed=1)]
    jl = jnn.ParameterList([paddle.create_parameter(list(p.shape), "float32")
                            for p in params])
    tl = tnn.ParameterList([pt.create_parameter(list(p.shape), "float32")
                            for p in params])
    assert sorted(tl.state_dict()) == sorted(_state(jl)) == ["0", "1"]
    tl.append(pt.create_parameter([4], "float32"))
    assert len(tl) == 3 and tuple(tl[2].shape) == (4,)


class _Net:
    @staticmethod
    def make(nn_):
        class Net(nn_.Layer):
            def __init__(self):
                super().__init__()
                self.body = nn_.Sequential(nn_.Conv2D(3, 4, 3),
                                           nn_.BatchNorm2D(4))
                self.head = nn_.Linear(4, 2)

            def forward(self, x):
                return self.head(self.body(x).mean(axis=[2, 3]))

        return Net()


def test_layer_surface_buffers_hooks_sublayers_apply():
    j, t = _Net.make(jnn), _Net.make(tnn)
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    assert [type(m).__name__ for m in t.sublayers(include_self=True)] == \
        [type(m).__name__ for m in j.sublayers(include_self=True)]
    order_j, order_t = [], []
    j.apply(lambda m: order_j.append(type(m).__name__))
    t.apply(lambda m: order_t.append(type(m).__name__))
    assert order_t == order_j
    assert t.full_name() == j.full_name() == "net"
    for layer, pkg in ((j, paddle), (t, pt)):
        layer.register_buffer("step", pkg.to_tensor(np.zeros(1, np.float32)),
                              persistable=False)
        layer.register_buffer("kept", pkg.to_tensor(np.ones(1, np.float32)))
    assert sorted(t.state_dict()) == sorted(_state(j))
    assert "step" not in t.state_dict() and "kept" in t.state_dict()
    load_numpy_state(t, _state(j))
    seen = {}
    for layer in (j, t):
        def pre(m, inputs, layer=layer):
            seen.setdefault(id(layer), []).append("pre")
            return (inputs[0] * 2,)

        def post(m, inputs, outputs, layer=layer):
            seen[id(layer)].append("post")
            return outputs + 1

        h1 = layer.head.register_forward_pre_hook(pre)
        h2 = layer.head.register_forward_post_hook(post)
        layer.eval()
        want = layer(paddle.to_tensor(IMG) if layer is j
                     else pt.to_tensor(IMG))
        seen[id(layer)].append(_np(want))
        h1.remove()
        h2.remove()
    a, b = seen[id(j)], seen[id(t)]
    assert a[:2] == b[:2] == ["pre", "post"]
    np.testing.assert_allclose(b[2], a[2], rtol=CONV_TOL, atol=CONV_TOL)
    plain = t(pt.to_tensor(IMG)).numpy()
    assert not np.allclose(plain, b[2])
