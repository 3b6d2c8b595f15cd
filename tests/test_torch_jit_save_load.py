"""The port's `jit.save` / `jit.load` (`jit/save_load.py`,
`framework/version.py`) against the JAX package on the CPU.

For one model (ResNet-18, NHWC, 10 classes) built in JAX and carried into
the port by name, both packages save the same weights in fp32, bf16 and
weight-only int8: the `.pdiparams.npz` files must hold the same keys,
dtypes and bytes (bf16 bit-equal, int8 `q` bit-equal, the scales equal),
and the `.pdmodel.json` files the same meta apart from the version stamp.
Each package then loads its own artifact and runs one seeded batch: the
port's output within 1e-5 (1 + |ref|) of the reference's in fp32, and
within two bf16 roundings of max|ref| (2^-7) in bf16 and int8. The port
refuses the reference's StableHLO `.pdmodel` and an incompatible version.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import models as jmodels
from paddle_tpu import quantization as jquant
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.enforce import UnimplementedError
from paddle_tpu_torch.utils import load_numpy_state

TOL = 1e-5
BF16_TOL = 2.0 ** -7
SHAPE = [2, 16, 16, 3]


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _state(jlayer):
    return {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    pt.set_device("cpu")
    paddle.seed(0)
    j = jmodels.resnet18(num_classes=10, data_format="NHWC")
    t = pt.models.resnet18(num_classes=10, data_format="NHWC")
    load_numpy_state(t, _state(j))
    # running statistics away from 0 / 1, so the artifacts carry them
    rng = np.random.default_rng(3)
    jbufs = dict(j.named_buffers())
    for k, tb in t.named_buffers():
        v = rng.uniform(0.5, 1.5, tuple(tb.shape)).astype(np.float32)
        jbufs[k]._value = jnp.asarray(v)
        tb.copy_(torch.from_numpy(v))
    j.eval()
    t.eval()
    return j, t


@pytest.fixture(scope="module")
def saved(pair, tmp_path_factory):
    j, t = pair
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for prec in (None, "bfloat16", "int8"):
        jp, tp = str(root / f"j_{prec}"), str(root / f"t_{prec}")
        jjit.save(j, jp, input_spec=[jjit.InputSpec(SHAPE, "float32")],
                  precision=prec)
        pt.jit.save(t, tp, input_spec=[pt.InputSpec(SHAPE, "float32")],
                    precision=prec)
        out[prec] = (jp, tp)
    return out


class TestJitSaveLoad:
    """`tests/test_jit_amp_io.py::TestJitSaveLoad` in the port."""

    def test_roundtrip(self, tmp_path):
        pt.seed(0)
        net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                               pt.nn.Linear(16, 4))
        net.eval()
        x = pt.to_tensor(np.random.rand(2, 8).astype("float32"))
        ref = net(x).numpy()
        path = str(tmp_path / "model")
        pt.jit.save(net, path, input_spec=[pt.InputSpec([2, 8], "float32")])
        loaded = pt.jit.load(path)
        out = loaded(x)
        assert isinstance(out, pt.Tensor)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
        assert sorted(loaded.state_dict()) == sorted(net.state_dict())


@pytest.mark.parametrize("prec", [None, "bfloat16", "int8"])
def test_npz_and_meta_equal_the_reference(saved, prec):
    jp, tp = saved[prec]
    with np.load(jp + ".pdiparams.npz") as a, \
            np.load(tp + ".pdiparams.npz") as b:
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        if prec == "int8":
            assert any(a[k].dtype == np.int8 for k in a)
            assert any(k.startswith("b::__scale__") for k in a)
    with open(jp + ".pdmodel.json") as f:
        jm = json.load(f)
    with open(tp + ".pdmodel.json") as f:
        tm = json.load(f)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        if k != "framework_version":
            assert jm[k] == tm[k], k
    assert tm["framework_version"] == pt.framework.version.FRAMEWORK_VERSION


@pytest.mark.parametrize("prec", [None, "bfloat16", "int8"])
def test_loaded_artifact_matches_the_reference_artifact(saved, prec):
    jp, tp = saved[prec]
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    jl, tl = jjit.load(jp), pt.jit.load(tp)
    jx = jnp.asarray(x) if prec is None else \
        jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jl(jx)._value.astype(jnp.float32))
    tx = torch.from_numpy(x)
    got = tl(tx if prec is None else tx.to(torch.bfloat16)).float().numpy()
    if prec is None:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    dtypes = dict(zip(tl._meta["param_names"], tl._params))
    for n in tl._meta["quantized"]:
        assert dtypes[n].dtype == torch.int8


def test_reference_artifact_is_refused(saved):
    jp, _ = saved[None]
    with pytest.raises(UnimplementedError, match="StableHLO"):
        pt.jit.load(jp)


def test_incompatible_version_raises_and_op_changes_warn(saved, tmp_path):
    _, tp = saved[None]
    with open(tp + ".pdmodel.json") as f:
        meta = json.load(f)
    path = str(tmp_path / "m")
    for ext in (".pdmodel", ".pdiparams.npz"):
        with open(tp + ext, "rb") as src, open(path + ext, "wb") as dst:
            dst.write(src.read())
    for version in ("1.9.0-torch", "not-a-version", None):
        with open(path + ".pdmodel.json", "w") as f:
            json.dump(dict(meta, framework_version=version), f)
        with pytest.raises(RuntimeError, match="incompatible version"):
            pt.jit.load(path)
    with open(path + ".pdmodel.json", "w") as f:
        json.dump(dict(meta, op_versions={"embedding": 0}), f)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pt.jit.load(path)
    assert any("op semantics changed since save: embedding: v0 -> v1"
               in str(w.message) for w in caught)


def test_precision_spellings_and_argument_errors(tmp_path):
    pt.seed(0)
    net = pt.models.LeNet(num_classes=10)
    spec = [pt.InputSpec([1, 1, 28, 28], "float32")]
    for prec in ("float16", "half", "fp16", "bf16"):
        path = str(tmp_path / prec)
        pt.jit.save(net, path, input_spec=spec, precision=prec)
        with open(path + ".pdmodel.json") as f:
            meta = json.load(f)
        assert meta["precision"] == prec
        assert set(meta["param_dtypes"]) == {"bfloat16"}
        assert meta["input_specs"] == [{"shape": [1, 1, 28, 28],
                                        "dtype": "bfloat16"}]
    path = str(tmp_path / "w8")
    pt.jit.save(net, path, input_spec=spec, precision="int8_weight_only")
    with open(path + ".pdmodel.json") as f:
        assert json.load(f)["precision"] == "int8"
    with pytest.raises(ValueError, match="unsupported save precision"):
        pt.jit.save(net, path, input_spec=spec, precision="int4")
    with pytest.raises(ValueError, match="input_spec"):
        pt.jit.save(net, path)
    with pytest.raises(UnimplementedError, match="to_static"):
        pt.jit.save(lambda x: x, path, input_spec=spec)
    with pytest.raises(TypeError):
        pt.jit.save(3, path, input_spec=spec)
    assert net.training      # save restores the training flag


def test_dynamic_dim_exports_as_one(tmp_path):
    pt.seed(0)
    net = pt.nn.Linear(4, 3)
    path = str(tmp_path / "dyn")
    pt.jit.save(net, path, input_spec=[pt.InputSpec([None, 4], "float32")])
    tl = pt.jit.load(path)
    assert tl._meta["input_specs"][0]["shape"] == [-1, 4]
    x = torch.ones(1, 4)
    np.testing.assert_allclose(tl(x).detach().numpy(),
                               net(x).detach().numpy(), rtol=1e-6)


def _tiny_gpt(seq):
    pt.seed(0)
    return pt.models.GPTForCausalLM(pt.models.GPTModel(
        vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
        max_seq_len=seq, dropout=0.0))


def _flash_nodes(tl):
    return sum(str(n.target) == "paddle_tpu_torch.flash_fwd.default"
               for n in tl.program().graph.nodes)


def test_cpu_export_takes_the_einsum_path(tmp_path):
    """The dispatch rule is read at export: at bf16 and S=1024 attention
    takes the kernel on CUDA inputs only, so an artifact exported on the
    CPU holds the einsum path."""
    lm = _tiny_gpt(1024)
    path = str(tmp_path / "gpt")
    pt.jit.save(lm, path, input_spec=[pt.InputSpec([1, 1024], "int32")],
                precision="bfloat16")
    assert _flash_nodes(pt.jit.load(path)) == 0


def test_flash_operator_survives_export_and_load(tmp_path, monkeypatch):
    """A program that calls the registered flash forward
    (`paddle_tpu_torch::flash_fwd`, traced through its fake) saves, loads
    and runs: on the CPU the operator runs the kernel's plain version."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.models import ernie

    def kernel_always(q, k, v, attn_mask=None, dropout_p=0.0,
                      is_causal=False, training=True, name=None):
        return flash_attention(q, k, v, causal=is_causal)

    lm = _tiny_gpt(64)
    lm.eval()
    ids = np.random.default_rng(0).integers(0, 128, (2, 64)).astype(
        np.int32)
    path = str(tmp_path / "gpt")
    monkeypatch.setattr(ernie, "scaled_dot_product_attention",
                        kernel_always)
    pt.jit.save(lm, path, input_spec=[pt.InputSpec([2, 64], "int32")])
    want = lm(torch.from_numpy(ids)).detach().numpy()
    monkeypatch.undo()
    tl = pt.jit.load(path)
    assert _flash_nodes(tl) == 2
    np.testing.assert_allclose(tl(torch.from_numpy(ids)).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_quantize_weights_matches_the_reference():
    paddle.seed(0)
    j = jmodels.LeNet(num_classes=10)
    t = pt.models.LeNet(num_classes=10)
    load_numpy_state(t, _state(j))
    want = jquant.quantize_weights(j)
    got = pt.quantization.quantize_weights(t)
    assert sorted(got) == sorted(want)
    for k, (q, s) in want.items():
        np.testing.assert_array_equal(got[k][0], q)
        np.testing.assert_array_equal(got[k][1], s)
    js = _state(j)
    for k, v in t.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), js[k])
    deq_want = jquant.dequantize_weights(want)
    for k, v in pt.quantization.dequantize_weights(got).items():
        np.testing.assert_array_equal(v, deq_want[k])
