"""The port's deploy path (`inference.Config` / `create_predictor` over a
`jit.save` artifact, `serving.ServingEngine` over it, `utils/bench.py
--arm resnet50_infer`) against the JAX package on the CPU.

Counterparts of the reference's `tests/test_quant_asp.py:258-301` (the
int8 artifact within 0.08 of fp32 by max|got - ref| / max|ref|, its npz
under 0.45x the fp32 one, its quantized parameters int8, `enable_quant()`
on an fp32 artifact refused) and `tests/test_jit_amp_io.py:278-327` (the
predictor round trip, the recorded `Config` knobs); the port's predictor
output is held to the reference's on the same weights within 1e-5
(1 + |ref|).
"""
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import jit as jjit
from paddle_tpu import models as jmodels
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.enforce import InvalidArgumentError, NotFoundError
from paddle_tpu_torch.utils import bench, load_numpy_state

TOL = 1e-5
SPEC = [4, 1, 28, 28]


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _lenet():
    pt.seed(0)
    net = pt.models.LeNet(num_classes=10)
    net.eval()
    return net


def _save(tmp_path, net, precision=None):
    path = str(tmp_path / f"m_{precision or 'fp32'}")
    pt.jit.save(net, path, input_spec=[pt.InputSpec(SPEC, "float32")],
                precision=precision)
    return path, os.path.getsize(path + ".pdiparams.npz")


def _predict(path, x, quant=False):
    cfg = pt.inference.Config(path)
    if quant:
        cfg.enable_quant()
    pred = pt.inference.create_predictor(cfg)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    pred.run()
    return pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()


def _x(seed=0):
    return np.random.RandomState(seed).rand(*SPEC).astype("float32")


def test_int8_predictor_runs_close_to_fp32(tmp_path):
    net = _lenet()
    p32, sz32 = _save(tmp_path, net)
    p8, sz8 = _save(tmp_path, net, "int8")
    assert sz8 < sz32 * 0.45, (sz8, sz32)
    x = _x()
    ref = _predict(p32, x)
    got = _predict(p8, x, quant=True)
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.08, rel


def test_int8_artifact_params_are_int8(tmp_path):
    p8, _ = _save(tmp_path, _lenet(), "int8")
    tl = pt.jit.load(p8)
    qnames = tl._meta["quantized"]
    assert qnames == [n for n, p in _lenet().named_parameters()
                      if p.dim() >= 2]
    by_name = dict(zip(tl._meta["param_names"], tl._params))
    for n in qnames:
        assert by_name[n].dtype == torch.int8, n
    assert [b for b in tl._meta["buffer_names"]
            if b.startswith("__scale__")] == [f"__scale__{n}" for n in qnames]


def test_enable_quant_on_fp32_artifact_raises(tmp_path):
    p32, _ = _save(tmp_path, _lenet())
    cfg = pt.inference.Config(p32)
    cfg.enable_quant()
    with pytest.raises(InvalidArgumentError, match="int8 artifact"):
        pt.inference.create_predictor(cfg)
    cfg = pt.inference.Config(p32)
    cfg.enable_tensorrt_engine(precision_mode="int8")
    with pytest.raises(InvalidArgumentError, match="int8 artifact"):
        pt.inference.create_predictor(cfg)


def test_predictor_roundtrip_matches_the_reference(tmp_path):
    """`test_jit_amp_io.py::TestInference::test_predictor_roundtrip` in both
    packages on the same LeNet weights."""
    paddle.seed(0)
    j = jmodels.LeNet(num_classes=10)
    j.eval()
    t = pt.models.LeNet(num_classes=10)
    load_numpy_state(t, {k: np.asarray(v._value)
                         for k, v in j.state_dict().items()})
    t.eval()
    x = _x(1)
    jp = str(tmp_path / "j")
    jjit.save(j, jp, input_spec=[jjit.InputSpec(SPEC, "float32")])
    jcfg = jinference.Config(jp + ".pdmodel")
    jpred = jinference.create_predictor(jcfg)
    jpred.get_input_handle(jpred.get_input_names()[0]).copy_from_cpu(x)
    jpred.run()
    want = jpred.get_output_handle(
        jpred.get_output_names()[0]).copy_to_cpu()
    tp, _ = _save(tmp_path, t)
    got = _predict(tp + ".pdmodel", x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got, t(torch.from_numpy(x)).detach().numpy(), rtol=TOL, atol=TOL)


def test_config_knobs_are_recorded_not_silent():
    cfg = pt.inference.Config("/nonexistent/model")
    cfg.enable_mkldnn()
    cfg.switch_ir_optim(False)
    cfg.set_cpu_math_library_num_threads(4)
    cfg.enable_tensorrt_engine(precision_mode="bfloat16")
    cfg.enable_memory_optim(False)
    s = cfg.summary()
    assert "mkldnn: n/a on the card" in s
    assert "ir_optim: False" in s
    assert "cpu_math_threads: 4" in s
    assert "precision: bfloat16" in s and cfg.precision() == "bfloat16"
    assert "trt: n/a" in s and "memory_optim: False" in s
    assert "device: cpu" in s          # the current place
    cfg.enable_use_gpu(500, device_id=1)
    assert cfg.device() == "cuda:1"
    assert "memory_pool_init_size_mb: n/a (500 requested" in cfg.summary()
    cfg.disable_gpu()
    assert cfg.device() == "cpu"
    cfg.enable_tpu()
    assert cfg.device() == "cuda:1"
    with pytest.raises(ValueError):
        cfg.enable_quant(bits=4)


def test_missing_model_raises_not_found(tmp_path):
    with pytest.raises(NotFoundError, match="Cannot open model file"):
        pt.inference.create_predictor(
            pt.inference.Config(str(tmp_path / "nope.pdmodel")))


def test_handles_run_and_run_batch_of_a_bf16_artifact(tmp_path):
    net = _lenet()
    path, _ = _save(tmp_path, net, "bfloat16")
    pred = pt.inference.create_predictor(pt.inference.Config(path))
    assert pred.get_input_names() == ["input_0"]
    assert pred.device == torch.device("cpu")
    x = _x(2)
    pred.get_input_handle("input_0").copy_from_cpu(x)
    fed = pred._feeds["input_0"]
    assert fed.dtype == torch.bfloat16 and fed.device == pred.device
    assert pred.run() is None
    assert pred.get_output_names() == ["output_0"]
    out_h = pred.get_output_handle("output_0")
    assert out_h.device_value().dtype == torch.bfloat16
    host = out_h.copy_to_cpu()
    assert host.dtype == np.float32 and host.shape == (4, 10)
    ref = net.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(host, ref.float().detach().numpy())
    ran = pred.run([x])
    assert ran[0].dtype == torch.float32
    np.testing.assert_array_equal(ran[0].numpy(), host)
    tensors = pred.run([pt.to_tensor(x)])
    assert isinstance(tensors[0], pt.Tensor)
    batch = pred.run_batch([x])
    assert isinstance(batch[0], np.ndarray) and batch[0].dtype == np.float32
    np.testing.assert_array_equal(batch[0], host)
    with pytest.raises(ValueError, match="expects 1"):
        pred.run_batch([x, x])


def test_serving_buckets_of_an_artifact_are_its_exported_batch(tmp_path):
    path, _ = _save(tmp_path, _lenet())
    pred = pt.inference.create_predictor(pt.inference.Config(path))
    assert pred.serving_buckets([1, 2, 4, 8]) == \
        [([(1, 28, 28)], ["float32"], [4])]
    live = pt.inference.Predictor(_lenet(), input_spec=[
        pt.InputSpec(SPEC, "float32")])
    assert live.serving_buckets([1, 2, 8]) == \
        [([(1, 28, 28)], ["float32"], [1, 2, 4, 8])]


def test_serving_engine_over_an_artifact_pads_to_its_batch(tmp_path):
    net = _lenet()
    path, _ = _save(tmp_path, net)
    pred = pt.inference.create_predictor(pt.inference.Config(path))
    engine = pt.serving.ServingEngine(pred, pt.serving.EngineConfig(
        max_batch_size=4, batch_sizes=(1, 2, 4), batch_timeout_ms=5.0))
    x = _x(3)
    engine.start()
    try:
        futures = [engine.submit([x[i:i + 1]]) for i in range(3)]
        outs = [f.result(60)[0] for f in futures]
    finally:
        engine.stop()
    stats = engine.stats()["counters"]
    assert stats["completed"] == 3 and stats["padded_rows"] >= 1
    want = net(torch.from_numpy(x)).detach().numpy()
    for i, out in enumerate(outs):
        assert out.shape == (1, 10)
        np.testing.assert_allclose(out[0], want[i], rtol=TOL, atol=TOL)


def test_bench_resnet50_infer_arm_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        bench.main(["--arm", "resnet50_infer", "--arm",
                    "resnet50_infer_int8", "--device", "cpu"])
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    r, r8 = lines
    assert r["arm"] == "resnet50_infer" and r["device"] == "cpu"
    assert r["imgs_per_sec"] > 0 and r["spread"] >= 0
    assert r["batch"] == 2 and r["precision"] == "float32"
    assert r["mfu"] is None and r["hbm_roofline_frac"] is None
    assert r["flops_per_img"] > 0 and r["op_traffic_bytes_per_batch"] > 0
    assert r8 == {"skipped": "needs the card", "arm": "resnet50_infer_int8",
                  "card": "cpu", "device": "cpu"}
