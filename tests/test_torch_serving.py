"""The same small GPT served through Predictor + ServingEngine in both
packages gives the same results; the port's engine keeps the reference's
bucket padding, overload, deadline and drain behaviour
(tests/test_serving.py)."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.jit import InputSpec as JInputSpec
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.serving import (DeadlineExceededError, EngineConfig,
                                      EngineStoppedError, NoBucketError,
                                      ServerOverloadedError, ServingEngine)
from paddle_tpu_torch.utils import load_numpy_state

CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
           max_seq_len=128)
SEQ = 128
TOL = 1e-4    # fp32 in both packages; only summation order differs


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jmodels.GPTForCausalLM(jmodels.gpt.GPTModel(**CFG))
    jm.eval()
    pt.set_device("cpu")
    tm = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(tm, {k: np.asarray(v._value)
                          for k, v in jm.state_dict().items()})
    return jm, tm


def _requests(n, seed=0, seq=SEQ):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (1, seq)).astype(np.int32) for _ in range(n)]


def _serve(engine, reqs):
    # enqueue before starting the worker: batching is then deterministic
    futs = [engine.submit([r]) for r in reqs]
    engine.start()
    outs = [f.result(timeout=120)[0] for f in futs]
    engine.stop()
    return outs


def test_port_serves_what_the_jax_package_serves(models):
    jm, tm = models
    reqs = _requests(4)
    cfg = dict(max_batch_size=4, batch_sizes=(1, 2, 4), batch_timeout_ms=5,
               warmup_on_start=False)
    want = _serve(JServingEngine(
        JPredictor(jm, input_spec=[JInputSpec([4, SEQ], "int32")]),
        JEngineConfig(**cfg)), reqs)
    engine = ServingEngine(
        Predictor(tm, input_spec=[pt.InputSpec([4, SEQ], "int32")],
                  device="cpu"), EngineConfig(**cfg))
    got = _serve(engine, reqs)
    assert engine.stats()["counters"]["batches"] == 1
    for g, w in zip(got, want):
        assert g.shape == (1, SEQ, 512) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_predictor_declares_its_bucket_and_warms_every_batch_size(models):
    _, tm = models
    pred = Predictor(tm, input_spec=[pt.InputSpec([4, SEQ], "int32")])
    assert pred.device == torch.device("cpu")
    assert pred.serving_buckets((1, 2, 4)) == [([(SEQ,)], ["int32"],
                                                 [1, 2, 4])]
    engine = ServingEngine(pred, EngineConfig(max_batch_size=4,
                                              batch_sizes=(1, 2, 4)))
    engine.start()
    engine.stop()
    assert engine.stats()["counters"]["warmup_runs"] == 3


def test_short_request_pads_into_the_bucket(models):
    """A 100-token request rides the declared 128-token bucket; causal
    attention makes its first 100 positions independent of the padding."""
    _, tm = models
    pred = Predictor(tm, input_spec=[pt.InputSpec([2, SEQ], "int32")])
    engine = ServingEngine(pred, EngineConfig(
        max_batch_size=2, batch_sizes=(2,), batch_timeout_ms=1,
        learn_buckets=False, warmup_on_start=False))
    (req,) = _requests(1, seed=5, seq=100)
    (out,) = _serve(engine, [req])
    assert out.shape == (1, SEQ, 512)
    with torch.inference_mode():
        want = tm(torch.from_numpy(req)).numpy()
    np.testing.assert_allclose(out[:, :100], want, rtol=TOL, atol=TOL)
    counts = engine.stats()["counters"]
    assert counts["padded_rows"] == 1
    assert counts["padding_waste_elems"] == 2 * SEQ - 100
    with pytest.raises(NoBucketError):
        engine.submit([np.zeros((1, SEQ + 1), np.int32)])


def test_predictor_run_and_handles(models):
    _, tm = models
    pred = Predictor(tm, input_spec=[pt.InputSpec([1, SEQ], "int32")])
    (req,) = _requests(1, seed=6)
    (out,) = pred.run([req])
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(req)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(got, out.numpy())
    np.testing.assert_array_equal(got, pred.run_batch([req])[0])


def test_bf16_outputs_come_back_as_float32(models):
    _, tm = models
    import copy
    pred = Predictor(copy.deepcopy(tm).bfloat16(),
                     input_spec=[pt.InputSpec([1, SEQ], "int32")])
    (out,) = pred.run_batch(_requests(1, seed=7))
    assert out.dtype == np.float32 and np.isfinite(out).all()


def test_overload_rejection_is_explicit():
    gate = threading.Event()

    def gated(x):
        gate.wait(10)
        return x

    eng = ServingEngine(gated, EngineConfig(
        max_batch_size=1, batch_timeout_ms=1, queue_depth=2,
        warmup_on_start=False))
    eng.start()
    f1 = eng.submit([np.ones((1, 2), np.float32)])
    time.sleep(0.1)
    queued = [eng.submit([np.ones((1, 2), np.float32)]) for _ in range(2)]
    with pytest.raises(ServerOverloadedError):
        eng.submit([np.ones((1, 2), np.float32)])
    gate.set()
    assert f1.result(timeout=30) is not None
    for f in queued:
        assert f.result(timeout=30) is not None   # backpressure != loss
    eng.stop()
    assert eng.stats()["counters"]["rejected"] == 1


def test_deadline_expires_before_dispatch():
    gate = threading.Event()
    calls = []

    def gated(x):
        calls.append(tuple(x.shape))
        gate.wait(10)
        return x

    eng = ServingEngine(gated, EngineConfig(
        max_batch_size=1, batch_timeout_ms=1, warmup_on_start=False))
    eng.start()
    f1 = eng.submit([np.ones((1, 2), np.float32)])
    time.sleep(0.1)          # the worker is now parked inside gated()
    f2 = eng.submit([np.ones((1, 2), np.float32)], deadline_ms=30)
    time.sleep(0.2)          # f2's deadline passes while it queues
    gate.set()
    assert f1.result(timeout=30) is not None
    with pytest.raises(DeadlineExceededError):
        f2.result(timeout=30)
    eng.stop()
    assert len(calls) == 1 and eng.stats()["counters"]["expired"] == 1


def test_drain_and_stop_without_drain():
    eng = ServingEngine(lambda x: x * 2.0, EngineConfig(
        max_batch_size=2, batch_timeout_ms=1, warmup_on_start=False))
    futs = [eng.submit([np.ones((1, 2), np.float32)]) for _ in range(5)]
    eng.start()
    eng.stop(drain=True)
    assert all(f.done() and f.exception() is None for f in futs)
    with pytest.raises(EngineStoppedError):
        eng.submit([np.ones((1, 2), np.float32)])
    eng2 = ServingEngine(lambda x: x, EngineConfig(warmup_on_start=False))
    futs = [eng2.submit([np.ones((1, 2), np.float32)]) for _ in range(3)]
    eng2.stop(drain=False)   # never started: everything still queued
    for f in futs:
        with pytest.raises(EngineStoppedError):
            f.result(timeout=1)


def test_model_error_lands_on_every_member_future():
    def broken(x):
        raise RuntimeError("kernel exploded")

    eng = ServingEngine(broken, EngineConfig(
        max_batch_size=4, batch_timeout_ms=5, warmup_on_start=False))
    futs = [eng.submit([np.ones((1, 2), np.float32)]) for _ in range(3)]
    eng.start()
    for f in futs:
        with pytest.raises(RuntimeError, match="kernel exploded"):
            f.result(timeout=30)
    eng.stop()
    assert eng.stats()["counters"]["failed"] == 3
