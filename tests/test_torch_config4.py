"""BASELINE config 4 in the port against the JAX package on the CPU, at
small sizes: PP-OCRv3 rec (`models/pp_ocr.py`: conv backbone -> BiLSTM ->
CTC head) and PP-YOLOE-s (`models/yoloe.py`, three head maps), each in
training and eval mode (`torch_convnet_parity.check_convnet`: training
outputs within 5e-3 relative L2 and running statistics within 1e-3
(1 + |ref|); eval outputs and every gradient within 1e-4 (1 + |ref|));
three SGD steps of `PPOCRRec.loss` (CTC) from the same weights, the losses
within 1e-4 relative and the parameters within 1e-4 (1 + |ref|); a CPU
`jit.save` -> `create_predictor` round trip of both models equal to the
live layer (relative L2 <= 1e-6), the OCR program holding one
`aten.lstm.input` node per BiLSTM layer; the two bench arms on the CPU;
and the port's namespaces against `tests/reference_api_all.json`.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from torch_convnet_parity import check_convnet, rel_l2
from torch_parity import dev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _ocr(m):
    return m.pp_ocrv3_rec(n_classes=20, scale=0.25, hidden_size=16)


def _img(*shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_pp_ocr_rec_matches_the_reference():
    j, t = check_convnet(lambda: _ocr(jmodels), lambda: _ocr(pt.models),
                         _img(2, 32, 48, 3))
    out = t(torch.from_numpy(_img(2, 32, 48, 3)))
    assert tuple(out.shape) == (2, 24, 20)    # T = W / 2
    assert sum("lstm" in n for n, _ in t.named_parameters()) == 16


def test_pp_ocr_rec_rejects_nchw():
    with pytest.raises(ValueError, match="NHWC"):
        pt.models.pp_ocrv3_rec(data_format="NCHW")


def test_pp_ocr_rec_trains_like_the_reference():
    """Three SGD steps of the CTC loss in training mode (batch statistics,
    running statistics written, as the reference's eager loop does)."""
    paddle.seed(0)
    j = _ocr(jmodels)
    t = _ocr(pt.models)
    pt.utils.load_numpy_state(t, {k: np.asarray(v._value)
                                  for k, v in j.state_dict().items()})
    x = _img(4, 32, 48, 3)
    rng = np.random.default_rng(3)
    labels = rng.integers(1, 20, (4, 6)).astype(np.int32)
    lab_len = np.array([6, 4, 5, 1], np.int64)
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=j.parameters())
    topt = pt.optimizer.SGD(learning_rate=0.1, parameters=t.parameters())
    for _ in range(3):
        jl = j.loss(j(paddle.to_tensor(x)), paddle.to_tensor(labels),
                    lab_len)
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = t.loss(t(torch.from_numpy(x)), torch.from_numpy(labels),
                    lab_len)
        tl.backward()
        topt.step()
        topt.clear_grad()
        assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    jp = dict(j.named_parameters())
    for k, p in t.named_parameters():
        assert dev(p.detach().numpy(), np.asarray(jp[k]._value)) <= 1e-4, k


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_ppyoloe_matches_the_reference(fmt):
    x = _img(2, 3, 64, 64)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))

    def make(m):
        return m.ppyoloe_s(num_classes=8, data_format=fmt)

    j, t = check_convnet(lambda: make(jmodels), lambda: make(pt.models), x)
    outs = t(torch.from_numpy(x))
    assert isinstance(outs, list) and len(outs) == 3
    assert outs[0].shape[-1 if fmt == "NHWC" else 1] == 13   # 5 + 8


@pytest.mark.parametrize("name", ["ocr", "yoloe"])
def test_deploy_round_trip_on_the_cpu(name, tmp_path):
    pt.seed(0)
    if name == "ocr":
        net, shape = _ocr(pt.models), (2, 32, 48, 3)
    else:
        net, shape = pt.models.ppyoloe_s(num_classes=8,
                                         data_format="NHWC"), (2, 64, 64, 3)
    net.eval()
    path = str(tmp_path / name)
    pt.jit.save(net, path, input_spec=[pt.InputSpec(list(shape))])
    cfg = pt.inference.Config(path)
    cfg.disable_gpu()
    pred = pt.inference.create_predictor(cfg)
    x = _img(*shape, seed=4)
    got = pred.run([x])
    with torch.no_grad():
        want = net(torch.from_numpy(x))
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want) == (1 if name == "ocr" else 3)
    for g, w in zip(got, want):
        assert rel_l2(np.asarray(g), w.numpy()) <= 1e-6
    nodes = [str(n.target) for n in
             pred._translated.program().graph.nodes]
    assert nodes.count("aten.lstm.input") == (2 if name == "ocr" else 0)


def test_bench_arms_on_the_cpu(capsys):
    from paddle_tpu_torch.utils import bench
    bench.main(["--arm", "yoloe_infer", "--arm", "ocr_rec_infer",
                "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["arm"] for r in lines] == ["yoloe_infer", "ocr_rec_infer"]
    for r in lines:
        for k in ("imgs_per_sec", "spread", "batch", "img", "layout",
                  "precision", "variant", "mfu", "max_memory_allocated",
                  "idle_share_20_runs"):
            assert k in r, k
        assert r["imgs_per_sec"] > 0 and r["layout"] == "NHWC"
        assert r["flops_per_img"] > 0


def test_rnn_flops_are_counted_by_formula():
    from paddle_tpu_torch.utils import bench
    net = pt.models.pp_ocrv3_rec(n_classes=20, scale=0.25, hidden_size=16)
    lstm = net.neck.lstm
    # T = 32 steps of a [1, 32, 64] sequence, 2 layers x 2 directions
    want = 2 * 32 * 2 * 4 * 16 * ((lstm.input_size + 16) + (32 + 16))
    assert bench._rnn_flops(lstm, (1, 32, lstm.input_size)) == want
    with_rnn = bench.model_flops(net, (1, 32, 64, 3))
    assert with_rnn > want


def test_namespaces_hold_the_reference_names():
    api = json.load(open(os.path.join(ROOT, "tests",
                                      "reference_api_all.json")))
    for ns, mod in (("paddle.nn", pt.nn),
                    ("paddle.nn.functional", pt.nn.functional),
                    ("paddle.vision.ops", pt.vision.ops),
                    ("paddle.vision.models", pt.vision.models)):
        missing = [n for n in api[ns] if not hasattr(mod, n)]
        assert not missing, (ns, missing)
    assert len(api["paddle.nn"]) == 116
    assert len(api["paddle.nn.functional"]) == 102
    assert hasattr(pt.vision.ops, "nms") and hasattr(pt.vision.ops,
                                                     "box_iou")
    import paddle_tpu.vision.models as jvm
    names = [n for n in dir(jvm) if not n.startswith("_")]
    assert all(hasattr(pt.vision.models, n) for n in names)
