"""`paddle_tpu_torch.save`/`load` and the JAX package's `paddle.save`/
`paddle.load` share one file format: a `.pdparams` written by either loads
in the other, bit-exact, and the port reads it without importing the JAX
package."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
import paddle_tpu_torch as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
           max_seq_len=16)


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _jax_state():
    paddle.seed(0)
    return jmodels.GPTForCausalLM(jmodels.gpt.GPTModel(**CFG)).state_dict()


def test_jax_pdparams_load_in_the_port(tmp_path):
    jstate = _jax_state()
    path = str(tmp_path / "gpt.pdparams")
    ids = paddle.to_tensor(np.arange(5))
    paddle.save({"model": jstate, "epoch": 3, "ids": ids,
                 "note": ["a", (1, 2.5)]}, path)
    got = pt.load(path)
    assert got["epoch"] == 3 and got["note"] == ["a", (1, 2.5)]
    assert got["ids"].numpy().dtype == np.asarray(ids._value).dtype
    np.testing.assert_array_equal(got["ids"].numpy(), np.arange(5))
    assert list(got["model"]) == list(jstate)
    for k, v in jstate.items():
        t = got["model"][k]
        assert isinstance(t, torch.nn.Parameter), k
        want = np.asarray(v._value)
        assert t.detach().numpy().dtype == want.dtype
        np.testing.assert_array_equal(t.detach().numpy(), want, err_msg=k)
    # and it loads into a port model by name
    model = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    assert model.set_state_dict(got["model"]) == ([], [])


def test_port_pdparams_load_in_jax(tmp_path):
    pt.seed(1)
    model = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    path = str(tmp_path / "gpt.pdparams")
    pt.save({"model": model.state_dict(keep_vars=True), "step": 7,
             "mask": torch.tensor([True, False])}, path)
    got = paddle.load(path)
    assert got["step"] == 7
    np.testing.assert_array_equal(got["mask"].numpy(), [True, False])
    for k, v in model.state_dict().items():
        j = got["model"][k]
        assert isinstance(j, paddle.Parameter), k
        np.testing.assert_array_equal(j.numpy(), v.numpy(), err_msg=k)
    jm = jmodels.GPTForCausalLM(jmodels.gpt.GPTModel(**CFG))
    assert jm.set_state_dict(got["model"]) == ([], [])


def test_round_trip_in_the_port_keeps_bf16_bits(tmp_path):
    x = torch.randn(4, 3).bfloat16()
    path = str(tmp_path / "x.pdparams")
    pt.save({"x": x, "p": torch.nn.Parameter(torch.ones(2))}, path)
    got = pt.load(path)
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    assert isinstance(got["p"], torch.nn.Parameter)
    assert pt.load(path, return_numpy=True)["p"].dtype == np.float32
    assert not os.path.exists(path + ".tmp")


def test_port_load_never_imports_the_jax_package(tmp_path):
    path = str(tmp_path / "gpt.pdparams")
    paddle.save(_jax_state(), path)
    code = f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        state = pt.load({path!r})
        model = pt.models.GPTForCausalLM(pt.models.GPTModel(
            vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            max_seq_len=16))
        assert model.set_state_dict(state) == ([], [])
        print("ok")
    """
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_port_load_refuses_other_jax_package_classes(tmp_path):
    path = str(tmp_path / "opt.pdparams")
    paddle.save({"lr": paddle.optimizer.lr.StepDecay(0.1, step_size=2)},
                path)
    with pytest.raises(Exception, match="outside the JAX package"):
        pt.load(path)
