"""int8 weight-only quantization in the port (`paddle_tpu_torch.
quantization`) against the JAX package's `channel_quant` and
`quant_weight_only`, on the CPU, from numpy seeds."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.quantization import channel_quant as jchannel_quant
from paddle_tpu.quantization import quant_weight_only as jquant_weight_only
import paddle_tpu_torch as pt
from paddle_tpu_torch.quantization import (WeightOnlyLinear, channel_quant,
                                           quant_weight_only)
from paddle_tpu_torch.utils import load_numpy_state

# fp32 products of the same dequantized weights in another summation order
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


@pytest.mark.parametrize("shape", [(32, 48), (8, 3, 3, 3), (5, 1)])
def test_channel_quant_is_bit_equal_to_the_jax_package(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[..., 0] *= 1e-3                   # channels of very different ranges
    jq, js = jchannel_quant(w)
    q, s = channel_quant(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    q2, s2 = channel_quant(w)            # numpy in, the same result
    assert torch.equal(q2, q) and torch.equal(s2, s)


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.fc2 = jnn.Linear(32, 8, bias_attr=False)

    def forward(self, x):
        return self.fc2(self.fc1(x))


class _Net(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = pt.nn.Linear(16, 32)
        self.fc2 = pt.nn.Linear(32, 8, bias_attr=False)

    def forward(self, x):
        return self.fc2(self.fc1(x))


def test_quant_weight_only_swaps_the_storage_like_the_jax_package():
    paddle.seed(3)
    jnet = _JNet()
    net = _Net()
    load_numpy_state(net, _state(jnet))
    x = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    jquant_weight_only(jnet)
    assert quant_weight_only(net) is net
    for layer in (net.fc1, net.fc2):
        assert isinstance(layer, WeightOnlyLinear)
        assert "weight" not in layer._parameters
        assert layer.wo_weight_q.dtype == torch.int8
        assert tuple(layer.wo_weight_scale.shape) == (1, layer.out_features)
    jstate, state = _state(jnet), net.state_dict()
    assert sorted(jstate) == sorted(state)
    for k, v in jstate.items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    want = jnet(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert "weight" not in net.fc1._parameters


def test_quantized_state_dict_moves_across_by_name():
    paddle.seed(5)
    jnet = _JNet()
    jquant_weight_only(jnet)
    net = quant_weight_only(_Net())
    load_numpy_state(net, _state(jnet))
    for k, v in _state(jnet).items():
        np.testing.assert_array_equal(net.state_dict()[k].numpy(), v)


def test_quant_weight_only_gpt_logits_match_the_jax_package():
    """The LLM int8 arm's model: every decoder Linear quantized, the tied
    embedding head kept in fp32."""
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=128, dropout=0.0)
    paddle.seed(11)
    jlm = JGPTForCausalLM(JGPTModel(**cfg))
    jlm.eval()
    lm = pt.models.GPTForCausalLM(pt.models.GPTModel(**cfg))
    load_numpy_state(lm, _state(jlm))
    lm.eval()
    jquant_weight_only(jlm)
    quant_weight_only(lm)
    assert sum(isinstance(m, WeightOnlyLinear) for m in lm.modules()) == 8
    assert lm.gpt.embeddings.word_embeddings.weight.dtype == torch.float32
    ids = np.random.default_rng(1).integers(0, 64, (2, 12)).astype(np.int32)
    want = jlm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = lm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_quant_weight_only_rejects_a_model_without_linear_weights():
    with pytest.raises(ValueError, match="no 2-D linear weights"):
        quant_weight_only(pt.nn.LayerNorm(8))
