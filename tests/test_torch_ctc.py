"""The port's CTC loss (`nn.functional.ctc_loss`, `nn.CTCLoss`) against the
JAX package on the CPU: forward and the gradient of the logits, for
random labels, repeated labels, a non-zero blank, the three reductions, a
zero-length label, `input_lengths` < T and an infeasible alignment (the
reference's -1e30 start gives a large finite loss, where torch's
`F.ctc_loss` gives inf: the port keeps the reference's); the host-side
length checks and `norm_by_times`, which raise in both. Forward within
1e-5 and gradients within 1e-5 (1 + |ref|) in fp32; the infeasible loss
(~1e30) within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import nn as tnn

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def _both(logits, labels, in_len, lab_len, blank=0, reduction="mean",
          layer=False):
    """(port loss, port grad, reference loss, reference grad)."""
    jx = paddle.to_tensor(logits, stop_gradient=False)
    tx = torch.tensor(logits, requires_grad=True)
    if layer:
        jl = jnn.CTCLoss(blank, reduction)(jx, paddle.to_tensor(labels),
                                           in_len, lab_len)
        tl = tnn.CTCLoss(blank, reduction)(tx, torch.from_numpy(labels),
                                           in_len, lab_len)
    else:
        jl = JF.ctc_loss(jx, paddle.to_tensor(labels), in_len, lab_len,
                         blank=blank, reduction=reduction)
        tl = TF.ctc_loss(tx, torch.from_numpy(labels), in_len, lab_len,
                         blank=blank, reduction=reduction)
    paddle.sum(jl).backward()
    tl.sum().backward()
    return (tl.detach().numpy(), tx.grad.numpy(), np.asarray(jl.numpy()),
            np.asarray(jx.gradient()))


def _case(T, B, C, L, seed=0, lo=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, C)).astype(np.float32),
            rng.integers(lo, C, (B, L)).astype(np.int32))


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_random_labels_and_reductions(reduction):
    logits, labels = _case(12, 3, 7, 4)
    in_len = np.array([12, 9, 11], np.int64)
    lab_len = np.array([4, 2, 3], np.int64)
    tl, tg, jl, jg = _both(logits, labels, in_len, lab_len,
                           reduction=reduction)
    assert _dev(tl, jl) <= TOL and _dev(tg, jg) <= TOL


def test_repeated_labels():
    logits, _ = _case(10, 1, 4, 4)
    labels = np.array([[2, 2, 3, 3]], np.int32)
    tl, tg, jl, jg = _both(logits, labels, np.array([10]), np.array([4]),
                           reduction="none")
    assert _dev(tl, jl) <= TOL and _dev(tg, jg) <= TOL


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_nonzero_blank(reduction):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((8, 2, 6)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 3)).astype(np.int32)
    tl, tg, jl, jg = _both(logits, labels, np.array([8, 8]),
                           np.array([3, 1]), blank=5, reduction=reduction)
    assert _dev(tl, jl) <= TOL and _dev(tg, jg) <= TOL


def test_zero_length_label_and_short_inputs():
    logits, labels = _case(9, 3, 5, 3, seed=2)
    tl, tg, jl, jg = _both(logits, labels, np.array([9, 4, 6]),
                           np.array([0, 2, 3]), reduction="none")
    assert _dev(tl, jl) <= TOL and _dev(tg, jg) <= TOL
    # the frozen steps past input_length get no gradient
    assert np.abs(tg[4:, 1]).max() == 0.0


def test_infeasible_alignment_is_large_and_finite():
    """Three labels with a repeat need 4 steps; 2 are given. The reference
    starts its alphas at -1e30, so the loss is ~1e30, finite; torch's own
    op gives inf there."""
    logits, _ = _case(6, 2, 5, 3, seed=3)
    labels = np.array([[1, 1, 2], [3, 4, 1]], np.int32)
    in_len, lab_len = np.array([2, 6]), np.array([3, 3])
    tl, tg, jl, jg = _both(logits, labels, in_len, lab_len,
                           reduction="none")
    assert np.isfinite(tl).all() and tl[0] > 1e29
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert np.isfinite(tg).all() and _dev(tg, jg) <= TOL
    lib = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(labels).long(), torch.from_numpy(in_len),
        torch.from_numpy(lab_len), reduction="none")
    assert torch.isinf(lib[0])


def test_layer_wrapper():
    logits, _ = _case(6, 2, 5, 2, seed=4)
    labels = np.array([[1, 2], [3, 0]], np.int32)
    tl, tg, jl, jg = _both(logits, labels, np.array([6, 6]), np.array([2, 1]),
                           reduction="sum", layer=True)
    assert _dev(tl, jl) <= TOL and _dev(tg, jg) <= TOL


def test_length_checks_and_norm_by_times_raise():
    x = torch.zeros(4, 1, 3)
    lab = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="input_lengths"):
        TF.ctc_loss(x, lab, np.array([5]), np.array([2]))
    with pytest.raises(ValueError, match="label_lengths"):
        TF.ctc_loss(x, lab, [4], [3])
    with pytest.raises(NotImplementedError):
        TF.ctc_loss(x, lab, np.array([4]), np.array([2]), norm_by_times=True)
    with pytest.raises(NotImplementedError):
        JF.ctc_loss(paddle.to_tensor(np.zeros((4, 1, 3), np.float32)),
                    paddle.to_tensor(np.zeros((1, 2), np.int32)),
                    np.array([4]), np.array([2]), norm_by_times=True)
    # tensor lengths are trusted, as in the reference
    TF.ctc_loss(x, lab, torch.tensor([4]), torch.tensor([2]))


def test_matches_torch_on_feasible_inputs():
    """Where every alignment is feasible the loss is torch's own op's."""
    logits, labels = _case(12, 3, 7, 4, seed=5)
    in_len, lab_len = np.array([12, 9, 11]), np.array([4, 2, 3])
    got = TF.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      in_len, lab_len, reduction="none")
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(labels).long(), torch.from_numpy(in_len),
        torch.from_numpy(lab_len), reduction="none")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
