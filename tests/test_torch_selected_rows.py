"""The sparse gradient path (`core/selected_rows.py`, the sparse lookup of
`nn.functional.embedding`, the optimizers' sparse rules, the clip, the
scaler's fallback and the meta-optimizers' densify) against the JAX
package's SelectedRows path (`tests/test_selected_rows.py`'s cases, each
run in both packages from the same weights and ids).

The carrier is pinned here: the port's `Parameter.grad` is an
uncoalesced sparse COO tensor with one entry per looked-up id, and
`SelectedRows.of(grad)` gives the reference's rows and values.
Tolerances: the gradient rows and values exactly; an embedding alone
after 5 steps of the SGD and Momentum rules (and of gradient merge)
within 1e-6 (1 + |ref|). The Adam family within 1e-5, the dense Adam
tests' own tolerance (`test_torch_optimizers.py`): its rule already
differs between the packages by ~1.4e-6 after 5 dense steps. With a
dense head on the embedding, everything within 1e-5 (the head's matmul
gradients sum in another order in the two packages, and the embedding's
gradient comes through the head)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.parallel import meta_optimizers as jmeta
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.parallel import meta_optimizers as tmeta

from torch_parity import dev


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


# one shape per step: the reference's backward fuses a tape whose
# structure repeats (`core/autograd.py:392-441`), and its fused walk hands
# the optimizer a DENSE embedding gradient from the third repeat on, so a
# repeated shape would compare the port's sparse rule with the reference's
# dense one (each step asserts the reference's gradient is SelectedRows)
IDS = [np.array([[1, 2], [2, 3]]), np.array([1, 5, 5, 9]),
       np.array([0, 7, 7, 7, 11]), np.array([3, 3, 4]),
       np.array([6, 1, 0, 0, 8, 10])]


def _pair(vocab=12, dim=4, padding_idx=None, head=False):
    """(reference model, port model) with the same weights: an embedding,
    and with `head` a Linear over it."""
    def make(nn):
        class M(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(vocab, dim, padding_idx=padding_idx,
                                        sparse=True)
                self.fc = nn.Linear(dim, 3) if head else None

            def forward(self, ids):
                e = self.emb(ids)
                return self.fc(e) if self.fc is not None else e
        return M()
    paddle.seed(0)
    j = make(jnn)
    t = make(tnn)
    pt.utils.load_numpy_state(t, {k: np.asarray(v._value)
                                  for k, v in j.state_dict().items()})
    return j, t


def _loss(out):
    return (out * out).sum()


def _same_weights(j, t, tol):
    for k, v in j.state_dict().items():
        assert dev(t.state_dict()[k].detach().numpy(),
                   np.asarray(v._value)) < tol, k


def test_the_carrier_is_an_uncoalesced_sparse_grad_with_the_references_rows():
    j, t = _pair()
    ids = IDS[0]
    _loss(j(paddle.to_tensor(ids))).backward()
    _loss(t(torch.from_numpy(ids))).backward()
    jg, tg = j.emb.weight.grad, t.emb.weight.grad
    assert isinstance(jg, JSR)
    assert tg.is_sparse and not tg.is_coalesced()
    sr = SelectedRows.of(tg)
    assert sr.rows.tolist() == np.asarray(jg.rows).tolist() == [1, 2, 2, 3]
    np.testing.assert_array_equal(sr.values.numpy(), np.asarray(jg.values))
    np.testing.assert_array_equal(sr.to_dense().numpy(),
                                  np.asarray(jg.to_dense()))
    m, jm = sr.merge(), jg.merge()
    assert m.rows.tolist() == np.asarray(jm.rows).tolist() == [1, 2, 3]
    np.testing.assert_array_equal(m.values.numpy(), np.asarray(jm.values))
    assert torch.equal(sr.to_dense(), tg.to_dense())


def test_selected_rows_merge_add_and_mismatch():
    sr = SelectedRows([1, 3, 1], np.ones((3, 2), np.float32), height=5)
    m = sr.merge()
    assert m.rows.tolist() == [1, 3]
    d = m.to_dense().numpy()
    np.testing.assert_array_equal(d[1], [2, 2])
    a = SelectedRows([0], np.ones((1, 2), np.float32), 3)
    b = SelectedRows([2], np.ones((1, 2), np.float32), 3)
    np.testing.assert_array_equal((a + b).to_dense().numpy(),
                                  [[1, 1], [0, 0], [1, 1]])
    np.testing.assert_array_equal(
        (a + np.full((3, 2), 5.0, np.float32)).numpy(),
        [[6, 6], [5, 5], [5, 5]])
    with pytest.raises(ValueError):
        SelectedRows([1, 2], np.ones((3, 2)), 5)


def test_two_backwards_concatenate_rows_and_padding_rows_get_zero():
    j, t = _pair(padding_idx=0)
    for ids in (np.array([[0, 1]]), np.array([4, 0])):
        _loss(j(paddle.to_tensor(ids))).backward()
        _loss(t(torch.from_numpy(ids))).backward()
    jg, sr = j.emb.weight.grad, SelectedRows.of(t.emb.weight.grad)
    assert sr.rows.tolist() == np.asarray(jg.rows).tolist() == [0, 1, 4, 0]
    np.testing.assert_array_equal(sr.values.numpy(), np.asarray(jg.values))
    assert (sr.to_dense()[0] == 0).all() and (sr.to_dense()[1] != 0).any()


def test_non_leaf_weight_gets_the_dense_gradient():
    w = np.random.default_rng(0).random((6, 3)).astype(np.float32)
    ids = np.array([1, 4])
    jw = paddle.to_tensor(w)
    jw.stop_gradient = False
    _loss(paddle.nn.functional.embedding(paddle.to_tensor(ids), jw * 2.0,
                                         sparse=True)).backward()
    tw = torch.from_numpy(w).requires_grad_()
    _loss(pt.nn.functional.embedding(torch.from_numpy(ids), tw * 2.0,
                                     sparse=True)).backward()
    assert not tw.grad.is_sparse
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw.grad._value),
                               rtol=1e-6)


def test_no_grad_lookup_is_the_dense_one():
    _, t = _pair()
    with torch.no_grad():
        out = t(torch.from_numpy(IDS[1]))
    assert not out.requires_grad and out.shape == (4, 4)


OPTS = {
    "sgd": lambda m, ps, clip: m.optimizer.SGD(
        parameters=ps, learning_rate=0.1, grad_clip=clip),
    "sgd_wd": lambda m, ps, clip: m.optimizer.SGD(
        parameters=ps, learning_rate=0.1, weight_decay=0.01, grad_clip=clip),
    "adam": lambda m, ps, clip: m.optimizer.Adam(
        parameters=ps, learning_rate=0.05, grad_clip=clip),
    "adam_lazy": lambda m, ps, clip: m.optimizer.Adam(
        parameters=ps, learning_rate=0.05, lazy_mode=True, grad_clip=clip),
    "adamw_lazy": lambda m, ps, clip: m.optimizer.AdamW(
        parameters=ps, learning_rate=0.05, lazy_mode=True, grad_clip=clip),
    "momentum": lambda m, ps, clip: m.optimizer.Momentum(
        parameters=ps, learning_rate=0.05, momentum=0.9, grad_clip=clip),
}


# every rule on the embedding alone, and with a dense head under the
# global-norm clip (one norm over the sparse rows and the dense gradients);
# SGD and lazy Adam also clipped alone
CASES = [(n, False, False) for n in sorted(OPTS)] + \
    [(n, True, True) for n in sorted(OPTS)] + \
    [("sgd", True, False), ("adam_lazy", True, False)]


@pytest.mark.parametrize("name,clip,head", CASES, ids=[
    f"{n}-{'globalnorm' if c else 'noclip'}-{'emb_fc' if h else 'emb'}"
    for n, c, h in CASES])
def test_sparse_rules_match_the_reference_over_5_steps(name, clip, head):
    """The sparse rule on the embedding; with `head`, the dense one on a
    Linear over it in the same step, and the clip's one global norm over
    both."""
    j, t = _pair(head=head)
    jopt = OPTS[name](paddle, j.parameters(),
                      jnn.ClipGradByGlobalNorm(1.0) if clip else None)
    topt = OPTS[name](pt, t.parameters(),
                      tnn.ClipGradByGlobalNorm(1.0) if clip else None)
    for ids in IDS:
        _loss(j(paddle.to_tensor(ids))).backward()
        _loss(t(torch.from_numpy(ids))).backward()
        assert isinstance(j.emb.weight.grad, JSR)
        assert t.emb.weight.grad.is_sparse
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
    _same_weights(j, t, 1e-5 if head or "adam" in name else 1e-6)


def test_lazy_adam_freezes_untouched_rows_and_default_adam_moves_them():
    for lazy in (False, True):
        _, t = _pair()
        opt = pt.optimizer.Adam(parameters=t.parameters(), learning_rate=0.1,
                                lazy_mode=lazy)
        _loss(t(torch.tensor([0]))).backward()
        opt.step()
        opt.clear_grad()
        w1 = t.emb.weight.detach().clone()
        _loss(t(torch.tensor([5]))).backward()
        opt.step()
        moved = (t.emb.weight[0] - w1[0]).abs().max().item()
        assert (moved == 0.0) if lazy else (moved > 1e-7)


def test_gradient_merge_densifies_sparse_grads_like_the_reference():
    j, t = _pair()
    jopt = jmeta.GradientMergeOptimizer(
        paddle.optimizer.SGD(parameters=j.parameters(), learning_rate=0.1),
        k_steps=2)
    topt = tmeta.GradientMergeOptimizer(
        pt.optimizer.SGD(parameters=t.parameters(), learning_rate=0.1),
        k_steps=2)
    for ids in IDS[1:]:
        _loss(j(paddle.to_tensor(ids))).backward()
        _loss(t(torch.from_numpy(ids))).backward()
        jopt.step()
        topt.step()
    _same_weights(j, t, 1e-6)


def test_the_scaler_falls_back_to_unscale_then_step_on_sparse_grads():
    """The reference's scaler cannot unscale a SelectedRows (its fused
    unscale takes arrays only), so the port's is held against the same
    steps without a scaler: lazy Adam on scaled sparse gradients, unfused,
    gives the unscaled run's weights."""
    _, t = _pair(head=True)
    _, u = _pair(head=True)
    topt = pt.optimizer.Adam(parameters=t.parameters(), learning_rate=0.05,
                             lazy_mode=True)
    uopt = pt.optimizer.Adam(parameters=u.parameters(), learning_rate=0.05,
                             lazy_mode=True)
    ts = pt.amp.GradScaler(init_loss_scaling=1024.0)
    assert ts._can_fuse(topt)
    for ids in IDS[1:3]:
        ts.scale(_loss(t(torch.from_numpy(ids)))).backward()
        assert not ts._can_fuse(topt)
        ts.step(topt)
        topt.clear_grad()
        _loss(u(torch.from_numpy(ids))).backward()
        uopt.step()
        uopt.clear_grad()
    for k, v in u.state_dict().items():
        assert dev(t.state_dict()[k].detach().numpy(),
                   v.detach().numpy()) < 1e-6, k
    with pytest.raises(RuntimeError, match="sparse"):
        _loss(t(torch.from_numpy(IDS[0]))).backward()
        topt.step(inv_scale=torch.tensor(1.0))


def test_static_sparse_embedding_gives_the_sparse_gradient():
    pt.static.nn._LAYER_SCOPE.clear()
    out = pt.static.nn.sparse_embedding(torch.from_numpy(IDS[0]), [10, 4])
    _loss(out).backward()
    emb = [v for v in pt.static.nn._LAYER_SCOPE.values()
           if isinstance(v, pt.nn.Embedding)][0]
    assert emb.weight.grad.is_sparse
    assert SelectedRows.of(emb.weight.grad).rows.tolist() == [1, 2, 2, 3]
    pt.static.nn._LAYER_SCOPE.clear()
