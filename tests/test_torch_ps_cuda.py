"""The sparse-gradient path and the PS lookup on a card.

Every test is marked `cuda` and skips without a CUDA device; the CPU
tests (test_torch_selected_rows.py, test_torch_ps.py) hold the port to
the JAX package. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ps_cuda.py
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.distributed import ps


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    pt.set_device("gpu")
    yield torch.device("cuda:0")
    pt.set_device("cpu")


def _steps(device, lazy, opt="adam"):
    pt.seed(0)
    emb = pt.nn.Embedding(1000, 9, sparse=True)
    w = np.random.default_rng(0).standard_normal((1000, 9)).astype(
        np.float32)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(w))
    emb.to(device)
    o = pt.optimizer.Adam(parameters=emb.parameters(), learning_rate=0.05,
                          lazy_mode=lazy) if opt == "adam" else \
        pt.optimizer.SGD(parameters=emb.parameters(), learning_rate=0.1)
    rng = np.random.default_rng(1)
    for _ in range(5):
        ids = torch.from_numpy(rng.zipf(1.3, (64, 26)) % 1000).to(device)
        (emb(ids) ** 2).sum().backward()
        assert emb.weight.grad.is_sparse
        assert emb.weight.grad.device.type == device.type
        o.step()
        o.clear_grad()
    return emb.weight.detach().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("opt,lazy", [("sgd", False), ("adam", False),
                                      ("adam", True)])
def test_the_sparse_update_on_the_card_matches_the_cpu(card, opt, lazy):
    got = _steps(card, lazy, opt)
    want = _steps(torch.device("cpu"), lazy, opt)
    assert (np.abs(got - want) / (1 + np.abs(want))).max() < 1e-5


@pytest.mark.cuda
def test_merge_is_deterministic_on_the_card(card):
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.zipf(1.2, 200000) % 5000).to(card)
    vals = torch.from_numpy(rng.standard_normal((200000, 9)).astype(
        np.float32)).to(card)
    a = SelectedRows(rows, vals, 5000).merge()
    b = SelectedRows(rows, vals, 5000).merge()
    assert torch.equal(a.rows, b.rows) and torch.equal(a.values, b.values)
    c = SelectedRows(rows.cpu(), vals.cpu(), 5000).merge()
    assert torch.equal(a.rows.cpu(), c.rows)
    # f32 sums of up to ~1e5 terms in another order: held to the f64 sum
    # within 1e-5 of the sum of the terms' magnitudes
    ref = SelectedRows(rows.cpu(), vals.cpu().double(), 5000).merge()
    mag = SelectedRows(rows.cpu(), vals.cpu().double().abs(), 5000).merge()
    for got in (a.values.cpu().double(), c.values.double()):
        assert ((got - ref.values).abs() <= 1e-5 * mag.values).all()


@pytest.mark.cuda
def test_distributed_embedding_pulls_onto_the_card_and_pushes_back(card):
    srv = ps.PsServer()
    srv.add_sparse_table("emb", dim=9, lr=0.5)
    srv.run()
    client = ps.PsClient([f"{srv.host}:{srv.port}"])
    try:
        emb = ps.DistributedEmbedding(client, "emb", 9)
        before = client.pull_sparse("emb", [3, 4]).copy()
        out = emb(np.array([[3, 4]]))
        assert out.device == card
        out.sum().backward()
        np.testing.assert_allclose(client.pull_sparse("emb", [3, 4]),
                                   before - 0.5, rtol=1e-6)
    finally:
        client.close()
        srv.stop()
