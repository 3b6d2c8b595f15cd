"""The port's slot-format datasets (`distributed/dataset.py`:
`InMemoryDataset`, `QueueDataset`) and `static.Executor.
train_from_dataset` against the JAX package's (`tests/test_dataset.py`'s
cases): one file and one shuffle seed give bit-equal batches in both
packages, and a CTR model with a sparse embedding trained from the
dataset descends as the reference's does (losses within 1e-5 relative:
both run Adam's default, non-lazy sparse rule on the embedding from the
same weights; the lazy rule is held in `test_torch_selected_rows.py`, as
the reference's backward densifies a repeated tape's sparse gradient)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import distributed as jdist
from paddle_tpu.ops.sequence import sequence_pool as jpool
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.ops.sequence import sequence_pool as tpool


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def write_slot_file(path, n=32, seed=0):
    """Samples: a ragged sparse id slot, a dense float slot, a label."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        ids = rng.integers(0, 20, k)
        dense = rng.normal(size=2)
        lines.append(f"{k} " + " ".join(map(str, ids)) +
                     f" 2 {dense[0]:.4f} {dense[1]:.4f} 1 {int(ids.sum() % 2)}")
    path.write_text("\n".join(lines) + "\n")
    return path


def _mk(pkg, cls, files, bs=8):
    ds = getattr(pkg, cls)()
    ds.init(batch_size=bs, use_slots=["ids", "dense", "label"],
            slot_types=["uint64", "float", "uint64"])
    ds.set_filelist([str(f) for f in files])
    return ds


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    return a


def test_the_namespace_exports_both_datasets():
    assert tdist.InMemoryDataset is pt.distributed.dataset.InMemoryDataset
    assert tdist.QueueDataset is pt.distributed.dataset.QueueDataset


@pytest.mark.parametrize("seed", [None, 1, 7])
def test_in_memory_batches_are_bit_equal_to_the_references(tmp_path, seed):
    files = [write_slot_file(tmp_path / "part-0"),
             write_slot_file(tmp_path / "part-1", n=20, seed=1)]
    ref, port = (_mk(p, "InMemoryDataset", files) for p in (jdist, tdist))
    for ds in (ref, port):
        ds.load_into_memory()
        if seed is not None:
            ds.local_shuffle(seed=seed)
            ds.global_shuffle(seed=seed + 1)
    assert port.get_memory_data_size() == ref.get_memory_data_size() == 52
    batches = _same_batches(ref, port)
    b = batches[0]
    assert b["ids"].dtype == np.uint64 and (b["label.lengths"] == 1).all()
    for row, n in zip(b["ids"], b["ids.lengths"]):
        assert (row[int(n):] == 0).all()
    port.release_memory()
    assert port.get_memory_data_size() == 0


def test_queue_dataset_streams_the_references_batches(tmp_path):
    files = [write_slot_file(tmp_path / "part-0", n=40)]
    _same_batches(_mk(jdist, "QueueDataset", files),
                  _mk(tdist, "QueueDataset", files))


def test_full_range_ids_and_malformed_lines(tmp_path):
    f = tmp_path / "big"
    f.write_text(f"1 {2**64 - 1}\n1 7\n")
    ds = tdist.InMemoryDataset()
    ds.init(batch_size=2, use_slots=["ids"], slot_types=["uint64"])
    ds.set_filelist([str(f)])
    ds.load_into_memory()
    assert next(iter(ds))["ids"][0, 0] == np.uint64(2**64 - 1)
    bad = tmp_path / "bad"
    bad.write_text("3 1 2\n")
    ds.set_filelist([str(bad)])
    with pytest.raises(ValueError):
        ds.load_into_memory()
    with pytest.raises(ValueError):
        tdist.QueueDataset().init(use_slots=["a"], slot_types=["uint64",
                                                                "float"])


def _program(pkg, nn, emb, tower, opt, pool, to_tensor, concat):
    ce = nn.CrossEntropyLoss()

    def program(batch):
        ids = to_tensor(batch["ids"].astype(np.int64))
        pooled = pool(emb(ids), to_tensor(batch["ids.lengths"]), "mean")
        feat = concat([pooled, to_tensor(batch["dense"])])
        loss = ce(tower(feat), to_tensor(batch["label"][:, 0].astype(
            np.int64)))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return program


def test_train_from_dataset_descends_like_the_reference(tmp_path):
    write_slot_file(tmp_path / "part-0", n=64)
    losses = {}
    for name in ("ref", "port"):
        pkg, nn, dist_ = (paddle, jnn, jdist) if name == "ref" else \
            (pt, tnn, tdist)
        ds = _mk(dist_, "InMemoryDataset", [tmp_path / "part-0"], bs=16)
        ds.load_into_memory()
        paddle.seed(0)
        jemb, jtower = jnn.Embedding(20, 8, sparse=True), jnn.Linear(10, 2)
        if name == "ref":
            emb, tower = jemb, jtower
            to_tensor, pool = paddle.to_tensor, jpool
            concat = lambda xs: paddle.concat(xs, axis=1)   # noqa: E731
        else:
            emb, tower = tnn.Embedding(20, 8, sparse=True), tnn.Linear(10, 2)
            for j, t in ((jemb, emb), (jtower, tower)):
                pt.utils.load_numpy_state(t, {k: np.asarray(v._value) for
                                              k, v in j.state_dict().items()})
            to_tensor, pool = torch.as_tensor, tpool
            concat = lambda xs: torch.cat(xs, 1)   # noqa: E731
        opt = pkg.optimizer.Adam(
            parameters=list(emb.parameters()) + list(tower.parameters()),
            learning_rate=5e-2)
        prog = _program(pkg, nn, emb, tower, opt, pool, to_tensor, concat)
        exe = pkg.static.Executor()
        losses[name] = []
        for _ in range(2):
            losses[name] += exe.train_from_dataset(prog, ds)
    got = losses["port"]
    assert np.mean(got[-4:]) < np.mean(got[:4]), got     # an epoch each
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
