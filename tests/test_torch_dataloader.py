"""The port's `io` data feed against the JAX package's: under one numpy
seed the two DataLoaders yield the same batches in the same order (shuffle
on and off, `drop_last`, a `DistributedBatchSampler`, zero and two worker
processes), and `DevicePrefetcher` passes a source's batches through in
order and drops what it staged on `close()`."""
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio

N, DIM = 23, 3


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


class _Rows:
    """(features, label) per index: picklable, so worker processes of
    either package can load it."""

    def __init__(self, mod):
        self.x = np.arange(N * DIM, dtype=np.float32).reshape(N, DIM)
        self.y = np.arange(N, dtype=np.int64) * 10
        self.mod = mod

    def __len__(self):
        return N

    def __getitem__(self, i):
        return self.x[i], int(self.y[i])


class _JRows(_Rows, jio.Dataset):
    def __init__(self):
        super().__init__("jax")


class _TRows(_Rows, tio.Dataset):
    def __init__(self):
        super().__init__("torch")


def _host(batch):
    return [np.asarray(getattr(b, "_value", b)) for b in batch]


def _batches(mod, ds, seed, **kw):
    np.random.seed(seed)
    return [_host(b) for b in mod.DataLoader(ds, **kw)]


LOADERS = [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=True),
    dict(batch_size=5, shuffle=True, drop_last=True),
    dict(batch_size=4, shuffle=True, num_workers=2),
    dict(batch_size=5, drop_last=True, num_workers=2),
]


@pytest.mark.parametrize("kw", LOADERS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_batches_match_the_jax_loader(kw):
    want = _batches(jio, _JRows(), 7, **kw)
    got = _batches(tio, _TRows(), 7, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert [a.dtype for a in g] == [a.dtype for a in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    if "num_workers" in kw:     # the same batches as without workers
        alone = _batches(tio, _TRows(), 7, **dict(kw, num_workers=0))
        for g, a in zip(got, alone):
            for x, y in zip(g, a):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_matches_the_jax_sampler(shuffle):
    for rank in range(3):
        samplers = [mod.DistributedBatchSampler(
            ds, batch_size=3, num_replicas=3, rank=rank, shuffle=shuffle,
            drop_last=False) for mod, ds in ((jio, _JRows()), (tio, _TRows()))]
        for s in samplers:
            s.set_epoch(2)
        assert list(samplers[1]) == list(samplers[0])
        assert len(samplers[1]) == len(samplers[0])
        want = [_host(b) for b in jio.DataLoader(_JRows(),
                                                 batch_sampler=samplers[0])]
        got = [_host(b) for b in tio.DataLoader(_TRows(),
                                                batch_sampler=samplers[1])]
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_random_split_and_datasets_match():
    np.random.seed(3)
    jparts = jio.random_split(_JRows(), [10, 13])
    np.random.seed(3)
    tparts = tio.random_split(_TRows(), [10, 13])
    assert [p.indices for p in tparts] == [p.indices for p in jparts]
    t = tio.TensorDataset([torch.arange(6).reshape(3, 2), torch.arange(3)])
    x, y = t[1]
    assert x.tolist() == [2, 3] and int(y) == 1 and len(t) == 3
    c = tio.ConcatDataset([tio.Subset(_TRows(), [0, 1]), _TRows()])
    assert len(c) == N + 2 and c[2][1] == 0


def test_prefetcher_yields_the_source_in_order():
    src = [(np.full((2, 2), i, np.float32), np.array([i])) for i in range(7)]
    feed = tio.DevicePrefetcher(src, depth=2)
    for _ in range(2):                    # re-iterable: one session each
        got = [b for b in feed]
        assert len(got) == 7
        for i, (x, y) in enumerate(got):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            assert float(x[0, 0]) == i and int(y[0]) == i
    assert feed.stats()["consumed"] == 7 and feed.stats()["in_flight"] == 0
    feed.close()


def test_prefetcher_close_drops_staged_batches():
    gate = threading.Event()

    def source():
        for i in range(10):
            if i == 4:
                gate.set()
            yield (np.array([i]),)

    feed = tio.DevicePrefetcher(source(), depth=3)
    first = next(iter(feed))
    assert int(first[0][0]) == 0
    assert gate.wait(10)
    stats = feed.stats()
    assert stats["consumed"] == 1 and 1 <= stats["in_flight"] <= 3
    feed.close()
    assert feed.stats() == {"depth": 3, "in_flight": 0, "produced": 0,
                            "consumed": 0}


def test_maybe_wrap_follows_the_flag():
    src = [(np.zeros(1),)]
    assert tio.maybe_wrap(src) is src
    pt.set_flags({"FLAGS_prefetch": True})
    try:
        wrapped = tio.maybe_wrap(src, depth=1)
        assert isinstance(wrapped, tio.DevicePrefetcher)
        assert wrapped.depth == 1
        wrapped.close()
    finally:
        pt.set_flags({"FLAGS_prefetch": False})


def test_worker_info_is_none_in_the_main_process():
    assert tio.get_worker_info() is None
