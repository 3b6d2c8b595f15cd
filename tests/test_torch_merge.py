"""The cross-rank timeline merge (`obs/merge.py`), `TrainGuard.
timeline_report` and the prefetcher's plane hooks, against the reference
on the CPU.

The same seeded step records go through both packages' merge: the merged
pod timeline, the straggler report and the skew rule are equal (exactly:
both are the same float arithmetic in the same order). Two ranks gather
their records through one `torch.distributed.TCPStore`, each in its own
thread. The prefetcher's hooks tag, time and count each staged batch."""
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.obs import merge as jmerge
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor, obs
from paddle_tpu_torch.guard import GuardConfig, TrainGuard
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.obs import memory, merge

from torch_fleet_parity import port_flags, store

PHASES = ("h2d", "device_compute", "optimizer", "collective")


def _records(seed, n_steps=4, slow=None):
    """A rank's step records from a seed; `slow` phase runs 3x long."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        phases = {p: float(rng.uniform(1e-3, 5e-3)) for p in PHASES}
        if slow is not None:
            phases[slow] *= 3.0
        out.append({"step": i, "wall": float(sum(phases.values())),
                    "phases": phases,
                    "between": {"data_wait": float(rng.uniform(0, 1e-3))},
                    "error": None, "spans": [("x", 0.0, 1.0)]})
    return out


@pytest.mark.parametrize("values", [
    {}, {0: 0.0, 1: 0.0}, {0: 0.0, 1: 2.0, 2: 0.0},
    {0: 1.0, 1: 2.0, 2: 3.0, 3: 10.0}, {"a": 5.0, "b": 1.0, "c": 1.0},
], ids=["empty", "all_zero", "zero_median", "even", "odd"])
def test_skew_over_median_equals_the_reference(values):
    assert merge.skew_over_median(values) == \
        jmerge.skew_over_median(values)


def test_merge_and_straggler_report_equal_the_reference():
    per_rank = {r: _records(r, slow="collective" if r == 2 else None)
                for r in range(4)}
    slim = {r: merge.slim_records(v) for r, v in per_rank.items()}
    assert slim == {r: jmerge.slim_records(v) for r, v in per_rank.items()}
    assert all("spans" not in rec for v in slim.values() for rec in v)
    got, want = merge.merge_timelines(slim), jmerge.merge_timelines(slim)
    assert got == want
    assert got["stragglers"]["collective"]["rank"] == 2
    assert got["stragglers"]["collective"]["skew"] > 2.0
    for unit in ("s", "ms", "us"):
        assert merge.straggler_report(got, unit) == \
            jmerge.straggler_report(want, unit)


def test_gather_timelines_over_a_tcp_store():
    """Two ranks, one thread each with its own client of one store; both
    get every rank's slimmed records, and the merge equals the
    reference's of the same records."""
    master = store()
    per_rank = {r: _records(10 + r) for r in range(2)}
    got, errors = {}, []

    def rank(r):
        import datetime
        import torch.distributed as tdist
        try:
            s = tdist.TCPStore("127.0.0.1", master.port, is_master=False,
                               timeout=datetime.timedelta(seconds=30))
            got[r] = merge.gather_timelines(s, r, 2, per_rank[r],
                                            key="obs/tl/t", timeout_s=20)
        except Exception as e:  # noqa: BLE001 — read after the join
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    [t.start() for t in threads]
    [t.join(30) for t in threads]
    assert not errors and got[0] == got[1]
    assert got[0] == {r: jmerge.slim_records(v) for r, v in per_rank.items()}
    assert merge.merge_timelines(got[0]) == jmerge.merge_timelines(got[0])
    with pytest.raises(TimeoutError):
        merge.gather_timelines(master, 0, 3, per_rank[0], key="obs/tl/u",
                               timeout_s=0.2)


def _linear_step():
    pt.seed(0)
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                           pt.nn.Linear(8, 1))
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=1e-2)
    return TrainStep(net, pt.nn.MSELoss(), opt, n_model_inputs=1)


def test_train_guard_timeline_report():
    """Off: the reference's explanation. On, one rank: the local merge of
    this process's timeline, as the reference's merge reads it."""
    pt.set_device("cpu")
    guard = TrainGuard(_linear_step(), config=GuardConfig(
        snapshot_interval=0), signals=())
    merged, text = guard.timeline_report()
    assert merged is None and "FLAGS_obs_timeline" in text
    rng = np.random.RandomState(1)
    with port_flags(obs_timeline=True):
        obs.timeline().reset()
        for b in range(3):
            guard.set_cursor(0, b)
            guard.step(torch.from_numpy(rng.rand(8, 4).astype("float32")),
                       torch.from_numpy(rng.rand(8, 1).astype("float32")))
        merged, text = guard.timeline_report()
        records = obs.timeline().records()
        obs.timeline().reset()
    want = jmerge.merge_timelines({0: jmerge.slim_records(records)})
    assert merged == want and merged["world_size"] == 1
    assert merged["ranks"][0]["steps"] == 3
    assert text == jmerge.straggler_report(want)
    assert "device_compute" in merged["stragglers"]


def test_prefetch_plane_hooks():
    """Each staged batch is tagged `prefetch_staging`, books a
    `prefetch_h2d` phase between steps and counts `io.prefetch.batches`
    and an `io.prefetch.h2d` observation; off, none of it."""
    pt.set_device("cpu")
    src = [(np.full((2, 3), i, np.float32),) for i in range(4)]
    monitor.reset()
    feed = DevicePrefetcher(src, depth=2)
    got = [b[0] for b in feed]
    feed.close()
    assert "io.prefetch.batches" not in monitor.snapshot()["counters"]
    with port_flags(monitor=True, obs_timeline=True, mem_census=True):
        obs.timeline().reset()
        monitor.reset()
        feed = DevicePrefetcher(src, depth=2)
        got = [b[0] for b in feed]
        feed.close()
        snap = monitor.snapshot()
        tags = [memory.tag_of(t) for t in got]
        with obs.step_record():
            pass
        between = obs.timeline().records()[-1]["between"]
        obs.timeline().reset()
        monitor.reset()
    assert [float(t[0, 0]) for t in got] == [0.0, 1.0, 2.0, 3.0]
    assert snap["counters"]["io.prefetch.batches"] == 4
    assert snap["histograms"]["io.prefetch.h2d"]["count"] == 4
    assert all(t == ("prefetch_staging", "DevicePrefetcher") for t in tags)
    assert between["prefetch_h2d"] >= 0.0
