"""`paddle_tpu_torch.parallel.elastic` against `paddle_tpu.parallel.elastic`
(`tests/test_elastic_io.py`'s TestElastic, TestElasticFailureBudget and
TestElasticScaleOut cases).

The store is `torch.distributed.TCPStore`, whose `get` waits for a
missing key: the port reads such keys through `check` first. The lease
and join-ticket protocol is held against the reference's by one
in-process store that both packages' managers write and read. The gang
tests run both packages' `launch_elastic` on the same scripts (plain
Python children) and compare the results; the scale-out test drives the
port's AutoCheckpoint in the ranks and waits only on the ranks' log
lines, never on wall-clock sleeps (the reference's test of it is flaky
under load)."""
import datetime
import os
import textwrap
import threading
import time

import pytest
import torch.distributed as dist

from paddle_tpu.parallel import elastic as jel
from paddle_tpu_torch.parallel import elastic as tel
from paddle_tpu_torch.parallel import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _store():
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=30))


class _DictStore:
    """set / get / add over a dict, get raising KeyError on a missing key
    (the surface the reference's managers read)."""

    def __init__(self):
        self._d = {}
        self._lock = threading.Lock()

    def set(self, key, value):
        with self._lock:
            self._d[key] = value if isinstance(value, bytes) \
                else str(value).encode()

    def get(self, key):
        with self._lock:
            return self._d[key]

    def add(self, key, amount):
        with self._lock:
            n = int(self._d.get(key, b"0")) + int(amount)
            self._d[key] = str(n).encode()
            return n


def _wait_for(cond, what, limit=60.0):
    """Poll `cond` until true; fail after `limit` seconds (a bound on a
    hang, not a schedule)."""
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.02)


def test_lease_membership_over_a_tcp_store():
    store = _store()
    members = [tel.ElasticManager(store, rank=r, world_size=2, lease_ttl=0.6,
                                  heartbeat_interval=0.1).register()
               for r in range(2)]
    watcher = tel.ElasticManager(store, rank=-1, world_size=2, lease_ttl=0.6)
    dead = []
    try:
        assert watcher.alive_ranks() == [0, 1]
        watcher.on_rank_dead(dead.append, interval=0.05)
        members[1].stop()                         # heartbeats cease
        assert watcher.watch(interval=0.05, max_wait=30.0) == [1]
        _wait_for(lambda: dead == [1], "the dead-rank callback")
        watcher.reclaim(0)                        # expired at once
        assert 0 in watcher.dead_ranks()
    finally:
        for m in members + [watcher]:
            m.stop()


def test_the_lease_and_join_protocol_is_the_references():
    """A member of either package is alive to the other's watcher; a join
    ticket of either is pending for the other; an empty or garbled lease
    is expired in both."""
    store = _DictStore()
    jm = jel.ElasticManager(store, rank=0, world_size=2, lease_ttl=5.0)
    tm = tel.ElasticManager(store, rank=1, world_size=2, lease_ttl=5.0)
    jm._beat()
    tm._beat()
    for w in (jm, tm):
        assert w.alive_ranks() == [0, 1]
    assert jm.announce_join("a") == 1 and tm.announce_join("b") == 2
    for w in (jm, tm):
        assert w.pending_joins() == [1, 2] and w.pending_joins(1) == [2]
    tm.reclaim(0)
    store.set("lease:1", b"garbled")
    for w in (jm, tm):
        assert w.dead_ranks() == [0, 1]
        assert w.watch_membership(max_wait=0.0) == ("scale_in", [0, 1])
    ps = tel.PrefixStore(_store(), "plane/")
    ps.set("k", "v")
    ps.wait(["k"], timeout=1.0)
    assert ps.get("k") == b"v" and ps.check(["k"]) and not ps.check(["x"])


def _script(tmp_path, body):
    path = tmp_path / "train.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


GANG = """
    import os, sys
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    launch = int(os.environ["PADDLE_ELASTIC_RESTART_COUNT"])
    assert os.environ["PADDLE_ELASTIC_NP"] == os.environ["PADDLE_TRAINERS_NUM"]
    {}
    sys.exit(0)
"""


@pytest.mark.parametrize("body,restarts,ok", [
    ("if rank == 1 and launch == 0: sys.exit(17)", 1, True),
    ("sys.exit(3)", 1, False),
], ids=["one_failure", "every_launch_fails"])
def test_gang_relaunch_and_failure_budget_match_the_reference(
        tmp_path, body, restarts, ok):
    """A member exiting non-zero costs one restart of the whole gang; an
    exhausted budget is a failed result, not an endless loop."""
    script = _script(tmp_path, GANG.format(body))
    got = tel.launch_elastic(script, nprocs=2, max_restarts=1, timeout=60,
                             poll_interval=0.05)
    ref = jel.launch_elastic(script, nprocs=2, max_restarts=1, timeout=60,
                             poll_interval=0.05)
    assert (got.success, got.restarts) == (ref.success, ref.restarts) == \
        (ok, restarts)
    assert len(got.returncodes) == len(ref.returncodes) == 2


def test_scale_out_costs_no_restart_as_in_the_reference(tmp_path):
    """A pending join re-rendezvouses the gang at world size 3; with
    max_restarts 0 that succeeds only if the scale event leaves the
    failure budget alone. The pre-scale gang blocks until it is
    stopped."""
    script = _script(tmp_path, GANG.format(
        "import time\n    "
        "while int(os.environ['PADDLE_TRAINERS_NUM']) == 2: time.sleep(0.05)"))
    for mod in (tel, jel):
        store = _store()
        mod.ElasticManager(store, rank=-1, world_size=0).announce_join("B")
        res = mod.launch_elastic(script, nprocs=2, max_restarts=0,
                                 timeout=60, store=store, max_np=3,
                                 poll_interval=0.05)
        assert res.success and res.restarts == 0, res.returncodes
        assert len(res.returncodes) == 3


def test_the_launcher_runs_an_elastic_gang(tmp_path):
    """`launch --run_mode elastic`: rank 1 fails the first launch, the
    gang is relaunched with the launcher's rendezvous (a fresh endpoint
    per launch) and succeeds; each rank's log collects both launches.
    Rank 1 fails only once rank 0 has printed (it waits, with a bound,
    for the file rank 0 writes after its print): a rank 0 slow to start
    would otherwise be stopped with the gang before it prints."""
    printed = tmp_path / "rank0_printed"
    script = _script(tmp_path, GANG.format(
        "print('launch', launch, os.environ['PADDLE_TRAINER_ENDPOINTS'], "
        "os.environ['PADDLE_DISTRI_DEVICE'], flush=True)\n    "
        f"printed = {str(printed)!r} + str(launch)\n    "
        "if rank == 0: open(printed, 'w').close()\n    "
        "import time\n    "
        "end = time.monotonic() + 30\n    "
        "while rank == 1 and not os.path.exists(printed) "
        "and time.monotonic() < end: time.sleep(0.02)\n    "
        "if rank == 1 and launch == 0: sys.exit(5)"))
    logs = tmp_path / "logs"
    rc = launch.launch(["--run_mode", "elastic", "--nproc_per_node", "2",
                        "--max_restarts", "1", "--device", "cpu",
                        "--log_dir", str(logs), "--timeout", "60", script])
    assert rc == 0
    lines = (logs / "workerlog.0").read_text().split("\n")
    l0, l1 = [ln for ln in lines if ln.startswith("launch")]
    assert l0.startswith("launch 0 ") and l1.startswith("launch 1 ")
    assert l0.split()[2] != l1.split()[2] and l1.endswith(" cpu")
    assert launch.launch(["--run_mode", "elastic", "--max_restarts", "0",
                          _script(tmp_path, GANG.format("sys.exit(2)"))]) == 1


def test_kill_and_join_resume_at_the_committed_epoch(tmp_path):
    """Rank 1 dies on launch 0; the relaunched pair trains under the
    port's AutoCheckpoint until a new node announces itself (after the
    pair committed epochs 0 and 1); the gang of 3 restores the snapshot
    and runs epochs 2-7 once each."""
    script = _script(tmp_path, f"""
        import json, os, sys, time
        sys.path.insert(0, {ROOT!r})
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        ws = int(os.environ["PADDLE_TRAINERS_NUM"])
        launch = int(os.environ["PADDLE_ELASTIC_RESTART_COUNT"])
        if rank == 1 and launch == 0:
            sys.exit(9)
        if rank != 0:
            sys.exit(0)
        from paddle_tpu_torch.framework.sharded_io import AutoCheckpoint
        log = open({str(tmp_path)!r} + "/log_0.txt", "a")
        state = {{"epochs_done": 0}}

        def save(path):
            with open(path, "w") as f:
                json.dump(state, f)

        def load(path):
            with open(path) as f:
                state.update(json.load(f))

        acp = AutoCheckpoint({str(tmp_path)!r} + "/ckpt", save, load)
        for epoch in acp.train_epoch_range(8):
            print(f"ws{{ws}} launch{{launch}} epoch{{epoch}} "
                  f"done{{state['epochs_done']}}", file=log, flush=True)
            while ws == 2 and epoch == 2:
                time.sleep(0.05)    # until the scale-out stops the gang
            state["epochs_done"] += 1
    """)
    store = _store()
    log0 = tmp_path / "log_0.txt"

    def join_after_two_epochs():
        _wait_for(lambda: log0.exists() and "ws2 launch1 epoch2"
                  in log0.read_text(), "the pair's epoch 2", limit=120)
        tel.ElasticManager(store, rank=-1, world_size=0).announce_join("C")

    th = threading.Thread(target=join_after_two_epochs)
    th.start()
    res = tel.launch_elastic(script, nprocs=2, max_restarts=2, timeout=120,
                             store=store, max_np=3, poll_interval=0.05)
    th.join(timeout=130)
    assert not th.is_alive()
    assert res.success, (res.restarts, res.returncodes)
    assert res.restarts == 1 and len(res.returncodes) == 3
    lines = log0.read_text().split("\n")
    ws3 = [ln for ln in lines if ln.startswith("ws3")]
    assert ws3[0] == "ws3 launch2 epoch2 done2"      # resumed, not at 0
    assert [int(ln.split("epoch")[1].split()[0]) for ln in ws3] == \
        list(range(2, 8))
    assert ws3[-1] == "ws3 launch2 epoch7 done7"
