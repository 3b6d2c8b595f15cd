"""The port's PS high availability (`distributed/ps/ha.py`) over its own
store, a `torch.distributed.TCPStore`, in one process
(`tests/test_ps_ha.py`'s in-process drills; its 15 s process soak is the
reference's alone):

- a standby tails the primary's WAL and converges bit-exactly, acking
  its watermark;
- a trainer's client fails over to the promoted standby within its call
  deadline, with the push it had in flight applied exactly once;
- a killed primary restarts from its WAL and rejoins as the standby;
- each role change is an event on the telemetry hook (`obs.telemetry.
  emit`), a no-op with no exporter installed.

No test sleeps to wait: each polls with a deadline. The fixture stops
every node and asserts that nothing of the port's PS plane outlives a
test."""
import datetime
import time

import numpy as np
import pytest
import torch.distributed as dist

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.distributed.ps import ha as psha
from paddle_tpu_torch.obs import telemetry

import torch_ps_parity as psp


class _Events:
    def __init__(self):
        self.seen = []

    def event(self, kind, **detail):
        self.seen.append((kind, detail))


@pytest.fixture(autouse=True)
def _flags_and_no_leak():
    pt.set_device("cpu")
    keep = {k: _flags.flag(k) for k in
            ("ps_ha_lease_ttl_s", "ps_ha_heartbeat_s",
             "ps_replication_interval_ms", "ps_rpc_backoff_ms")}
    _flags.set_flags({"ps_ha_lease_ttl_s": 0.6, "ps_ha_heartbeat_s": 0.15,
                      "ps_replication_interval_ms": 10.0,
                      "ps_rpc_backoff_ms": 20.0})
    pt.set_flags({"FLAGS_monitor": True})
    monitor.reset()
    yield
    pt.set_flags({"FLAGS_monitor": False})
    monitor.reset()
    _flags.set_flags(keep)
    psp.check_no_leak()


def _kill_node(node):
    """Process death: serve loop, heartbeat and replication stop at once,
    with no deregistration."""
    node._loop_stop.set()
    node._es.stop()
    node.server.stop()
    node._closed = True


@pytest.fixture()
def pair(tmp_path):
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          timeout=datetime.timedelta(seconds=30))
    events = _Events()
    telemetry._DEFAULT = events
    primary = standby = client = None
    try:
        primary = psha.HaPsNode(store, wal_dir=str(tmp_path / "a")).start()
        standby = psha.HaPsNode(store, wal_dir=str(tmp_path / "b")).start()
        client = psha.connect(store)
        yield store, primary, standby, client, events
    finally:
        telemetry._DEFAULT = None
        if client is not None:
            client.close()
        for n in (primary, standby):
            if n is not None and not n._closed:
                n.stop()


def _converged(primary, standby):
    return lambda: standby.server.applied_lsn == primary.server.applied_lsn


def test_roles_convergence_and_role_events(pair):
    store, primary, standby, client, events = pair
    assert primary.role == "primary" and standby.role == "standby"
    assert [(k, d["role"]) for k, d in events.seen] == [
        ("role_change", "primary"), ("role_change", "standby")]
    client.create_sparse_table("emb", 4, optimizer="adagrad", lr=0.5, seed=3)
    ids = np.array([1, 5, 9], np.int64)
    client.push_sparse("emb", ids, np.ones((3, 4), np.float32))
    psp.wait_until(_converged(primary, standby))
    for p, s in zip(primary.server.table("emb").snapshot_arrays().values(),
                    standby.server.table("emb").snapshot_arrays().values()):
        np.testing.assert_array_equal(p, s)
    psp.wait_until(lambda: primary.server._repl_acks.get(
        str(standby.node_id), 0) >= 1)
    assert monitor.snapshot()["counters"]["ps.replication.records"] >= 2


def test_failover_within_the_call_deadline_exactly_once(pair):
    store, primary, standby, client, events = pair
    client.create_sparse_table("emb", 4, optimizer="sgd", lr=0.5, seed=3)
    ids = np.array([1, 2], np.int64)
    for _ in range(3):
        client.push_sparse("emb", ids, np.ones((2, 4), np.float32))
    box = {}
    client.push_sparse("emb", [7], np.ones((1, 4), np.float32), _seqs=box)
    psp.wait_until(_converged(primary, standby))
    before = client.pull_sparse("emb", ids).copy()
    want7 = client.pull_sparse("emb", [7]).copy()
    _kill_node(primary)
    t0 = time.monotonic()
    client.push_sparse("emb", ids, np.ones((2, 4), np.float32))
    took = time.monotonic() - t0
    assert took < 10.0, f"failover took {took:.1f} s"
    assert standby.role == "primary"
    np.testing.assert_array_equal(client.pull_sparse("emb", ids),
                                  before - 0.5)
    # the in-flight push, re-sent with its seqs, is dropped by the ledger
    client.push_sparse("emb", [7], np.ones((1, 4), np.float32), _seqs=box)
    np.testing.assert_array_equal(client.pull_sparse("emb", [7]), want7)
    c = monitor.snapshot()["counters"]
    assert c.get("ps.failovers", 0) >= 1 and c.get("ps.promotions", 0) == 1
    assert events.seen[-1][0] == "role_change" and \
        events.seen[-1][1]["role"] == "primary"


def test_the_ex_primary_rejoins_as_the_standby(pair, tmp_path):
    store, primary, standby, client, _ = pair
    client.create_sparse_table("emb", 4, optimizer="sgd", lr=0.5, seed=3)
    client.push_sparse("emb", [1], np.ones((1, 4), np.float32))
    psp.wait_until(_converged(primary, standby))
    _kill_node(primary)
    client.push_sparse("emb", [1], np.ones((1, 4), np.float32))
    assert standby.role == "primary"
    want = client.pull_sparse("emb", [1]).copy()
    rejoined = psha.HaPsNode(store, wal_dir=str(tmp_path / "a")).start()
    try:
        assert rejoined.role == "standby"
        psp.wait_until(_converged(standby, rejoined))
        np.testing.assert_array_equal(
            rejoined.server.table("emb").pull([1]), want)
    finally:
        rejoined.stop()
    # the status side-file `monitor ps` reads
    assert monitor._main(["ps", str(tmp_path / "b")]) == 0


def test_the_telemetry_hook_is_a_no_op_without_an_exporter():
    assert telemetry.get_default() is None
    telemetry.emit("role_change", role="primary")   # nothing to call
    ev = _Events()
    telemetry._DEFAULT = ev
    try:
        telemetry.emit("role_change", role="standby", node=3)
        assert telemetry.get_default() is ev
        assert ev.seen == [("role_change", {"role": "standby", "node": 3})]
    finally:
        telemetry._DEFAULT = None
