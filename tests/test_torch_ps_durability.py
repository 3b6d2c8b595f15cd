"""The port's PS durability plane (`distributed/ps/wal.py`,
`PsServer(wal_dir=...)`) against the JAX package's
(`tests/test_ps_durability.py`'s cases):

- one push sequence gives byte-identical WAL segments in both packages;
- each package recovers a directory the other wrote (snapshot + WAL
  suffix) to bit-equal tables at the same `applied_lsn`;
- a torn tail record is truncated as the reference truncates it, and a
  crash between a snapshot's payload and its manifest falls back to the
  previous generation plus replay;
- a trainer retry stays exactly-once across a restart; the Communicator
  requeues a push the transport lost;
- `monitor ps DIR` renders the directory as the reference's does.

Every server and writer is stopped in its test; the fixture asserts that
nothing of the port's PS plane outlives a test."""
import glob
import os

import numpy as np
import pytest

from paddle_tpu.distributed import ps as jps
from paddle_tpu.distributed.ps import wal as jwal
import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed.ps import wal as twal

import torch_ps_parity as psp


@pytest.fixture(autouse=True)
def _monitor_and_no_leak():
    pt.set_device("cpu")
    pt.set_flags({"FLAGS_monitor": True})
    monitor.reset()
    yield
    pt.set_flags({"FLAGS_monitor": False})
    monitor.reset()
    psp.check_no_leak()


def _counters():
    return monitor.snapshot()["counters"]


def _records(w, pkg):
    ids = np.array([3, 9, 2 ** 40], np.int64)
    g = np.arange(12, dtype=np.float32).reshape(3, 4)
    w.append(pkg.R_ADD_SPARSE, "emb", "", -1,
             b'{"dim": 4, "optimizer": "adam", "lr": 0.05, "seed": 3}')
    for i in range(40):
        w.append(pkg.R_PUSH_SPARSE, "emb", "client-a", i,
                 pkg.pack_push_sparse(ids, g * i))
    w.append(pkg.R_PUSH_DENSE, "fc", "client-b", 7,
             pkg.pack_push_dense(np.ones(6, np.float32)))
    w.append(pkg.R_SHOW_CLICK, "emb", "client-a", 41,
             pkg.pack_show_click(ids, np.ones(3), np.zeros(3)))
    w.append(pkg.R_DECAY, "emb", "", -1, b"")


def test_one_record_sequence_gives_byte_identical_segments(tmp_path):
    """Small segments, so the sequence rolls over: every segment's name
    and bytes are the same in both packages."""
    files = {}
    for name, pkg in (("ref", jwal), ("port", twal)):
        d = str(tmp_path / name)
        w = pkg.WalWriter(d, segment_bytes=1024)
        _records(w, pkg)
        w.close()
        files[name] = {os.path.basename(p): open(p, "rb").read()
                       for p in sorted(glob.glob(os.path.join(d, "*")))}
    assert len(files["port"]) > 2
    assert files["port"] == files["ref"]
    recs = twal.replay(str(tmp_path / "ref"))
    assert [r.lsn for r in recs] == list(range(1, 45))
    rids, rg = twal.unpack_push_sparse(recs[5].payload)
    assert rids.tolist() == [3, 9, 2 ** 40] and rg[2, 3] == 11 * 4


def _durable_run(pkg, d):
    """A server of `pkg` over `d`: tables, pushes, a snapshot, a WAL
    suffix; returns the state to recover."""
    s = pkg.PsServer("127.0.0.1", 0, wal_dir=d)
    s.add_sparse_table("emb", dim=4, optimizer="adagrad", lr=0.1, seed=2,
                       accessor="ctr")
    s.add_dense_table("fc", (3, 2), optimizer="adam", lr=0.05)
    s.run()
    c = pkg.PsClient([f"127.0.0.1:{s.port}"])
    c.register_sparse_dim("emb", 4)
    ids = np.array([1, 5, 9, 2], np.int64)
    try:
        c.push_sparse("emb", ids, np.ones((4, 4), np.float32))
        c.push_dense("fc", np.ones(6, np.float32))
        c.push_show_click("emb", ids, np.ones(4), np.array([1, 0, 0, 1]))
        s.snapshot()
        c.push_sparse("emb", ids, np.full((4, 4), 2.0, np.float32))
        c.push_dense("fc", np.full(6, 0.5, np.float32))
        c.decay("emb")
        return (s.applied_lsn, s.table("emb").snapshot_arrays(),
                s.table("fc").snapshot_arrays())
    finally:
        c.close()
        s.stop()


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_recovers_the_others_directory(tmp_path, writer,
                                                    reader):
    pkgs = {"ref": jps, "port": tps}
    d = str(tmp_path / "wal")
    lsn, emb, fc = _durable_run(pkgs[writer], d)
    s2 = pkgs[reader].PsServer("127.0.0.1", 0, wal_dir=d)
    try:
        assert s2.applied_lsn == lsn
        _same_arrays(s2.table("emb").snapshot_arrays(), emb)
        _same_arrays(s2.table("fc").snapshot_arrays(), fc)
    finally:
        s2.stop()


def _start(d):
    s = tps.PsServer("127.0.0.1", 0, wal_dir=d)
    s.add_sparse_table("emb", dim=4, lr=0.5, seed=1)
    s.run()
    c = tps.PsClient([f"127.0.0.1:{s.port}"])
    c.register_sparse_dim("emb", 4)
    return s, c


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_torn_tail_is_truncated_as_the_reference_does(tmp_path, pkg):
    """The port tears its own last record (the `ps.wal.write` site); each
    package recovers the intact prefix and truncates the same bytes."""
    d = str(tmp_path)
    s, c = _start(d)
    ids = np.array([1, 5], np.int64)
    try:
        c.push_sparse("emb", ids, np.ones((2, 4), np.float32))
        want = c.pull_sparse("emb", ids).copy()
        lsn = s.applied_lsn
        with faults.inject("ps.wal.write:torn:times=1"):
            c.push_sparse("emb", ids, np.ones((2, 4), np.float32))
    finally:
        c.close()
        s.stop()
    seg = sorted(glob.glob(os.path.join(d, "wal-*")))[-1]
    torn_size = os.path.getsize(seg)
    s2 = (jps if pkg == "ref" else tps).PsServer("127.0.0.1", 0, wal_dir=d)
    try:
        assert s2.applied_lsn == lsn
        np.testing.assert_array_equal(s2.table("emb").pull(ids), want)
    finally:
        s2.stop()
    kept = os.path.getsize(seg)
    assert kept < torn_size
    # the other package truncates at the same byte
    assert twal.repair(d) == jwal.repair(d) == lsn
    assert os.path.getsize(seg) == kept
    if pkg == "port":
        assert _counters().get("ps.wal.fallbacks", 0) >= 1


def test_a_crash_before_the_manifest_falls_back_a_generation(tmp_path):
    d = str(tmp_path)
    s, c = _start(d)
    ids = np.array([2, 7], np.int64)
    try:
        c.push_sparse("emb", ids, np.ones((2, 4), np.float32))
        s.snapshot()
        c.push_sparse("emb", ids, np.ones((2, 4), np.float32))
        want = c.pull_sparse("emb", ids).copy()
        with faults.inject("ps.snapshot.commit:error:times=1"):
            with pytest.raises(faults.InjectedFault):
                s.snapshot()
    finally:
        c.close()
        s.stop()
    for pkg in (tps, jps):
        s2 = pkg.PsServer("127.0.0.1", 0, wal_dir=d)
        try:
            np.testing.assert_array_equal(s2.table("emb").pull(ids), want)
        finally:
            s2.stop()


def test_a_retry_stays_exactly_once_across_a_restart(tmp_path):
    d = str(tmp_path)
    s, c = _start(d)
    box = {}
    try:
        base = c.pull_sparse("emb", [42]).copy()
        c.push_sparse("emb", [42], np.ones((1, 4), np.float32), _seqs=box)
        want = c.pull_sparse("emb", [42]).copy()
        port = s.port
    finally:
        s.stop()
    s2 = tps.PsServer("127.0.0.1", port, wal_dir=d)
    s2.run()
    try:
        c.push_sparse("emb", [42], np.ones((1, 4), np.float32), _seqs=box)
        got = c.pull_sparse("emb", [42])
        np.testing.assert_array_equal(got, want)
        assert not np.allclose(got, base)
        assert _counters().get("ps.wal.records_replayed", 0) >= 1
    finally:
        c.close()
        s2.stop()


def test_a_lost_push_is_requeued_and_applied_once():
    s = tps.PsServer()
    s.add_sparse_table("emb", dim=4, lr=0.5)
    s.run()
    client = tps.PsClient([f"127.0.0.1:{s.port}"], max_retries=1,
                          backoff_ms=5.0)
    client.register_sparse_dim("emb", 4)
    comm = tps.Communicator(client)
    try:
        base = client.pull_sparse("emb", [8]).copy()
        with faults.inject("ps.rpc.send:conn_reset:times=3"):
            comm.push_sparse_async("emb", [8], np.ones((1, 4), np.float32))
            comm.flush(timeout=30.0)
        np.testing.assert_allclose(client.pull_sparse("emb", [8]),
                                   base - 0.5, rtol=1e-6)
        assert _counters().get("ps.communicator.requeues", 0) >= 1
    finally:
        comm.stop()
        client.close()
        s.stop()


def test_monitor_ps_renders_the_directory_like_the_reference(tmp_path,
                                                             capsys):
    from paddle_tpu import monitor as jmonitor
    d = str(tmp_path / "wal")
    _durable_run(tps, d)
    assert monitor._main(["ps", d]) == 0
    port_out = capsys.readouterr().out
    assert jmonitor._main(["ps", d]) == 0
    assert port_out == capsys.readouterr().out
    assert "snapshot: v1" in port_out and "last_lsn=" in port_out
    assert monitor._main(["ps", str(tmp_path / "nope")]) == 2
