"""`paddle_tpu_torch.guard` against `paddle_tpu.guard`
(`tests/test_guard.py`'s cases on the port's TrainStep).

On a tiny GPT TrainStep (dropout on, AdamW): a SIGTERM mid-epoch, then a
checkpoint, then fresh objects with another seed and `resume()`, ends
bit-identical to an uninterrupted run (parameters, slots, step count,
generators); a NaN or spiking loss rolls back bit-exactly and skips;
`DivergedError` after the limit; the watchdog surfaces an injected hang;
the desync vote over two ranks of a TCPStore; crash-atomic checkpoints,
whose files load in the other package. The guard's decisions (skip, keep,
raise) on one scripted loss sequence equal the JAX TrainGuard's."""
import datetime
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from paddle_tpu import guard as jguard
import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.guard import (DesyncDetector, DivergedError,
                                    GuardConfig, PreemptedError,
                                    RankDesyncError, StepStalledError,
                                    StepWatchdog, TrainGuard, array_crc,
                                    fingerprint, load_guard_state,
                                    rollback_guard_state, save_guard_state)
from paddle_tpu_torch.jit import TrainStep

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, dropout=0.1)


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture
def with_monitor():
    _flags.set_flags({"monitor": True})
    monitor.reset()
    yield
    monitor.reset()
    _flags.set_flags({"monitor": False})


def _gpt_step(seed=0):
    pt.seed(seed)
    net = pt.models.GPTForCausalLM(pt.models.gpt.GPTModel(**CFG))
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=net.parameters())
    return TrainStep(net, pt.models.GPTPretrainingCriterion(), opt)


def _gpt_batches(n=3):
    rng = np.random.default_rng(0)
    return [(torch.from_numpy(ids), torch.from_numpy(ids)) for ids in
            (rng.integers(0, 64, (4, 16)) for _ in range(n))]


def _linear_step(seed=0):
    pt.seed(seed)
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                           pt.nn.Linear(8, 1))
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=1e-2)
    return TrainStep(net, pt.nn.MSELoss(), opt, n_model_inputs=1)


def _linear_batches(n=8):
    rng = np.random.RandomState(1)
    return [(torch.from_numpy(rng.rand(8, 4).astype("float32")),
             torch.from_numpy(rng.rand(8, 1).astype("float32")))
            for _ in range(n)]


def _nan_batch():
    return torch.full((8, 4), float("nan"))


def _run(guard, batches, epochs, start=(0, 0)):
    for epoch in range(epochs):
        for b, batch in enumerate(batches):
            if (epoch, b) < tuple(start):
                continue
            guard.set_cursor(epoch, b)
            guard.step(*batch)


def _assert_state_equal(a, b, rng=True):
    assert sorted(a["params"]) == sorted(b["params"])
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n], n)
    for sa, sb in zip(a["slots"], b["slots"]):
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
    assert a["step_count"] == b["step_count"]
    np.testing.assert_array_equal(a["t"], b["t"])
    if rng:
        for k in a["rng_key"]:
            np.testing.assert_array_equal(np.asarray(a["rng_key"][k]),
                                          np.asarray(b["rng_key"][k]))


# ---- preemption-safe resume ----
def test_sigterm_mid_epoch_then_resume_is_bit_identical(tmp_path):
    batches = _gpt_batches(3)
    step_a = _gpt_step()
    with TrainGuard(step_a, config=GuardConfig(snapshot_interval=0)) as ga:
        _run(ga, batches, epochs=2)
    final_a = step_a.state_dict()

    ckpt = str(tmp_path / "guard")
    step_b = _gpt_step()
    with TrainGuard(step_b, ckpt_dir=ckpt,
                    config=GuardConfig(snapshot_interval=0)) as gb:
        with pytest.raises(PreemptedError) as ei:
            for epoch in range(2):
                for b, batch in enumerate(batches):
                    gb.set_cursor(epoch, b)
                    if (epoch, b) == (1, 1):
                        os.kill(os.getpid(), signal.SIGTERM)
                    gb.step(*batch)
    assert ei.value.cursor == (1, 2) and ei.value.ckpt_dir == ckpt

    step_c = _gpt_step(seed=123)        # the relaunch: other weights
    pt.seed(99)                          # and another generator state
    with TrainGuard(step_c, ckpt_dir=ckpt,
                    config=GuardConfig(snapshot_interval=0)) as gc:
        start = gc.resume()
        assert start == (1, 2)
        _run(gc, batches, epochs=2, start=start)
    _assert_state_equal(final_a, step_c.state_dict())


def test_sigint_preempts_and_counts_and_handlers_are_restored(with_monitor,
                                                              tmp_path):
    prev = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    step = _linear_step()
    x, y = _linear_batches(1)[0]
    with TrainGuard(step, config=GuardConfig(snapshot_interval=0)) as g:
        assert signal.getsignal(signal.SIGTERM) is not prev[0]
        g.set_cursor(0, 0)
        g.step(x, y)
        os.kill(os.getpid(), signal.SIGINT)
        with pytest.raises(PreemptedError) as ei:
            g.set_cursor(0, 1)
            g.step(x, y)
    assert ei.value.ckpt_dir is None
    assert monitor.counter("guard.preempts").get() == 1
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == prev
    with TrainGuard(_linear_step(), ckpt_dir=str(tmp_path / "none")) as g:
        assert g.resume() is None


def test_scaler_and_scheduler_round_trip(tmp_path):
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import lr as lr_mod

    def make(seed, scale):
        pt.seed(seed)
        net = pt.nn.Sequential(pt.nn.Linear(4, 4), pt.nn.Linear(4, 1))
        sched = lr_mod.StepDecay(learning_rate=0.1, step_size=2)
        opt = pt.optimizer.Adam(parameters=net.parameters(),
                                learning_rate=sched)
        return (TrainStep(net, pt.nn.MSELoss(), opt, n_model_inputs=1),
                sched, opt, GradScaler(init_loss_scaling=scale))

    step, sched, opt, scaler = make(0, 512.0)
    scaler._good_steps, scaler._bad_steps, scaler._found_inf = 7, 1, True
    with TrainGuard(step, ckpt_dir=str(tmp_path / "g"), scaler=scaler) as g:
        g.set_cursor(0, 0)
        g.step(*_linear_batches(1)[0])
        sched.step()
        sched.step()
        g.checkpoint()
    step2, sched2, opt2, scaler2 = make(1, 2.0 ** 15)
    with TrainGuard(step2, ckpt_dir=str(tmp_path / "g"),
                    scaler=scaler2) as g2:
        assert g2.resume() == (0, 1)
    assert scaler2.get_loss_scaling() == 512.0
    assert (scaler2._good_steps, scaler2._bad_steps,
            scaler2._found_inf) == (7, 1, True)
    assert sched2.last_epoch == sched.last_epoch
    assert opt2.get_lr() == opt.get_lr()


# ---- the step watchdog ----
def test_an_injected_hang_surfaces_within_twice_the_deadline():
    step = _linear_step()
    batches = _linear_batches(2)
    g = TrainGuard(step, config=GuardConfig(step_timeout_s=0.4,
                                            snapshot_interval=0))
    try:
        g.set_cursor(0, 0)
        g.step(*batches[0])
        with faults.inject("guard.step:delay:delay=1.5:times=1"):
            t0 = time.monotonic()
            with pytest.raises(StepStalledError) as ei:
                g.step(*batches[0])
            elapsed = time.monotonic() - t0
        assert elapsed < 0.8
        assert ei.value.phase == "dispatch"
        assert ei.value.deadline_s == pytest.approx(0.4)
        loss = g.step(*batches[1])        # a fresh runner serves it
        assert loss is not None and np.isfinite(loss)
    finally:
        g.close(grace_s=3.0)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("guard-") and t.is_alive()]


def test_the_auto_deadline_and_a_stale_result():
    for mod in (pt.guard, jguard):
        wd = mod.StepWatchdog(timeout_s=0.0, warmup_steps=3, factor=5.0,
                              min_timeout_s=0.05)
        try:
            assert wd.deadline() is None
            for _ in range(3):
                wd.run(time.sleep, 0.02)
            assert 0.05 <= wd.deadline() < 0.5
        finally:
            wd.close(grace_s=3.0)
    wd = StepWatchdog(timeout_s=0.15, warmup_steps=1)
    try:
        with pytest.raises(StepStalledError):
            wd.run(lambda: (time.sleep(0.4), "stale")[1])
        assert wd.run(lambda: "fresh") == "fresh"
    finally:
        wd.close(grace_s=2.0)


def test_a_step_exception_propagates_and_counts(with_monitor):
    step = _linear_step()
    x, y = _linear_batches(1)[0]
    with TrainGuard(step, config=GuardConfig(snapshot_interval=0)) as g:
        g.set_cursor(0, 0)
        g.step(x, y)
        with faults.inject("guard.step:error:times=1"):
            with pytest.raises(faults.InjectedFault):
                g.step(x, y)
        assert monitor.counter("guard.step_errors").get() == 1
        assert np.isfinite(g.step(x, y))


# ---- the divergence guard ----
def test_a_nan_step_rolls_back_bit_exactly_and_skips(with_monitor):
    step = _gpt_step()
    batches = _gpt_batches(3)
    with TrainGuard(step, config=GuardConfig(snapshot_interval=1,
                                             max_bad_steps=3)) as g:
        for i, batch in enumerate(batches):
            g.set_cursor(0, i)
            g.step(*batch)
        before = step.state_dict()
        # a poisoned embedding row: every loss of the batch is NaN
        emb = step.model.gpt.embeddings.word_embeddings.weight
        with torch.no_grad():
            emb[int(batches[0][0][0, 0])] = float("nan")
        assert g.step(*batches[0]) is None
        _assert_state_equal(before, step.state_dict())
        assert monitor.counter("guard.bad_steps").get() == 1
        assert monitor.counter("guard.rollbacks").get() == 1
        assert monitor.counter("guard.steps").get() == 3
        assert np.isfinite(g.step(*batches[1]))


def test_check_nan_inf_is_a_bad_step_too():
    """FLAGS_check_nan_inf makes TrainStep raise FloatingPointError after
    it committed the poisoned update: the guard rolls it back."""
    _flags.set_flags({"check_nan_inf": True})
    try:
        step = _linear_step()
        batches = _linear_batches(2)
        with TrainGuard(step, config=GuardConfig(snapshot_interval=1,
                                                 max_bad_steps=3)) as g:
            g.set_cursor(0, 0)
            g.step(*batches[0])
            before = step.state_dict()
            assert g.step(_nan_batch(), batches[0][1]) is None
            _assert_state_equal(before, step.state_dict())
    finally:
        _flags.set_flags({"check_nan_inf": False})


def test_a_spike_rolls_back_and_the_limit_raises_diverged():
    step = _linear_step()
    batches = _linear_batches(4)
    with TrainGuard(step, config=GuardConfig(snapshot_interval=1,
                                             max_bad_steps=3)) as g:
        _run(g, batches, epochs=1)
        before = step.state_dict()
        assert g.step(torch.full((8, 4), 1e4), batches[0][1]) is None
        _assert_state_equal(before, step.state_dict())
        assert g.step(_nan_batch(), batches[0][1]) is None
        with pytest.raises(DivergedError) as ei:
            g.step(_nan_batch(), batches[0][1])
    assert ei.value.bad_steps == 3


def _scripted(losses):
    """A step stand-in whose call returns the next scripted loss."""
    class Step:
        def __init__(self):
            self.it = iter(losses)

        def __call__(self, *batch):
            return next(self.it)

        def state_dict(self):
            return {}

        def set_state_dict(self, sd):
            pass

    return Step()


@pytest.mark.parametrize("max_bad", [2, 3])
def test_the_decisions_on_one_loss_sequence_are_the_references(max_bad):
    losses = [1.0, 0.9, float("nan"), 0.8, 50.0, 0.85, 0.7, float("inf"),
              0.6, 40.0, float("nan"), float("nan"), 0.5]
    decisions = []
    for mod in (pt.guard, jguard):
        cfg = mod.GuardConfig(snapshot_interval=2, max_bad_steps=max_bad,
                              loss_spike_ratio=10.0)
        out = []
        g = mod.TrainGuard(_scripted(losses), config=cfg, signals=())
        try:
            for i in range(len(losses)):
                try:
                    out.append(g.step(i))
                except mod.DivergedError as e:
                    out.append(("diverged", e.bad_steps))
                    break
        finally:
            g.close()
        decisions.append(out)
    assert decisions[0] == decisions[1]
    assert decisions[0][-1] == ("diverged", max_bad)
    assert decisions[0].count(None) == max_bad + 2


# ---- cross-rank desync ----
class _DictStore:
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


def _ranks(n, fn):
    out = [None] * n
    ts = [threading.Thread(target=lambda r=r: out.__setitem__(r, fn(r)))
          for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    return out


def test_the_vote_names_the_minority_on_every_rank(with_monitor):
    store = _DictStore()
    good = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    bad = {"w": good["w"].clone()}
    bad["w"][1, 1] = torch.nextafter(bad["w"][1, 1], torch.tensor(99.0))

    def rank(r):
        det = DesyncDetector(store, r, 3, timeout_s=5.0)
        try:
            det.check(7, bad if r == 2 else good)
        except RankDesyncError as e:
            return e

    errs = _ranks(3, rank)
    assert all(e is not None and e.offenders == [2] and e.step == 7
               for e in errs)
    assert monitor.counter("guard.desync_checks").get() == 3
    assert DesyncDetector._vote({0: 111, 1: 222}) == [1]
    assert DesyncDetector._vote({0: 5, 1: 5}) == []
    assert set(DesyncDetector(None, 0, 1).check(1, good)) == {0}


def test_fingerprints_equal_the_references():
    rng = np.random.default_rng(0)
    arrs = {"w": rng.normal(size=(8, 3)).astype(np.float32),
            "b": np.ones(3, np.float32)}
    tens = {k: torch.from_numpy(v) for k, v in arrs.items()}
    assert fingerprint(tens) == jguard.fingerprint(arrs)
    assert array_crc(tens["w"]) == jguard.array_crc(arrs["w"])
    drift = dict(tens, w=tens["w"].clone())
    drift["w"][0, 0] = torch.nextafter(drift["w"][0, 0], torch.tensor(9.0))
    assert fingerprint(drift) != fingerprint(tens)
    assert fingerprint({"w2": tens["w"], "b": tens["b"]}) != fingerprint(tens)


def test_two_ranks_over_a_tcp_store_name_the_desynced_rank():
    """Two ranks, each with its own TrainStep and TrainGuard(desync
    interval 2) and its own client of one TCPStore; rank 1's parameters
    drift after round 1: both ranks raise naming rank 1 at round 2."""
    master = dist.TCPStore("127.0.0.1", 0, is_master=True,
                           wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=30))
    batches = _linear_batches(4)
    steps = [_linear_step(), _linear_step()]
    for s in steps:
        s.named_param_arrays()           # build before the threads

    def rank(r):
        store = dist.TCPStore("127.0.0.1", master.port, is_master=False,
                              timeout=datetime.timedelta(seconds=30))
        g = TrainGuard(steps[r], store=store, rank=r, world_size=2,
                       config=GuardConfig(snapshot_interval=0,
                                          desync_interval=2,
                                          desync_timeout_s=20.0),
                       signals=())
        try:
            for i, b in enumerate(batches):
                if r == 1 and i == 2:
                    with torch.no_grad():
                        next(iter(steps[r].model.parameters())).add_(1e-3)
                g.set_cursor(0, i)
                g.step(*b)
            return "ok"
        except RankDesyncError as e:
            return e
        finally:
            g.close()

    errs = _ranks(2, rank)
    for e in errs:
        assert isinstance(e, RankDesyncError), e
        assert e.offenders == [1] and e.step == 2


# ---- crash-atomic guard checkpoints ----
def test_a_crash_between_payload_and_commit_keeps_the_previous(tmp_path):
    d = str(tmp_path / "g")
    save_guard_state(d, {"w": np.arange(4, dtype="float32")}, {"gen": 1})
    with faults.inject("guard.snapshot:error:times=1"):
        with pytest.raises(faults.InjectedFault):
            save_guard_state(d, {"w": np.full(4, 9.0, "float32")},
                             {"gen": 2})
    for load in (load_guard_state, jguard.load_guard_state):
        arrays, meta = load(d)
        assert meta["gen"] == 1
        np.testing.assert_array_equal(arrays["w"],
                                      np.arange(4, dtype="float32"))


def test_a_torn_payload_falls_back_and_rollback_promotes(tmp_path,
                                                         with_monitor):
    d = str(tmp_path / "g")
    save_guard_state(d, {"w": np.arange(4, dtype="float32")}, {"gen": 1})
    with faults.inject("guard.snapshot.write:torn:times=1"):
        save_guard_state(d, {"w": np.full(4, 9.0, "float32")}, {"gen": 2})
    with pytest.warns(UserWarning, match="falling back"):
        arrays, meta = load_guard_state(d)
    assert meta["gen"] == 1
    assert monitor.counter("guard.ckpt_fallbacks").get() == 1
    assert rollback_guard_state(d) == 1


def test_guard_files_move_between_the_packages(tmp_path):
    """bf16 tensors round-trip bit for bit; a JAX-written generation
    loads in the port and the reverse."""
    import ml_dtypes
    w = torch.arange(6, dtype=torch.float32).bfloat16() * 0.3
    save_guard_state(str(tmp_path / "t"), {"w": w, "i": np.arange(3)},
                     {"who": "port"})
    arrays, meta = jguard.load_guard_state(str(tmp_path / "t"))
    assert meta == {"who": "port"}
    assert arrays["w"].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(arrays["w"].view(np.int16),
                                  w.view(torch.int16).numpy())
    jw = np.arange(6).astype(ml_dtypes.bfloat16)
    jguard.save_guard_state(str(tmp_path / "j"), {"w": jw}, {"who": "jax"})
    arrays, meta = load_guard_state(str(tmp_path / "j"))
    assert meta == {"who": "jax"}
    np.testing.assert_array_equal(arrays["w"].view(np.int16),
                                  jw.view(np.int16))


def test_checkpoint_and_resume_counters(tmp_path, with_monitor):
    step = _linear_step()
    with TrainGuard(step, ckpt_dir=str(tmp_path / "g"),
                    config=GuardConfig(snapshot_interval=1)) as g:
        g.set_cursor(0, 0)
        g.step(*_linear_batches(1)[0])
        g.checkpoint()
    with TrainGuard(_linear_step(), ckpt_dir=str(tmp_path / "g")) as g2:
        g2.resume()
    snap = monitor.snapshot()["counters"]
    assert snap["guard.checkpoints"] == 1 and snap["guard.resumes"] == 1
    assert snap["guard.steps"] == 1 and snap["guard.snapshots"] >= 2
