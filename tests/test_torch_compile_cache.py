"""The port's persistent compile cache (`paddle_tpu_torch.core.compile_cache`,
`core.executable.acquire`, to_static's cache branch, the warm-start
workload) against `paddle_tpu.core.compile_cache`.

- the on-disk logic of both packages on one sequence of store / lookup /
  gc / verify over blobs of equal sizes and `last_used` stamps: the same
  evictions, the same fallback reasons (prune, plain miss, torn write,
  blob without manifest, stale version, wrong topology) and the same
  `stats()`;
- to_static's hit path: `release()`, then a call makes no export and
  gives a bit-equal output; gradients through a loaded export equal a
  fresh export's (exactly: the same operators in the same order);
- a corrupt, torn, stale-torch-version or wrong-topology entry falls back
  to a fresh export, counted and pruned, never raised;
- a function holding tensor constants is not persisted; the key moves
  with the source, a flag, the dtype and the `training` flag;
- two processes of `utils/warm_start.py` (cold, then warm: zero exports,
  equal digests) and two racing cold processes (a consistent directory);
- the ledger's LRU half against the reference's; `atomic_write`'s per-writer
  tmp names under racing threads; the `monitor cache` CLI.
"""
import importlib.util
import json
import os
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu.core.compile_cache as jcc
import paddle_tpu.core.executable as jexe
from paddle_tpu import faults as jfaults
from paddle_tpu import monitor as jmonitor
from paddle_tpu.core import flags as jflags

import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.core import compile_cache as cc
from paddle_tpu_torch.core import executable as exe
from paddle_tpu_torch.core import flags as flags
from paddle_tpu_torch.framework.io import atomic_write
from paddle_tpu_torch.utils import warm_start

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0)


@pytest.fixture(autouse=True)
def _cpu_and_no_leak():
    pt.set_device("cpu")
    yield
    leaked = bool(flags.flag("compile_cache_dir"))
    flags.set_flags({"compile_cache_dir": "", "monitor": False})
    faults.clear()
    assert not leaked, "compile_cache_dir leaked out of the test"


@pytest.fixture
def cache_on(tmp_path):
    d = str(tmp_path / "cc")
    flags.set_flags({"compile_cache_dir": d, "monitor": True})
    monitor.reset()
    cc.reset_stats()
    yield d
    flags.set_flags({"compile_cache_dir": "", "monitor": False})
    monitor.reset()
    cc.reset_stats()


def _doctor(d, key, **fields):
    mpath = os.path.join(d, key + ".json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest.update(fields)
    with open(mpath, "w") as f:
        json.dump(manifest, f)


def _whys(mod):
    return [e["why"] for e in mod.events()
            if e["event"] == "compile_cache.fallback"]


# ---- the on-disk logic against the reference --------------------------------

def _drive(cache, fault_mod, d, version_field):
    """One sequence of store / lookup / gc / verify on `cache` (either
    package's module) over `d`; returns what it observed."""
    seen = {}
    kb = 1024
    for i, key in enumerate(("a" * 40, "b" * 40, "c" * 40)):
        assert cache.store(key, bytes([i]) * (300 * kb), kind="test",
                           label="t")
        _doctor(d, key, last_used=1000.0 + i)
    seen["hit"] = cache.lookup("a" * 40) == bytes([0]) * (300 * kb)
    seen["plain_miss"] = cache.lookup("f" * 40)
    with open(os.path.join(d, "b" * 40 + ".bin"), "wb") as f:
        f.write(b"\xff" * (300 * kb))
    seen["corrupt"] = cache.lookup("b" * 40)
    seen["pruned"] = not os.path.exists(os.path.join(d, "b" * 40 + ".bin"))
    cache.store("d" * 40, b"d" * (100 * kb), kind="test")
    os.remove(os.path.join(d, "d" * 40 + ".json"))
    seen["no_manifest"] = cache.lookup("d" * 40)
    with fault_mod.inject("compile_cache.write:torn"):
        cache.store("e" * 40, b"e" * (64 * kb), kind="test")
    seen["torn_bytes"] = os.path.getsize(os.path.join(d, "e" * 40 + ".bin"))
    seen["torn"] = cache.lookup("e" * 40)
    cache.store("g" * 40, b"g" * kb, kind="test")
    _doctor(d, "g" * 40, **{version_field: "0.0.1"})
    seen["stale"] = cache.lookup("g" * 40)
    cache.store("h" * 40, b"h" * kb, kind="test")
    _doctor(d, "h" * 40, topology="elsewhere x8192")
    seen["topology"] = cache.lookup("h" * 40)
    for i, key in enumerate(("i" * 40, "j" * 40)):
        cache.store(key, b"i" * (200 * kb), kind="test")
        _doctor(d, key, last_used=2000.0 + i)
    seen["evicted"] = cache.gc(d, cap_mb=0.6)
    cache.store("k" * 40, b"k" * kb, kind="test")
    with open(os.path.join(d, "k" * 40 + ".bin"), "wb") as f:
        f.write(b"garbage")
    seen["verify"] = cache.verify(d)
    seen["entries"] = [r["key"] for r in cache.entries(d)]
    seen["stats"] = cache.stats()
    return seen


def test_on_disk_logic_matches_the_reference(tmp_path):
    out = {}
    for name, cache, fault_mod, mon, fl, field in (
            ("ref", jcc, jfaults, jmonitor, jflags, "jax_version"),
            ("port", cc, faults, monitor, flags, "torch_version")):
        d = str(tmp_path / name)
        fl.set_flags({"compile_cache_dir": d, "monitor": True})
        mon.reset()
        cache.reset_stats()
        try:
            out[name] = _drive(cache, fault_mod, d, field)
            out[name]["whys"] = _whys(mon)
        finally:
            fl.set_flags({"compile_cache_dir": "", "monitor": False})
            mon.reset()
            cache.reset_stats()
    ref, port = out["ref"], out["port"]
    assert ref["whys"] == ["crc_mismatch", "missing_manifest",
                           "crc_mismatch", "stale_jax_version",
                           "wrong_topology"]
    assert port["whys"] == [w.replace("jax", "torch") for w in ref["whys"]]
    for k in ("whys",):
        ref.pop(k), port.pop(k)
    assert port == ref
    assert port["torn_bytes"] == 32 * 1024
    assert port["evicted"] == ["c" * 40, "i" * 40]     # LRU first
    assert port["stats"] == {"hits": 1, "misses": 0, "fallbacks": 5,
                             "stores": 10, "evictions": 2,
                             "export_skips": 0}


def test_disabled_by_default_and_acquire_costs_nothing():
    assert not cc.enabled() and cc._DIR == ""
    called = []

    def note(*_):
        called.append(1)

    out = exe.acquire("to_static", lambda: "built",
                      lambda: note() or "material", dumps=note, loads=note,
                      not_persistable=note)
    assert out == ("built", "fresh") and called == []


def test_core_knows_no_program_format():
    """`acquire` takes the regime's serializer and persistence rule: the
    core layer imports nothing of jit/ or static/."""
    import ast
    tree = ast.parse(open(exe.__file__).read())
    imported = {(n.module or "") for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)}
    assert not any(m.split(".")[-1] in ("jit", "static", "save_load",
                                        "program") or ".jit" in m or
                   ".static" in m for m in imported), imported


def test_ledger_lru_matches_the_reference():
    logs = {}
    for name, ledger_cls in (("ref", jexe.ExecutableLedger),
                             ("port", exe.ExecutableLedger)):
        log = []
        led = ledger_cls("k", cap=2, on_evict=lambda s, v, log=log:
                         log.append((s, v)))
        for i in range(4):
            led.put(i, i * 10)
            if i == 1:
                assert led.get(0) == 0      # 0 becomes most recent
        led.current_sig = 3
        led.note(3)
        led.set_cap(1)
        keys = led.keys()
        led.clear(seen=False)
        logs[name] = (log, keys, led.evictions, led.seen(3),
                      led.current_sig, len(led))
    assert logs["port"] == logs["ref"]
    assert logs["port"][0] == [(1, 10), (0, 0), (2, 20)]


def test_atomic_write_racing_threads_leave_one_complete_file(tmp_path):
    path = str(tmp_path / "blob")
    payloads = [bytes([i]) * 4096 for i in range(8)]
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def writer(p):
            try:
                for _ in range(20):
                    atomic_write(path, p)
            except OSError as e:
                errors.append(e)
        threads = [threading.Thread(target=writer, args=(p,))
                   for p in payloads]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert open(path, "rb").read() in payloads
    assert os.listdir(tmp_path) == ["blob"]


# ---- to_static through the cache --------------------------------------------

def _gpt():
    pt.seed(0)
    return pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))


def test_to_static_hit_path_makes_no_export_and_is_bit_equal(cache_on):
    model = _gpt()
    model.eval()
    pt.jit.to_static(model)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 16)).astype(np.int64))
    with torch.no_grad():
        first = model(ids)
    assert cc.exports == 1 and cc.stats()["stores"] == 1
    model.forward.release()
    with torch.no_grad():
        again = model(ids)
    assert cc.exports == 1 and cc.stats()["hits"] == 1
    assert torch.equal(first, again)
    report = cc.warm_start_report()
    assert report["exports"] == 1 and not report["warm"]
    row = cc.entries(cache_on)[0]
    assert row["kind"] == "to_static" and row["label"] == "forward"
    assert row["torch_version"] == cc.torch_version()
    # no weights in the entry: far below the parameters' bytes
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert row["bytes"] < nbytes
    hits = [e for e in monitor.events() if e["event"] == "compile_cache.hit"]
    assert len(hits) == 1 and hits[0]["bytes"] == row["bytes"]


def test_gradients_through_a_loaded_export_equal_a_fresh_exports(cache_on):
    model = _gpt()
    pt.jit.to_static(model)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 16)).astype(np.int64))
    grads = []
    for _ in range(2):           # fresh export, then the loaded one
        model.forward.release()
        model(ids).float().square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        for p in model.parameters():
            p.grad = None
    assert cc.exports == 1 and cc.stats()["hits"] == 1
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("damage", ["corrupt", "torn", "stale_torch_version",
                                    "wrong_topology"])
def test_a_bad_entry_falls_back_to_a_fresh_export(cache_on, damage):
    @pt.jit.to_static
    def f(a):
        return a * 2.0 + 1.0

    x = torch.arange(6, dtype=torch.float32)
    if damage == "torn":
        with faults.inject("compile_cache.write:torn"):
            want = f(x)
    else:
        want = f(x)
    (row,) = cc.entries(cache_on)
    key = row["key"]
    if damage == "corrupt":
        with open(os.path.join(cache_on, key + ".bin"), "r+b") as fh:
            fh.seek(100)
            fh.write(b"\x00\xff\x00")
    elif damage == "stale_torch_version":
        _doctor(cache_on, key, torch_version="0.0.1")
    elif damage == "wrong_topology":
        _doctor(cache_on, key, topology="elsewhere x8192")
    f.release()
    got = f(x)                   # never raises: a fresh export
    why = {"corrupt": "crc_mismatch", "torn": "crc_mismatch"}.get(
        damage, damage)
    assert _whys(monitor) == [why]
    assert cc.stats()["fallbacks"] == 1 and cc.exports == 2
    assert torch.equal(got, want)
    assert cc.verify(cache_on) == (1, [])      # pruned and stored anew


def test_a_function_holding_tensor_constants_is_not_persisted(cache_on):
    lin = pt.nn.Linear(3, 3)

    @pt.jit.to_static
    def g(a):
        return lin(a)

    x = torch.ones(2, 3)
    g(x)
    assert cc.stats()["export_skips"] == 1 and cc.stats()["stores"] == 0
    assert cc.entries(cache_on) == []
    skips = [e for e in monitor.events()
             if e["event"] == "compile_cache.export_skip"]
    assert "tensor constants" in skips[0]["why"]


def test_a_program_calling_a_py_func_is_not_persisted(cache_on):
    @pt.jit.to_static
    def h(v):
        return pt.static.nn.py_func(np.sin, v * 1.0,
                                    pt.InputSpec([3], "float32")) + 1.0

    h(torch.ones(3))
    assert h.program().has_op("py_func")
    assert cc.stats()["export_skips"] == 1 and cc.entries(cache_on) == []


def _make(act):
    @pt.jit.to_static
    def f(a):
        return act(a)
    return f


def test_a_function_held_in_a_closure_is_keyed(cache_on):
    """Two functions of one qualname and source that differ only in the
    activation their closure holds: two entries, each its own output."""
    x = torch.linspace(-2.0, 2.0, 8)
    F = pt.nn.functional
    relu, gelu = _make(F.relu)(x), _make(F.gelu)(x)
    assert len(cc.entries(cache_on)) == 2 and cc.stats()["hits"] == 0
    assert torch.equal(relu, torch.relu(x))
    assert torch.allclose(gelu, torch.nn.functional.gelu(x), atol=1e-6)
    assert torch.equal(_make(F.gelu)(x), gelu)     # a hit: its own entry
    assert cc.stats()["hits"] == 1


def test_layer_attributes_and_hooks_are_keyed(cache_on):
    """TransformerEncoderLayers of one seed and width that differ only in
    `activation`, or only in a forward hook: one entry each, each output
    the eager layer's (absolute 1e-5, fp32)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 16)).astype(np.float32))
    outs = []
    for act, hooked in (("relu", False), ("gelu", False), ("gelu", True)):
        pt.seed(0)
        layer = pt.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                              activation=act)
        layer.eval()
        if hooked:
            layer.linear2.register_forward_hook(lambda m, i, o: o * 2.0)
        with torch.no_grad():
            want = layer(x)
            pt.jit.to_static(layer)
            got = layer(x)
        assert (got - want).abs().max() <= 1e-5
        outs.append(got)
    assert len(cc.entries(cache_on)) == 3 and cc.stats()["hits"] == 0
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])


def test_a_value_without_a_stable_description_is_not_persisted(cache_on):
    net = pt.nn.Linear(4, 4)
    net.guard = threading.Lock()        # no description across processes
    pt.jit.to_static(net)
    with torch.no_grad():
        out = net(torch.ones(2, 4))
    assert out.shape == (2, 4)
    assert cc.stats()["export_skips"] == 1 and cc.entries(cache_on) == []
    skips = [e["why"] for e in monitor.events()
             if e["event"] == "compile_cache.export_skip"]
    assert "_Unkeyable" in skips[0] and "_thread.lock" in skips[0]


def test_an_entry_written_for_another_device_loads_onto_the_calls(cache_on):
    """The key holds device kinds, not indices: a rank on `cuda:1` loads
    the entry a rank on `cuda:0` wrote. Here the entry is rewritten as a
    program on the meta device; a CPU call loads it onto the CPU: a hit,
    no fallback, no export, the same output."""
    from paddle_tpu_torch.jit.save_load import (program_bytes,
                                                program_from_bytes)
    from torch.export.passes import move_to_device_pass
    model = _gpt()
    model.eval()
    pt.jit.to_static(model)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 16)).astype(np.int64))
    with torch.no_grad():
        want = model(ids)
    (row,) = cc.entries(cache_on)
    with open(os.path.join(cache_on, row["key"] + ".bin"), "rb") as f:
        elsewhere = move_to_device_pass(program_from_bytes(f.read()),
                                        "meta")
    assert {n.meta["val"].device.type for n in elsewhere.graph.nodes
            if n.op == "placeholder"} == {"meta"}
    assert cc.store(row["key"], program_bytes(elsewhere), kind="to_static")
    model.forward.release()
    with torch.no_grad():
        got = model(ids)
    assert cc.stats()["hits"] == 1 and cc.stats()["fallbacks"] == 0
    assert cc.exports == 1 and torch.equal(got, want)


def _module_from(tmp_path, name, body):
    path = tmp_path / f"{name}.py"
    path.write_text("def fn(a):\n    return " + body + "\n")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fn


def test_the_key_moves_with_source_flag_dtype_and_training(cache_on,
                                                           tmp_path):
    keys = set()

    def stored():
        return {r["key"] for r in cc.entries(cache_on)}

    # the same qualname, two sources
    for name, body in (("src_a", "a * 2.0"), ("src_b", "a * 3.0")):
        pt.jit.to_static(_module_from(tmp_path, name, body))(torch.ones(3))
    keys = stored()
    assert len(keys) == 2
    # src_a's source again, in another file: the same key (the key holds
    # the function's source, not its file)
    f = pt.jit.to_static(_module_from(tmp_path, "src_c", "a * 2.0"))
    f(torch.ones(3))
    assert stored() == keys and cc.stats()["hits"] == 1
    f(torch.ones(3, dtype=torch.float64))        # dtype
    assert len(stored()) == 3
    flags.set_flags({"check_nan_inf": True})     # a flag
    try:
        f.release()
        f(torch.ones(3))
    finally:
        flags.set_flags({"check_nan_inf": False})
    assert len(stored()) == 4
    net = pt.nn.Sequential(pt.nn.Linear(4, 4), pt.nn.Dropout(0.5))
    pt.jit.to_static(net)
    with torch.no_grad():
        net(torch.ones(2, 4))
        net.eval()                               # the training flag
        net(torch.ones(2, 4))
    assert len(stored()) == 6 and cc.stats()["hits"] == 1
    assert cc.exports == 6


def test_engine_stats_carry_the_cache(cache_on):
    eng = pt.serving.ServingEngine(lambda a: a + 1.0, pt.serving.EngineConfig(
        max_batch_size=2, warmup_on_start=False))
    assert eng.stats()["compile_cache"] == cc.stats()


# ---- across processes -------------------------------------------------------

def _workload(cache_dir):
    return warm_start.spawn(cache_dir, "cpu",
                            env=dict(os.environ, OMP_NUM_THREADS="2"))


def _result(proc):
    return warm_start.result(proc, timeout=300)


_digests = warm_start.digests


@pytest.fixture(scope="module")
def workload_runs(tmp_path_factory):
    """Two cold processes racing on one empty directory (lock-free
    writers, last rename wins), the directory's verify right after, then
    one warm process over it."""
    d = str(tmp_path_factory.mktemp("workload") / "cc")
    cold = [_result(p) for p in [_workload(d), _workload(d)]]
    checked = cc.verify(d, prune=False)
    crcs = [zlib.crc32(open(os.path.join(d, r["key"] + ".bin"), "rb")
                       .read()) & 0xFFFFFFFF == r["crc"]
            for r in cc.entries(d)]
    leftovers = [n for n in os.listdir(d) if n.endswith(".tmp")]
    warm = _result(_workload(d))
    return cold, (checked, crcs, leftovers), warm


def test_a_warm_process_exports_nothing_and_is_bit_identical(workload_runs):
    colds, _, warm = workload_runs
    # signatures: 2 predictor buckets, 3 GPT buckets, 1 step, the relu and
    # gelu TransformerEncoderLayers
    n = 8
    for cold in colds:
        # a racing peer may have stored a signature first: then it loads
        cc_ = cold["compile_cache"]
        assert cold["report"]["exports"] + cc_["hits"] == n
        assert cc_["stores"] == cold["report"]["exports"]
        assert cc_["export_skips"] == 0 and cc_["fallbacks"] == 0
    assert sum(c["compile_cache"]["stores"] for c in colds) >= n
    assert warm["report"]["exports"] == 0 and warm["report"]["warm"]
    assert warm["compile_cache"]["hits"] == n
    assert warm["compile_cache"]["misses"] == 0
    assert _digests(warm) == _digests(colds[0])
    assert warm["stats_compile_cache"]["hits"] == 2
    assert warm["gpt_serve"]["signatures"] == 3
    assert [p["event"] for p in warm["programs"]] == \
        ["compile_cache.hit"] * n
    assert [p["key"] for p in warm["programs"]] == \
        [p["key"] for p in colds[0]["programs"]]


def test_layers_differing_only_in_activation_load_their_own(workload_runs):
    """The workload's relu and gelu TransformerEncoderLayers, cold and
    warm: different outputs, each within 1e-5 of its eager layer's."""
    colds, _, warm = workload_runs
    for r in colds + [warm]:
        act = r["activations"]
        assert act["differ"] and act["max_abs_err"] <= 1e-5, act


def test_racing_cold_processes_leave_a_consistent_directory(workload_runs):
    cold, (checked, crcs, leftovers), _ = workload_runs
    assert _digests(cold[0]) == _digests(cold[1])
    assert checked == (8, []) and crcs == [True] * 8
    assert leftovers == []


# ---- the monitor CLI --------------------------------------------------------

def test_cache_cli_list_verify_gc(cache_on, capsys):
    from paddle_tpu_torch.monitor import _main
    key = "9" * 40
    assert cc.store(key, b"q" * 2048, kind="test")
    assert _main(["cache", cache_on]) == 0
    out = capsys.readouterr().out
    assert key in out and "test" in out and "1 entries" in out
    with open(os.path.join(cache_on, key + ".bin"), "wb") as f:
        f.write(b"garbage")
    assert _main(["cache", cache_on, "--verify"]) == 0
    assert "1 corrupt pruned" in capsys.readouterr().out
    cc.store("8" * 40, b"q" * 2048, kind="test")
    assert _main(["cache", cache_on, "--gc", "--cap-mb", "0"]) == 0
    assert "1 entries evicted" in capsys.readouterr().out
    assert cc.entries(cache_on) == []


def test_cache_cli_without_a_dir_is_an_error(capsys):
    from paddle_tpu_torch.monitor import _main
    assert _main(["cache"]) == 2
    assert "no cache dir" in capsys.readouterr().err
