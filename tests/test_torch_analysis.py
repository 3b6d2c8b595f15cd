"""The port's tpu-lint (`paddle_tpu_torch.analysis`) against
`paddle_tpu.analysis`.

- the source lint: a corpus of framework-neutral snippets through both
  packages' `lint_source` gives equal (rule, line) lists; torch's own host
  syncs (`.cpu()`, `torch.cuda.synchronize()`) and shape methods
  (`.size()`) get their own cases;
- the concurrency pass: the reference's concurrency sources through both
  `analyze_source` give equal findings and lock edges;
- the graph rules: one small program built in both packages from the same
  weights gives the same findings under `analyze_program`; dtype-widen,
  host-callback and the collective / stage rules against hand
  expectations (the reference's own cases need `jax.experimental.
  enable_x64`, which its jax no longer has, or fail in its suite);
- the `lint` / `concurrency` passes, the CLI (exit codes, JSON, filters),
  the trace-time FLAGS_lint hook;
- the self-gates: the port's lock graph is cycle-free with zero
  concurrency findings, and its models/, nn/, ops/ and hot-path files are
  lint-clean (the CI recipe: `python -m paddle_tpu_torch.analysis`).
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import concurrency as jconc
from paddle_tpu.analysis import graph as jgraph
from paddle_tpu.analysis.lint import lint_source as jlint_source
from paddle_tpu.static.program import Program as JProgram

import paddle_tpu_torch as pt
from paddle_tpu_torch import analysis, monitor
from paddle_tpu_torch.analysis import cli
from paddle_tpu_torch.analysis import concurrency as conc
from paddle_tpu_torch.analysis import graph
from paddle_tpu_torch.analysis.lint import lint_source
from paddle_tpu_torch.parallel.collective import CollectiveDesc

from test_analysis import (BLOCKING_SRC, CONSISTENT_SRC, INVERTED_SRC,
                           THREAD_SRC)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def rules_of(findings):
    return [f.rule for f in findings]


def lines_of(findings):
    return [(f.rule, f.line) for f in findings]


# ---- level 1: the source lint against the reference -------------------------

CORPUS = {
    "host_sync": ("""
def forward(self, x):
    y = x.numpy()
    z = float(x)
    w = x.item()
    v = x.tolist()
    return y, z, w, v
""", {}),
    "clean": ("""
def forward(self, x):
    return (x * 2 + 1).reshape([-1])
""", {}),
    "tensor_branch": ("""
def forward(self, x):
    if x > 0:
        x = x * 2
    while x.sum() < 10:
        x = x + 1
    assert x.mean() > 0
    return x
""", {}),
    "static_predicates": ("""
def forward(self, x, mask=None, use_cache=False):
    if mask is not None:
        x = x + mask
    if use_cache:
        x = x * 1
    if self.training:
        x = x * 2
    if isinstance(x, tuple):
        x = x[0]
    return x
""", {}),
    "taint": ("""
def forward(self, x):
    y = x * 2
    z = y + 1
    if z > 0:
        z = z - 1
    return z
""", {}),
    "print": ("""
def forward(self, x):
    print(x)
    return x
""", {}),
    "random": ("""
def forward(self, x):
    import random
    a = random.random()
    b = np.random.rand(3)
    c = numpy.random.randint(0, 2)
    d = paddle.rand([4])
    return x + a + b + c + d
""", {}),
    "shape_capture": ("""
def forward(self, x):
    if x.shape[0] > 8:
        x = x * 2
    while len(x) > 4:
        x = x[:-1]
    b = x.shape[0]
    for i in range(x.shape[1]):
        x = x + i
    return x.reshape([b, -1])
""", {}),
    "lazy_sync": ("""
def forward(self, x):
    total = 0.0
    for i in range(int(x.item())):
        total += x.item()
    while x.item() > 0:
        x = x - 1
    return total
""", {}),
    "default_mode": ("""
def helper(x):
    return x.numpy()

def forward(self, x):
    return x + 1
""", {}),
    "all_mode": ("""
def helper(x):
    return x.numpy()

def __repr__(self):
    return str(self.x.numpy())
""", {"all_functions": True}),
    "entries": ("""
def train_body(x):
    if x > 0:
        return x.item()
    return x
""", {"entries": ["train_body"]}),
    "decorated": ("""
@paddle.jit.to_static
def step(x):
    print(x)
    return x
""", {}),
    "nested": ("""
def forward(self, x):
    def inner(v):
        return v.numpy()
    return inner(x)
""", {}),
    "suppressions": ("""
def forward(self, x):
    y = x.numpy()  # tpu-lint: disable=host-sync
    z = x.numpy()
    return y, z
""", {}),
    "suppress_file": ("""
# tpu-lint: disable=host-sync
def forward(self, x):
    print(x)
    return x.numpy()
""", {}),
    "buffer_retain": ("""
class Loop:
    def run_epoch(self, loader):
        for batch in loader:
            loss = self.step(batch)
            self.last_loss = loss
            self.last = float(loss)
            self.curve = np.asarray(loss)

    def forward(self, x):
        for blk in range(3):
            x = x * 2
            self.h = x
        return x

    def setup(self, x):
        self.template = paddle.zeros([4, 4])
""", {"all_functions": True}),
    "fused_update": ("""
def apply_update(params, grads, lr):
    for p, g in zip(params, grads):
        p = p - lr * g
    for p in params:
        paddle.assign(p * 0.5, p)
""", {"all_functions": True}),
    "raw_socket": ("""
def pull(sock, addr):
    conn = socket.create_connection(addr)
    conn.sendall(b"x")
    return sock.recv(4)
""", {"all_functions": True}),
    "parse_error": ("def forward(self, x:\n", {}),
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_source_lint_matches_the_reference(name):
    src, kw = CORPUS[name]
    want = lines_of(jlint_source(src, "f.py", **kw))
    got = lines_of(lint_source(src, "f.py", **kw))
    assert got == want


def test_the_corpus_exercises_every_source_rule():
    seen = {f.rule for src, kw in CORPUS.values()
            for f in lint_source(src, "f.py", **kw)}
    assert seen >= {"host-sync", "tensor-branch", "traced-print",
                    "stdlib-random", "shape-capture", "lazy-sync",
                    "buffer-retain", "fused-update", "raw-socket"}


def test_torch_host_syncs_and_shape_methods():
    src = """
def forward(self, x):
    a = x.cpu()
    torch.cuda.synchronize()
    if x.size(0) > 8:
        x = x * 2
    if x.dim() == 3 and x.is_floating_point():
        x = x + 1
    if x.device.type == "cuda":
        x = x - 1
    for i in range(3):
        b = x.cpu()
    return x, a, b
"""
    assert lines_of(lint_source(src, "f.py")) == [
        ("host-sync", 3), ("host-sync", 4), ("shape-capture", 5),
        ("shape-capture", 7), ("host-sync", 12), ("lazy-sync", 12)]
    eager = "def helper(x):\n    torch.cuda.synchronize()\n"
    assert rules_of(lint_source(eager, "f.py", all_functions=True)) == [
        "host-sync"]


# ---- level 4: the concurrency pass against the reference --------------------

CONC_SOURCES = {
    "inverted": INVERTED_SRC, "consistent": CONSISTENT_SRC,
    "blocking": BLOCKING_SRC, "thread": THREAD_SRC,
    "registered": THREAD_SRC.replace("threading.Thread",
                                     "_syncwatch.Thread"),
    "suppressed": INVERTED_SRC.replace(
        "        with self.a_lock:\n                pass",
        "        with self.a_lock:  # tpu-lint: disable=lock-order\n"
        "                pass"),
    "bounded": """
import threading
import time

_LOCK = threading.Lock()

def tick(q, t, counters):
    with _LOCK:
        time.sleep(0.001)
        q.get(timeout=1.0)
        t.join(timeout=5.0)
        counters.get()
    q.get()
""",
    "rpc": """
import threading

_LOCK = threading.Lock()

def push(chan):
    with _LOCK:
        return chan.call_with_retry(b"PUSH", b"")
""",
    "acquire_release": """
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._mu = threading.Lock()

    def fwd(self):
        self._lock.acquire()
        with self._mu:
            pass
        self._lock.release()

    def rev(self):
        with self._mu:
            self._lock.acquire()
            self._lock.release()
""",
    "one_level": """
import threading
import time

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        time.sleep(1.0)
""",
}


@pytest.mark.parametrize("name", sorted(CONC_SOURCES))
def test_concurrency_matches_the_reference(name):
    src = CONC_SOURCES[name]
    want = [f.as_dict() for f in jconc.analyze_source(src, "fix.py")]
    got = [f.as_dict() for f in conc.analyze_source(src, "fix.py")]
    assert got == want
    assert conc._scan_module(src, "fix.py")[1].sites == \
        jconc._scan_module(src, "fix.py")[1].sites


def test_concurrency_findings_name_both_sites():
    (f,) = conc.analyze_source(INVERTED_SRC, "fix.py")
    assert f.rule == "lock-order" and "fix.py:" in f.message
    assert "Pool.a_lock" in f.message and "Pool.b_lock" in f.message
    assert rules_of(conc.analyze_source(BLOCKING_SRC, "fix.py")) == \
        ["blocking-under-lock"] * 4


# ---- level 2: the graph rules ----------------------------------------------

def _mlp_inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 8), (8, 16), (16, 4), (3,))]


def test_graph_rules_match_the_reference_on_one_program():
    def jfn(x, a, b, unused):
        h = paddle.matmul(x, a)
        _ = paddle.tanh(h) * 3.0                 # dead
        return paddle.matmul(paddle.nn.functional.relu(h), b)

    def tfn(x, a, b, unused):
        h = pt.matmul(x, a)
        _ = pt.tanh(h) * 3.0                     # dead
        return pt.matmul(pt.nn.functional.relu(h), b)

    arrs = _mlp_inputs()
    jprog = JProgram.from_callable(
        jfn, [jax.ShapeDtypeStruct(a.shape, jnp.float32) for a in arrs])
    tprog = pt.static.Program.from_callable(
        tfn, [torch.from_numpy(a) for a in arrs])
    want = jgraph.analyze_program(jprog)
    got = graph.analyze_program(tprog)
    assert rules_of(got) == rules_of(want) == ["dead-op", "dead-op",
                                               "unused-var"]
    assert [f.message.split("'")[1].split(".")[-1] for f in got[:2]] == \
        [f.message.split("'")[1] for f in want[:2]]      # tanh, mul
    assert got[2].message == want[2].message


def test_lenet_programs_are_graph_clean_in_both_modes():
    for train in (False, True):
        pt.seed(0)
        net = pt.models.LeNet()
        net.train() if train else net.eval()
        pt.jit.to_static(net)
        with torch.no_grad():
            net(torch.rand(2, 1, 28, 28))
        fs = [f for f in graph.analyze_program(net.forward.program())
              if f.rule != "unused-var"]
        assert fs == [], [f.format() for f in fs]


def test_dtype_widen_and_host_callback():
    def widen(x):
        return x.double() * 2.0

    def wide_in(x):
        return x * 2.0

    fs = graph.analyze_program(pt.static.Program.from_callable(
        widen, [torch.ones(3)]))
    assert rules_of(fs) == ["dtype-widen"] and "float64" in fs[0].message
    assert graph.analyze_program(pt.static.Program.from_callable(
        wide_in, [torch.ones(3, dtype=torch.float64)])) == []

    @pt.jit.to_static
    def f(v):
        return pt.static.nn.py_func(np.sin, v * 1.0,
                                    pt.InputSpec([3], "float32")) + 1.0

    f(torch.ones(3))
    fs = graph.analyze_program(f.program())
    assert rules_of(fs) == ["host-callback"]
    assert "paddle_tpu_torch.py_func" in fs[0].message


def _desc(op, shape=(4,), axis="dp"):
    return CollectiveDesc(op, axis, shape, torch.float32)


def test_collective_order():
    a = [_desc("all_reduce"), _desc("all_gather", (8,)),
         _desc("reduce_scatter")]
    assert graph.verify_collective_order({"r0": a, "r1": list(a)}) == []
    fs = graph.verify_collective_order(
        {"r0": a, "r1": [a[0], _desc("all_gather", (4,)), a[2]]})
    assert rules_of(fs) == ["collective-order"]
    assert "#1" in fs[0].message and fs[0].func == "r1"
    fs = graph.verify_collective_order({"stage0": a, "stage1": a[:2]})
    assert rules_of(fs) == ["collective-order"]
    assert "issues 2 collectives" in fs[0].message and "#2" in fs[0].message
    assert graph.verify_collective_order({"only": a}) == []

    def step(x):
        pt.distributed.all_reduce(x)
        return x

    seq = graph.collective_sequence(step, torch.ones(4))
    assert [d.op for d in seq] == ["psum"] and seq[0].shape == (4,)

    class Regime:
        def collective_signature(self, *batch):
            return list(a)

    assert graph.collective_sequence(Regime(), "batch") == a
    assert graph.verify_collective_order(
        {"r0": Regime(), "r1": a[:1]}, specs={"r0": ("b",)})[0].rule == \
        "collective-order"
    assert analysis.CollectiveDesc is CollectiveDesc


def test_stage_rules():
    stages = [pt.nn.Linear(8, 16), pt.nn.Linear(16, 4)]
    assert graph.verify_stage_chain(stages, torch.ones(2, 8)) == []
    fs = graph.verify_stage_chain([stages[0], pt.nn.Linear(8, 4)],
                                  torch.ones(2, 8))
    assert rules_of(fs) == ["stage-graph"] and "stage 1" in fs[0].message
    for args in (({0: 0, 2: 1}, 3), ({0: 0, 1: 1}, 2, 0, [0, 1]),
                 ({0: 0, 1: 1}, 2, 1, [1]), ({0: 0, 5: 1}, 2)):
        assert [f.as_dict() for f in graph.verify_stage_assignment(*args)] \
            == [f.as_dict() for f in jgraph.verify_stage_assignment(*args)]


# ---- the passes, the CLI, the trace-time hook --------------------------------

def test_lint_and_concurrency_passes():
    def f(x, unused):
        _ = torch.exp(x)
        return torch.tanh(x)

    prog = pt.static.Program.from_callable(f, [torch.ones(4), torch.ones(2)])
    assert {"lint", "concurrency"} <= set(pt.static.passes.list_passes())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = prog.apply_pass("lint")
    assert rules_of(out.lint_findings) == ["dead-op", "unused-var"]
    assert sum("tpu-lint[pass]" in str(m.message) for m in w) == 2
    with pytest.raises(ValueError, match="lint pass: 2 finding"):
        prog.apply_pass("lint", fail_on="warning")
    assert prog.apply_pass("lint", fail_on="error") is prog
    assert prog.apply_pass("concurrency",
                           fail_on="error").concurrency_findings == []


def test_concurrency_pass_reads_the_functions_module(tmp_path):
    path = tmp_path / "spawner.py"
    path.write_text(THREAD_SRC + "\n\ndef body(x):\n    return x * 2\n")
    ns = {}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    prog = pt.static.Program.from_callable(ns["body"], [torch.ones(2)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = prog.apply_pass("concurrency")
    assert rules_of(out.concurrency_findings) == ["unregistered-thread"]
    with pytest.raises(ValueError, match="concurrency pass"):
        prog.apply_pass("concurrency", fail_on="warning")


def test_cli(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def forward(self, x):\n    return x.item()\n")
    clean = tmp_path / "clean.py"
    clean.write_text("def forward(self, x):\n    print(x)\n    return x\n")
    pool = tmp_path / "pool.py"
    pool.write_text(INVERTED_SRC)
    assert cli.main([str(bad)]) == 1
    assert "host-sync" in capsys.readouterr().out
    assert cli.main([str(clean)]) == 0
    assert cli.main([str(clean), "--fail-on", "warning"]) == 1
    assert cli.main([str(bad), "--fail-on", "never"]) == 0
    assert cli.main([str(tmp_path / "missing.py")]) == 2
    capsys.readouterr()
    assert cli.main([str(tmp_path), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["files"] == 3 and doc["counts"] == {
        "error": 2, "warning": 1, "info": 0}
    assert sorted(f["rule"] for f in doc["findings"]) == [
        "host-sync", "lock-order", "traced-print"]
    assert cli.main([str(pool), "--no-concurrency"]) == 0
    assert cli.main([str(tmp_path), "--rules", "traced-print"]) == 0
    assert cli.main([str(tmp_path), "--disable", "host-sync,lock-order"]) \
        == 0
    helper = tmp_path / "helper.py"
    helper.write_text("def body(x):\n    return x.numpy()\n")
    assert cli.main([str(helper)]) == 0
    assert cli.main([str(helper), "--all"]) == 1
    assert cli.main([str(helper), "--entry", "body"]) == 1
    capsys.readouterr()
    assert cli.main(["--list-rules", "x"]) == 0
    out = capsys.readouterr().out
    assert "lock-order" in out and "host-callback" in out


@pytest.fixture
def linted():
    monitor.reset()
    analysis._reset_trace_cache()
    pt.set_flags({"FLAGS_lint": True, "FLAGS_monitor": True})
    try:
        yield
    finally:
        pt.set_flags({"FLAGS_lint": False, "FLAGS_monitor": False})
        analysis._reset_trace_cache()
        monitor.reset()


def _load(tmp_path, name, src):
    path = tmp_path / f"{name}.py"
    path.write_text(src)
    ns = {"pt": pt}
    exec(compile(src, str(path), "exec"), ns)
    return ns


HAZARD = """
def fn(x):
    print(x)
    return x * 2.0


class Net(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = pt.nn.Linear(4, 2)

    def forward(self, x):
        print(x)
        return self.fc(x)
"""


def test_to_static_lints_once_and_counts(tmp_path, linted):
    ns = _load(tmp_path, "hazard", HAZARD)
    f = pt.jit.to_static(ns["fn"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        f(torch.ones(3))
        f(torch.ones(5))          # a second signature: linted already
        f(torch.ones(3))
    msgs = [str(m.message) for m in w if "tpu-lint" in str(m.message)]
    assert len(msgs) == 1 and "tpu-lint[to_static]" in msgs[0]
    assert "traced-print" in msgs[0] and "hazard.py:3" in msgs[0]
    counters = monitor.snapshot()["counters"]
    assert counters["lint.findings"] == 1 and counters["lint.files"] == 1


def test_train_steps_lint_at_construction(tmp_path, linted):
    ns = _load(tmp_path, "hazard2", HAZARD)
    net = ns["Net"]()
    opt = pt.optimizer.SGD(parameters=net.parameters(), learning_rate=0.1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pt.jit.TrainStep(net, pt.nn.MSELoss(), opt)
        with pytest.raises(ValueError, match="mesh"):
            pt.parallel.SPMDTrainStep(ns["Net"](), pt.nn.MSELoss(), opt)
    msgs = [str(m.message) for m in w if "tpu-lint" in str(m.message)]
    assert len(msgs) == 1 and "tpu-lint[train_step]" in msgs[0]
    analysis._reset_trace_cache()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with pytest.raises(ValueError, match="mesh"):
            pt.parallel.SPMDTrainStep(ns["Net"](), pt.nn.MSELoss(), opt)
    assert ["tpu-lint[spmd_train_step]" in str(m.message) for m in w
            if "tpu-lint" in str(m.message)] == [True]


def test_disabled_hook_lints_nothing(tmp_path):
    monitor.reset()
    analysis._reset_trace_cache()
    assert not analysis.enabled()
    ns = _load(tmp_path, "hazard3", HAZARD)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pt.jit.to_static(ns["fn"])(torch.ones(3))
    assert not [m for m in w if "tpu-lint" in str(m.message)]
    assert "lint.findings" not in monitor.snapshot()["counters"]


# ---- the self-gates ---------------------------------------------------------

def test_the_port_lock_graph_is_cycle_free_and_concurrency_clean():
    findings, n_files, sites = conc.analyze_paths([PKG])
    assert n_files > 150
    assert findings == [], "\n".join(f.format() for f in findings)
    assert conc.find_cycles(sites) == []


HOT_PATHS = ["models", "nn", "ops", "io/prefetch.py", "parallel/reducer.py",
             "serving/engine.py", "serving/llm.py", "guard/supervisor.py",
             "core/executable.py", "core/compile_cache.py", "obs/trace.py",
             "obs/slo.py", "jit/to_static.py"]


def test_the_port_models_nn_ops_and_hot_paths_are_lint_clean():
    findings, n_files = analysis.lint_paths(
        [os.path.join(PKG, p) for p in HOT_PATHS], all_functions=True)
    assert n_files > 50
    assert findings == [], "\n".join(f.format() for f in findings)
    assert cli.main([os.path.join(PKG, p) for p in ("models", "nn", "ops")]
                    + ["--json"]) == 0
