"""tpu-lint core: findings, the rule registry, and suppression parsing.

Counterpart of `paddle_tpu/analysis/base.py`, with the same rule ids. The
hazards worth detecting are the ones that break the port's static path
(source -> dy2static -> `torch.export` program -> CUDA-graph replay): host
syncs, retrace storms, collective deadlocks. All of them are visible
STATICALLY — in the Python AST, the exported FX graph, or a rank's traced
collective sequence — so they are reported before a card ever hangs.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

__all__ = ["Severity", "Rule", "RULES", "Finding", "Suppressions",
           "severity_at_least"]


class Severity:
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"

    _ORDER = {"info": 0, "warning": 1, "error": 2}


def severity_at_least(sev: str, threshold: str) -> bool:
    return Severity._ORDER[sev] >= Severity._ORDER[threshold]


class Rule:
    __slots__ = ("id", "severity", "doc")

    def __init__(self, id_: str, severity: str, doc: str):
        self.id, self.severity, self.doc = id_, severity, doc

    def __repr__(self):
        return f"Rule({self.id}, {self.severity})"


# The rule table (README "Static analysis" section mirrors this).
RULES: Dict[str, Rule] = {r.id: r for r in [
    # -- source rules (analysis/lint.py, AST level) --
    Rule("host-sync", Severity.ERROR,
         ".item()/.cpu()/.numpy()/.tolist()/float()/int()/bool() on a "
         "tensor, or torch.cuda.synchronize(), in an exported region — a "
         "device->host sync; under torch.export it raises a data-dependent "
         "error or bakes the value into the program, and it cannot sit in "
         "a CUDA-graph capture"),
    Rule("tensor-branch", Severity.ERROR,
         "Python `if`/`while`/`assert` on a tensor value — data-dependent "
         "control flow cannot be exported as written (let dy2static lower "
         "it to static.nn.cond / while_loop, or keep the predicate "
         "host-static)"),
    Rule("traced-print", Severity.WARNING,
         "print() inside an exported region — runs once at export time, "
         "never per replay; use monitor counters"),
    Rule("stdlib-random", Severity.ERROR,
         "stdlib random.* / numpy.random.* inside an exported region — the "
         "value is burned in at export time (use paddle randomness ops, "
         "which draw from the device generator on every replay)"),
    Rule("shape-capture", Severity.WARNING,
         "branching on a tensor's .shape/len() — each distinct input shape "
         "silently exports a different program (a per-shape retrace fork)"),
    Rule("fused-update", Severity.INFO,
         "advisory (--all scans): a per-parameter Python loop doing tensor "
         "math inside an eager step/update function launches kernels per "
         "parameter — fuse it into one multi-tensor update "
         "(torch._foreach_*, as optimizer.Optimizer does); loops inside "
         "exported regions are captured whole and are exempt"),
    Rule("lazy-sync", Severity.INFO,
         "advisory: a host-sync call (.item()/.cpu()/.numpy()/.tolist()/"
         "float()/int()/bool()) inside a loop body — every iteration waits "
         "for the device, serializing launches the stream was queueing; "
         "hoist the sync out of the hot loop (or accumulate on the device "
         "and sync once after it)"),
    Rule("raw-socket", Severity.WARNING,
         "socket.recv/sendall/create_connection outside utils/net.py — "
         "raw wire I/O bypasses the unified RPC substrate (deadlines, "
         "retries, auth/TLS, fault sites, wire-health counters); route "
         "through RpcChannel/RpcServer or the net.py helpers"),
    Rule("buffer-retain", Severity.INFO,
         "advisory: a self./cls. attribute assigned from a per-step tensor "
         "inside a loop body — the held reference outlives the step and "
         "pins device memory (and its autograd graph) until the next "
         "overwrite (the creeping 'other' bytes a mem census shows); keep "
         "a host scalar (float(loss)) or a detached copy instead"),
    # -- graph rules (analysis/graph.py, exported FX graph level) --
    Rule("dead-op", Severity.WARNING,
         "op whose results are never used by any program output — wasted "
         "export and replay time and a likely logic error"),
    Rule("unused-var", Severity.WARNING,
         "program input consumed by no live op — dead argument traffic"),
    Rule("dtype-widen", Severity.ERROR,
         "implicit f32/bf16 -> f64 (or c64 -> c128) widening — float64 runs "
         "at 1/15 of the card's f32 rate and off the tensor cores"),
    Rule("host-callback", Severity.WARNING,
         "host callback op inside the exported program (py_func, a "
         "scalar read) — a device->host round trip on every call, and no "
         "CUDA graph can hold it"),
    Rule("collective-order", Severity.ERROR,
         "ranks/stages issue diverging static collective sequences — the "
         "world deadlocks at the first mismatched collective at runtime"),
    Rule("stage-graph", Severity.ERROR,
         "pipeline stage wiring broken: a stage's output cannot feed the "
         "next stage, or a stage has no owner — the pipeline hangs"),
    # -- concurrency rules (analysis/concurrency.py, whole-package AST) --
    Rule("lock-order", Severity.ERROR,
         "two code paths acquire the same pair of locks in opposite "
         "orders — two threads running them concurrently deadlock; the "
         "finding names both sites of the cycle"),
    Rule("blocking-under-lock", Severity.ERROR,
         "unbounded blocking (socket recv/accept, queue.get/join/wait "
         "with no timeout, long time.sleep, RPC call_with_retry) inside "
         "a held-lock region — every contending thread stalls for the "
         "full blocking duration; move it out or bound it"),
    Rule("unregistered-thread", Severity.WARNING,
         "raw threading.Thread() outside the syncwatch ThreadRegistry — "
         "invisible to the leak fixtures and the `monitor threads` "
         "table; spawn via syncwatch.Thread(..., owner=__name__)"),
]}


class Finding:
    """One diagnostic. `path`/`line` anchor it; `func` names the traced
    function (or program/rank) it was found in."""

    __slots__ = ("rule", "severity", "path", "line", "col", "message", "func")

    def __init__(self, rule: str, message: str, path: str = "<program>",
                 line: int = 0, col: int = 0, func: str = "",
                 severity: Optional[str] = None):
        self.rule = rule
        self.severity = severity or RULES[rule].severity
        self.path, self.line, self.col = path, line, col
        self.message = message
        self.func = func

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        where = f" (in {self.func})" if self.func else ""
        return f"{loc}: {self.severity}: {self.message}{where} [{self.rule}]"

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line, "col": self.col,
                "message": self.message, "func": self.func}

    def __repr__(self):
        return f"Finding({self.format()})"


# `# tpu-lint: disable=rule-a,rule-b` — on a code line it silences those
# rules for that line; on a comment-only line it silences them for the
# whole file. `disable=all` silences everything.
_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable=([\w,\-]+)")


class Suppressions:
    """Parsed suppression comments for one source file."""

    def __init__(self, source: str):
        self.by_line: Dict[int, set] = {}
        self.file_wide: set = set()
        for i, line in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            if line.strip().startswith("#"):
                self.file_wide |= rules
            else:
                self.by_line.setdefault(i, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if "all" in self.file_wide or rule in self.file_wide:
            return True
        here = self.by_line.get(line, ())
        return "all" in here or rule in here

    def apply(self, findings: List[Finding]) -> List[Finding]:
        return [f for f in findings
                if not self.suppressed(f.rule, f.line)]
