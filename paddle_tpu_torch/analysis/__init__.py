"""paddle_tpu_torch.analysis — tpu-lint, the static-analysis plane.

Counterpart of `paddle_tpu/analysis/`. Four levels (trace safety, graph
hygiene, collective-deadlock detection, thread/lock concurrency), all
runnable offline and at export time:

  1. source lint (`analysis.lint`): AST scan of trace-destined functions
     for host syncs (torch's: `.item()`, `.cpu()`, `.numpy()`,
     `.tolist()`, `float/int/bool(t)`, `torch.cuda.synchronize()`),
     tensor-dependent Python control flow, traced print, stdlib RNG, and
     shape-capture retrace forks;
  2. graph analysis (`analysis.graph`): walks of a Program's exported FX
     graph for dead ops, unused inputs, implicit f64 widenings, host
     callbacks, and collective-ordering verification across ranks /
     pipeline stages over their traced `CollectiveDesc` sequences;
  3. concurrency analysis (`analysis.concurrency`): whole-package AST
     pass building the static lock-acquisition graph — `lock-order`
     inversions, `blocking-under-lock`, `unregistered-thread` (the
     static half of `utils/syncwatch.py`, which observes the same graph
     live under `FLAGS_sync_watch`);
  4. command line: `python -m paddle_tpu_torch.analysis <paths>` (severities,
     `# tpu-lint: disable=RULE` suppressions, `--json`), the same rules as
     registered passes (`prog.apply_pass('lint')`, `'concurrency'`,
     `'dead_op_elim'` in `static/passes.py`), and a trace-time hook behind
     `FLAGS_lint` at to_static's novel-signature export and at
     `TrainStep` / `SPMDTrainStep` construction (warnings +
     `lint.findings`/`lint.files` monitor counters; the disabled path is
     one module-attribute check, like `faults`/`monitor`).
"""
from __future__ import annotations

from typing import List

from ..core import flags as _flags
from .base import Finding, RULES, Severity  # noqa: F401
from .lint import (  # noqa: F401
    lint_callable, lint_file, lint_paths, lint_source)

__all__ = [
    "Finding", "RULES", "Severity",
    "lint_source", "lint_file", "lint_paths", "lint_callable",
    "analyze_graph", "analyze_program",
    "collective_sequence", "verify_collective_order",
    "verify_stage_chain", "verify_stage_assignment",
    "analyze_concurrency", "analyze_concurrency_paths", "lock_graph",
    "enabled", "enable", "disable", "lint_traced", "main",
]

# Hot-path gate (faults/monitor pattern): the jit trace hooks read this
# module attribute; `watch_flag` keeps it in sync with set_flags.
_ENABLED: bool = bool(_flags.flag("lint"))


def _on_flag(value) -> None:
    global _ENABLED
    _ENABLED = bool(value)


_flags.watch_flag("lint", _on_flag)


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    _flags.set_flags({"lint": True})


def disable() -> None:
    _flags.set_flags({"lint": False})


# level 2 (torch.fx) lives in .graph; re-export lazily so importing the
# linter (pure stdlib ast) never pulls the export machinery
def __getattr__(name):
    if name in ("analyze_graph", "analyze_program", "collective_sequence",
                "verify_collective_order", "verify_stage_chain",
                "verify_stage_assignment", "CollectiveDesc",
                "iter_nodes", "live_node_mask"):
        from . import graph as _graph
        return getattr(_graph, name)
    # level 4 (concurrency) stays lazy like level 2: importing the core
    # linter must not grow
    if name in ("analyze_concurrency", "analyze_concurrency_paths",
                "lock_graph", "find_cycles"):
        from . import concurrency as _concurrency
        return {"analyze_concurrency": _concurrency.analyze_source,
                "analyze_concurrency_paths": _concurrency.analyze_paths,
                "lock_graph": _concurrency.lock_graph,
                "find_cycles": _concurrency.find_cycles}[name]
    if name == "main":
        from .cli import main as _main
        return _main
    raise AttributeError(name)


# ---- trace-time hook (FLAGS_lint) ------------------------------------------

# functions already linted this process (code object identity): tracing the
# same capture for a new shape signature must not re-lint or re-warn
_LINTED_KEYS = set()
_LINTED_FILES = set()


def lint_traced(fn, where: str = "trace") -> List[Finding]:
    """Lint `fn` as a traced region, once per function per process. Called
    from `jit/to_static.py` (a novel signature's export),
    `jit/train_step.py` and `parallel/spmd.py` (construction) when
    `FLAGS_lint` is on. Emits a warning per finding and bumps the
    `lint.findings` / `lint.files` monitor counters."""
    import warnings

    target = getattr(fn, "__func__", fn)
    code = getattr(target, "__code__", None)
    key = code if code is not None else id(target)
    if key in _LINTED_KEYS:
        return []
    _LINTED_KEYS.add(key)
    findings = lint_callable(fn)
    from .. import monitor as _monitor
    src_file = getattr(code, "co_filename", None)
    if src_file is not None and src_file not in _LINTED_FILES:
        _LINTED_FILES.add(src_file)
        _monitor.count("lint.files")
    if findings:
        _monitor.count("lint.findings", len(findings))
        for f in findings:
            warnings.warn(f"tpu-lint[{where}]: {f.format()}", stacklevel=3)
    return findings


def _reset_trace_cache() -> None:
    """Test hook: forget which functions were already linted."""
    _LINTED_KEYS.clear()
    _LINTED_FILES.clear()
