"""tpu-lint level 1: source lint for trace-destined Python functions.

Counterpart of `paddle_tpu/analysis/lint.py`. Reuses the same AST
machinery `jit/dy2static.py` parses functions with, but for ANALYSIS
instead of rewriting: scan functions destined for `@to_static` /
`TrainStep` for the hazards that only surface at runtime as a
data-dependent export error, a CUDA-graph capture that cannot hold a sync,
a silent retrace storm, or a host-pinned step. The host syncs are torch's:
`.item()`, `.cpu()`, `.numpy()`, `.tolist()`, `float/int/bool(tensor)`,
`np.asarray(tensor)` and `torch.cuda.synchronize()`; `.size()` / `.dim()`
/ `.numel()` are shape metadata, as `.shape` is.

Two scan modes per function:
  - trace-destined (forward methods, @to_static/@declarative/@*.jit
    decorated, or names passed as entry points): full rule set, with a
    light intra-function taint analysis seeding every non-self parameter
    (minus ones with scalar/str/None defaults) as a tensor;
  - --all mode (every other def): syntactic rules only (.numpy()-family
    host syncs, stdlib RNG, print) — the taint assumption "parameters are
    tensors" is only sound for trace-destined code.

Suppression: `# tpu-lint: disable=rule-a,rule-b` on the offending line, or
on a comment-only line for file-wide scope (see base.Suppressions).
"""
from __future__ import annotations

import ast
import inspect
import re
import textwrap
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from .base import Finding, Suppressions

__all__ = ["lint_source", "lint_file", "lint_callable", "lint_paths"]

# method calls that force a device->host sync on a tensor receiver
_HOST_SYNC_METHODS = {"numpy", "item", "tolist", "cpu"}
# builtins that concretize a tensor argument
_HOST_SYNC_BUILTINS = {"float", "int", "bool"}
# attribute reads that are STATIC metadata under trace (not data)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "stop_gradient", "device",
                 "requires_grad", "is_cuda"}
# method calls on a tensor that return shape metadata (static under
# export, but each distinct value forks a program, as .shape does)
_SHAPE_METHODS = {"size", "dim", "numel", "nelement", "ndimension"}
# method calls on a tensor that return host-static facts
_STATIC_METHODS = {"is_floating_point", "is_complex", "get_device",
                   "element_size", "is_contiguous"}
# builtins whose result is host-static regardless of tensor args (type
# tests and reflection — never data-dependent)
_STATIC_BUILTINS = {"isinstance", "issubclass", "hasattr", "callable",
                    "type", "id", "repr"}
# decorator name suffixes that mark a function trace-destined
_TRACED_DECORATORS = {"to_static", "declarative", "jit"}
# fused-update advisory: eager step/update functions looping per-parameter
_UPDATE_FUNC_RE = re.compile(r"step|update", re.IGNORECASE)
_PARAMISH_RE = re.compile(r"param|grad|slot|moment|velocit", re.IGNORECASE)
# call roots/attrs in a loop body that indicate per-iteration device work
_ARRAY_CALL_ROOTS = {"torch", "F", "paddle", "pt", "run_op"}
# default values that mark a parameter as non-tensor config
_SCALAR_DEFAULT_TYPES = (bool, int, float, str, bytes, type(None))
# raw socket operations that belong in the substrate (utils/net.py);
# the substrate itself and the C-API mirror (csrc/predict_capi.cpp
# callers) are exempt by path
_RAW_SOCKET_CALLS = {"recv", "sendall", "create_connection"}
_RAW_SOCKET_EXEMPT_RE = re.compile(
    r"(^|[/\\])(utils[/\\]net\.py$|csrc[/\\])")


def _dotted(node) -> Tuple[str, ...]:
    """('np', 'random', 'rand') for np.random.rand; () when not a pure
    dotted name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _is_stdlib_random(chain: Tuple[str, ...]) -> bool:
    if not chain:
        return False
    if chain[0] == "random" and len(chain) > 1:
        return True
    return len(chain) > 2 and chain[0] in ("np", "numpy") \
        and chain[1] == "random"


def _decorator_traced(dec) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    chain = _dotted(target)
    return bool(chain) and chain[-1] in _TRACED_DECORATORS


class _Taint:
    """Expression classification: (tensor-tainted, shape-derived)."""

    def __init__(self, tainted: Set[str]):
        self.tainted = tainted

    def of(self, node) -> Tuple[bool, bool]:
        t = self._of
        if isinstance(node, ast.Name):
            return node.id in self.tainted, False
        if isinstance(node, ast.Attribute):
            bt, bs = t(node.value)
            if node.attr in _STATIC_ATTRS:
                # x.shape/x.ndim of a tensor: static metadata, but flag
                # branches on it (shape-capture) — each shape forks a trace
                return False, (bt or bs) and node.attr in ("shape", "ndim")
            return bt, bs
        if isinstance(node, ast.Subscript):
            bt, bs = t(node.value)
            it, is_ = t(node.slice)
            return bt or it, bs or is_
        if isinstance(node, ast.Call):
            chain = _dotted(node.func)
            args_tb = [t(a) for a in node.args] + \
                [t(k.value) for k in node.keywords]
            any_t = any(a for a, _ in args_tb)
            any_s = any(s for _, s in args_tb)
            if len(chain) == 1 and chain[0] in _STATIC_BUILTINS:
                return False, False
            if chain == ("len",):
                at, _ = t(node.args[0]) if node.args else (False, False)
                return False, at          # len(tensor) is static metadata
            if chain and chain[-1] in _HOST_SYNC_METHODS:
                return False, False       # result is a host value
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SHAPE_METHODS:
                rt, rs = t(node.func.value)
                return False, rt or rs    # x.size(0) is static metadata
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _STATIC_METHODS:
                return False, False
            if len(chain) == 1 and chain[0] in _HOST_SYNC_BUILTINS:
                return False, any_s       # int(x.shape[0]) stays shapey
            ft, fs = t(node.func)
            return ft or any_t, fs or any_s
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False, False       # identity tests are host-static
            parts = [t(node.left)] + [t(c) for c in node.comparators]
            any_t = any(a for a, _ in parts)
            return any_t, (not any_t) and any(s for _, s in parts)
        if isinstance(node, (ast.BoolOp,)):
            parts = [t(v) for v in node.values]
            return any(a for a, _ in parts), any(s for _, s in parts)
        if isinstance(node, ast.BinOp):
            lt, ls = t(node.left)
            rt, rs = t(node.right)
            return lt or rt, ls or rs
        if isinstance(node, ast.UnaryOp):
            return t(node.operand)
        if isinstance(node, ast.IfExp):
            parts = [t(node.test), t(node.body), t(node.orelse)]
            return any(a for a, _ in parts), any(s for _, s in parts)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            parts = [t(e) for e in node.elts]
            return any(a for a, _ in parts), any(s for _, s in parts)
        if isinstance(node, ast.Starred):
            return t(node.value)
        if isinstance(node, ast.NamedExpr):
            return t(node.value)
        return False, False

    _of = of


def _seed_params(fdef) -> Set[str]:
    """Non-self parameters assumed to carry tensors — minus ones whose
    DEFAULT is a plain scalar/str/None (config knobs, not data)."""
    a = fdef.args
    params = [p.arg for p in a.posonlyargs + a.args]
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    scalarish: Set[str] = set()
    pos = a.posonlyargs + a.args
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if isinstance(d, ast.Constant) and \
                isinstance(d.value, _SCALAR_DEFAULT_TYPES):
            scalarish.add(p.arg)
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if isinstance(d, ast.Constant) and \
                isinstance(d.value, _SCALAR_DEFAULT_TYPES):
            scalarish.add(p.arg)
        else:
            params.append(p.arg)
    return {p for p in params if p not in scalarish}


def _taint_fixpoint(fdef, seeds: Set[str]) -> Set[str]:
    """Order-insensitive name-taint closure over the function body: a name
    assigned from a tainted expression becomes tainted. Sound
    over-approximation (a name reused for host values stays flagged —
    suppressions cover the rare intentional case)."""
    tainted = set(seeds)
    assigns = []
    for n in ast.walk(fdef):
        if isinstance(n, ast.Assign):
            assigns.append((n.targets, n.value))
        elif isinstance(n, ast.AugAssign):
            assigns.append(([n.target], n.value))
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            assigns.append(([n.target], n.value))
        elif isinstance(n, ast.NamedExpr):
            assigns.append(([n.target], n.value))
        elif isinstance(n, ast.For):
            assigns.append(([n.target], n.iter))
    for _ in range(len(assigns) + 1):
        changed = False
        tt = _Taint(tainted)
        for targets, value in assigns:
            vt, _ = tt.of(value)
            if not vt:
                continue
            for tgt in targets:
                for nm in ast.walk(tgt):
                    if isinstance(nm, ast.Name) and nm.id not in tainted:
                        tainted.add(nm.id)
                        changed = True
        if not changed:
            break
    return tainted


class _RegionLinter(ast.NodeVisitor):
    """Flagging pass over one traced function's body (nested defs and
    lambdas included — the traced region covers them)."""

    def __init__(self, path: str, func: str, tainted: Set[str],
                 full: bool, raw_socket_exempt: bool = False):
        self.path, self.func = path, func
        self.taint = _Taint(tainted)
        self.full = full            # taint-based rules enabled
        self.raw_socket_exempt = raw_socket_exempt
        self.findings: List[Finding] = []
        self._loop_depth = 0        # For/While bodies (lazy-sync advisory)
        # names carrying per-iteration values (loop targets + names
        # assigned from them / from array-call results inside the body) —
        # the buffer-retain advisory's lightweight --all-mode taint
        self._loop_names: Set[str] = set()

    def _add(self, rule: str, node, message: str):
        self.findings.append(Finding(
            rule, message, path=self.path, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), func=self.func))

    def _add_sync(self, node, message: str):
        """host-sync finding + lazy-sync advisory when it sits in a loop
        body: each such call waits for the device, so a per-iteration sync
        serializes the launches the stream was queueing."""
        self._add("host-sync", node, message)
        if self._loop_depth:
            self._add("lazy-sync", node,
                      "sync point inside a loop body waits for the "
                      "device every iteration — hoist it out of the hot "
                      "loop")

    # -- calls: host syncs, RNG, print --
    def visit_Call(self, node):
        chain = _dotted(node.func)
        if chain and chain[-1] in _HOST_SYNC_METHODS \
                and isinstance(node.func, ast.Attribute):
            self._add_sync(node,
                           f".{chain[-1]}() forces a device->host sync in "
                           "a traced region")
        elif chain[-2:] == ("cuda", "synchronize"):
            self._add_sync(node,
                           "torch.cuda.synchronize() waits for the device "
                           "in a traced region")
        elif _is_stdlib_random(chain):
            self._add("stdlib-random", node,
                      f"{'.'.join(chain)}() is host RNG: its value is "
                      "burned in at export time (use paddle randomness "
                      "ops, which draw on the device every call)")
        elif chain == ("print",):
            self._add("traced-print", node,
                      "print() in a traced region runs at trace time only")
        elif self.full and len(chain) == 1 \
                and chain[0] in _HOST_SYNC_BUILTINS and node.args:
            at, _ = self.taint.of(node.args[0])
            if at:
                self._add_sync(node,
                               f"{chain[0]}(tensor) reads a traced value "
                               "on the host (device->host sync)")
        elif self.full and len(chain) == 2 and chain[0] in ("np", "numpy") \
                and chain[1] in ("asarray", "array") and node.args:
            at, _ = self.taint.of(node.args[0])
            if at:
                self._add_sync(node,
                               f"{'.'.join(chain)}(tensor) pulls a traced "
                               "value to the host")
        if len(chain) > 1 and chain[-1] in _RAW_SOCKET_CALLS \
                and not self.raw_socket_exempt:
            self._add("raw-socket", node,
                      f".{chain[-1]}() is raw socket I/O outside "
                      "utils/net.py — it bypasses the unified RPC "
                      "substrate (deadlines, retries, auth/TLS, fault "
                      "sites); route through RpcChannel/RpcServer or the "
                      "net.py helpers")
        self.generic_visit(node)

    # -- control flow on tensors / shapes --
    def _check_test(self, node, test, kind: str):
        if not self.full:
            return
        tt, ts = self.taint.of(test)
        if tt:
            self._add("tensor-branch", node,
                      f"`{kind}` on a tensor value is data-dependent "
                      "Python control flow (untraceable predicate)")
        elif ts:
            self._add("shape-capture", node,
                      f"`{kind}` on a tensor shape forks a separate "
                      "compilation per input shape (retrace storm)")

    # -- per-param dispatch loops (fused-update advisory) --
    def visit_For(self, node):
        # Traced regions (full=True) unroll loops into ONE executable, so
        # the per-param-dispatch hazard only exists in eager step/update
        # functions scanned under --all.
        if not self.full and _UPDATE_FUNC_RE.search(self.func) \
                and self._iterates_params(node.iter) \
                and self._loop_dispatches(node):
            self._add("fused-update", node,
                      "per-parameter Python loop doing tensor math in an "
                      "eager step/update function — each iteration "
                      "launches its own kernels; fuse into one "
                      "multi-tensor update (torch._foreach_*)")
        # the iterable is evaluated once, at loop entry — only the body
        # (and else-clause) re-runs per iteration
        self.visit(node.target)
        self.visit(node.iter)
        added = {n.id for n in ast.walk(node.target)
                 if isinstance(n, ast.Name)} - self._loop_names
        self._loop_names |= added
        self._loop_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self._loop_depth -= 1
        self._loop_names -= added

    @staticmethod
    def _iterates_params(iter_node) -> bool:
        names = [n.id for n in ast.walk(iter_node)
                 if isinstance(n, ast.Name)]
        names += [n.attr for n in ast.walk(iter_node)
                  if isinstance(n, ast.Attribute)]
        return any(_PARAMISH_RE.search(s) for s in names)

    @staticmethod
    def _loop_dispatches(node) -> bool:
        targets = {n.id for n in ast.walk(node.target)
                   if isinstance(n, ast.Name)}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                chain = _dotted(sub.func)
                if chain and (chain[0] in _ARRAY_CALL_ROOTS
                              or chain[-1].lstrip("_").startswith("apply")):
                    return True
            elif isinstance(sub, (ast.Assign, ast.AugAssign)):
                val = sub.value
                if isinstance(val, ast.BinOp) and any(
                        isinstance(n, ast.Name) and n.id in targets
                        for n in ast.walk(val)):
                    return True
        return False

    def visit_If(self, node):
        self._check_test(node, node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_test(node, node.test, "while")
        # the test re-evaluates every iteration: count it as loop body
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_Assert(self, node):
        self._check_test(node, node.test, "assert")
        self.generic_visit(node)

    # -- buffer-retain advisory (self-attribute writes in loop bodies) --
    @staticmethod
    def _is_host_copy(value) -> bool:
        """float(x) / x.item() / np.asarray(x)-style conversions — the
        recommended buffer-retain FIX — produce host values, not buffers."""
        if not isinstance(value, ast.Call):
            return False
        chain = _dotted(value.func)
        if len(chain) == 1 and chain[0] in _HOST_SYNC_BUILTINS:
            return True
        if chain and chain[-1] in _HOST_SYNC_METHODS:
            return True
        return len(chain) == 2 and chain[0] in ("np", "numpy") \
            and chain[1] in ("asarray", "array")

    def _value_steplike(self, value) -> bool:
        """--all-mode stand-in for taint: does the expression touch a
        per-iteration value (a tracked loop name) or produce device work
        (a call rooted in torch/F/paddle/pt/run_op)?"""
        if self._is_host_copy(value):
            return False
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call):
                chain = _dotted(sub.func)
                if chain and chain[0] in _ARRAY_CALL_ROOTS:
                    return True
            elif isinstance(sub, ast.Name) and sub.id in self._loop_names:
                return True
        return False

    def _maybe_buffer_retain(self, node, targets, value):
        if not self._loop_depth:
            return
        if self.full:
            steplike, _ = self.taint.of(value)
        else:
            steplike = self._value_steplike(value)
        if not steplike:
            return
        if not self.full:
            # propagate through plain-name rebinds so `loss = step(b);
            # self.last = loss` is caught, not just the direct form
            for t in targets:
                if isinstance(t, ast.Name):
                    self._loop_names.add(t.id)
        for t in targets:
            if not isinstance(t, ast.Attribute):
                continue
            root = t
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id in ("self", "cls"):
                self._add("buffer-retain", node,
                          f"`{ast.unparse(t) if hasattr(ast, 'unparse') else t.attr}` "
                          "assigned from a per-step tensor inside a loop — "
                          "the held reference outlives the iteration and "
                          "pins device memory and its autograd graph (keep "
                          "float(...) or detached copies instead)")

    def visit_Assign(self, node):
        self._maybe_buffer_retain(node, node.targets, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._maybe_buffer_retain(node, [node.target], node.value)
        self.generic_visit(node)


def _iter_scan_units(tree) -> Iterable[Tuple[ast.AST, bool]]:
    """(function node, is_method) for every top-level and class-level def.
    Nested defs are scanned as part of their parent's region."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, False
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield sub, True


def _is_trace_destined(fdef, is_method: bool, entries) -> bool:
    if fdef.name in entries or fdef.name == "forward":
        return True
    return any(_decorator_traced(d) for d in fdef.decorator_list)


def lint_source(source: str, path: str = "<string>",
                all_functions: bool = False,
                entries: Sequence[str] = (),
                assume_traced: bool = False) -> List[Finding]:
    """Lint one module's source. Returns suppression-filtered findings."""
    try:
        tree = ast.parse(textwrap.dedent(source))
    except SyntaxError as e:
        return [Finding("parse-error", f"unparseable source: {e}", path=path,
                        line=getattr(e, "lineno", 0) or 0,
                        severity="info")]
    sup = Suppressions(source)
    findings: List[Finding] = []
    entries = set(entries)
    for fdef, is_method in _iter_scan_units(tree):
        traced = assume_traced or _is_trace_destined(fdef, is_method, entries)
        if not traced and not all_functions:
            continue
        if not traced and (fdef.name.startswith("__")
                           and fdef.name.endswith("__")):
            continue                     # dunders are never traced regions
        tainted = _taint_fixpoint(fdef, _seed_params(fdef)) if traced \
            else set()
        linter = _RegionLinter(
            path, fdef.name, tainted, full=traced,
            raw_socket_exempt=bool(_RAW_SOCKET_EXEMPT_RE.search(path)))
        for stmt in fdef.body:
            linter.visit(stmt)
        findings.extend(linter.findings)
    return sup.apply(findings)


def lint_file(path: str, all_functions: bool = False,
              entries: Sequence[str] = ()) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, path=path, all_functions=all_functions,
                       entries=entries)


def lint_paths(paths: Sequence[str], all_functions: bool = False,
               entries: Sequence[str] = ()) -> Tuple[List[Finding], int]:
    """Lint files/directories recursively. Returns (findings, n_files).
    Raises FileNotFoundError for a missing path (CLI maps it to exit 2)."""
    import os
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                if "__pycache__" in root:
                    continue
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif os.path.isfile(p):
            files.append(p)
        else:
            raise FileNotFoundError(p)
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_file(f, all_functions=all_functions,
                                  entries=entries))
    return findings, len(files)


def lint_callable(fn, path: Optional[str] = None) -> List[Finding]:
    """Lint a live function/method as a traced region (the trace-time
    FLAGS_lint hook). A dy2static rewrite is linted as its original
    source. Source unavailable -> no findings, never an error."""
    fn = inspect.unwrap(getattr(fn, "__dy2static_original__", fn))
    if inspect.ismethod(fn):
        fn = fn.__func__
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        fname = path or inspect.getsourcefile(fn) or "<callable>"
    except (OSError, TypeError):
        return []
    findings = lint_source(src, path=fname, assume_traced=True)
    # re-anchor fixture/<string> line numbers onto the real file
    try:
        base = fn.__code__.co_firstlineno - 1
        for f in findings:
            f.line += base
    except AttributeError:
        pass
    return findings
