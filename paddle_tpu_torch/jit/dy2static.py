"""dygraph_to_static: rewrite tensor control flow in the source for
`jit.to_static`.

Counterpart of `paddle_tpu/jit/dy2static.py` (:1-979). The AST
transformers (:285-906) are the reference's: `if` / `elif` / `else`,
`while`, `for x in range(...)`, `and` / `or` / `not`, and the lowering of
`break`, `continue` and `return` into guard flags, with one change: a
loop's `continue` flag is also bound before the loop, so `continue` works
in a tensor-predicate loop (the reference refuses it: the flag is a loop
variable unbound at entry). The
transformed code calls the runtime helpers below, which keep plain Python
semantics when their predicate is a Python value or a concrete tensor, and
lower to torch's control-flow operators when it is a tensor of an export
trace (`torch.export`, which `to_static` and `static.Program` use):

  if/elif/else      -> `static.nn.cond` (the `cond` operator)
  while             -> `static.nn.while_loop` (the `while_loop` operator)
  for x in range(n) -> `while_loop` with a trip counter, when a bound is
                       a traced tensor; Python bounds unroll
  a and b / a or b  -> `torch.logical_and` / `torch.logical_or` on traced
                       operands, Python short-circuit otherwise

A tensor is traced when it is a fake tensor or torch.export is tracing
(`_is_traced`; the reference tests for a jax `Tracer`).

Limitations, as in the reference: loop variables must be initialised
before a tensor-predicate loop, and a traced early return's value must
have one type on every path. The `cond` and `while_loop` operators add
theirs: both branches return tensors of one shape and dtype, and a loop
body keeps each carried value's shape and dtype.
"""
from __future__ import annotations

import ast
import functools
import inspect
import sys
import textwrap
import types

import torch

__all__ = ["ast_transform", "convert_ifelse", "convert_while",
           "convert_for_range", "convert_logical_and", "convert_logical_or",
           "convert_logical_not"]


class _Undef:
    """Sentinel for loop/branch vars that had no value at region entry.

    Any USE fails loudly with UnboundLocalError (python semantics for a
    possibly-unbound local), while mere propagation through untaken
    branches stays legal — the reference's RETURN_NO_VALUE pattern."""
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<undefined>"

    def _raise(self, *a, **k):
        raise UnboundLocalError(
            "dy2static: variable used before assignment (bound in only one "
            "branch/loop body); initialize it before the control flow")

    __bool__ = __int__ = __float__ = __iter__ = __len__ = _raise
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _raise
    __truediv__ = __rtruediv__ = __getitem__ = __call__ = _raise
    __lt__ = __le__ = __gt__ = __ge__ = __eq__ = __ne__ = _raise
    __hash__ = object.__hash__  # identity hash despite custom __eq__

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self._raise()


UNDEF = _Undef()


def maybe(thunk):
    """Evaluate thunk; UNDEF if the name is not bound yet."""
    try:
        return thunk()
    except (NameError, UnboundLocalError):
        return UNDEF


def _is_traced(x) -> bool:
    """Whether x is a tensor of an export trace: a fake tensor, or any
    tensor while torch.export traces."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x) or torch.compiler.is_exporting()


def _as_bool(x, like) -> torch.Tensor:
    """x as a 0-d bool tensor on `like`'s device."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(torch.bool)
    return torch.full((), bool(x), device=like.device)


# ---------------- runtime dispatch (convert_operators.py parity) ----------
def convert_ifelse(pred, true_fn, false_fn, init_vars, names):
    """Branch fns take the current values of the output names as args (a
    name that is read-then-written inside a branch must arrive as a
    parameter, not through the closure)."""
    if not _is_traced(pred):
        return true_fn(*init_vars) if pred else false_fn(*init_vars)

    def _chk(vals):
        # the friendly error while the branch is traced, before the cond
        # operator meets an UNDEF output
        seq = vals if isinstance(vals, (list, tuple)) else (vals,)
        for n, v in zip(names, seq):
            if v is UNDEF:
                raise ValueError(
                    f"dy2static: variable '{n}' is assigned in only one "
                    "branch of a tensor-predicate `if`; initialize it before "
                    "the branch")
        return vals

    from ..static.nn import _probe, cond

    try:
        return cond(pred, lambda: _chk(true_fn(*init_vars)),
                    lambda: _chk(false_fn(*init_vars)))
    except TypeError:
        if not (names and any(n.startswith("_dy2s_") for n in names)):
            raise

    # Structure mismatch on a lowered escape: a _dy2s_* var (e.g. the
    # return value) is None on the untaken side. Probe both branches for a
    # template (a run on the trace's fake tensors that records nothing)
    # and backfill the None side with a typed zero — dead by construction:
    # the flag protocol assigns a real value before it is read
    # (return_transformer.py's RETURN_NO_VALUE scheme, typed instead).
    fixes = {}
    probe_t, probe_f = _probe(lambda: (true_fn(*init_vars),
                                       false_fn(*init_vars)))
    seq_t = probe_t if isinstance(probe_t, tuple) else (probe_t,)
    seq_f = probe_f if isinstance(probe_f, tuple) else (probe_f,)
    for i, (n, a, b) in enumerate(zip(names, seq_t, seq_f)):
        if not n.startswith("_dy2s_"):
            continue
        a_none, b_none = a is None or a is UNDEF, b is None or b is UNDEF
        if a_none != b_none:
            tmpl = b if a_none else a
            if isinstance(tmpl, torch.Tensor):
                fixes[i] = (tuple(tmpl.shape), tmpl.dtype, tmpl.device)

    def _fix(vals):
        if not fixes:
            return _chk(vals)
        seq = list(vals) if isinstance(vals, tuple) else [vals]
        for i, (shape, dtype, device) in fixes.items():
            if seq[i] is None or seq[i] is UNDEF:
                seq[i] = torch.zeros(shape, dtype=dtype, device=device)
        out = tuple(seq) if isinstance(vals, tuple) else seq[0]
        return _chk(out)

    return cond(pred, lambda: _fix(true_fn(*init_vars)),
                lambda: _fix(false_fn(*init_vars)))


def convert_while(cond_fn, body_fn, loop_vars, names):
    # A static (python) predicate unrolls under trace — required when the
    # body indexes layers by the counter; only a traced predicate lowers to
    # the while_loop operator.
    def _traced_loop(vs):
        for n, v in zip(names, vs):
            if v is UNDEF:
                raise ValueError(
                    f"dy2static: loop variable '{n}' must be initialized "
                    "before a tensor-predicate `while`")
        from ..static.nn import while_loop
        return tuple(while_loop(cond_fn, body_fn, list(vs)))

    from ..static.nn import _probe
    # the first test decides the lowering; it is evaluated without being
    # recorded, so a traced loop leaves no dead test in the program
    c0 = _probe(lambda: cond_fn(*loop_vars))
    if not _is_traced(c0):
        vs = list(loop_vars)
        while True:
            c = cond_fn(*vs)
            if _is_traced(c):
                # the predicate BECAME traced mid-loop (e.g. a lowered
                # break flag fed by a tensor `if`): hand the current
                # carries to the operator for the remaining iterations
                return _traced_loop(vs)
            if not c:
                break
            out = body_fn(*vs)
            vs = list(out) if isinstance(out, (list, tuple)) else [out]
        return tuple(vs)
    return _traced_loop(loop_vars)


def convert_for_range(start, stop, step, body_fn, target_init, loop_vars,
                      names):
    """body_fn(i, *vars) -> (i, *new_vars); returns (final_target, *vars).

    Static python bounds unroll (python `for`), even over traced loop vars —
    the counter stays a python int so `self.layers[i]` indexing works; only
    traced bounds lower to the while_loop operator. The loop target keeps
    python binding semantics: last iterated value, or its prior value when
    the loop body never runs."""
    traced = [v for v in (start, stop, step) if _is_traced(v)]
    if not traced:
        vs = list(loop_vars)
        last = target_init
        for i in range(int(start), int(stop), int(step)):
            last = i
            out = body_fn(i, *vs)
            vs = list(out[1:])
        return (last,) + tuple(vs)
    for n, v in zip(names, loop_vars):
        if v is UNDEF:
            raise ValueError(
                f"dy2static: loop variable '{n}' must be initialized before "
                "a tensor-bound `for range(...)`")
    from ..static.nn import while_loop

    # trip count with python-range semantics (negative steps included):
    # n = max(0, (stop - start + step -/+ 1) // step), in the traced
    # bound's integer dtype
    like = traced[0]

    def t(v):
        return v.reshape(()).to(like.dtype) if isinstance(v, torch.Tensor) \
            else torch.full((), int(v), dtype=like.dtype, device=like.device)

    a_, b_, s_ = t(start), t(stop), t(step)
    adj = torch.where(s_ > 0, s_ - 1, s_ + 1)
    n_trips = torch.clamp(torch.div(b_ - a_ + adj, s_,
                                    rounding_mode="floor"), min=0)

    def c(k, i, *vs):
        return k < n_trips

    def b(k, i, *vs):
        out = body_fn(i, *vs)
        return (k + 1, t(out[0]) + s_) + tuple(out[1:])

    final = while_loop(c, b, [torch.zeros((), dtype=like.dtype,
                                          device=like.device), a_]
                       + list(loop_vars))
    last = a_ + (n_trips - 1) * s_
    if target_init is not UNDEF:
        try:
            last = torch.where(n_trips > 0, last, t(target_init))
        except (TypeError, ValueError, RuntimeError):
            pass  # prior value not a number: keep computed last
    return (last,) + tuple(final[2:])


def convert_logical_and(lhs_fn, rhs_fn):
    lhs = lhs_fn()
    if not _is_traced(lhs):
        return lhs and rhs_fn()          # python short-circuit preserved
    return torch.logical_and(_as_bool(lhs, lhs), _as_bool(rhs_fn(), lhs))


def convert_logical_or(lhs_fn, rhs_fn):
    lhs = lhs_fn()
    if not _is_traced(lhs):
        return lhs or rhs_fn()
    return torch.logical_or(_as_bool(lhs, lhs), _as_bool(rhs_fn(), lhs))


def convert_logical_not(x):
    if not _is_traced(x):
        return not x
    return torch.logical_not(_as_bool(x, x))


# ---------------- AST analysis ----------------
class _AssignedNames(ast.NodeVisitor):
    """Names (re)bound by statements — branch outputs / loop carries."""

    def __init__(self):
        self.names = set()

    def _target(self, t):
        if isinstance(t, ast.Name):
            if not t.id.startswith("__dy2s_"):
                self.names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e)
        elif isinstance(t, ast.Starred):
            self._target(t.value)

    def visit_Assign(self, node):
        for t in node.targets:
            self._target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._target(node.target)
        self.generic_visit(node)

    def visit_For(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_NamedExpr(self, node):  # walrus: (y := expr)
        self._target(node.target)
        self.generic_visit(node)

    def visit_withitem(self, node):
        if node.optional_vars is not None:
            self._target(node.optional_vars)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        if not node.name.startswith("__dy2s_"):
            self.names.add(node.name)  # don't descend: inner scope

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


class _HasCtrlEscape(ast.NodeVisitor):
    """Return/break/continue at this statement level (not nested defs)."""

    def __init__(self):
        self.found = False

    def visit_Return(self, node):
        self.found = True

    def visit_Break(self, node):
        self.found = True

    def visit_Continue(self, node):
        self.found = True

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _escapes(stmts):
    v = _HasCtrlEscape()
    for s in stmts:
        v.visit(s)
    return v.found


def _name(id_, ctx):
    return ast.Name(id=id_, ctx=ctx)


def _jst_call(fn_name, args):
    return ast.Call(
        func=ast.Attribute(value=_name("_jst", ast.Load()), attr=fn_name,
                           ctx=ast.Load()),
        args=args, keywords=[])


def _maybe_expr(varname):
    # _jst.maybe(lambda: var)
    return _jst_call("maybe", [ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], vararg=None, kwonlyargs=[],
                           kw_defaults=[], kwarg=None, defaults=[]),
        body=_name(varname, ast.Load()))])


def _names_tuple_store(names):
    return ast.Tuple(elts=[_name(n, ast.Store()) for n in names],
                     ctx=ast.Store())


def _names_tuple_load(names):
    return ast.Tuple(elts=[_name(n, ast.Load()) for n in names],
                     ctx=ast.Load())


def _str_tuple(names):
    return ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                     ctx=ast.Load())


def _fn_def(name, argnames, body, returns_names):
    body = list(body)
    body.append(ast.Return(value=_names_tuple_load(returns_names)))
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=a) for a in argnames],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[]),
        body=body, decorator_list=[], returns=None)


# ---------------- escape lowering (break/continue/return) ----------------

def _sets_name(stmt, name):
    """Does stmt's subtree (sans nested defs) assign `name`?"""
    for n in ast.walk(stmt):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) \
                and n is not stmt:
            continue
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return True
    return False


def _not_name(name):
    return ast.UnaryOp(op=ast.Not(), operand=_name(name, ast.Load()))


def _assign_const(name, value):
    return ast.Assign(targets=[_name(name, ast.Store())],
                      value=ast.Constant(value=value))


def _guard_tail(stmts, flag):
    """After any statement that may set `flag`, wrap the rest of the block
    in `if not flag:` — recursively, including inside nested `if` arms
    (loops and nested defs are scope boundaries handled by their own
    lowering passes)."""
    out = []
    for i, s in enumerate(stmts):
        if isinstance(s, ast.If):
            s.body = _guard_tail(s.body, flag)
            s.orelse = _guard_tail(s.orelse, flag)
        out.append(s)
        if _sets_name(s, flag) and i + 1 < len(stmts):
            rest = _guard_tail(stmts[i + 1:], flag)
            out.append(ast.If(test=_not_name(flag), body=rest, orelse=[]))
            return out
    return out


def _ends_in_return(stmts):
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))


def _always_returns(stmts):
    """Every path through stmts ends in return/raise (shallow analysis)."""
    if _ends_in_return(stmts):
        return True
    if stmts and isinstance(stmts[-1], ast.If):
        last = stmts[-1]
        return bool(last.orelse) and _always_returns(last.body) \
            and _always_returns(last.orelse)
    return False


class _TailReturnFusion(ast.NodeTransformer):
    """`if c: ...return` followed by more statements -> push the rest into
    the else branch. Turns the ubiquitous early-return pattern into a
    well-typed if/else join with no guard flags needed
    (return_transformer.py's simplest case)."""

    def _fuse_block(self, stmts):
        stmts = list(stmts)
        changed = True
        while changed:
            changed = False
            for i, s in enumerate(stmts):
                if isinstance(s, ast.If) and _always_returns(s.body) \
                        and not s.orelse and i + 1 < len(stmts):
                    s.orelse = self._fuse_block(stmts[i + 1:])
                    stmts = stmts[:i + 1]
                    changed = True
                    break
        return stmts

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        node.body = self._fuse_block(node.body)
        return node

    def visit_If(self, node):
        self.generic_visit(node)
        node.body = self._fuse_block(node.body)
        node.orelse = self._fuse_block(node.orelse)
        return node


def _strip_tail_returns(stmts, var):
    """Replace the terminal Return on every path of an always-returning
    block with an assignment to `var`."""
    last = stmts[-1]
    if isinstance(last, ast.Return):
        val = last.value if last.value is not None else ast.Constant(value=None)
        stmts[-1] = ast.Assign(targets=[_name(var, ast.Store())], value=val)
    elif isinstance(last, ast.If):
        _strip_tail_returns(last.body, var)
        _strip_tail_returns(last.orelse, var)
    return stmts


class _ReturnPushdown(ast.NodeTransformer):
    """A block ending in an If where BOTH arms always return becomes
    branch-assignments of one fresh var + a single trailing return — a
    well-typed lax.cond join with no guard flags (the structured half of
    return_transformer.py; _ReturnLowering handles the rest)."""

    def __init__(self, uid):
        self._uid = uid

    def _push_block(self, stmts):
        if not stmts:
            return stmts
        last = stmts[-1]
        if isinstance(last, ast.If) and last.orelse \
                and _always_returns(last.body) and _always_returns(last.orelse) \
                and not isinstance(last.body[-1], ast.Raise) \
                and not isinstance(last.orelse[-1], ast.Raise):
            var = f"_dy2s_ret_{self._uid()}"
            _strip_tail_returns(last.body, var)
            _strip_tail_returns(last.orelse, var)
            return stmts + [ast.Return(value=_name(var, ast.Load()))]
        return stmts

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        node.body = self._push_block(node.body)
        return node


class _ForRangeToWhile(ast.NodeTransformer):
    """for x in range(...) containing break/continue/return -> explicit
    while, so the guard-flag lowering has a test to AND flags into. The
    increment is tagged so continue-guards leave it outside."""

    def __init__(self, uid):
        self._uid = uid

    def _visit_block(self, stmts):
        out = []
        for s in stmts:
            r = self.visit(s)
            out.extend(r if isinstance(r, list) else [r])
        return out

    def generic_visit(self, node):
        for field, old in ast.iter_fields(node):
            if isinstance(old, list) and old and isinstance(old[0], ast.stmt):
                setattr(node, field, self._visit_block(old))
            elif isinstance(old, ast.AST):
                self.visit(old)
        return node

    def visit_For(self, node):
        self.generic_visit(node)
        if (not _escapes(node.body) or node.orelse
                or not isinstance(node.iter, ast.Call)
                or not isinstance(node.iter.func, ast.Name)
                or node.iter.func.id != "range"
                or not isinstance(node.target, ast.Name)):
            return node
        rargs = node.iter.args
        if len(rargs) == 1:
            start, stop, step = ast.Constant(value=0), rargs[0], \
                ast.Constant(value=1)
        elif len(rargs) == 2:
            start, stop, step = rargs[0], rargs[1], ast.Constant(value=1)
        elif len(rargs) == 3:
            start, stop, step = rargs
        else:
            return node
        i = self._uid()
        it, st, sp = f"_dy2s_it_{i}", f"_dy2s_stop_{i}", f"_dy2s_step_{i}"

        def nm(x, ctx=ast.Load):
            return _name(x, ctx())

        # ((step > 0) and (it < stop)) or ((step < 0) and (it > stop))
        test = ast.BoolOp(op=ast.Or(), values=[
            ast.BoolOp(op=ast.And(), values=[
                ast.Compare(left=nm(sp), ops=[ast.Gt()],
                            comparators=[ast.Constant(value=0)]),
                ast.Compare(left=nm(it), ops=[ast.Lt()],
                            comparators=[nm(st)])]),
            ast.BoolOp(op=ast.And(), values=[
                ast.Compare(left=nm(sp), ops=[ast.Lt()],
                            comparators=[ast.Constant(value=0)]),
                ast.Compare(left=nm(it), ops=[ast.Gt()],
                            comparators=[nm(st)])])])
        incr = ast.Assign(
            targets=[nm(it, ast.Store)],
            value=ast.BinOp(left=nm(it), op=ast.Add(), right=nm(sp)))
        incr._dy2s_incr = True
        body = [ast.Assign(targets=[_name(node.target.id, ast.Store())],
                           value=nm(it))] + node.body + [incr]
        return [
            ast.Assign(targets=[nm(it, ast.Store)], value=start),
            ast.Assign(targets=[nm(st, ast.Store)], value=stop),
            ast.Assign(targets=[nm(sp, ast.Store)], value=step),
            ast.While(test=test, body=body, orelse=[]),
        ]


class _ReturnLowering(ast.NodeTransformer):
    """Returns under control flow -> (_dy2s_ret_flag, _dy2s_ret_val) with
    guarded tails and flag-aware while tests (return_transformer.py:1)."""

    FLAG, VAL = "_dy2s_ret_flag", "_dy2s_ret_val"

    def lower(self, fdef):
        # A Return inside a surviving `for` over a NON-range iterable can't
        # be flag-lowered (no test expression to AND the flag into) — leave
        # the whole function on python-escape semantics rather than lower
        # partially and keep iterating past the "return".
        for n in ast.walk(fdef):
            if isinstance(n, ast.For):
                if any(isinstance(m, (ast.Return, ast.Break, ast.Continue))
                       for m in ast.walk(n)):
                    return fdef
        inside = False
        for n in ast.walk(fdef):
            if isinstance(n, (ast.If, ast.While, ast.For)):
                if any(isinstance(m, ast.Return) for m in ast.walk(n)):
                    inside = True
                    break
        if not inside:
            return fdef
        self._replace_block(fdef)
        fdef.body = [_assign_const(self.FLAG, False),
                     _assign_const(self.VAL, None)] + \
            self._guard_blocks(fdef).body
        fdef.body.append(ast.Return(value=_name(self.VAL, ast.Load())))
        return fdef

    # pass 1: every Return -> val/flag assignment
    def _replace_block(self, root):
        class R(ast.NodeTransformer):
            def visit_Return(self, node):
                val = node.value if node.value is not None \
                    else ast.Constant(value=None)
                return [
                    ast.Assign(targets=[_name(_ReturnLowering.VAL,
                                              ast.Store())], value=val),
                    _assign_const(_ReturnLowering.FLAG, True),
                ]

            def visit_FunctionDef(self, node):
                return node  # inner scope

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, node):
                return node

        for field, old in ast.iter_fields(root):
            if isinstance(old, list):
                new = []
                for s in old:
                    if isinstance(s, ast.stmt):
                        r = R().visit(s)
                        new.extend(r if isinstance(r, list) else [r])
                    else:
                        new.append(s)
                setattr(root, field, new)
        for child in ast.iter_child_nodes(root):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)) or child is root:
                self._replace_block(child)
        return root

    # pass 2: guard tails + while tests
    def _guard_blocks(self, root):
        for child in ast.iter_child_nodes(root):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                self._guard_blocks(child)
        for field, old in ast.iter_fields(root):
            if isinstance(old, list) and old and isinstance(old[0], ast.stmt):
                setattr(root, field, _guard_tail(old, self.FLAG))
        if isinstance(root, ast.While) and _sets_name(root, self.FLAG):
            root.test = ast.BoolOp(op=ast.And(),
                                   values=[root.test, _not_name(self.FLAG)])
        return root


class _BreakContinueLowering(ast.NodeTransformer):
    """Per-loop guard flags (break_continue_transformer.py:1). Runs after
    return lowering, so remaining Break/Continue nodes at a loop's level
    (nested loops already lowered) belong to that loop."""

    def __init__(self, uid):
        self._uid = uid

    def _visit_block(self, stmts):
        out = []
        for s in stmts:
            r = self.visit(s)
            out.extend(r if isinstance(r, list) else [r])
        return out

    def generic_visit(self, node):
        for field, old in ast.iter_fields(node):
            if isinstance(old, list) and old and isinstance(old[0], ast.stmt):
                setattr(node, field, self._visit_block(old))
            elif isinstance(old, ast.AST):
                self.visit(old)
        return node

    def visit_While(self, node):
        self.generic_visit(node)  # inner loops first
        has_b = any(isinstance(n, ast.Break) for n in ast.walk(node))
        has_c = any(isinstance(n, ast.Continue) for n in ast.walk(node))
        if not (has_b or has_c):
            return node
        i = self._uid()
        brk, cont = f"_dy2s_brk_{i}", f"_dy2s_cont_{i}"

        class R(ast.NodeTransformer):
            def visit_Break(self, n):
                return _assign_const(brk, True)

            def visit_Continue(self, n):
                return _assign_const(cont, True)

            def visit_While(self, n):
                return n  # inner loops already lowered; don't descend

            def visit_For(self, n):
                return n

            def visit_FunctionDef(self, n):
                return n

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, n):
                return n

        body = [R().visit(s) for s in node.body]
        # keep a tagged for->while increment outside the continue guards
        tail = []
        if body and getattr(body[-1], "_dy2s_incr", False):
            tail = [body[-1]]
            body = body[:-1]
        if has_c:
            body = _guard_tail(body, cont)
        if has_b:
            body = _guard_tail(body, brk)
        pre = []
        if has_c:
            body = [_assign_const(cont, False)] + body
            # also bound before the loop, so a traced loop can carry it (the
            # reference leaves it unbound there and refuses `continue` in
            # a tensor-predicate loop; pinned by a test)
            pre.append(_assign_const(cont, False))
        if has_b:
            pre.append(_assign_const(brk, False))
            node.test = ast.BoolOp(op=ast.And(),
                                   values=[node.test, _not_name(brk)])
        node.body = body + tail
        return pre + [node] if pre else node


def _lower_escapes(tree, uid):
    """break/continue/return -> structured control flow + guard flags."""
    tree = _TailReturnFusion().visit(tree)
    tree = _ReturnPushdown(uid).visit(tree)
    tree = _ForRangeToWhile(uid).visit(tree)
    fdef = tree.body[0]
    _ReturnLowering().lower(fdef)
    tree = _BreakContinueLowering(uid).visit(tree)
    return tree


class _Dy2StaticTransformer(ast.NodeTransformer):
    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    # -- if / elif / else --
    def visit_If(self, node):
        self.generic_visit(node)
        if _escapes(node.body) or _escapes(node.orelse):
            return node
        names = sorted(_assigned(node.body) | _assigned(node.orelse))
        i = self._uid()
        tname, fname = f"__dy2s_true_{i}", f"__dy2s_false_{i}"
        true_def = _fn_def(tname, names, node.body, names)
        false_def = _fn_def(fname, names, node.orelse or [ast.Pass()], names)
        init = ast.List(elts=[_maybe_expr(n) for n in names], ctx=ast.Load())
        call = _jst_call("convert_ifelse",
                         [node.test, _name(tname, ast.Load()),
                          _name(fname, ast.Load()), init, _str_tuple(names)])
        if names:
            assign = ast.Assign(targets=[_names_tuple_store(names)], value=call)
        else:
            assign = ast.Expr(value=call)
        return [true_def, false_def, assign]

    # -- while --
    def visit_While(self, node):
        self.generic_visit(node)
        if _escapes(node.body) or node.orelse:
            return node
        names = sorted(_assigned(node.body))
        if not names:
            return node
        i = self._uid()
        cname, bname = f"__dy2s_cond_{i}", f"__dy2s_body_{i}"
        cond_def = ast.FunctionDef(
            name=cname,
            args=ast.arguments(posonlyargs=[],
                               args=[ast.arg(arg=a) for a in names],
                               vararg=None, kwonlyargs=[], kw_defaults=[],
                               kwarg=None, defaults=[]),
            body=[ast.Return(value=node.test)], decorator_list=[],
            returns=None)
        body_def = _fn_def(bname, names, node.body, names)
        init = ast.List(elts=[_maybe_expr(n) for n in names], ctx=ast.Load())
        call = _jst_call("convert_while",
                         [_name(cname, ast.Load()), _name(bname, ast.Load()),
                          init, _str_tuple(names)])
        assign = ast.Assign(targets=[_names_tuple_store(names)], value=call)
        return [cond_def, body_def, assign]

    # -- for target in range(...) --
    def visit_For(self, node):
        self.generic_visit(node)
        if (_escapes(node.body) or node.orelse
                or not isinstance(node.iter, ast.Call)
                or not isinstance(node.iter.func, ast.Name)
                or node.iter.func.id != "range"
                or not isinstance(node.target, ast.Name)):
            return node
        rargs = node.iter.args
        if len(rargs) == 1:
            start, stop, step = ast.Constant(value=0), rargs[0], ast.Constant(value=1)
        elif len(rargs) == 2:
            start, stop, step = rargs[0], rargs[1], ast.Constant(value=1)
        elif len(rargs) == 3:
            start, stop, step = rargs
        else:
            return node
        tvar = node.target.id
        names = sorted(_assigned(node.body) - {tvar})
        i = self._uid()
        bname = f"__dy2s_forbody_{i}"
        body_def = _fn_def(bname, [tvar] + names, node.body, [tvar] + names)
        init = ast.List(elts=[_maybe_expr(n) for n in names], ctx=ast.Load())
        call = _jst_call("convert_for_range",
                         [start, stop, step, _name(bname, ast.Load()),
                          _maybe_expr(tvar), init, _str_tuple(names)])
        assign = ast.Assign(targets=[_names_tuple_store([tvar] + names)],
                            value=call)
        return [body_def, assign]

    # -- boolean operators --
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = "convert_logical_and" if isinstance(node.op, ast.And) \
            else "convert_logical_or"
        out = node.values[-1]
        for val in reversed(node.values[:-1]):
            out = _jst_call(fn, [
                ast.Lambda(args=ast.arguments(posonlyargs=[], args=[],
                                              vararg=None, kwonlyargs=[],
                                              kw_defaults=[], kwarg=None,
                                              defaults=[]),
                           body=val),
                ast.Lambda(args=ast.arguments(posonlyargs=[], args=[],
                                              vararg=None, kwonlyargs=[],
                                              kw_defaults=[], kwarg=None,
                                              defaults=[]),
                           body=out)])
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _jst_call("convert_logical_not", [node.operand])
        return node


def _has_ctrl_flow(tree) -> bool:
    for n in ast.walk(tree):
        if isinstance(n, (ast.If, ast.While, ast.For, ast.BoolOp)):
            return True
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            return True
    return False


def ast_transform(func):
    """Return `func` rewritten with tensor-aware control flow, or `func`
    unchanged when there is nothing to rewrite or the source is unavailable.
    Bound methods are re-bound to the same instance."""
    is_method = inspect.ismethod(func)
    fn = func.__func__ if is_method else func
    if isinstance(fn, functools.partial) or not isinstance(
            fn, types.FunctionType):
        return func
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return func
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return func
    if not _has_ctrl_flow(fdef):
        return func
    fdef.decorator_list = []  # avoid re-applying @to_static etc.
    import itertools
    counter = itertools.count(1)
    tree = _lower_escapes(tree, lambda: next(counter))
    new_tree = _Dy2StaticTransformer().visit(tree)
    ast.fix_missing_locations(new_tree)
    try:
        code = compile(new_tree, filename=f"<dy2static:{fn.__name__}>",
                       mode="exec")
    except (SyntaxError, ValueError):
        return func

    closure_vals = {}
    if fn.__closure__:
        for cname, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                closure_vals[cname] = cell.cell_contents
            except ValueError:
                return func  # empty cell (e.g. recursive def): bail out
    _self = sys.modules[__name__]

    ns = {}
    inner_name = fn.__name__

    def _sync():
        # Live view of the defining module: names defined/rebound AFTER
        # decoration (forward-referenced helpers, monkeypatches) must stay
        # visible, so refresh before each call instead of snapshotting once.
        ns.update(fn.__globals__)
        ns.update(closure_vals)
        ns["_jst"] = _self

    _sync()
    exec(code, ns)
    inner = ns[inner_name]

    def new_fn(*args, **kwargs):
        _sync()
        ns[inner_name] = inner  # recursion resolves to the rewritten fn
        return inner(*args, **kwargs)

    functools.update_wrapper(new_fn, fn)
    new_fn.__dy2static_original__ = fn
    # what the compile cache keys a rewritten function on
    new_fn.__dy2static_source__ = ast.unparse(new_tree)
    if is_method:
        return new_fn.__get__(func.__self__)
    return new_fn
