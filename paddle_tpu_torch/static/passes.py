"""User-extensible program passes.

Counterpart of `paddle_tpu/static/passes.py` (:1-323), the IR pass
framework's role (`framework/ir/pass.h`, `PassRegistry`). Two kinds of
pass, as in the reference:
  - function passes, `Callable[[fn], fn]` (the default): `remat` (the
    whole program under non-reentrant `torch.utils.checkpoint`: backward
    recomputes instead of saving residuals) and `bf16_io` (floating
    inputs cast to bf16 before the body), carried over;
  - program passes (marked `_program_pass = True`), given the Program:
    `dead_op_elim` (FX dead-code elimination over the exported graph and
    its subgraphs; the reference's liveness walk over the jaxpr) and the
    op-rewrite passes of `make_op_rewrite_pass`, which swap operators by
    name in the exported graph (the fuse-pass role). A rewrite reaches
    into the branches of `cond`, as the reference's reaches nested jits;
    a `while_loop` body is left as it is, with a warning, as the
    reference's `_warn_if_skipped_region` (:100) does for its loop bodies.
  - the analysis-only program passes `lint` and `concurrency` (:265,
    :294): tpu-lint's graph rules over the exported graph plus its source
    lint of the Program's function, and its concurrency rules over the
    module that defines the function. They return the Program with the
    findings attached (`.lint_findings`, `.concurrency_findings`);
    `fail_on=` raises at that severity.
`Program.apply_pass(name)` returns a new Program; its `ops()` show the
rewritten graph.
"""
from __future__ import annotations

import copy
import inspect
import warnings
from typing import Callable, Dict

import torch

__all__ = ["register_pass", "get_pass", "list_passes", "apply_pass",
           "make_op_rewrite_pass"]

_REGISTRY: Dict[str, Callable] = {}


def register_pass(name: str, pass_fn: Callable = None):
    """Register a function-to-function transform under `name`.

    Usable directly or as a decorator::

        @register_pass("my_pass")
        def my_pass(fn):
            def wrapped(*args):
                return fn(*args)
            return wrapped
    """
    if callable(name):
        raise TypeError(
            "register_pass needs a name: use @register_pass(\"my_pass\")")
    if pass_fn is None:
        def deco(f):
            _REGISTRY[name] = f
            return f
        return deco
    _REGISTRY[name] = pass_fn
    return pass_fn


def get_pass(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown pass {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_passes():
    return sorted(_REGISTRY)


def apply_pass(program, name: str, **options):
    """A NEW Program with the named pass applied: a function pass maps the
    Program's function, a program pass (`_program_pass = True`) maps the
    Program itself."""
    from .program import Program
    p = get_pass(name)
    if getattr(p, "_program_pass", False):
        return p(program, **options)
    new_fn = p(program._fn, **options)
    return Program(new_fn, program._arg_specs, devices=program._devices,
                   name=f"{program.name}+{name}")


def _program_pass(fn):
    fn._program_pass = True
    return fn


def _from_graph(program, ep, suffix):
    """A Program that runs the exported program `ep` (a rewrite of
    `program`'s graph): its function is `ep`'s module, so later passes
    trace the rewritten graph."""
    from .program import Program
    module = ep.module()
    if program._bound is not None:
        n, bound = program._bound

        def fn(*args):
            return module(*args[:n], *bound, *args[n:])
    else:
        fn = module
    return Program(fn, program._arg_specs, exported=ep,
                   devices=program._devices, bound=program._bound,
                   name=f"{program.name}+{suffix}")


# ---- the op-rewrite (fuse-pass) mechanism ----

def _call_impl(impl, args, kwargs):
    """Call a rewrite impl with the node's keyword arguments its signature
    takes (a **kwargs impl gets them all)."""
    try:
        sig = inspect.signature(impl)
    except (TypeError, ValueError):
        return impl(*args)
    if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
        return impl(*args, **kwargs)
    keep = {k: v for k, v in kwargs.items() if k in sig.parameters}
    return impl(*args, **keep)


_warned_regions = set()


def _matches(node, rewrites):
    """The rewrite key naming the node's operator, if any: `aten.tanh`,
    or its short form `tanh`."""
    from .program import op_name
    if node.op != "call_function":
        return None
    name = op_name(node.target)
    if name is None:
        return None
    for key in (name, name.split(".", 1)[-1]):
        if key in rewrites:
            return key
    return None


def _rewrite_graph(gm, rewrites):
    """Retarget the matching nodes of gm and of its `cond` branches; warn
    (once per pair) for a match inside a `while_loop` body."""
    from .program import op_name
    loop_mods = set()
    for node in gm.graph.nodes:
        if node.op == "call_function" and \
                op_name(node.target) == "higher_order.while_loop":
            for arg in node.args[:2]:
                if isinstance(arg, torch.fx.Node) and arg.op == "get_attr":
                    loop_mods.add(arg.target)
    for node in gm.graph.nodes:
        key = _matches(node, rewrites)
        if key is not None:
            impl = rewrites[key]
            node.target = (lambda impl: lambda *a, **k:
                           _call_impl(impl, a, k))(impl)
    gm.recompile()
    for name, sub in gm.named_children():
        if not isinstance(sub, torch.fx.GraphModule):
            continue
        if name in loop_mods:
            for node in sub.graph.nodes:
                key = _matches(node, rewrites)
                if key is not None and ("while_loop", key) not in \
                        _warned_regions:
                    _warned_regions.add(("while_loop", key))
                    warnings.warn(
                        f"op-rewrite pass: '{key}' inside a 'while_loop' "
                        "body is NOT rewritten (loop regions are executed "
                        "as-is)")
        else:
            _rewrite_graph(sub, rewrites)


def make_op_rewrite_pass(rewrites: Dict[str, Callable]) -> Callable:
    """A pass substituting operators by name.

    `rewrites` maps operator names (those of `Program.op_histogram()`,
    `aten.tanh`, or their short form `tanh`) to replacements called as
    `impl(*args, **kwargs)` with the node's arguments. Applied to a
    Program it rewrites the exported graph; applied to a function it
    gives a function that exports `fn` at its first (concrete) arguments
    and runs the rewritten graph."""

    def rewrite(ep):
        ep = copy.deepcopy(ep)
        _rewrite_graph(ep.graph_module, rewrites)
        return ep

    def pass_fn(target):
        from .program import Program
        if isinstance(target, Program):
            return _from_graph(target, rewrite(target.exported()), "rewrite")
        fn, cache = target, {}

        def rewritten(*args):
            key = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
            module = cache.get(key)
            if module is None:
                from ..jit.save_load import _Program, export_program
                ep = export_program(_Program(None, [], [], fn=fn), args)
                module = cache[key] = rewrite(ep).module()
            return module(*args)
        return rewritten

    pass_fn._program_pass = True
    return pass_fn


# ---- builtin passes (reference pass-library counterparts) ----

@register_pass("remat")
def _remat_pass(fn):
    """Whole-program rematerialization (`memory_optimize_pass` role):
    backward recomputes instead of saving residuals."""
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


@register_pass("bf16_io")
def _bf16_io_pass(fn):
    """Cast floating inputs to bf16 before the body (fuse_bf16 role)."""
    def wrapped(*args):
        return fn(*[a.to(torch.bfloat16)
                    if isinstance(a, torch.Tensor) and a.is_floating_point()
                    else a for a in args])
    return wrapped


@register_pass("dead_op_elim")
@_program_pass
def _dead_op_elim_pass(program):
    """Dead-op elimination (the reference's `identity_op_clean` / DCE pass
    family): the ops whose results nothing reads leave the graph, so
    introspection and every later pass stop paying for them. Random and
    in-place ops stay."""
    from .program import eliminate_dead_code
    return _from_graph(program, eliminate_dead_code(program.exported()),
                       "dead_op_elim")


def _gate(findings, kind, fail_on):
    """Warn each finding; with `fail_on` set, raise on the findings at or
    above that severity (the export-time gate)."""
    from ..analysis.base import severity_at_least
    for f in findings:
        warnings.warn(f"tpu-lint[pass]: {f.format()}")
    if fail_on is not None:
        bad = [f for f in findings if severity_at_least(f.severity, fail_on)]
        if bad:
            raise ValueError(
                f"{kind} pass: {len(bad)} finding(s) at/above {fail_on}:\n"
                + "\n".join(f.format() for f in bad))


@register_pass("lint")
@_program_pass
def _lint_pass(program, fail_on: str = None):
    """Analysis-only PROGRAM pass: tpu-lint's graph rules (dead ops,
    unused inputs, f64 widenings, host callbacks) over the exported graph
    and its source lint over the Program's function. Findings are warned
    and stored on the returned program as `.lint_findings`; with
    `fail_on=` set ('warning'/'error'), findings at/above that severity
    raise ValueError — the export-time gate
    (`prog.apply_pass('lint', fail_on='error')`)."""
    from ..analysis import lint_callable
    from ..analysis.graph import analyze_program
    findings = analyze_program(program) + lint_callable(program._fn)
    program.lint_findings = findings
    _gate(findings, "lint", fail_on)
    return program


@register_pass("concurrency")
@_program_pass
def _concurrency_pass(program, fail_on: str = None):
    """Analysis-only PROGRAM pass: tpu-lint's concurrency rules
    (lock-order, blocking-under-lock, unregistered-thread) over the
    module that defines the Program's function — the threading context
    the program runs in, not its graph. Findings are warned and stored as
    `.concurrency_findings`; `fail_on=` gates like the lint pass. A
    function with no source file gives no findings."""
    from ..analysis.concurrency import analyze_paths
    try:
        path = inspect.getsourcefile(program._fn)
    except TypeError:
        path = None
    findings = analyze_paths([path])[0] if path else []
    program.concurrency_findings = findings
    _gate(findings, "concurrency", fail_on)
    return program
