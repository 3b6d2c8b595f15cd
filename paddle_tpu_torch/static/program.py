"""Program: an inspectable, prunable static program.

Counterpart of `paddle_tpu/static/program.py` (:54-175). The reference's
program is the StableHLO module of a traced function; the port's is the
`torch.export` graph of one (`jit.save_load.export_program`, the export
under `jit.save` and `jit.to_static`). A Program keeps the function, its
argument specs and, once lowered, the exported program:
  - ops() / op_histogram() / has_op(): the graph's `call_function` nodes
    under their operator names (`aten.linear`, `aten.tanh`,
    `higher_order.cond`, ...), the subgraphs of `cond` and `while_loop`
    included — the golden-graph snapshots of the program tests;
  - num_blocks(): 1 plus the subgraphs of `cond` and `while_loop`;
  - inputs() / outputs(): the signature;
  - prune(fetch_ids): the program of a subset of the outputs, with the
    ops no kept output needs eliminated (framework/prune.cc's backward
    slice; the reference leaves it to XLA's dead-code elimination);
  - apply_pass(name): a registered pass (`static.passes`);
  - compile() / run(): the exported program as a callable.
"""
from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from ..core.dtype import dtype_name
from ..core.place import resolve_device
from ..core.tensor import to_torch
from ..jit.input_spec import InputSpec

__all__ = ["Program", "OpDesc", "default_main_program", "op_name",
           "op_names"]


def op_name(target) -> Optional[str]:
    """The operator name of an FX node target: `aten.linear` for
    `aten.linear.default`, `higher_order.cond` for the cond operator;
    None for Python builtins (`getitem`)."""
    if isinstance(target, torch._ops.OpOverload):
        return target._schema.name.replace("::", ".")
    if isinstance(target, torch._ops.HigherOrderOperator):
        return f"higher_order.{target.name()}"
    if isinstance(target, torch._ops.OpOverloadPacket):
        return str(target).replace("::", ".")
    return None


def _graph_modules(gm):
    """gm and the graph modules of its `cond` / `while_loop` subgraphs."""
    return [m for m in gm.modules() if isinstance(m, torch.fx.GraphModule)]


def op_names(gm) -> List[str]:
    return [name for m in _graph_modules(gm) for node in m.graph.nodes
            if node.op == "call_function"
            and (name := op_name(node.target)) is not None]


class OpDesc:
    """One operation of the program (ProgramDesc OpDesc mirror)."""

    __slots__ = ("type", "result", "text")

    def __init__(self, type_, result, text):
        self.type = type_          # e.g. "aten.linear"
        self.result = result       # the node's name
        self.text = text           # the node as FX prints it

    def __repr__(self):
        return f"OpDesc({self.type})"


class _VarDesc:
    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, list(shape), dtype

    def __repr__(self):
        return f"Var({self.name}: {self.dtype}{self.shape})"


def _spec_of(a):
    """(InputSpec, device) of an argument spec: a tensor, an InputSpec or
    an object with shape and dtype."""
    if isinstance(a, torch.Tensor):
        return InputSpec.from_tensor(a), a.device
    if isinstance(a, InputSpec):
        return a, resolve_device()
    return InputSpec(list(getattr(a, "shape", ())),
                     getattr(a, "dtype", "float32")), resolve_device()


class Program:
    """A static program captured from a function of tensors.

    Build one with `Program.from_callable(fn, specs)` (tensors or
    InputSpecs), or take a `@to_static` function's (`program()`,
    `static.default_main_program()`)."""

    def __init__(self, fn: Callable, arg_specs: Sequence, exported=None,
                 devices=None, name: str = "main", bound=None, dce=False):
        self._fn = fn
        self._arg_specs = list(arg_specs)
        self._devices = list(devices) if devices is not None else \
            [resolve_device()] * len(self._arg_specs)
        self._exported = exported
        # (n leading args, tensors): the exported graph takes the bound
        # tensors after its first n arguments (a to_static capture's
        # buffers); the Program's own arguments leave them out
        self._bound = bound
        self._dce = dce
        self._compiled = None
        self.name = name

    # ---- construction ----
    @classmethod
    def from_callable(cls, fn, arg_specs, name="main"):
        pairs = [_spec_of(a) for a in arg_specs]
        return cls(fn, [s for s, _ in pairs], devices=[d for _, d in pairs],
                   name=name)

    def _examples(self):
        return [torch.zeros([1 if d == -1 else int(d) for d in s.shape],
                            dtype=s.dtype, device=dev)
                for s, dev in zip(self._arg_specs, self._devices)]

    def _lower(self):
        if self._exported is None:
            from ..jit.save_load import _Program, export_program
            ep = export_program(_Program(None, [], [], fn=self._fn),
                                self._examples())
            if self._dce:
                ep = eliminate_dead_code(ep)
            self._exported = ep
        return self._exported

    def exported(self):
        """The `torch.export.ExportedProgram` of this program."""
        return self._lower()

    # ---- introspection (ProgramDesc surface) ----
    def as_text(self) -> str:
        """The exported graph, its subgraphs included, as FX prints it."""
        return self._lower().graph_module.print_readable(
            print_output=False)

    __str__ = as_text

    def ops(self) -> List[OpDesc]:
        out = []
        for m in _graph_modules(self._lower().graph_module):
            for node in m.graph.nodes:
                if node.op != "call_function":
                    continue
                name = op_name(node.target)
                if name is not None:
                    out.append(OpDesc(name, node.name, node.format_node()))
        return out

    def op_histogram(self) -> dict:
        """Op name -> count: the golden-graph snapshot of program tests."""
        hist: dict = {}
        for op in self.ops():
            hist[op.type] = hist.get(op.type, 0) + 1
        return hist

    def has_op(self, op_type: str) -> bool:
        return any(op.type == op_type or op.type.endswith("." + op_type)
                   for op in self.ops())

    def inputs(self) -> List[_VarDesc]:
        return [_VarDesc(f"input_{i}", s.shape, dtype_name(s.dtype))
                for i, s in enumerate(self._arg_specs)]

    def outputs(self) -> List[_VarDesc]:
        gm = self._lower().graph_module
        out = next(n for n in gm.graph.nodes if n.op == "output")
        vals = [a.meta["val"] for a in pytree.tree_leaves(out.args[0])
                if isinstance(a, torch.fx.Node) and "val" in a.meta]
        return [_VarDesc(f"output_{i}", v.shape, dtype_name(v.dtype))
                for i, v in enumerate(vals)]

    def num_blocks(self) -> int:
        return len(_graph_modules(self._lower().graph_module))

    # ---- prune (framework/prune.cc role) ----
    def prune(self, fetch_ids) -> "Program":
        """The program of the outputs in `fetch_ids` (indices into the
        flattened outputs), with the ops none of them needs eliminated."""
        if isinstance(fetch_ids, int):
            fetch_ids = [fetch_ids]
        ids = list(fetch_ids)
        fn = self._fn

        def pruned(*args):
            leaves = pytree.tree_leaves(fn(*args))
            picked = [leaves[i] for i in ids]
            return picked[0] if len(picked) == 1 else tuple(picked)

        return Program(pruned, self._arg_specs, devices=self._devices,
                       name=f"{self.name}_pruned", dce=True)

    # ---- pass hook (framework/ir PassRegistry role) ----
    def apply_pass(self, name: str, **options) -> "Program":
        """A NEW Program with a registered pass applied
        (`static.passes.register_pass` is the extension point)."""
        from .passes import apply_pass
        return apply_pass(self, name, **options)

    # ---- execution ----
    def compile(self):
        """The exported program as a callable of this Program's arguments."""
        if self._compiled is None:
            module = self._lower().module()
            if self._bound is None:
                self._compiled = module
            else:
                n, bound = self._bound

                def call(*args):
                    return module(*args[:n], *bound, *args[n:])
                self._compiled = call
        return self._compiled

    def run(self, *args):
        arrs = [to_torch(a) if isinstance(a, torch.Tensor)
                else torch.as_tensor(a, device=dev)
                for a, dev in zip(args, self._devices)]
        return self.compile()(*arrs)

    def clone(self, for_test=False) -> "Program":
        return Program(self._fn, self._arg_specs, exported=self._exported,
                       devices=self._devices, name=self.name,
                       bound=self._bound, dce=self._dce)

    def __repr__(self):
        # never lowers (repr stays cheap); the op count shows only once
        # the program was exported
        ops = f", ops={len(self.ops())}" if self._exported is not None \
            else ""
        return (f"Program(name={self.name!r}, "
                f"inputs={len(self._arg_specs)}{ops})")


def eliminate_dead_code(ep):
    """A copy of the exported program without the nodes no output needs
    (FX dead-code elimination over the graph and its subgraphs; random
    and in-place ops count as needed)."""
    ep = copy.deepcopy(ep)
    for m in _graph_modules(ep.graph_module):
        m.graph.eliminate_dead_code()
        m.recompile()
    return ep


# the default program (fluid.default_main_program role)
_DEFAULT: List[Optional[Program]] = [None]


def _set_default_program(prog: Program):
    _DEFAULT[0] = prog


def default_main_program() -> Program:
    if _DEFAULT[0] is None:
        raise RuntimeError(
            "no program captured yet: call an @to_static function (or build "
            "one with Program.from_callable) first")
    return _DEFAULT[0]
