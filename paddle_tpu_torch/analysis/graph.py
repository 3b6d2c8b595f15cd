"""tpu-lint level 2: graph analysis over exported programs and collective
sequences.

Counterpart of `paddle_tpu/analysis/graph.py`. The reference walks the
traced jaxpr; the port's SSA graph is a `static.Program`'s exported FX
graph (`torch.export`, the program `jit.to_static` runs), walked with
`static.program`'s own helpers: dead-op liveness, implicit dtype
widenings, host callbacks, and unused program inputs. The headline rule,
collective-ordering verification, holds each rank's or pipeline stage's
STATIC sequence of collectives (op, axis, shape, dtype) — the
`CollectiveDesc` lists `parallel.collective.record_only()` gives, as
`SPMDTrainStep.collective_signature` and `PipelineParallel.
collective_signature` trace them without communicating — and proves the
sequences match, naming the first divergence instead of letting the world
deadlock at runtime.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import torch

from .base import Finding

__all__ = ["iter_nodes", "live_node_mask", "dead_nodes",
           "analyze_graph", "analyze_program",
           "CollectiveDesc", "collective_sequence", "verify_collective_order",
           "verify_stage_chain", "verify_stage_assignment"]

# operators that re-enter the host from inside the program: the py_func
# operator (`static.nn.py_func`) and a tensor's scalar read
HOST_CALLBACK_OPS = {"paddle_tpu_torch.py_func", "aten._local_scalar_dense",
                     "aten.item"}
_WIDE = (torch.float64, torch.complex128)


def _graph_module(obj):
    """Normalize a Program / ExportedProgram / GraphModule to the root
    GraphModule of its exported graph."""
    if isinstance(obj, torch.fx.GraphModule):
        return obj
    if hasattr(obj, "graph_module"):                 # ExportedProgram
        return obj.graph_module
    if hasattr(obj, "exported") and hasattr(obj, "_arg_specs"):  # Program
        return obj.exported().graph_module
    raise TypeError(f"cannot analyze {type(obj).__name__}")


def iter_nodes(obj) -> Iterable[torch.fx.Node]:
    """Every operator node in program order, the subgraphs of `cond` and
    `while_loop` included (each once)."""
    from ..static.program import _graph_modules
    for m in _graph_modules(_graph_module(obj)):
        for node in m.graph.nodes:
            if node.op == "call_function":
                yield node


def live_node_mask(graph: torch.fx.Graph) -> Dict[torch.fx.Node, bool]:
    """Per-node liveness at one graph level: a node is live when it is the
    output, has side effects (in-place, random and collective operators:
    `Node.is_impure`), or feeds a live node. Subgraphs count atomically."""
    live: Dict[torch.fx.Node, bool] = {}
    for node in reversed(graph.nodes):
        live[node] = node.op == "output" or (
            node.op == "call_function" and node.is_impure()) or any(
            live.get(u, False) for u in node.users)
    return live


def dead_nodes(obj) -> Iterable[torch.fx.Node]:
    """Dead operator nodes at every level: a node whose value never
    reaches its own graph's outputs is dead whatever the enclosing program
    does with that graph (a `cond` branch's dead node included). Only
    operators that make tensors count: a Python builtin (`getitem` of a
    multi-output operator's unused result, such as batch norm's saved
    statistics) is a projection, and an operator on metadata
    (`aten.promote_types`, whose dtype the export read on the host) does
    no device work; a jaxpr has neither."""
    from ..static.program import _graph_modules, op_name
    for m in _graph_modules(_graph_module(obj)):
        live = live_node_mask(m.graph)
        for node in m.graph.nodes:
            if node.op == "call_function" and not live[node] and \
                    op_name(node.target) is not None and \
                    _dtypes(node.meta.get("val")):
                yield node


def _dtypes(val) -> List[torch.dtype]:
    if isinstance(val, torch.Tensor):
        return [val.dtype]
    if isinstance(val, (list, tuple)):
        return [d for v in val for d in _dtypes(v)]
    return []


def _short(val) -> str:
    if isinstance(val, torch.Tensor):
        return f"{str(val.dtype).replace('torch.', '')}{list(val.shape)}"
    return type(val).__name__


def analyze_graph(obj, path: str = "<program>",
                  func: str = "") -> List[Finding]:
    """dead-op / unused-var / dtype-widen / host-callback over one exported
    program (a Program, an ExportedProgram or its GraphModule)."""
    from ..static.program import op_name
    gm = _graph_module(obj)
    findings: List[Finding] = []

    for node in dead_nodes(gm):
        findings.append(Finding(
            "dead-op",
            f"dead op '{op_name(node.target)}': its results "
            "are never used by any program output", path=path, func=func))

    live = live_node_mask(gm.graph)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for i, node in enumerate(placeholders):
        if not any(live[u] for u in node.users):
            findings.append(Finding(
                "unused-var",
                f"program input #{i} ({_short(node.meta.get('val'))}) is "
                "consumed by no live op", path=path, func=func))

    for node in iter_nodes(gm):
        name = op_name(node.target) or str(node.target)
        if name in HOST_CALLBACK_OPS:
            findings.append(Finding(
                "host-callback",
                f"host callback '{name}' inside the exported program — a "
                "device->host round trip every call", path=path, func=func))
        out_dts = _dtypes(node.meta.get("val"))
        in_dts = [d for a in node.all_input_nodes
                  for d in _dtypes(a.meta.get("val"))]
        wide = [d for d in out_dts if d in _WIDE]
        if wide and in_dts and not any(d in _WIDE for d in in_dts):
            findings.append(Finding(
                "dtype-widen",
                f"'{name}' widens {str(in_dts[0]).replace('torch.', '')} "
                f"-> {str(wide[0]).replace('torch.', '')} (float64 runs off "
                "the tensor cores at a fraction of the f32 rate)",
                path=path, func=func))
    return findings


def analyze_program(program, path: Optional[str] = None) -> List[Finding]:
    """Graph rules over a `static.Program` (its exported graph)."""
    return analyze_graph(program, path=path or f"<Program {program.name}>",
                         func=program.name)


# ---- collective-ordering verification --------------------------------------

def __getattr__(name):
    # the port's CollectiveDesc lives with the collectives that record it
    if name == "CollectiveDesc":
        from ..parallel.collective import CollectiveDesc
        return CollectiveDesc
    raise AttributeError(name)


def collective_sequence(obj, *args) -> list:
    """The static, ordered collective sequence of a program. `obj` may be
    an already-extracted sequence (returned as-is), a regime with a
    `collective_signature` (`SPMDTrainStep`, `PipelineParallel`; `args`
    are its batch), or a callable run on `args` under FakeTensorMode with
    every collective recorded instead of issued
    (`collective.record_only()`)."""
    from ..parallel import collective
    if isinstance(obj, (list, tuple)) and all(
            isinstance(c, collective.CollectiveDesc) for c in obj):
        return list(obj)
    if hasattr(obj, "collective_signature"):
        return list(obj.collective_signature(*args))
    if callable(obj):
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True) as fm, \
                collective.record_only() as seq:
            obj(*[fm.from_tensor(a) if isinstance(a, torch.Tensor) else a
                  for a in args])
        return list(seq)
    raise TypeError(f"no collective sequence in {type(obj).__name__}")


def verify_collective_order(programs: Mapping[str, Any],
                            specs: Optional[Mapping[str, Sequence]] = None
                            ) -> List[Finding]:
    """Prove every rank's/stage's static collective sequence matches the
    first entry's (the reference rank). Values may be sequences from
    `collective_sequence`, regimes or callables (give per-name example
    args via `specs`). Returns findings naming the FIRST divergence — the
    exact call the world would deadlock on."""
    names = list(programs)
    if len(names) < 2:
        return []
    seqs: Dict[str, list] = {}
    for n in names:
        sp = (specs or {}).get(n, ())
        seqs[n] = collective_sequence(programs[n], *sp)
    ref_name, ref = names[0], seqs[names[0]]
    findings: List[Finding] = []
    for n in names[1:]:
        seq = seqs[n]
        for i, (a, b) in enumerate(zip(ref, seq)):
            if a != b:
                findings.append(Finding(
                    "collective-order",
                    f"{n} diverges from {ref_name} at collective #{i}: "
                    f"{ref_name} issues {a!r}, {n} issues {b!r} — the "
                    "world deadlocks here at runtime", func=n))
                break
        else:
            if len(ref) != len(seq):
                short, long_ = (n, ref_name) if len(seq) < len(ref) \
                    else (ref_name, n)
                i = min(len(ref), len(seq))
                extra = (ref if len(ref) > len(seq) else seq)[i]
                findings.append(Finding(
                    "collective-order",
                    f"{n} issues {len(seq)} collectives, {ref_name} issues "
                    f"{len(ref)}: {short} never reaches {long_}'s "
                    f"collective #{i} ({extra!r}) — peers block there "
                    "forever", func=n))
    return findings


# ---- pipeline/task-graph verification --------------------------------------

def verify_stage_chain(stages: Sequence, sample) -> List[Finding]:
    """Prove each pipeline stage's output can feed the next stage by
    shape propagation under FakeTensorMode (no FLOPs): names the first
    broken edge instead of letting the pipeline hang mid-drain. `sample`
    is a stage-0 example input (a tensor)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    findings: List[Finding] = []
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        x = fm.from_tensor(sample) if isinstance(sample, torch.Tensor) \
            else sample
        for i, stage in enumerate(stages):
            try:
                with torch.no_grad():
                    x = stage(x)
            except Exception as e:   # noqa: BLE001 — the finding
                src = "microbatch input" if i == 0 \
                    else f"stage {i - 1} output"
                shp = tuple(x.shape) if isinstance(x, torch.Tensor) \
                    else type(x).__name__
                findings.append(Finding(
                    "stage-graph",
                    f"stage {i} cannot consume {src} {shp}: "
                    f"{type(e).__name__}: {e}", func=f"stage{i}"))
                return findings
    return findings


def verify_stage_assignment(stage_owner: Mapping[int, int], n_stages: int,
                            my_rank: Optional[int] = None,
                            my_stages: Optional[Iterable[int]] = None
                            ) -> List[Finding]:
    """Task-graph ownership check: every stage 0..n-1 must have an owner,
    and a rank must only host stages it owns — a stage with no owner is a
    pipeline that never drains."""
    findings: List[Finding] = []
    for s in range(n_stages):
        if s not in stage_owner:
            findings.append(Finding(
                "stage-graph",
                f"stage {s} has no owning rank: microbatches reaching it "
                "are never consumed", func=f"stage{s}"))
    for s in stage_owner:
        if not (0 <= s < n_stages):
            findings.append(Finding(
                "stage-graph",
                f"stage_owner maps nonexistent stage {s} "
                f"(n_stages={n_stages})", func=f"stage{s}"))
    if my_rank is not None and my_stages is not None:
        for s in my_stages:
            owner = stage_owner.get(s)
            if owner is not None and owner != my_rank:
                findings.append(Finding(
                    "stage-graph",
                    f"rank {my_rank} hosts stage {s} but stage_owner maps "
                    f"it to rank {owner}: both ranks will consume its "
                    "messages", func=f"stage{s}"))
    return findings
