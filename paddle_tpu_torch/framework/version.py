"""Artifact version stamping and the op version registry.

Counterpart of `paddle_tpu/framework/version.py` (framework/version.cc
and op_version_registry.h in paddle): `jit.save` stamps each artifact with
the version that wrote it and a {op: version} snapshot; `jit.load` refuses
an artifact of an incompatible version and warns for ops whose semantics
changed since it was saved. The version string is the port's own: its
artifact is a `torch.export` program, which the JAX package cannot read,
nor the port the JAX package's StableHLO.
"""
from __future__ import annotations

from typing import Dict, List, Optional

FRAMEWORK_VERSION = "2.0.0-torch"
# artifacts written by versions < this cannot be read (format breaks)
MIN_COMPATIBLE_VERSION = "2.0.0-torch"


def _ver_tuple(v: str):
    return tuple(int(x) for x in v.split("-")[0].split("."))


def is_compatible(artifact_version: Optional[str]) -> bool:
    if not artifact_version:
        return False
    try:
        return _ver_tuple(artifact_version) >= \
            _ver_tuple(MIN_COMPATIBLE_VERSION)
    except ValueError:  # malformed or foreign version string
        return False


class OpCheckpoint:
    def __init__(self, note: str, version: int):
        self.note = note
        self.version = version


class OpVersionRegistry:
    """op name -> ordered checkpoints."""

    def __init__(self):
        self._ops: Dict[str, List[OpCheckpoint]] = {}

    def register(self, op_name: str):
        self._ops.setdefault(op_name, [])
        return _OpVersionBuilder(self, op_name)

    def _add(self, op_name: str, note: str):
        cps = self._ops.setdefault(op_name, [])
        cps.append(OpCheckpoint(note, len(cps) + 1))

    def version_of(self, op_name: str) -> int:
        return len(self._ops.get(op_name, []))

    def checkpoints(self, op_name: str) -> List[OpCheckpoint]:
        return list(self._ops.get(op_name, []))

    def snapshot(self) -> Dict[str, int]:
        """{op: version} map stamped into saved artifacts."""
        return {k: len(v) for k, v in self._ops.items()}

    def incompatibilities(self, artifact_ops: Dict[str, int]) -> List[str]:
        """Ops whose semantics changed since the artifact was written."""
        out = []
        for op, ver in (artifact_ops or {}).items():
            cur = self.version_of(op)
            if cur > ver:
                notes = "; ".join(c.note for c in self._ops[op][ver:])
                out.append(f"{op}: v{ver} -> v{cur} ({notes})")
        return out


class _OpVersionBuilder:
    def __init__(self, reg: OpVersionRegistry, op_name: str):
        self._reg = reg
        self._op = op_name

    def add_checkpoint(self, note: str):
        self._reg._add(self._op, note)
        return self


GLOBAL_OP_VERSION_REGISTRY = OpVersionRegistry()

# the reference's semantic-change history, kept so that a snapshot names
# the same ops at the same versions
GLOBAL_OP_VERSION_REGISTRY.register("sequence_pad").add_checkpoint(
    "maxlen smaller than the longest sequence now raises instead of "
    "silently padding to the true max")
GLOBAL_OP_VERSION_REGISTRY.register("embedding").add_checkpoint(
    "sparse=True emits SelectedRows weight gradients")

__all__ = ["FRAMEWORK_VERSION", "MIN_COMPATIBLE_VERSION", "is_compatible",
           "OpCheckpoint", "OpVersionRegistry", "GLOBAL_OP_VERSION_REGISTRY"]
