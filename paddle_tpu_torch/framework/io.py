"""paddle.save / paddle.load — object checkpointing.

Counterpart of `paddle_tpu/framework/io.py` (:19-81), with the same file
format, so a file moves between the two packages in either direction: a
pickle of `{"__paddle_tpu__": 1, "obj": <object tree>, "npz": <bytes>}`
whose tree holds a reference object in place of every tensor, and an npz
archive of the tensors (bf16 as the raw 2-byte values that numpy stores
for it).

The pickle names the reference class by the JAX package's module path,
`paddle_tpu.framework.io._TensorRef`. `save` writes that name for this
module's `_TensorRef` without importing anything, and `load` maps it back
with its own `find_class`: the JAX package is never imported.
"""
from __future__ import annotations

import io as _io
import os
import pickle
import threading

import numpy as np
import torch

from ..core.place import resolve_device

_REF_MODULE, _REF_NAME = "paddle_tpu.framework.io", "_TensorRef"


class _TensorRef:
    def __init__(self, key, is_param, name):
        self.key, self.is_param, self.name = key, is_param, name


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):  # bf16
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _pack(obj, store):
    if isinstance(obj, torch.Tensor):
        key = f"t{len(store)}"
        store[key] = _to_numpy(obj)
        return _TensorRef(key, isinstance(obj, torch.nn.Parameter),
                          getattr(obj, "name", None))
    if isinstance(obj, dict):
        return {k: _pack(v, store) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_pack(v, store) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _unpack(obj, store, return_numpy, device):
    if isinstance(obj, _TensorRef):
        arr = store[obj.key]
        if return_numpy:
            return arr
        t = _to_tensor(arr).to(device)
        return torch.nn.Parameter(t, requires_grad=t.is_floating_point()) \
            if obj.is_param else t
    if isinstance(obj, dict):
        return {k: _unpack(v, store, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_unpack(v, store, return_numpy, device) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


class _Pickler(pickle._Pickler):
    """Writes `_TensorRef` under the JAX package's class path. The Python
    pickler is used because the C one imports a class's module to check
    its name."""

    def save_global(self, obj, name=None):
        if obj is not _TensorRef:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_REF_MODULE)
            self.save(_REF_NAME)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL +
                       f"{_REF_MODULE}\n{_REF_NAME}\n".encode("utf-8"))
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == (_REF_MODULE, _REF_NAME):
            return _TensorRef
        if module.split(".")[0] == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"{module}.{name}: only tensors, containers and plain "
                "Python objects load outside the JAX package")
        return super().find_class(module, name)


def atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename: the final name either holds the complete
    bytes or does not exist (`paddle_tpu/framework/sharded_io.py:42`).

    Each writer has its own tmp name (pid + thread id), so concurrent
    writers of one name never interleave inside one tmp file: whoever
    renames last wins, and both candidate files were complete (the
    compile cache's lock-free writers rely on it)."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(obj, path, protocol=4, **configs):
    """Crash-atomic: the payload is serialized in memory, then committed
    by `atomic_write`."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    store = {}
    packed = _pack(obj, store)
    npz = _io.BytesIO()
    np.savez(npz, **store)
    buf = _io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(
        {"__paddle_tpu__": 1, "obj": packed, "npz": npz.getvalue()})
    atomic_write(path, buf.getvalue())


def load(path, return_numpy=False, **configs):
    """The saved object; tensors come back on the current device (or as
    numpy arrays with return_numpy)."""
    with open(path, "rb") as f:
        blob = _Unpickler(f).load()
    if not (isinstance(blob, dict) and "__paddle_tpu__" in blob):
        return blob  # plain pickle
    store = dict(np.load(_io.BytesIO(blob["npz"]), allow_pickle=False))
    device = None if return_numpy else resolve_device()
    return _unpack(blob["obj"], store, return_numpy, device)


__all__ = ["save", "load", "atomic_write"]
