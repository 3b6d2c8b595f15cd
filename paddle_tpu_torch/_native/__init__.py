"""The C inference API client (`csrc/predict_capi.cpp`), loaded via ctypes.

Counterpart of the C-client part of `paddle_tpu/_native/`: C and Go apps
run inference against a stable ABI — `PD_PredictorCreate`,
`PD_PredictorRun`, `PD_PredictorRunWithDeadline`, `PD_TensorsDestroy`,
`PD_GetLastError`, `PD_PredictorDestroy` — a thin binary-protocol client
of `inference.server.PredictorServer`.

`load()` compiles the repo's single copy of `csrc/predict_capi.cpp` (the
source the C apps compile against, so the ABI cannot drift) with
`g++ -O2 -std=c++17 -fPIC -shared -pthread` into `_native/build/` at first
use; the library's name carries a hash of the source, so an edited source
rebuilds. A failed build raises: there is no Python stand-in. The
reference's TCPStore and PS server sources wait for the distributed
slice.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["PD_Tensor", "load", "library_path", "run"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.normpath(os.path.join(_HERE, "..", "..", "csrc",
                                        "predict_capi.cpp"))
_BUILD = os.path.join(_HERE, "build")
_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lib = None
_lock = threading.Lock()


class PD_Tensor(ctypes.Structure):
    """The ABI's tensor: dtype 0 f32 / 1 i32 / 2 i64, up to 8 dims; the
    data of outputs is owned by the library (`PD_TensorsDestroy`)."""
    _fields_ = [("dtype", ctypes.c_int32), ("ndim", ctypes.c_int32),
                ("dims", ctypes.c_int64 * 8), ("data", ctypes.c_void_p)]


def library_path() -> str:
    """Where the library for the current source lives (built or not)."""
    if not os.path.exists(_SOURCE):
        raise FileNotFoundError(
            f"{_SOURCE}: the C client's source is not in this checkout")
    with open(_SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"libpaddle_tpu_capi-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SOURCE]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("building the C inference client needs g++ on "
                           "PATH") from e
    if r.returncode != 0:
        raise RuntimeError(f"building {_SOURCE} failed ({' '.join(cmd)}):\n"
                           f"{r.stderr[-2000:]}")
    os.replace(tmp, path)   # atomic: concurrent builds race harmlessly


def load():
    """The C client library, built on first use, with every entry's
    `argtypes` / `restype` declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        p_tensor = ctypes.POINTER(PD_Tensor)
        lib.PD_PredictorCreate.restype = ctypes.c_void_p
        lib.PD_PredictorCreate.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.PD_PredictorDestroy.restype = None
        lib.PD_PredictorDestroy.argtypes = [ctypes.c_void_p]
        lib.PD_PredictorRun.restype = ctypes.c_int
        lib.PD_PredictorRun.argtypes = [
            ctypes.c_void_p, p_tensor, ctypes.c_int,
            ctypes.POINTER(p_tensor), ctypes.POINTER(ctypes.c_int)]
        lib.PD_PredictorRunWithDeadline.restype = ctypes.c_int
        lib.PD_PredictorRunWithDeadline.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, p_tensor, ctypes.c_int,
            ctypes.POINTER(p_tensor), ctypes.POINTER(ctypes.c_int)]
        lib.PD_TensorsDestroy.restype = None
        lib.PD_TensorsDestroy.argtypes = [p_tensor, ctypes.c_int]
        lib.PD_GetLastError.restype = ctypes.c_char_p
        lib.PD_GetLastError.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


_DTYPE_CODES = {"float32": 0, "int32": 1, "int64": 2}
_CODE_DTYPES = {0: "float32", 1: "int32", 2: "int64"}


def run(host: str, port: int, arrays, deadline_ms=None):
    """One request through the C client, as a C app makes it: connect
    (`PD_PredictorCreate`), `PD_PredictorRun` (or
    `PD_PredictorRunWithDeadline`), copy the outputs out, free them and
    disconnect. Returns (rc, outputs or the library's error message); rc
    0 ok, 3 server error, 4 overloaded, 5 deadline expired."""
    import numpy as np
    lib = load()
    arrays = [np.ascontiguousarray(a) for a in arrays]
    ins = (PD_Tensor * len(arrays))()
    for t, a in zip(ins, arrays):
        if str(a.dtype) not in _DTYPE_CODES or a.ndim > 8:
            raise ValueError(f"the C ABI carries f32/i32/i64 of <= 8 dims, "
                             f"not {a.dtype}{list(a.shape)}")
        t.dtype, t.ndim = _DTYPE_CODES[str(a.dtype)], a.ndim
        for i, d in enumerate(a.shape):
            t.dims[i] = d
        t.data = a.ctypes.data_as(ctypes.c_void_p)
    handle = lib.PD_PredictorCreate(host.encode(), int(port))
    if not handle:
        raise ConnectionError(f"PD_PredictorCreate({host}:{port}) failed")
    try:
        outs = ctypes.POINTER(PD_Tensor)()
        n_out = ctypes.c_int(0)
        if deadline_ms is None:
            rc = lib.PD_PredictorRun(handle, ins, len(arrays),
                                     ctypes.byref(outs), ctypes.byref(n_out))
        else:
            rc = lib.PD_PredictorRunWithDeadline(
                handle, int(deadline_ms), ins, len(arrays),
                ctypes.byref(outs), ctypes.byref(n_out))
        if rc != 0:
            return rc, (lib.PD_GetLastError(handle) or b"").decode()
        got = []
        try:
            for i in range(n_out.value):
                t = outs[i]
                shape = tuple(t.dims[j] for j in range(t.ndim))
                dt = np.dtype(_CODE_DTYPES[t.dtype])
                n = int(np.prod(shape)) if shape else 1
                buf = (ctypes.c_char * (n * dt.itemsize)).from_address(
                    t.data) if n else b""
                got.append(np.frombuffer(bytes(buf), dt).reshape(shape))
        finally:
            lib.PD_TensorsDestroy(outs, n_out.value)
        return rc, got
    finally:
        lib.PD_PredictorDestroy(handle)
