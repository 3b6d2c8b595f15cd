"""Build a CUDA source of this package into a shared library, at first use.

`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
compiles `kernels/csrc/<name>.cu` into `kernels/build/`, a directory that
git ignores, and links it against the CUDA driver (`-lcuda`: the kernels'
TMA descriptors are encoded on the host by `cuTensorMapEncodeTiled`). The
library's file name carries a hash of its source, of every shared header
(`csrc/*.cuh`) and of the flags, so an edited source or header is rebuilt
and never loaded stale. A file lock keeps two
threads or processes (the serving worker and the main thread) from
building the same library twice. Only the sources in this package are
compiled; a failed build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
LINK_FLAGS = ["-lcuda"]

_LOCK = threading.Lock()
_LIBS = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "paddle_tpu_torch are built from source at first use")


def library_path(name: str) -> str:
    """The library's path: a hash of `<name>.cu`, of every `csrc/*.cuh`
    (any source may include any of them) and of the nvcc flags."""
    digest = hashlib.sha256(" ".join(ARCH_FLAGS + LINK_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists;
    returns the library's path."""
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                       "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
                       os.path.join(CSRC_DIR, name + ".cu"), *LINK_FLAGS]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {name}.cu (rc={res.returncode}):\n"
                        f"{res.stderr[-4000:]}")
                with open(out + ".log", "w") as log:
                    log.write(res.stdout + res.stderr)
                os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, built on first call."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib
