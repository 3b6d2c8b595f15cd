"""Sharded checkpoints and epoch-granular auto-checkpointing.

Counterpart of `paddle_tpu/framework/sharded_io.py`, with the same files,
so a directory written by one package loads in the other:

  dirname/manifest-p<proc>.json      the commit record: every array's
                                     shape, dtype and shards (key, index,
                                     CRC32), the shard file's name and its
                                     whole-file CRC32, the version
  dirname/shards-p<proc>-v<N>.npz    the shards, one npz per process and
                                     generation (bf16 as the raw 2-byte
                                     values numpy stores for it)
  dirname/manifest-p<proc>.json.bak  the previous generation's record,
                                     the fallback when the newest is torn

The reference writes each addressable shard of a GSPMD array. The port
runs one process per card, and each process writes the tensors it is
given whole (`<name>::full`): a rank that holds a slice of a parameter
(ZeRO, an mp slice) saves it under a name of its own, or gathers first.
The loader reassembles sharded entries written by the reference by their
index ranges.

`AutoCheckpoint` is the reference's epoch loop over a status record
(`fluid/incubate/checkpoint/auto_checkpoint.py:71`): an elastic relaunch
(`parallel.elastic.launch_elastic`) restores the last committed snapshot
and resumes at its epoch.
"""
from __future__ import annotations

import glob
import io
import json
import os
import shutil
import warnings
import zlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import faults as _faults
from .. import monitor as _monitor
from .io import _to_numpy, _to_tensor, atomic_write


class CheckpointCorruptError(RuntimeError):
    """Checkpoint data failed its checksum or structure check and no
    intact fallback generation exists."""


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype of a manifest string. bfloat16 and the float8
    types resolve through ml_dtypes when it is installed; without it they
    stay the raw bytes numpy stores them as (`|V1` / `|V2`), which
    `framework.io._to_tensor` reads as bf16."""
    try:
        return np.dtype(name)
    except TypeError:
        try:
            import ml_dtypes
        except ImportError:
            return np.dtype("V2" if name == "bfloat16" else "V1")
        return np.dtype(getattr(ml_dtypes, name))


def _process_index() -> int:
    from ..parallel.env import get_rank
    return get_rank()


def _process_count() -> int:
    from ..parallel.env import get_world_size
    return get_world_size()


def _as_numpy(v) -> Tuple[np.ndarray, str]:
    """(the array as numpy, its dtype's name in the manifest)."""
    if isinstance(v, torch.Tensor):
        name = str(v.dtype).replace("torch.", "")
        return _to_numpy(v), name
    arr = np.asarray(v)
    return arr, str(arr.dtype)


def save_sharded(state: Dict[str, object], dirname: str,
                 process_index: Optional[int] = None):
    """Write this process's tensors of `state` (torch tensors or numpy
    arrays) under `dirname` (see the module docstring).
    `process_index` defaults to the process world's rank.

    Crash-atomic: the shard file is written under a new versioned name
    (tmp + fsync + rename), then the manifest, carrying the shard file's
    name and its whole-file and per-shard CRC32s, replaces the previous
    one atomically. A crash at any point leaves the previous manifest
    pointing at its intact shard file. The previous generation is kept
    as `manifest-p<proc>.json.bak` (and its shard file); older ones are
    removed after a commit. Fault sites: `ckpt.write` (a torn payload)
    and `ckpt.commit` (a crash between the payload and the commit)."""
    os.makedirs(dirname, exist_ok=True)
    proc = _process_index() if process_index is None else process_index
    mpath = os.path.join(dirname, f"manifest-p{proc}.json")
    prev = _read_manifest(mpath)
    version = int(prev.get("version", 0)) + 1 if prev else 1
    manifest = {"arrays": {}, "process_count": _process_count(),
                "version": version}
    blobs = {}
    for name, v in state.items():
        arr, dtype = _as_numpy(v)
        key = f"{name}::full"
        blobs[key] = arr
        manifest["arrays"][name] = {
            "shape": list(arr.shape), "dtype": dtype,
            "shards": [{"key": key, "index": None,
                        "crc": _crc(np.ascontiguousarray(arr).tobytes())}]}
    buf = io.BytesIO()
    np.savez(buf, **blobs)
    data = buf.getvalue()
    shard_file = f"shards-p{proc}-v{version}.npz"
    manifest["shard_file"] = shard_file
    manifest["file_crc"] = _crc(data)   # of the intended bytes: a torn
    if _faults._ENABLED:                # write below fails the check
        data = _faults.mangle("ckpt.write", data)
    atomic_write(os.path.join(dirname, shard_file), data)
    if _faults._ENABLED:
        _faults.check("ckpt.commit")
    if os.path.exists(mpath):           # keep one fallback generation
        shutil.copyfile(mpath, mpath + ".bak")
    atomic_write(mpath, json.dumps(manifest).encode())
    _gc_shard_files(dirname, proc, keep={shard_file,
                                         prev.get("shard_file", "")})


def _read_manifest(mpath: str) -> dict:
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _gc_shard_files(dirname: str, proc, keep) -> None:
    for path in glob.glob(os.path.join(dirname, f"shards-p{proc}-v*.npz")):
        if os.path.basename(path) not in keep:
            try:
                os.remove(path)
            except OSError:
                pass


def _load_verified(dirname: str, mpath: str
                   ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """One manifest and its shard file, the whole-file CRC and every
    per-shard CRC verified; any mismatch or unreadable file raises
    CheckpointCorruptError. Manifests without checksums load
    unverified."""
    manifest = _read_manifest(mpath)
    if not manifest:
        raise CheckpointCorruptError(f"unreadable manifest {mpath}")
    proc = os.path.basename(mpath)[len("manifest-p"):].split(".", 1)[0]
    path = os.path.join(dirname,
                        manifest.get("shard_file", f"shards-p{proc}.npz"))
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointCorruptError(f"missing shard file {path}") from e
    if "file_crc" in manifest and _crc(raw) != manifest["file_crc"]:
        raise CheckpointCorruptError(
            f"shard file {path} failed its checksum (torn/corrupt write)")
    try:
        npz = np.load(io.BytesIO(raw))
        blobs = {}
        for meta in manifest["arrays"].values():
            for sh in meta.get("shards", []):
                blob = npz[sh["key"]]
                if "crc" in sh and _crc(
                        np.ascontiguousarray(blob).tobytes()) != sh["crc"]:
                    raise CheckpointCorruptError(
                        f"shard {sh['key']} in {path} failed its checksum")
                blobs[sh["key"]] = blob
    except CheckpointCorruptError:
        raise
    except Exception as e:   # zip, pickle or key damage
        raise CheckpointCorruptError(
            f"shard file {path} is unreadable: {e}") from e
    return manifest, blobs


def load_sharded(dirname: str, shardings=None) -> Dict[str, object]:
    """Reassemble every array from every process's shard files, as numpy
    arrays. `shardings` places them as torch tensors: a device (every
    array) or a {name: device} map (the arrays it names; the rest stay
    numpy). The reference's `shardings` maps names to jax shardings.

    Every shard file is verified against its manifest; on corruption the
    loader falls back to the previous committed generation
    (`manifest-p*.json.bak`), counting `ckpt.fallbacks` and warning. It
    raises CheckpointCorruptError only when no generation is intact, and
    FileNotFoundError when there is no checkpoint."""
    arrays: Dict[str, np.ndarray] = {}
    manifests = sorted(glob.glob(os.path.join(dirname, "manifest-p*.json")))
    if not manifests:
        raise FileNotFoundError(f"no sharded checkpoint in {dirname}")
    for mpath in manifests:
        try:
            manifest, blobs = _load_verified(dirname, mpath)
        except CheckpointCorruptError as e:
            bak = mpath + ".bak"
            if not os.path.exists(bak):
                raise
            if _monitor._ENABLED:
                _monitor.count("ckpt.fallbacks")
            warnings.warn(f"sharded checkpoint: {e}; falling back to the "
                          f"previous committed generation ({bak})")
            manifest, blobs = _load_verified(dirname, bak)
        for name, meta in manifest["arrays"].items():
            want = _np_dtype(meta["dtype"])
            if name not in arrays:
                arrays[name] = np.zeros(meta["shape"], want)
            for sh in meta.get("shards", []):
                data = blobs[sh["key"]]
                if data.dtype != want:
                    # npz stores bf16 and float8 as raw void bytes
                    data = np.ascontiguousarray(data).view(want)
                if sh["index"] is None:
                    arrays[name] = data
                else:
                    idx = tuple(slice(a, b) for a, b in sh["index"])
                    arrays[name][idx] = data
    if shardings is None:
        return arrays
    where = shardings if isinstance(shardings, dict) else \
        {name: shardings for name in arrays}
    for name, device in where.items():
        if name in arrays:
            arr = arrays[name]
            if str(arr.dtype) == "bfloat16":   # ml_dtypes' bf16
                arr = arr.view("V2")
            arrays[name] = _to_tensor(arr).to(device)
    return arrays


class AutoCheckpoint:
    """Epoch-granular snapshot and resume (auto_checkpoint.py:71)."""

    def __init__(self, dirname: str, save_fn: Callable[[str], None],
                 load_fn: Callable[[str], None]):
        self.dirname = dirname
        self.save_fn = save_fn
        self.load_fn = load_fn
        os.makedirs(dirname, exist_ok=True)

    def _status_path(self):
        return os.path.join(self.dirname, "status.json")

    def _status(self) -> dict:
        try:
            with open(self._status_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def completed_epochs(self) -> int:
        return int(self._status().get("epoch", 0))

    def train_epoch_range(self, max_epochs: int) -> Iterator[int]:
        """`for epoch in acp.train_epoch_range(n)`: on a fresh start yields
        0..n-1; after a relaunch it restores the snapshot and resumes at
        the first incomplete epoch.

        Each epoch writes a versioned snapshot (`save_fn(path)`), then
        commits the status record (the snapshot's path and the epoch)
        with fsync and an atomic rename. A kill between the snapshot and
        the commit leaves the status at the previous intact snapshot, so
        the interrupted epoch runs again exactly once. Fault site:
        `ckpt.commit`, between the two."""
        st = self._status()
        start = int(st.get("epoch", 0))
        if start > 0:
            self.load_fn(st.get("snapshot",
                                os.path.join(self.dirname, "snapshot")))
        for epoch in range(start, max_epochs):
            yield epoch
            snap = os.path.join(self.dirname, f"snapshot-{epoch + 1}")
            self.save_fn(snap)
            tmp = self._status_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"epoch": epoch + 1, "snapshot": snap}, f)
                f.flush()
                os.fsync(f.fileno())
            if _faults._ENABLED:
                _faults.check("ckpt.commit")
            os.replace(tmp, self._status_path())
            prev = os.path.join(self.dirname, f"snapshot-{epoch}")
            if os.path.isdir(prev):
                shutil.rmtree(prev, ignore_errors=True)
            elif os.path.isfile(prev):  # a save_fn may write one file
                try:
                    os.remove(prev)
                except OSError:
                    pass


__all__ = ["CheckpointCorruptError", "save_sharded", "load_sharded",
           "AutoCheckpoint"]
