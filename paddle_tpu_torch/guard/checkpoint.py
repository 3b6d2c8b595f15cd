"""Crash-atomic loop-state checkpoints of the training guard.

Counterpart of `paddle_tpu/guard/checkpoint.py`, on the commit discipline
and the CRC of `framework/sharded_io.py`, with the same files, so a guard
directory written by one package loads in the other:

  guard-meta.json        the commit record: the payload's name, its
                         whole-file CRC32, each array's dtype, the meta
  guard-state-v<N>.npz   the payload, one flat name -> array npz
  guard-meta.json.bak    the previous record, the fallback on corruption

The payload is written under a new versioned name (tmp + fsync + rename),
then the record replaces the previous one atomically: a crash at any
point leaves the previous record pointing at its intact payload. bf16 is
stored as its raw 2-byte values and re-viewed through the record's dtype
map. Fault sites: `guard.snapshot.write` (a torn payload) and
`guard.snapshot` (a crash between payload and commit).
"""
from __future__ import annotations

import glob
import io
import json
import os
import shutil
import warnings
from typing import Dict, Tuple

import numpy as np

from .. import faults as _faults
from .. import monitor as _monitor
from ..framework.io import atomic_write
from ..framework.sharded_io import (CheckpointCorruptError, _as_numpy, _crc,
                                   _np_dtype)

_META = "guard-meta.json"


def save_guard_state(dirname: str, arrays: Dict[str, object],
                     meta: dict) -> str:
    """Commit one loop-state generation of `arrays` (numpy arrays or
    torch tensors); returns the payload's path."""
    os.makedirs(dirname, exist_ok=True)
    mpath = os.path.join(dirname, _META)
    prev = _read_meta(mpath)
    version = int(prev.get("version", 0)) + 1 if prev else 1
    host, names = {}, {}
    for k, v in arrays.items():
        arr, names[k] = _as_numpy(v)
        host[k] = np.asarray(arr, order="C")     # 0-d stays 0-d
    buf = io.BytesIO()
    np.savez(buf, **host)
    data = buf.getvalue()
    state_file = f"guard-state-v{version}.npz"
    record = {"version": version, "state_file": state_file,
              "file_crc": _crc(data),  # of the intended bytes
              "dtypes": names, "meta": meta}
    if _faults._ENABLED:
        data = _faults.mangle("guard.snapshot.write", data)
    atomic_write(os.path.join(dirname, state_file), data)
    if _faults._ENABLED:
        _faults.check("guard.snapshot")
    if os.path.exists(mpath):  # keep one fallback generation
        shutil.copyfile(mpath, mpath + ".bak")
    atomic_write(mpath, json.dumps(record).encode())
    _gc(dirname, keep={state_file, prev.get("state_file", "")})
    if _monitor._ENABLED:
        _monitor.count("guard.checkpoints")
    return os.path.join(dirname, state_file)


def _read_meta(mpath: str) -> dict:
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _gc(dirname: str, keep) -> None:
    for path in glob.glob(os.path.join(dirname, "guard-state-v*.npz")):
        if os.path.basename(path) not in keep:
            try:
                os.remove(path)
            except OSError:
                pass


def _load_one(dirname: str, mpath: str
              ) -> Tuple[Dict[str, np.ndarray], dict]:
    record = _read_meta(mpath)
    if not record:
        raise CheckpointCorruptError(f"unreadable guard manifest {mpath}")
    path = os.path.join(dirname, record.get("state_file", ""))
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointCorruptError(
            f"missing guard state file {path}") from e
    if "file_crc" in record and _crc(raw) != record["file_crc"]:
        raise CheckpointCorruptError(
            f"guard state file {path} failed its checksum (torn/corrupt)")
    try:
        npz = np.load(io.BytesIO(raw))
        dtypes = record.get("dtypes", {})
        arrays = {}
        for key in npz.files:
            arr = npz[key]
            want = _np_dtype(dtypes[key]) if key in dtypes else arr.dtype
            if arr.dtype != want:  # bf16 / float8 stored as void bytes
                arr = np.ascontiguousarray(arr).view(want)
            arrays[key] = arr
    except Exception as e:
        raise CheckpointCorruptError(
            f"guard state file {path} is unreadable: {e}") from e
    return arrays, record.get("meta", {})


def load_guard_state(dirname: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """The newest intact generation (arrays, meta). Falls back to the
    previous committed generation on corruption (counting
    `guard.ckpt_fallbacks`, warning); raises FileNotFoundError when none
    was ever committed and CheckpointCorruptError when none is intact."""
    mpath = os.path.join(dirname, _META)
    if not os.path.exists(mpath) and not os.path.exists(mpath + ".bak"):
        raise FileNotFoundError(f"no guard checkpoint in {dirname}")
    try:
        return _load_one(dirname, mpath)
    except CheckpointCorruptError as e:
        bak = mpath + ".bak"
        if not os.path.exists(bak):
            raise
        if _monitor._ENABLED:
            _monitor.count("guard.ckpt_fallbacks")
        warnings.warn(f"guard checkpoint: {e}; falling back to the "
                      f"previous committed generation ({bak})")
        return _load_one(dirname, bak)


def has_guard_state(dirname: str) -> bool:
    mpath = os.path.join(dirname, _META)
    return os.path.exists(mpath) or os.path.exists(mpath + ".bak")


def guard_state_version(dirname: str) -> int:
    """The version of the committed generation (0: none)."""
    return int(_read_meta(os.path.join(dirname, _META)).get("version", 0))


def rollback_guard_state(dirname: str) -> int:
    """Promote the `.bak` generation to current, after verifying it;
    returns its version. CheckpointCorruptError when there is no intact
    fallback."""
    mpath = os.path.join(dirname, _META)
    bak = mpath + ".bak"
    if not os.path.exists(bak):
        raise CheckpointCorruptError(
            f"no fallback generation to roll back to in {dirname}")
    _load_one(dirname, bak)
    record = _read_meta(bak)
    atomic_write(mpath, json.dumps(record).encode())
    if _monitor._ENABLED:
        _monitor.count("guard.ckpt_rollbacks")
    return int(record.get("version", 0))
