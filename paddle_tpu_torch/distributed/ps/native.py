"""Native (C++) PS server facade.

Counterpart of `paddle_tpu/distributed/ps/native.py` (Paddle's
`ps/service/brpc_ps_server.cc`: the PS data plane is native C++): the
repo's one `csrc/ps_server.cpp`, built as it is by `_native.load_ps()`
(g++, a library named by the source's hash; a failed build raises), speaks
the python `PsServer`'s wire through the ctypes bridge. A cluster may mix
python and native servers; the python `PsClient` drives both unchanged.

Scope: the high-QPS data plane — sgd/adagrad/adam sparse+dense tables
with per-row optimizer slots, the CTR accessor (show/click stats, time
decay, TTL/score shrink), barrier, error frames, and remote table-config
negotiation. SSD spill and save/load remain python-tier features
(`service.PsServer`).
"""
from __future__ import annotations

import ctypes

from ... import _native
from .table import dense_shard_range


class NativePsServer:
    """C++ parameter server bound to 127.0.0.1:<port> (0 = ephemeral)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        # teardown-safe defaults FIRST: __del__ runs even when __init__
        # raises (no toolchain, bind failure), so every attribute stop()
        # touches must already exist
        import threading
        self._h = None
        self._lib = None
        self._stopped = threading.Event()
        if host not in ("127.0.0.1", "localhost"):
            raise ValueError(
                "NativePsServer binds loopback only for now; front a "
                f"non-loopback host ({host!r}) with the python PsServer")
        lib = _native.load_ps()
        self._lib = lib
        out_port = ctypes.c_int(0)
        self._h = lib.ps_native_server_start(int(port),
                                             ctypes.byref(out_port))
        if not self._h:
            raise RuntimeError("native PS server failed to bind")
        self.host = host
        self.port = int(out_port.value)

    def add_sparse_table(self, name: str, dim: int, lr: float = 0.01,
                         init_std: float = 0.01, seed: int = 0,
                         optimizer: str = "sgd", accessor=None,
                         beta1: float = 0.9, beta2: float = 0.999,
                         eps: float = 1e-8, show_decay_rate: float = 0.98,
                         click_coeff: float = 8.0,
                         delete_threshold: float = 0.8,
                         ttl_days: float = 30.0):
        from .table import OPT_WIRE_IDS as opt_ids
        if optimizer not in opt_ids:
            raise NotImplementedError(
                f"native PS optimizer {optimizer!r} (have {sorted(opt_ids)})")
        if accessor not in (None, "ctr"):
            raise TypeError(f"unknown accessor {accessor!r}")
        rc = self._lib.ps_native_add_sparse_v2(
            self._h, name.encode(), int(dim), float(lr), float(init_std),
            int(seed), opt_ids[optimizer], float(beta1), float(beta2),
            float(eps), 1 if accessor == "ctr" else 0,
            float(show_decay_rate), float(click_coeff),
            float(delete_threshold), float(ttl_days))
        if rc == -2:
            raise ValueError(f"table {name!r} already registered")
        if rc != 0:
            raise ValueError(f"add_sparse_table({name!r}) failed")

    def add_dense_table(self, name: str, shape, lr: float = 0.01,
                        shard=None, optimizer: str = "sgd",
                        beta1: float = 0.9, beta2: float = 0.999,
                        eps: float = 1e-8):
        from .table import OPT_WIRE_IDS as opt_ids
        if optimizer not in opt_ids:
            raise NotImplementedError(
                f"native PS optimizer {optimizer!r} (have {sorted(opt_ids)})")
        import numpy as np
        total = int(np.prod(shape))
        if shard is not None:
            i, n = shard
            if not 0 <= i < n:
                raise ValueError(f"dense shard index {i} out of range for "
                                 f"{n} shards")
            lo, hi = dense_shard_range(total, i, n)
        else:
            lo, hi = 0, total
        rc = self._lib.ps_native_add_dense_v2(
            self._h, name.encode(), hi - lo, float(lr), lo, total,
            opt_ids[optimizer], float(beta1), float(beta2), float(eps))
        if rc == -2:
            raise ValueError(f"table {name!r} already registered")
        if rc != 0:
            raise ValueError(f"add_dense_table({name!r}) failed")

    def run(self, block: bool = False):
        # the accept loop starts at construction; block=True keeps the
        # caller alive until stop() (python PsServer.run parity)
        if block:
            self._stopped.wait()
        return self

    def stop(self):
        # shutdown-before-close (PsServer.stop() ordering): wake blocked
        # run() callers BEFORE the native handle is freed, so none of
        # them can observe a half-torn-down server
        self._stopped.set()
        h, self._h = self._h, None
        if h and self._lib is not None:
            self._lib.ps_native_server_stop(h)

    def __del__(self):
        try:
            if getattr(self, "_h", None) is not None:
                self.stop()
        except Exception:
            pass
