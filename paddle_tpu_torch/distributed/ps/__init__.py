"""Parameter-server tier (CTR/recommendation workload class).

Counterpart of `paddle_tpu/distributed/ps/__init__.py` (Paddle's python
runtime facade `distributed/ps/the_one_ps.py` over the C++ PS, plus
`distributed_lookup_table_op` as the trainer-side sparse pull/push op).

The split: sparse embedding tables live on CPU PS hosts (numpy tables
behind `PsServer`, or the C++ `NativePsServer`); the trainer pulls just
the batch's rows onto its card, runs the DENSE model there, and pushes the
row gradients back, asynchronously through the `Communicator` or
synchronously — the DownpourWorker dataflow.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .table import DenseTable, SparseTable  # noqa: F401
from .service import (Communicator, CommunicatorFlushTimeout,  # noqa: F401
                      PsClient, PsError, PsServer)
from .native import NativePsServer  # noqa: F401
from .wal import PsSnapshotUnsupportedError, SeqLedger, WalWriter  # noqa: F401
from .ha import HaPsNode, connect as ha_connect_client  # noqa: F401
from .delta import DeltaBatch, DeltaSubscriber, rpc_delta  # noqa: F401
from ... import monitor as _monitor


class PsContext:
    """the_one_ps-style runtime facade driven by TRAINING_ROLE env."""

    def __init__(self):
        self.role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self.server_endpoints = [e for e in eps.split(",") if e]
        self.server: Optional[PsServer] = None
        self.client: Optional[PsClient] = None
        self.communicator: Optional[Communicator] = None

    def is_server(self):
        return self.role == "PSERVER"

    def init_server(self, host="127.0.0.1", port=0) -> PsServer:
        self.server = PsServer(host, port)
        return self.server

    def run_server(self, block=False):
        return self.server.run(block=block)

    def init_worker(self, endpoints=None) -> PsClient:
        # re-read the env each time: the documented flow sets
        # PADDLE_PSERVERS_IP_PORT_LIST AFTER the server binds its port
        if endpoints is not None:
            self.server_endpoints = list(endpoints)
        else:
            eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
            parsed = [e for e in eps.split(",") if e]
            if parsed:
                self.server_endpoints = parsed
        if not self.server_endpoints:
            raise RuntimeError(
                "init_worker: no PS endpoints — set "
                "PADDLE_PSERVERS_IP_PORT_LIST or pass endpoints=")
        self.client = PsClient(self.server_endpoints)
        self.communicator = Communicator(self.client)
        return self.client

    def stop_worker(self):
        try:
            if self.communicator is not None:
                self.communicator.stop()
        finally:
            if self.client is not None:
                self.client.close()


def _observe(name: str, t0: float) -> float:
    t1 = time.perf_counter()
    _monitor.observe(name, t1 - t0)
    return t1


class _Lookup(torch.autograd.Function):
    """The pulled rows as an autograd node whose backward pushes the row
    gradients (the reference records a tape node with no inputs; here the
    node hangs off a 0-d requires-grad anchor, which gets no gradient)."""

    @staticmethod
    def forward(ctx, anchor, rows, push):
        ctx.push = push
        return rows

    @staticmethod
    def backward(ctx, g):
        ctx.push(g)
        return None, None, None


class DistributedEmbedding:
    """Sparse embedding backed by a PS sparse table
    (`distributed_lookup_table_op` role).

    forward: pull rows for the batch ids (host RPC) -> a tensor on the
    current place's device at construction (`cuda` unless the caller
    asked for the CPU with `set_device("cpu")`); backward: the gradient
    comes back to the host and is pushed to the PS, once per backward,
    through the async Communicator when one is given, else synchronously
    (the DownpourWorker push_gradients path). Nothing is pushed under
    `no_grad`.

    Under FLAGS_monitor the four host legs are observed as
    `ps.embedding.pull` / `.h2d` / `.d2h` / `.push` (seconds); the D2H
    leg first waits for the stream, so it times the copy alone."""

    def __init__(self, client: PsClient, table: str, dim: int,
                 communicator: Optional[Communicator] = None):
        from ...core.place import resolve_device
        self.client = client
        self.table = table
        self.dim = dim
        self.communicator = communicator
        self.device = resolve_device()
        client.register_sparse_dim(table, dim)

    def __call__(self, ids):
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        ids_np = np.asarray(ids, np.int64)
        flat = ids_np.reshape(-1)
        mon = _monitor._ENABLED
        t0 = time.perf_counter() if mon else 0.0
        rows = self.client.pull_sparse(self.table, flat)  # [N, dim] host
        if mon:
            t0 = _observe("ps.embedding.pull", t0)
        out = torch.from_numpy(rows.reshape(*ids_np.shape, self.dim)).to(
            self.device)
        if mon:
            if out.is_cuda:
                torch.cuda.current_stream(out.device).synchronize()
            _observe("ps.embedding.h2d", t0)
        if not torch.is_grad_enabled():
            return out
        client, table, comm, dim = (self.client, self.table,
                                    self.communicator, self.dim)

        def push(g):
            mon = _monitor._ENABLED
            if mon and g.is_cuda:
                torch.cuda.current_stream(g.device).synchronize()
            t0 = time.perf_counter() if mon else 0.0
            g_np = g.detach().to("cpu", torch.float32).numpy().reshape(
                len(flat), dim)
            if mon:
                t0 = _observe("ps.embedding.d2h", t0)
            if comm is not None:
                comm.push_sparse_async(table, flat, g_np)
            else:
                client.push_sparse(table, flat, g_np)
            if mon:
                _observe("ps.embedding.push", t0)

        anchor = torch.zeros((), device=out.device, requires_grad=True)
        return _Lookup.apply(anchor, out, push)
