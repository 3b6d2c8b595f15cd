"""Distributed launcher: one process per card.

    python -m paddle_tpu_torch.parallel.launch --nproc_per_node N script.py [args]
    python -m paddle_tpu_torch.parallel.launch --nproc_per_node 2 \\
        --backend gloo --device cpu script.py [args]

Counterpart of `paddle_tpu/parallel/launch.py`'s collective mode
(:86-130), with the flags of its `_parse` (:21). Each rank is a child
process with the launcher's environment: `PADDLE_TRAINER_ID`,
`PADDLE_TRAINERS_NUM`, `PADDLE_RANK_IN_NODE`, `PADDLE_CURRENT_ENDPOINT`,
`PADDLE_TRAINER_ENDPOINTS` (the first is the rendezvous of
`init_parallel_env`), `PADDLE_MASTER`, `FLAGS_selected_gpus` (the rank's
entry of `--gpus`, else its local rank), and `PADDLE_DISTRI_BACKEND` /
`PADDLE_DISTRI_DEVICE` when `--backend` / `--device` name them (CPU
ranks also get `OMP_NUM_THREADS=1` unless it is set, as torchrun does).

Every child is watched: when one exits non-zero the others are stopped
and the launcher exits with that code; when `--timeout` seconds pass
first, all are stopped and it exits 124 (no limit by default: a training
run may take days, and a rank that hangs in a collective fails at the
group's timeout). The `ps` and `elastic` run
modes are not ported (ROADMAP.md Queue 1: elastic with the
meta-optimizers and MoE, ps with the host-side distributed state).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gpu_list(gpus) -> Optional[List[str]]:
    if gpus is None or gpus == "":
        return None
    if isinstance(gpus, (list, tuple)):
        return [str(g) for g in gpus]
    return [g.strip() for g in str(gpus).split(",") if g.strip()]


def rank_envs(nproc: int, nnodes: int = 1, node_rank: int = 0,
              master: Optional[str] = None, gpus=None,
              backend: Optional[str] = None,
              device: Optional[str] = None) -> List[Dict[str, str]]:
    """The `PADDLE_*` environment of each local rank of this node."""
    world = nnodes * nproc
    if master is None:
        master = f"127.0.0.1:{free_port()}"
    host, port = master.rsplit(":", 1)
    # the first endpoint is the rendezvous; a rank's own endpoint is nominal
    eps = [master] + [f"{host}:{int(port) + r}" for r in range(1, world)]
    sel = _gpu_list(gpus)
    if sel is not None and len(sel) < nproc:
        raise ValueError(f"gpus {sel} names fewer cards than "
                         f"nproc_per_node={nproc}")
    envs = []
    for local in range(nproc):
        rank = node_rank * nproc + local
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(world),
               "PADDLE_RANK_IN_NODE": str(local),
               "PADDLE_CURRENT_ENDPOINT": eps[rank],
               "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
               "PADDLE_MASTER": master,
               "FLAGS_selected_gpus": sel[local] if sel else str(local)}
        if backend:
            env["PADDLE_DISTRI_BACKEND"] = backend
        if device:
            env["PADDLE_DISTRI_DEVICE"] = device
        if device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
            # ranks share the host's cores: one thread each (torchrun's
            # default), as spinning thread pools starve each other
            env["OMP_NUM_THREADS"] = "1"
        envs.append(env)
    return envs


def watch(procs: Sequence, timeout: Optional[float], poll_s: float = 0.1,
          stop=None) -> int:
    """Wait for every child: 0 when all exit 0; the first non-zero exit
    code (the others stopped); 124 when `timeout` seconds pass first (all
    stopped). `procs` have `poll()` -> exit code or None; `stop(p)` ends
    one."""
    stop = stop or (lambda p: p.kill())
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = [c for c in codes if c not in (None, 0)]
        if bad:
            for p, c in zip(procs, codes):
                if c is None:
                    stop(p)
            return bad[0]
        if all(c == 0 for c in codes):
            return 0
        if deadline is not None and time.monotonic() > deadline:
            for p, c in zip(procs, codes):
                if c is None:
                    stop(p)
            return 124
        time.sleep(poll_s)


def _parse(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.parallel.launch")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", 1)))
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", 0)))
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="host:port of the rendezvous (default: a free "
                        "port on 127.0.0.1)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--devices", "--gpus", dest="devices", default=None,
                   help="comma-separated card of each local rank")
    p.add_argument("--backend", default=None,
                   help="nccl | gloo (default: nccl on cards, gloo on the "
                        "CPU)")
    p.add_argument("--device", choices=("gpu", "cpu"), default=None,
                   help="cpu runs every rank on the CPU")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before every rank is stopped (exit 124)")
    p.add_argument("--run_mode", default="collective",
                   help="collective (ps and elastic are not ported)")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(argv=None) -> int:
    args = _parse(argv)
    if args.run_mode != "collective":
        raise NotImplementedError(
            f"launch --run_mode {args.run_mode}: the parameter-server and "
            "elastic modes are not ported yet (ROADMAP.md Queue 1: "
            "\"meta-optimizers, MoE and elastic\", \"the host-side "
            "distributed state\")")
    envs = rank_envs(args.nproc_per_node, args.nnodes, args.node_rank,
                     args.master, args.devices, args.backend, args.device)
    procs, logs = [], []
    try:
        for env in envs:
            out = None
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
                out = open(os.path.join(
                    args.log_dir, f"workerlog.{env['PADDLE_TRAINER_ID']}"),
                    "w")
                logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, args.training_script]
                + args.training_script_args,
                env=dict(os.environ, **env), stdout=out,
                stderr=subprocess.STDOUT if out else None))
        return watch(procs, args.timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()


if __name__ == "__main__":
    sys.exit(launch())
