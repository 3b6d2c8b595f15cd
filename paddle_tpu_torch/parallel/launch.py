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
group's timeout).

    python -m paddle_tpu_torch.parallel.launch --run_mode elastic \
        --nproc_per_node 2 --max_restarts 3 script.py [args]

runs the gang under `elastic.launch_elastic` (reference :86-96): a rank
exiting non-zero stops the gang, which is relaunched as a unit (with
`PADDLE_ELASTIC_RESTART_COUNT` counting the launches) up to
`--max_restarts` times; the launcher exits 0 when a launch succeeded,
else 1. `--timeout` bounds each launch there.

    python -m paddle_tpu_torch.parallel.launch --run_mode ps \
        --server_num 1 --worker_num 2 script.py [args]

runs the parameter-server gang (reference :45-77, Paddle's launch_ps):
`--server_num` servers (or the `--servers` host:port list; by default
free ports on 127.0.0.1) with `TRAINING_ROLE=PSERVER`, `PADDLE_PORT` and
`POD_IP`, and `--worker_num` trainers with `TRAINING_ROLE=TRAINER` and
`PADDLE_TRAINER_ID`; all get `PADDLE_PSERVERS_IP_PORT_LIST` and
`PADDLE_TRAINERS_NUM`. The launcher watches the trainers as a gang (a
failure or `--timeout` stops them all) and stops the servers when they
are done; its exit code is the trainers'. Giving `--server_num`,
`--servers` or `--worker_num` selects this mode, as the reference's
`which_distributed_mode` does.
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
    p.add_argument("--run_mode", default=None,
                   help="collective (default) | ps | elastic")
    p.add_argument("--server_num", type=int, default=0,
                   help="ps: servers on free local ports")
    p.add_argument("--worker_num", type=int, default=0,
                   help="ps: trainers (default 1)")
    p.add_argument("--servers", default="",
                   help="ps: the servers' host:port list")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="elastic: relaunches of the gang after a failure")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.run_mode is None:
        args.run_mode = "ps" if (args.server_num or args.servers
                                 or args.worker_num) else "collective"
    return args


def ps_envs(endpoints: Sequence[str], n_workers: int,
            device: Optional[str] = None):
    """(the servers' environments, the trainers' environments) of a PS
    gang over `endpoints`."""
    common = {"PADDLE_PSERVERS_IP_PORT_LIST": ",".join(endpoints),
              "PADDLE_TRAINERS_NUM": str(n_workers)}
    if device:
        common["PADDLE_DISTRI_DEVICE"] = device
    if device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        common["OMP_NUM_THREADS"] = "1"
    servers = [dict(common, TRAINING_ROLE="PSERVER",
                    PADDLE_PORT=ep.rsplit(":", 1)[1],
                    POD_IP=ep.rsplit(":", 1)[0]) for ep in endpoints]
    trainers = [dict(common, TRAINING_ROLE="TRAINER",
                     PADDLE_TRAINER_ID=str(r)) for r in range(n_workers)]
    return servers, trainers


def _launch_ps(args) -> int:
    if args.servers:
        endpoints = [e for e in args.servers.split(",") if e]
    else:
        endpoints = [f"127.0.0.1:{free_port()}"
                     for _ in range(max(args.server_num, 1))]
    server_envs, trainer_envs = ps_envs(endpoints, args.worker_num or 1,
                                        args.device)
    servers, trainers, logs = [], [], []

    def start(env, name):
        out = None
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            out = open(os.path.join(args.log_dir, name), "w")
            logs.append(out)
        return subprocess.Popen(
            [sys.executable, args.training_script]
            + args.training_script_args,
            env=dict(os.environ, **env), stdout=out,
            stderr=subprocess.STDOUT if out else None)

    try:
        for i, env in enumerate(server_envs):
            servers.append(start(env, f"serverlog.{i}"))
        for r, env in enumerate(trainer_envs):
            trainers.append(start(env, f"trainerlog.{r}"))
        return watch(trainers, args.timeout)
    finally:
        # the trainers are done: stop the servers (reference behaviour)
        for p in servers:
            if p.poll() is None:
                p.terminate()
        for p in servers + trainers:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()


def launch(argv=None) -> int:
    args = _parse(argv)
    if args.run_mode == "elastic":
        from .elastic import launch_elastic
        res = launch_elastic(
            args.training_script, args.training_script_args,
            nprocs=max(args.nproc_per_node, 1),
            max_restarts=args.max_restarts,
            timeout=args.timeout,
            backend=args.backend, device=args.device, gpus=args.devices,
            log_dir=args.log_dir)
        return 0 if res.success else 1
    if args.run_mode == "ps":
        return _launch_ps(args)
    if args.run_mode != "collective":
        raise ValueError(f"launch: unknown --run_mode {args.run_mode!r} "
                         "(collective | ps | elastic)")
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
