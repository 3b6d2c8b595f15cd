"""Process-level distributed environment.

Counterpart of `paddle_tpu/parallel/env.py`: `get_rank`, `get_world_size`,
`ParallelEnv` and `init_parallel_env`, over the environment the launcher
writes (`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`,
`PADDLE_TRAINER_ENDPOINTS`, `PADDLE_RANK_IN_NODE`,
`PADDLE_CURRENT_ENDPOINT`).

The reference is one process per host; the port is one process per card.
`init_parallel_env` makes the `torch.distributed` world: the first
endpoint is the rendezvous (a `tcp://` init method), every group is made
with a timeout, so a rank that never arrives fails the others instead of
stalling them.

- Device: the card of this rank is the launcher's `FLAGS_selected_gpus`
  (the rank's entry of `gpus`), else its local rank. It is set as the
  current CUDA device and the current place before the group is made.
  `PADDLE_DISTRI_DEVICE=cpu` (the launcher's `--device cpu`), or a current
  place on the CPU, keeps the rank on the CPU.
- Backend: NCCL for a CUDA device, gloo for the CPU, or the one the caller
  named (`spawn(backend=...)`, the launcher's `--backend`), which arrives
  as `PADDLE_DISTRI_BACKEND`. A failed NCCL init raises; nothing falls
  back to gloo.
- With `PADDLE_TRAINERS_NUM` unset or 1 it does nothing, as the
  reference's does, unless the launcher named a backend for this process
  (a world of one, which still runs the backend's own path).
"""
from __future__ import annotations

import atexit
import datetime
import os
import sys

import torch
import torch.distributed as dist

from ..core.place import CPUPlace, get_place, set_device

# every process group is made with this timeout: a collective that a rank
# never joins fails within it
TIMEOUT = datetime.timedelta(seconds=60)

_STATE = {"initialized": False, "device": None}


def _world_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    if group is not None and hasattr(group, "rank"):
        return group.rank
    env = os.environ.get("PADDLE_TRAINER_ID")
    if env is not None:
        return int(env)
    return dist.get_rank() if _world_up() else 0


def get_world_size(group=None) -> int:
    if group is not None and hasattr(group, "nranks"):
        return group.nranks
    env = os.environ.get("PADDLE_TRAINERS_NUM")
    if env is not None:
        return int(env)
    return dist.get_world_size() if _world_up() else 1


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_RANK_IN_NODE", 0))

    @property
    def dev_id(self):
        sel = os.environ.get("FLAGS_selected_gpus")
        return int(sel.split(",")[0]) if sel else self.local_rank

    @property
    def device(self) -> torch.device:
        """This rank's device: the one `init_parallel_env` set, else the
        current place's."""
        return _STATE["device"] or get_place().torch_device()

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]


def _rank_device() -> torch.device:
    """The rank's device, set as the current device and place. Never
    chosen by probing: the launcher's gpus entry or the local rank."""
    if os.environ.get("PADDLE_DISTRI_DEVICE", "").lower() == "cpu":
        set_device("cpu")
    if isinstance(get_place(), CPUPlace):
        return torch.device("cpu")
    idx = ParallelEnv().dev_id
    set_device(f"gpu:{idx}")
    dev = get_place().torch_device()      # raises without a card
    torch.cuda.set_device(dev)
    return dev


def backend_for(device: torch.device) -> str:
    """The named backend (`PADDLE_DISTRI_BACKEND`), else NCCL for a CUDA
    device and gloo for the CPU."""
    named = os.environ.get("PADDLE_DISTRI_BACKEND")
    if named:
        return named.lower()
    return "nccl" if device.type == "cuda" else "gloo"


def init_parallel_env(strategy=None):
    """Bring up the process world from the launcher's environment and
    return a ParallelEnv. A no-op for a single process the launcher did
    not start as a world (see the module docstring), and on a second
    call."""
    if _STATE["initialized"]:
        return ParallelEnv()
    nproc = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    named = os.environ.get("PADDLE_DISTRI_BACKEND")
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS")
    if not eps or (nproc <= 1 and not named):
        _STATE["initialized"] = True
        return ParallelEnv()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    device = _rank_device()
    backend = backend_for(device)
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError("init_parallel_env: the NCCL backend needs a "
                           "CUDA device; this rank is on the CPU")
    # NCCL with device_id makes its communicator now: one that cannot be
    # made fails here
    kwargs = {"device_id": device} if backend == "nccl" else {}
    if not _world_up():
        dist.init_process_group(
            backend, init_method=f"tcp://{eps.split(',')[0]}", rank=rank,
            world_size=nproc, timeout=TIMEOUT, **kwargs)
        atexit.register(_release)
        if not hasattr(sys.exit, "_paddle_exit"):
            sys.exit = _recording_exit(sys.exit)
    _STATE.update(initialized=True, device=device)
    return ParallelEnv()


# how long a rank leaving the world waits for its peers at each of the
# two exit rendezvous (a peer that died is not waited for past it)
_EXIT_WAIT_S = 20.0

# the code this process last asked `sys.exit` for (None: it did not)
_EXIT = {"code": None}


def _recording_exit(exit_):
    def exit(code=None):
        _EXIT["code"] = code
        exit_(code)
    exit._paddle_exit = True
    return exit


def _failing() -> bool:
    """Whether this process is leaving on an uncaught exception or a
    non-zero `sys.exit` (a `raise SystemExit(n)` of the script's own is
    not seen: it waits at the rendezvous as a clean exit does)."""
    return getattr(sys, "last_exc", None) is not None or \
        getattr(sys, "last_value", None) is not None or \
        _EXIT["code"] not in (None, 0)


def _store_wait_count(store, key: str, n: int, deadline: float) -> None:
    import time
    while int(store.add(key, 0)) < n and time.monotonic() < deadline:
        time.sleep(0.005)


def _release():
    """Leave the world in order (at exit). Rank 0 hosts the rendezvous
    store that every rank's groups (the world's and each `new_group`'s)
    were made through; a peer still tearing its groups down when that
    store's server goes away aborts in C++ (exit 250), and a rank that
    tears its groups down while a peer is still working in them can
    abort that peer ("terminate called without an active exception").
    So: every rank arrives before any tears down, and rank 0 keeps the
    store up until every peer has said that its teardown is done. Each
    wait is bounded by `_EXIT_WAIT_S`. A failing process (`_failing`)
    waits for nobody: its peers may be blocked on it in a collective, and
    its failure must show at once."""
    import time
    if _world_up():
        world, rank = dist.get_world_size(), dist.get_rank()
        store = None
        if world > 1 and not _failing():
            try:
                store = dist.distributed_c10d._get_default_store()
                store.add("paddle_exit/arrived", 1)
                _store_wait_count(store, "paddle_exit/arrived", world,
                                  time.monotonic() + _EXIT_WAIT_S)
            except Exception:       # a peer or the store is gone
                store = None
        dist.destroy_process_group()
        if store is not None:
            try:
                if rank != 0:
                    store.add("paddle_exit/done", 1)
                else:
                    _store_wait_count(store, "paddle_exit/done", world - 1,
                                      time.monotonic() + _EXIT_WAIT_S)
            except Exception:
                pass
    _STATE.update(initialized=False, device=None)


def get_backend() -> str:
    """The world's backend ('nccl' or 'gloo'), or None without a world."""
    return dist.get_backend() if _world_up() else None


def is_world() -> bool:
    """True when a process world of this package is up."""
    return _world_up()


__all__ = ["get_rank", "get_world_size", "ParallelEnv", "init_parallel_env",
           "get_backend", "is_world", "TIMEOUT"]
