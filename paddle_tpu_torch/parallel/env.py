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
    _STATE.update(initialized=True, device=device)
    return ParallelEnv()


def _release():
    if _world_up():
        dist.destroy_process_group()
    _STATE.update(initialized=False, device=None)


def get_backend() -> str:
    """The world's backend ('nccl' or 'gloo'), or None without a world."""
    return dist.get_backend() if _world_up() else None


def is_world() -> bool:
    """True when a process world of this package is up."""
    return _world_up()


__all__ = ["get_rank", "get_world_size", "ParallelEnv", "init_parallel_env",
           "get_backend", "is_world", "TIMEOUT"]
