"""Process/device topology -> a device mesh.

Counterpart of `paddle_tpu/parallel/topology.py`: `CommunicateTopology`,
`HybridCommunicateGroup` (same degrees, axis order and names, :58-86),
`create_mesh`, `get_mesh`/`set_mesh`/`use_mesh` and
`get_hybrid_communicate_group`.

The JAX package is single-controller: one process holds every shard of a
`jax.sharding.Mesh` ("rank-free programming model", :84). The port keeps
that design over its own small `Mesh`: a numpy object array of
`torch.device`s with axis names, on which `parallel.sp` places one shard
per slot and moves blocks between slots with `Tensor.to`. Slots may name
one device more than once (four slots over `cuda:0` run on one card the
per-hop work that each card of a four-card ring would do) or four cards
(peer copies, no code change). Such slots are only made when the caller
passes them: the default devices are the visible CUDA devices, or the CPU
when the current place is the CPU.

Over a process world (`init_parallel_env`, one process per card) and with
no `devices` given, `HybridCommunicateGroup` is the reference Paddle's:
the ranks map to coordinates in `CommunicateTopology`'s order (data,
pipe, sharding, model), each axis has a real `collective.Group`, and the
rank's coordinates answer `get_data_parallel_rank()`, `get_stage_id()`,
`get_model_parallel_rank()` and the like. There dp x pp x sharding x mp
must equal the world size; a sequence degree above 1 across processes
raises NotImplementedError (ROADMAP.md Queue 1, "sp across processes").
Besides the four axes' groups it makes the group of the data axes (the
ranks that share this rank's pipe and model coordinates:
`get_data_axes_group()`), over which a stage's gradients are averaged.
Every slot of its mesh names this process's device (the one it can
address).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.place import CPUPlace, get_place, resolve_device

_GLOBAL_HCG = [None]
_GLOBAL_MESH = [None]


class Mesh:
    """`devices`: an array (any shape) of device specs (`torch.device`,
    'cpu', 'cuda:0', 'gpu:1', Place); `axis_names`: one name per axis.
    Every device is resolved when the mesh is made, so a `cuda` slot on a
    machine without a card raises `UnavailableError` here."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        for i, d in enumerate(arr.reshape(-1)):
            flat[i] = resolve_device(d)
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (as `jax.sharding.Mesh.shape`)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis_name) -> list:
        """The devices along `axis_name`, at index 0 of every other axis."""
        ax = self.axis_names.index(axis_name)
        line = np.moveaxis(self.devices, ax, -1).reshape(-1,
                                                         self.devices.shape[ax])
        return list(line[0])

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def _default_devices() -> list:
    """The visible CUDA devices, or the CPU when the current place is the
    CPU; with neither, resolving the place raises UnavailableError."""
    if isinstance(get_place(), CPUPlace):
        return [torch.device("cpu")]
    resolve_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coords, self._dims))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))


# the paddle axis names beside the mesh's
_AXIS_ALIAS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
               "model": "mp", "sep": "sp"}


class HybridCommunicateGroup:
    """Builds the device mesh for the hybrid strategy.

    Axis order (outer -> inner): dp, pp, sharding, mp[, sp], as in the
    reference."""

    def __init__(self, strategy=None, hybrid_configs: Optional[Dict] = None,
                 devices=None):
        cfg = hybrid_configs or (strategy.hybrid_configs if strategy else {})
        self.dp_degree = int(cfg.get("dp_degree", 1))
        self.pp_degree = int(cfg.get("pp_degree", 1))
        self.sharding_degree = int(cfg.get("sharding_degree", 1))
        self.mp_degree = int(cfg.get("mp_degree", 1))
        self.sp_degree = int(cfg.get("sp_degree", 1))
        self.process_mode = False
        self._groups = {}
        from .env import is_world
        if devices is None and is_world():
            self._init_process_world()
            return

        devices = list(devices) if devices is not None else _default_devices()
        need = (self.dp_degree * self.pp_degree * self.sharding_degree *
                self.mp_degree * self.sp_degree)
        if need > len(devices):
            raise ValueError(f"hybrid config needs {need} devices, have {len(devices)}")
        devices = devices[:need]

        self._axis_names = ["dp", "pp", "sharding", "mp"]
        dims = [self.dp_degree, self.pp_degree, self.sharding_degree, self.mp_degree]
        if self.sp_degree > 1:
            self._axis_names.append("sp")
            dims.append(self.sp_degree)
        mesh_arr = np.empty(need, dtype=object)
        mesh_arr[:] = devices
        self.mesh = Mesh(mesh_arr.reshape(dims), tuple(self._axis_names))
        self.topology = CommunicateTopology(
            ("data", "pipe", "sharding", "model") + (("sep",) if self.sp_degree > 1 else ()),
            dims)
        self.global_rank = 0  # single controller: rank-free programming model
        _GLOBAL_HCG[0] = self
        _GLOBAL_MESH[0] = self.mesh

    def _init_process_world(self):
        """The hybrid topology over the ranks of the process world."""
        import torch.distributed as dist
        from . import collective
        from .env import ParallelEnv
        world, rank = dist.get_world_size(), dist.get_rank()
        if self.sp_degree > 1:
            raise NotImplementedError(
                f"sp_degree={self.sp_degree} across processes: sequence "
                "parallelism runs over the slots of one process's mesh "
                "(ROADMAP.md Queue 1, \"sp across processes\")")
        if self.dp_degree * self.pp_degree * self.sharding_degree * \
                self.mp_degree == 1 and world > 1:
            self.dp_degree = world          # paddle's default: pure DP
        dims = [self.dp_degree, self.pp_degree, self.sharding_degree,
                self.mp_degree]
        if int(np.prod(dims)) != world:
            raise ValueError(
                f"dp_degree {self.dp_degree} x pp_degree {self.pp_degree} x "
                f"sharding_degree {self.sharding_degree} x mp_degree "
                f"{self.mp_degree} must equal the world size {world}")
        self.process_mode = True
        names = ("dp", "pp", "sharding", "mp")
        self._axis_names = list(names)
        self.topology = CommunicateTopology(
            ("data", "pipe", "sharding", "model"), dims)
        self.global_rank = rank
        self._coord = self.topology.get_coord(rank)
        for ax, name in enumerate(names):
            self._groups[name] = self._axes_group(dims, (ax,), name)
        self._groups["data_axes"] = self._axes_group(dims, (0, 2),
                                                     "data_axes")
        self._groups["sp"] = collective.Group([rank], None, axis_name="sp")
        device = ParallelEnv().device
        slots = np.empty(int(np.prod(dims)), dtype=object)
        slots[:] = [device] * slots.size
        self.mesh = Mesh(slots.reshape(dims), names)
        _GLOBAL_HCG[0] = self
        _GLOBAL_MESH[0] = self.mesh

    def _axes_group(self, dims, axes, name):
        """This rank's group along the mesh `axes` (the ranks that share
        its coordinates on every other axis). Every rank makes every group
        of the axes, in one order, as `new_group` requires."""
        import torch.distributed as dist
        from . import collective
        world, rank = dist.get_world_size(), dist.get_rank()
        size = int(np.prod([dims[a] for a in axes]))
        if size == world:
            return collective.Group(range(world), dist.group.WORLD,
                                    axis_name=name)
        if size == 1:
            return collective.Group([rank], None, axis_name=name)
        rest_axes = [a for a in range(len(dims)) if a not in axes]
        mine = None
        for rest in np.ndindex(*[dims[a] for a in rest_axes]):
            ranks = []
            for inner in np.ndindex(*[dims[a] for a in axes]):
                coord = [0] * len(dims)
                for a, c in zip(rest_axes, rest):
                    coord[a] = c
                for a, c in zip(axes, inner):
                    coord[a] = c
                ranks.append(int(np.ravel_multi_index(coord, dims)))
            g = collective.new_group(ranks, axis_name=name)
            if rank in ranks:
                mine = g
        return mine

    def axis_group(self, name):
        """The process-world group of a mesh axis ('dp', 'sharding', ...,
        or paddle's 'data', 'model', ...); None outside a process world."""
        return self._groups.get(_AXIS_ALIAS.get(name, name))

    def get_mesh(self) -> Mesh:
        return self.mesh

    # ---- paddle API parity ----
    def get_parallel_mode(self):
        if self.pp_degree > 1:
            return "pipeline"
        if self.sharding_degree > 1:
            return "sharding"
        if self.mp_degree > 1:
            return "tensor"
        return "data"

    def get_data_parallel_world_size(self):
        return self.dp_degree

    def get_model_parallel_world_size(self):
        return self.mp_degree

    def get_pipe_parallel_world_size(self):
        return self.pp_degree

    def get_sharding_parallel_world_size(self):
        return self.sharding_degree

    def get_sep_parallel_world_size(self):
        return self.sp_degree

    def _coord_of(self, ax):
        return self._coord[ax] if self.process_mode else 0

    def get_data_parallel_rank(self):
        return self._coord_of(0)

    def get_sharding_parallel_rank(self):
        return self._coord_of(2)

    def get_model_parallel_rank(self):
        return self._coord_of(3)

    def get_stage_id(self):
        return self._coord_of(1)

    def _group(self, name):
        return self._groups[name] if self.process_mode else name

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_data_axes_group(self):
        """The ranks of this rank's stage and model slice along the data
        axes (dp x sharding)."""
        return self._group("data_axes")

    def get_check_parallel_group(self):
        return None


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _GLOBAL_HCG[0]


def set_mesh(mesh: Mesh):
    _GLOBAL_MESH[0] = mesh


def get_mesh() -> Optional[Mesh]:
    return _GLOBAL_MESH[0]


class use_mesh:
    """Context manager scoping the active mesh."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh

    def __enter__(self):
        self._prev = _GLOBAL_MESH[0]
        _GLOBAL_MESH[0] = self._mesh
        return self._mesh

    def __exit__(self, *exc):
        _GLOBAL_MESH[0] = self._prev
        return False


def create_mesh(shape: Dict[str, int], devices=None) -> Mesh:
    """Direct mesh construction: create_mesh({'sp': 4}, devices=[...])."""
    devices = list(devices) if devices is not None else _default_devices()
    dims = list(shape.values())
    n = int(np.prod(dims))
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    mesh = Mesh(arr.reshape(dims), tuple(shape.keys()))
    _GLOBAL_MESH[0] = mesh
    return mesh


__all__ = ["Mesh", "CommunicateTopology", "HybridCommunicateGroup",
           "create_mesh", "get_mesh", "set_mesh", "use_mesh",
           "get_hybrid_communicate_group"]
