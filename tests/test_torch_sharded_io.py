"""`paddle_tpu_torch.framework.sharded_io` against the JAX package's
`framework.sharded_io`: one directory layout (manifest, per-shard CRC32s,
the `.bak` generation), so a checkpoint written by either loads in the
other with identical arrays (bf16 included, bit for bit); a torn payload
falls back to the previous generation, `CheckpointCorruptError` when no
generation is intact, and `AutoCheckpoint` resumes at the first epoch that
was not committed, as the reference's does."""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from paddle_tpu import faults as jfaults
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.framework import sharded_io as jio
from paddle_tpu.parallel.topology import create_mesh
import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.framework import sharded_io as tio


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _state():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(8, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "step": np.array(7, np.int64),
            "h": rng.normal(size=(4, 6)).astype(np.float16)}


def _bf16_bits(a):
    """The raw 16-bit values of a bf16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.ascontiguousarray(a).view(np.int16)


def test_a_jax_checkpoint_loads_in_the_port(tmp_path):
    state = _state()
    mesh = create_mesh({"dp": 2, "mp": 4})
    sharding = NamedSharding(mesh, P("dp", "mp"))
    # a Tensor over a sharded array: the reference writes its 8 shards
    jstate = {"w": JTensor(jax.device_put(state["w"], sharding)),
              "b": state["b"],
              "step": state["step"], "h": state["h"],
              "bf": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) * 0.3}
    jio.save_sharded(jstate, str(tmp_path))
    manifest = json.load(open(tmp_path / "manifest-p0.json"))
    assert len(manifest["arrays"]["w"]["shards"]) == 8   # the mesh's shards
    got = tio.load_sharded(str(tmp_path))
    for k in ("w", "b", "step", "h"):
        assert got[k].dtype == state[k].dtype
        np.testing.assert_array_equal(got[k], state[k])
    on = tio.load_sharded(str(tmp_path), shardings="cpu")
    assert on["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(on["bf"]),
                                  _bf16_bits(np.asarray(jstate["bf"])))
    some = tio.load_sharded(str(tmp_path), shardings={"w": "cpu"})
    assert isinstance(some["w"], torch.Tensor) and \
        isinstance(some["b"], np.ndarray)
    np.testing.assert_array_equal(some["w"].numpy(), state["w"])


def test_a_port_checkpoint_loads_in_the_jax_package(tmp_path):
    state = _state()
    bf = torch.arange(12, dtype=torch.float32).reshape(3, 4).bfloat16() * 0.3
    tio.save_sharded({"w": torch.from_numpy(state["w"]), "b": state["b"],
                      "step": torch.tensor(7), "h": state["h"], "bf": bf},
                     str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["manifest-p0.json",
                                            "shards-p0-v1.npz"]
    got = jio.load_sharded(str(tmp_path))
    for k in ("w", "b", "step", "h"):
        assert got[k].dtype == state[k].dtype
        np.testing.assert_array_equal(got[k], state[k])
    assert str(got["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(_bf16_bits(got["bf"]), _bf16_bits(bf))
    # the same manifest bytes the reference writes for the same state
    jdir = tmp_path / "jax"
    jio.save_sharded({"w": state["w"], "b": state["b"], "h": state["h"]},
                     str(jdir))
    tdir = tmp_path / "port"
    tio.save_sharded({"w": state["w"], "b": state["b"], "h": state["h"]},
                     str(tdir))
    mj, mt = (json.load(open(d / "manifest-p0.json")) for d in (jdir, tdir))
    # the npz's zip headers carry the time of writing: not its CRC
    mj.pop("file_crc"), mt.pop("file_crc")
    assert mj == mt


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_torn_payload_falls_back_to_the_previous_generation(tmp_path,
                                                               writer):
    """A torn second generation (the `ckpt.write` fault of the package
    that wrote it) loads as the first in both packages."""
    _flags.set_flags({"monitor": True})
    monitor.reset()
    try:
        first = {"w": np.arange(6, dtype=np.float32)}
        second = {"w": np.full(6, 9.0, np.float32)}
        io_, fl = (tio, faults) if writer == "port" else (jio, jfaults)
        io_.save_sharded(first, str(tmp_path))
        with fl.inject("ckpt.write:torn:times=1"):
            io_.save_sharded(second, str(tmp_path))
        for loader in (tio, jio):
            with pytest.warns(UserWarning, match="falling back"):
                got = loader.load_sharded(str(tmp_path))
            np.testing.assert_array_equal(got["w"], first["w"])
        assert monitor.counter("ckpt.fallbacks").get() == 1
    finally:
        monitor.reset()
        _flags.set_flags({"monitor": False})


def test_no_intact_generation_raises(tmp_path):
    tio.save_sharded({"w": np.ones(4, np.float32)}, str(tmp_path))
    shard = tmp_path / "shards-p0-v1.npz"
    shard.write_bytes(shard.read_bytes()[:40])
    for loader in (tio, jio):
        with pytest.raises(loader.CheckpointCorruptError):
            loader.load_sharded(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tio.load_sharded(str(tmp_path / "nope"))
    # a crash between the payload and the commit keeps the previous one
    with faults.inject("ckpt.commit:error:times=1"):
        with pytest.raises(faults.InjectedFault):
            tio.save_sharded({"w": np.zeros(4, np.float32)},
                             str(tmp_path / "c"))
    assert not os.path.exists(tmp_path / "c" / "manifest-p0.json")


def test_generations_are_collected_and_process_index_names_the_files(
        tmp_path):
    for v in range(3):
        tio.save_sharded({"w": np.full(2, v, np.float32)}, str(tmp_path),
                         process_index=1)
    assert sorted(os.listdir(tmp_path)) == [
        "manifest-p1.json", "manifest-p1.json.bak", "shards-p1-v2.npz",
        "shards-p1-v3.npz"]
    for loader in (tio, jio):
        np.testing.assert_array_equal(loader.load_sharded(
            str(tmp_path))["w"], np.full(2, 2.0, np.float32))


def _acp_run(io_, d, state, log, tag, stop_after=None):
    def save_fn(path):
        os.makedirs(path, exist_ok=True)
        io_.save_sharded({"w": np.asarray(state["w"], np.float32)}, path,
                         process_index=0)

    def load_fn(path):
        state["w"] = float(io_.load_sharded(path)["w"])

    acp = io_.AutoCheckpoint(d, save_fn, load_fn)
    for epoch in acp.train_epoch_range(5):
        state["w"] += 1.0
        log.append((tag, epoch))
        if epoch == stop_after:
            break   # killed inside the epoch: its snapshot never lands
    return acp


@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"),
                                          ("port", "jax")])
def test_auto_checkpoint_resume_matches_the_reference(tmp_path, first,
                                                      second):
    """Run 1 dies inside epoch 2; run 2 (fresh, wrong state) restores the
    snapshot of epoch 1 and runs epochs 2-4, by either package."""
    pkg = {"port": tio, "jax": jio}
    state, log = {"w": 0.0}, []
    acp = _acp_run(pkg[first], str(tmp_path), state, log, "run1",
                   stop_after=2)
    assert acp.completed_epochs() == 2
    state["w"] = -99.0
    acp2 = _acp_run(pkg[second], str(tmp_path), state, log, "run2")
    assert state["w"] == 5.0
    assert [e for r, e in log if r == "run2"] == [2, 3, 4]
    assert acp2.completed_epochs() == 5
    assert sorted(os.listdir(tmp_path)) == ["snapshot-5", "status.json"]


def test_auto_checkpoint_commit_crash_replays_the_epoch_once(tmp_path):
    """A crash between an epoch's snapshot and its commit (`ckpt.commit`)
    leaves the status at the previous epoch: the epoch runs again once."""
    state, log = {"w": 0.0}, []

    def save_fn(path):   # no save_sharded: it holds a ckpt.commit site too
        with open(path, "w") as f:
            json.dump(state, f)

    def load_fn(path):
        with open(path) as f:
            state.update(json.load(f))

    acp = tio.AutoCheckpoint(str(tmp_path), save_fn, load_fn)
    with faults.inject("ckpt.commit:error:after=1:times=1"):
        with pytest.raises(faults.InjectedFault):
            for epoch in acp.train_epoch_range(4):
                state["w"] += 1.0
                log.append(epoch)
    assert acp.completed_epochs() == 1 and log == [0, 1]
    state["w"] = 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for epoch in acp.train_epoch_range(4):
            state["w"] += 1.0
            log.append(epoch)
    assert log == [0, 1, 1, 2, 3] and state["w"] == 4.0
