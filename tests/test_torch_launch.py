"""The port's launcher, `spawn`, the process environment and the
`paddle.distributed` namespace, on the CPU over gloo.

`python -m paddle_tpu_torch.parallel.launch` gives each of four ranks the
`PADDLE_*` environment, a gloo world and its hybrid coordinates (dp 2 x
sharding 2, with real groups); a rank that raises makes the launcher and
`spawn` exit non-zero, the others stopped, within their timeouts, and a
hung world makes `spawn` raise TimeoutError. NCCL named for a CPU rank
raises (no fallback to gloo); the ps run mode raises; a single process
without the launcher's world stays one. `paddle.distributed` holds 26 of
the reference's 28 names, and bench's allreduce and ernie_dp arms run on
the CPU.
"""
import json
import os
import subprocess
import sys
import time

import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import env as penv, launch, spawn

import torch_dist_runner as runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(ROOT, "tests", "torch_dist_runner.py")


def _launch(job, out, n, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
         "--nproc_per_node", str(n), "--backend", "gloo", "--device", "cpu",
         "--timeout", str(timeout), RUNNER, job, str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout + 30)


def test_launch_gives_each_rank_its_environment_and_groups(tmp_path):
    res = _launch("env", tmp_path, 4)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.load(open(tmp_path / f"env_{r}.json")) for r in range(4)]
    eps = recs[0]["env"]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == 4
    for r, rec in enumerate(recs):
        env = rec["env"]
        assert env["PADDLE_TRAINER_ID"] == str(r)
        assert env["PADDLE_TRAINERS_NUM"] == "4"
        assert env["PADDLE_RANK_IN_NODE"] == str(r)
        assert env["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert env["PADDLE_DISTRI_BACKEND"] == "gloo"
        assert env["PADDLE_DISTRI_DEVICE"] == "cpu"
        assert env["FLAGS_selected_gpus"] == str(r)
        assert (rec["rank"], rec["world"], rec["local_rank"]) == (r, 4, r)
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
        # data, pipe, sharding, model order: rank = 2 * dp + sharding
        d, s = divmod(r, 2)
        assert (rec["dp_rank"], rec["sharding_rank"]) == (d, s)
        assert rec["dp_ranks"] == [s, 2 + s]
        assert rec["sharding_ranks"] == [2 * d, 2 * d + 1]
        assert rec["dp_sum"] == (s + 1) + (2 + s + 1)
        assert rec["sharding_sum"] == (2 * d + 1) + (2 * d + 2)
        assert rec["first"] == (r == 0) and rec["index"] == r


def test_a_failing_rank_fails_launch_and_stops_the_others(tmp_path):
    t0 = time.monotonic()
    res = _launch("fail", tmp_path, 2, timeout=60)
    assert res.returncode == 1, res.stderr[-3000:]
    assert "rank 1 fails on purpose" in res.stderr
    assert time.monotonic() - t0 < 60


def test_a_failing_rank_fails_spawn(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 exited with code 1"):
        spawn(runner.run, args=("fail", str(tmp_path)), nprocs=2,
              backend="gloo", device="cpu", timeout=60)


def test_a_hung_world_times_spawn_out(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 3"):
        spawn(runner.run, args=("hang", str(tmp_path)), nprocs=2,
              backend="gloo", device="cpu", timeout=3)
    assert time.monotonic() - t0 < 30


def test_rank_environments_and_modes():
    envs = launch.rank_envs(2, gpus="0,0", backend="gloo")
    assert [e["FLAGS_selected_gpus"] for e in envs] == ["0", "0"]
    assert envs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")[0] == \
        envs[0]["PADDLE_MASTER"]
    with pytest.raises(ValueError, match="fewer cards"):
        launch.rank_envs(3, gpus="0,1")
    # the ps mode is ported: the server options select it, and an unknown
    # mode raises
    assert launch._parse(["--server_num", "1", "train.py"]).run_mode == "ps"
    assert launch._parse(["train.py"]).run_mode == "collective"
    servers, trainers = launch.ps_envs(["127.0.0.1:1", "127.0.0.1:2"], 2)
    assert [e["PADDLE_PORT"] for e in servers] == ["1", "2"]
    assert [e["PADDLE_TRAINER_ID"] for e in trainers] == ["0", "1"]
    with pytest.raises(ValueError, match="unknown --run_mode"):
        launch.launch(["--run_mode", "bogus", "train.py"])


def test_nccl_for_a_cpu_rank_raises_and_one_process_stays_one(monkeypatch):
    pt.set_device("cpu")
    for k in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ENDPOINTS",
              "PADDLE_DISTRI_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    penv.init_parallel_env()
    assert not penv.is_world() and pt.distributed.get_world_size() == 1
    penv._STATE["initialized"] = False
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       f"127.0.0.1:{launch.free_port()},127.0.0.1:1")
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA"):
        penv.init_parallel_env()
    assert not penv.is_world()
    penv._STATE["initialized"] = False


def test_distributed_namespace_holds_26_of_28_names():
    api = json.load(open(os.path.join(ROOT, "tests",
                                      "reference_api_all.json")))
    names = api["paddle.distributed"]
    missing = sorted(n for n in names if not hasattr(pt.distributed, n))
    assert len(names) == 28
    assert missing == []
    entry = pt.distributed.CountFilterEntry(3)
    assert entry._to_attr() == "count_filter_entry:3"
    assert pt.distributed.ProbabilityEntry(0.5)._to_attr() == \
        "probability_entry:0.5"
    assert pt.distributed.ShowClickEntry("s", "c")._to_attr() == \
        "show_click_entry:s:c"
    parts = pt.distributed.split(pt.to_tensor([1.0, 2.0, 3.0, 4.0]), 2)
    assert [p.tolist() for p in parts] == [[1.0, 2.0], [3.0, 4.0]]


def test_gloo_control_plane_barrier():
    port = launch.free_port()
    pt.distributed.gloo_init_parallel_env(0, 1, f"127.0.0.1:{port}")
    pt.distributed.gloo_barrier()
    pt.distributed.gloo_barrier()
    pt.distributed.gloo_release()
    with pytest.raises(RuntimeError, match="before gloo_init"):
        pt.distributed.gloo_barrier()


def test_bench_allreduce_and_ernie_dp_arms_on_the_cpu(capsys):
    from paddle_tpu_torch.utils import bench
    bench.main(["--arm", "allreduce", "--arm", "ernie_dp", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    ar, dp = lines
    assert ar["arm"] == "allreduce" and ar["n_devices"] == 2
    assert ar["backend"] == "gloo" and ar["bus_gbps"] > 0
    assert "host-staged" in ar["note"]
    assert dp["arm"] == "ernie_dp" and dp["n_ranks"] == 2
    assert dp["samples_per_sec"] > 0 and dp["one_card_call_samples_per_sec"] > 0
    assert dp["n_buckets"] >= 1 and dp["loss_last"] < dp["loss_first"]
