"""`python -m paddle_tpu_torch.parallel.launch --run_mode ps` on the CPU:
one server and two trainers through fleet's PS surface (`init_server`,
`run_server`, `init_worker`, `stop_worker`), as the reference's
`tests/test_launch_ps.py` drives its launcher. Each trainer pushes, the
two meet at the PS barrier, and each then reads both pushes applied; the
launcher exits 0 when the trainers have, and stops the server itself."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import os, socket, sys, time
sys.path.insert(0, {root!r})
import numpy as np
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import fleet

pt.set_device("cpu")
if os.environ["TRAINING_ROLE"] == "PSERVER":
    srv = fleet.init_server(port=int(os.environ["PADDLE_PORT"]))
    srv.add_sparse_table("emb", dim=4, lr=0.5)
    fleet.run_server(block=True)       # stopped by the launcher
else:
    # the server binds its port before it registers the table and serves:
    # poll the port with a deadline, then every request finds the table
    host, port = os.environ["PADDLE_PSERVERS_IP_PORT_LIST"].rsplit(":", 1)
    deadline = time.monotonic() + 60
    while True:
        try:
            socket.create_connection((host, int(port)), timeout=1).close()
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    client = fleet.init_worker()
    client.register_sparse_dim("emb", 4)
    n = int(os.environ["PADDLE_TRAINERS_NUM"])
    before = client.pull_sparse("emb", [1, 2]).copy()
    client.barrier(n_trainers=n)       # both read the rows before a push
    client.push_sparse("emb", [1, 2], np.ones((2, 4), np.float32))
    client.barrier(n_trainers=n)       # both pushes are in
    after = client.pull_sparse("emb", [1, 2])
    assert abs((before - after) - 0.5 * n).max() < 1e-5, (before, after)
    fleet.stop_worker()
    print("TRAINER_OK", os.environ["PADDLE_TRAINER_ID"])
"""


def test_launch_ps_runs_one_server_and_two_trainers(tmp_path):
    script = tmp_path / "ps_job.py"
    script.write_text(textwrap.dedent(SCRIPT.format(root=ROOT)))
    log_dir = tmp_path / "logs"
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
         "--server_num", "1", "--worker_num", "2", "--device", "cpu",
         "--timeout", "120", "--log_dir", str(log_dir), str(script)],
        capture_output=True, text=True, timeout=180, cwd=ROOT)
    logs = {f: (log_dir / f).read_text() for f in os.listdir(log_dir)}
    assert p.returncode == 0, (p.stdout, p.stderr, logs)
    assert sorted(logs) == ["serverlog.0", "trainerlog.0", "trainerlog.1"]
    for r in (0, 1):
        assert f"TRAINER_OK {r}" in logs[f"trainerlog.{r}"], logs
