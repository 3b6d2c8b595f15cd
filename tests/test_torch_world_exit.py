"""The gloo world's exit under the port's launcher, on the CPU.

A rank that leaves with a non-zero `sys.exit` after the world is up (the
`sys.exit(main())` idiom) fails the launch well within its timeout, with
the others stopped: neither a failing peer nor a failing rank 0 sits in
the exit rendezvous (`parallel/env.py` `_release`) while the rest of the
world waits on it in a collective.

The bound is taken from the failing rank's exit, not from the launch's
start: the launcher and both ranks each import torch first, one after the
other, and under a loaded machine that startup alone can outlast the
wait. The rank prints `time.monotonic()` just before it exits; on Linux
CLOCK_MONOTONIC is shared by the processes of one machine."""
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu_torch.parallel import env as penv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import time
sys.path.insert(0, {root!r})
import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as dist

pt.set_device("cpu")
dist.init_parallel_env()
dist.barrier()
if dist.get_rank() == {rank}:
    print("rank {rank} exits 3 on purpose", file=sys.stderr, flush=True)
    print("exit stamp", time.monotonic(), file=sys.stderr, flush=True)
    sys.exit(3)
dist.barrier()
"""


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_that_exits_non_zero_fails_launch_at_once(tmp_path, rank):
    script = tmp_path / "exit_rank.py"
    script.write_text(textwrap.dedent(SCRIPT.format(root=ROOT, rank=rank)))
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
         "--nproc_per_node", "2", "--backend", "gloo", "--device", "cpu",
         "--timeout", "60", str(script)],
        cwd=ROOT, capture_output=True, text=True, timeout=90)
    returned = time.monotonic()
    assert res.returncode != 0, res.stderr[-3000:]
    assert f"rank {rank} exits 3 on purpose" in res.stderr
    stamp = re.search(r"^exit stamp (\S+)$", res.stderr, re.M)
    assert stamp is not None, res.stderr[-3000:]
    wall = returned - float(stamp.group(1))
    # rank 0's exit wait is 20 s (`_EXIT_WAIT_S`): a failing rank 0 never
    # sits in it, so the launch ends well before the wait would
    assert wall < penv._EXIT_WAIT_S - 1, (wall, res.stderr[-3000:])
