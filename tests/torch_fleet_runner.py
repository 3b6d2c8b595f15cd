"""A child process of the port's fleet drills (the slow tier of
`test_torch_fleet.py`, `test_torch_telemetry.py` and
`test_torch_autoscaler.py`), on the CPU.

`replica`: ONE ReplicaAgent (handler x * 2) joined to the parent's
TCPStore; it publishes `replica_id host port` through the port file once
registered, and serves until it is killed (SIGKILL is the drill's point)
or a line arrives on stdin (a graceful drain). `collector`: ONE
TelemetryCollector published in the store; it writes `host port` and
lives until it is killed or a line arrives on stdin.

argv: [replica|collector, store_host, store_port, fleet_name, port_file]
env:  FLEET_REPLICA_ID (optional): rejoin with a fixed id;
      FLEET_HANDLER_MS (optional): the handler's service time.
"""
import datetime
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

role, host, port, fleet_name, port_file = sys.argv[1:6]

import torch.distributed as tdist  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.core import flags as _flags  # noqa: E402
from paddle_tpu_torch.obs import telemetry  # noqa: E402
from paddle_tpu_torch.serving import EngineConfig, ReplicaAgent  # noqa: E402

pt.set_device("cpu")
_flags.set_flags({"fleet_heartbeat_s": 0.15, "fleet_lease_ttl_s": 0.6})
store = tdist.TCPStore(host, int(port), is_master=False,
                       timeout=datetime.timedelta(seconds=30))


def publish(text):
    tmp = port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.rename(tmp, port_file)   # atomic: the parent never reads half


if role == "collector":
    col = telemetry.TelemetryCollector(store, fleet=fleet_name).start()
    publish(f"{col.host} {col.port}")
    sys.stdin.readline()
    col.stop()
else:
    rid = os.environ.get("FLEET_REPLICA_ID")
    service_s = float(os.environ.get("FLEET_HANDLER_MS", "0")) / 1e3

    def handler(x):
        if service_s:
            time.sleep(service_s)
        return x * 2.0
    agent = ReplicaAgent(
        handler, store, fleet=fleet_name,
        replica_id=int(rid) if rid else None,
        engine_config=EngineConfig(warmup_on_start=False,
                                   batch_timeout_ms=2,
                                   max_batch_size=8)).start()
    publish(f"{agent.replica_id} {agent.host} {agent.port}")
    sys.stdin.readline()
    agent.stop(drain=True)
