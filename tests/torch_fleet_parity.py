"""Helpers shared by the port's fleet, telemetry, autoscaler and online
parity tests: a `torch.distributed.TCPStore` on a free port, polling with
a deadline, the fast fleet clocks of the reference's tests, and the leak
check over the port's live routers, agents, exporters, collectors,
autoscalers and rollback guards and their threads (conftest watches only
the reference's)."""
import contextlib
import datetime
import time

import torch.distributed as tdist

from paddle_tpu_torch.core import flags
from paddle_tpu_torch.obs import telemetry
from paddle_tpu_torch.serving import autoscaler, fleet, online
from paddle_tpu_torch.utils import syncwatch

# the reference's test settings (tests/test_fleet.py FAST_FLEET)
FAST_FLEET = {"fleet_heartbeat_s": 0.1, "fleet_lease_ttl_s": 0.4,
              "fleet_health_interval_s": 0.1}

# thread names the fleet planes start
_THREADS = ("telemetry-", "fleet-health", "elastic-", "autoscaler-",
            "online-guard", "predictor-serve", "serving-")


def store():
    """A master TCPStore on a free port (no waiting for workers)."""
    return tdist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=30))


@contextlib.contextmanager
def port_flags(**values):
    """Set the port's flags for the block, restoring them after."""
    before = {k: flags.flag(k) for k in values}
    flags.set_flags(values)
    try:
        yield
    finally:
        flags.set_flags(before)


def wait_until(cond, timeout=10.0, poll=0.01):
    """Poll `cond()` until true; raise after `timeout` seconds."""
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise TimeoutError(f"condition not reached within {timeout} s")
        time.sleep(poll)


def _open(obj):
    if isinstance(obj, telemetry.TelemetryExporter):
        return obj._thread is not None
    if isinstance(obj, telemetry.TelemetryCollector):
        return obj._listener is not None
    if isinstance(obj, online.OnlineRollbackGuard):
        return obj._thread is not None
    return not getattr(obj, "_closed", True)


def leaked():
    """The port's fleet objects still running, each stopped here; returns
    their type names (empty when nothing leaked)."""
    objs = [o for live in (fleet._LIVE, autoscaler._LIVE, telemetry._LIVE,
                           online._LIVE) for o in list(live) if _open(o)]
    for o in objs:
        try:
            if isinstance(o, fleet.ReplicaAgent):
                o.stop(drain=False)
            else:
                o.close()
        except Exception:
            pass
    if telemetry._DEFAULT is not None:
        telemetry._DEFAULT = None
    return [type(o).__name__ for o in objs]


def check_no_leak(deadline_s=5.0):
    """Assert nothing of the port's fleet planes outlived the test."""
    names = leaked()
    assert not names, f"fleet objects leaked (stop() never reached): {names}"
    end = time.monotonic() + deadline_s
    while True:
        alive = [r["name"] for r in syncwatch.live_threads()
                 if r["name"].startswith(_THREADS)]
        if not alive or time.monotonic() > end:
            break
        time.sleep(0.02)
    assert not alive, f"fleet threads still alive: {alive}"
