"""Helpers shared by the port's parameter-server parity tests: the leak
check over the port's PS objects and threads (the reference's are watched
by conftest), polling with a deadline, and the CTR model both packages
train through a PS."""
import time

import numpy as np

from paddle_tpu_torch.distributed.ps import delta as _delta
from paddle_tpu_torch.distributed.ps import ha as _ha
from paddle_tpu_torch.distributed.ps import service as _service
from paddle_tpu_torch.distributed.ps import wal as _wal
from paddle_tpu_torch.utils import syncwatch

# thread names the PS plane starts (server accept / handlers, the
# Communicator, the HA tail, the lease threads, delta subscribers)
_PS_THREADS = ("ps-", "elastic-", "delta-", "communicator")


def leaked_ps_objects():
    """The port's PS objects still running, each stopped here; returns
    their type names (empty when nothing leaked)."""
    leaked = [n for n in list(_ha._LIVE) if not getattr(n, "_closed", True)]
    leaked += [s for s in list(_service._LIVE)
               if not getattr(s, "_closed", True) and not s._stop.is_set()]
    leaked += [w for w in list(_wal._LIVE_WRITERS) if not w.closed]
    leaked += [d for d in list(_delta._LIVE)
               if d._thread is not None and d._thread.is_alive()]
    for obj in leaked:
        try:
            obj.stop() if hasattr(obj, "stop") else obj.close()
        except Exception:
            pass
    return [type(o).__name__ for o in leaked]


def ps_threads(deadline_s=5.0):
    """The port's PS threads still alive after `deadline_s` of polling."""
    end = time.monotonic() + deadline_s
    while True:
        alive = [r["name"] for r in syncwatch.live_threads()
                 if r["name"].startswith(_PS_THREADS)]
        if not alive or time.monotonic() > end:
            return alive
        time.sleep(0.02)


def check_no_leak():
    """Assert nothing of the port's PS plane outlived the test."""
    leaked = leaked_ps_objects()
    assert not leaked, f"PS objects leaked (stop() never reached): {leaked}"
    threads = ps_threads()
    assert not threads, f"PS threads still alive: {threads}"


def wait_until(cond, timeout=10.0, poll=0.01):
    """Poll `cond()` until true; raise after `timeout` seconds."""
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise TimeoutError("condition not reached within "
                               f"{timeout} s")
        time.sleep(poll)


def ctr_data(n_slots=3, batch=16, vocab=40, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, n_slots))
    y = (ids.sum(1) % 2).astype(np.int64)
    dense = rng.standard_normal((batch, 2)).astype(np.float32)
    return ids, dense, y


def ctr_tower(nn, n_slots=3, dim=4):
    """The CTR-DNN's dense tower at a small size: the slots' embeddings
    and two dense features, two ReLU layers, a 2-way head."""
    return nn.Sequential(nn.Linear(n_slots * dim + 2, 16), nn.ReLU(),
                         nn.Linear(16, 8), nn.ReLU(), nn.Linear(8, 2))
