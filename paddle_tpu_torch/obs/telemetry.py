"""The fleet telemetry plane's event hook.

Counterpart of `paddle_tpu/obs/telemetry.py`'s `emit` / `get_default`
(:73-83): a site fires an event (the PS HA node's `role_change`) on the
process-default exporter, and with none installed the call is one
module-attribute read and nothing else. The exporter and the collector
that would install one are not ported yet, so `_DEFAULT` stays None
unless a caller sets it to an object with `event(kind, **detail)`.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["emit", "get_default"]

# the process-default exporter: any object with `event(kind, **detail)`
_DEFAULT: Optional[Any] = None


def emit(kind: str, **detail) -> None:
    """Fire an event on the process-default exporter; no-op without one
    (one module-attribute read on the disabled path)."""
    exp = _DEFAULT
    if exp is not None:
        exp.event(kind, **detail)


def get_default() -> Optional[Any]:
    return _DEFAULT
