"""Exported-flags registry, reduced to the flags the ported paths read.

Counterpart of `paddle_tpu/core/flags.py`: `check_nan_inf` (read by
`jit.TrainStep`) and the `FLAGS_serving_*` entries that
`EngineConfig.from_flags` reads. Flags may be seeded from environment
variables named FLAGS_<name>.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default: Any, doc: str = "") -> None:
    env = os.environ.get(f"FLAGS_{name}")
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = value


def _key(k: str) -> str:
    key = k[6:] if k.startswith("FLAGS_") else k
    if key not in _REGISTRY:
        raise KeyError(f"unknown flag {k}")
    return key


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        _REGISTRY[_key(k)] = v


def flag(name: str) -> Any:
    return _REGISTRY[name]


define_flag("check_nan_inf", False,
            "scan op outputs for NaN/Inf (operator.cc:1171); TrainStep "
            "checks the loss and every gradient")
define_flag("serving_max_batch_size", 8,
            "dynamic batcher: max rows coalesced into one Predictor call")
define_flag("serving_batch_timeout_ms", 2.0,
            "dynamic batcher: max wait for co-batchable requests before "
            "dispatching a partial batch")
define_flag("serving_queue_depth", 256,
            "serving engine: pending-request cap; submits beyond it get "
            "explicit overload rejection, not queuing")
define_flag("serving_default_deadline_ms", 0.0,
            "serving engine: implicit per-request deadline (0 = none)")
define_flag("serving_num_workers", 1,
            "serving engine: batcher worker threads (predictor dispatch "
            "itself is serialized)")
define_flag("serving_learn_buckets", True,
            "serving engine: a novel request signature registers a new "
            "shape bucket instead of being rejected")
define_flag("serving_warmup", True,
            "serving engine: pre-run every declared bucket x batch size "
            "at start()")
