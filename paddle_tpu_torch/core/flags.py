"""Exported-flags registry, reduced to the flags the ported paths read.

Counterpart of `paddle_tpu/core/flags.py`: `check_nan_inf` (read by
`jit.TrainStep`), `amp_fused_update` (read by `amp.GradScaler`), the
`FLAGS_serving_*` entries that `EngineConfig.from_flags` reads, the
`FLAGS_llm_*` entries that `LLMConfig.from_flags` reads, `monitor` (the
gate of `paddle_tpu_torch.monitor`, kept in sync through `watch_flag`),
and the data feed's `prefetch`, `prefetch_depth` and
`dataloader_max_worker_restarts`, with the reference's defaults. Flags
may be seeded from environment variables named FLAGS_<name>.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List

_REGISTRY: Dict[str, Any] = {}
_WATCHERS: Dict[str, List[Callable[[Any], None]]] = {}


def watch_flag(name: str, fn: Callable[[Any], None]) -> None:
    """Register fn(new_value) to run whenever `name` is set via set_flags."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown flag {name}")
    _WATCHERS.setdefault(name, []).append(fn)


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
        key = _key(k)
        _REGISTRY[key] = v
        for fn in _WATCHERS.get(key, ()):
            fn(v)


def flag(name: str) -> Any:
    return _REGISTRY[name]


define_flag("check_nan_inf", False,
            "scan op outputs for NaN/Inf (operator.cc:1171); TrainStep "
            "checks the loss and every gradient")
define_flag("amp_fused_update", True,
            "GradScaler.step folds unscale + found_inf check + gate into "
            "the optimizer's update (no host sync on found_inf before the "
            "update); off = the legacy unscale_-then-step path with its "
            "per-step host sync")
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
define_flag("dataloader_max_worker_restarts", 2,
            "DataLoader: respawns allowed per worker slot before a dead "
            "worker becomes a hard error")
define_flag("prefetch", False,
            "io.maybe_wrap feeds the step through io.DevicePrefetcher (a "
            "feeder thread stages FLAGS_prefetch_depth batches on the device "
            "ahead of the consumer)")
define_flag("prefetch_depth", 2,
            "prefetch: batches staged on the device ahead of the consumer; "
            "also the most that close() drops")
define_flag("monitor", False,
            "enable the paddle_tpu_torch.monitor stats registry + trace "
            "spans (platform/monitor.h STAT registry role); off = every "
            "instrumented site pays one module-attribute check and nothing "
            "else")
# ---- LLM continuous-batching serving (serving/llm.py) ---------------------
define_flag("llm_num_slots", 8,
            "LLM engine: KV-cache pool slots = max sequences decoding "
            "concurrently; one fixed-shape decode executable covers all "
            "slots, so this is also the decode batch width")
define_flag("llm_max_len", 256,
            "LLM engine: per-slot KV page length (prompt + generated "
            "ceiling); pool bytes scale linearly with it "
            "(see README 'LLM serving' sizing recipe)")
define_flag("llm_prefill_buckets", "",
            "LLM engine: comma-separated prefill length buckets (prompts "
            "pad up to the next bucket; one cached prefill executable per "
            "bucket). Empty = powers of two from 8 up to llm_max_len")
define_flag("llm_max_new_tokens", 64,
            "LLM engine: default generation budget per request when the "
            "submit call doesn't set one")
define_flag("llm_queue_depth", 256,
            "LLM engine: max queued (not yet admitted) requests before "
            "submit sheds with ServerOverloadedError")
define_flag("llm_default_deadline_ms", 0.0,
            "LLM engine: deadline applied to requests that don't carry "
            "one; sequences past it are evicted at the next decode step "
            "(llm.evictions.deadline). 0 = no default")
define_flag("llm_warmup", True,
            "LLM engine: trace+compile every prefill bucket and the "
            "decode step at start() so steady-state serving performs "
            "zero compiles (the jit.* retrace counters stay flat)")
define_flag("llm_quant", "off",
            "LLM engine decode quantization arm: 'int8' applies "
            "quant_weight_only to the decoder matmuls (Linear + "
            "ColumnParallelLinear/RowParallelLinear) at engine init; "
            "'off' serves fp32 weights")
define_flag("llm_kv_int8", False,
            "LLM engine: store KV-cache pages as int8 with one "
            "dequantization scale per slot (computed at prefill, "
            "clipped into at decode) — 4x pool bytes reduction")
