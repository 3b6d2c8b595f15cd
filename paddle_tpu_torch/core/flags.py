"""Exported-flags registry, reduced to the flags the ported paths read.

Counterpart of `paddle_tpu/core/flags.py`: `check_nan_inf` (read by
`jit.TrainStep`), `amp_fused_update` (read by `amp.GradScaler`), the
`FLAGS_serving_*` entries that `EngineConfig.from_flags` reads, the
`FLAGS_llm_*` entries that `LLMConfig.from_flags` reads, `monitor` (the
gate of `paddle_tpu_torch.monitor`, kept in sync through `watch_flag`),
the data feed's `prefetch`, `prefetch_depth` and
`dataloader_max_worker_restarts`, and the observability and wire plane's
flags (`fault_inject`, `obs_*`, `mem_*`, `trace*`, `slo_*`, `net_*`,
`sync_*`, `serving_client_*`), with the reference's defaults. Flags may be
seeded from environment variables named FLAGS_<name>.
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

# ---- fault injection (faults.py) ------------------------------------------
define_flag("fault_inject", "",
            "deterministic fault-injection spec(s), ';'-separated "
            "site:kind[:p=..][:seed=..][:times=..][:after=..] strings "
            "(paddle_tpu_torch.faults); empty = every injection site is one "
            "module-attribute check")
# ---- step timeline + flight recorder (obs/) --------------------------------
define_flag("obs_timeline", False,
            "record a per-step phase timeline (data_wait/h2d/trace_compile/"
            "device_compute/optimizer ...) into a bounded ring "
            "(paddle_tpu_torch.obs.StepTimeline); adds a synchronize of the "
            "stream that did the work per step so device compute is "
            "attributed honestly; off = one module-attribute check per "
            "instrumented site")
define_flag("obs_flight_recorder", False,
            "keep the black-box flight recorder armed: last-N step "
            "records + monitor-counter deltas + recent events, dumped to "
            "one JSON artifact on serving overload, OOM, or dump(); "
            "off = one module-attribute check per instrumented site")
define_flag("obs_ring_steps", 64,
            "obs: step records kept in the timeline/flight-recorder ring")
define_flag("obs_ring_snapshots", 16,
            "obs: per-step monitor-counter deltas kept in the flight "
            "recorder ring")
define_flag("obs_dump_dir", "flight_recorder",
            "obs: directory flight-recorder dumps are written to when no "
            "explicit path is given")
define_flag("obs_dump_min_interval_s", 30.0,
            "obs: min seconds between AUTOMATIC dumps for the same reason "
            "(overload storms must not flood the disk); explicit "
            "dump(path=...) calls are never rate-limited")
# ---- memory attribution plane (obs/memory.py) ------------------------------
define_flag("mem_census", False,
            "device memory attribution (obs/memory.py): tag tensors at "
            "their creation seams (params/slots/activations/serving "
            "buckets/kv pool) and let census() bucket tagged bytes per tag "
            "per device, publishing mem.<tag>.bytes gauges; off = every "
            "tag seam pays one module-attribute check")
define_flag("mem_census_ring", 16,
            "mem census: snapshots kept in the census ring (the flight "
            "recorder embeds this ring in its dump)")
define_flag("mem_top_k", 8,
            "mem census: top-K largest tagged storages (with tag + origin) "
            "reported by top_buffers() and the OOM forensics dump")
define_flag("mem_leak_window", 8,
            "mem leak watch: a tag whose census bytes grow strictly for "
            "this many consecutive censuses is flagged as a leak suspect "
            "(warning + mem.leak_suspects counter); 0 disables the check")
# ---- request tracing + SLO plane (obs/trace.py + obs/slo.py) ---------------
define_flag("trace", False,
            "request-scoped distributed tracing (obs/trace.py): mint a "
            "trace context per PredictorClient request, carry it over the "
            "wire in an optional 'PDTC' frame, and record spans "
            "(client.send/serving.request/queue_wait/batch/dispatch/reply) "
            "into a tail-sampled ring that joins the flight-recorder dump "
            "and chrome-trace export; off = every span site pays one "
            "module-attribute check")
define_flag("trace_ring", 64,
            "tracing: finished traces kept per ring (one ring for healthy "
            "traces, one PROTECTED ring for over-deadline/rejected/errored/"
            "SLO-violating traces that tail sampling always keeps)")
define_flag("slo_latency_ms", 0.0,
            "SLO plane (obs/slo.py): latency objective for serving e2e "
            "latency — a request slower than this (or rejected/deadline-"
            "expired/errored) burns error budget; 0 = SLO plane off "
            "(one attribute check per recorded request)")
define_flag("slo_target", 0.999,
            "SLO plane: availability target (fraction of requests that "
            "must meet the latency objective); burn rate = bad_fraction / "
            "(1 - target), so burn 1.0 = exactly consuming the budget")
define_flag("slo_windows", "60,300,3600",
            "SLO plane: comma-separated burn-rate window lengths in "
            "seconds (multi-window burn alerting: short window catches "
            "fast burn, long window catches slow leaks)")
define_flag("slo_shed_burn", 0.0,
            "SLO plane: admission hook threshold — when the SHORTEST "
            "window's burn rate exceeds this, ServingEngine.submit sheds "
            "new requests as overloaded before the budget burns; "
            "0 = never shed on burn")
# ---- the RPC substrate (utils/net.py) + the serving client -----------------
define_flag("net_auth_token", "",
            "RPC substrate: shared secret enabling per-frame HMAC auth — "
            "clients open each connection with a 'PDAH' challenge "
            "handshake and both sides speak 'PDAR' HMAC-SHA256 records; "
            "unauthenticated peers are rejected and counted "
            "(net.auth_rejects). Empty = off: the wire stays "
            "byte-identical to the plain protocols")
define_flag("net_tls_cert", "",
            "RPC substrate: path to a PEM cert chain — set together "
            "with net_tls_key to wrap every listener in TLS (clients also "
            "present it for mutual TLS); empty = off")
define_flag("net_tls_key", "",
            "RPC substrate: path to the PEM private key for "
            "net_tls_cert (empty = key lives in the cert file)")
define_flag("net_tls_ca", "",
            "RPC substrate: path to the PEM CA bundle peers are "
            "verified against — on clients it turns on server "
            "verification, on servers it requires client certs")
define_flag("net_deadline_wire", False,
            "RPC substrate: prefix every request with a 'PDDL' "
            "absolute-deadline frame so servers DROP expired work "
            "(net.deadline_drops) instead of computing it. Off by "
            "default: peers without it reject the unknown magic, so "
            "flip it only on same-version deployments")
define_flag("serving_client_max_retries", 3,
            "PredictorClient: bounded connect attempts per endpoint "
            "(exponential backoff + full jitter) — a dead server burns "
            "milliseconds of the request deadline, not all of it")
define_flag("serving_client_backoff_ms", 25.0,
            "PredictorClient: initial reconnect backoff; doubles per "
            "attempt, capped at 1s, with full (0..100%) uniform jitter")
define_flag("serving_client_connect_timeout_s", 2.0,
            "PredictorClient: per-attempt TCP connect timeout (also "
            "clipped to the remaining per-call deadline)")
# ---- concurrency sanitizer (utils/syncwatch.py) ----------------------------
define_flag("sync_watch", False,
            "concurrency sanitizer (utils/syncwatch.py): syncwatch.lock()/"
            "rlock() factories hand out watched wrappers that record "
            "per-thread held-sets + acquisition stacks, maintain the "
            "observed lock-order graph, and raise SyncOrderError (naming "
            "BOTH acquisition stacks) on a cycle BEFORE the acquire would "
            "wedge; off = the factories return plain threading locks "
            "(one module-attribute check at lock-construction time, zero "
            "per-acquire cost)")
define_flag("sync_hold_warn_ms", 0.0,
            "syncwatch: warn with the acquisition stack when a watched "
            "lock was held longer than this many ms (observed on release "
            "into the sync.lock_hold_ms histogram; the live thread table "
            "`python -m paddle_tpu_torch.monitor threads` flags still-held "
            "locks over the threshold); 0 = record the histogram only")
define_flag("sync_order_fatal", True,
            "syncwatch: raise SyncOrderError on a lock-order cycle "
            "(False: warn + count sync.order_violations and continue — "
            "for soaks that want the census without dying on first hit)")
