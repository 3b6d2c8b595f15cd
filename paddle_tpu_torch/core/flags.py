"""Exported-flags registry, reduced to the flags the ported paths read.

Counterpart of `paddle_tpu/core/flags.py`: `check_nan_inf` (read by
`jit.TrainStep`), `amp_fused_update` (read by `amp.GradScaler`), the
`FLAGS_serving_*` entries that `EngineConfig.from_flags` reads, the
`FLAGS_llm_*` entries that `LLMConfig.from_flags` reads, `monitor` (the
gate of `paddle_tpu_torch.monitor`, kept in sync through `watch_flag`),
the data feed's `prefetch`, `prefetch_depth` and
`dataloader_max_worker_restarts`, `dp_bucket_mb` (read by
`parallel.Reducer`), and the observability and wire plane's
flags (`fault_inject`, `obs_*`, `mem_*`, `trace*`, `slo_*`, `net_*`,
`sync_*`, `serving_client_*`) and the training guard's `guard_*` (read by
`guard.GuardConfig.from_flags`), the persistent compile cache's
`compile_cache_dir` / `compile_cache_mb` (`core/compile_cache.py`) and
`lint`, the gate of the trace-time hook of `analysis/`, and the
parameter server's `ps_*` (`distributed/ps/`), and the serving fleet's
`online_*` (`serving/online.py`), `fleet_*` (`serving/fleet.py`),
`telemetry*` (`obs/telemetry.py`) and `autoscaler_*`
(`serving/autoscaler.py`), with the reference's defaults. Flags may be seeded from environment variables named
FLAGS_<name>.
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
define_flag("dp_bucket_mb", 25,
            "bucketed gradient reduction (parallel/reducer.py): gradient "
            "bytes coalesced per collective in the backward-interleaved "
            "DP reduction (reference DataParallel comm_buffer_size=25MB); "
            "smaller = earlier overlap, larger = fewer collectives")
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
define_flag("lint", False,
            "run tpu-lint (paddle_tpu_torch.analysis) over functions as "
            "they are exported by @to_static or wrapped by TrainStep / "
            "SPMDTrainStep: trace-hazard warnings + lint.findings/lint.files "
            "monitor counters, once per function; off = one "
            "module-attribute check at build time only")
# ---- executable plane (core/executable.py + core/compile_cache.py) --------
define_flag("compile_cache_dir", "",
            "persistent on-disk program cache (core/compile_cache.py): a "
            "novel to_static signature's torch.export program is saved "
            "under a key of (the signature, the parameter and buffer "
            "names, the function's source, the source files of the "
            "Layer's classes, the port's own sources, torch and CUDA "
            "versions, the topology, the flags); a second process running "
            "the same workload loads it instead of exporting (fleet warm "
            "start). Empty = off: every build site pays one "
            "module-attribute check")
define_flag("compile_cache_mb", 1024,
            "compile cache: on-disk size cap in MB; least-recently-used "
            "entries beyond it are evicted at store/gc time "
            "(compile_cache.evictions counter)")
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
# ---- parameter server (distributed/ps/) -----------------------------------
define_flag("ps_rpc_max_retries", 3,
            "PS client: transport-failure retries per RPC (exponential "
            "backoff + jitter; pushes stay exactly-once via per-client "
            "request sequencing)")
define_flag("ps_rpc_backoff_ms", 50.0,
            "PS client: initial retry backoff; doubles per attempt, "
            "capped at 2s, with up to 100% uniform jitter")
define_flag("ps_rpc_call_timeout_s", 120.0,
            "PS client: per-call deadline for connect + each response "
            "read (0 = wait forever)")
define_flag("ps_wal_dir", "",
            "PS durability: directory for the server's write-ahead delta "
            "log + crash-atomic snapshots; empty = in-memory only "
            "(PsServer(wal_dir=...) overrides per instance)")
define_flag("ps_wal_segment_mb", 16.0,
            "PS durability: WAL segment rollover size in MiB")
define_flag("ps_snapshot_every_records", 0,
            "PS durability: auto-compact the WAL into a snapshot every N "
            "committed delta records; 0 = manual snapshot() only")
define_flag("ps_replication_interval_ms", 20.0,
            "PS HA: standby poll interval for tailing the primary's delta "
            "stream (CMD_REPLICATE)")
define_flag("ps_communicator_max_requeues", 3,
            "Communicator: times one async push batch may be re-enqueued "
            "after a transport failure (client failover) before the "
            "worker records a permanent error")
define_flag("ps_ha_lease_ttl_s", 2.0,
            "PS HA: primary lease time-to-live in the rendezvous store; "
            "a standby promotes itself after this long without heartbeats")
define_flag("ps_ha_heartbeat_s", 0.5,
            "PS HA: lease heartbeat interval (must be well under "
            "FLAGS_ps_ha_lease_ttl_s)")

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

# ---- training guard plane (guard.GuardConfig.from_flags) ----
define_flag("guard_step_timeout_s", 0.0,
            "step watchdog: hard per-step deadline in seconds; 0 = "
            "auto-calibrate from the trailing median step duration after "
            "FLAGS_guard_warmup_steps completed steps")
define_flag("guard_warmup_steps", 5,
            "step watchdog: completed steps observed before the "
            "auto-calibrated deadline arms")
define_flag("guard_timeout_factor", 10.0,
            "step watchdog: auto deadline = max(min, factor x trailing "
            "median step duration)")
define_flag("guard_min_timeout_s", 30.0,
            "step watchdog: floor for the auto-calibrated deadline")
define_flag("guard_loss_spike_ratio", 10.0,
            "divergence guard: a finite loss above ratio x trailing-median "
            "good loss counts as a bad step (rollback + skip); 0 disables "
            "the spike check (a non-finite loss is always bad)")
define_flag("guard_snapshot_interval", 25,
            "divergence guard: steps between rolling in-memory last-good "
            "snapshots of params/slots/rng (rollback granularity)")
define_flag("guard_max_bad_steps", 3,
            "divergence guard: consecutive bad (rolled-back) steps before "
            "DivergedError is raised instead of skipping")
define_flag("guard_desync_interval", 0,
            "cross-rank desync detector: steps between parameter-"
            "fingerprint all-gathers across the data-parallel group; "
            "0 = disabled")
define_flag("guard_desync_timeout_s", 30.0,
            "cross-rank desync detector: how long to wait for peer "
            "fingerprints before giving up on a round")

# ---- online serving plane (serving/online.py) --------------------------------
define_flag("online_max_staleness_s", 5.0,
            "online serving: a table whose last successful delta sync is "
            "older than this is considered stale; lookups then follow "
            "FLAGS_online_staleness_degrade")
define_flag("online_staleness_degrade", "serve_stale",
            "online serving: behavior past the staleness bound — "
            "'serve_stale' answers from the stale table (counted + one "
            "telemetry event per episode), 'reject' raises "
            "StalenessExceededError to the caller")
define_flag("online_delta_interval_ms", 50.0,
            "online serving: DeltaSubscriber poll interval for tailing "
            "the PS delta-push plane (CMD_DELTA)")
define_flag("online_delta_max_rows", 0,
            "online serving: cap on rows per delta pull (cut on version "
            "boundaries, never inside one); 0 = unbounded")

# ---- fleet serving tier (serving/fleet.py) -----------------------------------
define_flag("fleet_heartbeat_s", 0.5,
            "fleet replica: heartbeat interval for the replica's "
            "ElasticManager lease (FleetRouter detects death at lease "
            "expiry OR on a dispatch connection error, whichever first)")
define_flag("fleet_lease_ttl_s", 2.0,
            "fleet replica: lease TTL; a replica whose lease is this "
            "stale is dead and its traffic re-routes")
define_flag("fleet_health_interval_s", 0.5,
            "fleet router: 'PDHQ' probe interval per replica (feeds the "
            "load-aware routing score: queue depth, SLO burn, "
            "warm_start_ms) and the rejoin detector for recovered "
            "replicas")
define_flag("fleet_max_replicas", 16,
            "fleet router: replica-id space scanned in the rendezvous "
            "store for registrations")
define_flag("fleet_failover_attempts", 3,
            "fleet router: distinct replicas tried per request before "
            "giving up (each retry bounded by the request's ORIGINAL "
            "deadline; the sequence ledger keeps delivery exactly-once)")
define_flag("fleet_route_burn_weight", 2.0,
            "fleet router: weight of a replica's shortest-window SLO "
            "burn rate in its routing score (score = queue fraction + "
            "weight * burn; lowest score wins)")
define_flag("fleet_canary_burn", 1.0,
            "fleet rollout: canary burn-rate threshold — a pushed model "
            "version whose canary-replica tenant burn exceeds this rolls "
            "back instantly via the guard checkpoint .bak generation")
define_flag("fleet_hbm_budget_mb", 0.0,
            "fleet replica: HBM budget for hosted model weights "
            "(mem.model.<name>.bytes admission control: a push that "
            "would exceed it evicts idle LRU tenants first, then is "
            "rejected; 0 = unlimited)")

# ---- fleet telemetry plane (obs/telemetry.py) --------------------------------
define_flag("telemetry", False,
            "fleet telemetry plane (obs/telemetry.py): processes run a "
            "TelemetryExporter pushing delta-compressed counters, "
            "mergeable DDSketch histograms, and immediate events to the "
            "TelemetryCollector found via TCPStore rendezvous; off = "
            "zero telemetry threads/sockets")
define_flag("telemetry_interval_s", 0.25,
            "telemetry: exporter metric-push period in seconds (events "
            "push immediately regardless)")
define_flag("telemetry_buffer", 256,
            "telemetry: exporter's bounded drop-oldest event buffer — a "
            "dead collector costs at most this many queued events "
            "(telemetry.dropped counts the overflow), never serving "
            "throughput")
define_flag("telemetry_ring", 256,
            "telemetry: collector's per-(source, metric) time-series "
            "ring length and its fleet event-ring length")
define_flag("telemetry_death_after_s", 1.5,
            "telemetry: collector declares a silent source dead after "
            "this many seconds without a push (socket EOF on SIGKILL is "
            "the fast path; this reaper catches wedged-not-dead)")
define_flag("telemetry_incident_min_interval_s", 30.0,
            "telemetry: minimum spacing between correlated-incident "
            "fan-outs — a crash loop yields one fleet-wide dump set per "
            "window, not a dump storm")

# ---- SLO-driven autoscaler (serving/autoscaler.py) ---------------------------
define_flag("autoscaler_interval_s", 0.5,
            "autoscaler: control-loop tick period — each tick senses the "
            "collector's fleet signal (worst shortest-window burn + queue "
            "fraction), asks the policy for a decision, and actuates it")
define_flag("autoscaler_burn_high", 1.0,
            "autoscaler policy: scale OUT when the worst replica's "
            "shortest-window SLO burn exceeds this (1.0 = consuming the "
            "error budget exactly as provisioned)")
define_flag("autoscaler_burn_low", 0.25,
            "autoscaler policy: burn must be at or below this for the "
            "idle clock to run (scale-in hysteresis band: the gap to "
            "autoscaler_burn_high is where nothing happens)")
define_flag("autoscaler_queue_high", 0.8,
            "autoscaler policy: scale OUT when the fleet queue fraction "
            "(queued work / aggregate queue capacity) exceeds this")
define_flag("autoscaler_queue_low", 0.2,
            "autoscaler policy: queue fraction must be at or below this "
            "for the idle clock to run (scale-in hysteresis band)")
define_flag("autoscaler_cooldown_s", 5.0,
            "autoscaler policy: minimum spacing between scale actions in "
            "the SAME direction — flapping traffic cannot thrash the "
            "pool faster than one step per cooldown")
define_flag("autoscaler_idle_after_s", 10.0,
            "autoscaler policy: the fleet must stay calm (burn and queue "
            "below the low thresholds) this long before ONE replica is "
            "drained; the clock restarts after each scale-in")
define_flag("autoscaler_zero_after_s", 60.0,
            "autoscaler policy: with autoscaler_min_replicas=0, a fleet "
            "calm this long scales TO ZERO (drains every replica); idle "
            "tenants are evicted at the same threshold under the "
            "FLAGS_fleet_hbm_budget_mb LRU when autoscaler_tenant_idle_s "
            "is unset")
define_flag("autoscaler_min_replicas", 1,
            "autoscaler policy: floor of the replica pool (0 allows "
            "scale-to-zero)")
define_flag("autoscaler_max_replicas", 0,
            "autoscaler policy: ceiling of the replica pool; 0 = use "
            "FLAGS_fleet_max_replicas")
define_flag("autoscaler_step", 1,
            "autoscaler policy: replicas added per scale-out decision "
            "(scale-in always drains one at a time)")
define_flag("autoscaler_spawn_timeout_s", 15.0,
            "autoscaler pool: a spawned replica must answer its first "
            "'PDHQ' probe within this window or it is reaped (record + "
            "lease reclaimed, autoscaler.spawn_failures counted)")
define_flag("autoscaler_spawn_retries", 3,
            "autoscaler pool: consecutive spawn failures tolerated "
            "before scale-out is declared blocked (the collector's "
            "scale_blocked alert fires); one success resets the budget")
define_flag("autoscaler_tenant_idle_s", 0.0,
            "autoscaler: evict a hosted ModelTenant idle this long with "
            "an empty queue (scale-to-zero for tenants, via the "
            "replica's HBM-budget LRU eviction path); 0 = fall back to "
            "autoscaler_zero_after_s, negative = never evict tenants")
define_flag("autoscaler_ledger_ring", 128,
            "autoscaler: decision-ledger ring length (every scale action "
            "with its triggering evidence; dumped into the flight "
            "recorder and rendered by `monitor top`)")
