"""Continuous-batching autoregressive serving (the LLM decode plane).

Counterpart of `paddle_tpu/serving/llm.py`: `_prefill_ladder`,
`LLMConfig`, `LLMStream`, `LLMEngine` with its scheduler thread, over
`GPTForCausalLM.forward_cached`.

- **Slot-paged fixed-shape pool**: per layer one `[num_slots, page_len,
  heads, head_dim]` K and V tensor pair (fp32, or int8 with one f32
  scale per slot). Sequences borrow a slot for their lifetime; shapes
  never depend on which slots are live.
- **The decode step as one CUDA graph**: the reference keeps one jitted
  decode executable for the whole pool; on CUDA the port captures one
  CUDA graph of the decode step at warm-up (after one eager step on a side
  stream) over static `tokens [S]` / `positions [S]` buffers and the pool,
  which `forward_cached` updates in place. Every decode step copies the
  host's tokens and positions into the static buffers, replays the graph
  and reads back the `[S]` next tokens. `llm.graph_captures` counts
  captures: one per engine at warm-up, none after (the counterpart of the
  reference's zero steady-state compiles). On the CPU the same function
  runs eagerly.
- **Prefill** stays eager, one call per length bucket: it zeroes the
  slot's page of the pool and writes the prompt's K/V into it in place,
  so the graph reads the new rows. The pool is never reallocated.
- **Continuous scheduler**: every decode step admits queued sequences into
  free slots and evicts on EOS / length / deadline, streaming each token to
  the caller the moment it exists. Admission sheds on queue depth.
- **Quantized decode arm**: `LLMConfig(quant="int8")` runs the decoder
  matmuls through `quantization.quant_weight_only`; `kv_int8=True` stores
  the pool as int8 with a dequantization scale per slot.

Decode blocks are `decode_block` (=2) tokens wide with only row 0 real, as
in the reference; the junk row's cache write lands one past the live
prefix and is overwritten by the next real token before it can be read.

The reference's hooks, each behind its flag's one attribute check: the
SLO shed at admission and every finished request's outcome
(`obs/slo.py`); the `llm.decode` fault site, checked once per in-flight
sequence so an injected error evicts exactly that one; the decode step
under `dispatch_guard("llm_decode")` and, with the timeline on, its own
`decode_step` phase fenced on the scheduler's stream; the `kv_pool`
memory tag; the scheduler as a `syncwatch.Thread`. The 'PDSQ' / 'PDST'
streaming wire is `inference/server.py`'s, over `on_token` / `iter()`.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults as _faults
from .. import monitor as _monitor
from .. import nn
from .. import obs as _obs
from ..core import executable as _exe
from ..core import flags as _flags
from ..core.place import resolve_device
from ..obs import memory as _mem
from ..obs import slo as _slo
from ..utils import syncwatch as _syncwatch
from .engine import (DeadlineExceededError, EngineStoppedError,
                     ServerOverloadedError, ServingError)

__all__ = ["LLMConfig", "LLMEngine", "LLMStream"]


def _prefill_ladder(max_len: int, declared: Sequence[int] = ()) -> List[int]:
    """Prefill length buckets: declared ones (clamped to max_len), or
    powers of two from 8 up to max_len."""
    if declared:
        ladder = sorted({int(b) for b in declared if 0 < int(b) <= max_len})
        if ladder:
            return ladder
    ladder, b = [], 8
    while b < max_len:
        ladder.append(b)
        b *= 2
    ladder.append(max_len)
    return sorted(set(ladder))


@dataclass
class LLMConfig:
    """Knobs for the continuous-batching engine (FLAGS_llm_* defaults).

    Pool sizing recipe: bytes = 2 (K and V) * num_layers * num_slots *
    (max_len + decode_block) * heads * head_dim * itemsize, fp32 itemsize
    4, kv_int8 itemsize 1 (+ two f32 scales per slot per layer, 8 *
    num_layers * num_slots bytes). `LLMEngine.kv_pool_bytes()` reports the
    real figure. The budget (max_new <= max_len - prompt) ends each
    sequence with a decode step at position <= max_len - 2, whose junk row
    embeds position <= max_len - 1: max_len <= the model's max_seq_len
    keeps every embedded position inside the position table."""

    num_slots: int = 8
    max_len: int = 256
    prefill_buckets: Tuple[int, ...] = ()
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    queue_depth: int = 256
    default_deadline_ms: Optional[float] = None
    warmup_on_start: bool = True
    quant: str = "off"          # "off" | "int8" weight-only decoder matmuls
    kv_int8: bool = False
    # block width of one decode step (row 0 real, the rest junk), as in
    # the reference
    decode_block: int = 2
    idle_park_s: float = 0.02   # scheduler nap when no work is queued

    @classmethod
    def from_flags(cls) -> "LLMConfig":
        buckets: Tuple[int, ...] = ()
        raw = str(_flags.flag("llm_prefill_buckets") or "").strip()
        if raw:
            buckets = tuple(int(p) for p in raw.split(",") if p.strip())
        ddl = float(_flags.flag("llm_default_deadline_ms"))
        return cls(
            num_slots=int(_flags.flag("llm_num_slots")),
            max_len=int(_flags.flag("llm_max_len")),
            prefill_buckets=buckets,
            max_new_tokens=int(_flags.flag("llm_max_new_tokens")),
            queue_depth=int(_flags.flag("llm_queue_depth")),
            default_deadline_ms=ddl if ddl > 0 else None,
            warmup_on_start=bool(_flags.flag("llm_warmup")),
            quant=str(_flags.flag("llm_quant")),
            kv_int8=bool(_flags.flag("llm_kv_int8")),
        )


class LLMStream:
    """Per-request handle: tokens stream into it as the scheduler emits
    them; iterate to consume incrementally, or `result()` to wait for the
    terminal status. Terminal statuses: "done" (EOS or token budget),
    "deadline", "error" (model fault), "stopped" (engine shut down before
    completion)."""

    def __init__(self, request_id: int, on_token: Optional[Callable] = None):
        self.request_id = request_id
        self.tokens: List[int] = []
        self.status = "queued"
        self.error: Optional[str] = None
        self._on_token = on_token
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()

    # scheduler-side
    def _emit(self, tok: int) -> None:
        self.tokens.append(tok)
        self._q.put(tok)
        if self._on_token is not None:
            try:
                self._on_token(len(self.tokens) - 1, tok)
            except Exception:
                pass  # a broken callback must not kill the scheduler

    def _finish(self, status: str, error: Optional[str] = None) -> None:
        if self._done.is_set():
            return
        self.status = status
        self.error = error
        self._done.set()
        self._q.put(None)

    # consumer-side
    def __iter__(self):
        return self.iter()

    def iter(self, timeout: Optional[float] = 600.0):
        """Yield tokens as they arrive until the stream terminates."""
        while True:
            tok = self._q.get(timeout=timeout)
            if tok is None:
                return
            yield tok

    def result(self, timeout: Optional[float] = None) -> Tuple[str, List[int]]:
        """(terminal status, all tokens); raises TimeoutError on wait."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still in flight")
        return self.status, list(self.tokens)

    def done(self) -> bool:
        return self._done.is_set()


@dataclass
class _Seq:
    stream: LLMStream
    prompt: np.ndarray
    max_new: int
    deadline: Optional[float]          # absolute monotonic, or None
    submit_t: float
    slot: int = -1
    pos: int = 0                       # tokens cached so far
    last_token: int = 0
    last_emit_t: float = 0.0
    admit_t: float = 0.0


class _PrefillNet(nn.Layer):
    """One prefill call per length bucket: (tokens [B, Lb], lengths [B],
    pages) -> (first greedy token [B], last-position logits [B, V],
    [int8 scales]). The pages (views of the pool's slot rows) are zeroed,
    as the reference's fresh pages are, then written in place."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, tokens, lengths, pages):
        for k, v in pages:
            k.zero_()
            v.zero_()
        b = tokens.shape[0]
        positions = torch.zeros(b, dtype=torch.int32, device=tokens.device)
        logits, _, scales = self.lm.forward_cached(tokens, pages, positions)
        last = logits[torch.arange(b, device=tokens.device),
                      lengths.long() - 1]
        return last.argmax(-1).to(torch.int32), last, scales


class _DecodeNet(nn.Layer):
    """THE decode step: one fixed-shape step for the whole pool.
    (tokens [S], positions [S], pool, scales) -> (next greedy token [S],
    logits [S, V]); the pool is updated in place. Free slots ride along as
    masked junk rows: occupancy never changes a shape."""

    def __init__(self, lm, num_layers: int, block: int):
        super().__init__()
        self.lm = lm
        self._n = num_layers
        self._block = block

    def forward(self, tokens, positions, pool, scales):
        n = self._n
        kv = [(pool[2 * i], pool[2 * i + 1]) for i in range(n)]
        sc = [(scales[2 * i], scales[2 * i + 1]) for i in range(n)] \
            if scales else None
        # [S] -> [S, block]: row 0 real, the rest padding
        blk = tokens[:, None].expand(-1, self._block)
        logits, _, _ = self.lm.forward_cached(blk, kv, positions, sc)
        last = logits[:, 0]
        return last.argmax(-1).to(torch.int32), last


class LLMEngine:
    """Continuous-batching scheduler over a slot-paged KV-cache pool.

    `submit()` is thread-safe and returns an `LLMStream` immediately; a
    single scheduler thread owns the pool and runs the admit -> decode ->
    evict loop. The model runs on `device` (`cuda` unless the caller asks
    for the CPU). See LLMConfig for sizing and the module docstring for
    the one-capture invariant."""

    _FAULT_SITE = "llm.decode"

    def __init__(self, model, config: Optional[LLMConfig] = None,
                 device=None):
        from ..models.gpt import GPTForCausalLM, GPTModel
        cfg = config or LLMConfig.from_flags()
        if isinstance(model, GPTModel):
            model = GPTForCausalLM(model)
        if not hasattr(model, "forward_cached"):
            raise ServingError(
                "LLMEngine needs a model with a cached-attention path "
                "(GPTForCausalLM / GPTModel)")
        self.config = cfg
        self.device = resolve_device(device)
        self.lm = model.to(self.device)
        self.lm.eval()  # serving path: dropout off
        if cfg.quant == "int8":
            from ..quantization import quant_weight_only
            quant_weight_only(self.lm)
        elif cfg.quant not in ("", "off"):
            raise ServingError(f"unknown llm quant arm {cfg.quant!r}")

        gpt = self.lm.gpt
        attn = gpt.layers[0].attention
        self._n_layers = len(gpt.layers)
        self._heads, self._head_dim = attn.num_heads, attn.head_dim
        self._page_len = cfg.max_len + cfg.decode_block
        self.buckets = _prefill_ladder(cfg.max_len, cfg.prefill_buckets)
        self._prefill = _PrefillNet(self.lm)
        self._decode = _DecodeNet(self.lm, self._n_layers, cfg.decode_block)

        s = cfg.num_slots
        shape = (s, self._page_len, self._heads, self._head_dim)
        kdt = torch.int8 if cfg.kv_int8 else torch.float32
        dev = self.device
        # k0, v0, k1, v1, ...: allocated once; prefill and decode write
        # into them in place, so the captured graph's pointers stay valid
        self._pool: List[torch.Tensor] = [
            torch.zeros(shape, dtype=kdt, device=dev)
            for _ in range(2 * self._n_layers)]
        # ks0, vs0, ... ([S] f32 per slot)
        self._scales: List[torch.Tensor] = [
            torch.ones(s, dtype=torch.float32, device=dev)
            for _ in range(2 * self._n_layers)] if cfg.kv_int8 else []
        # the decode step's static inputs, and its graph (CUDA)
        self._tok = torch.zeros(s, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(s, dtype=torch.int32, device=dev)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

        self._free: List[int] = list(range(s))
        self._active: Dict[int, _Seq] = {}
        self._pending: "collections.deque[_Seq]" = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._next_id = 0
        self._counters = {"requests": 0, "completed": 0, "shed": 0,
                          "evictions.eos": 0, "evictions.length": 0,
                          "evictions.deadline": 0, "evictions.error": 0,
                          "graph_captures": 0}
        self._warm_ms = 0.0

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "LLMEngine":
        if self._thread is not None:
            return self
        if self.config.warmup_on_start:
            self._warmup()
        self._retag_pool()
        self._thread = _syncwatch.Thread(target=self._run, daemon=True,
                                         name="llm-scheduler")
        self._thread.start()
        return self

    def _warmup(self) -> None:
        """Run every prefill bucket once and, on CUDA, capture the decode
        step (on the CPU: run it once), so steady-state serving captures
        nothing. The warm-up writes junk into slot rows that every
        prefill zeroes before use."""
        t0 = time.monotonic()
        for lb in self.buckets:
            self._prefill_slot(np.zeros(lb, np.int32), 0)
        if self.device.type == "cuda":
            self._capture()
        else:
            self._decode_step(self._tok.numpy(), self._pos.numpy(),
                              replay=False)
        self._warm_ms = (time.monotonic() - t0) * 1000.0
        if _monitor._ENABLED:
            _monitor.gauge_set("llm.warm_start_ms", self._warm_ms)
            _monitor.count("llm.warmup_runs", len(self.buckets) + 1)

    @torch.no_grad()
    def _capture(self) -> None:
        """One eager decode step on a side stream (cuBLAS initialises
        lazily there), then the step captured over the static buffers."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._decode(self._tok, self._pos, self._pool, self._scales)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._decode(self._tok, self._pos, self._pool,
                               self._scales)
        self._graph, self._graph_out = graph, out
        self._counters["graph_captures"] += 1
        if _monitor._ENABLED:
            _monitor.count("llm.graph_captures")

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        if drain and self._thread is not None:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._pending and not self._active:
                        break
                time.sleep(0.01)
        with self._work:
            self._stopped = True
            self._work.notify_all()
        alive = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            alive = self._thread.is_alive()
            self._thread = None
        with self._lock:
            leftovers = list(self._pending) + list(self._active.values())
            self._pending.clear()
            self._active.clear()
            self._free = list(range(self.config.num_slots))
        for seq in leftovers:
            seq.stream._finish("stopped", "engine stopped")
        if not alive:
            # free the graph's memory pool; a scheduler still inside a
            # replay keeps it
            self._graph = self._graph_out = None

    # ---- submission --------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable] = None) -> LLMStream:
        """Queue one generation; returns its LLMStream immediately. Sheds
        with ServerOverloadedError on queue depth, like
        ServingEngine.submit. A `Tensor` prompt is read through its
        `numpy()`."""
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ServingError("empty prompt")
        if prompt.size > self.buckets[-1]:
            raise ServingError(
                f"prompt length {prompt.size} exceeds the largest prefill "
                f"bucket {self.buckets[-1]} (raise FLAGS_llm_max_len)")
        if self._stopped or self._thread is None:
            raise EngineStoppedError("LLM engine not running")
        if _slo._ENABLED and _slo.should_shed():
            self._counters["shed"] += 1
            if _monitor._ENABLED:
                _monitor.count("llm.shed")
            _slo.record_request(None, _slo.OUTCOME_REJECTED)
            raise ServerOverloadedError("shedding on SLO burn rate")
        budget = self.config.max_len - int(prompt.size)
        max_new = min(int(max_new_tokens or self.config.max_new_tokens),
                      max(budget, 1))
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        now = time.monotonic()
        deadline = now + deadline_ms / 1000.0 if deadline_ms else None
        with self._work:
            if len(self._pending) >= self.config.queue_depth:
                self._counters["shed"] += 1
                if _monitor._ENABLED:
                    _monitor.count("llm.shed")
                raise ServerOverloadedError(
                    f"llm queue full ({self.config.queue_depth})")
            self._next_id += 1
            stream = LLMStream(self._next_id, on_token)
            seq = _Seq(stream=stream, prompt=prompt, max_new=max_new,
                       deadline=deadline, submit_t=now)
            self._pending.append(seq)
            self._counters["requests"] += 1
            self._work.notify()
        if _monitor._ENABLED:
            _monitor.count("llm.requests")
        return stream

    def generate(self, prompt_ids: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 timeout: float = 600.0) -> List[int]:
        """Blocking convenience wrapper: submit + wait; raises the
        deadline/error terminal statuses as serving exceptions."""
        status, toks = self.submit(
            prompt_ids, max_new_tokens, deadline_ms).result(timeout)
        if status == "deadline":
            raise DeadlineExceededError("generation deadline exceeded")
        if status != "done":
            raise ServingError(f"generation {status}")
        return toks

    # ---- scheduler ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._work:
                if self._stopped:
                    return
                if not self._pending and not self._active:
                    self._work.wait(timeout=self.config.idle_park_s)
                    if self._stopped:
                        return
                pending_now = bool(self._pending)
            if pending_now:
                self._admit()
            if self._active:
                try:
                    self._step()
                except Exception as e:  # scheduler must survive
                    self._evict_all("error", f"{type(e).__name__}: {e}")

    def _admit(self) -> None:
        while True:
            with self._lock:
                if not self._free or not self._pending:
                    return
                seq = self._pending.popleft()
                slot = self._free.pop()
            now = time.monotonic()
            if seq.deadline is not None and now > seq.deadline:
                with self._lock:
                    self._free.append(slot)
                self._finish(seq, "deadline", "expired before admission")
                continue
            seq.slot, seq.admit_t = slot, now
            self._prefill_into(seq)

    def _slot_pages(self, slot: int):
        """(k, v) views of one slot's rows of the pool, per layer."""
        p = self._pool
        return [(p[2 * i][slot:slot + 1], p[2 * i + 1][slot:slot + 1])
                for i in range(self._n_layers)]

    @torch.no_grad()
    def _prefill_slot(self, prompt: np.ndarray, slot: int):
        """Prefill one prompt into `slot`'s page (and its int8 scales),
        padded to its bucket. Returns (first greedy token, last-position
        logits [1, V])."""
        plen = int(prompt.size)
        lb = next(b for b in self.buckets if b >= plen)
        padded = np.zeros((1, lb), np.int32)
        padded[0, :plen] = prompt
        first, last, scales = self._prefill(
            torch.from_numpy(padded).to(self.device),
            torch.full((1,), plen, dtype=torch.int32, device=self.device),
            self._slot_pages(slot))
        if self.config.kv_int8:
            for i, (ks, vs) in enumerate(scales):
                self._scales[2 * i][slot:slot + 1].copy_(ks)
                self._scales[2 * i + 1][slot:slot + 1].copy_(vs)
        return int(first[0]), last

    def _prefill_into(self, seq: _Seq) -> None:
        cfg = self.config
        plen = int(seq.prompt.size)
        first, _ = self._prefill_slot(seq.prompt, seq.slot)
        now = time.monotonic()
        seq.pos = plen
        seq.last_token = first
        seq.last_emit_t = now
        seq.stream.status = "running"
        seq.stream._emit(first)
        with self._lock:
            self._active[seq.slot] = seq
        if _monitor._ENABLED:
            _monitor.count("llm.prefill.requests")
            _monitor.count("llm.tokens_generated")
            _monitor.observe("llm.queue_wait", seq.admit_t - seq.submit_t)
            _monitor.observe("llm.ttft_ms", (now - seq.submit_t) * 1000.0)
            _monitor.gauge_set("llm.slots_active", len(self._active))
        # a one-token budget (or instant EOS) finishes without decoding
        if first == cfg.eos_token_id:
            self._evict(seq, "eos")
        elif len(seq.stream.tokens) >= seq.max_new:
            self._evict(seq, "length")

    @torch.no_grad()
    def _decode_step(self, toks: np.ndarray, pos: np.ndarray,
                     replay: bool = True):
        """One decode step of the whole pool from host tokens and
        positions [S]: copy them into the static buffers, then replay the
        captured graph (`replay`, and a graph was captured: CUDA, warmed
        up) or run the step eagerly.
        Returns the (next tokens [S], logits [S, V]) device tensors; the
        graph's are its static outputs, overwritten by the next replay."""
        self._tok.copy_(torch.from_numpy(toks))
        self._pos.copy_(torch.from_numpy(pos))
        if replay and self._graph is not None:
            self._graph.replay()
            return self._graph_out
        return self._decode(self._tok, self._pos, self._pool, self._scales)

    def _step(self) -> None:
        """One decode step for every active slot: dispatch, emit, evict.
        Fixed shapes: occupancy is data, not signature."""
        cfg = self.config
        now = time.monotonic()
        with self._lock:
            live = sorted(self._active.items())
        # the llm.decode fault site is checked once per in-flight
        # sequence so an injected error takes down exactly one of them
        for slot, seq in live:
            if seq.deadline is not None and now > seq.deadline:
                self._evict(seq, "deadline")
                continue
            if _faults._ENABLED:
                try:
                    _faults.check(self._FAULT_SITE)
                except Exception as e:
                    self._evict(seq, "error", f"{type(e).__name__}: {e}")
        with self._lock:
            live = sorted(self._active.items())
        if not live:
            return
        s = cfg.num_slots
        toks = np.zeros((s,), np.int32)
        pos = np.zeros((s,), np.int32)
        for slot, seq in live:
            toks[slot] = seq.last_token
            pos[slot] = seq.pos
        def _dispatch():
            report = lambda: {"kv_pool_bytes": self.kv_pool_bytes()}  # noqa: E731
            with _exe.dispatch_guard("llm_decode", report=report), \
                    _monitor.span("llm.decode_step"):
                return self._decode_step(toks, pos)[0].cpu().numpy()

        if _obs._TL_ENABLED and not _obs.in_phase():
            # the read-back above synchronizes the scheduler's stream, so
            # the phase holds the step's device time
            with _obs.timeline().phase("decode_step"):
                nxt = _dispatch()
        else:
            nxt = _dispatch()
        now = time.monotonic()
        for slot, seq in live:
            tok = int(nxt[slot])
            seq.pos += 1
            seq.last_token = tok
            seq.stream._emit(tok)
            if _monitor._ENABLED:
                _monitor.count("llm.tokens_generated")
                _monitor.observe("llm.inter_token_ms",
                                 (now - seq.last_emit_t) * 1000.0)
            seq.last_emit_t = now
            if tok == cfg.eos_token_id:
                self._evict(seq, "eos")
            elif len(seq.stream.tokens) >= seq.max_new \
                    or seq.pos >= cfg.max_len:
                self._evict(seq, "length")
            elif seq.deadline is not None and now > seq.deadline:
                self._evict(seq, "deadline")
        if _monitor._ENABLED:
            _monitor.count("llm.decode.steps")
            _monitor.gauge_set("llm.slots_active", len(self._active))

    # ---- eviction / bookkeeping --------------------------------------------

    def _evict(self, seq: _Seq, reason: str,
               error: Optional[str] = None) -> None:
        """Free the sequence's slot and terminate its stream. The pool
        row needs no scrub: free slots are never read (the validity mask
        keys off per-row positions) and the next prefill zeroes the whole
        page."""
        with self._lock:
            if self._active.pop(seq.slot, None) is not None:
                self._free.append(seq.slot)
        status = {"eos": "done", "length": "done"}.get(reason, reason)
        self._counters[f"evictions.{reason}"] = \
            self._counters.get(f"evictions.{reason}", 0) + 1
        if _monitor._ENABLED:
            _monitor.count(f"llm.evictions.{reason}")
        self._finish(seq, status, error)

    def _evict_all(self, status: str, error: str) -> None:
        with self._lock:
            live = list(self._active.values())
            self._active.clear()
            self._free = list(range(self.config.num_slots))
        for seq in live:
            self._counters["evictions.error"] += 1
            if _monitor._ENABLED:
                _monitor.count("llm.evictions.error")
            self._finish(seq, status, error)

    def _finish(self, seq: _Seq, status: str, error: Optional[str]) -> None:
        latency = time.monotonic() - seq.submit_t
        self._counters["completed"] += 1
        if _monitor._ENABLED:
            _monitor.count("llm.completed")
            _monitor.observe("llm.e2e_latency", latency)
        if _slo._ENABLED:
            outcome = {"done": _slo.OUTCOME_OK,
                       "deadline": _slo.OUTCOME_DEADLINE}.get(
                           status, _slo.OUTCOME_ERROR)
            _slo.record_request(
                latency if outcome == _slo.OUTCOME_OK else None, outcome)
        seq.stream._finish(status, error)

    def _retag_pool(self) -> None:
        if _mem._ENABLED:
            _mem.tag("kv_pool", [*self._pool, *self._scales],
                     origin="LLMEngine")

    # ---- introspection -----------------------------------------------------

    def kv_pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self._pool, *self._scales))

    def stats(self) -> dict:
        with self._lock:
            active, free, queued = (len(self._active), len(self._free),
                                    len(self._pending))
        return {
            "slots": self.config.num_slots, "active": active, "free": free,
            "queued": queued, "buckets": list(self.buckets),
            "page_len": self._page_len, "kv_pool_bytes": self.kv_pool_bytes(),
            "kv_int8": self.config.kv_int8, "quant": self.config.quant,
            "warm_start_ms": self._warm_ms,
            "counters": dict(self._counters),
        }
