"""LLM serving in the port (`paddle_tpu_torch.serving.LLMEngine` over
`GPTForCausalLM.forward_cached`) against the JAX package, at the small GPT
of tests/test_llm_serving.py (vocab 64, hidden 32, 2 layers, 4 heads,
max_seq_len 128), its weights moved across by name. Inputs come from numpy
seeds. Decode bit-identity and int8 top-1 agreement are not taken from the
reference as oracles (its own tests of them fail under this jax); the
port's decode is held to its own full forward within a stated tolerance."""
import json
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.serving import LLMConfig as JLLMConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.serving import (EngineStoppedError, LLMConfig,
                                      LLMEngine, ServerOverloadedError,
                                      ServingError)
from paddle_tpu_torch.serving.llm import _prefill_ladder
from paddle_tpu_torch.utils import load_numpy_state

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
# fp32 logits of magnitude ~10 through two layers and the tied head: XLA
# and PyTorch differ only in summation order (observed <= 5e-6)
TOL = 1e-5
# an int8 page's scale is max|x| / 127 of its K or V rows, which the two
# packages' projections give within an ulp (observed 1.3e-7 relative), so
# the scales agree to ~1 ulp and the int8 pages exactly
SCALE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture()
def monitored():
    pt.monitor.reset()
    pt.set_flags({"FLAGS_monitor": True})
    yield pt.monitor
    pt.set_flags({"FLAGS_monitor": False})
    pt.monitor.reset()


def _jax_lm(seed=7, **kw):
    paddle.seed(seed)
    lm = JGPTForCausalLM(JGPTModel(**dict(CFG, **kw)))
    lm.eval()
    return lm


def _port_lm(jlm, **kw):
    lm = pt.models.GPTForCausalLM(pt.models.GPTModel(**dict(CFG, **kw)))
    load_numpy_state(lm, {k: np.asarray(v._value)
                          for k, v in jlm.state_dict().items()})
    lm.eval()
    return lm


def _prompts(n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=int(k)).tolist()
            for k in rng.integers(2, 14, size=n)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _port_step(lm, ids, kv, pos, scales=None):
    with torch.no_grad():
        return lm.forward_cached(torch.from_numpy(np.asarray(ids, np.int32)),
                                 kv, torch.tensor(pos, dtype=torch.int32),
                                 scales)


# ---- forward_cached against the JAX package ----

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_forward_cached_matches_the_jax_package(dtype):
    """Prefill then 4 decode steps (blocks of 2, row 0 real): logits and
    fp32 pages within TOL (1 + |ref|), int8 pages exactly, their scales
    within SCALE_TOL (1 + |ref|)."""
    jlm = _jax_lm()
    lm = _port_lm(jlm)
    prompt, page = [5, 17, 3, 8, 9, 1], 16
    jkv = jlm.gpt.init_kv_cache(1, page, dtype=dtype)
    kv = lm.gpt.init_kv_cache(1, page, dtype=dtype)
    assert [tuple(k.shape) for k, _ in kv] == [(1, page, 4, 8)] * 2
    assert kv[0][0].dtype == getattr(torch, dtype)
    ids, pos = [prompt], [0]
    jsc = sc = None
    for step in range(5):
        jl, jkv, jnew = jlm.forward_cached(
            paddle.to_tensor(np.asarray(ids, np.int32)), jkv,
            paddle.to_tensor(np.asarray(pos, np.int32)), jsc)
        logits, kv2, new = _port_step(lm, ids, kv, pos, sc)
        assert all(a is b for pa, pb in zip(kv, kv2) for a, b in zip(pa, pb))
        _close(logits.numpy(), jl.numpy())
        for (jk, jv), (k, v) in zip(jkv, kv):
            for ja, a in ((jk, k), (jv, v)):
                if dtype == "int8":
                    np.testing.assert_array_equal(a.numpy(),
                                                  np.asarray(ja._value))
                else:
                    _close(a.numpy(), np.asarray(ja._value))
        if dtype == "int8":
            for (jks, jvs), (ks, vs) in zip(jnew, new):
                _close(ks.numpy(), jks.numpy(), SCALE_TOL)
                _close(vs.numpy(), jvs.numpy(), SCALE_TOL)
            jsc, sc = jnew, new
        else:
            assert all(s == (None, None) for s in new)
        nxt = int(logits.numpy()[0, -1 if step == 0 else 0].argmax())
        pos = [pos[0] + len(ids[0]) if step == 0 else pos[0] + 1]
        ids = [[nxt, nxt]]


def test_out_of_range_position_gives_a_nan_row_in_both_packages():
    """max_seq_len 16, a page of 18 (max_len 16 + the decode block of 2),
    15 prompt tokens, then the decode step at position 15: its junk row
    embeds position 16, one past the table. The reference's take fills
    that row with NaN and the real row reads 0 * NaN from its V; the port
    gives the same NaN row, from a clamped gather (no index error)."""
    jlm = _jax_lm(max_seq_len=16)
    lm = _port_lm(jlm, max_seq_len=16)
    prompt = list(np.random.default_rng(0).integers(0, 64, size=15))
    jkv = jlm.gpt.init_kv_cache(1, 18)
    kv = lm.gpt.init_kv_cache(1, 18)
    jl, jkv, _ = jlm.forward_cached(
        paddle.to_tensor(np.asarray([prompt], np.int32)), jkv,
        paddle.to_tensor(np.zeros(1, np.int32)))
    logits, _, _ = _port_step(lm, [prompt], kv, [0])
    nxt = int(logits.numpy()[0, -1].argmax())
    assert nxt == int(jl.numpy()[0, -1].argmax())
    blk = np.asarray([[nxt, nxt]], np.int32)
    jl, _, _ = jlm.forward_cached(paddle.to_tensor(blk), jkv,
                                  paddle.to_tensor(np.asarray([15], np.int32)))
    logits, _, _ = _port_step(lm, blk, kv, [15])
    for row in (jl.numpy()[0, 0], logits.numpy()[0, 0]):
        assert np.isnan(row).all()
        assert int(row.argmax()) == 0
    assert int(torch.from_numpy(logits.numpy()[0, 0]).argmax()) == 0


def test_the_engine_stops_before_the_out_of_range_position():
    """At max_len == max_seq_len the token budget (max_new <= max_len -
    prompt) ends each sequence one decode step before the position above:
    the port's tokens are the reference engine's, with no NaN step."""
    jlm = _jax_lm(max_seq_len=16)
    lm = _port_lm(jlm, max_seq_len=16)
    cfg = dict(num_slots=2, max_len=16, max_new_tokens=64)
    prompts = [[1, 2], [3] * 14, [4] * 15]
    jeng = JLLMEngine(jlm, JLLMConfig(**cfg)).start()
    eng = LLMEngine(lm, LLMConfig(**cfg), device="cpu").start()
    try:
        for p in prompts:
            want = jeng.submit(p).result(60.0)
            assert eng.submit(p).result(60.0) == want
            assert len(want[1]) == 16 - len(p)
    finally:
        jeng.stop()
        eng.stop()


# ---- the port's decode against its own full forward ----

def test_prefill_is_bit_equal_to_the_full_forward_on_a_page_of_its_length():
    lm = _port_lm(_jax_lm())
    prompt = [[5, 17, 3, 8, 9, 1]]
    logits, _, _ = _port_step(lm, prompt, lm.gpt.init_kv_cache(1, 6), [0])
    with torch.no_grad():
        full = lm(torch.tensor(prompt, dtype=torch.int32))
    assert torch.equal(logits, full)


def test_decode_matches_the_ports_own_full_forward():
    """Prefill + 4 decode steps on a page of 16 against the full forward
    of the sequence so far, within TOL (1 + |ref|): not bitwise, because
    the masked keys past the live prefix lengthen the softmax and p v
    reductions, which changes their summation order."""
    lm = _port_lm(_jax_lm())
    seq = [5, 17, 3, 8]
    kv = lm.gpt.init_kv_cache(1, 16)
    logits, _, _ = _port_step(lm, [seq], kv, [0])
    nxt = int(logits[0, -1].argmax())
    for _ in range(4):
        logits, _, _ = _port_step(lm, [[nxt, nxt]], kv, [len(seq)])
        seq.append(nxt)
        with torch.no_grad():
            full = lm(torch.tensor([seq], dtype=torch.int32))
        _close(logits[0, 0].numpy(), full[0, -1].numpy())
        nxt = int(logits[0, 0].argmax())
        assert nxt == int(full[0, -1].argmax())


# ---- the engine ----

def _jax_greedy_equal(jlm, prompts, outputs):
    """Each of `outputs` is the JAX package's full-recompute greedy decode
    of its prompt: one full forward over prompt + tokens[:-1] whose argmax
    at every generated position is the next token (the causal model's
    logits at a position see only the tokens before it, so this is the
    greedy loop's condition, step by step). The sequences go through one
    batched forward, right-padded: padding after a position does not
    reach its logits."""
    seqs = [list(p) + list(t[:-1]) for p, t in zip(prompts, outputs)]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, seq in enumerate(seqs):
        batch[i, :len(seq)] = seq
    logits = jlm(paddle.to_tensor(batch)).numpy()
    return [list(logits[i, len(p) - 1:len(p) - 1 + len(t)].argmax(-1))
            == list(t) for i, (p, t) in enumerate(zip(prompts, outputs))]


def test_engine_tokens_match_the_jax_greedy_decode_and_pool_bytes():
    jlm = _jax_lm()
    lm = _port_lm(jlm)
    cfg = dict(num_slots=8, max_len=32, max_new_tokens=16)
    eng = LLMEngine(lm, LLMConfig(**cfg), device="cpu").start()
    try:
        prompts = _prompts()
        results = [s.result(60.0) for s in [eng.submit(p) for p in prompts]]
    finally:
        eng.stop()
    assert all(st == "done" and len(t) == 16 for st, t in results)
    assert all(_jax_greedy_equal(jlm, prompts, [t for _, t in results]))
    for kv_int8 in (False, True):
        c = dict(cfg, kv_int8=kv_int8)
        jeng = JLLMEngine(_jax_lm(), JLLMConfig(**c))
        eng = LLMEngine(_port_lm(jlm), LLMConfig(**c), device="cpu")
        assert eng.kv_pool_bytes() == jeng.kv_pool_bytes()
        jeng.stop()


def test_int8_engine_matches_the_jax_int8_engine():
    """quant="int8" + kv_int8: the same tokens as the JAX package's engine
    in the same arm (int8 weights and pages, scales per slot)."""
    jlm = _jax_lm(seed=11)
    lm = _port_lm(jlm)
    cfg = dict(num_slots=4, max_len=32, max_new_tokens=10, quant="int8",
               kv_int8=True)
    prompts = [[5, 17, 3], [11, 2, 9, 4, 44, 7], [1], [23, 8, 30, 2],
               [9, 9, 1, 63]]
    jeng = JLLMEngine(jlm, JLLMConfig(**cfg)).start()
    eng = LLMEngine(lm, LLMConfig(**cfg), device="cpu").start()
    try:
        want = [s.result(60.0) for s in [jeng.submit(p) for p in prompts]]
        got = [s.result(60.0) for s in [eng.submit(p) for p in prompts]]
    finally:
        jeng.stop()
        eng.stop()
    assert got == want
    fp32 = 2 * 2 * 4 * eng._page_len * 4 * 8 * 4
    assert eng.kv_pool_bytes() < fp32 / 2


def test_kv_pool_bytes_follow_the_config_formula():
    lm = _port_lm(_jax_lm())
    for kv_int8 in (False, True):
        cfg = LLMConfig(num_slots=3, max_len=40, kv_int8=kv_int8)
        eng = LLMEngine(lm, cfg, device="cpu")
        page = cfg.max_len + cfg.decode_block
        want = 2 * 2 * 3 * page * 4 * 8 * (1 if kv_int8 else 4) + \
            (2 * 2 * 3 * 4 if kv_int8 else 0)
        assert eng.kv_pool_bytes() == want == eng.stats()["kv_pool_bytes"]
        assert eng.stats()["page_len"] == page


def test_monitor_counters_after_eight_requests(monitored):
    lm = _port_lm(_jax_lm())
    eng = LLMEngine(lm, LLMConfig(num_slots=8, max_len=32,
                                  max_new_tokens=16), device="cpu").start()
    try:
        results = [s.result(60.0) for s in [eng.submit(p)
                                            for p in _prompts()]]
    finally:
        eng.stop()
    assert all(st == "done" for st, _ in results)
    snap = monitored.snapshot()
    assert snap["counters"]["llm.requests"] == 8
    assert snap["counters"]["llm.prefill.requests"] == 8
    assert snap["counters"]["llm.tokens_generated"] == 8 * 16
    assert snap["counters"]["llm.decode.steps"] > 0
    assert snap["counters"]["llm.evictions.length"] == 8
    assert snap["counters"]["llm.warmup_runs"] == len(eng.buckets) + 1
    assert "llm.graph_captures" not in snap["counters"]   # the CPU: eager
    assert "llm.slots_active" in snap["gauges"]
    assert snap["gauges"]["llm.warm_start_ms"] > 0
    hist = snap["histograms"]
    assert hist["llm.ttft_ms"]["count"] == 8
    assert hist["llm.inter_token_ms"]["count"] == 8 * 15
    assert hist["llm.e2e_latency"]["count"] == 8
    assert hist["llm.queue_wait"]["count"] == 8
    assert hist["llm.ttft_ms"]["p99"] >= hist["llm.ttft_ms"]["p50"] > 0


class TestPrefillLadder:
    def test_powers_of_two_default(self):
        assert _prefill_ladder(64) == [8, 16, 32, 64]
        assert _prefill_ladder(48) == [8, 16, 32, 48]
        assert _prefill_ladder(8) == [8]

    def test_declared_buckets_clamped(self):
        assert _prefill_ladder(32, (16, 64, 32)) == [16, 32]
        # all-invalid declarations fall back to the default ladder
        assert _prefill_ladder(16, (99,)) == [8, 16]


def _blocked_engine(**cfg):
    """A started one-slot engine whose scheduler is held inside the first
    token callback of a request until the returned event is set."""
    lm = _port_lm(_jax_lm())
    eng = LLMEngine(lm, LLMConfig(num_slots=1, max_len=16, **cfg),
                    device="cpu").start()
    entered, release = threading.Event(), threading.Event()

    def hold(i, tok):
        entered.set()
        release.wait(30.0)

    first = eng.submit([1, 2, 3], on_token=hold)
    assert entered.wait(30.0)
    return eng, first, release


def test_submit_validation_and_queue_shedding():
    eng, first, release = _blocked_engine(max_new_tokens=4, queue_depth=1)
    try:
        with pytest.raises(ServingError, match="exceeds the largest"):
            eng.submit(list(range(17)))
        with pytest.raises(ServingError, match="empty prompt"):
            eng.submit([])
        queued = eng.submit([4, 5])
        with pytest.raises(ServerOverloadedError, match="queue full"):
            eng.submit([6, 7])
        assert eng.stats()["counters"]["shed"] == 1
        release.set()
        assert first.result(30.0)[0] == "done"
        assert queued.result(30.0)[0] == "done"
    finally:
        release.set()
        eng.stop()
    with pytest.raises(EngineStoppedError):
        eng.submit([1, 2])


def test_stop_finishes_leftovers_as_stopped():
    eng, first, release = _blocked_engine(max_new_tokens=8)
    queued = eng.submit([4, 5])
    threading.Timer(0.2, release.set).start()
    eng.stop(drain=False)
    assert first.result(5.0)[0] == "stopped"
    assert queued.result(5.0) == ("stopped", [])
    assert queued.error == "engine stopped"
    assert eng.stats()["free"] == 1


def test_deadline_eviction_mid_decode(monitored):
    """A callback that takes 30 ms per token holds the scheduler; the
    150 ms deadline passes after a few tokens and the sequence is
    evicted between decode steps."""
    lm = _port_lm(_jax_lm())
    eng = LLMEngine(lm, LLMConfig(num_slots=2, max_len=64,
                                  max_new_tokens=48), device="cpu").start()
    try:
        status, toks = eng.submit(
            [5, 6], deadline_ms=150.0,
            on_token=lambda i, t: time.sleep(0.03)).result(60.0)
        assert status == "deadline"
        assert 0 < len(toks) < 48
        assert monitored.snapshot()["counters"]["llm.evictions.deadline"] \
            == 1
        assert eng.stats()["free"] == 2
    finally:
        eng.stop()


def test_generate_and_config_from_flags():
    pt.set_flags({"FLAGS_llm_num_slots": 2, "FLAGS_llm_max_len": 24,
                  "FLAGS_llm_prefill_buckets": "12,24",
                  "FLAGS_llm_max_new_tokens": 3,
                  "FLAGS_llm_default_deadline_ms": 0.0})
    try:
        cfg = LLMConfig.from_flags()
        assert (cfg.num_slots, cfg.max_len, cfg.prefill_buckets,
                cfg.max_new_tokens, cfg.default_deadline_ms,
                cfg.quant, cfg.kv_int8) == (2, 24, (12, 24), 3, None,
                                            "off", False)
        jlm = _jax_lm()
        eng = LLMEngine(_port_lm(jlm), device="cpu").start()
        try:
            assert eng.buckets == [12, 24]
            toks = eng.generate([7, 8, 9])
            assert len(toks) == 3
            assert _jax_greedy_equal(jlm, [[7, 8, 9]], [toks]) == [True]
        finally:
            eng.stop()
    finally:
        pt.set_flags({"FLAGS_llm_num_slots": 8, "FLAGS_llm_max_len": 256,
                      "FLAGS_llm_prefill_buckets": "",
                      "FLAGS_llm_max_new_tokens": 64})


def test_engine_raises_without_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    lm = _port_lm(_jax_lm())
    pt.set_device("gpu")
    try:
        with pytest.raises(UnavailableError):
            LLMEngine(lm, LLMConfig(num_slots=1, max_len=16))
        LLMEngine(lm, LLMConfig(num_slots=1, max_len=16), device="cpu")
    finally:
        pt.set_device("cpu")


def test_bench_llm_arm_prints_one_json_line(capsys):
    """`python -m paddle_tpu_torch.utils.bench --arm llm --device cpu`:
    bench.py's CPU sizes, both arms, one JSON line with its keys."""
    from paddle_tpu_torch.utils import bench
    bench.main(["--arm", "llm", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["arm"] == "llm" and r["device"] == "cpu"
    assert r["int8_decode_speedup"] > 0
    for arm in ("fp32", "int8"):
        m = r[arm]
        for key in ("prefill_tokens_per_s", "decode_tokens_per_s",
                    "kv_pool_mb", "warm_start_ms"):
            assert m[key] > 0, key
        for key in ("ttft_ms", "inter_token_ms"):
            assert set(m[key]) == {"p50", "p95", "p99"}
        assert m["requests"] == 8 and m["steady_state_captures"] == 0
    assert r["int8"]["kv_pool_mb"] < r["fp32"]["kv_pool_mb"] / 2
