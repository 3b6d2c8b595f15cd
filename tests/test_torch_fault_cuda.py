"""Slice 17 on cards: the guard, the meta-optimizers and MoE with expert
parallelism on CUDA tensors.

Every test is marked `cuda` and skips without a CUDA device; the CPU
tests (test_torch_guard.py, test_torch_meta_optimizers.py,
test_torch_moe.py, test_torch_elastic.py, test_torch_sharded_io.py) hold
the port to the JAX package. This file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fault_cuda.py
"""
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.guard import GuardConfig, PreemptedError, TrainGuard
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.parallel import moe, spawn
from paddle_tpu_torch.parallel.meta_optimizers import (DGCMomentumOptimizer,
                                                       recompute)

import torch_dist_runner as runner

# a GPT whose attention takes the flash kernels: bf16, head_dim 64, S 1024
CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
           max_seq_len=1024, dropout=0.0)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels and the ranks' "
                    "cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_device("gpu")
    yield torch.device("cuda", 0)
    pt.set_device("cpu")


def _step(seed):
    pt.seed(seed)
    net = pt.models.GPTForCausalLM(pt.models.gpt.GPTModel(**CFG))
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters())
    return pt.jit.TrainStep(net, pt.models.GPTPretrainingCriterion(), opt,
                            amp_dtype="bfloat16")


@pytest.mark.cuda
def test_guard_rollback_and_resume_through_the_flash_kernels(card, tmp_path):
    """A poisoned step rolls back bit-exactly; a SIGTERM, the checkpoint
    and resume() from another seed end bit-equal to an uninterrupted run
    under deterministic algorithms; every step launches the kernels."""
    rng = np.random.default_rng(0)
    batches = [(ids, ids) for ids in (
        torch.from_numpy(rng.integers(0, 512, (2, 1024))).to(card)
        for _ in range(4))]
    fwd = fa.flash_attention_fwd
    fwd.launches = 0
    step = _step(0)
    with TrainGuard(step, config=GuardConfig(snapshot_interval=1)) as g:
        g.set_cursor(0, 0)
        g.step(*batches[0])
        before = step.state_dict()
        emb = step.model.gpt.embeddings.word_embeddings.weight
        with torch.no_grad():
            emb[int(batches[1][0][0, 0])] = float("nan")
        assert g.step(*batches[1]) is None
        after = step.state_dict()
    for n in before["params"]:
        np.testing.assert_array_equal(before["params"][n],
                                      after["params"][n])
    assert fwd.launches == 2 * CFG["num_layers"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step = _step(0)
        with TrainGuard(step, config=GuardConfig(snapshot_interval=0)) as g:
            for i, b in enumerate(batches):
                g.set_cursor(0, i)
                g.step(*b)
        want = {n: t.clone() for n, t in step.named_param_arrays().items()}
        ckpt = str(tmp_path / "g")
        step = _step(0)
        with TrainGuard(step, ckpt_dir=ckpt,
                        config=GuardConfig(snapshot_interval=0)) as g:
            with pytest.raises(PreemptedError):
                for i, b in enumerate(batches):
                    g.set_cursor(0, i)
                    if i == 1:
                        os.kill(os.getpid(), signal.SIGTERM)
                    g.step(*b)
        step = _step(5)
        with TrainGuard(step, ckpt_dir=ckpt,
                        config=GuardConfig(snapshot_interval=0)) as g:
            start = g.resume()
            for i in range(start[1], len(batches)):
                g.set_cursor(0, i)
                g.step(*batches[i])
        got = step.named_param_arrays()
        assert all(torch.equal(got[n], want[n]) for n in want)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_recompute_with_dropout_and_dgc_on_the_card(card):
    pt.seed(0)
    blk = pt.nn.Sequential(pt.nn.Linear(64, 256), pt.nn.GELU(),
                           pt.nn.Dropout(0.3), pt.nn.Linear(256, 64))
    x = torch.randn(32, 64, device=card, requires_grad=True)

    def grads(rc):
        for p in blk.parameters():
            p.grad = None
        x.grad = None
        pt.seed(3)
        out = recompute(blk, x) if rc else blk(x)
        (out ** 2).sum().backward()
        return [p.grad.clone() for p in blk.parameters()] + [x.grad.clone()]

    for a, b in zip(grads(True), grads(False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # DGC on the card: k entries sent per parameter (more only on a tie),
    # and what is kept plus what is sent is the accumulation, exactly
    pt.seed(1)
    net = pt.nn.Linear(256, 256)
    sent = []
    opt = DGCMomentumOptimizer(pt.optimizer.SGD(
        parameters=net.parameters(), learning_rate=0.1), sparsity=0.99,
        allreduce=lambda t: sent.append(t.clone()) or t)
    params = list(net.parameters())
    for i in range(3):
        xb = torch.from_numpy(np.random.default_rng(i).normal(
            size=(8, 256)).astype(np.float32)).to(card)
        (net(xb) ** 2).sum().backward()
        grads = [p.grad.clone() for p in params]
        prev = [(opt._u.get(id(p)), opt._v.get(id(p))) for p in params]
        sent.clear()
        opt.step()
        opt.clear_grad()
        for p, g, (u0, v0), s in zip(params, grads, prev, sent):
            u = g if u0 is None else 0.9 * u0 + g
            acc = u if v0 is None else v0 + u
            k = max(1, int(p.numel() * 0.01))
            thresh = torch.topk(acc.abs().reshape(-1), k).values[-1]
            ties = int((acc.abs() == thresh).sum())
            n_sent = int((s != 0).sum())
            assert n_sent == k or (ties > 1 and k < n_sent < k + ties)
            assert torch.equal(opt._v[id(p)] + s, acc)


@pytest.mark.cuda
def test_moe_expert_parallel_on_cards(card, tmp_path):
    """ep 4 (NCCL on four cards, else four gloo ranks on cuda:0) against
    every expert local on each rank's tokens; the gate on the card against
    the CPU."""
    n = torch.cuda.device_count()
    backend, gpus = ("nccl", "0,1,2,3") if n >= 4 else ("gloo", "0,0,0,0")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64, 32)).astype(np.float32)
    np.savez(tmp_path / "moe_in.npz", x=x, cfg=np.array([32, 64, 8, 2, 3]),
             buckets=rng.normal(size=(8, 4, 32)).astype(np.float32),
             counts=np.array([4, 2, 0, 3, 1, 4, 0, 2], np.int32))
    spawn(runner.run, args=("moe", str(tmp_path)), nprocs=4,
          backend=backend, gpus=gpus, timeout=300)
    for r in range(4):
        got = dict(np.load(tmp_path / f"moe_{r}.npz"))
        np.testing.assert_allclose(got["ep_y"], got["local_y"], rtol=1e-5,
                                   atol=1e-5)
        assert got["ep_aux"] == got["local_aux"]
    lg = torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32))
    cpu = moe.top_k_gating(lg, 2)
    gpu = moe.top_k_gating(lg.to(card), 2)
    assert torch.equal(cpu[0], gpu[0].cpu())
    torch.testing.assert_close(cpu[1], gpu[1].cpu(), rtol=0, atol=3e-7)
