"""`PipelineParallel` across processes: four gloo ranks on the CPU
(tests/torch_dist_runner.py `job_pp`) through `fleet.init` ->
`distributed_model` -> `distributed_optimizer` -> `train_batch`, against
the JAX package's single-controller PipelineParallel on its 8-device CPU
mesh, from one state.

A tiny `gpt_pipeline_layer` (vocabulary 64, hidden 32, 4 layers, 2 heads,
sequence 16, dropout 0) at pp 2 x mp 2 (use_mp=True) and at pp 2 x dp 2,
2 micro-batches, 3 SGD(0.1) steps with `ClipGradByGlobalNorm(0.5)`:
losses and the gathered whole parameters within 1e-5 (1 + |ref|) of the
reference's single controller at pp 2 x mp 2 x dp 2 (its stage programs
compute the dense model, whatever the degrees). Every rank's stage holds only its layers (the mp ranks their
slices); `last_peak_inflight` is at most the number of stages; the
collective signature (traced before the first step) is equal on the
ranks of one stage and equal to what that step then issued. What the
process form does not run yet raises, naming ROADMAP.md.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import models as jmodels
from paddle_tpu.parallel import HybridCommunicateGroup as JHCG
from paddle_tpu.parallel import topology as jtopo
from paddle_tpu.parallel.pipeline_parallel import PipelineParallel as JPP
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import spawn, topology as ttopo

import torch_dist_runner as runner
from torch_parity import dev, state_of

CFG = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=2,
           max_seq_len=16, dropout=0.0)
MICRO, LR, CLIP, STEPS = 2, 0.1, 0.5, 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


def _reference(state, ids):
    """The reference's single controller at pp 2 x mp 2 x dp 2 on its mesh
    (use_mp=True): its GSPMD stage programs compute the dense model, the
    numbers both port worlds (pp 2 x mp 2, pp 2 x dp 2) must give."""
    hcg = JHCG(hybrid_configs={"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 2})
    pl = jmodels.gpt_pipeline_layer(num_stages=2, use_mp=True, **CFG)
    pl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    engine = JPP(pl, hcg, None)
    engine.accumulate_steps = MICRO
    opt = paddle.optimizer.SGD(parameters=pl.parameters(), learning_rate=LR,
                               grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
    t = paddle.to_tensor(ids)
    losses = np.array([float(engine.train_batch([t, t], opt))
                       for _ in range(STEPS)])
    return losses, state_of(pl)


@pytest.fixture(scope="module")
def pp_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    paddle.seed(5)
    pl = jmodels.gpt_pipeline_layer(num_stages=2, use_mp=True, **CFG)
    state = state_of(pl)
    ids = np.random.default_rng(0).integers(0, 64, (8, 16)).astype(np.int32)
    np.savez(out / "pp_in.npz", cfg=np.array(json.dumps(CFG)), ids=ids,
             micro=np.array(MICRO), lr=np.array(LR), clip=np.array(CLIP),
             **state)
    spawn(runner.run, args=("pp", str(out)), nprocs=4, backend="gloo",
          device="cpu", timeout=300)
    res = []
    for r in range(4):
        with np.load(out / f"pp_{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res, state, ids, _reference(state, ids)


@pytest.mark.parametrize("tag", ["ppmp", "ppdp"])
def test_process_pipeline_matches_the_reference(pp_ranks, tag):
    res, state, ids, (want_losses, want) = pp_ranks
    assert want_losses[-1] < want_losses[0]
    got = {}
    for r in res:
        assert dev(r[f"{tag}_losses"], want_losses) <= TOL
        stage_keys = [k[len(tag) + 3:] for k in r if k.startswith(
            f"{tag}_p_")]
        # a stage holds only its own entries
        first = {int(k.split(".")[0]) for k in stage_keys}
        assert (max(first) < 3) if int(r[f"{tag}_stage"]) == 0 else \
            (min(first) >= 3)
        for k in stage_keys:
            got[k] = r[f"{tag}_p_{k}"]
        assert int(r[f"{tag}_peak"]) <= 2
        assert str(r[f"{tag}_device"]) == "cpu"
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert dev(got[k], v) <= TOL, k


@pytest.mark.parametrize("tag", ["ppmp", "ppdp"])
def test_stage_signatures_agree_and_match_the_step(pp_ranks, tag):
    res = pp_ranks[0]
    by_stage = {}
    for r in res:
        sig = json.loads(str(r[f"{tag}_signature"]))
        assert sig == json.loads(str(r[f"{tag}_issued"]))
        by_stage.setdefault(int(r[f"{tag}_stage"]), []).append(sig)
    assert sorted(by_stage) == [0, 1]
    for stage, sigs in by_stage.items():
        assert all(s == sigs[0] for s in sigs[1:])
        ops = [s[0] for s in sigs[0]]
        # stage 0 sends activations and receives gradients, stage 1 the
        # reverse; then the clip norm over pp and the loss broadcast
        assert ops.count("send") == MICRO and ops.count("recv") == MICRO
        assert "broadcast" in ops
        if tag == "ppmp":
            assert any(s[1] == "mp" for s in sigs[0])
        else:
            assert any(s[1] == "data_axes" for s in sigs[0])


def test_what_remains_raises_across_processes(pp_ranks):
    """Interleaved virtual stages, a SharedLayerDesc that spans stages and
    sp across processes raise, each naming its ROADMAP.md item."""
    for r in pp_ranks[0]:
        raised = json.loads(str(r["raised"]))
        assert "process-form interleave" in raised["interleave"]
        assert "SharedLayerDesc across processes" in raised["shared"]
        assert "sp across processes" in raised["sp"]
