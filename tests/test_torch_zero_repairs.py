"""The three repairs of `SPMDTrainStep`'s ZeRO path, over four gloo ranks
on the CPU (tests/torch_dist_runner.py `job_zero`), against the JAX
package's SPMDTrainStep on its 8-device CPU mesh.

- A norm clip at ZeRO stages 2 and 3 (dp 2 x sharding 2):
  `ClipGradByGlobalNorm(0.05)` and `ClipGradByNorm(0.05)` (per parameter)
  on tests/test_parallel.py's MLP with a 5-way head, whose bias stays
  whole over the sharding ranks (the norm counts it once), 4 SGD steps.
  SGD's update is the clipped gradient itself, so the clip shows in every
  parameter: losses and parameters within 1e-5 (1 + |ref|) of the
  reference's run at the same stage, and the first update equal, within
  1e-4 relative, to the clip of the whole gradient that the port's
  unclipped stage-1 run applied (the global norm and each parameter's,
  the clip active: the factors are well under 1).
- ZeRO-3 by units (sharding 2 x pp 2: the data group is the two sharding
  ranks): a tiny ErnieModel (embeddings, 2 ErnieLayers, the pooler: four
  units) over 3 AdamW steps is bit-equal to stage 1 from the same state
  (two-way sums over gloo are exact), and the most whole-parameter bytes
  held at once is at most the largest unit's; ErnieForPretraining, whose
  MLM head reads the word embeddings outside their unit, keeps them
  gathered for the step (the root group) and stays within 1e-6 of stage 1,
  in fp32 and in bf16 AMP (each unit's parameters cast inside the unit and
  the casts freed with them: the peak of whole parameters and casts is at
  most the root group's plus the largest unit's).
- `collective_signature(*batch)` before any step, for dp (bucketed) and
  ZeRO 1-3 with a global-norm clip: it changes no parameter, slot, shard
  or step count, returns (op, axis, shape, dtype, perm) records, is equal
  on every rank, and equals what the first step then issued.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.parallel import HybridCommunicateGroup as JHCG
from paddle_tpu.parallel import SPMDTrainStep as JSPMD
from paddle_tpu.parallel import topology as jtopo
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import spawn, topology as ttopo

import torch_dist_runner as runner

ZERO_CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                hidden_dropout_prob=0.0)


CLIP_LR = 0.5


class MLP(jnn.Layer):
    """tests/test_parallel.py's MLP (`classes` outputs; 4 there)."""

    def __init__(self, d=16, classes=4):
        super().__init__()
        self.fc1 = jnn.Linear(d, 4 * d)
        self.fc2 = jnn.Linear(4 * d, d)
        self.act = jnn.GELU()
        self.head = jnn.Linear(d, classes)

    def forward(self, x):
        return self.head(self.fc2(self.act(self.fc1(x))))


def _mlp_and_data(classes=4):
    """The reference test's model and batch (test_parallel.py:63-74)."""
    paddle.seed(42)
    np.random.seed(42)
    model = MLP(classes=classes)
    x = np.random.rand(16, 16).astype("float32")
    y = np.random.randint(0, 4, (16,))
    return model, x, y


@pytest.fixture(autouse=True)
def _fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


def _state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def zero_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero")
    model, x, y = _mlp_and_data()
    np.savez(out / "mlp_init.npz", **_state(model))
    np.savez(out / "mlp_data.npz", x=x, y=y, clip_lr=np.array(CLIP_LR))
    np.savez(out / "clip_init.npz", **_state(_mlp_and_data(classes=5)[0]))
    rng = np.random.default_rng(0)
    np.savez(out / "zero_in.npz", cfg=np.array(json.dumps(ZERO_CFG)),
             ids=rng.integers(0, 64, (4, 16)).astype(np.int32),
             target=rng.standard_normal((4, 32)).astype(np.float32),
             nsp=rng.integers(0, 2, (4,)).astype(np.int32))
    spawn(runner.run, args=("zero", str(out)), nprocs=4, backend="gloo",
          device="cpu", timeout=300)
    res = []
    for r in range(4):
        with np.load(out / f"zero_{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


def _ref_clip_run(stage, clip):
    model, x, y = _mlp_and_data(classes=5)
    hcg = JHCG(hybrid_configs={"dp_degree": 2, "sharding_degree": 2})
    c = jnn.ClipGradByGlobalNorm(0.05) if clip == "global" else \
        jnn.ClipGradByNorm(0.05)
    opt = paddle.optimizer.SGD(parameters=model.parameters(),
                               learning_rate=CLIP_LR, grad_clip=c)
    step = JSPMD(model, jnn.CrossEntropyLoss(), opt, mesh=hcg.get_mesh(),
                 sharding_stage=stage, donate=False)
    xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
    losses = np.array([float(step(xt, yt)) for _ in range(4)])
    return losses, _state(model)


@pytest.mark.parametrize("clip", ["global", "norm"])
@pytest.mark.parametrize("stage", [2, 3])
def test_norm_clip_at_zero_stage_matches_the_reference(zero_ranks, stage,
                                                       clip):
    want, params = _ref_clip_run(stage, clip)
    init = _state(_mlp_and_data(classes=5)[0])
    tag = f"clip_{clip}_{stage}"
    for r in zero_ranks:
        # the head's bias (5) stays whole over sharding 2: counted once
        assert "head.bias" in json.loads(str(r[f"{tag}_replicated"]))
        np.testing.assert_allclose(r[tag], want, rtol=1e-5, atol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(r[f"{tag}_p_{k}"], v, rtol=1e-5,
                                       atol=1e-5)
        # the first update is the clip of the whole gradient, which the
        # unclipped run's first update gives
        g = {k: (init[k] - r[f"clip_none_1_p1_{k}"]) / CLIP_LR for k in init}
        got = {k: (init[k] - r[f"{tag}_p1_{k}"]) / CLIP_LR for k in init}
        norms = {k: float(np.linalg.norm(v)) for k, v in g.items()}
        if clip == "global":
            total = float(np.sqrt(sum(n * n for n in norms.values())))
            factors = dict.fromkeys(g, 0.05 / max(total, 0.05))
            assert factors["head.bias"] < 0.5           # the clip is active
        else:
            factors = {k: min(1.0, 0.05 / n) for k, n in norms.items()}
            assert factors["head.bias"] < 0.5 and max(factors.values()) < 1
        for k in g:
            np.testing.assert_allclose(got[k], g[k] * factors[k],
                                       rtol=1e-4, atol=1e-6)


def _peak_bound(r, tag):
    """The root group's bytes plus the largest unit's."""
    sizes = {int(k): v for k, v in
             json.loads(str(r[f"{tag}_unit_bytes"])).items()}
    return sizes[-1] + max(v for g, v in sizes.items() if g >= 0)


def test_zero3_by_units_is_bit_equal_to_whole_gathers(zero_ranks):
    for r in zero_ranks:
        assert bool(r["untied_bit_equal"]), (r["untied_losses"],
                                             r["untied_max_diff"])
        sizes = {int(k): v for k, v in
                 json.loads(str(r["untied_unit_bytes"])).items()}
        assert len([g for g in sizes if g >= 0]) == 4     # emb, 2 layers,
        assert sizes[-1] == 0                             # pooler; no root
        assert 0 < int(r["untied_peak"]) <= max(sizes.values())
        assert int(r["tied_peak"]) <= _peak_bound(r, "tied")
        # the tied head's weight stays gathered for the step
        assert json.loads(str(r["tied_pinned"])) == [
            "ernie.embeddings.word_embeddings.weight"]
        assert float(r["tied_max_diff"]) <= 1e-6
        lu, lw = r["tied_losses"]
        np.testing.assert_allclose(lu, lw, rtol=1e-6)
        assert lu[-1] < lu[0]
        # under bf16 AMP each unit's parameters are cast inside the unit:
        # the same casts, so the same numbers, and only the tied weight
        # stays gathered; the casts are freed and made again with their
        # unit's whole parameters
        assert json.loads(str(r["tied_bf16_pinned"])) == [
            "ernie.embeddings.word_embeddings.weight"]
        assert float(r["tied_bf16_max_diff"]) <= 1e-6
        np.testing.assert_allclose(*r["tied_bf16_losses"], rtol=1e-6)
        sizes = json.loads(str(r["tied_bf16_unit_bytes"]))
        assert sum(sizes.values()) == sum(
            json.loads(str(r["tied_unit_bytes"])).values()) * 3 // 2
        assert int(r["tied_bf16_peak"]) <= _peak_bound(r, "tied_bf16")


@pytest.mark.parametrize("tag", ["dpb", "z1", "z2", "z3"])
def test_signature_before_any_step_changes_nothing(zero_ranks, tag):
    sig = json.loads(str(zero_ranks[0][f"{tag}_signature"]))
    assert sig and all(len(s) == 5 for s in sig)
    ops = [s[0] for s in sig]
    assert "pmean" in ops                     # the global loss
    if tag == "z2":
        assert "psum_scatter" in ops and "all_gather" in ops
    if tag == "z3":
        # units: gathers before each forward and each backward
        assert ops.count("all_gather") >= 6 and "psum_scatter" in ops
    for r in zero_ranks:
        assert bool(r[f"{tag}_unchanged"])
        assert json.loads(str(r[f"{tag}_signature"])) == sig
        assert json.loads(str(r[f"{tag}_issued"])) == sig
