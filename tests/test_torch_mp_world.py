"""`paddle_tpu_torch.parallel.mp_layers` and `SPMDTrainStep` over mp in a
world of four gloo ranks on the CPU (tests/torch_dist_runner.py
`job_mp`), against the JAX package on the same seeded numpy inputs.

- Each mp layer (column with and without the gathered output, row with
  and without a parallel input) against the reference's layer of the same
  weights without a mesh (its GSPMD regime computes the dense layer):
  outputs, input gradients and the gathered weight gradients within 1e-5
  (1 + |ref|). `VocabParallelEmbedding` and `ParallelCrossEntropy`
  against the reference's own shard_map cases (tests/test_parallel.py:
  242-280) and the dense loss's gradient.
- `GPTModel(use_mp=True)` under `GPTForCausalLM` with
  `GPTPretrainingCriterion(use_parallel_ce=True)` (loss and gathered
  gradients), and `ErnieModel(use_mp=True)` (outputs), each rank loading
  its slices of the reference's whole state by name; `state_dict()` gives
  the whole tensors back.
- SPMDTrainStep over {"mp_degree": 4}: tests/test_parallel.py's
  MLP(use_mp=True), 8 Adam steps, losses and parameters within 1e-5
  (1 + |ref|) of the reference's; the column weight's shard shape; a
  global and a per-parameter norm clip over the mp slices (one SGD step,
  whose update is the clipped gradient: the clip of the unclipped run's
  whole gradient within 1e-4 relative, with the pieces that stay whole
  over mp counted once); the
  collective signature before the first step (no state changed), equal
  on every rank and to what the step then issued; a rank whose hidden
  width differs diverges at its gradient bucket, the first collective
  whose shape depends on it.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import models as jmodels
from paddle_tpu.parallel import (ColumnParallelLinear, HybridCommunicateGroup,
                                 ParallelCrossEntropy, RowParallelLinear,
                                 SPMDTrainStep, VocabParallelEmbedding,
                                 create_mesh)
from paddle_tpu.parallel import topology as jtopo
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import spawn, topology as ttopo

import torch_dist_runner as runner
from torch_parity import dev, state_of

TOL = 1e-5
GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               max_seq_len=16, dropout=0.0)
ERNIE_CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 hidden_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class JMLP(jnn.Layer):
    """tests/test_parallel.py's MLP(use_mp=True)."""

    def __init__(self, d=16):
        super().__init__()
        self.fc1 = ColumnParallelLinear(d, 4 * d, gather_output=False)
        self.fc2 = RowParallelLinear(4 * d, d, input_is_parallel=True)
        self.act = jnn.GELU()
        self.head = jnn.Linear(d, 4)

    def forward(self, x):
        return self.head(self.fc2(self.act(self.fc1(x))))


def _reference_layers(rng):
    """The dense reference layers, their inputs and output gradients."""
    paddle.seed(0)
    layers = {"col_g": ColumnParallelLinear(16, 32, gather_output=True),
              "col_s": ColumnParallelLinear(16, 32, gather_output=False),
              "row_s": RowParallelLinear(32, 16, input_is_parallel=False),
              "row_p": RowParallelLinear(32, 16, input_is_parallel=True)}
    data = {"x16": _r(rng, 2, 3, 16), "x32": _r(rng, 2, 3, 32),
            "g16": _r(rng, 2, 3, 16), "g32": _r(rng, 2, 3, 32)}
    return layers, data


@pytest.fixture(scope="module")
def mp_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(0)
    layers, data = _reference_layers(rng)
    arrays = dict(data)
    for tag, layer in layers.items():
        arrays.update({f"{tag}.{k}": v for k, v in state_of(layer).items()})
    paddle.seed(1)
    emb = VocabParallelEmbedding(16, 8)
    arrays["emb.weight"] = state_of(emb)["weight"]
    arrays["ids"] = rng.integers(0, 16, (2, 5))
    arrays["g_emb"] = _r(rng, 2, 5, 8)
    arrays["logits"] = rng.random((6, 16), dtype=np.float32)
    arrays["labels"] = rng.integers(0, 16, (6, 1))
    paddle.seed(2)
    gpt = jmodels.GPTForCausalLM(jmodels.GPTModel(**GPT_CFG, use_mp=True))
    arrays.update({f"gpt.{k}": v for k, v in state_of(gpt).items()})
    paddle.seed(3)
    ernie = jmodels.ErnieModel(**ERNIE_CFG, use_mp=True)
    arrays.update({f"ernie.{k}": v for k, v in state_of(ernie).items()})
    arrays["tok"] = rng.integers(0, 64, (2, 16)).astype(np.int32)
    arrays["gpt_cfg"] = np.array(json.dumps(GPT_CFG))
    arrays["ernie_cfg"] = np.array(json.dumps(ERNIE_CFG))
    np.savez(out / "mp_in.npz", **arrays)
    paddle.seed(42)
    np.random.seed(42)
    mlp = JMLP()
    np.savez(out / "mlp_mp_init.npz", **state_of(mlp))
    np.savez(out / "mlp_data.npz", x=np.random.rand(16, 16).astype("float32"),
             y=np.random.randint(0, 4, (16,)))
    spawn(runner.run, args=("mp", str(out)), nprocs=4, backend="gloo",
          device="cpu", timeout=300)
    res = []
    for r in range(4):
        with np.load(out / f"mp_{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return {"ranks": res, "layers": layers, "data": data, "emb": emb,
            "arrays": arrays, "gpt": gpt, "ernie": ernie, "dir": out}


def _chunk(a, r, n=4):
    return np.split(a, n, axis=-1)[r]


@pytest.mark.parametrize("tag", ["col_g", "col_s", "row_s", "row_p"])
def test_linear_layers_match_the_dense_reference(mp_ranks, tag):
    layer = mp_ranks["layers"][tag]
    data = mp_ranks["data"]
    x = data["x16"] if tag.startswith("col") else data["x32"]
    g = data["g32"] if tag.startswith("col") else data["g16"]
    xt = paddle.to_tensor(x, stop_gradient=False)
    y = layer(xt)
    paddle.sum(y * paddle.to_tensor(g)).backward()
    want_y = y.numpy()
    want_grads = {n: p.gradient() for n, p in layer.named_parameters()}
    for r, res in enumerate(mp_ranks["ranks"]):
        got_y = res[f"{tag}_out"]
        assert dev(got_y, _chunk(want_y, r) if tag == "col_s"
                   else want_y) <= TOL
        if tag == "row_p":      # the rank's input is its slice
            assert dev(_chunk(res[f"{tag}_dx"], r),
                       _chunk(xt.gradient(), r)) <= TOL
        else:
            assert dev(res[f"{tag}_dx"], xt.gradient()) <= TOL
        for n, v in want_grads.items():
            assert dev(res[f"{tag}_g_{n}"], v) <= TOL, n
        # the rank holds its slice; state_dict() gives the whole weight
        shapes = json.loads(str(res[f"{tag}_shapes"]))
        state = json.loads(str(res[f"{tag}_state"]))
        whole = {n: list(p.shape) for n, p in layer.named_parameters()}
        assert state == whole
        w = whole["weight"]
        axis = 1 if tag.startswith("col") else 0
        assert shapes["weight"][axis] * 4 == w[axis]


def test_vocab_embedding_and_parallel_ce_match_the_reference(mp_ranks):
    from jax.experimental.shard_map import shard_map
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    a = mp_ranks["arrays"]
    # the reference's shard_map cases (tests/test_parallel.py:242-280)
    create_mesh({"mp": 4})
    emb = mp_ranks["emb"]
    w_full = a["emb.weight"]

    def body(w):
        emb.weight._value = w
        return emb(paddle.to_tensor(a["ids"]))._value

    want_emb = np.asarray(shard_map(body, mesh=jtopo.get_mesh(),
                                    in_specs=P("mp", None), out_specs=P(),
                                    check_rep=False)(jnp.asarray(w_full)))
    np.testing.assert_allclose(want_emb, w_full[a["ids"]], rtol=1e-6)
    pce = ParallelCrossEntropy()

    def ce_body(lg):
        return pce(paddle.to_tensor(lg), paddle.to_tensor(a["labels"]))._value

    want_ce = np.asarray(shard_map(ce_body, mesh=jtopo.get_mesh(),
                                   in_specs=P(None, "mp"), out_specs=P(),
                                   check_rep=False)(jnp.asarray(a["logits"])))
    lg = paddle.to_tensor(a["logits"], stop_gradient=False)
    dense = paddle.nn.functional.softmax_with_cross_entropy(
        lg, paddle.to_tensor(a["labels"]))
    paddle.sum(dense).backward()
    emb_grad = np.zeros_like(w_full)
    np.add.at(emb_grad, a["ids"].reshape(-1), a["g_emb"].reshape(-1, 8))
    for r, res in enumerate(mp_ranks["ranks"]):
        assert dev(res["emb_out"], want_emb) <= TOL
        assert dev(res["emb_g_weight"], emb_grad) <= TOL
        assert dev(res["ce_out"], want_ce) <= TOL
        assert dev(res["ce_out"], dense.numpy().reshape(6, 1)) <= TOL
        # each rank's logits gradient covers its vocabulary slice
        assert dev(_chunk(res["ce_dlogits"], r),
                   _chunk(lg.gradient(), r)) <= TOL


def test_models_with_use_mp_match_the_reference(mp_ranks):
    a = mp_ranks["arrays"]
    tok = paddle.to_tensor(a["tok"])
    gpt = mp_ranks["gpt"]
    crit = jmodels.GPTPretrainingCriterion(use_parallel_ce=True)
    loss = crit(gpt(tok), tok)
    loss.backward()
    want = {n: p.gradient() for n, p in gpt.named_parameters()}
    seq, pooled = mp_ranks["ernie"](tok)
    for res in mp_ranks["ranks"]:
        assert int(res["gpt_local_vocab"]) == GPT_CFG["vocab_size"] // 4
        assert dev(res["gpt_loss"], loss.numpy()) <= TOL
        for n, v in want.items():
            assert dev(res[f"gpt_g_{n}"], v) <= TOL, n
        assert dev(res["ernie_seq"], seq.numpy()) <= TOL
        assert dev(res["ernie_pooled"], pooled.numpy()) <= TOL
        assert bool(res["gpt_roundtrip"]) and bool(res["ernie_roundtrip"])


def test_spmd_over_mp_matches_the_reference(mp_ranks):
    """tests/test_parallel.py's {"mp_degree": 4} run (:81-84) and its
    shard shape (:99-112)."""
    paddle.seed(42)
    np.random.seed(42)
    hcg = HybridCommunicateGroup(hybrid_configs={"mp_degree": 4})
    model = JMLP()
    init = dict(np.load(mp_ranks["dir"] / "mlp_mp_init.npz"))
    for k, v in state_of(model).items():
        np.testing.assert_array_equal(v, init[k])
    opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                learning_rate=1e-2)
    step = SPMDTrainStep(model, jnn.CrossEntropyLoss(), opt,
                         mesh=hcg.get_mesh(), donate=False)
    data = np.load(mp_ranks["dir"] / "mlp_data.npz")
    x, y = paddle.to_tensor(data["x"]), paddle.to_tensor(data["y"])
    want = np.array([float(step(x, y)) for _ in range(8)])
    assert want[-1] < want[0]
    params = state_of(model)
    for res in mp_ranks["ranks"]:
        assert dev(res["spmd_losses"], want) <= TOL
        for k, v in params.items():
            assert dev(res[f"spmd_p_{k}"], v) <= TOL, k
        assert list(res["fc1_shard"]) == [16, 16]


@pytest.mark.parametrize("clip", ["global", "norm"])
def test_norm_clip_over_mp_slices(mp_ranks, clip):
    init = dict(np.load(mp_ranks["dir"] / "mlp_mp_init.npz"))
    for res in mp_ranks["ranks"]:
        g = {k: (init[k] - res[f"clip_none_p1_{k}"]) / 0.5 for k in init}
        got = {k: (init[k] - res[f"clip_{clip}_p1_{k}"]) / 0.5 for k in init}
        norms = {k: float(np.linalg.norm(v)) for k, v in g.items()}
        if clip == "global":
            total = float(np.sqrt(sum(n * n for n in norms.values())))
            factors = dict.fromkeys(g, 0.05 / max(total, 0.05))
        else:
            factors = {k: min(1.0, 0.05 / n) for k, n in norms.items()}
        # the clip is active on the pieces that stay whole over mp
        assert factors["fc2.bias"] < 0.5 and factors["head.bias"] < 0.5
        for k in g:
            np.testing.assert_allclose(got[k], g[k] * factors[k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_mp_signature_before_the_first_step(mp_ranks):
    ranks = mp_ranks["ranks"]
    sig = json.loads(str(ranks[0]["signature"]))
    ops = [s[0] for s in sig]
    # forward: fc2's all-reduce over mp (the batch needs no gradient, so
    # fc1's backward all-reduce is not issued); the gradient bucket over
    # the (lone) data group; the global loss
    assert ops == ["psum", "psum", "pmean"], sig
    assert sig[0][1] == "mp" and sig[0][2] == [16, 16]
    assert sig[1][1] == sig[2][1] == "data_axes"
    for res in ranks:
        assert bool(res["sig_unchanged"])
        assert json.loads(str(res["signature"])) == sig
        assert json.loads(str(res["issued"])) == sig


def test_a_diverging_rank_differs_at_its_first_divergent_collective(
        mp_ranks):
    from paddle_tpu_torch.parallel.collective import (CollectiveDesc,
                                                      first_divergence)
    seqs = json.loads(str(mp_ranks["ranks"][0]["diverged"]))

    def descs(s):
        return [CollectiveDesc(o, a, sh, dt, None if p is None else
                               [tuple(x) if isinstance(x, list) else x
                                for x in p]) for o, a, sh, dt, p in s]

    ref = descs(seqs[0])
    for r in (1, 2):
        assert first_divergence(ref, descs(seqs[r])) is None
    i = first_divergence(ref, descs(seqs[3]))
    assert i == 1, (i, seqs[0][:4], seqs[3][:4])
    assert seqs[3][i][0] == seqs[0][i][0] == "psum"
    assert seqs[3][i][2] != seqs[0][i][2]


def test_spmd_over_dp_mp_and_sharding_matches_the_reference(tmp_path):
    """tests/test_parallel.py's {"dp_degree": 2, "mp_degree": 2,
    "sharding_degree": 2} run at ZeRO stage 1 (:95-98) over eight ranks
    (`job_hybrid`): the rank's rows come from dp x sharding, mp ranks
    share them, the slots of each mp slice are sliced again over the
    sharding group."""
    paddle.seed(42)
    np.random.seed(42)
    hcg = HybridCommunicateGroup(hybrid_configs={
        "dp_degree": 2, "mp_degree": 2, "sharding_degree": 2})
    model = JMLP()
    np.savez(tmp_path / "mlp_mp_init.npz", **state_of(model))
    x = np.random.rand(16, 16).astype("float32")
    y = np.random.randint(0, 4, (16,))
    np.savez(tmp_path / "mlp_data.npz", x=x, y=y)
    spawn(runner.run, args=("hybrid", str(tmp_path)), nprocs=8,
          backend="gloo", device="cpu", timeout=300)
    opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                learning_rate=1e-2)
    step = SPMDTrainStep(model, jnn.CrossEntropyLoss(), opt,
                         mesh=hcg.get_mesh(), sharding_stage=1, donate=False)
    want = np.array([float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                     for _ in range(8)])
    assert want[-1] < want[0]
    params = state_of(model)
    coords = set()
    for r in range(8):
        with np.load(tmp_path / f"hybrid_{r}.npz") as z:
            assert dev(z["losses"], want) <= TOL
            for k, v in params.items():
                assert dev(z[f"p_{k}"], v) <= TOL, k
            coords.add(tuple(z["coord"]))
    assert len(coords) == 8
