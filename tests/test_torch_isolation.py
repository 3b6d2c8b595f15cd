"""`paddle_tpu_torch` stands alone: it imports neither jax nor the JAX
package, and with no CUDA device and no explicit CPU request its entry
points raise instead of running on the CPU."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _run(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        for mod in _top_level_imports(path):
            if mod.split(".")[0] in FORBIDDEN:
                offenders.append(f"{os.path.relpath(path, ROOT)}: {mod}")
    assert not offenders, offenders


def test_small_gpt_runs_with_jax_and_the_jax_package_blocked():
    res = _run("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        pt.seed(0)
        model = pt.models.GPTForCausalLM(pt.models.GPTModel(
            vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=64))
        pred = pt.inference.Predictor(
            model, input_spec=[pt.InputSpec([2, 64], "int32")])
        engine = pt.serving.ServingEngine(pred, pt.serving.EngineConfig(
            max_batch_size=2, batch_sizes=(1, 2)))
        engine.start()
        ids = np.arange(64, dtype=np.int32)[None] % 256
        out = engine.submit([ids]).result(60)[0]
        engine.stop()
        assert out.shape == (1, 64, 256) and np.isfinite(out).all()
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_small_gpt_trains_with_jax_and_the_jax_package_blocked(tmp_path):
    res = _run(f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        pt.seed(0)
        model = pt.models.GPTForCausalLM(pt.models.GPTModel(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=32, dropout=0.0))
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        step = pt.jit.TrainStep(model, pt.models.GPTPretrainingCriterion(),
                                opt, amp_dtype="bfloat16")
        ids = np.arange(64, dtype=np.int32).reshape(2, 32) % 256
        losses = [float(step(ids, ids)) for _ in range(3)]
        assert losses[-1] < losses[0], losses
        pt.save(step.state_dict(), {str(tmp_path / "s.pdparams")!r})
        step.set_state_dict(pt.load({str(tmp_path / "s.pdparams")!r}))
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_small_ernie_trains_over_the_sp_ring_with_jax_blocked():
    res = _run("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        pt.seed(0)
        pt.parallel.HybridCommunicateGroup(
            hybrid_configs={"sp_degree": 4}, devices=["cpu"] * 4)
        net = pt.models.ErnieForPretraining(pt.models.ErnieModel(
            vocab_size=128, hidden_size=64, num_hidden_layers=1,
            num_attention_heads=1, intermediate_size=128,
            hidden_dropout_prob=0.0, use_sp=True))
        ce = pt.nn.CrossEntropyLoss()
        def loss_fn(logits, nsp_logits, ids, nsp):
            return ce(logits.reshape(-1, 128), ids.reshape(-1)) + \\
                ce(nsp_logits, nsp)
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())
        step = pt.jit.TrainStep(net, loss_fn, opt, amp_dtype="bfloat16",
                                n_model_inputs=1)
        ids = np.arange(1024, dtype=np.int64).reshape(2, 512) % 128
        nsp = np.array([0, 1])
        losses = [float(step(ids, ids, nsp)) for _ in range(3)]
        assert losses[-1] < losses[0], losses
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda_or_a_cpu_request():
    res = _run("""
        import torch
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.core.enforce import UnavailableError
        assert not torch.cuda.is_available()
        assert pt.get_device() == "gpu:0"          # the default place
        def raises(fn):
            try:
                fn()
            except UnavailableError as e:
                assert "set_device('cpu')" in str(e)
                return True
            return False
        assert raises(lambda: pt.models.GPTForCausalLM(
            pt.models.GPTModel(vocab_size=64, hidden_size=64, num_layers=1,
                               num_heads=1, max_seq_len=16)))
        assert raises(lambda: pt.nn.Linear(4, 4))
        from paddle_tpu_torch.inference.server import PredictorServer
        assert raises(lambda: PredictorServer(lambda x: x))
        pt.set_device("cpu")
        layer = pt.nn.Linear(4, 4)
        assert raises(lambda: pt.inference.Predictor(layer, device="gpu"))
        pt.set_device("gpu")
        assert raises(lambda: pt.inference.Predictor(layer))
        assert pt.inference.Predictor(layer, device="cpu").device.type == "cpu"
        print("ok")
    """, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("layout", ["alone", "no_cuda"])
def test_chip_smoke_refuses_to_run_without_the_repo_or_a_card(tmp_path,
                                                               layout):
    script = os.path.join(ROOT, "chip_smoke.py")
    if layout == "alone":
        # a directory that holds chip_smoke.py and nothing else of the repo
        copy = tmp_path / "chip_smoke.py"
        copy.write_text(open(script).read())
        script = str(copy)
    res = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "FAILED" in res.stderr


def test_deploy_flow_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    res = _run(f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        pt.seed(0)
        net = pt.vision.models.resnet18(num_classes=10, data_format="NHWC")
        path = {str(tmp_path / "r18")!r}
        pt.jit.save(net, path, input_spec=[pt.InputSpec([2, 32, 32, 3])],
                    precision="int8")
        cfg = pt.inference.Config(path + ".pdmodel")
        cfg.disable_gpu()
        cfg.enable_quant()
        pred = pt.inference.create_predictor(cfg)
        h = pred.get_input_handle(pred.get_input_names()[0])
        h.copy_from_cpu(np.ones((2, 32, 32, 3), np.float32))
        pred.run()
        out = pred.get_output_handle("output_0").copy_to_cpu()
        assert out.shape == (2, 10) and np.isfinite(out).all()
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_sequence_layers_and_config4_run_with_jax_and_the_jax_package_blocked(
        tmp_path):
    res = _run(f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import torch
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        pt.seed(0)
        net = pt.models.pp_ocrv3_rec(n_classes=20, scale=0.25,
                                     hidden_size=16)
        x = np.random.default_rng(0).random((2, 32, 48, 3),
                                            dtype=np.float32)
        loss = net.loss(net(torch.from_numpy(x)),
                        torch.ones(2, 3, dtype=torch.int64), [3, 2])
        loss.backward()
        net.eval()
        path = {str(tmp_path / "ocr")!r}
        pt.jit.save(net, path, input_spec=[pt.InputSpec([2, 32, 48, 3])])
        pred = pt.inference.create_predictor(pt.inference.Config(path))
        assert pred.run([x])[0].shape == (2, 24, 20)
        t = pt.nn.Transformer(16, 2, 1, 1, 32, dropout=0.0)
        src = torch.randn(2, 5, 16)
        t(src, src, tgt_mask=t.generate_square_subsequent_mask(5)).sum()
        dec = pt.nn.BeamSearchDecoder(pt.nn.GRUCell(4, 8), 0, 1, 2,
                                      embedding_fn=pt.nn.Embedding(6, 4),
                                      output_fn=pt.nn.Linear(8, 6))
        ids, _ = pt.nn.dynamic_decode(dec, inits=torch.zeros(2, 8),
                                      max_step_num=3)
        boxes, scores = pt.vision.ops.yolo_box(
            torch.randn(1, 8, 3, 3), None, [10, 13], 3, 0.5, 8)
        keep = pt.vision.ops.nms(boxes[0], 0.5, scores[0].max(-1).values)
        pt.vision.models.squeezenet1_1(num_classes=3)
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_server_and_obs_plane_run_with_jax_and_the_jax_package_blocked():
    res = _run("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import _native, monitor, obs
        from paddle_tpu_torch.inference.server import (PredictorClient,
                                                       PredictorServer)
        from paddle_tpu_torch.obs import memory, trace
        pt.set_device("cpu")
        pt.set_flags({"FLAGS_monitor": True, "FLAGS_trace": True,
                      "FLAGS_obs_timeline": True, "FLAGS_mem_census": True})
        pt.seed(0)
        model = pt.models.GPTForCausalLM(pt.models.GPTModel(
            vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=32, dropout=0.0))
        pred = pt.inference.Predictor(
            model, input_spec=[pt.InputSpec([1, 32], "int32")])
        llm = pt.serving.LLMEngine(model, pt.serving.LLMConfig(
            num_slots=2, max_len=32, max_new_tokens=4), device="cpu")
        srv = PredictorServer(pred, llm_engine=llm).start()
        c = PredictorClient(srv.host, srv.port, timeout=60)
        ids = np.arange(32, dtype=np.int32)[None] % 64
        status, outs = c.run([ids])
        assert status == 0 and outs[0].shape == (1, 32, 64)
        rc, couts = _native.run(srv.host, srv.port, [ids])
        assert rc == 0 and couts[0].tobytes() == outs[0].tobytes()
        status, toks = c.generate([1, 2, 3], 4)
        assert status == 0 and len(toks) == 4
        assert c.health()["monitor"]["counters"]["serving.completed"] == 2
        c.drain()
        c.close()
        srv.stop()
        assert len(trace.traces()) == 1 and trace.active_depth() == 0
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        step = pt.jit.TrainStep(model, pt.models.GPTPretrainingCriterion(),
                                opt)
        for _ in range(2):
            step(ids, ids)
        assert len(obs.timeline().records()) == 2
        assert memory.census()["tags"]["params"]["bytes"] > 0
        assert "paddle_tpu_serving_completed 2" in monitor.prometheus_text()
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_data_parallel_and_zero_ranks_run_with_jax_and_the_jax_package_blocked(
        tmp_path):
    """Slice 15's modules (env, collective, launch + spawn, topology,
    reducer, data_parallel, spmd, hybrid_optimizer, meta_parallel, fleet,
    the distributed namespace, bench's arms) in two gloo ranks whose
    imports of jax and the JAX package fail."""
    script = tmp_path / "ranks.py"
    script.write_text(textwrap.dedent("""
        import os
        import sys
        BLOCKED = ("jax", "jaxlib", "paddle_tpu")
        for name in BLOCKED:
            sys.modules[name] = None          # any import of them fails


        def rank(out):
            for name in BLOCKED:
                sys.modules[name] = None
            import torch
            import paddle_tpu_torch as pt
            from paddle_tpu_torch import distributed as dist
            from paddle_tpu_torch.parallel import (
                DataParallel, DistributedStrategy, SPMDTrainStep, fleet,
                group_sharded_parallel)
            from paddle_tpu_torch.utils import bench
            pt.set_device("cpu")
            st = DistributedStrategy()
            st.hybrid_configs["sharding_degree"] = 2
            hcg = fleet.init(is_collective=True, strategy=st)
            r = dist.get_rank()
            t = torch.ones(2) * (r + 1)
            dist.all_reduce(t)
            assert t.tolist() == [3.0, 3.0]
            pt.seed(0)
            net = pt.nn.Linear(8, 4)
            model = fleet.distributed_model(net)
            opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
                parameters=net.parameters(), learning_rate=1e-2))
            model, opt = group_sharded_parallel(model, opt, "p_g_os")
            step = SPMDTrainStep(model, lambda o, y: ((o - y) ** 2).mean(),
                                 opt, mesh=hcg.get_mesh(),
                                 sharding_stage=opt.sharding_stage)
            x, y = torch.ones(4, 8), torch.zeros(4, 4)
            losses = [float(step(x, y)) for _ in range(3)]
            assert losses[-1] < losses[0], losses
            bench.allreduce_busbw(1 << 16, reps=2)
            DataParallel(pt.nn.Linear(4, 4))
            loaded = sorted(m for m in sys.modules
                            if sys.modules[m] is not None
                            and m.split(".")[0] in BLOCKED)
            assert not loaded, loaded
            open(os.path.join(out, f"ok_{r}"), "w").close()


        if __name__ == "__main__":
            sys.path.insert(0, sys.argv[1])
            from paddle_tpu_torch.parallel import spawn
            spawn(rank, args=(sys.argv[2],), nprocs=2, backend="gloo",
                  device="cpu", timeout=120)
            print("ok")
    """))
    res = subprocess.run([sys.executable, str(script), ROOT, str(tmp_path)],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"
    assert (tmp_path / "ok_0").exists() and (tmp_path / "ok_1").exists()


def test_tensor_and_pipeline_parallel_ranks_run_with_jax_and_the_jax_package_blocked(
        tmp_path):
    """The tensor- and pipeline-parallel modules (mp_layers, pp_layers,
    pipeline_parallel, grad_clip, zero3, TensorParallel, the models'
    use_mp, gpt_10b's module, collective_signature) in two gloo ranks
    whose imports of jax and the JAX package fail: SPMDTrainStep over mp
    2, ZeRO-3 by units, then a pp 2 gpt_pipeline_layer through fleet."""
    script = tmp_path / "ranks.py"
    script.write_text(textwrap.dedent("""
        import os
        import sys
        BLOCKED = ("jax", "jaxlib", "paddle_tpu")
        for name in BLOCKED:
            sys.modules[name] = None          # any import of them fails


        def rank(out):
            for name in BLOCKED:
                sys.modules[name] = None
            import torch
            import paddle_tpu_torch as pt
            from paddle_tpu_torch import distributed as dist
            from paddle_tpu_torch.parallel import (
                ColumnParallelLinear, DistributedStrategy,
                HybridCommunicateGroup, PipelineParallel, RowParallelLinear,
                SPMDTrainStep, TensorParallel, fleet)
            pt.set_device("cpu")
            st = DistributedStrategy()
            st.hybrid_configs["mp_degree"] = 2
            hcg = fleet.init(is_collective=True, strategy=st)
            r = dist.get_rank()
            pt.seed(0)
            net = pt.nn.Sequential(ColumnParallelLinear(8, 16,
                                                        gather_output=False),
                                   RowParallelLinear(16, 4,
                                                     input_is_parallel=True))
            model = fleet.distributed_model(net)
            assert isinstance(model, TensorParallel)
            opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
                parameters=net.parameters(), learning_rate=1e-2,
                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
            step = SPMDTrainStep(model, lambda o, y: ((o - y) ** 2).mean(),
                                 opt, mesh=hcg.get_mesh())
            x, y = torch.ones(4, 8), torch.zeros(4, 4)
            assert step.collective_signature(x, y)
            losses = [float(step(x, y)) for _ in range(3)]
            assert losses[-1] < losses[0], losses
            assert model.state_dict()["0.weight"].shape == (8, 16)
            z = HybridCommunicateGroup(hybrid_configs={"sharding_degree": 2})
            znet = pt.models.ErnieModel(vocab_size=32, hidden_size=16,
                                        num_hidden_layers=2,
                                        num_attention_heads=2,
                                        intermediate_size=32)
            zstep = SPMDTrainStep(
                znet, lambda s, p: (p ** 2).mean(),
                pt.optimizer.AdamW(parameters=znet.parameters()),
                mesh=z.get_mesh(), sharding_stage=3)
            ids = torch.ones(2, 8, dtype=torch.int64)
            zstep(ids)
            assert zstep.last_peak_gathered_bytes > 0
            st = DistributedStrategy()
            st.hybrid_configs["pp_degree"] = 2
            st.pipeline_configs["accumulate_steps"] = 2
            fleet.init(is_collective=True, strategy=st)
            pl = pt.models.gpt_pipeline_layer(
                vocab_size=32, hidden_size=16, num_layers=2, num_heads=2,
                max_seq_len=8, dropout=0.0, num_stages=2)
            engine = fleet.distributed_model(pl)
            assert isinstance(engine, PipelineParallel)
            popt = pt.optimizer.SGD(parameters=pl.parameters(),
                                    learning_rate=0.1)
            tok = torch.ones(4, 8, dtype=torch.int64)
            assert engine.collective_signature([tok, tok], popt)
            pl_losses = [float(engine.train_batch([tok, tok], popt))
                         for _ in range(2)]
            assert pl_losses[1] < pl_losses[0], pl_losses
            assert pt.models.gpt_10b is not None
            loaded = sorted(m for m in sys.modules
                            if sys.modules[m] is not None
                            and m.split(".")[0] in BLOCKED)
            assert not loaded, loaded
            open(os.path.join(out, f"ok_{r}"), "w").close()


        if __name__ == "__main__":
            sys.path.insert(0, sys.argv[1])
            from paddle_tpu_torch.parallel import spawn
            spawn(rank, args=(sys.argv[2],), nprocs=2, backend="gloo",
                  device="cpu", timeout=120)
            print("ok")
    """))
    res = subprocess.run([sys.executable, str(script), ROOT, str(tmp_path)],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"
    assert (tmp_path / "ok_0").exists() and (tmp_path / "ok_1").exists()


def test_fault_tolerance_modules_run_with_jax_and_the_jax_package_blocked(
        tmp_path):
    """Slice 17: the guard, sharded_io, MoE, the meta-optimizers and
    elastic import and run with the JAX package blocked; MoELayer raises
    without CUDA unless the CPU was asked for."""
    res = _run(f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import torch
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.core.enforce import UnavailableError
        from paddle_tpu_torch.framework import sharded_io
        from paddle_tpu_torch.guard import GuardConfig, TrainGuard
        from paddle_tpu_torch.parallel import elastic, meta_optimizers, moe
        try:
            moe.MoELayer(8, 16, 4)
            raise SystemExit("MoELayer ran on the CPU unasked")
        except UnavailableError:
            pass
        pt.set_device("cpu")
        pt.seed(0)
        net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.Linear(8, 1))
        opt = pt.optimizer.Adam(parameters=net.parameters())
        step = pt.jit.TrainStep(net, pt.nn.MSELoss(), opt, n_model_inputs=1)
        x, y = torch.ones(2, 4), torch.zeros(2, 1)
        with TrainGuard(step, ckpt_dir={str(tmp_path / "g")!r},
                        config=GuardConfig(snapshot_interval=1)) as g:
            g.step(x, y)
            g.checkpoint()
            assert g.step(torch.full((2, 4), float("nan")), y) is None
        sharded_io.save_sharded({{"w": torch.ones(3)}}, {str(tmp_path / "s")!r})
        assert sharded_io.load_sharded({str(tmp_path / "s")!r})["w"].sum() == 3
        layer = moe.MoELayer(8, 16, 4, top_k=2)
        out = meta_optimizers.recompute(layer, torch.ones(6, 8))
        assert out.shape == (6, 8)
        assert elastic.ElasticResult(0, [0, 0]).success
        print("ok", "jax" in sys.modules and sys.modules["jax"] is not None)
    """, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok False"


def test_static_graph_half_runs_with_jax_and_the_jax_package_blocked(
        tmp_path):
    # from a file: dy2static reads the functions' source
    script = tmp_path / "static_half.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None          # any import of them fails
        import numpy as np
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import static
        pt.set_device("cpu")
        pt.seed(0)

        class Gated(pt.nn.Layer):
            def __init__(self):
                super().__init__()
                self.a, self.b = pt.nn.Linear(8, 4), pt.nn.Linear(8, 4)

            def forward(self, x):
                if x.mean() > 0:
                    y = self.a(x)
                else:
                    y = self.b(x)
                return y

        net = pt.jit.to_static(Gated())
        x = pt.to_tensor(np.abs(np.random.rand(2, 8)).astype("float32"))
        net(x).sum().backward()
        assert float(net.a.weight.grad.abs().sum()) > 0
        assert float(net.b.weight.grad.abs().sum()) == 0   # untaken branch
        prog = net.forward.program()
        assert prog.has_op("cond") and prog.num_blocks() == 3
        for name in ("dead_op_elim", "remat", "bf16_io"):
            assert prog.apply_pass(name).outputs()[0].shape == [2, 4]

        @pt.jit.to_static
        def count(x, n):
            acc = x * 0
            i = 0
            for i in range(n):
                if i % 2 == 1:
                    continue
                acc = acc + x
            while acc.sum() > 100.0:
                acc = acc / 2.0
            return acc
        out = count(pt.to_tensor(np.ones(3, "float32")),
                    pt.to_tensor(np.asarray(5, "int32")))
        assert np.allclose(out.numpy(), 3.0)
        y = static.nn.fc(x, 3)
        p = static.nn.sequence_pool(y, pt.to_tensor(np.array([1, 2], "int32")),
                                    "max")
        assert list(p.shape) == [2] and static.Executor().run(
            lambda v: v * 2, feed=[np.ones(2)])[0].tolist() == [2.0, 2.0]
        path = {str(tmp_path / "sf")!r}
        net.eval()
        pt.jit.save(net, path, input_spec=[pt.InputSpec([2, 8], "float32")])
        pred = pt.inference.create_predictor(pt.inference.Config(path))
        live = pt.inference.Predictor(Gated(), input_spec=[
            pt.InputSpec([2, 8], "float32")])
        assert list(pred.run([x.numpy()])[0].shape) == [2, 4]
        assert list(live.run([x.numpy()])[0].shape) == [2, 4]
        assert isinstance(live._fn, pt.jit.StaticFunction)
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not loaded, loaded
        print("ok")
    """))
    res = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"
