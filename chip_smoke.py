"""Chip smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line is printed):

  1. device  - the card's name and power limit from nvidia-smi;
  2. build   - every kernel of the training, serving and sequence-parallel
               paths built from the sources in the checkout (one nvcc per
               source, all started together);
  3. kernels - each kernel held against its plain PyTorch version on the
               card, at the shapes the main paths give it (the titan
               layer's BH 128, S 2048, D 64, non-causal among them) and at
               the other shapes it accepts, with its time through the
               wrapper and on
               the device alone (a CUDA graph), its plain version's, the
               PyTorch library call's (also both ways) and the least time
               the card could take; the fused and the two-pass backward
               held against each other, the backward's prep pass (delta,
               the zeroed dq workspace) against its plain version, the dq
               pass at both CTA sizes of its wgmma template and run twice
               (bit-equal). The three ring-attention kernels through their
               one-hop wrappers: at the sp train's hop (BH 96, 128 x 128,
               non-causal), causal hops on the diagonal, in the past and
               in the future (exact zeros and -1e30), an offset off the
               tile grid, Sq != Sk, D 128 and 256, and fp32; at each of
               those the three step kernels on a group of two slots
               adding into running accumulators (a future hop leaves them
               bit-unchanged); the forward and dk/dv step kernels on the
               four slots of a ring step at the sp hop (non-causal, timed
               per launch and per slot-hop, and causal); the dq step on
               four slots at nine cases, from non-zero accumulators, at
               both CTA sizes. Then each of the seven kernels in fp16 at its
               main path's shape (rows 1-4 at the titan and the train
               shapes, the ring steps at the sp hop), held to 5e-3 (1 +
               |ref|) forward and 1e-2 (1 + |ref|) for the gradients, its
               device time beside its bf16 row's and SDPA's in fp16;
  4. ring    - sequence_parallel_attention(impl="ring", causal=True) over
               a mesh of four slots at B=1, S=4096, H=12, D=64 in bf16,
               forward and backward, against the single-device flash
               attention on the same q/k/v; on one card 4 launches of
               each of the three step kernels (16 slot-hops each); then
               fp16 attention: one scaled_dot_product_attention call at
               S=4096 launches the flash forward (and its backward the
               fused backward), one fp16 ring over the four slots 4
               launches of each step kernel, both against fp32; the ring
               at D=96 takes the dense ring, no launch; the fp16 call's
               memory beside the fp16 einsum path's and the bf16 kernel's;
  5. train   - GPTForCausalLM(gpt2_small(dropout=0.0)) at full width and
               depth, fp32 master weights drawn from a seed, trained in
               bf16 AMP on 8 x 1024 tokens through jit.TrainStep + AdamW:
               the step-1 gradients against the same weights in fp32 and
               against the deterministic two-pass backward, then one
               warm-up step, 5 __call__ steps, a run() span of 5 steps (a
               CUDA graph: its first step eager, one capture, 4 replays)
               and one step under torch.use_deterministic_algorithms.
               Every attention forward and backward must go through the
               kernels (launch counts: the wrappers count host calls, so
               the capture counts once and the replays not at all) and
               the loss must fall;
  6. serve   - the same model at full width in bf16, served through
               Predictor -> ServingEngine: 8 requests of 1024 tokens from
               4 threads. The live layer serves through jit.to_static:
               each batch bucket exports and captures once at warm-up
               (timed), then replays. Every attention call must go
               through the kernel (host launches of the captures, flash
               nodes of each graph), and one request's logits must match
               the same model run in float32;
  7. sp train - ErnieForPretraining(ernie_base(use_sp=True)) at full width
               and depth, trained in bf16 AMP on 8 x 512 tokens through
               jit.TrainStep + AdamW with the MLM + NSP loss, under
               HybridCommunicateGroup(sp_degree=4) over four slots of one
               card (or four cards when there are four): the step-1 loss
               and gradients against the same weights in fp32 without sp,
               then one warm-up step, 5 __call__ steps and a run() span of
               15. Every attention call must go through the ring kernels
               (per host-driven step on one card 12 x 4 launches and
               12 x 16 slot-hops of each of the three step kernels; on
               four cards 12 x 16 of each, and run() is a loop there; none
               of the flash kernels), the step-1 loss must be bit-equal
               when computed twice (the three lowest per-parameter
               gradient cosines are printed), and the loss must fall;
  8. flagship - ErnieForPretraining(ernie_base(hidden_dropout_prob=0.0))
               without sp at 32 x 128, as bench.py trains it
               (paddle_tpu_torch.utils.bench.ernie_train): run() spans of
               20 steps, 3 reps; samples/s, spread, MFU by bench.py's
               formula and from cost_analysis (within 10% of each
               other), the forward / backward / optimizer split,
               memory_report and peak memory, the per-step path with and
               without io.DevicePrefetcher. The loss must fall;
  9. titan   - four titan layers, ErnieScanStack(4096, 64, 16384, 4,
               remat="dots") at 2 x 2048 (bench.ernie10b_layer): run()
               spans of 10 steps, 3 reps; ms per layer-sample, MFU, peak
               memory. The loss must fall;
 10. graph   - for GPT-2, the flagship, titan and the sp train: from one
               saved state, run() over 4 distinct steps (one CUDA-graph
               replay each) against the eager loop of __call__ (GPT-2 and
               titan under torch.use_deterministic_algorithms, since the
               fused backward's dq atomics do not repeat bitwise): per-step
               losses within 1e-4 relative, parameter cosine >= 0.9999;
               the kernels of one replay counted by symbol over the
               kernel nodes of the captured step (a replay runs every
               node of its graph): GPT-2 12 flash forward and 12 fused
               backward launches per step, titan 4 and 4 under "dots" (8
               forwards under remat=True, and fewer GEMMs), the sp train
               48 of each ring step kernel on one card, the flagship
               none; the torch.profiler trace of a replayed span printed
               beside them, and never more than the graph's count per
               replay;
 11. fp16 titan - path A: the same four titan layers in fp16 AMP, eager,
               AdamW(1e-4) + amp.GradScaler() at its defaults: the step-1
               loss and unscaled gradients against fp32 on the card (fused
               and two-pass backward: loss within 1e-2 relative, every
               per-parameter cosine >= 0.99), 10 steps with finite losses
               and scales, 4 + 4 fp16 flash launches in the device trace
               of a step, then two steps with an inf injected into a
               gradient (the first under torch.use_deterministic_
               algorithms: the two-pass backward), each leaving
               parameters, AdamW slots, step count and device t bit-
               unchanged, together halving the scale; host launches over
               those 13 steps exactly 4 x 13 forward, 4 x 12 fused, 4 dq
               and 4 dk/dv; ms per step and peak memory beside the bf16
               TrainStep __call__ of the same stack;
 12. fp16 sp - path B: ERNIE-base over the sp=4 ring in fp16 AMP, eager,
               the same optimizer and scaler, MLM + NSP at 8 x 512 (the
               loss in f32 on the fp16 logits): the step-1 loss and
               gradients against fp32 without sp (the same tolerances),
               steps until 8 were taken (at 2^15 the scaled gradients
               overflow fp16, so the first steps are skipped while the
               scale halves), the loss falling over the 8, 48 launches of
               each ring step kernel per step (host counts) and in fp16 in
               the device trace;
 13. llm     - GPTForCausalLM(gpt2_small(dropout=0.0)) at full width and
               depth, fp32 weights from a seed, served through
               serving.LLMEngine (16 slots, max_len 1022: a page of 1024
               rows, the position table's length): 32 requests of 16-896
               prompt tokens (a seeded default_rng) and 64 new tokens from
               4 submitting threads, in the fp32 arm and then the int8 arm
               (quant="int8", kv_int8=True). Each engine must capture its
               decode step once, at warm-up, and never while serving; no
               flash or ring kernel may launch (cached attention is masked
               einsums, as in the reference); every stream ends "done"
               with 64 tokens; kv_pool_bytes must equal LLMConfig's
               formula, the int8 pool under half the fp32 one. From an
               idle engine: a graph replay against the eager step from one
               pool state (the same tokens, logits and pools within 1e-4
               (1 + |ref|)), the replay's device ms beside its bytes bound
               and the host ms of an eager step and a replay. The fp32
               arm's tokens of requests 0-2 must each be the full
               forward's argmax (a full-recompute greedy decode), and one
               decode step's logits within 1e-4 (1 + |ref|) of the full
               forward's last position. Prints decode and prefill tokens/s,
               TTFT and inter-token p50 / p99, peak memory, and the int8
               arm's decode speedup and its token agreement with fp32
               (reported, not gated);
 14. dygraph - the paddle user's dygraph loop on the Tensor API:
               GPTForCausalLM(gpt2_small(dropout=0.0)) at full width and
               depth, ids from a seeded default_rng through pt.to_tensor
               (a pt.Tensor, int32, on CUDAPlace(0)), 12 steps of
               auto_cast(bf16) forward, cross_entropy on Tensor methods
               (slicing, reshape, astype), backward(), AdamW(1e-4) step()
               and clear_grad(): logits and loss are pt.Tensor, 12 flash
               forward and 12 fused backward launches per step (host
               counts), the loss falls; the same loop on plain torch ids
               in turns (ms per step: the Tensor layer's host cost); both
               from one saved state under torch.use_deterministic_
               algorithms: losses within 1e-4 relative, lowest parameter
               cosine >= 0.9999;
 15. ops     - each op family of the Tensor API (creation, math,
               manipulation, logic, search, linalg) on CUDA pt.Tensors
               against the same call on CPU pt.Tensors, forward and the
               gradients of the sum where differentiable, within the
               family's tolerance (OP_TOL); numpy() of a CUDA bf16 tensor
               (exact f32); the 15 random ops drawn twice on the card under
               one seed, bit-equal; the host cost of one op, Tensor vs
               plain;
 16. conv    - slice 11, the convolutional nn library: LeNet through
               bench.py's lenet_dispatch loop (utils/bench.py lenet_loop:
               seed 0, batch 32, SGD(0.01), CrossEntropyLoss, on Tensors):
               the step-1 loss and every gradient on the card against the
               same weights and batch on the CPU (fp32, TF32 off, within
               LENET_TOL (1 + |ref|)); 6 warm-up steps, then eager spans
               and TrainStep.run() spans of 20 steps in turns (medians;
               run() one capture, then replays, its kernel nodes counted
               from the captured graph), the loss falling; the ten
               optimizers (Momentum with Nesterov, RMSProp centred with
               momentum, Lamb and LARS with exclusions), 3 LeNet steps on
               the card against the CPU with one ParamAttr(learning_rate=
               0.5) weight and one frozen bias, and their rules alone on
               the CPU's gradients; ResNet-50's stem (Conv2D 7x7 stride 2,
               BatchNorm2D, ReLU, MaxPool2D 3/2/1) at batch 8 against the
               CPU in fp32 and bf16 auto_cast (output, gradients, running
               statistics), NHWC against NCHW, then forward + backward at
               bench.py's resnet50_infer batch of 128 x 224 x 224 in NCHW
               and NHWC, fp32 and bf16 (CUDA events, peak memory); dropout
               on the card (eval downscale_in_infer exact, the kept
               fraction, the kept values, one draw per row with axis);
 17. deploy  - slice 12, the deploy path: ResNet-50 NHWC (seed 0) through
               jit.save -> inference.Config -> create_predictor on the
               card: the fp32 artifact at batch 8 against the live layer
               on the CPU (relative L2 <= 1e-5, TF32 off); fp32, bf16 and
               weight-only int8 artifacts at bench.py's resnet50_infer
               batch of 128 x 224 x 224 x 3, bf16 and int8 against fp32
               (max|got - ref| / max|ref| < 0.08), every quantized weight
               int8 in the loaded artifact, the int8 .pdiparams.npz under
               0.45x the fp32 one; imgs/s with spread in bench.py's
               scaffold beside the live layer's eager forward at the same
               batch and dtype, the loaded program's device busy time per
               batch within 10% of the live layer's, MFU, peak memory and
               the idle share over 6 run()s; GPT-2 small's bf16 artifact
               at 4 x 1024 (exported on the card: 12 flash_fwd nodes), 8
               requests through ServingEngine over the loaded Predictor
               (each input signature one CUDA graph: 2 x 12 host launches
               for the warm-up's eager run and capture, 12 flash nodes in
               the graph, 12 in the device trace of a replay) against the
               live-layer Predictor (relative mean-abs error <= 2e-2);
               ResNet-50 NHWC bf16 at batch 32 through TrainStep, run()
               against __call__ from one state (losses within 1e-4
               relative, parameter cosine >= 0.9999) with every running
               statistic bit-unchanged, as in the reference; and a run()
               capture after an eager LeNet loop whose loss kept its graph;
 18. seq     - slice 13, the sequence layers: nn.Transformer(512, 8, 6, 6,
               2048, dropout=0.0) (the base model of Vaswani et al., the
               reference's defaults) on src = tgt = 8 x 1024 x 512 with the
               causal target mask, trained on mean((out - y) ** 2) through
               jit.TrainStep(amp_dtype="bfloat16", n_model_inputs=2) +
               AdamW(1e-4): step 1 in bf16 against fp32 on the card (loss
               within 2e-2 relative; gradient cosine >= 0.999 whole, >= 0.99
               for each parameter outside the q / k projections and for
               those together; fp32 takes the einsum path), 3 __call__
               steps, then run() from the same state (losses within 1e-4
               relative; the pair again under deterministic algorithms,
               parameter cosine >= 0.9999), the loss falling; 12 flash_fwd
               and 12
               fused backward launches per step in the device trace (6
               encoder self-attentions, 6 cross-attentions; the masked
               decoder self-attention none); BeamSearchDecoder(GRUCell(128,
               256), 4 beams, Embedding(1000, 128), Linear(256, 1000))
               through dynamic_decode(max_step_num=32) at batch 8, card vs
               CPU: the same ids, parents and lengths; LSTM / GRU /
               SimpleRNN, two bidirectional layers, with and without
               sequence_length, card vs CPU: outputs within 1e-4, gradients
               within 5e-4 (1 + |ref|), both beside float64;
 19. config4 - slice 13, BASELINE config 4 through the deploy path:
               PP-OCRv3 rec (n_classes 6625, scale 0.5, hidden 48; 64 x 32
               x 320 x 3) and PP-YOLOE-s NHWC (64 x 640 x 640 x 3), seed 0:
               the fp32 artifact against the live layer on the CPU at batch
               4 / 2 (relative L2 <= 1e-5 per output), fp32 and bf16
               artifacts at bench.py's batch, bf16 against fp32 (< 0.08 of
               max|ref| per output), the OCR program's two aten.lstm.input
               nodes, imgs/s with spread, MFU, peak memory, idle share over
               6 run()s and device busy against the live layer (the OCR
               program run eagerly within 10%), and which recurrent
               kernels the OCR trace shows; yolo_box on the detector's
               three heads and nms of one image, card vs CPU; ctc_loss at
               T 160, batch 64, 6625
               classes forward and backward, and 3 SGD steps of
               PPOCRRec.loss at batch 4, card vs CPU (1e-4 (1 + |ref|) and
               1e-3 relative); every vision op but decode_jpeg, forward
               (and backward where differentiable), and the six small-net
               families in eval, card vs CPU within 1e-4 (1 + |ref|);
 20. server  - slice 14, the serving wire: the deploy phase's GPT-2 small
               bf16 artifact behind PredictorServer (ServingEngine at the
               artifact's batch of 4; LLMEngine over gpt2_small fp32, 16
               slots x 1024 rows) with the monitor, tracing, the memory
               census, the flight recorder and an SLO on; 4
               PredictorClient threads x 2 traced 'PDRQ' requests of 1 x
               1024 ids (206 MB of f32 logits each) within 2e-2 relative
               mean-abs error of the live-layer Predictor; 24 flash host
               launches at warm-up (eager run and capture) and 12 flash
               nodes a replay; one complete trace per request; the C client
               built from csrc/predict_capi.cpp byte-equal to
               PredictorClient; a 'PDSQ' stream in order and equal to
               LLMEngine.submit; an injected dispatch fault (status 1, then
               0); an overload burst on a queue of depth 1 (status 2, one
               serving_overload dump); 'PDHQ', one Prometheus sample per
               counter and gauge, the census within memory_allocated;
               'PDDR', then a refused connect; requests/s, p50 / p99 and
               the span means printed;
 21. obs     - slice 14's plane in TrainStep: 5 __call__ steps of
               gpt2_small at 8 x 1024 bf16 AMP and run() over 6 steps (the
               capture, 5 replays) under FLAGS_obs_timeline and
               FLAGS_mem_census: every steady step's phases within
               [0.95, 1.05] of its wall, device_compute the largest; the
               params, opt_slots and activations tags; the
               jit.train_step.steps counter; 12 + 12 flash launches per
               eager step and kernel nodes per replay.

 22. dist    - slice 15, data parallelism and ZeRO over processes (BASELINE
               config 3), ranks started by the port's own spawn: with two
               or more cards one NCCL rank per card (at most 8); with one,
               a world of one over NCCL and two gloo ranks on cuda:0
               (gloo named explicitly; NCCL takes no two ranks on one
               card). In each rank: every collective on CUDA tensors
               seeded per rank, every ReduceOp, f32 (exact, integer
               values) and bf16 (1e-2 relative); ERNIE-base at full width
               and depth, dropout 0, MLM + NSP at the global 32 x 128, bf16
               AMP, AdamW(1e-4) through fleet.init -> distributed_model ->
               SPMDTrainStep(grad_reduction="bucketed"): the step-1 loss
               within 1e-3 relative and every gradient at cosine >= 0.999
               of one process's TrainStep on the whole batch from the same
               weights, then 1 warm-up and 5 steps with the loss falling,
               c_allreduce_bucket counted once per bucket and step, the
               flight recorder holding them, the parameters bit-equal
               across ranks (an all_gather of checksums); ZeRO stages 1, 2
               and 3 over the world, 2 steps each from the same weights,
               losses within 1e-3 of DP's, memory beside DP's and stage
               1's slot bytes at 1/W of DP's; scaled_dot_product_attention
               forward and backward in bf16 at 1 x 2048 x 12 x 64 on the
               rank's card through rows 1 and 2 (1 + 1 launches) against
               the plain f32 math; the allreduce arm's bus GB/s at 64 MB
               (n/a for one rank; host-staged over gloo). ZeRO-3 gathers
               unit by unit: each stage's peak max_memory_allocated, the
               peak gathered bytes beside the largest unit's, and stages
               1 and 3 with ClipGradByGlobalNorm(1.0) within 1e-3.
 23. config5 - BASELINE config 5's model-parallel half:
               gpt_pipeline_layer at gpt_10b's full width (hidden 4096, 64
               heads of 64, FFN 16384, vocabulary 50304, sequence 2048),
               depth cut from 48 to 4 layers, 4 micro-batches of 1 x 2048
               of random ids from SEED, AdamW(1e-4) with
               ClipGradByGlobalNorm(1.0). Rows 1-2 at the micro-batch's
               attention (B 1, 64 heads, S 2048, D 64, causal, bf16)
               against their plain versions, device ms beside SDPA's and
               the bound. The single controller (PipelineParallel, pp 2
               over cuda:0 twice, or cuda:0 and cuda:1): the fp32 pipeline
               against the same PipelineLayer run whole over the same
               micro-batches (loss within 1e-4 relative, every gradient
               at cosine >= 0.9999), bf16 against fp32 (2e-2, 0.99), one
               bf16 train_batch's flash launches (2 L M forwards and L M
               backwards: the backward recomputes each stage's forward),
               in-flight inputs <= 2, ms per train_batch, tokens/s, peak
               memory per stage device. Then a process world of pp 2 x
               mp 2 (four gloo ranks on cuda:0, or NCCL on four cards)
               through fleet.init -> distributed_model ->
               distributed_optimizer -> train_batch, each rank loading
               its stage and mp slices of the single controller's initial
               state: the fp32 step-1 loss within 1e-4 and the gathered
               gradients at cosine >= 0.9999 of the single controller's,
               2 bf16 steps with the loss falling, the flash launches per
               rank, rows 1-2 on every rank against the plain math, the
               collective signature's length equal within each stage.
 24. fault   - slice 17, fault-tolerant training: (a) TrainGuard over
               GPT-2 small's TrainStep (bf16 AMP, AdamW(1e-4), 8 x 1024):
               a batch whose loss scale is NaN rolled back and skipped,
               parameters and AdamW slots bit-equal to the snapshot; under
               deterministic algorithms a SIGTERM to this process before
               step 3, the checkpoint, fresh objects from another seed and
               resume(), the final parameters bit-equal to an
               uninterrupted run of 4 steps; 12 + 12 flash launches per
               guarded step (fused, then dq + dk/dv when deterministic);
               (b) ERNIE-base at 32 x 128 in fp32: fleet's gradient_merge,
               k 4 over 8 x 128 micro-batches, against one SGD step on the
               whole batch (loss and parameters within 1e-4 relative);
               fleet.utils.recompute over the 12 encoder layers with
               dropout on against the plain backward (gradients within
               1e-5 (1 + |ref|), both peaks printed); LocalSGD (k 4, AdamW)
               and DGC (sparsity 0.999) in a world of two (gloo on cuda:0,
               NCCL on 2+ cards): parameters bit-equal across ranks after
               each averaging and each DGC step, DGC's sent count per
               parameter the top-k's k (more only on a tie), residual +
               sent equal to the accumulation exactly (ERNIE-base's width,
               4 of its layers); (c)
               MoELayer(768, 3072, 8 experts, top 2) on 4096 tokens at ep
               4 (four gloo ranks on cuda:0, NCCL on 4+ cards) against the
               same layer with every expert local on each rank's tokens:
               fp32 outputs and gradients within 1e-5 (1 + |ref|), the aux
               loss equal, bf16 within tol_of; dropped assignments and ms
               per forward + backward at ep 4 and ep 1; (d)
               launch_elastic of a gang of two (this script with
               --elastic-rank) over a TCPStore, each rank config 3's DP
               step (4 layers) at 8 x 128 under AutoCheckpoint for 3
               epochs of 2 steps: rank 1 exits 9 on the first launch, the
               relaunched pair commits epochs 0 and 1, a joiner announces
               itself, and the gang of three resumes at epoch 2 and
               finishes.
 25. static  - slice 18, the static-graph half (config 2's @to_static
               path): (a) jit.to_static(resnet50(data_format="NHWC")) at
               resnet50_infer's batch of 128 x 224 x 224, fp32, under
               no_grad: the first call exports and captures, later calls
               replay one CUDA graph (one program, one capture), the
               output within relative L2 1e-5 of the eager layer; jit.save
               of the to_static'd layer -> create_predictor gives the
               same output; a second Predictor over the live layer runs
               through to_static, its imgs/s beside the artifact's and the
               replay's, each export timed; a to_static'd Dropout in
               training mode draws fresh bits in each replay. (b) GPT-2
               small through to_static at 8 x 1024, bf16 auto_cast, AdamW:
               3 steps of loss.backward() across the static boundary
               against the same eager loop from one state under
               deterministic algorithms (losses within 1e-4 relative,
               every parameter at cosine >= 0.9999), 12 + 12 flash
               launches a step (host counts of the three steps, and of
               one profiled step of each backward: rows 1-2, or rows 1,
               3, 4 deterministic; its device trace holds those kernels
               and no other flash kernel);
               after opt.step() a no-grad replay reads the updated
               weights. (c) dy2static: a function with a tensor if / elif,
               a tensor while with break, a for over range(tensor) with
               continue and an early return, exported through the cond
               and while_loop operators on the card, equal to its eager
               run; a gradient through a cond equal to the eager one.
               (d) the Programs of (a) and (b): op_histogram (53
               convolutions; 48 linears), prune, and the dead_op_elim /
               remat / bf16_io passes, each run within its dtype's
               tolerance of the unpassed program.
 26. analysis - slice 19, tpu-lint: the lint and concurrency passes over
               25's two Programs (ResNet-50's, GPT-2's with its 12
               flash_fwd nodes): no error, no host-callback, no
               concurrency finding; verify_collective_order over the
               dist phase's per-rank collective sequences (traced by
               SPMDTrainStep.collective_signature without communicating)
               finds nothing, and names the divergence of a copy with its
               last collective dropped; the self-gates on this checkout
               (the concurrency pass over paddle_tpu_torch: no finding, no
               lock cycle; the lint over models/, nn/, ops/: none, the
               CLI exits 0).
 27. warm_start - slice 19, the persistent compile cache: the workload of
               `python -m paddle_tpu_torch.utils.warm_start DIR` (LeNet
               TrainStep x2, a to_static predictor's bucket warm-up,
               GPT-2 small's live-layer Predictor over 3 buckets of 1024
               tokens in bf16 and 2 to_static bf16 AdamW steps at 8 x
               1024, a relu and a gelu TransformerEncoderLayer of one
               seed, deterministic algorithms) through bench.py's
               `warm_start` arm, a cold and then a warm process over one
               new directory: the warm process exports nothing and loads
               all 8 signatures (`warm` true), the two activation layers'
               outputs differ and each is within 1e-4 of its eager
               layer's, its
               digests of outputs, losses and parameters equal the cold
               process's bit for bit, both launch 12 flash_fwd a forward
               (72 over the 3 signatures' eager run + capture) and 12 + 12
               + 12 a training step (rows 1, 3, 4), each program holds 12
               flash_fwd nodes, each entry is under 50 MB; each
               signature's export (cold) and load (warm) seconds. Then a
               corrupt, torn, stale-torch-version and wrong-topology entry
               of a to_static function on the card each fall back to a
               fresh export, counted, pruned and stored anew, with an
               equal output.
 28. ps     - the parameter-server tier: PaddleRec's CTR-DNN on
               Criteo (`models/rank/dnn`: 26 sparse slots sharing one
               1,000,001 x 9 table, 13 dense features, fc 512-256-128-32
               with ReLU and a 2-way softmax, batch 512; composed from the
               port's layers, weights from the seed). Slot files of Zipf
               ids written in a temporary directory -> InMemoryDataset ->
               Executor.train_from_dataset -> DistributedEmbedding rows
               pulled from two servers (a python PsServer with a WAL and
               a NativePsServer, ids split by id % 2; the table under
               Adam) onto cuda:0 -> the tower on cuda:0 -> the row
               gradients pushed back through the Communicator, flushed
               each step: 40 steps, the loss falls, rows and tower on
               cuda:0. The same flow with an SGD table against one process
               (a local Embedding(sparse=True) seeded with the servers'
               initial rows, sparse SGD on the card): losses and tower
               within 1e-5 (1 + |ref|); the card's run against the port's
               CPU run within 1e-4 (1 + |ref|); a local sparse Embedding
               under sparse Adam, lazy and not, card against CPU within
               1e-5 (1 + |ref|); a snapshot and a restart of the python
               server recover its table bit-equal at the same
               applied_lsn. Printed: samples/s over the wall of
               train_from_dataset's steady steps, ms per steady step split
               into batch assembly, pull, H2D, device forward + backward
               (+ the tower's update), D2H, push and flush (one window for
               every part), the idle share of the same program traced over
               one slot file's batches, push throughput to each server, the
               ps_durability arm's WAL-off / WAL-on us per push, recovery
               ms.
 29. fleet  - the serving fleet and the telemetry plane: GPT-2 small at
               full width in bf16 behind a FleetRouter over a TCPStore,
               two in-process replicas (ReplicaAgent -> PredictorServer ->
               ServingEngine over the live layer's Predictor, one 1 x 1024
               bucket, its programs loaded from the warm_start phase's
               compile cache) and one in a child process on the caller's
               cuda:0; a TelemetryCollector fed by every replica's
               exporter, the router subscribed. A reply equal to a direct
               Predictor call, requests/s through the router against one
               replica direct; PaddleRec's CTR-DNN (phase 28's width) as a
               ModelTenant on both in-process replicas, its rows read from
               an OnlineServingTable that a DeltaSubscriber fills from a
               PsServer while a trainer pushes (one host-to-device copy a
               request): staleness under its bound, push -> servable p50 /
               p99, the exporter's tax on the tenant's p99 (off, on, on,
               off), a poisoned generation promoted by a canary rollout
               and rolled back by OnlineRollbackGuard within its interval;
               `monitor top` and `monitor fleet`; the child SIGKILLed
               mid-burst, its death relayed by the collector, the sequence
               ledger's audit (every sequence settled once, none lost);
               the Autoscaler growing the pool 2 -> 3 under a queue spike
               (the new replica loading its programs from the cache) and
               draining it back. The flash forward's host launches of the
               in-process replicas' warm-ups join row 1's.

The dist phase's two worlds run at once, and so do the fault phase's
LocalSGD / DGC and MoE worlds, beside its in-process meta checks.

Each fp16 step drives `scaler.step(opt)` after the scaled backward and no
`scaler.update()`: the reference's step() already updates the scale once
every optimizer has stepped, and an update() after it counts the step a
second time, as a good one. The last two lines are a JSON summary of the
kernels, one entry per kernel and dtype (bf16 from the bf16 paths, the
dygraph, seq and obs phases' launches in rows 1-2, the fault phase's in
rows 1-4, the warm_start phase's two processes' in rows 1, 3 and 4, and
the deploy, server and fleet phases' in row 1, fp16
from paths A and B), and `{"ok": true, "device": {...}}`. Imports nothing
of JAX.

    python3 chip_smoke.py --rows [ROOT] [DTYPE]

measures only the seven kernels' device ms and their registers and
spills, from ROOT's package and ROOT's own cases (see `kernel_rows`), so
that two trees run in turn in one card session compare their rows.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PEAK_BF16 = 989e12      # H100 SXM dense bf16 (and fp16) tensor-core FLOP/s
PEAK_FP32 = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
TRAIN_B, TRAIN_S = 8, 1024
SP_B, SP_S, SP_DEGREE = 8, 512, 4
# the sp train's run() span: from this seed AdamW(1e-4) lifts the loss at
# step 2 and it falls steadily only from about step 12, so the span runs
# the path past that point before "the loss fell" is read
SP_RUN = 15
# run() spans of the flagship and titan phases, and of the graph phase's
# comparison of run() with the eager loop (4 steps: cut from 12 to keep
# the whole smoke inside its time limit)
FLAGSHIP_RUN, TITAN_RUN, GRAPH_RUN = 20, 10, 4
TITAN_B, TITAN_S = 2, 2048      # the titan arm's batch (bench.py:702)
FLAGSHIP_B, FLAGSHIP_S = 32, 128
# the llm phase: 16 slots of a 1024-row page (max_len 1022 + the decode
# block of 2), the length of gpt2_small's position table, so no row of a
# page has a position past the table. A decode step at position
# max_seq_len - 1 would embed its junk row one past it: a NaN row, as in
# the reference (forward_cached); the engine's token budget stops each
# sequence before that step
LLM_SLOTS, LLM_MAX_LEN, LLM_NEW = 16, 1022, 64
LLM_REQUESTS, LLM_CLIENTS, LLM_PROMPTS = 32, 4, (16, 896)
# fp32 logits of a decode step against the full forward's (a different
# summation order over the masked page)
LLM_TOL = 1e-4
# the server phase: client threads (2 requests each), the 'PDSQ' stream's
# tokens, the overload burst's clients, the SLO's latency objective
SERVER_THREADS, SERVER_NEW, SERVER_BURST = 4, 32, 6
SERVER_SLO_MS = 30000.0
# the obs phase's __call__ steps (run() then spans one more: its capture)
OBS_STEPS = 5
# the dist phase: DP warm-up and measured steps, ZeRO steps per stage,
# the per-rank kernel check's attention shape, a world's time limit; the
# ZeRO clip check's SGD rate (one step: the update is the clipped
# gradient) and clip norm as a share of the initial gradient norm
DIST_WARM, DIST_STEPS, ZERO_STEPS = 1, 5, 2     # ZeRO steps cut from 3
ZERO_CLIP_LR, ZERO_CLIP_SHARE = 1.0, 0.5
DIST_ATT = (1, 2048, 12, 64)
DIST_TIMEOUT = 300
RING_SRC = "paddle_tpu_torch/kernels/csrc/ring_attention.cu"
SOURCES = {"flash_fwd": "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
           "flash_bwd_fused": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "flash_bwd_dq": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "flash_bwd_dkv": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "ring_fwd": RING_SRC, "ring_dq_step": RING_SRC,
           "ring_dkv": RING_SRC}
REPLACES = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:58",
            "flash_bwd_fused": "paddle_tpu/kernels/flash_attention.py:732",
            "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:239",
            "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:280",
            "ring_fwd": "paddle_tpu/kernels/flash_attention.py:506",
            "ring_dq_step": "paddle_tpu/kernels/flash_attention.py:551",
            "ring_dkv": "paddle_tpu/kernels/flash_attention.py:592"}
# products per visible (q, k) pair, in units of D multiply-adds x 2:
# forward q k^T and p v; fused backward the five of _bwd_tile_pds and its
# users; the dq pass recomputes s and dp and forms ds k; the dk/dv pass
# recomputes s and dp and forms p^T dO and ds^T q (the ring kernels alike)
PRODUCTS = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3,
            "flash_bwd_dkv": 4, "ring_fwd": 2, "ring_dq_step": 3,
            "ring_dkv": 4}
# [BH, S, D] tensors read and written, [BH, S] f32 rows read and written
TRAFFIC = {"flash_fwd": (4, 1), "flash_bwd_fused": (7, 2),
           "flash_bwd_dq": (5, 2), "flash_bwd_dkv": (6, 2)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_name_and_limit() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def attention_bound(name, bh, s, d, itemsize, causal, peak_ops):
    """Least time (ms) for the card: each input read once, each output
    written once, over HBM bandwidth; the products' FLOPs over the peak
    for the input type. Causal counts the visible (q, k) pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * PRODUCTS[name] * d * pairs * bh
    mats, rows = TRAFFIC[name]
    nbytes = mats * bh * s * d * itemsize + rows * bh * s * 4
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def tol_of(torch, dtype, grad=False):
    """Tolerance of a kernel against its plain version (f32 throughout),
    as max |err| <= tol (1 + |ref|): bf16 and fp16 round p (and ds) to
    their type before the products, as the Pallas kernels do, and store in
    it (2^-8, 2^-11 relative); fp16 is held to 5e-3 forward and 1e-2 for
    the gradients. fp32: sums in another order."""
    if dtype == torch.bfloat16:
        return 2e-2
    if dtype == torch.float16:
        return 1e-2 if grad else 5e-3
    return 1e-4


def peak_of(torch, dtype):
    """The card's peak rate for products of this input type."""
    return PEAK_FP32 if dtype == torch.float32 else PEAK_BF16


def close_enough(got, want, tol):
    """max |got - want| and whether it is <= tol + tol * |want| everywhere."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= tol + tol * want.float().abs())
                                  .all())


def fwd_case(fa, torch, b, s, h, d, dtype, causal):
    """Forward kernel vs plain version on one shape; the case's numbers."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + s + d)
    q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype) for _ in range(3))
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    # out: `tol_of`; lse depends on f32 sums only, in another order and
    # with exp2 for exp
    tol_out = tol_of(torch, dtype)
    tol_lse = 1e-4 if dtype == torch.float32 else 1e-3
    check(bool(torch.isfinite(out.float()).all()), f"non-finite out {s=} {d=}")
    err_out, ok_out = close_enough(out, ref_out, tol_out)
    err_lse, ok_lse = close_enough(lse, ref_lse, tol_lse)
    check(ok_out, f"flash_fwd out disagrees at {b=} {s=} {h=} {d=} {dtype} "
          f"{causal=}: max abs err {err_out}")
    check(ok_lse, f"flash_fwd lse disagrees at {b=} {s=} {h=} {d=} {dtype} "
          f"{causal=}: max abs err {err_lse}")
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))

    def kernel():
        return fa.flash_attention_fwd(q, k, v, causal)

    def library():
        return TF.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    kernel_ms = median_ms(kernel)
    plain_ms = median_ms(
        lambda: fa.flash_attention_fwd_plain(q, k, v, causal))
    library_ms = median_ms(library)
    # the wrapper launches the kernel and allocates: its graph is the
    # kernel's device time
    device_ms, library_device_ms = graph_ms(torch, kernel), \
        graph_ms(torch, library)
    bound_ms, bound_by = attention_bound(
        "flash_fwd", b * h, s, d, q.element_size(), causal,
        peak_of(torch, dtype))
    return {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "max_abs_err": err_out,
            "max_abs_err_lse": err_lse, "tol_out": tol_out,
            "tol_lse": tol_lse, "ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def bwd_case(fa, torch, b, s, h, d, dtype, causal):
    """The three backward kernels vs the plain backward, and the fused
    form vs the two-pass form, on one shape; each kernel's numbers."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1 + s + d)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    args = (q, k, v, out, lse, do, causal)
    fused = fa.flash_attention_bwd_fused(*args)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    dq_again = fa.flash_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(*args)
    tol = tol_of(torch, dtype, grad=True)
    where = f"{b=} {s=} {h=} {d=} {dtype} {causal=}"
    errs = {}
    # one CTA owns each q block and loops over the keys in one order: a
    # second run gives the same bits
    check(torch.equal(dq_again, dq),
          f"flash_bwd_dq is not bitwise reproducible at {where}")
    for kname, got in (("flash_bwd_fused", fused), ("flash_bwd_dq", (dq,)),
                       ("flash_bwd_dkv", (dk, dv))):
        want = ref if kname == "flash_bwd_fused" else \
            (ref[0],) if kname == "flash_bwd_dq" else ref[1:]
        errs[kname] = 0.0
        for g, r in zip(got, want):
            check(bool(torch.isfinite(g.float()).all()),
                  f"{kname}: non-finite gradient at {where}")
            err, ok = close_enough(g, r, tol)
            check(ok, f"{kname} disagrees with the plain backward at {where}:"
                  f" max abs err {err}")
            errs[kname] = max(errs[kname], err)
    # the fused and two-pass forms: dk, dv from the same arithmetic in the
    # same order (bit-equal); dq from f32 sums in another order (atomics
    # vs a register loop), then one rounding to the input dtype
    check(torch.equal(fused[1], dk) and torch.equal(fused[2], dv),
          f"fused and two-pass dk/dv differ at {where}")
    err_fq, ok_fq = close_enough(fused[0], dq, tol / 2)
    check(ok_fq, f"fused and two-pass dq differ at {where}: {err_fq}")
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    lq, lk, lv = (x.detach().requires_grad_() for x in (q4, k4, v4))
    lout = TF.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    library_ms = median_ms(lambda: torch.autograd.grad(
        lout, (lq, lk, lv), do4, retain_graph=True))
    library_device_ms = sdpa_backward_device_ms(torch, TF, lq, lk, lv, do4,
                                                causal)
    plain_ms = median_ms(lambda: fa.flash_attention_bwd_plain(*args),
                         samples=10, per_sample=3, warmup=2)
    timed = {"flash_bwd_fused": lambda: fa.flash_attention_bwd_fused(*args),
             "flash_bwd_dq": lambda: fa.flash_attention_bwd_dq(*args),
             "flash_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(*args)}
    # the passes around the kernels: delta and the fused form's zeroed dq
    # workspace from the prep kernel against their plain versions (f32
    # sums of D products in another order)
    delta, dq_ws = fa._bwd_inputs("flash_bwd_prep", q, k, v, out, lse, do,
                                  workspace=True)
    err_d, ok_d = close_enough(delta, fa._delta(do, out), 1e-4)
    check(ok_d and bool((dq_ws == 0).all()),
          f"flash_bwd_prep: delta max abs err {err_d} or a non-zero "
          f"workspace at {where}")
    # the C entry points alone, on buffers made once: the wrapper adds the
    # prep pass and, for the fused form, the scale-and-cast of dq
    dq_b, dk_b, dv_b = (torch.empty_like(x) for x in (q, k, v))
    bufs = {"flash_bwd_fused": (q, k, v, do, lse, delta, dq_ws, dk_b, dv_b),
            "flash_bwd_dq": (q, k, v, do, lse, delta, dq_b),
            "flash_bwd_dkv": (q, k, v, do, lse, delta, dk_b, dv_b)}
    rows = {}
    for kname, fn in timed.items():
        entry = bufs[kname]
        device_ms = graph_ms(torch, lambda: fa._launch(
            fa._BWD, kname, entry, q, causal))
        bound_ms, bound_by = attention_bound(
            kname, b * h, s, d, q.element_size(), causal,
            peak_of(torch, dtype))
        rows[kname] = {"shape": [b, s, h, d],
                       "dtype": str(dtype).replace("torch.", ""),
                       "causal": causal, "max_abs_err": errs[kname],
                       "tol": tol, "ms": median_ms(fn),
                       "device_ms": device_ms,
                       "wrapper_device_ms": graph_ms(torch, fn),
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library_device_ms": library_device_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by}
    rows["fused_vs_two_pass_dq_err"] = err_fq
    return rows


def ring_pairs(sq, sk, offs, causal):
    """Visible (q, k) pairs of one hop: key j is visible to row i when
    k_off + j <= q_off + i."""
    if not causal:
        return sq * sk
    q_off, k_off = offs
    return sum(min(max(q_off + i - k_off + 1, 0), sk) for i in range(sq))


def ring_work(name, bh, sq, sk, d, itemsize, causal, offs, merged):
    """(FLOPs, bytes) of one hop: the products over the visible pairs, each
    input read once and each output written once (f32 dq, dk, dv at 4
    bytes; a hop that sees no key needs no input). With `merged`, the step
    kernels' middle step: the forward reads and writes the f32 (o, lse)
    accumulators instead of writing out, dq and dk/dv read and write their
    f32 accumulators; a hop that sees no key touches none of them."""
    pairs = ring_pairs(sq, sk, offs, causal)
    flops = 2 * PRODUCTS[name] * d * pairs * bh
    qrows, krows = bh * sq * d, bh * sk * d
    if name == "ring_fwd" and merged:  # q, k, v, o, lse -> o, lse
        reads = (qrows + 2 * krows) * itemsize + (qrows + bh * sq) * 4
        writes = (qrows + bh * sq) * 4
    elif name == "ring_fwd":   # q, k, v -> out, lse
        reads = (qrows + 2 * krows) * itemsize
        writes = qrows * itemsize + bh * sq * 4
    elif name == "ring_dq_step":  # q, dO, k, v, lse, delta (+ dq) -> dq
        reads = (2 * qrows + 2 * krows) * itemsize + 2 * bh * sq * 4 + \
            (qrows * 4 if merged else 0)
        writes = qrows * 4
    else:                      # the same inputs (+ dk, dv) -> dk, dv f32
        reads = (2 * qrows + 2 * krows) * itemsize + 2 * bh * sq * 4 + \
            (2 * krows * 4 if merged else 0)
        writes = 2 * krows * 4
    if not pairs:
        return 0, (0 if merged else writes)
    return flops, reads + writes


def ring_bound(name, bh, sq, sk, d, itemsize, causal, offs, peak_ops,
               merged=False):
    """Least time (ms) of a launch over the slot-hops at `offs` (one
    (q_off, k_off) pair, or a list of them): FLOPs over the peak for the
    input type against bytes over the memory rate, summed over the
    slot-hops (`ring_work`)."""
    offs = offs if isinstance(offs, list) else [offs]
    flops, nbytes = map(sum, zip(*(
        ring_work(name, bh, sq, sk, d, itemsize, causal, o, merged)
        for o in offs)))
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def ring_case(tra, torch, bh, sq, sk, d, dtype, causal, offs):
    """The three ring kernels vs their plain versions on one hop; each
    kernel's numbers. dq and dk/dv take the plain forward's lse and delta,
    as the ring gives them the merged rows."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + 2 + sq + sk + d + offs[0])
    q, do = (torch.randn(bh, sq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = tra.ring_block_fwd(q, k, v, offs, causal)
    ref_out, ref_lse = tra.ring_block_fwd_plain(q, k, v, offs, causal)
    delta = (do.float() * ref_out.float()).sum(-1)[:, None, :]
    bargs = (q, k, v, do, ref_lse, delta, offs, causal)
    dq = tra.ring_block_dq(*bargs)
    dk, dv = tra.ring_block_dkv(*bargs)
    torch.cuda.synchronize()
    ref_dq = tra.ring_block_dq_plain(*bargs)
    ref_dk, ref_dv = tra.ring_block_dkv_plain(*bargs)
    bf16 = dtype == torch.bfloat16
    # bf16: the kernels round p (and ds) to bf16 before the products, as
    # the Pallas kernels do, and store out in bf16; the plain versions keep
    # f32. fp32: sums in another order.
    tol = 2e-2 if bf16 else 1e-4
    where = f"BH={bh} Sq={sq} Sk={sk} D={d} {dtype} {causal=} {offs=}"
    errs = {}
    for kname, pairs in (("ring_fwd", ((out, ref_out), (lse, ref_lse))),
                         ("ring_dq_step", ((dq, ref_dq),)),
                         ("ring_dkv", ((dk, ref_dk), (dv, ref_dv)))):
        errs[kname] = 0.0
        for got, want in pairs:
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kname}: non-finite output at {where}")
            err, ok = close_enough(got, want, tol)
            check(ok, f"{kname} disagrees with its plain version at {where}:"
                  f" max abs err {err}")
            errs[kname] = max(errs[kname], err)
    future = causal and offs[1] >= offs[0] + sq
    if future:
        check(all(bool((x == 0).all()) for x in (out, dq, dk, dv)) and
              bool((lse == -1e30).all()),
              f"the future hop did not write exact zeros and -1e30 at {where}")
    step_errs = step_check(tra, torch, bh, sq, sk, d, dtype, causal, offs,
                           tol, where)
    # the library yardstick where one SDPA call computes the same out: a
    # hop that sees every key (non-causal, or wholly in the past) or the
    # diagonal hop
    lib_causal = None
    if not causal or offs[0] >= offs[1] + sk - 1:
        lib_causal = False
    elif offs[0] == offs[1] and sq == sk:
        lib_causal = True
    lib_fwd = lib_bwd = lib_fwd_dev = lib_bwd_dev = None
    if lib_causal is not None:
        q4, k4, v4, do4 = (x.view(1, bh, x.shape[1], d) for x in (q, k, v, do))

        def library():
            return TF.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=lib_causal)

        lib_fwd, lib_fwd_dev = median_ms(library), graph_ms(torch, library)
        lq, lk, lv = (x.detach().requires_grad_() for x in (q4, k4, v4))
        lout = TF.scaled_dot_product_attention(lq, lk, lv,
                                               is_causal=lib_causal)
        lib_bwd = median_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), do4, retain_graph=True))
        lib_bwd_dev = sdpa_backward_device_ms(torch, TF, lq, lk, lv, do4,
                                              lib_causal)
    timed = {
        "ring_fwd": (lambda: tra.ring_block_fwd(q, k, v, offs, causal),
                     lambda: tra.ring_block_fwd_plain(q, k, v, offs, causal),
                     lib_fwd, lib_fwd_dev),
        "ring_dq_step": (lambda: tra.ring_block_dq(*bargs),
                         lambda: tra.ring_block_dq_plain(*bargs), lib_bwd,
                         lib_bwd_dev),
        "ring_dkv": (lambda: tra.ring_block_dkv(*bargs),
                     lambda: tra.ring_block_dkv_plain(*bargs), lib_bwd,
                     lib_bwd_dev)}
    rows = {}
    for kname, (fn, plain, lib, lib_dev) in timed.items():
        bound_ms, bound_by = ring_bound(kname, bh, sq, sk, d,
                                        q.element_size(), causal, offs,
                                        PEAK_BF16 if bf16 else PEAK_FP32)
        rows[kname] = {"shape": [bh, sq, sk, d], "offs": list(offs),
                       "dtype": str(dtype).replace("torch.", ""),
                       "causal": causal, "max_abs_err": errs[kname],
                       "tol": tol, "ms": median_ms(fn),
                       "device_ms": graph_ms(torch, fn),
                       "plain_ms": median_ms(plain, samples=10),
                       "library_ms": lib, "library_device_ms": lib_dev,
                       "bound_ms": bound_ms,
                       "bound_by": bound_by, "future": future,
                       "max_abs_err_group": step_errs.get(kname)}
    return rows


def step_check(tra, torch, bh, sq, sk, d, dtype, causal, offs, tol, where):
    """The three step kernels against their plain versions on a group of
    two slots at the case's offsets (two draws of data), at a middle step
    and the last (forward): the running f32 accumulators are drawn at
    random, and a hop that sees no key must leave them bit-unchanged.
    Returns each kernel's max abs error."""
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + 4 + sq + sk + d + offs[0])

    def draw(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    qs, dos = ([draw(bh, sq, d) for _ in range(2)] for _ in range(2))
    ks, vs = ([draw(bh, sk, d) for _ in range(2)] for _ in range(2))
    pair = [offs, offs]
    o = [draw(bh, sq, d, dt=torch.float32) for _ in range(2)]
    lse = [draw(bh, 1, sq, dt=torch.float32) + 5.0 for _ in range(2)]
    future = causal and offs[1] >= offs[0] + sq
    errs = {"ring_fwd": 0.0, "ring_dq_step": 0.0, "ring_dkv": 0.0}

    def held(kname, got, want):
        for g, w in zip(got, want):
            check(bool(torch.isfinite(g.float()).all()),
                  f"{kname}: non-finite output at {where}")
            err, ok = close_enough(g, w, tol)
            check(ok, f"{kname} (group of 2) disagrees with its plain version"
                  f" at {where}: max abs err {err}")
            errs[kname] = max(errs[kname], err)

    for last in (False, True):
        ok_, lk = [x.clone() for x in o], [x.clone() for x in lse]
        op, lp = [x.clone() for x in o], [x.clone() for x in lse]
        got = tra.ring_fwd_step(qs, ks, vs, pair, ok_, lk, causal, last=last)
        want = tra.ring_fwd_step_plain(qs, ks, vs, pair, op, lp, causal,
                                       last=last)
        torch.cuda.synchronize()
        held("ring_fwd", (got if last else ok_) + lk,
             (want if last else op) + lp)
        if future:
            same = all(torch.equal(a, b) for a, b in zip(lk, lse)) and (
                all(torch.equal(a, b.to(dtype)) for a, b in zip(got, o))
                if last else all(torch.equal(a, b) for a, b in zip(ok_, o)))
            check(same, f"the future hop changed the accumulators at {where}")
    fwd = [tra.ring_block_fwd_plain(q, k, v, offs, causal)
           for q, k, v in zip(qs, ks, vs)]
    glse = [lse_ for _, lse_ in fwd]
    delta = [(g.float() * out.float()).sum(-1)[:, None, :]
             for g, (out, _) in zip(dos, fwd)]
    dq = [draw(bh, sq, d, dt=torch.float32) for _ in range(2)]
    dk, dv = ([draw(bh, sk, d, dt=torch.float32) for _ in range(2)]
              for _ in range(2))
    dqk, dqp = [x.clone() for x in dq], [x.clone() for x in dq]
    dkk, dvk = [x.clone() for x in dk], [x.clone() for x in dv]
    dkp, dvp = [x.clone() for x in dk], [x.clone() for x in dv]
    dargs = (qs, ks, vs, dos, glse, delta, pair)
    tra.ring_dq_step(*dargs, dqk, causal)
    tra.ring_dq_step_plain(*dargs, dqp, causal)
    tra.ring_dkv_step(*dargs, dkk, dvk, causal)
    tra.ring_dkv_step_plain(*dargs, dkp, dvp, causal)
    torch.cuda.synchronize()
    held("ring_dq_step", dqk, dqp)
    held("ring_dkv", dkk + dvk, dkp + dvp)
    if future:
        check(all(torch.equal(a, b) for a, b in zip(dqk + dkk + dvk,
                                                    dq + dk + dv)),
              f"the future hop changed the dq or dk/dv accumulators at "
              f"{where}")
    return errs


def ring_step_case(tra, torch, bh, s_loc, d, dtype, causal, step,
                   n=SP_DEGREE):
    """The step kernels on the slots of one ring step on one card, as the
    sp train gives them: n slots of [bh, s_loc, d], slot i at q_off =
    i s_loc holding block (i - step) mod n, a middle step (accumulators
    read and written, drawn from an earlier hop). Held against the plain
    versions; timed through the wrapper (per launch), as device time per
    launch and per slot-hop (a CUDA graph), beside the plain versions and
    SDPA (the n hops stacked in one call, and one hop)."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5 + s_loc + d)

    def draw(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    qs, dos, ks, vs, kp, vp = ([draw(bh, s_loc, d) for _ in range(n)]
                               for _ in range(6))
    offs = [(i * s_loc, ((i - step) % n) * s_loc) for i in range(n)]
    prev = [(i * s_loc, ((i - step + 1) % n) * s_loc) for i in range(n)]
    o = [torch.empty(bh, s_loc, d, device="cuda") for _ in range(n)]
    lse = [torch.empty(bh, 1, s_loc, device="cuda") for _ in range(n)]
    tra.ring_fwd_step_plain(qs, kp, vp, prev, o, lse, causal, first=True)
    tols = {"ring_fwd": tol_of(torch, dtype),
            "ring_dkv": tol_of(torch, dtype, grad=True)}
    where = f"ring step {step} of {n} slots [{bh}, {s_loc}, {d}] {dtype} " \
        f"{causal=}"
    ok_, lk = [x.clone() for x in o], [x.clone() for x in lse]
    op, lp = [x.clone() for x in o], [x.clone() for x in lse]
    tra.ring_fwd_step(qs, ks, vs, offs, ok_, lk, causal)
    tra.ring_fwd_step_plain(qs, ks, vs, offs, op, lp, causal)
    delta = [(g.float() * x).sum(-1)[:, None, :] for g, x in zip(dos, op)]
    dk, dv = ([draw(bh, s_loc, d, dt=torch.float32) for _ in range(n)]
              for _ in range(2))
    dkk, dvk = [x.clone() for x in dk], [x.clone() for x in dv]
    dkp, dvp = [x.clone() for x in dk], [x.clone() for x in dv]
    dargs = (qs, ks, vs, dos, lp, delta, offs)
    tra.ring_dkv_step(*dargs, dkk, dvk, causal)
    tra.ring_dkv_step_plain(*dargs, dkp, dvp, causal)
    torch.cuda.synchronize()
    errs = {}
    for kname, got, want in (("ring_fwd", ok_ + lk, op + lp),
                             ("ring_dkv", dkk + dvk, dkp + dvp)):
        errs[kname] = 0.0
        for g, w in zip(got, want):
            check(bool(torch.isfinite(g).all()), f"{kname}: non-finite at "
                  f"{where}")
            err, ok = close_enough(g, w, tols[kname])
            check(ok, f"{kname} disagrees with its plain version at {where}:"
                  f" max abs err {err}")
            errs[kname] = max(errs[kname], err)
    stack = [torch.stack(x) for x in (qs, ks, vs, dos)]   # [n, bh, s, d]
    lib = {}
    if not causal:  # SDPA computes the hops' attention when all is visible
        def sdpa():
            return TF.scaled_dot_product_attention(*stack[:3])

        def sdpa_hop():
            return TF.scaled_dot_product_attention(
                *(x[:1] for x in stack[:3]))
        lq, lk_, lv = (x.detach().requires_grad_() for x in stack[:3])
        lout = TF.scaled_dot_product_attention(lq, lk_, lv)
        lib = {"fwd": (median_ms(sdpa), graph_ms(torch, sdpa),
                       graph_ms(torch, sdpa_hop)),
               "bwd": (median_ms(lambda: torch.autograd.grad(
                   lout, (lq, lk_, lv), stack[3], retain_graph=True)),
                   sdpa_backward_device_ms(torch, TF, *stack, False),
                   sdpa_backward_device_ms(torch, TF,
                                           *(x[:1] for x in stack), False))}
    timed = {
        "ring_fwd": (lambda: tra.ring_fwd_step(qs, ks, vs, offs, ok_, lk,
                                               causal),
                     lambda: tra.ring_fwd_step_plain(qs, ks, vs, offs, op,
                                                     lp, causal), "fwd"),
        "ring_dkv": (lambda: tra.ring_dkv_step(*dargs, dkk, dvk, causal),
                     lambda: tra.ring_dkv_step_plain(*dargs, dkp, dvp,
                                                     causal), "bwd")}
    rows = {}
    for kname, (fn, plain, lkey) in timed.items():
        bound_ms, bound_by = ring_bound(kname, bh, s_loc, s_loc, d,
                                        qs[0].element_size(), causal, offs,
                                        peak_of(torch, dtype), merged=True)
        device_ms = graph_ms(torch, fn)
        lib_ms, lib_dev, lib_hop = lib.get(lkey, (None, None, None))
        rows[kname] = {"shape": [n, bh, s_loc, s_loc, d], "offs": offs,
                       "dtype": str(dtype).replace("torch.", ""),
                       "causal": causal, "max_abs_err": errs[kname],
                       "tol": tols[kname], "ms": median_ms(fn),
                       "device_ms": device_ms,
                       "device_ms_per_hop": device_ms / n,
                       "plain_ms": median_ms(plain, samples=10),
                       "library_ms": lib_ms, "library_device_ms": lib_dev,
                       "library_hop_device_ms": lib_hop,
                       "bound_ms": bound_ms, "bound_ms_per_hop": bound_ms / n,
                       "bound_by": bound_by}
    return rows


def dq_step_case(tra, torch, bh, sq, sk, d, dtype, causal, offs):
    """ring_dq_step on the slots of one ring step (one slot per (q_off,
    k_off) in `offs`: q, dO [bh, sq, d] against k, v [bh, sk, d]) against
    ring_dq_step_plain, both adding into the same non-zero f32
    accumulators: the part each added is held to the tolerance, and a slot
    whose hop is wholly in the future must leave its accumulator
    bit-unchanged. lse and delta are the hop's own (its plain forward's), as
    step_check takes them. Timed through the wrapper (per launch), as device
    time per launch and per slot-hop (a CUDA graph), beside the plain
    version and SDPA's backward (the slots' hops stacked in one call, and
    one hop) where SDPA computes the same attention."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    n = len(offs)
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + 6 + sq + sk + d + offs[0][0])

    def draw(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    qs, dos = ([draw(bh, sq, d) for _ in range(n)] for _ in range(2))
    ks, vs = ([draw(bh, sk, d) for _ in range(n)] for _ in range(2))
    fwd = [tra.ring_block_fwd_plain(q, k, v, off, causal)
           for q, k, v, off in zip(qs, ks, vs, offs)]
    lse = [x for _, x in fwd]
    delta = [(g.float() * o.float()).sum(-1)[:, None, :]
             for g, (o, _) in zip(dos, fwd)]
    acc = [draw(bh, sq, d, dt=torch.float32) for _ in range(n)]
    dargs = (qs, ks, vs, dos, lse, delta, offs)
    tol = tol_of(torch, dtype, grad=True)
    where = f"dq step of {n} slots [{bh}, {sq}, {sk}, {d}] {dtype} " \
        f"{causal=} {offs=}"
    want = [x.clone() for x in acc]
    tra.ring_dq_step_plain(*dargs, want, causal)
    got = [x.clone() for x in acc]
    tra.ring_dq_step(*dargs, got, causal)
    torch.cuda.synchronize()
    err = 0.0
    for i, (g, w, a) in enumerate(zip(got, want, acc)):
        check(bool(torch.isfinite(g).all()),
              f"ring_dq_step: non-finite at {where}")
        # the added part alone: the accumulator's own size must not widen
        # the tolerance
        e, ok = close_enough(g - a, w - a, tol)
        check(ok, f"ring_dq_step disagrees with its plain version at "
              f"{where}: max abs err {e}")
        err = max(err, e)
        if causal and offs[i][1] >= offs[i][0] + sq:
            check(torch.equal(g, a), f"ring_dq_step changed slot {i}'s "
                  f"accumulator, whose hop is wholly in the future, at "
                  f"{where}")
    lib = (None, None, None)
    diag = all(o[0] == o[1] for o in offs) and sq == sk
    if not causal or diag:
        stack = [torch.stack(x) for x in (qs, ks, vs, dos)]  # [n, bh, s, d]
        lq, lk, lv = (x.detach().requires_grad_() for x in stack[:3])
        lout = TF.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        lib = (median_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), stack[3], retain_graph=True)),
            sdpa_backward_device_ms(torch, TF, *stack, causal),
            sdpa_backward_device_ms(torch, TF, *(x[:1] for x in stack),
                                    causal))
    timed = [x.clone() for x in acc]
    device_ms = graph_ms(torch, lambda: tra.ring_dq_step(*dargs, timed,
                                                        causal))
    plain = [x.clone() for x in acc]
    bound_ms, bound_by = ring_bound("ring_dq_step", bh, sq, sk, d,
                                    qs[0].element_size(), causal, list(offs),
                                    peak_of(torch, dtype), merged=True)
    return {"shape": [n, bh, sq, sk, d], "offs": [list(o) for o in offs],
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "max_abs_err": err, "tol": tol,
            "ms": median_ms(lambda: tra.ring_dq_step(*dargs, timed, causal)),
            "device_ms": device_ms, "device_ms_per_hop": device_ms / n,
            "plain_ms": median_ms(lambda: tra.ring_dq_step_plain(
                *dargs, plain, causal), samples=10),
            "library_ms": lib[0], "library_device_ms": lib[1],
            "library_hop_device_ms": lib[2], "bound_ms": bound_ms,
            "bound_ms_per_hop": bound_ms / n, "bound_by": bound_by}


def graph_ms(torch, fn, calls=20, samples=10, stream=None):
    """Device time of one call of `fn` without the host's cost per call:
    `calls` calls captured in one CUDA graph, the graph replayed and timed
    with CUDA events (median of `samples` replays). `median_ms` times the
    wrapper as a caller sees it, host work included; for a kernel of a few
    microseconds the two differ by the host's launch cost."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    del graph
    return statistics.median(times)


def sdpa_backward_device_ms(torch, TF, q, k, v, do, causal):
    """Device time of PyTorch's SDPA backward on these inputs: a CUDA
    graph of forward + backward less a graph of the forward alone. The
    leaves are made on the capturing stream, so that the backward's
    gradient nodes run on it too."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd():
        return TF.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (q, k, v), do)

    try:
        return graph_ms(torch, fwd_bwd, stream=stream) - \
            graph_ms(torch, fwd, stream=stream)
    except Exception as e:  # noqa: BLE001 — a yardstick only: not measured
        print(f"chip_smoke: SDPA backward not captured in a CUDA graph: {e}",
              file=sys.stderr, flush=True)
        torch.cuda.synchronize()
        return None


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    return 1.0 if na == nb == 0 else (a @ b).item() / (na * nb)


def train_phase(pt, fa, torch, np, card, shape_rows):
    """gpt2_small trained in bf16 AMP through jit.TrainStep + AdamW."""
    from paddle_tpu_torch.jit import amp_functional_call, split_state
    from paddle_tpu_torch.utils.bench import step_split_ms
    pt.set_device("gpu")
    pt.seed(SEED)
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    n_layers = len(model.gpt.layers)
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    crit = pt.models.GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(model, crit, opt, amp_dtype="bfloat16")
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_B, TRAIN_S))).cuda()
    trainable, frozen = split_state(model)
    pnames, ps = list(trainable), list(trainable.values())
    bnames, bufs = list(frozen), list(frozen.values())
    n_params = sum(p.numel() for p in ps)

    def grads_of(amp_dtype, deterministic=False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                with torch.enable_grad():
                    logits = amp_functional_call(model, pnames, ps, bnames,
                                                 bufs, [ids], amp_dtype)
                    loss = crit(logits, ids)
                    grads = torch.autograd.grad(loss, ps)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        return float(loss.detach()), [g.float() for g in grads]

    # ---- step-1 gradients: bf16 kernels (fused and two-pass) vs fp32 ----
    # fp32 at S=1024 takes the einsum path (the kernel from S=4096): no
    # kernel, the reference of the check
    loss32, g32 = grads_of(None)
    loss_f, g_f = grads_of("bfloat16")
    loss_d, g_d = grads_of("bfloat16", deterministic=True)
    rel = abs(loss_f - loss32) / abs(loss32)
    cos_32 = min((cosine(a, b), n) for a, b, n in zip(g_f, g32, pnames))
    cos_fd = min((cosine(a, b), n) for a, b, n in zip(g_f, g_d, pnames))
    print(f"train: step-1 loss fp32 {loss32:.6f} bf16 fused {loss_f:.6f} "
          f"bf16 two-pass {loss_d:.6f}; rel err bf16 vs fp32 {rel:.3g} "
          f"(tol 2e-2); min per-parameter grad cosine bf16 vs fp32 "
          f"{cos_32[0]:.6f} ({cos_32[1]}, tol 0.99), fused vs two-pass "
          f"{cos_fd[0]:.6f} ({cos_fd[1]}, tol 0.999) [{card}]", flush=True)
    # bf16 weights, activations, logits and loss (2^-8 relative per
    # rounding) through 12 post-LN layers against fp32
    check(rel <= 2e-2, f"bf16 vs fp32 step-1 loss rel err {rel}")
    check(cos_32[0] >= 0.99, f"bf16 vs fp32 gradient cosine {cos_32}")
    # the two forms differ only in the order of dq's f32 sums, which then
    # flows back through bf16 layers
    check(loss_d == loss_f, f"two-pass step changed the loss: {loss_d} vs "
          f"{loss_f}")
    check(cos_fd[0] >= 0.999, f"fused vs two-pass gradient cosine {cos_fd}")
    del g32, g_f, g_d
    torch.cuda.empty_cache()

    # ---- the main path: TrainStep through its entry points ----
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t_start = time.perf_counter()
    losses = [step(ids, ids)]                       # warm-up step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t_calls = time.perf_counter()
    events[0].record()
    for i in range(5):
        losses.append(step(ids, ids))
        events[i + 1].record()
    torch.cuda.synchronize()
    calls_s = time.perf_counter() - t_calls
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(5)]
    stacked = ids.expand(5, TRAIN_B, TRAIN_S)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    span = step.run(stacked, stacked)
    e1.record()
    torch.cuda.synchronize()
    run_ms = e0.elapsed_time(e1) / 5
    losses.extend(span.unbind(0))
    before = [c.launches for c in counters]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det_loss = float(step(ids, ids))
        finally:
            torch.use_deterministic_algorithms(False)
    det = [c.launches - n for c, n in zip(counters, before)]
    launches = {name: c.launches for name, c in zip(
        ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"),
        counters)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = 1 + 5 + 5 + 1
    # the wrappers count host calls: run()'s span is its eager first step
    # and one capture (the replays launch on the device alone; the graph
    # phase counts them in the device trace)
    n_host = 1 + 5 + 2 + 1
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses + [det_loss]),
          f"non-finite loss: {losses} {det_loss}")
    check(losses[-1] < losses[0], f"the loss did not fall over 10 steps on "
          f"the repeated batch: {losses}")
    check(launches["flash_fwd"] == n_layers * n_host,
          f"flash_fwd launched {launches['flash_fwd']} times in "
          f"{n_host} host-driven steps of {n_layers} layers")
    check(launches["flash_bwd_fused"] == n_layers * (n_host - 1),
          f"flash_bwd_fused launched {launches['flash_bwd_fused']} times")
    check(det == [n_layers, 0, n_layers, n_layers],
          f"the deterministic step launched {det} (fwd, fused, dq, dkv)")

    # ---- where one step's device time goes (outside the counted run) ----
    split = step_split_ms(step, ids, ids)
    med_ms = statistics.median(step_ms)
    tokens = TRAIN_B * TRAIN_S
    # 6 FLOPs per parameter per token (the embedding table counted once, as
    # the tied head) plus causal attention's forward and backward products
    bh, d = TRAIN_B * model.gpt.layers[0].attention.num_heads, \
        model.gpt.layers[0].attention.head_dim
    pairs = TRAIN_S * (TRAIN_S + 1) // 2
    pos = model.gpt.embeddings.position_embeddings.weight.numel()
    step_flops = 6 * (n_params - pos) * tokens + n_layers * 2 * (
        PRODUCTS["flash_fwd"] + PRODUCTS["flash_bwd_fused"]) * d * pairs * bh
    fwd_row = shape_rows["fwd"]
    bwd_row = shape_rows["flash_bwd_fused"]
    attn_ms = n_layers * (fwd_row["device_ms"] +
                          bwd_row["wrapper_device_ms"])
    print(f"train: gpt2_small bf16 AMP {TRAIN_B}x{TRAIN_S} tokens, "
          f"{n_params} parameters, AdamW(1e-4): losses "
          f"{[round(x, 4) for x in losses]} then {det_loss:.4f} "
          f"(deterministic step) [{card}]", flush=True)
    print(f"train: step time median {med_ms:.3f} ms over 5 __call__ steps "
          f"(CUDA events; {[round(x, 3) for x in step_ms]}), run() "
          f"{run_ms:.3f} ms per step over 5; tokens/s "
          f"{tokens / med_ms * 1e3:.1f}; warm-up step {warm_s * 1e3:.1f} ms "
          f"host; 5 calls {calls_s * 1e3:.1f} ms host; step bound "
          f"{step_flops / PEAK_BF16 * 1e3:.3f} ms ({step_flops / 1e12:.3f} "
          f"TFLOP at 989 TFLOP/s), model FLOP utilisation "
          f"{step_flops / (med_ms * 1e-3) / PEAK_BF16:.3f} [{card}]",
          flush=True)
    print(f"train: one step's device time: forward {split['forward']:.3f} ms"
          f", backward {split['backward']:.3f} ms, optimizer "
          f"{split['optimizer']:.3f} ms (CUDA events, median of 3); "
          f"attention ~{attn_ms:.3f} ms of it ({n_layers} x (fwd "
          f"{fwd_row['device_ms']:.4f} + fused bwd wrapper "
          f"{bwd_row['wrapper_device_ms']:.4f}) ms, CUDA graphs at this "
          f"shape); peak max_memory_allocated "
          f"{peak_gib:.2f} GiB [{card}]", flush=True)
    print(f"train: attention launches (host calls) in {n_steps} steps, "
          f"{n_host} of them from the host (run()'s span: its first step "
          f"and one capture): {launches} (deterministic step: fwd, fused, "
          f"dq, dkv = {det}) [{card}]", flush=True)
    del step, opt, model
    torch.cuda.empty_cache()
    return launches


def serve_phase(pt, fa, torch, np, card):
    """gpt2_small in bf16 through Predictor -> ServingEngine."""
    pt.set_device("gpu")
    pt.seed(SEED)
    model32 = pt.models.GPTForCausalLM(pt.models.gpt2_small())
    model32.eval()
    model = copy.deepcopy(model32).bfloat16()
    n_layers = len(model.gpt.layers)
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    seq = 1024
    pred = pt.inference.Predictor(
        model, input_spec=[pt.InputSpec([4, seq], "int32")])
    engine = pt.serving.ServingEngine(pred, pt.serving.EngineConfig(
        max_batch_size=4, batch_sizes=(1, 2, 4), batch_timeout_ms=20.0))
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, vocab, (1, seq)).astype(np.int32)
                for _ in range(8)]
    results_by_req = [None] * len(requests)
    latencies = [None] * len(requests)
    errors = []

    def client(idxs):
        try:
            for i in idxs:
                t = time.perf_counter()
                results_by_req[i] = engine.submit([requests[i]]).result(600)
                latencies[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    with kept_graphs(torch):
        t_start = time.perf_counter()
        engine.start()
        t_warm = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=([2 * j, 2 * j + 1],))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t_warm
        engine.stop(drain=True)
    launches = fa.flash_attention_fwd.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(not errors, f"requests failed: {errors}")
    counts = engine.stats()["counters"]
    dispatched = counts["batches"] + counts["warmup_runs"]
    check(counts["completed"] == len(requests),
          f"completed {counts['completed']} of {len(requests)}")
    # the live layer serves through to_static: each signature's first
    # dispatch exports, runs eagerly and captures (2 host launches a
    # layer), every later one replays its graph (a kernel node a layer)
    from paddle_tpu_torch.utils.train_profile import (graph_kernel_names,
                                                      kernel_counts)
    n_sigs = len(pred._fn._programs)
    nodes = [kernel_counts(graph_kernel_names(rep.graph))["flash_fwd"]
             for rep in pred._fn.captures()]
    check(isinstance(pred._fn, pt.jit.StaticFunction) and
          len(nodes) == n_sigs and all(n == n_layers for n in nodes) and
          launches == 2 * n_layers * n_sigs,
          f"attention kernel launched {launches} times from the host for "
          f"{n_sigs} signatures of {n_layers} layers, graph nodes {nodes}")
    replayed = n_layers * (dispatched - n_sigs)
    for i, out in enumerate(results_by_req):
        logits = out[0][0]
        check(logits.shape == (seq, vocab) and logits.dtype == np.float32,
              f"request {i}: logits {logits.shape} {logits.dtype}")
        check(bool(np.isfinite(logits).all()), f"request {i}: non-finite")

    # one request against the same weights in float32 (at S=1024 fp32
    # attention takes the einsum path: no kernel)
    with torch.inference_mode():
        ref = model32(torch.from_numpy(requests[0]).cuda())[0].cpu().numpy()
    got = results_by_req[0][0][0]
    rel = float(np.abs(got - ref).mean() / np.abs(ref).mean())
    top1 = float((got.argmax(-1) == ref.argmax(-1)).mean())
    # bf16 weights and activations (2^-8 relative rounding per step) across
    # 12 post-LN layers, against fp32: relative mean-abs error <= 2e-2
    check(rel <= 2e-2, f"bf16 serve vs fp32 relative mean-abs error {rel}")
    # where a batch's time goes: the model on the device vs the whole
    # run_batch (adds the bf16->f32 logits copy to the host)
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    batch4 = [np.concatenate(requests[:4])]
    fwd_ms = median_ms(lambda: pred._forward(batch4), samples=5,
                       per_sample=2, warmup=1)
    t = time.perf_counter()
    pred.run_batch(batch4)
    run_batch_ms = (time.perf_counter() - t) * 1e3
    print(f"serve breakdown: batch of 4 x {seq} tokens: model forward on "
          f"the device {fwd_ms:.2f} ms, run_batch (forward + logits to "
          f"host as f32) {run_batch_ms:.1f} ms [{card}]", flush=True)

    lat_ms = sorted(x * 1e3 for x in latencies)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, math.ceil(0.99 * len(lat_ms)) - 1)]
    print(f"serve: gpt2_small bf16 S={seq}: {len(requests)} requests in "
          f"{wall:.3f} s after {1e3 * (t_warm - t_start):.0f} ms warm-up "
          f"({counts['warmup_runs']} runs, one to_static export + capture "
          f"per batch bucket: {n_sigs} signatures); "
          f"batches={counts['batches']} "
          f"requests/s={len(requests) / wall:.3f} "
          f"tokens/s={len(requests) * seq / wall:.1f} p50_ms={p50:.1f} "
          f"p99_ms={p99:.1f} peak_mem_mib={peak_mib:.0f} "
          f"attention_launches={launches} host ({2 * n_layers} x {n_sigs} "
          f"signatures: eager run + capture) and {replayed} replayed "
          f"({n_layers} graph nodes x {dispatched - n_sigs} replays) "
          f"vs_fp32_rel_mean_abs_err={rel:.3g} top1_agree={top1:.4f}"
          f" [{card}]", flush=True)
    return launches


RING_KERNELS = ("ring_fwd", "ring_dq_step", "ring_dkv")


def ring_wrappers(tra):
    """The counted wrappers of the three ring step kernels, by name."""
    return dict(zip(RING_KERNELS, (tra.ring_fwd_step, tra.ring_dq_step,
                                   tra.ring_dkv_step)))


def ring_counts(tra):
    """A reader of the ring wrappers' counts: launches and slot-hops of the
    three step kernels."""
    def read():
        counts = {}
        for name, w in ring_wrappers(tra).items():
            counts[name] = w.launches
            counts[name + "_hops"] = w.hops
        return counts
    return read


def ring_launches_per_layer(devices):
    """What one layer's forward and backward over the ring must launch:
    each step kernel once per ring step and device (MAX_SLOTS slots at
    most), every slot-hop covered once."""
    from paddle_tpu_torch.parallel import sp
    n = len(devices)
    steps = n * len(sp._step_groups(devices))
    want = {}
    for name in RING_KERNELS:
        want[name] = steps
        want[name + "_hops"] = n * n
    return want


def ring_phase(fa, tra, torch, card, devices):
    """The 4-slot causal flash ring at S=4096 against single-device flash
    attention on the same q/k/v, forward and backward."""
    from paddle_tpu_torch.parallel import create_mesh, set_mesh, sp
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    b, s, h, d = 1, 4096, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    base = [torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]
    w = torch.randn(b, s, h, d, generator=gen, device="cuda")
    mesh = create_mesh({"sp": SP_DEGREE}, devices=devices)
    set_mesh(None)

    def ring(q, k, v):
        return sp.sequence_parallel_attention(q, k, v, impl="ring",
                                              causal=True, mesh=mesh)

    def flash(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def fwd_bwd(fn):
        q, k, v = (x.detach().requires_grad_() for x in base)
        out = fn(q, k, v)
        grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
        return out, grads

    counts = ring_counts(tra)
    before = counts()
    out, grads = fwd_bwd(ring)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    ref, ref_grads = fwd_bwd(flash)
    torch.cuda.synchronize()
    want = ring_launches_per_layer(devices)
    check(launched == want, f"the {SP_DEGREE}-slot ring launched {launched}"
          f", not {want}")
    # both in bf16 with f32 accumulation; they tile the sequence and round
    # p to bf16 at different places
    err_out, ok = close_enough(out, ref, 2e-2)
    check(ok, f"ring vs flash attention out: max abs err {err_out}")
    verdicts = []
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        err, ok = close_enough(g, r, 2e-2)
        cos = cosine(g.float(), r.float())
        check(ok or cos >= 0.999, f"ring vs flash {name}: max abs err {err}"
              f", cosine {cos}")
        verdicts.append(f"{name} max abs err {err:.3g} cosine {cos:.6f} "
                        f"({'elementwise 2e-2(1+|ref|)' if ok else 'cosine >= 0.999'})")
    ring_ms = median_ms(lambda: fwd_bwd(ring), samples=5, per_sample=2,
                        warmup=1)
    flash_ms = median_ms(lambda: fwd_bwd(flash), samples=5, per_sample=2,
                         warmup=1)
    print(f"ring: causal sp={SP_DEGREE} ring over {len(set(devices))} "
          f"device(s) at B={b} S={s} H={h} D={d} bf16 (s_loc "
          f"{s // SP_DEGREE}) vs single-device flash attention: out max abs"
          f" err {err_out:.3g} (tol 2e-2(1+|ref|)); {'; '.join(verdicts)}; "
          f"launches and slot-hops {launched}; forward+backward "
          f"{ring_ms:.3f} ms ring vs {flash_ms:.3f} ms flash (CUDA events) "
          f"[{card}]", flush=True)


def fp16_phase(fa, tra, torch, card, devices):
    """fp16 attention on the card, where the reference's rule sends it to
    the kernels: one scaled_dot_product_attention call (S=4096, D=64, no
    mask) launches the flash forward and, for its backward, the fused
    backward; one sequence_parallel_attention(impl="ring") over a mesh of
    four slots launches each ring step kernel once per ring step; both
    agree with the fp32 einsum path on the same q/k/v. The ring at D=96,
    which the kernels are not built for, takes the dense ring and launches
    nothing. The memory each call holds above what was allocated before it
    (its peak, output and saved tensors included) is printed for the fp16
    kernel, the fp16 einsum path and the bf16 kernel."""
    from paddle_tpu_torch.nn.functional.attention import (
        _einsum_attention, scaled_dot_product_attention)
    from paddle_tpu_torch.parallel import create_mesh, set_mesh, sp
    b, s, h, d = 1, 4096, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
               for _ in range(3))
    ref = _einsum_attention(q, k, v, is_causal=True)
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
               *ring_wrappers(tra).values())
    h16 = [x.half().requires_grad_() for x in (q, k, v)]

    def peak_mib(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = fn()
        torch.cuda.synchronize()
        return res, (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    def launched_by(fn):
        before = [c.launches for c in counted]
        res = fn()
        torch.cuda.synchronize()
        return res, [c.launches - n for c, n in zip(counted, before)]

    (out, mib16), sdpa_launches = launched_by(lambda: peak_mib(
        lambda: scaled_dot_product_attention(*h16, is_causal=True)))
    _, bwd_launches = launched_by(
        lambda: torch.autograd.grad(out.float().sum(), h16))
    mesh = create_mesh({"sp": SP_DEGREE}, devices=devices)
    set_mesh(None)

    def ring_fwd_bwd(xs):
        res = sp.sequence_parallel_attention(*xs, impl="ring", causal=True,
                                             mesh=mesh)
        return res, torch.autograd.grad(res.float().sum(), xs)

    (ring_out, grads), ring_launches = launched_by(lambda: ring_fwd_bwd(h16))
    n_steps = ring_launches_per_layer(devices)["ring_fwd"]
    check(sdpa_launches == [1, 0, 0, 0, 0, 0, 0] and
          bwd_launches == [0, 1, 0, 0, 0, 0, 0] and
          ring_launches == [0, 0, 0, 0] + [n_steps] * 3,
          f"fp16 attention launched {sdpa_launches} (sdpa forward), "
          f"{bwd_launches} (its backward), {ring_launches} (the ring); each "
          "(flash fwd, fused, dq, dkv, ring fwd, dq, dkv)")
    check(all(bool(torch.isfinite(x).all()) for x in (out, ring_out, *grads))
          and out.dtype == ring_out.dtype == torch.float16,
          "fp16 attention: non-finite or not fp16")
    # fp16 inputs and outputs (2^-11 relative), p rounded to fp16 before
    # the PV product, against fp32
    errs = []
    for name, got in (("sdpa", out), ("ring", ring_out)):
        err, ok = close_enough(got, ref, 1e-2)
        check(ok, f"fp16 {name} attention vs the fp32 einsum path: max abs "
              f"err {err}")
        errs.append(err)
    # a head dim off the kernels: the dense ring, no launch
    odd = [torch.randn(b, 1024, 4, 96, generator=gen, device="cuda").half()
           .requires_grad_() for _ in range(3)]
    (dense, _), odd_launches = launched_by(lambda: ring_fwd_bwd(odd))
    err_odd, ok_odd = close_enough(dense, _einsum_attention(
        *(x.detach().float() for x in odd), is_causal=True), 1e-2)
    check(odd_launches == [0] * len(counted) and ok_odd,
          f"the fp16 ring at D=96 launched {odd_launches} or disagrees with "
          f"fp32: max abs err {err_odd}")
    print(f"fp16: scaled_dot_product_attention at B={b} S={s} H={h} D={d} "
          f"causal (flash kernel) max abs err {errs[0]:.3g}, "
          f"sequence_parallel_attention ring over {SP_DEGREE} slots (ring "
          f"kernels, forward + backward) max abs err {errs[1]:.3g} vs the "
          f"fp32 einsum path (tol 1e-2(1+|ref|)); kernel launches: sdpa "
          f"{sdpa_launches}, its backward {bwd_launches}, ring "
          f"{ring_launches}; the D=96 ring (dense ring) {odd_launches}, max "
          f"abs err {err_odd:.3g} [{card}]", flush=True)
    # the same call on the einsum path in fp16 and on the kernel in bf16
    # (outside the counts)
    _, mib_einsum = peak_mib(lambda: _einsum_attention(*h16, is_causal=True))
    b16 = [x.bfloat16().requires_grad_() for x in (q, k, v)]
    _, mib_bf16 = peak_mib(lambda: scaled_dot_product_attention(
        *b16, is_causal=True))
    print(f"fp16: memory above the inputs of one scaled_dot_product_attention"
          f" call at B={b} S={s} H={h} D={d} causal, with autograd: fp16 "
          f"flash kernel {mib16:.1f} MiB, fp16 einsum path {mib_einsum:.1f} "
          f"MiB, bf16 flash kernel {mib_bf16:.1f} MiB [{card}]", flush=True)
    return {"sdpa_fp16_mib": mib16, "einsum_fp16_mib": mib_einsum,
            "sdpa_bf16_mib": mib_bf16}


def traced_half_launches(torch, fn):
    """Run `fn` once under torch.profiler; the launches of the port's
    kernels instantiated for fp16 (`__half` in the symbol) in its device
    trace, by kernel."""
    from paddle_tpu_torch.utils.train_profile import KERNEL_SYMBOLS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {name: 0 for name, _ in KERNEL_SYMBOLS if name != "gemm"}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                "__half" not in e.name:
            continue
        for name, pattern in KERNEL_SYMBOLS:
            if pattern.search(e.name):
                if name in counts:
                    counts[name] += 1
                break
    return counts


def state_copy(opt, params):
    """Copies of the parameters, the optimizer's slots, step count and
    device t: what a skipped step must leave bit-unchanged."""
    return ([p.detach().clone() for p in params],
            [{k: v.clone() for k, v in opt._accumulators[id(p)].items()}
             for p in params], opt._step_count,
            None if opt._t_arr is None else opt._t_arr.clone())


def state_unchanged(torch, opt, params, saved):
    ps, slots, count, t = saved
    return (all(torch.equal(p.detach(), x) for p, x in zip(params, ps))
            and all(torch.equal(opt._accumulators[id(p)][k], v)
                    for p, sl in zip(params, slots) for k, v in sl.items())
            and opt._step_count == count
            and (t is None or torch.equal(opt._t_arr, t)))


def amp16_step(pt, net_loss, scaler, opt, inject=None):
    """One step of fp16 AMP with a GradScaler: the loss under auto_cast,
    the scaled backward, then `scaler.step`, which updates the scale itself
    once every optimizer has stepped (the reference's step(), :171-177; an
    update() after it would count the step a second time, as a good one).
    `inject(params)` may write an inf into a gradient first. Returns the
    loss."""
    with pt.amp.auto_cast(dtype="float16"):
        loss = net_loss()
    scaler.scale(loss).backward()
    if inject is not None:
        inject()
    scaler.step(opt)
    opt.clear_grad()
    return loss.detach()


def fp16_titan_phase(pt, fa, torch, np, card):
    """Path A: four titan layers, ErnieScanStack(4096, 64, 16384, 4,
    remat="dots"), at 2 x 2048 in fp16 AMP, eager, with AdamW(1e-4) and
    GradScaler() at its defaults."""
    from paddle_tpu_torch.utils import bench
    pt.set_device("gpu")
    pt.seed(SEED)
    net = pt.models.ErnieScanStack(4096, 64, 16384, 4, remat="dots")
    params = list(net.parameters())
    names = [n for n, _ in net.named_parameters()]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random((TITAN_B, TITAN_S, 4096), np.float32)
                         * 0.02).cuda()

    def net_loss():
        return (net(x) ** 2).mean()       # bench.py's titan loss

    # The step-1 check takes a random projection of the output as its
    # loss: bench.py's loss, the mean square of a layer norm's output
    # with unit gain and zero bias, is 1 up to the norm's eps, so its
    # gradients below the last norm are ~1e-5 of a rounding step and
    # compare as noise (cosine ~0.4 in fp16 as in bf16)
    w = torch.from_numpy(rng.standard_normal((TITAN_B, TITAN_S, 4096))
                         .astype(np.float32)).cuda()

    def check_loss():
        return (net(x).float() * w).mean()

    # ---- step 1 against fp32 on the card (the fp32 flash kernels) ----
    with torch.enable_grad():
        loss32 = check_loss()
        g32 = torch.autograd.grad(loss32, params)
    loss32 = loss32.item()
    scaler = pt.amp.GradScaler()

    def grads16(deterministic):
        with determinism(torch, deterministic), torch.enable_grad():
            with pt.amp.auto_cast(dtype="float16"):
                loss = check_loss()
            g = torch.autograd.grad(scaler.scale(loss), params)
        s = scaler.get_loss_scaling()
        return loss.item(), [x.float() / s for x in g]

    rows = []
    for deterministic in (False, True):    # fused backward, then two-pass
        loss16, g16 = grads16(deterministic)
        rel = abs(loss16 - loss32) / abs(loss32)
        low = sorted((cosine(a, b), n) for a, b, n in zip(g16, g32, names))
        finite = all(bool(torch.isfinite(g).all()) for g in g16)
        rows.append((rel, low[0]))
        print(f"fp16_titan: step-1 projection loss fp32 {loss32:.8f}, fp16 "
              f"AMP {loss16:.8f} (rel err {rel:.3g}, tol 1e-2); unscaled "
              f"gradients at scale {scaler.get_loss_scaling():g} "
              f"({'two-pass' if deterministic else 'fused'} backward) "
              f"finite={finite}, lowest per-parameter cosines vs fp32 "
              f"{', '.join(f'{c:.6f} ({n})' for c, n in low[:3])} (tol "
              f"0.99) [{card}]", flush=True)
        check(finite and rel <= 1e-2 and low[0][0] >= 0.99,
              f"fp16 titan step 1 vs fp32: loss rel err {rel}, lowest "
              f"cosine {low[0]}, finite {finite}")
        del g16
    del g32, w
    torch.cuda.empty_cache()

    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=params)
    # ---- the main path, its counts set to 0 just before: 10 steps, one
    # traced step, two steps with an injected inf (the first of them
    # deterministic, so the two-pass backward runs on the main path) ----
    flash = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
             fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in flash:
        c.launches = 0
    losses, scales, step_ms = [], [], []
    for i in range(10):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss = amp16_step(pt, net_loss, scaler, opt)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
        scales.append(scaler.get_loss_scaling())
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(v) for v in losses + scales),
          f"fp16 titan: non-finite loss or scale {losses} {scales}")
    # the fp16 kernels in the device trace of one more step
    traced = traced_half_launches(
        torch, lambda: amp16_step(pt, net_loss, scaler, opt))
    check(traced["flash_fwd"] == 4 and traced["flash_bwd_fused"] == 4,
          f"fp16 titan step: fp16 flash launches in the device trace "
          f"{traced}, want 4 + 4")

    # ---- an inf in one gradient: the step leaves everything as it was;
    # two such steps halve the scale (decr_every_n_nan_or_inf=2) ----
    def inject():
        params[0].grad.view(-1)[0] = float("inf")

    scale_before = scaler.get_loss_scaling()
    skipped = []
    for deterministic in (True, False):
        saved = state_copy(opt, params)
        before = [c.launches for c in flash]
        with determinism(torch, deterministic):
            amp16_step(pt, net_loss, scaler, opt, inject)
        torch.cuda.synchronize()
        if deterministic:
            det = [c.launches - n for c, n in zip(flash, before)]
        skipped.append(state_unchanged(torch, opt, params, saved))
        del saved
    check(all(skipped) and scaler.get_loss_scaling() == scale_before / 2,
          f"fp16 titan: injected infs left the state unchanged {skipped}, "
          f"scale {scale_before} -> {scaler.get_loss_scaling()}")
    launches = [c.launches for c in flash]
    n_steps = 10 + 1 + 2
    want = [4 * n_steps, 4 * (n_steps - 1), 4, 4]
    check(det == [4, 0, 4, 4] and launches == want,
          f"fp16 titan: host launches (fwd, fused, dq, dkv) {launches} in "
          f"{n_steps} steps of 4 layers (want {want}), the deterministic "
          f"step {det} (want [4, 0, 4, 4])")
    med = statistics.median(step_ms[1:])
    print(f"fp16_titan: {len(losses)} eager steps, losses "
          f"{[round(v, 5) for v in losses]}, scales {scales}; step "
          f"{med:.3f} ms median (CUDA events, steps 2-10); peak "
          f"max_memory_allocated {peak_gib:.2f} GiB; fp16 flash launches "
          f"in the device trace of one step {traced}; two injected infs: "
          f"parameters, AdamW slots, step count and device t bit-unchanged "
          f"{skipped}, scale {scale_before:g} -> "
          f"{scaler.get_loss_scaling():g}; host launches (fwd, fused, dq, "
          f"dkv) in the {n_steps} main-path steps {launches} [{card}]",
          flush=True)
    del opt, net, params, x
    torch.cuda.empty_cache()

    # the bf16 eager __call__ of the same stack, in this session
    pt.seed(SEED)
    step = bench.titan_step(pt)
    xb = torch.from_numpy(rng.random((TITAN_B, TITAN_S, 4096), np.float32)
                          * 0.02).cuda()
    step(xb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bf16_ms = []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        step(xb)
        e1.record()
        torch.cuda.synchronize()
        bf16_ms.append(e0.elapsed_time(e1))
    bf16_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"fp16_titan: beside it, the bf16 TrainStep __call__ of the same "
          f"stack: {statistics.median(bf16_ms):.3f} ms median over 5 steps, "
          f"peak max_memory_allocated {bf16_gib:.2f} GiB; fp16 eager "
          f"{med:.3f} ms, {peak_gib:.2f} GiB [{card}]", flush=True)
    del step, xb
    torch.cuda.empty_cache()
    return dict(zip(("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                     "flash_bwd_dkv"), launches))


def fp16_sp_phase(pt, tra, torch, np, card, devices):
    """Path B: ErnieForPretraining(ernie_base(use_sp=True)) at 8 x 512 over
    HybridCommunicateGroup(sp_degree=4) in fp16 AMP, eager, MLM + NSP,
    with AdamW(1e-4) and GradScaler() at its defaults."""
    pt.set_device("gpu")
    pt.seed(SEED)
    pt.parallel.HybridCommunicateGroup(
        hybrid_configs={"sp_degree": SP_DEGREE}, devices=devices)
    net = pt.models.ErnieForPretraining(
        pt.models.ernie_base(hidden_dropout_prob=0.0, use_sp=True))
    layers = net.ernie.layers
    params = list(net.parameters())
    names = [n for n, _ in net.named_parameters()]
    vocab = net.ernie.embeddings.word_embeddings.weight.shape[0]
    ce = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, vocab, (SP_B, SP_S))).cuda()
    nsp = torch.from_numpy(rng.integers(0, 2, (SP_B,))).cuda()

    def net_loss():
        # the loss on the logits cast to f32: at init the MLM loss is ~105,
        # and its mean over 4096 tokens taken in fp16 overflows (the sum
        # does), in the reference's arithmetic as in the port's
        logits, nsp_logits = net(ids)
        return ce(logits.float().reshape(-1, vocab), ids.reshape(-1)) + \
            ce(nsp_logits.float(), nsp)

    def grads_of(fp16, use_sp):
        for layer in layers:
            layer.attention.use_sp = use_sp
        try:
            with torch.enable_grad():
                if fp16:
                    # the check's scale: 2^10 keeps the scaled fp16
                    # gradients of the head inside fp16's range
                    probe = pt.amp.GradScaler(init_loss_scaling=2.0 ** 10)
                    with pt.amp.auto_cast(dtype="float16"):
                        loss = net_loss()
                    g = torch.autograd.grad(probe.scale(loss), params)
                    g = [x.float() / probe.get_loss_scaling() for x in g]
                else:
                    loss = net_loss()
                    g = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
        finally:
            for layer in layers:
                layer.attention.use_sp = True
        return loss.item(), g

    # ---- step 1: fp16 through the ring kernels vs fp32 without sp ----
    loss32, g32 = grads_of(False, False)
    loss16, g16 = grads_of(True, True)
    rel = abs(loss16 - loss32) / abs(loss32)
    low = sorted((cosine(a, b), n) for a, b, n in zip(g16, g32, names))
    finite = all(bool(torch.isfinite(g).all()) for g in g16)
    print(f"fp16_sp: step-1 loss fp32 without sp {loss32:.6f}, fp16 AMP "
          f"sp={SP_DEGREE} ring {loss16:.6f} (rel err {rel:.3g}, tol 1e-2);"
          f" unscaled gradients at scale 1024 finite={finite}, lowest "
          f"per-parameter cosines "
          f"{', '.join(f'{c:.6f} ({n})' for c, n in low[:3])} (tol 0.99) "
          f"[{card}]", flush=True)
    check(finite and rel <= 1e-2 and low[0][0] >= 0.99,
          f"fp16 sp step 1 vs fp32: loss rel err {rel}, lowest cosine "
          f"{low[0]}, finite {finite}")
    del g16, g32
    torch.cuda.empty_cache()

    # ---- the main path, its counts set to 0 just before: steps until 8
    # have been taken (a step whose gradients overflow fp16 is skipped,
    # and two in a row halve the scale) ----
    ring = ring_wrappers(tra)
    for c in ring.values():
        c.launches = c.hops = 0
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=params)
    scaler = pt.amp.GradScaler()
    losses, taken, scales, step_ms = [], [], [], []
    while opt._step_count < 8 and len(losses) < 24:
        count = opt._step_count
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss = amp16_step(pt, net_loss, scaler, opt)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
        scales.append(scaler.get_loss_scaling())
        taken.append(opt._step_count > count)
    launches = ring_counts(tra)()
    n_iter = len(losses)
    per_layer = ring_launches_per_layer(devices)
    want = {k: len(layers) * n_iter * v for k, v in per_layer.items()}
    check(launches == want, f"fp16 sp: ring kernels launched {launches} in "
          f"{n_iter} steps of {len(layers)} layers (want {want})")
    traced = traced_half_launches(
        torch, lambda: amp16_step(pt, net_loss, scaler, opt))
    want_traced = len(layers) * per_layer["ring_fwd"]
    check(all(traced[k] == want_traced for k in RING_KERNELS),
          f"fp16 sp step: fp16 ring launches in the device trace {traced}, "
          f"want {want_traced} of each")
    took = [v for v, t in zip(losses, taken) if t]
    check(all(math.isfinite(v) for v in losses) and len(took) == 8 and
          took[-1] < took[0], f"fp16 sp: the loss did not fall over 8 "
          f"taken steps: losses {losses}, taken {taken}, scales {scales}")
    med = statistics.median(t for t, k in zip(step_ms, taken) if k)
    print(f"fp16_sp: ernie_base use_sp=True, sp={SP_DEGREE} over "
          f"{devices}, fp16 AMP, {SP_B}x{SP_S}, AdamW(1e-4), GradScaler(): "
          f"{n_iter} steps, {n_iter - sum(taken)} skipped on overflow; losses "
          f"{[round(v, 4) for v in losses]}, taken {taken}, scales "
          f"{scales}; step {med:.3f} ms median over the taken steps (CUDA "
          f"events); ring launches and slot-hops (host calls) {launches}; "
          f"fp16 ring launches in the device trace of one step {traced} "
          f"[{card}]", flush=True)
    pt.parallel.set_mesh(None)
    del opt, net, params
    torch.cuda.empty_cache()
    return launches


def sp_train_phase(pt, fa, tra, torch, np, card, devices):
    """ERNIE-base pretraining with the sp=4 ring through TrainStep."""
    from paddle_tpu_torch.jit import amp_functional_call, split_state
    from paddle_tpu_torch.utils.bench import step_split_ms
    pt.set_device("gpu")
    pt.seed(SEED)
    pt.parallel.HybridCommunicateGroup(
        hybrid_configs={"sp_degree": SP_DEGREE}, devices=devices)
    net = pt.models.ErnieForPretraining(
        pt.models.ernie_base(hidden_dropout_prob=0.0, use_sp=True))
    layers = net.ernie.layers
    n_layers = len(layers)
    vocab = net.ernie.embeddings.word_embeddings.weight.shape[0]
    ce = pt.nn.CrossEntropyLoss()

    def loss_fn(logits, nsp_logits, ids, nsp):       # bench.py:203-205
        v = logits.shape[-1]
        return ce(logits.reshape(-1, v), ids.reshape(-1)) + \
            ce(nsp_logits, nsp)

    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters())
    step = pt.jit.TrainStep(net, loss_fn, opt, amp_dtype="bfloat16",
                            n_model_inputs=1)
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, vocab, (SP_B, SP_S))).cuda()
    nsp = torch.from_numpy(rng.integers(0, 2, (SP_B,))).cuda()
    trainable, frozen = split_state(net)
    pnames, ps = list(trainable), list(trainable.values())
    bnames, bufs = list(frozen), list(frozen.values())
    n_params = sum(p.numel() for p in ps)

    def grads_of(amp_dtype, use_sp):
        for layer in layers:
            layer.attention.use_sp = use_sp
        try:
            with torch.enable_grad():
                logits, nsp_logits = amp_functional_call(
                    net, pnames, ps, bnames, bufs, [ids], amp_dtype)
                loss = loss_fn(logits, nsp_logits, ids, nsp)
                grads = torch.autograd.grad(loss, ps)
            torch.cuda.synchronize()
        finally:
            for layer in layers:
                layer.attention.use_sp = True
        return float(loss.detach()), [g.float() for g in grads]

    # ---- step-1: bf16 through the ring kernels vs fp32 without sp ----
    # fp32 at S=512 without sp takes the einsum path: no kernel
    loss32, g32 = grads_of(None, False)
    loss_sp, g_sp = grads_of("bfloat16", True)
    loss_again, _ = grads_of("bfloat16", True)
    rel = abs(loss_sp - loss32) / abs(loss32)
    lowest = sorted((cosine(a, b), n) for a, b, n in zip(g_sp, g32, pnames))
    cos = lowest[0]
    print(f"sp_train: step-1 loss fp32 without sp {loss32:.6f}, bf16 sp=4 "
          f"ring {loss_sp:.6f}; rel err {rel:.3g} (tol 2e-2); lowest "
          f"per-parameter grad cosines "
          f"{', '.join(f'{c:.6f} ({n})' for c, n in lowest[:3])} (tol 0.99);"
          f" computed again {loss_again!r} vs {loss_sp!r} (bit-equal) "
          f"[{card}]", flush=True)
    # no atomics anywhere on the ring: the step is bitwise reproducible
    check(loss_again == loss_sp, f"the sp step-1 loss is not reproducible: "
          f"{loss_sp!r} then {loss_again!r}")
    # bf16 weights, activations, logits and loss through 12 post-LN layers
    check(rel <= 2e-2, f"sp bf16 vs fp32 step-1 loss rel err {rel}")
    check(cos[0] >= 0.99, f"sp bf16 vs fp32 gradient cosine {cos}")
    del g_sp
    # diagnostics, no check: the ring alone (fp32 through the ring
    # kernels) and bf16 alone (bf16 without sp, the einsum attention), each
    # vs fp32 without sp, say which of the two moves the lowest cosines
    for name, amp_dtype, use_sp in (("fp32 sp=4 ring", None, True),
                                    ("bf16 without sp", "bfloat16", False)):
        loss_x, g_x = grads_of(amp_dtype, use_sp)
        low = sorted((cosine(a, b), n) for a, b, n in zip(g_x, g32, pnames))
        print(f"sp_train: step-1 {name}: loss {loss_x:.6f}; lowest "
              f"per-parameter grad cosines vs fp32 without sp "
              f"{', '.join(f'{c:.6f} ({n})' for c, n in low[:3])} [{card}]",
              flush=True)
        del g_x
    del g32
    torch.cuda.empty_cache()

    # ---- the main path: TrainStep through its entry points ----
    ring = tuple(ring_wrappers(tra).values())
    flash = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
             fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in ring + flash:
        c.launches = 0
    for c in ring:
        c.hops = 0
    t_start = time.perf_counter()
    losses = [step(ids, ids, nsp)]                   # warm-up step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t_calls = time.perf_counter()
    events[0].record()
    for i in range(5):
        losses.append(step(ids, ids, nsp))
        events[i + 1].record()
    torch.cuda.synchronize()
    calls_s = time.perf_counter() - t_calls
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(5)]
    sids, snsp = ids.expand(SP_RUN, SP_B, SP_S), \
        nsp.expand(SP_RUN, SP_B)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    span = step.run(sids, sids, snsp)
    e1.record()
    torch.cuda.synchronize()
    run_ms = e0.elapsed_time(e1) / SP_RUN
    losses.extend(span.unbind(0))
    launches = ring_counts(tra)()
    flash_launches = [c.launches for c in flash]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = 1 + 5 + SP_RUN
    # host calls: on one card run()'s span is its first step and one
    # capture; across cards run() is the loop of its steps
    n_host = 1 + 5 + (2 if len(set(devices)) == 1 else SP_RUN)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall over {n_steps} "
          f"steps on the repeated batch: {losses}")
    want = {k: n_layers * n_host * v
            for k, v in ring_launches_per_layer(devices).items()}
    check(launches == want, f"ring kernels launched {launches} in {n_host} "
          f"host-driven steps of {n_layers} layers (want {want})")
    check(flash_launches == [0] * 4,
          f"the flash kernels launched {flash_launches} on the sp path")

    # ---- where one step's device time goes (outside the counted run) ----
    split = step_split_ms(step, ids, ids, nsp)
    med_ms = statistics.median(step_ms)
    tokens = SP_B * SP_S
    # 6 FLOPs per product parameter per token (the word embeddings counted
    # once, as the tied head; the position and token-type lookups not) plus
    # the ring's non-causal products: 2 forward, 3 dq, 4 dk/dv per pair
    emb = net.ernie.embeddings
    lookups = emb.position_embeddings.weight.numel() + \
        emb.token_type_embeddings.weight.numel()
    att = layers[0].attention
    step_flops = 6 * (n_params - lookups) * tokens + n_layers * 2 * (
        PRODUCTS["ring_fwd"] + PRODUCTS["ring_dq_step"] +
        PRODUCTS["ring_dkv"]) \
        * att.head_dim * SP_S * SP_S * SP_B * att.num_heads
    where = "four cards" if len(set(devices)) > 1 else \
        f"{SP_DEGREE} slots of one card"
    print(f"sp_train: ernie_base use_sp=True, sp={SP_DEGREE} over {where} "
          f"({devices}), bf16 AMP, {SP_B}x{SP_S} tokens, {n_params} "
          f"parameters, AdamW(1e-4), MLM + NSP loss: losses "
          f"{[round(x, 4) for x in losses]} [{card}]", flush=True)
    print(f"sp_train: step time median {med_ms:.3f} ms over 5 __call__ "
          f"steps (CUDA events; {[round(x, 3) for x in step_ms]}), run() "
          f"{run_ms:.3f} ms per step over {SP_RUN}; tokens/s "
          f"{tokens / med_ms * 1e3:.1f}; warm-up step {warm_s * 1e3:.1f} ms "
          f"host; 5 calls {calls_s * 1e3:.1f} ms host; step bound "
          f"{step_flops / PEAK_BF16 * 1e3:.3f} ms ({step_flops / 1e12:.3f} "
          f"TFLOP at 989 TFLOP/s), model FLOP utilisation "
          f"{step_flops / (med_ms * 1e-3) / PEAK_BF16:.3f} [{card}]",
          flush=True)
    print(f"sp_train: one step's device time: forward "
          f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, "
          f"optimizer {split['optimizer']:.3f} ms (CUDA events, median of "
          f"3); peak max_memory_allocated {peak_gib:.2f} GiB [{card}]",
          flush=True)
    per_step = {k: v // n_host for k, v in launches.items()}
    print(f"sp_train: ring launches and slot-hops (host calls) in "
          f"{n_host} host-driven steps of {n_steps}: "
          f"{launches}; per step {per_step} ({n_layers} layers), ring "
          f"kernel launches per step "
          f"{sum(per_step[k] for k in RING_KERNELS)};"
          f" flash kernels {flash_launches} [{card}]", flush=True)
    pt.parallel.set_mesh(None)
    del step, opt, net
    torch.cuda.empty_cache()
    return launches


def flagship_phase(pt, torch, card):
    """The flagship as bench.py trains it, through run(): ERNIE-base
    without sp at 32 x 128 (utils/bench.py's ernie_train, shorter spans)."""
    from paddle_tpu_torch.utils import bench
    pt.set_device("gpu")
    r = bench.ernie_train(n_steps=FLAGSHIP_RUN, reps=3, prefetch_steps=10)
    losses = r["losses_first_span"]
    check(all(math.isfinite(x) for x in losses + [r["loss_last"]]),
          f"flagship: non-finite loss {losses} {r['loss_last']}")
    check(r["loss_last"] < r["loss_first"], f"flagship: the loss did not "
          f"fall: {losses} ... {r['loss_last']}")
    # the formula counts the position and token-type lookups and the
    # pooler / NSP products at every token; at 128 tokens that is ~1%
    ratio = r["flops_per_step_attributed"] / r["flops_per_step_formula"]
    check(0.9 <= ratio <= 1.1, f"flagship: cost_analysis flops "
          f"{r['flops_per_step_attributed']} vs the formula "
          f"{r['flops_per_step_formula']}")
    mem, split = r["memory"], r["split_ms"]
    print(f"flagship: ernie_base without sp, bf16 AMP, {r['batch']}x"
          f"{r['seqlen']}, AdamW(1e-4), MLM + NSP, run() spans of "
          f"{r['n_steps']} steps x {r['reps']}: samples/s "
          f"{r['samples_per_sec']:.1f} (spread {r['spread']:.3f}), step "
          f"{r['step_ms']:.3f} ms, MFU {r['mfu']:.4f} (bench.py's formula, "
          f"{r['flops_per_step_formula'] / 1e12:.4f} TFLOP per step) / "
          f"{r['mfu_attributed']:.4f} (cost_analysis, "
          f"{r['flops_per_step_attributed'] / 1e12:.4f} TFLOP, ratio "
          f"{ratio:.4f}); first span {r['first_span_s']:.2f} s (capture "
          f"in it); losses {[round(x, 4) for x in losses]} ... "
          f"{r['loss_last']:.4f} [{card}]", flush=True)
    print(f"flagship: one step's device time: forward "
          f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, "
          f"optimizer {split['optimizer']:.3f} ms (CUDA events, eager); "
          f"memory_report {mem}; per-step path samples/s prefetch off "
          f"{r['overlap']['prefetch_off']['samples_per_sec']:.1f}, on "
          f"{r['overlap']['prefetch_on']['samples_per_sec']:.1f} (speedup "
          f"{r['overlap']['speedup']:.3f}) [{card}]", flush=True)
    torch.cuda.empty_cache()
    return r


def titan_phase(pt, fa, torch, card):
    """Four titan layers through run(): ErnieScanStack(4096, 64, 16384, 4,
    remat="dots") at 2 x 2048 (utils/bench.py's ernie10b_layer)."""
    from paddle_tpu_torch.utils import bench
    pt.set_device("gpu")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused)
    for c in counters:
        c.launches = 0
    r = bench.ernie10b_layer(n_steps=TITAN_RUN, reps=3)
    launches = [c.launches for c in counters]
    losses = r["losses_first_span"]
    check(all(math.isfinite(x) for x in losses + [r["loss_last"]]),
          f"titan: non-finite loss {losses} {r['loss_last']}")
    check(r["loss_last"] < r["loss_first"], f"titan: the loss did not fall:"
          f" {losses} ... {r['loss_last']}")
    # host calls: one capture of the 4-layer step and its eager first step
    check(launches[0] > 0 and launches[1] > 0,
          f"titan: flash kernels launched {launches}")
    mem = r["memory"]
    print(f"titan: {r['layers']} layers {r['geometry']} batch {r['batch']},"
          f" remat={r['remat']}, bf16 AMP, AdamW(1e-4), run() spans of "
          f"{r['n_steps']} x {r['reps']}: layer_step_ms_per_sample "
          f"{r['layer_step_ms_per_sample']:.3f}, step {r['step_ms']:.3f} ms "
          f"(spread {r['spread']:.3f}), MFU {r['mfu']:.4f}; first span "
          f"{r['first_span_s']:.2f} s; losses "
          f"{[round(x, 5) for x in losses]} ... {r['loss_last']:.5f}; "
          f"peak max_memory_allocated "
          f"{mem['max_memory_allocated'] / 2 ** 30:.2f} GiB, reserved "
          f"{mem['max_memory_reserved'] / 2 ** 30:.2f} GiB (the graph's "
          f"pool); memory_report "
          f"{mem}; flash launches (host calls) fwd, fused {launches} "
          f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    return dict(r, launches=launches)


@contextlib.contextmanager
def determinism(torch, on):
    """torch.use_deterministic_algorithms for the block when `on`: the
    flash backward then takes the two-pass kernels, without atomics."""
    if not on:
        yield
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def kept_graphs(torch):
    """torch.cuda.CUDAGraph made with keep_graph=True for the block (so a
    captured graph's nodes can be read): yields the class."""
    real = torch.cuda.CUDAGraph

    class Kept(real):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    torch.cuda.CUDAGraph = Kept
    try:
        yield Kept
    finally:
        torch.cuda.CUDAGraph = real


def graph_run_vs_loop(pt, torch, name, step, batch, n, card, want=None,
                      deterministic=False):
    """From one saved state, run() over n distinct steps (every step one
    graph replay) against the eager loop of __call__ over the same steps:
    per-step losses, bit-equality and the lowest parameter cosine after
    the span. With `deterministic` both run under
    torch.use_deterministic_algorithms: the fused flash backward sums dq
    with atomics, so two runs of it differ by rounding, which bf16 losses
    and Adam's steps on zero-gradient parameters make visible. Then, in
    the default form, the per-step times of run() and of the loop (host
    clock) and the port's kernels in the device trace of one replayed
    span, against `want` per step."""
    from paddle_tpu_torch.utils.train_profile import (graph_kernel_names,
                                                      kernel_counts,
                                                      kernel_launches)
    saved = step.state_dict()
    with determinism(torch, deterministic):
        step.run(*batch)                   # capture (its first step eager)
        step.set_state_dict(saved)
        graph = step.run(*batch)
        graph_params = [p.detach().clone() for p in step._ptensors]
        step.set_state_dict(saved)
        loop = torch.stack([step(*[x[i] for x in batch]) for i in range(n)])
    g, lo = graph.float(), loop.float()
    rel = ((g - lo).abs() / lo.abs()).max().item()
    bit = torch.equal(graph, loop)
    low = min((cosine(a.float(), b.float()), pname) for a, b, pname in
              zip(graph_params, step._ptensors, step._pnames))
    del graph_params
    # the default form: capture anew (keeping the graph to read its
    # kernel nodes), then time a replayed span and the loop
    step._graphs.clear()
    with kept_graphs(torch) as kept:
        step.run(*batch)
    caps = [c for c in step._graphs.values() if isinstance(c.graph, kept)]
    check(len(caps) == 1, f"graph {name}: {len(caps)} kept captures")
    names = graph_kernel_names(caps[0].graph)
    per_step = kernel_counts(names)
    ours = sorted({n.split("(")[0] for n in names
                   if "flash" in n or "ring" in n})
    del caps
    step.set_state_dict(saved)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.run(*batch)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / n
    step.set_state_dict(saved)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(*[x[i] for x in batch])
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / n
    step.set_state_dict(saved)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step.run(*batch)
        torch.cuda.synchronize()
    counts = kernel_launches(prof)
    del prof
    form = "deterministic backward" if deterministic else "default form"
    print(f"graph: {name}: run() of {n} distinct steps (one graph replay "
          f"each) vs the eager loop of __call__ from one saved state "
          f"({form}): max rel loss diff {rel:.3g} (tol 1e-4), bit-equal "
          f"{bit}, lowest parameter cosine {low[0]:.8f} ({low[1]}, tol "
          f"0.9999); default form per step {graph_ms:.3f} ms run() vs "
          f"{loop_ms:.3f} ms loop (host clock); kernel nodes of the "
          f"captured step (each replay runs every node): {per_step}; "
          f"device trace of one replayed span of {n}: {counts} [{card}]",
          flush=True)
    check(rel <= 1e-4, f"graph {name}: run() vs loop losses {graph} {loop}")
    check(low[0] >= 0.9999, f"graph {name}: parameter cosine {low}")
    for kname, want_step in (want or {}).items():
        check(per_step[kname] == want_step, f"graph {name}: the captured "
              f"step holds {per_step[kname]} {kname} kernel nodes (want "
              f"{want_step}); its attention kernels: {ours}")
    for kname, c in counts.items():
        check(c <= per_step[kname] * n, f"graph {name}: the trace of a "
              f"replayed span of {n} shows {c} {kname} launches, more than "
              f"the graph's {per_step[kname]} per replay")
    return {"rel": rel, "bit_equal": bit, "cosine": low[0],
            "graph_ms": graph_ms, "loop_ms": loop_ms, "counts": counts,
            "per_step": per_step}


def graph_phase(pt, torch, np, card):
    """run() as one CUDA-graph replay per step, for the four trains (built
    as train_profile and utils/bench.py build them)."""
    from paddle_tpu_torch.utils import bench, train_profile
    pt.set_device("gpu")
    n = GRAPH_RUN
    rng = np.random.default_rng(SEED + 11)
    out = {}

    def ids(vocab, *shape):
        return torch.from_numpy(rng.integers(0, vocab, (n, *shape))).cuda()

    def vocab_of(emb):
        return emb.word_embeddings.weight.shape[0]

    # GPT-2 small, 12 layers, 8 x 1024
    pt.seed(SEED)
    step, _ = train_profile.MODELS["gpt2"](pt, rng)
    x = ids(vocab_of(step.model.gpt.embeddings), TRAIN_B, TRAIN_S)
    per_layer = len(step.model.gpt.layers)
    out["gpt2"] = graph_run_vs_loop(pt, torch, "gpt2_small", step, (x, x),
                                    n, card, {"flash_fwd": per_layer,
                                              "flash_bwd_fused": per_layer},
                                    deterministic=True)
    del step, x
    torch.cuda.empty_cache()

    # the flagship, 32 x 128: attention on the einsum path
    pt.seed(SEED)
    step = bench.flagship_step(pt)
    x = ids(vocab_of(step.model.ernie.embeddings), FLAGSHIP_B, FLAGSHIP_S)
    nsp = ids(2, FLAGSHIP_B)
    out["flagship"] = graph_run_vs_loop(
        pt, torch, "flagship", step, (x, x, nsp), n, card,
        {"flash_fwd": 0, "flash_bwd_fused": 0})
    del step, x, nsp
    torch.cuda.empty_cache()

    # four titan layers, 2 x 2048, remat="dots": one flash forward and one
    # fused backward per layer and step, none recomputed
    pt.seed(SEED)
    step = bench.titan_step(pt)
    x = torch.from_numpy(rng.random(
        (n, TITAN_B, TITAN_S, step.model.hidden_size), np.float32) *
        0.02).cuda()
    out["titan"] = graph_run_vs_loop(pt, torch, "titan dots", step, (x,), n,
                                     card, {"flash_fwd": 4,
                                            "flash_bwd_fused": 4},
                                     deterministic=True)
    del step
    torch.cuda.empty_cache()
    # remat=True recomputes each layer's forward: 8 forwards per step
    pt.seed(SEED)
    step = bench.titan_step(pt, remat=True)
    out["titan_remat"] = graph_run_vs_loop(
        pt, torch, "titan remat=True", step, (x[:2],), 2, card,
        {"flash_fwd": 8, "flash_bwd_fused": 4}, deterministic=True)
    gemms = (out["titan"]["per_step"]["gemm"],
             out["titan_remat"]["per_step"]["gemm"])
    print(f"graph: titan GEMM launches per step, dots {gemms[0]:.0f} vs "
          f"remat=True {gemms[1]:.0f} (the recompute's products) [{card}]",
          flush=True)
    check(gemms[0] < gemms[1], f"titan dots recomputes products: {gemms}")
    del step, x
    torch.cuda.empty_cache()

    # ERNIE-base over the sp=4 ring, 8 x 512, on the smoke's ring devices
    pt.seed(SEED)
    step, _ = train_profile.MODELS["ernie_sp"](pt, rng, sp=SP_DEGREE)
    devices = list(pt.parallel.get_mesh().devices.reshape(-1))
    x = ids(vocab_of(step.model.ernie.embeddings), SP_B, SP_S)
    nsp = ids(2, SP_B)
    per_layer = ring_launches_per_layer(devices)
    layers = len(step.model.ernie.layers)
    want = {k: layers * per_layer[k] for k in RING_KERNELS} \
        if len(set(devices)) == 1 else None
    out["sp"] = graph_run_vs_loop(pt, torch, "ernie_base sp=4", step,
                                  (x, x, nsp), n, card, want)
    pt.parallel.set_mesh(None)
    del step, x, nsp
    torch.cuda.empty_cache()
    return out


def llm_bound(eng, n_tokens, vocab):
    """(ms, "bytes" | "operations") of one decode step of the whole pool:
    the model's parameters and buffers, the pool and the [S, V] f32 logits
    moved once over 3.35 TB/s, against its products (2 x the matmul
    weights per token row, plus q k^T and p v over every page) over the
    fp32 peak: the products run in fp32 in both arms."""
    lm = eng.lm
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*lm.parameters(), *lm.buffers())) + \
        eng.kv_pool_bytes() + eng.config.num_slots * vocab * 4
    mat = sum(t.numel() for t in (*lm.parameters(), *lm.buffers())
              if t.dim() == 2)
    pos_table = lm.gpt.embeddings.position_embeddings.weight.numel()
    flops = 2 * (mat - pos_table) * n_tokens + \
        2 * 2 * n_tokens * eng._page_len * eng._heads * eng._head_dim * \
        eng._n_layers
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def llm_probe(torch, np, eng, prompt, reps=20):
    """On an idle engine: prefill `prompt` into slot 0, then one decode
    step of the pool by a graph replay and, from the same pool state, by
    the eager step. Returns the replay's and the eager step's (next
    tokens, logits), the largest difference of the pools the two left, the
    replay's device ms (CUDA events over `reps` replays) and the host ms of an
    eager step and of a replay (median, each with its copies in and its
    read-back of the next tokens, as the scheduler runs it)."""
    s = eng.config.num_slots
    toks, pos = np.zeros(s, np.int32), np.zeros(s, np.int32)
    first, _ = eng._prefill_slot(np.asarray(prompt, np.int32), 0)
    toks[0], pos[0] = first, len(prompt)
    state = [*eng._pool, *eng._scales]
    saved = [t.clone() for t in state]
    graph = [x.clone() for x in eng._decode_step(toks, pos)]
    after_graph = [t.clone() for t in state]
    for t, v in zip(state, saved):
        t.copy_(v)
    eager = eng._decode_step(toks, pos, replay=False)
    pool_err = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(after_graph, state))
    del saved, after_graph

    def host_ms(replay):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            eng._decode_step(toks, pos, replay)[0].cpu()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times[2:])

    host = {"eager": host_ms(False), "replay": host_ms(True)}
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        eng._graph.replay()
    e1.record()
    e1.synchronize()
    return {"first": first, "graph": graph, "eager": eager,
            "pool_err": pool_err, "device_ms": e0.elapsed_time(e1) / reps,
            "host_ms": host}


def llm_phase(pt, fa, tra, torch, np, card):
    """gpt2_small at full width and depth, fp32 weights from a seed, served
    through LLMEngine: 32 requests of 16-896 prompt tokens and 64 new
    tokens from 4 threads, in the fp32 arm and in the int8 arm (weight-only
    int8 + int8 KV). Each decode step must be one replay of the one graph
    captured at warm-up, no attention kernel may launch (the path is
    masked einsums, as in the reference), and the fp32 arm's tokens and
    logits must agree with the full forward of the same model."""
    from paddle_tpu_torch.utils.bench import serve_llm
    pt.set_device("gpu")
    pt.seed(SEED)
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    model.eval()
    model8 = copy.deepcopy(model)            # quantized in place by its arm
    gpt = model.gpt
    attn = gpt.layers[0].attention
    n_layers = len(gpt.layers)
    vocab = gpt.embeddings.word_embeddings.weight.shape[0]
    rng = np.random.default_rng(SEED)
    lens = rng.integers(LLM_PROMPTS[0], LLM_PROMPTS[1] + 1,
                        size=LLM_REQUESTS)
    prompts = [rng.integers(0, vocab, size=int(n)).tolist() for n in lens]
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
               *ring_wrappers(tra).values())
    before = [c.launches for c in counted]
    arms = {}
    t_phase = time.perf_counter()
    for arm, lm in (("fp32", model), ("int8", model8)):
        int8 = arm == "int8"
        cfg = pt.serving.LLMConfig(
            num_slots=LLM_SLOTS, max_len=LLM_MAX_LEN, max_new_tokens=LLM_NEW,
            quant="int8" if int8 else "off", kv_int8=int8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng, results, m = serve_llm(lm, cfg, prompts, clients=LLM_CLIENTS)
        try:
            m["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
            for i, (status, toks) in enumerate(results):
                check(status == "done" and len(toks) == LLM_NEW,
                      f"llm {arm}: request {i} ended {status} with "
                      f"{len(toks)} tokens")
            m["tokens"] = [t for _, t in results]
            page = LLM_MAX_LEN + cfg.decode_block
            want = 2 * n_layers * LLM_SLOTS * page * attn.num_heads * \
                attn.head_dim * (1 if int8 else 4) + \
                (2 * n_layers * LLM_SLOTS * 4 if int8 else 0)
            check(m["kv_pool_bytes"] == want, f"llm {arm}: kv_pool_bytes "
                  f"{m['kv_pool_bytes']} against the formula's {want}")
            probe = llm_probe(torch, np, eng, prompts[0])
            check(eng.stats()["counters"]["graph_captures"] == 1 and
                  m["steady_state_captures"] == 0,
                  f"llm {arm}: {eng.stats()['counters']['graph_captures']} "
                  f"captures, {m['steady_state_captures']} after warm-up")
            (g_tok, g_lg), (e_tok, e_lg) = probe["graph"], probe["eager"]
            g_err = float((g_lg - e_lg).abs().max())
            tol = LLM_TOL * (1 + float(e_lg.abs().max()))
            check(torch.equal(g_tok, e_tok) and g_err <= tol and
                  probe["pool_err"] <= tol,
                  f"llm {arm}: a replay against the eager step: tokens "
                  f"equal {torch.equal(g_tok, e_tok)}, logits max abs err "
                  f"{g_err}, pools max abs err {probe['pool_err']} (tol "
                  f"{tol})")
            m.update(probe_device_ms=probe["device_ms"],
                     probe_host_ms=probe["host_ms"], graph_vs_eager=g_err,
                     graph_vs_eager_bit_equal=bool(torch.equal(g_lg, e_lg)),
                     pool_err=probe["pool_err"])
            m["bound_ms"], m["bound_by"] = llm_bound(
                eng, LLM_SLOTS * cfg.decode_block, vocab)
            if not int8:
                m.update(llm_full_checks(torch, model, prompts, results,
                                         probe, e_lg))
        finally:
            eng.stop()
        arms[arm] = m
        del eng, results
        torch.cuda.empty_cache()
    after = [c.launches for c in counted]
    check(after == before, f"llm: attention kernels launched: {before} -> "
          f"{after}")
    f32, i8 = arms["fp32"], arms["int8"]
    check(i8["kv_pool_bytes"] < f32["kv_pool_bytes"] / 2,
          f"llm: int8 pool {i8['kv_pool_bytes']} not under half the fp32 "
          f"{f32['kv_pool_bytes']}")
    first_agree = sum(a[0] == b[0] for a, b in zip(i8["tokens"],
                                                   f32["tokens"]))
    pos_agree = sum(x == y for a, b in zip(i8["tokens"], f32["tokens"])
                    for x, y in zip(a, b))
    for arm, m in arms.items():
        print(f"llm: {arm} gpt2_small ({n_layers} x "
              f"{attn.num_heads * attn.head_dim}, vocab {vocab}) through "
              f"LLMEngine, {LLM_SLOTS} slots x page "
              f"{LLM_MAX_LEN + 2}, {LLM_REQUESTS} requests of "
              f"{LLM_PROMPTS[0]}-{LLM_PROMPTS[1]} prompt tokens + {LLM_NEW} "
              f"new from {LLM_CLIENTS} threads: {m['wall_s']:.3f} s, decode "
              f"tokens/s {m['decode_tokens_per_s']:.1f}, prefill tokens/s "
              f"{m['prefill_tokens_per_s']:.1f}, TTFT ms p50 "
              f"{m['ttft_ms']['p50']:.2f} p99 {m['ttft_ms']['p99']:.2f}, "
              f"inter-token ms p50 {m['inter_token_ms']['p50']:.3f} p99 "
              f"{m['inter_token_ms']['p99']:.3f}, {m['decode_steps']} decode "
              f"steps, captures {m['graph_captures']} (after warm-up "
              f"{m['steady_state_captures']}), warm start "
              f"{m['warm_start_ms']:.1f} ms, kv pool {m['kv_pool_bytes']} B, "
              f"peak {m['peak_mib']:.0f} MiB [{card}]", flush=True)
        print(f"llm: {arm} one decode step of {LLM_SLOTS} slots: device "
              f"{m['probe_device_ms']:.4f} ms per replay (CUDA events) "
              f"against a bound of {m['bound_ms']:.4f} ms "
              f"({m['bound_by']}); host ms with copies in and read-back: "
              f"eager {m['probe_host_ms']['eager']:.3f}, replay "
              f"{m['probe_host_ms']['replay']:.3f}; replay vs eager logits "
              f"max abs err {m['graph_vs_eager']:.3g} (bit-equal "
              f"{m['graph_vs_eager_bit_equal']}), pools "
              f"{m['pool_err']:.3g} [{card}]", flush=True)
    print(f"llm: full-forward checks (fp32): requests 0-2 "
          f"{f32['argmax_equal']} of {3 * LLM_NEW} tokens the full "
          f"forward's argmax, {f32['ties']} near-ties within "
          f"{LLM_TOL}(1+|ref|); one decode step's logits vs the full "
          f"forward's last position max abs err {f32['decode_vs_full']:.3g} "
          f"(tol {LLM_TOL}(1+|ref|)) [{card}]", flush=True)
    print(f"llm: int8 arm (weight-only int8 + int8 KV) decode speedup "
          f"{i8['decode_tokens_per_s'] / f32['decode_tokens_per_s']:.3f}, "
          f"first tokens equal to fp32's {first_agree} of {LLM_REQUESTS}, "
          f"tokens equal position by position {pos_agree} of "
          f"{LLM_REQUESTS * LLM_NEW} (reported, not gated); pool "
          f"{i8['kv_pool_bytes']} / {f32['kv_pool_bytes']} B; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return arms


def llm_full_checks(torch, model, prompts, results, probe, decode_logits):
    """The fp32 arm against the full forward of the same model: requests
    0-2 token by token (each generated token is the full forward's argmax
    over the prompt and the tokens before it, so a full-recompute greedy
    decode gives the same tokens, up to logits tied within the tolerance),
    and the probe's decode step against the last position."""
    equal = ties = 0
    dev = next(model.parameters()).device
    with torch.no_grad():
        for i in range(3):
            seq = prompts[i] + results[i][1]
            full = model(torch.tensor([seq[:-1]], device=dev))[0]
            pred = full[len(prompts[i]) - 1:]
            for j, tok in enumerate(results[i][1]):
                am = int(pred[j].argmax())
                if am == tok:
                    equal += 1
                    continue
                top = float(pred[j, am])
                check(top - float(pred[j, tok]) <= LLM_TOL * (1 + abs(top)),
                      f"llm fp32: request {i} token {j}: {tok}, the full "
                      f"forward's argmax {am} ({top} vs "
                      f"{float(pred[j, tok])})")
                ties += 1
        ref = model(torch.tensor([prompts[0] + [probe["first"]]],
                                 device=dev))[0, -1]
    got = decode_logits[0]
    err = float((got - ref).abs().max())
    check(bool(((got - ref).abs() <= LLM_TOL * (1 + ref.abs())).all()),
          f"llm fp32: decode step logits vs the full forward: max abs err "
          f"{err}")
    return {"argmax_equal": equal, "ties": ties, "decode_vs_full": err}


# the dygraph phase's steps: at gpt2_small's initial loss (~116: its
# N(0, 1) embeddings, tied to the head, give logits of std ~28) AdamW(1e-4)
# on the repeated batch lifts the loss again at steps 4-6 before it falls
# (on an H100: 116.2, 115.9, 107.4, 116.9, 117.0, 117.0, 111.9, ..., 98.1
# at step 10), so the run goes past that before "the loss fell" is read
DYGRAPH_STEPS = 12


def dygraph_loop(pt, torch, model, ids, vocab, wrapped, n=DYGRAPH_STEPS):
    """n steps of the paddle user's dygraph loop (forward under
    auto_cast bf16, the loss in f32, backward, AdamW step, clear_grad)
    from the model's current state, on `Tensor` ids (wrapped) or on plain
    torch ids: the losses (device) and each step's host ms (synced)."""
    F = pt.nn.functional
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        with pt.amp.auto_cast(dtype="bfloat16"):
            logits = model(ids)
        if wrapped:
            loss = F.cross_entropy(
                logits[:, :-1].reshape([-1, vocab]).astype("float32"),
                ids[:, 1:].reshape([-1])).mean()
        else:
            loss = F.cross_entropy(
                logits[:, :-1].reshape(-1, vocab).float(),
                ids[:, 1:].reshape(-1)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.detach())
        del logits, loss
    return torch.stack([torch.as_tensor(v).float() for v in losses]), ms


def dygraph_phase(pt, fa, torch, np, card):
    """GPT-2 small at full width and depth, 8 x 1024, trained by the paddle
    user's dygraph loop on `Tensor`s (to_tensor, Tensor methods,
    backward(), step(), clear_grad()) under auto_cast(bf16): attention
    reaches the flash kernels (S >= 1024 in bf16), 12 + 12 launches per
    step. Then the same loop on plain torch ids (ms per step: the Tensor
    layer's host cost), and both from one saved state under
    torch.use_deterministic_algorithms (the same kernels without the fused
    backward's dq atomics) for the parity check."""
    pt.set_device("gpu")
    pt.seed(SEED)
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    n_layers = len(model.gpt.layers)
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ids_np = np.random.default_rng(SEED).integers(0, vocab,
                                                   (TRAIN_B, TRAIN_S))
    ids = pt.to_tensor(ids_np)
    check(isinstance(ids, pt.Tensor) and ids.place == pt.CUDAPlace(0)
          and ids.dtype == pt.int32,
          f"dygraph: ids {type(ids)} {ids.place} {ids.dtype}")
    with pt.amp.auto_cast(dtype="bfloat16"):
        logits = model(ids)
    loss = pt.nn.functional.cross_entropy(
        logits[:, :-1].reshape([-1, vocab]).astype("float32"),
        ids[:, 1:].reshape([-1])).mean()
    check(isinstance(logits, pt.Tensor) and isinstance(loss, pt.Tensor),
          f"dygraph: logits {type(logits)}, loss {type(loss)}")
    check(logits.shape == [TRAIN_B, TRAIN_S, vocab] and
          math.isfinite(loss.item()),
          f"dygraph: logits {logits.shape}, loss {loss.item()}")
    del logits, loss

    # ---- the main path: counts set to 0 just before, read just after ----
    counters = {"flash_fwd": fa.flash_attention_fwd,
                "flash_bwd_fused": fa.flash_attention_bwd_fused,
                "flash_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_bwd_dkv": fa.flash_attention_bwd_dkv}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    tensor_losses, tensor_ms = dygraph_loop(pt, torch, model, ids, vocab,
                                            True)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches["flash_fwd"] == n_layers * DYGRAPH_STEPS and
          launches["flash_bwd_fused"] == n_layers * DYGRAPH_STEPS and
          launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          f"dygraph: launches {launches} (want {n_layers} forward and "
          f"{n_layers} fused backward per step)")
    lo = tensor_losses.tolist()
    check(all(math.isfinite(v) for v in lo) and lo[-1] < lo[0],
          f"dygraph: losses {lo} do not fall")

    # ---- the same loop on plain torch ids: the Tensor layer's host cost,
    # in turns (Tensor, plain, plain, Tensor) from the saved state; each
    # loop's first step is its warm-up ----
    plain_ids = torch.from_numpy(ids_np).to(ids.device)
    timed = {True: [tensor_ms[1:]], False: []}
    for wrapped in (False, False, True):
        model.load_state_dict(saved)
        losses, ms = dygraph_loop(pt, torch, model,
                                  ids if wrapped else plain_ids, vocab,
                                  wrapped)
        timed[wrapped].append(ms[1:])
        if not wrapped:
            plain_losses = losses
    default_rel = ((tensor_losses - plain_losses).abs() /
                   plain_losses.abs()).max().item()

    # ---- parity: both loops from one state, deterministic backward ----
    finals, det = [], []
    for wrapped, x in ((True, ids), (False, plain_ids)):
        model.load_state_dict(saved)
        with determinism(torch, True):
            losses, _ = dygraph_loop(pt, torch, model, x, vocab, wrapped)
        det.append(losses)
        finals.append([p.detach().float().clone()
                       for p in model.parameters()])
    rel = ((det[0] - det[1]).abs() / det[1].abs()).max().item()
    names = [n for n, _ in model.named_parameters()]
    low = min((cosine(a, b), n) for a, b, n in zip(*finals, names))
    bit = torch.equal(det[0], det[1])
    del finals, saved
    t_ms = statistics.median([v for ms in timed[True] for v in ms])
    p_ms = statistics.median([v for ms in timed[False] for v in ms])
    print(f"dygraph: GPT-2 small 8 x {TRAIN_S}, {DYGRAPH_STEPS} steps of "
          f"to_tensor / auto_cast(bf16) / backward() / AdamW step() / "
          f"clear_grad() on Tensor ids (int32, {ids.place}): losses "
          f"{[round(v, 4) for v in lo]}; launches {launches} "
          f"({n_layers} + {n_layers} per step); ms per step, median over "
          f"two loops of each in turns, each after its warm-up step (host "
          f"clock, synced): Tensor loop {t_ms:.3f} vs plain torch loop "
          f"{p_ms:.3f}, Tensor layer {t_ms - p_ms:+.3f} ms per step "
          f"(Tensor {[[round(v, 2) for v in ms] for ms in timed[True]]}, "
          f"plain {[[round(v, 2) for v in ms] for ms in timed[False]]}); "
          f"default form max rel loss diff "
          f"{default_rel:.3g}; deterministic backward: max rel loss diff "
          f"{rel:.3g} (tol 1e-4), bit-equal {bit}, lowest parameter cosine "
          f"{low[0]:.8f} ({low[1]}, tol 0.9999); peak memory {peak:.2f} GiB "
          f"[{card}]", flush=True)
    check(rel <= 1e-4, f"dygraph: Tensor vs plain losses {det}")
    check(low[0] >= 0.9999, f"dygraph: parameter cosine {low}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "tensor_ms": t_ms, "plain_ms": p_ms}


# ---- the op phase: every op family on the card against the CPU ----------
OP_TOL = {"creation": 0.0, "math": 1e-4, "manipulation": 0.0,
          "logic": 0.0, "search": 0.0, "linalg": 1e-3}


def _op_cases(pt, np):
    """(family, name, call, differentiable): call(T) builds its tensors
    with T(array, grad=False) on the current device."""
    rng = np.random.default_rng(SEED + 21)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    y = rng.standard_normal((64, 96)).astype(np.float32)
    pos = rng.uniform(0.5, 2.0, (64, 96)).astype(np.float32)
    sq = rng.standard_normal((32, 32)).astype(np.float32)
    spd = (sq @ sq.T + 32 * np.eye(32)).astype(np.float32)
    idx = rng.integers(0, 64, (40,)).astype(np.int32)
    ints = rng.integers(0, 50, (64, 96)).astype(np.int32)

    def recon_svd(o):
        u, s, v = (a.numpy() for a in o)
        return u @ np.diag(s) @ v.T

    def recon_eigh(o):
        w, v = (a.numpy() for a in o)
        return v @ np.diag(w) @ v.T

    def recon_qr(o):
        q, r = (a.numpy() for a in o)
        return q @ r

    cases = [
        ("creation", "to_tensor", lambda T: pt.to_tensor(x), False),
        ("creation", "zeros/ones/full", lambda T: pt.concat(
            [pt.zeros([4, 96]), pt.ones([4, 96]), pt.full([4, 96], 2.5)]),
         False),
        ("creation", "arange", lambda T: pt.arange(0, 100, 3), False),
        ("creation", "linspace", lambda T: pt.linspace(0.0, 1.0, 33), False),
        ("creation", "eye", lambda T: pt.eye(16, 24), False),
        ("creation", "tril/triu", lambda T: pt.tril(T(sq, True)) +
         pt.triu(T(sq, True), 1), True),
        ("creation", "diag", lambda T: pt.diag(T(sq, True)), True),
        ("creation", "full_like", lambda T: pt.full_like(T(x), 3.0), False),
        ("creation", "meshgrid", lambda T: pt.meshgrid(
            T(x[0]), T(y[0, :8])), False),
        ("math", "unary", lambda T: [getattr(pt, n)(T(pos, True)) for n in (
            "sqrt", "rsqrt", "exp", "log", "log1p", "sin", "cos", "tanh",
            "erf", "lgamma", "reciprocal", "square", "abs", "floor")], True),
        ("math", "binary", lambda T: [getattr(pt, n)(T(x, True), T(pos)) for
                                      n in ("add", "subtract", "multiply",
                                            "divide", "pow", "maximum",
                                            "minimum", "atan2", "remainder")],
         True),
        ("math", "dunders", lambda T: (T(x, True) * 2 + 1) / (T(pos) ** 2)
         - T(y), True),
        ("math", "reductions", lambda T: [
            T(x, True).sum(axis=1), T(x, True).mean(axis=0),
            T(x, True).max(axis=1), T(x, True).std(axis=1),
            T(x, True).logsumexp(axis=1), T(pos, True).prod(axis=1),
            T(x, True).median(axis=1)], True),
        ("math", "cumulative", lambda T: [pt.cumsum(T(x, True), 1),
                                          pt.cumprod(T(pos, True), 1),
                                          pt.cummax(T(x, True), 1)[0]],
         True),
        ("math", "matmul", lambda T: pt.matmul(T(x, True), T(y, True),
                                               transpose_y=True), True),
        ("math", "scale/clip", lambda T: pt.clip(pt.scale(T(x, True), 2.0,
                                                          0.5), -1, 1), True),
        ("math", "int sum", lambda T: T(ints).sum(axis=0), False),
        ("manipulation", "reshape/transpose", lambda T: T(x, True).reshape(
            [8, 8, 96]).transpose([2, 0, 1]), True),
        ("manipulation", "split/concat", lambda T: pt.concat(
            pt.split(T(x, True), 3, axis=1)[::-1], axis=1), True),
        ("manipulation", "gather", lambda T: pt.gather(T(x, True), T(idx)),
         True),
        ("manipulation", "gather_nd", lambda T: pt.gather_nd(
            T(x, True), T(np.stack([idx, idx % 96], 1))), True),
        ("manipulation", "scatter", lambda T: pt.scatter(
            T(x, True), T(np.unique(idx)), T(y[:len(np.unique(idx))], True)),
         True),
        ("manipulation", "take_along_axis", lambda T: pt.take_along_axis(
            T(x, True), T(ints % 96), 1), True),
        ("manipulation", "tile/expand/flip/roll", lambda T: [
            pt.tile(T(x[:2], True), [2, 1]), T(x[:1], True).expand([3, 96]),
            pt.flip(T(x, True), [0]), pt.roll(T(x, True), 5, 1)], True),
        ("manipulation", "pad", lambda T: pt.pad(T(x[None, None], True),
                                                 [1, 2, 3, 4]), True),
        ("manipulation", "getitem", lambda T: T(x, True)[3:40:2, ::-1], True),
        ("manipulation", "masked_fill/where", lambda T: pt.where(
            T(x) > 0, pt.masked_fill(T(x, True), T(y) > 1, 0.0), T(y, True)),
         True),
        ("manipulation", "unique", lambda T: pt.unique(T(ints), True, True,
                                                       True), False),
        ("logic", "compare", lambda T: [T(x) > T(y), T(x) == T(x),
                                        pt.isclose(T(x), T(y))], False),
        ("logic", "logical/bitwise", lambda T: [
            pt.logical_and(T(x) > 0, T(y) > 0), pt.bitwise_xor(T(ints), 7),
            pt.all(T(x) > -10, axis=1), pt.any(T(x) > 2)], False),
        ("search", "argmax/argsort", lambda T: [
            pt.argmax(T(x), axis=1), pt.argsort(T(x), axis=1)], False),
        ("search", "sort/topk", lambda T: [pt.sort(T(x, True), axis=1),
                                           pt.topk(T(x, True), 5)[0]], True),
        ("search", "nonzero/masked_select", lambda T: [
            pt.nonzero(T(x) > 1), pt.masked_select(T(x, True), T(x) > 1)],
         True),
        ("search", "searchsorted", lambda T: pt.searchsorted(
            T(np.sort(x[0])), T(y[0])), False),
        ("linalg", "norm/dist", lambda T: [pt.norm(T(x, True)),
                                           pt.norm(T(x, True), 2, 1),
                                           pt.dist(T(x, True), T(y))], True),
        ("linalg", "inv/solve/det", lambda T: [
            pt.inv(T(spd, True)), pt.solve(T(spd, True), T(x[:32, :4])),
            pt.slogdet(T(spd, True))[1]], True),
        ("linalg", "cholesky", lambda T: pt.cholesky(T(spd, True)), True),
        ("linalg", "einsum", lambda T: pt.einsum("ij,kj->ik", T(x, True),
                                                 T(y, True)), True),
        ("linalg", "svd", lambda T: recon_svd(pt.svd(T(x[:32, :16]))),
         False),
        ("linalg", "eigh", lambda T: recon_eigh(pt.eigh(T(spd))), False),
        ("linalg", "qr", lambda T: recon_qr(pt.qr(T(x[:32, :16]))), False),
    ]
    return cases


def _flat_out(o):
    if isinstance(o, (list, tuple)):
        return [v for e in o for v in _flat_out(e)]
    return [o]


def _np_of(torch, np, o):
    return o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)


def _max_err(np, got, want, tol):
    """The largest |got - want| / (1 + |want|), NaN where both are NaN
    counted as equal; checks the shapes and dtypes."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"ops: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    if got.dtype.kind not in "fc":
        return 0.0 if np.array_equal(got, want) else float("inf")
    both_nan = np.isnan(got) & np.isnan(want)
    err = np.where(both_nan, 0.0, np.abs(got.astype(np.float64) -
                                         want) / (1 + np.abs(want)))
    return float(np.nan_to_num(err, nan=np.inf).max()) if err.size else 0.0


def _random_draws(pt):
    return {
        "uniform": lambda: pt.uniform([1 << 16], min=-2.0, max=3.0),
        "uniform_": lambda: pt.uniform_(pt.zeros([1 << 16]), 0.0, 2.0),
        "normal": lambda: pt.normal(1.0, 2.0, [1 << 16]),
        "gaussian": lambda: pt.gaussian([1 << 16], 0.5, 0.5),
        "standard_normal": lambda: pt.standard_normal([1 << 16]),
        "randn": lambda: pt.randn([1 << 16]),
        "rand": lambda: pt.rand([1 << 16]),
        "randint": lambda: pt.randint(2, 9, [1 << 16]),
        "randint_like": lambda: pt.randint_like(pt.zeros([1 << 16]), 0, 4),
        "randperm": lambda: pt.randperm(4096),
        "bernoulli": lambda: pt.bernoulli(pt.full([1 << 16], 0.3)),
        "multinomial": lambda: pt.multinomial(pt.full([64, 128], 1.0), 4),
        "poisson": lambda: pt.poisson(pt.full([1 << 16], 3.0)),
        "exponential_": lambda: pt.exponential_(pt.zeros([1 << 16]), 2.0),
        "shuffle": lambda: pt.shuffle(pt.arange(4096)),
    }


def op_phase(pt, torch, np, card):
    """Every op family of the Tensor API on CUDA `Tensor`s against the same
    call on CPU `Tensor`s (outputs, shapes, dtypes; for a differentiable
    call the gradients of the sum of its float outputs), within each
    family's tolerance (relative to 1 + |ref|); numpy() of a CUDA bf16
    tensor; each random op drawn twice on the card under one seed, bit
    for bit; the host cost of one op through the Tensor layer."""
    worst = {}
    for family, name, call, diff in _op_cases(pt, np):
        res = {}
        for dev in ("cpu", "gpu"):
            pt.set_device(dev)
            leaves = []

            def T(a, grad=False):
                t = pt.to_tensor(a, stop_gradient=not grad)
                if grad:
                    leaves.append(t)
                return t

            flat = _flat_out(call(T))
            for o in flat:
                if isinstance(o, torch.Tensor):
                    check(isinstance(o, pt.Tensor) and
                          o.place.device_type == dev,
                          f"ops {name} on {dev}: {type(o)} "
                          f"{getattr(o, 'place', None)}")
            grads = []
            if diff:
                total = sum(o.astype("float32").sum() for o in flat
                            if isinstance(o, torch.Tensor) and
                            o.is_floating_point() and not o.stop_gradient)
                total.backward()
                grads = [leaf.gradient() for leaf in leaves]
            res[dev] = ([_np_of(torch, np, o) for o in flat], grads)
        tol = OP_TOL[family]
        (got, ggot), (want, gwant) = res["gpu"], res["cpu"]
        check(len(got) == len(want) and len(ggot) == len(gwant),
              f"ops {name}: output counts")
        err = max([_max_err(np, g, w, tol) for g, w in zip(got, want)] +
                  [_max_err(np, g, w, tol) for g, w in zip(ggot, gwant)
                   if w is not None or g is not None] + [0.0])
        check(err <= tol, f"ops {family} {name}: max err {err} (tol {tol})")
        prev = worst.get(family, (0, 0.0))
        worst[family] = (prev[0] + 1, max(prev[1], err))
    pt.set_device("gpu")
    for family, (count, err) in worst.items():
        print(f"ops: {family}: {count} calls on CUDA Tensors vs CPU Tensors "
              f"(forward and, where differentiable, the gradients of the "
              f"sum): max err {err:.3g} relative to 1 + |ref| (tol "
              f"{OP_TOL[family]}) [{card}]", flush=True)
    # numpy() of a CUDA bf16 tensor: exact f32
    x = np.random.default_rng(SEED + 22).standard_normal(
        (64, 96)).astype(np.float32)
    t = pt.to_tensor(x, dtype="bfloat16")
    host = t.numpy()
    check(t.place == pt.CUDAPlace(0) and host.dtype == np.float32 and
          np.array_equal(host, torch.from_numpy(x).bfloat16().float()
                         .numpy()), "ops: numpy() of a CUDA bf16 tensor")
    # the random ops: two seeded draws on the card, bit for bit
    draws = _random_draws(pt)
    for name, draw in draws.items():
        pt.seed(SEED + 23)
        a = draw()
        pt.seed(SEED + 23)
        b = draw()
        check(a.place == pt.CUDAPlace(0) and torch.equal(a, b),
              f"ops: {name} does not repeat under one seed on the card")
    u = draws["uniform"]().numpy()
    r = draws["randint"]().numpy()
    check(u.min() >= -2.0 and u.max() <= 3.0 and abs(u.mean() - 0.5) < 0.05
          and r.min() >= 2 and r.max() <= 8, "ops: random supports")
    print(f"ops: numpy() of a CUDA bf16 tensor is its exact f32; "
          f"{len(draws)} random ops each drawn twice on the card under one "
          f"seed: bit-equal [{card}]", flush=True)
    # the host cost of the Tensor layer per op (small tensors: launch-bound)
    a, b = pt.to_tensor(x), pt.to_tensor(x)
    ap, bp = pt.core.tensor.to_torch(a), pt.core.tensor.to_torch(b)
    costs = {}
    for label, fn in (("pt.add(Tensor, Tensor)", lambda: pt.add(a, b)),
                      ("Tensor + Tensor", lambda: a + b),
                      ("Tensor.sum(axis=1)", lambda: a.sum(axis=1)),
                      ("torch.add(plain, plain)", lambda: torch.add(ap, bp)),
                      ("plain.sum(1)", lambda: ap.sum(1))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        costs[label] = (time.perf_counter() - t0) / 2000 * 1e6
    print(f"ops: host us per call on a 64 x 96 CUDA tensor (2000 calls, "
          f"synced at the end): "
          f"{ {k: round(v, 2) for k, v in costs.items()} } [{card}]",
          flush=True)
    return costs


# ---- the conv phase: LeNet, the optimizer zoo, ResNet-50's stem ---------
LENET_B, LENET_WARMUP, LENET_SPAN, LENET_TURNS = 32, 6, 20, 3
STEM_CHECK_B, STEM_B, STEM_HW = 8, 128, 224
# LeNet's step-1 loss and gradients, card vs CPU: fp32 throughout (TF32
# off), cuDNN's and the CPU's convolutions sum in other orders
LENET_TOL = 1e-4
# the stem, card vs CPU: relative L2 error of the output and each
# gradient; bf16 rounds at 2^-8 per op through conv, batch norm and pool
STEM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the zoo's 3 LeNet steps, card vs CPU: the parameters within
# ZOO_TOL (1 + |ref|); with the CPU's gradients fed to both, the rules
# alone (multi-tensor-apply vs a loop) within ZOO_RULE_TOL (1 + |ref|)
ZOO_TOL, ZOO_RULE_TOL = 1e-4, 1e-6


def rel_l2(got, want):
    """||got - want|| / ||want|| in float64, on got's device."""
    g = got.detach().double()
    w = want.detach().to(g.device).double()
    return ((g - w).norm() / max(w.norm().item(), 1e-30)).item()


def zoo_optimizer(pt, name, params):
    """The ten optimizers of paddle.optimizer at the settings the smoke
    holds to the CPU (Momentum with Nesterov, RMSProp centred with
    momentum, Lamb and LARS leaving the biases out of their decay)."""
    o = pt.optimizer
    return {
        "SGD": lambda: o.SGD(0.01, params, weight_decay=0.01),
        "Momentum": lambda: o.Momentum(0.01, 0.9, params, use_nesterov=True,
                                       weight_decay=o.L2Decay(0.01)),
        "Adam": lambda: o.Adam(1e-3, parameters=params, weight_decay=0.01),
        "AdamW": lambda: o.AdamW(1e-3, parameters=params),
        "Adamax": lambda: o.Adamax(1e-3, parameters=params),
        "Lamb": lambda: o.Lamb(1e-3, 0.01, parameters=params,
                               exclude_from_weight_decay_fn=lambda p:
                               p.ndim == 1),
        "Adagrad": lambda: o.Adagrad(1e-2, parameters=params),
        "RMSProp": lambda: o.RMSProp(1e-3, 0.9, 1e-6, 0.5, True, params),
        "Adadelta": lambda: o.Adadelta(1.0, parameters=params),
        "LarsMomentum": lambda: o.LarsMomentum(
            0.01, 0.9, parameters=params,
            exclude_from_weight_decay=["bias"]),
    }[name]()


def zoo_lenet(pt, device):
    """LeNet from the smoke's seed on `device`, its head a Linear whose
    weight has ParamAttr(learning_rate=0.5) and whose bias is frozen
    (ParamAttr(trainable=False)); every parameter named by its path (the
    name LARS's exclusion reads)."""
    pt.set_device(device)
    pt.seed(SEED)
    net = pt.models.LeNet(num_classes=10)
    setattr(net.fc, "2", pt.nn.Linear(
        84, 10, weight_attr=pt.ParamAttr(learning_rate=0.5),
        bias_attr=pt.ParamAttr(trainable=False)))
    for n, p in net.named_parameters():
        p.name = n
    return net


def conv_phase(pt, torch, np, card):
    """Slice 11 on the card: LeNet through bench.py's lenet_dispatch loop
    (the step-1 loss and gradients against the CPU; the eager loop and
    TrainStep.run() spans in turns, one capture then replays), the ten
    optimizers against the CPU, ResNet-50's stem (bench.py's
    resnet50_infer shape) in NCHW and NHWC, fp32 and bf16, against the
    CPU and timed, and dropout's modes on the card."""
    from paddle_tpu_torch.utils import bench
    from paddle_tpu_torch.utils.train_profile import (graph_kernel_names,
                                                      kernel_counts)
    F = pt.nn.functional

    # ---- LeNet: step 1 on the card against the CPU ----
    nets = {}
    for dev in ("cpu", "gpu"):
        pt.set_device(dev)
        nets[dev] = bench.lenet_loop(pt, SEED, LENET_B)
    for (k, a), b in zip(nets["cpu"][0].state_dict().items(),
                         nets["gpu"][0].state_dict().values()):
        check(torch.equal(a, b.cpu()), f"conv: LeNet {k} differs between "
              "the devices at one seed")
    step1 = {}
    for dev, (net, _, ce, x, y, _) in nets.items():
        loss = ce(net(x), y)
        loss.backward()
        step1[dev] = (loss.detach().cpu(),
                      {n: p.grad.detach().cpu().clone()
                       for n, p in net.named_parameters()})
        for p in net.parameters():
            p.grad = None
        # a live graph would keep the parameters' gradient-accumulation
        # nodes on the default stream, which run()'s capture cannot join
        del loss
    (lc, gc), (lg, gg) = step1["cpu"], step1["gpu"]
    loss_rel = abs(lg.item() - lc.item()) / abs(lc.item())
    grad_err = max((g - gc[n]).abs().max().item() /
                   (1 + gc[n].abs().max().item()) for n, g in gg.items())
    print(f"conv: LeNet step 1 on the card vs the CPU (batch {LENET_B}, "
          f"fp32, TF32 off): loss {lg.item():.6f} vs {lc.item():.6f}, rel "
          f"{loss_rel:.3g}; max gradient error {grad_err:.3g} (1 + |ref|) "
          f"over {len(gg)} parameters (tol {LENET_TOL}) [{card}]",
          flush=True)
    check(loss_rel <= LENET_TOL and grad_err <= LENET_TOL,
          f"conv: LeNet step 1 loss rel {loss_rel}, grads {grad_err}")

    # ---- the bench loop: warm-up, then eager spans and run() spans in
    # turns ----
    pt.set_device("gpu")
    net, _, ce, x, y, one = nets["gpu"]
    del nets["cpu"]
    losses = [float(one()) for _ in range(LENET_WARMUP)]
    step = pt.jit.TrainStep(net, ce, pt.optimizer.SGD(
        parameters=net.parameters(), learning_rate=0.01))
    captures = [0]
    capture = step._capture

    def counted(*a, **kw):
        captures[0] += 1
        return capture(*a, **kw)

    step._capture = counted
    xs = x.expand([LENET_SPAN] + x.shape)
    ys = y.expand([LENET_SPAN] + y.shape)
    with kept_graphs(torch) as kept:
        span_losses = step.run(xs, ys)       # capture + 19 replays
    caps = [c for c in step._graphs.values() if isinstance(c.graph, kept)]
    check(len(caps) == 1, f"conv: {len(caps)} kept LeNet captures")
    nodes = graph_kernel_names(caps[0].graph)
    del caps
    eager_ms, graph_ms = [], []
    for _ in range(LENET_TURNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LENET_SPAN):
            loss = one()
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3 / LENET_SPAN)
        t0 = time.perf_counter()
        span_losses = step.run(xs, ys)
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t0) * 1e3 / LENET_SPAN)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step.run(xs, ys)
        torch.cuda.synchronize()
    device_events = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    # copies and memsets (a graph's memset node traces as "memset32") are
    # not kernel nodes
    kernels = [n for n in device_events
               if not n.lower().startswith(("memcpy", "memset"))]
    traced, copies = len(kernels), len(device_events) - len(kernels)
    del prof
    losses += [float(loss), float(span_losses[-1])]
    conv_nodes = sum(1 for n in nodes if "conv" in n.lower()
                     or "cudnn" in n.lower() or "implicit" in n.lower())
    print(f"conv: LeNet bench loop (batch {LENET_B}, SGD(0.01)): "
          f"{LENET_WARMUP} warm-up steps, then {LENET_TURNS} turns of an "
          f"eager span and a run() span of {LENET_SPAN} steps each: eager "
          f"step median {statistics.median(eager_ms):.4f} ms "
          f"({[round(v, 4) for v in eager_ms]}), run() step median "
          f"{statistics.median(graph_ms):.4f} ms "
          f"({[round(v, 4) for v in graph_ms]}) (host clock, synced); "
          f"captures {captures[0]}, the captured step {len(nodes)} kernel "
          f"nodes ({conv_nodes} of them convolution kernels; "
          f"{kernel_counts(nodes)['gemm']} GEMMs), device trace of one "
          f"replayed span {traced} kernels ({LENET_SPAN} x {len(nodes)} = "
          f"{LENET_SPAN * len(nodes)}, and the span's reset of its step "
          f"index) and {copies} copies and memsets (the batch into the "
          f"static inputs, a memset node per replay, the losses out); losses "
          f"{[round(v, 4) for v in losses]} [{card}]", flush=True)
    check(captures[0] == 1, f"conv: run() captured {captures[0]} times")
    check(len(nodes) > 0 and traced <= LENET_SPAN * len(nodes) + 1,
          f"conv: {len(nodes)} graph nodes, {traced} traced kernels")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"conv: LeNet losses {losses} do not fall")
    lenet = {"eager_ms": statistics.median(eager_ms),
             "graph_ms": statistics.median(graph_ms),
             "nodes": len(nodes)}
    del step, net, nets, xs, ys

    # ---- the optimizer zoo: 3 LeNet steps on the card against the CPU,
    # and the rules alone on the CPU's gradients ----
    pt.set_device("cpu")
    np.random.seed(SEED)
    xz = np.random.rand(LENET_B, 1, 28, 28).astype("float32")
    yz = np.random.randint(0, 10, (LENET_B,))
    zoo = {}
    for name in ("SGD", "Momentum", "Adam", "AdamW", "Adamax", "Lamb",
                 "Adagrad", "RMSProp", "Adadelta", "LarsMomentum"):
        runs = {}
        for dev in ("cpu", "gpu"):
            net = zoo_lenet(pt, dev)
            opt = zoo_optimizer(pt, name, net.parameters())
            ce = pt.nn.CrossEntropyLoss()
            xt, yt = pt.to_tensor(xz), pt.to_tensor(yz)
            grads = []
            for _ in range(3):
                loss = ce(net(xt), yt)
                loss.backward()
                grads.append([None if p.grad is None else
                              p.grad.detach().cpu().clone()
                              for p in net.parameters()])
                opt.step()
                opt.clear_grad()
            runs[dev] = (net, grads)
        full = max((a.detach().cpu() - b.detach()).abs().max().item() /
                   (1 + b.detach().abs().max().item())
                   for a, b in zip(runs["gpu"][0].parameters(),
                                   runs["cpu"][0].parameters()))
        # the rules alone: the CPU's gradients into a fresh card optimizer
        net = zoo_lenet(pt, "gpu")
        opt = zoo_optimizer(pt, name, net.parameters())
        for gs in runs["cpu"][1]:
            for p, g in zip(net.parameters(), gs):
                p.grad = None if g is None else g.cuda()
            opt.step()
            opt.clear_grad()
        rule = max((a.detach().cpu() - b.detach()).abs().max().item() /
                   (1 + b.detach().abs().max().item())
                   for a, b in zip(net.parameters(),
                                   runs["cpu"][0].parameters()))
        head = runs["gpu"][0].fc[2]
        check(head.bias.stop_gradient and
              torch.equal(head.bias.detach().cpu(),
                          zoo_lenet(pt, "cpu").fc[2].bias.detach()),
              f"conv: {name} moved the frozen bias")
        zoo[name] = (full, rule)
        check(full <= ZOO_TOL and rule <= ZOO_RULE_TOL,
              f"conv: {name} card vs CPU after 3 steps {full}, rule {rule}")
    print(f"conv: the ten optimizers, 3 LeNet steps on the card vs the "
          f"CPU (one ParamAttr(learning_rate=0.5) weight, one frozen bias; "
          f"max parameter error (1 + |ref|), tol {ZOO_TOL}) and the rules "
          f"alone on the CPU's gradients (tol {ZOO_RULE_TOL}): "
          + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in zoo.items())
          + f" [{card}]", flush=True)

    # ---- ResNet-50's stem: checks at batch 8, times at batch 128 ----
    def stem(fmt):
        nn = pt.nn
        return nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                      data_format=fmt),
            nn.BatchNorm2D(64, data_format=fmt), nn.ReLU(),
            nn.MaxPool2D(3, 2, 1, data_format=fmt))

    rng = np.random.default_rng(SEED + 21)
    xs_np = rng.standard_normal((STEM_CHECK_B, 3, STEM_HW, STEM_HW),
                                dtype=np.float32)
    worst = {}
    for dtype in ("float32", "bfloat16"):
        res = {}
        for dev in ("cpu", "gpu"):
            pt.set_device(dev)
            pt.seed(SEED)
            m = stem("NCHW")
            xt = pt.to_tensor(xs_np, stop_gradient=False)
            with pt.amp.auto_cast(enable=dtype == "bfloat16",
                                  dtype="bfloat16"):
                out = m(xt)
            g = pt.to_tensor(np.random.default_rng(SEED + 22)
                             .standard_normal(out.shape, dtype=np.float32))
            (out.astype("float32") * g).sum().backward()
            res[dev] = [out, xt.grad, m[0].weight.grad, m[1].weight.grad,
                        m[1].bias.grad, m[1]._mean, m[1]._variance]
        errs = [rel_l2(a, b) for a, b in zip(res["gpu"], res["cpu"])]
        worst[dtype] = max(errs)
        print(f"conv: stem {dtype} at batch {STEM_CHECK_B}, card vs CPU: "
              f"relative L2 error of the output {errs[0]:.3g}, input grad "
              f"{errs[1]:.3g}, conv weight grad {errs[2]:.3g}, BN weight / "
              f"bias grads {errs[3]:.3g} / {errs[4]:.3g}, running mean / "
              f"variance after one training call {errs[5]:.3g} / "
              f"{errs[6]:.3g} (tol {STEM_TOL[dtype]}) [{card}]", flush=True)
        check(worst[dtype] <= STEM_TOL[dtype],
              f"conv: stem {dtype} card vs CPU {errs}")
    pt.set_device("gpu")
    pt.seed(SEED)
    a, b = stem("NCHW"), stem("NHWC")
    b.set_state_dict(a.state_dict())
    xg = torch.from_numpy(xs_np).cuda()
    nhwc_err = rel_l2(b(xg.permute(0, 2, 3, 1).contiguous()).permute(
        0, 3, 1, 2), a(xg))
    check(nhwc_err <= STEM_TOL["float32"],
          f"conv: stem NHWC vs NCHW {nhwc_err}")
    del a, b, xg, res
    times = {}
    big = torch.randn(STEM_B, 3, STEM_HW, STEM_HW, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(SEED))
    for fmt in ("NCHW", "NHWC"):
        x_in = big if fmt == "NCHW" else big.permute(0, 2, 3, 1).contiguous()
        for dtype in ("float32", "bfloat16"):
            pt.seed(SEED)
            m = stem(fmt)
            amp = pt.amp.auto_cast(enable=dtype == "bfloat16",
                                   dtype="bfloat16")

            def fwd_bwd():
                with amp:
                    out = m(x_in)
                out.backward(torch.ones_like(out))
                for p in m.parameters():
                    p.grad = None

            for _ in range(3):
                fwd_bwd()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(10):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                fwd_bwd()
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
            times[(fmt, dtype)] = (statistics.median(ms),
                                   torch.cuda.max_memory_allocated() / 2 ** 30)
            del m
    best = {dt: min(("NCHW", "NHWC"), key=lambda f: times[(f, dt)][0])
            for dt in ("float32", "bfloat16")}
    print(f"conv: ResNet-50 stem (Conv2D(3, 64, 7, stride 2, padding 3, no "
          f"bias) + BatchNorm2D(64) + ReLU + MaxPool2D(3, 2, 1)) forward + "
          f"backward at {STEM_B} x 3 x {STEM_HW} x {STEM_HW}, ms (CUDA "
          f"events, median of 10) and peak GiB: "
          + ", ".join(f"{f} {dt} {t:.3f} ms {g:.2f} GiB"
                      for (f, dt), (t, g) in times.items())
          + f"; NHWC vs NCHW output rel err {nhwc_err:.3g}; faster layout: "
          f"fp32 {best['float32']}, bf16 {best['bfloat16']} [{card}]",
          flush=True)
    del big
    torch.cuda.empty_cache()

    # ---- dropout on the card ----
    x = torch.rand(512, 256, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(SEED)) + 0.5
    ev = F.dropout(x, 0.3, training=False, mode="downscale_in_infer")
    exact = torch.equal(ev.cpu(), x.cpu() * 0.7)
    pt.seed(SEED)
    tr = F.dropout(x, 0.3)
    kept = tr != 0
    n, p_keep = x.numel(), 0.7
    band = 5 * math.sqrt(n * p_keep * (1 - p_keep))
    frac_ok = abs(kept.sum().item() - n * p_keep) <= band
    vals_ok = torch.equal(tr[kept], (x / torch.tensor(
        0.7, device="cuda"))[kept])
    down = F.dropout(x, 0.3, mode="downscale_in_infer")
    down_ok = torch.equal(down[down != 0], x[down != 0])
    ax = F.dropout(x, 0.5, axis=0) != 0
    axis_ok = bool((ax == ax[:, :1]).all())
    print(f"conv: dropout on the card: eval downscale_in_infer bit-equal to "
          f"x * 0.7 {exact}; training kept {kept.sum().item()} of {n} (band "
          f"{n * p_keep:.0f} +- {band:.0f}) {frac_ok}, kept values x / 0.7 "
          f"{vals_ok}, downscale_in_infer keeps x {down_ok}, axis=0 one "
          f"draw per row {axis_ok} [{card}]", flush=True)
    check(exact and frac_ok and vals_ok and down_ok and axis_ok,
          "conv: dropout on the card")
    return {"lenet": lenet, "zoo": zoo, "stem": times}


# the deploy phase: ResNet-50 at bench.py's resnet50_infer size, the
# card-vs-CPU check at a small batch, the runs of each rate span, the
# repairs' TrainStep batch and steps
DEPLOY_B, DEPLOY_CHECK_B, DEPLOY_TRAIN_B = 128, 8, 32
DEPLOY_RUNS, DEPLOY_REPS, DEPLOY_TRAIN_STEPS = 6, 2, 3   # cut from 20, 3
# relative L2 of the fp32 artifact on the card against the live layer on
# the CPU (TF32 off), and bf16 / int8 against fp32 by the reference's
# measure, max|got - ref| / max|ref| (tests/test_quant_asp.py:278-280)
DEPLOY_TOL, DEPLOY_QUANT_TOL = 1e-5, 0.08
# the int8 weights' share of the fp32 ones (tests/test_quant_asp.py:263)
DEPLOY_INT8_SHARE = 0.45
# the loaded program's device time per batch against the live layer's
DEPLOY_DEVICE_SHARE = 0.10


def deploy_saved(pt, net, path, shape, dtype, precision):
    """jit.save -> Config -> create_predictor on the card: (predictor,
    seconds to export, bytes of the .pdiparams.npz)."""
    t0 = time.perf_counter()
    pt.jit.save(net, path, input_spec=[pt.InputSpec(list(shape), dtype)],
                precision=precision)
    export_s = time.perf_counter() - t0
    cfg = pt.inference.Config(path)
    cfg.enable_use_gpu(device_id=0)
    return (pt.inference.create_predictor(cfg), export_s,
            os.path.getsize(path + ".pdiparams.npz"))


def busy_ms(torch, fn, runs):
    """(device busy ms per call, idle share, wall ms per call) of `runs`
    calls of fn under torch.profiler."""
    from paddle_tpu_torch.utils import bench
    return bench.busy_ms(fn, runs, torch.device("cuda"))


def deploy_phase(pt, fa, torch, np, card, gpt2_dir=None):
    """Slice 12 on the card: ResNet-50 NHWC through jit.save -> Config ->
    create_predictor in fp32 (against the live layer on the CPU), bf16 and
    int8 (against fp32), their rates, device time against the live
    layer's, MFU and memory; GPT-2 small's bf16 artifact through the
    flash kernel and ServingEngine; BN's running statistics under
    TrainStep and a run() capture after an eager loop that kept its
    loss's graph. Returns the flash forward's host launches of the
    artifact's main path. GPT-2's artifact is saved under `gpt2_dir` (which
    outlives the phase: the server phase serves it) when given."""
    import tempfile
    from paddle_tpu_torch.utils import bench
    from paddle_tpu_torch.utils.train_profile import _trace
    pt.set_device("gpu")
    pt.seed(SEED)
    net = pt.models.resnet50(data_format="NHWC")
    net.eval()
    rng = np.random.default_rng(SEED)
    x = rng.random((DEPLOY_B, 224, 224, 3), dtype=np.float32)
    work = tempfile.TemporaryDirectory(prefix="deploy_")
    try:
        # ---- fp32 at a small batch against the live layer on the CPU ----
        pred, export_s, _ = deploy_saved(
            pt, net, os.path.join(work.name, "r50_check"),
            (DEPLOY_CHECK_B, 224, 224, 3), "float32", None)
        x8 = x[:DEPLOY_CHECK_B]
        got = pred.run([x8])[0]
        with torch.inference_mode():
            ref = copy.deepcopy(net).cpu()(torch.from_numpy(x8))
        err = rel_l2(got, ref)
        print(f"deploy: ResNet-50 NHWC fp32 artifact (exported on the card "
              f"in {export_s:.1f} s) at batch {DEPLOY_CHECK_B} vs the live "
              f"layer on the CPU: relative L2 {err:.3g} (tol {DEPLOY_TOL}, "
              f"TF32 off) [{card}]", flush=True)
        check(err <= DEPLOY_TOL, f"deploy: fp32 artifact vs CPU {err}")
        del pred, got, ref

        # ---- fp32, bf16 and int8 at bench.py's batch ----
        flops_img = bench.forward_flops(
            net, torch.zeros((1, 224, 224, 3), device="cuda"))
        outs, sizes, rows = {}, {}, {}
        live16 = copy.deepcopy(net).to(torch.bfloat16)
        xd = torch.from_numpy(x).cuda()
        lives = {"float32": (net, xd), "bfloat16": (live16, xd.bfloat16())}
        for prec in ("float32", "bfloat16", "int8"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pred, export_s, sizes[prec] = deploy_saved(
                pt, net, os.path.join(work.name, f"r50_{prec}"),
                (DEPLOY_B, 224, 224, 3), "float32", prec)
            if prec == "int8":
                meta = pred._translated._meta
                q = dict(zip(meta["param_names"], pred._translated._params))
                n_2d = sum(1 for p in net.parameters() if p.dim() >= 2)
                check(len(meta["quantized"]) == n_2d and all(
                    q[n].dtype == torch.int8 for n in meta["quantized"]),
                    f"deploy: int8 artifact quantized "
                    f"{len(meta['quantized'])} of {n_2d} weights")
            rate, spread = bench.predictor_rate(pred, x, DEPLOY_RUNS,
                                                DEPLOY_REPS)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            outs[prec] = pred.get_output_handle("output_0").copy_to_cpu()
            busy, idle, wall = busy_ms(torch, pred.run, DEPLOY_RUNS)
            row = {"rate": rate, "spread": spread, "busy": busy,
                   "idle": idle, "wall": wall, "peak": peak,
                   "export_s": export_s,
                   "mfu": rate * flops_img / PEAK_BF16}
            live = lives.get(prec)
            if live is not None:
                layer, xin = live

                def eager(layer=layer, xin=xin):
                    with torch.inference_mode():
                        return layer(xin)

                live_rate, live_spread, _ = bench._timed_rate(
                    lambda: [eager() for _ in range(DEPLOY_RUNS)],
                    DEPLOY_B * DEPLOY_RUNS, DEPLOY_REPS,
                    torch.device("cuda"))
                live_busy = busy_ms(torch, eager, DEPLOY_RUNS)[0]
                row.update(live_rate=live_rate, live_spread=live_spread,
                           live_busy=live_busy)
            rows[prec] = row
            del pred
            torch.cuda.empty_cache()
        for prec, row in rows.items():
            vs = "" if "live_busy" not in row else (
                f"; the live layer's eager forward {row['live_rate']:.1f} "
                f"imgs/s (spread {row['live_spread']:.3f}), device busy "
                f"{row['live_busy']:.3f} ms per batch (program / live "
                f"{row['busy'] / row['live_busy']:.4f}, tol 1 +- "
                f"{DEPLOY_DEVICE_SHARE})")
            print(f"deploy: ResNet-50 NHWC {prec} artifact, batch "
                  f"{DEPLOY_B}: {row['rate']:.1f} imgs/s (spread "
                  f"{row['spread']:.3f}, {DEPLOY_RUNS} runs x "
                  f"{DEPLOY_REPS}), MFU {row['mfu']:.4f} "
                  f"({flops_img / 1e9:.3f} GFLOP per image), device busy "
                  f"{row['busy']:.3f} ms per run, idle share "
                  f"{row['idle']:.4f} over {DEPLOY_RUNS} run()s (profiled "
                  f"wall {row['wall']:.3f} ms), peak {row['peak']:.2f} "
                  f"GiB, export {row['export_s']:.1f} s{vs} [{card}]",
                  flush=True)
            if "live_busy" in row:
                check(abs(row["busy"] / row["live_busy"] - 1)
                      <= DEPLOY_DEVICE_SHARE,
                      f"deploy: {prec} program {row['busy']} ms vs live "
                      f"{row['live_busy']} ms per batch")
        scale = float(np.abs(outs["float32"]).max())
        for prec in ("bfloat16", "int8"):
            e = float(np.abs(outs[prec] - outs["float32"]).max()) / scale
            print(f"deploy: {prec} vs fp32 logits max|got - ref| / max|ref| "
                  f"{e:.4g} (tol {DEPLOY_QUANT_TOL}) [{card}]", flush=True)
            check(np.isfinite(outs[prec]).all() and
                  outs[prec].shape == (DEPLOY_B, 1000) and
                  e < DEPLOY_QUANT_TOL, f"deploy: {prec} vs fp32 {e}")
        share = sizes["int8"] / sizes["float32"]
        print(f"deploy: .pdiparams.npz int8 {sizes['int8']} bytes, fp32 "
              f"{sizes['float32']} bytes: {share:.4f} (tol < "
              f"{DEPLOY_INT8_SHARE}) [{card}]", flush=True)
        check(share < DEPLOY_INT8_SHARE, f"deploy: int8 npz share {share}")
        del live16, xd, lives, outs
        launches = deploy_gpt2(pt, fa, torch, np, card,
                               gpt2_dir or work.name)
    finally:
        work.cleanup()
    deploy_repairs(pt, torch, np, card, net)
    return launches


def deploy_gpt2(pt, fa, torch, np, card, workdir):
    """GPT-2 small's bf16 artifact: 12 flash forward nodes in the exported
    program; 8 requests through ServingEngine over the loaded Predictor
    (the engine's warm-up runs the program eagerly and captures it, each
    batch is a replay: 2 x 12 host launches, 12 kernel nodes in the
    captured graph, 12 flash forwards in the device trace of a replay),
    against the live-layer Predictor."""
    from paddle_tpu_torch.utils.train_profile import (graph_kernel_names,
                                                      kernel_counts,
                                                      kernel_launches)
    pt.seed(SEED)
    lm = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    lm.eval()
    n_layers = len(lm.gpt.layers)
    vocab = lm.gpt.embeddings.word_embeddings.weight.shape[0]
    seq = 1024
    pred, export_s, _ = deploy_saved(pt, lm, os.path.join(workdir, "gpt2"),
                                     (4, seq), "int32", "bfloat16")
    nodes = sum(str(n.target) == "paddle_tpu_torch.flash_fwd.default"
                for n in pred._translated.program().graph.nodes)
    check(nodes == n_layers, f"deploy: GPT-2's bf16 program holds {nodes} "
          f"flash_fwd nodes, not {n_layers}: exported on the einsum path")
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, vocab, (1, seq)).astype(np.int32)
                for _ in range(8)]
    engine = pt.serving.ServingEngine(pred, pt.serving.EngineConfig(
        max_batch_size=4, batch_sizes=(1, 2, 4), batch_timeout_ms=20.0))
    torch.cuda.synchronize()
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    with kept_graphs(torch):
        engine.start()
        futures = [engine.submit([r]) for r in requests]
        results = [f.result(600)[0] for f in futures]
    wall = time.perf_counter() - t0
    engine.stop(drain=True)
    launches = fa.flash_attention_fwd.launches
    counts = engine.stats()["counters"]
    graphs = list(pred._translated._graphs.values())
    check(len(graphs) == 1, f"deploy: {len(graphs)} captures of GPT-2's "
          "program for one signature")
    per_run = kernel_counts(graph_kernel_names(graphs[0].graph))
    check(counts["completed"] == len(requests) and
          launches == 2 * n_layers and per_run["flash_fwd"] == n_layers,
          f"deploy: engine over the artifact: {counts}, {launches} flash "
          f"host launches (want {2 * n_layers}: the warm-up's eager run and "
          f"capture), {per_run['flash_fwd']} flash nodes in the graph")
    batch4 = np.concatenate(requests[:4])
    pred.run_batch([batch4])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pred.run_batch([batch4])
        torch.cuda.synchronize()
    traced = kernel_launches(prof)["flash_fwd"]
    del prof
    # a trace can lose a kernel record (PERF.md: once 15 of 16), never
    # show one the graph does not hold
    check(n_layers - 1 <= traced <= n_layers, f"deploy: the device trace "
          f"of one replayed run() shows {traced} flash forwards")
    live = pt.inference.Predictor(copy.deepcopy(lm).to(torch.bfloat16),
                                  input_spec=[pt.InputSpec([4, seq],
                                                           "int32")])
    worst = 0.0
    for r, got in zip(requests, results):
        ref = live.run_batch([r])[0]
        check(got.shape == (1, seq, vocab) and np.isfinite(got).all(),
              f"deploy: engine logits {got.shape}")
        worst = max(worst, float(np.abs(got - ref).mean()
                                 / np.abs(ref).mean()))
    print(f"deploy: GPT-2 small bf16 artifact (export {export_s:.1f} s): "
          f"{nodes} flash_fwd nodes; ServingEngine over the loaded "
          f"Predictor: {len(requests)} requests in {wall:.3f} s (warm-up "
          f"and capture included), {counts['batches']} batches at the "
          f"exported batch 4 ({counts['padded_rows']} padded rows), "
          f"{launches} flash host launches (the warm-up's eager run and "
          f"capture), {per_run['flash_fwd']} flash nodes in the captured "
          f"graph, {traced} flash forwards in the device trace of one "
          f"replayed run(); vs the live-layer Predictor max relative "
          f"mean-abs error {worst:.3g} (tol 2e-2) [{card}]", flush=True)
    check(worst <= 2e-2, f"deploy: artifact vs live layer {worst}")
    return launches


def deploy_repairs(pt, torch, np, card, net):
    """BN's running statistics under TrainStep (ResNet-50 NHWC, bf16 AMP):
    __call__ and run() leave them bit-unchanged and agree step for step;
    then a run() capture after an eager LeNet loop that kept its loss's
    graph."""
    from paddle_tpu_torch.utils import bench
    net.train()
    rng = np.random.default_rng(SEED)
    n, b = DEPLOY_TRAIN_STEPS, DEPLOY_TRAIN_B
    xs = torch.from_numpy(rng.random((n, b, 224, 224, 3),
                                     dtype=np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, 1000, (n, b))).cuda()
    stats = {k: v.clone() for k, v in net.named_buffers()}
    step = pt.jit.TrainStep(net, pt.nn.CrossEntropyLoss(),
                            pt.optimizer.Momentum(
                                learning_rate=0.01, momentum=0.9,
                                parameters=net.parameters()),
                            amp_dtype="bfloat16")
    r = graph_run_vs_loop(pt, torch, "ResNet-50 NHWC bf16 (batch "
                          f"{b})", step, (xs, ys), n, card)
    moved = [k for k, v in net.named_buffers()
             if not torch.equal(v, stats[k])]
    print(f"deploy: BN under TrainStep: {len(stats)} running statistics "
          f"after the __call__ and run() spans: {len(moved)} moved "
          f"(want 0, as in the reference); run() vs __call__ max rel loss "
          f"diff {r['rel']:.3g}, cosine {r['cosine']:.8f} [{card}]",
          flush=True)
    check(not moved, f"deploy: BN statistics moved under TrainStep: "
          f"{moved[:4]}")
    del step, xs, ys, stats

    lnet, opt, ce, x, y, _ = bench.lenet_loop(pt, SEED, LENET_B)
    for _ in range(3):
        kept = ce(lnet(x), y)        # kept with its graph
        kept.backward()
        opt.step()
        opt.clear_grad()
    step = pt.jit.TrainStep(lnet, ce, pt.optimizer.SGD(
        parameters=lnet.parameters(), learning_rate=0.01))
    losses = step.run(x.expand([LENET_SPAN] + x.shape),
                      y.expand([LENET_SPAN] + y.shape))
    ok = bool(torch.isfinite(losses).all()) and len(step._graphs) == 1 \
        and kept.grad_fn is not None
    print(f"deploy: TrainStep.run() after an eager LeNet loop whose loss "
          f"kept its graph: {len(step._graphs)} capture, {LENET_SPAN} "
          f"steps, loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} "
          f"[{card}]", flush=True)
    check(ok and float(losses[-1]) < float(losses[0]),
          f"deploy: capture after a kept graph: {losses}")


# ---- slice 13: the sequence layers and BASELINE config 4 ----
SEQ_B, SEQ_S, SEQ_STEPS = 8, 1024, 3
# card against CPU for the RNN family and the CTC loss (fp32, TF32 off)
SEQ_TOL = 1e-4
# the RNN family's gradients, card against CPU: cuDNN's fp32 RNN is about
# ten times less accurate than aten's CPU loop (the seq phase prints both
# against float64 on the CPU)
RNN_GRAD_TOL = 5e-4
# the beam search of the seq phase: GRUCell(128, 256) over a 1000-token
# vocabulary, 4 beams, 8 sequences, at most 32 steps
BEAM_VOCAB, BEAM_EMB, BEAM_HIDDEN, BEAM_W, BEAM_B, BEAM_STEPS = \
    1000, 128, 256, 4, 8, 32
# config 4: the fp32 artifacts against the live layers on the CPU at these
# batches; the rates over spans of C4_RUNS run()s (6 x 2: cut from 20 x
# 3 to keep the whole smoke inside its time limit)
OCR_CHECK_B, YOLOE_CHECK_B, OCR_TRAIN_B, C4_RUNS, C4_REPS = 4, 2, 4, 6, 2
# the CTC loss at the OCR head's shapes: T 160 positions, batch 64,
# 6625 classes, labels of 1-25 tokens
CTC_T, CTC_B, CTC_C, CTC_L = 160, 64, 6625, 25
OCR_TRAIN_TOL = 1e-3


def seq_phase(pt, fa, torch, np, card):
    """Slice 13, the sequence layers: the base Transformer (Vaswani et al.,
    the reference's defaults) trained in bf16 AMP through TrainStep +
    AdamW, whose encoder self-attention and equal-length cross-attention
    reach kernel rows 1-2; beam search over a GRU cell, card against CPU;
    the RNN family card against CPU. Returns the host launches of the
    flash kernels over the main path's steps."""
    from paddle_tpu_torch.jit import amp_functional_call, split_state
    from paddle_tpu_torch.utils.train_profile import (kernel_launches,
                                                      transformer_step)
    t_phase = time.time()
    pt.set_device("gpu")
    pt.seed(SEED)
    rng = np.random.default_rng(SEED)
    step, (src, tgt, y) = transformer_step(pt, rng, SEQ_B, SEQ_S)
    model, loss_fn = step.model, step.loss_fn
    n_layers = 6
    trainable, frozen = split_state(model)
    pnames, ps = list(trainable), list(trainable.values())
    bnames, bufs = list(frozen), list(frozen.values())

    def grads_of(amp_dtype):
        with torch.enable_grad():
            out = amp_functional_call(model, pnames, ps, bnames, bufs,
                                      [src, tgt], amp_dtype)
            loss = loss_fn(out, y)
            grads = torch.autograd.grad(loss, ps)
        torch.cuda.synchronize()
        return float(loss.detach()), [g.float() for g in grads]

    # ---- step 1: the bf16 kernel path against fp32 (the einsum path at
    # S = 1024) on the card ----
    counters = {"flash_fwd": fa.flash_attention_fwd,
                "flash_bwd_fused": fa.flash_attention_bwd_fused,
                "flash_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_bwd_dkv": fa.flash_attention_bwd_dkv}
    before = {k: c.launches for k, c in counters.items()}
    loss32, g32 = grads_of(None)
    fp32_launches = {k: c.launches - before[k] for k, c in counters.items()}
    loss16, g16 = grads_of("bfloat16")
    rel = abs(loss16 - loss32) / abs(loss32)
    # the attention logits' projections (q_proj, k_proj) get the
    # softmax's backward, dS = P * (dP - rowsum(P * dP)): at this
    # initialisation the two terms nearly cancel and bf16 rounding (of P
    # on the einsum path, of the output the kernel's rowsum(dO * O) reads)
    # dominates their small gradients (1e-5 to 1e-4 of the largest); they
    # are held together, as one vector, and each other parameter alone.
    # The key bias's exact gradient is 0 (q . b_k shifts a whole softmax
    # row): its computed norms are printed beside the query bias's
    logit = [i for i, n in enumerate(pnames)
             if ".q_proj." in n or ".k_proj." in n]
    k_bias = [i for i in logit if pnames[i].endswith("k_proj.bias")]
    q_bias = [i for i in logit if pnames[i].endswith("q_proj.bias")]
    noise = max(float(g[i].norm()) / float(g[j].norm())
                for g in (g32, g16) for i, j in zip(k_bias, q_bias))
    cos = min((cosine(a, b), n) for i, (a, b, n) in
              enumerate(zip(g16, g32, pnames)) if i not in logit)
    qk = [i for i in logit if i not in k_bias]
    cos_qk = cosine(torch.cat([g16[i].flatten() for i in qk]),
                    torch.cat([g32[i].flatten() for i in qk]))
    low_qk = sorted((cosine(g16[i], g32[i]), pnames[i]) for i in qk)[:3]
    cos_all = cosine(torch.cat([g.flatten() for g in g16]),
                     torch.cat([g.flatten() for g in g32]))
    print(f"seq: Transformer(512, 8, 6 + 6, 2048) step 1 at {SEQ_B} x "
          f"{SEQ_S}: loss fp32 {loss32:.6f} bf16 {loss16:.6f}, rel err "
          f"{rel:.3g} (tol 2e-2); gradient cosine bf16 vs fp32: whole "
          f"{cos_all:.6f} (tol 0.999), lowest per parameter outside the "
          f"q / k projections {cos[0]:.6f} ({cos[1]}, tol 0.99), the "
          f"{len(qk)} q / k projection tensors together {cos_qk:.6f} (tol "
          f"0.99; lowest alone {[(round(c, 4), n) for c, n in low_qk]}); "
          f"key-bias gradient norms at most {noise:.3g} of the query "
          f"biases'; fp32 flash launches {sum(fp32_launches.values())} "
          f"(want 0) [{card}]", flush=True)
    check(rel <= 2e-2, f"seq: bf16 vs fp32 step-1 loss {rel}")
    check(cos_all >= 0.999, f"seq: bf16 vs fp32 whole gradient {cos_all}")
    check(cos[0] >= 0.99, f"seq: bf16 vs fp32 gradient cosine {cos}")
    check(cos_qk >= 0.99, f"seq: bf16 vs fp32 q / k gradients {cos_qk}")
    check(not any(fp32_launches.values()),
          f"seq: fp32 reached the kernels: {fp32_launches}")
    del g32, g16
    torch.cuda.empty_cache()

    # ---- the main path: SEQ_STEPS __call__ steps, then run() over as
    # many from the same state ----
    saved = step.state_dict()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SEQ_STEPS + 1)]
    events[0].record()
    losses = []
    for i in range(SEQ_STEPS):
        losses.append(step(src, tgt, y))
        events[i + 1].record()
    torch.cuda.synchronize()
    call_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(SEQ_STEPS)]
    call_params = [p.detach().clone() for p in step._ptensors]
    step.set_state_dict(saved)
    stacked = [t.expand(SEQ_STEPS, *t.shape) for t in (src, tgt, y)]
    run_losses = step.run(*stacked)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    run_losses = [float(x) for x in run_losses]
    run_rel = max(abs(a - b) / abs(b) for a, b in zip(run_losses, losses))
    # the parameters after the two spans differ by the fused backward's dq
    # atomics, which AdamW makes visible on the key biases (their exact
    # gradient is 0, so their steps follow rounding noise): the same pair
    # again from the saved state under torch.use_deterministic_algorithms
    # (the two-pass backward) holds run() to __call__ parameter by
    # parameter
    with determinism(torch, True):
        step.set_state_dict(saved)
        for _ in range(SEQ_STEPS):
            step(src, tgt, y)
        det_params = [p.detach().clone() for p in step._ptensors]
        step.set_state_dict(saved)
        step.run(*stacked)
    run_cos = min((cosine(a.float(), b.float()), n) for a, b, n in
                  zip(step._ptensors, det_params, step._pnames))
    del call_params, det_params
    # the device trace of one more __call__ step: the kernels per step
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(src, tgt, y)
        torch.cuda.synchronize()
    traced = kernel_launches(prof)
    # host calls: SEQ_STEPS __call__ steps, then run()'s eager first step
    # and one capture (the replays launch on the device alone)
    n_host = SEQ_STEPS + 2
    per_layer = 2 * n_layers            # encoder self + decoder cross
    print(f"seq: losses __call__ {[round(x, 6) for x in losses]}, run() "
          f"{[round(x, 6) for x in run_losses]}: max rel diff "
          f"{run_rel:.3g} (tol 1e-4); lowest parameter cosine run() vs "
          f"__call__ under deterministic algorithms {run_cos[0]:.8f} "
          f"({run_cos[1]}, tol 0.9999); __call__ "
          f"{[round(x, 3) for x in call_ms]} ms per step (CUDA events), "
          f"peak {peak:.2f} GiB [{card}]", flush=True)
    print(f"seq: flash launches (host calls) over {SEQ_STEPS} __call__ "
          f"steps and run(): {launches}; in the device trace of one step: "
          f"flash_fwd {traced['flash_fwd']}, flash_bwd_fused "
          f"{traced['flash_bwd_fused']} (want {per_layer} each: 6 encoder "
          f"self-attentions, 6 cross-attentions; the masked decoder "
          f"self-attention takes the einsum path) [{card}]", flush=True)
    check(all(math.isfinite(x) for x in losses + run_losses),
          f"seq: non-finite loss {losses} {run_losses}")
    check(losses[-1] < losses[0], f"seq: the loss did not fall {losses}")
    check(run_rel <= 1e-4, f"seq: run() vs __call__ losses {run_rel}")
    check(run_cos[0] >= 0.9999, f"seq: run() vs __call__ params {run_cos}")
    check(traced["flash_fwd"] == per_layer and
          traced["flash_bwd_fused"] == per_layer and
          traced["flash_bwd_dq"] == 0 and traced["flash_bwd_dkv"] == 0,
          f"seq: device trace of one step {traced}")
    check(launches == {"flash_fwd": per_layer * n_host,
                       "flash_bwd_fused": per_layer * n_host,
                       "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"seq: host launches {launches} over {n_host} host steps")
    del step, model, saved, stacked, src, tgt, y
    torch.cuda.empty_cache()
    beam_check(pt, torch, np, card)
    rnn_checks(pt, torch, np, card)
    print(f"seq: phase wall {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches


def beam_check(pt, torch, np, card):
    """BeamSearchDecoder(GRUCell) through dynamic_decode on the card and
    on the CPU from the same weights: the same ids, parents and lengths."""
    pt.seed(SEED)
    emb = pt.nn.Embedding(BEAM_VOCAB, BEAM_EMB)
    cell = pt.nn.GRUCell(BEAM_EMB, BEAM_HIDDEN)
    proj = pt.nn.Linear(BEAM_HIDDEN, BEAM_VOCAB)
    h0 = np.random.default_rng(SEED).standard_normal(
        (BEAM_B, BEAM_HIDDEN)).astype(np.float32)

    class Recording(pt.nn.BeamSearchDecoder):
        def step(self, *args, **kwargs):
            res = super().step(*args, **kwargs)
            self.parents.append(res[0].parent_ids)
            return res

    res = {}
    for where in ("cuda", "cpu"):
        mods = [copy.deepcopy(m).to(where) for m in (emb, cell, proj)]
        dec = Recording(mods[1], start_token=0, end_token=1,
                        beam_size=BEAM_W, embedding_fn=mods[0],
                        output_fn=mods[2])
        dec.parents = []
        with torch.no_grad():
            ids, _, lengths = pt.nn.dynamic_decode(
                dec, inits=torch.from_numpy(h0).to(where),
                max_step_num=BEAM_STEPS, return_length=True)
        res[where] = (ids.cpu().numpy(), np.stack(dec.parents),
                      lengths.cpu().numpy())
    same = [bool(np.array_equal(a, b)) for a, b in zip(res["cuda"],
                                                      res["cpu"])]
    print(f"seq: beam search GRUCell({BEAM_EMB}, {BEAM_HIDDEN}), "
          f"{BEAM_W} beams, batch {BEAM_B}, vocabulary {BEAM_VOCAB}: "
          f"{res['cuda'][0].shape[1]} steps; card vs CPU ids, parents, "
          f"lengths equal {same} [{card}]", flush=True)
    check(all(same), f"seq: beam search card vs CPU {same}")


def rnn_checks(pt, torch, np, card):
    """nn.LSTM / GRU / SimpleRNN, two bidirectional layers, with and
    without sequence_length, forward and the gradients of sum(out * g),
    card against CPU from the same weights; each also against float64 on
    the CPU, the accuracy of cuDNN's fp32 RNN beside aten's."""
    rng = np.random.default_rng(SEED)
    x_np = rng.standard_normal((8, 50, 64)).astype(np.float32)
    g_np = rng.standard_normal((8, 50, 256)).astype(np.float32)
    seq = np.array([50, 20, 35, 50, 7, 49, 1, 30])

    def dev(got, want):
        """(outputs, gradients) worst |got - want| / (1 + |want|)."""
        e = [float(((a.double() - b.double()).abs()
                    / (1 + b.double().abs())).max())
             for a, b in zip(got, want)]
        return e[0], max(e[1:])

    worst, vs64 = [], {"card": (0.0, 0.0), "cpu": (0.0, 0.0)}
    for cls in ("LSTM", "GRU", "SimpleRNN"):
        pt.seed(SEED)
        net = getattr(pt.nn, cls)(64, 128, num_layers=2,
                                  direction="bidirect")
        for lengths in (None, seq):
            outs = {}
            for where, dt in (("cuda", torch.float32),
                              ("cpu", torch.float32),
                              ("cpu", torch.float64)):
                m = copy.deepcopy(net).to(where).to(dt)
                x = torch.tensor(x_np, device=where, dtype=dt,
                                 requires_grad=True)
                sl = None if lengths is None else \
                    torch.from_numpy(lengths).to(where)
                out, _ = m(x, sequence_length=sl)
                (out * torch.from_numpy(g_np).to(where, dt)).sum() \
                    .backward()
                outs[(where, dt)] = [out.detach().cpu(), x.grad.cpu()] + \
                    [p.grad.cpu() for p in m.parameters()]
            card32, cpu32, cpu64 = outs.values()
            worst.append(dev(card32, cpu32) + (cls, lengths is not None))
            for k, got in (("card", card32), ("cpu", cpu32)):
                vs64[k] = tuple(map(max, vs64[k], dev(got, cpu64)))
    out_w = max(worst)
    grad_w = max(worst, key=lambda w: w[1])
    print(f"seq: LSTM / GRU / SimpleRNN, 2 bidirectional layers, 8 x 50 x "
          f"64 -> 128, with and without sequence_length, card vs CPU: "
          f"outputs worst {out_w[0]:.3g} ({out_w[2]}, sequence_length="
          f"{out_w[3]}; tol {SEQ_TOL} (1 + |ref|)), gradients worst "
          f"{grad_w[1]:.3g} ({grad_w[2]}, sequence_length={grad_w[3]}; tol "
          f"{RNN_GRAD_TOL} (1 + |ref|)); against float64 on the CPU, "
          f"outputs / gradients worst: the card {vs64['card'][0]:.3g} / "
          f"{vs64['card'][1]:.3g}, the CPU {vs64['cpu'][0]:.3g} / "
          f"{vs64['cpu'][1]:.3g} [{card}]", flush=True)
    check(out_w[0] <= SEQ_TOL and grad_w[1] <= RNN_GRAD_TOL,
          f"seq: RNN card vs CPU {out_w} {grad_w}")


def lstm_kernels(torch, fn):
    """The recurrent kernels in the device trace of fn(): {name: (ms,
    launches)} of the kernels whose names speak of an RNN or LSTM."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        low = e.key.lower()
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                ("rnn" in low or "lstm" in low):
            out[e.key[:90]] = (e.self_device_time_total / 1e3, e.count)
    return out


def config4_phase(pt, torch, np, card):
    """Slice 13, BASELINE config 4 through the deploy path on the card:
    PP-OCRv3 rec and PP-YOLOE-s at bench.py's sizes, exported fp32 (against
    the live layer on the CPU) and bf16 (against fp32), their rates, MFU,
    memory, idle share and device time against the live layer; the CTC
    loss and three OCR training steps card against CPU; yolo_box and nms on
    the detector's heads; every vision op and the six small-net families
    card against CPU."""
    import tempfile
    from paddle_tpu_torch.utils import bench
    t_phase = time.time()
    pt.set_device("gpu")
    work = tempfile.TemporaryDirectory(prefix="config4_")
    heads = None
    try:
        for name in ("ocr_rec_infer", "yoloe_infer"):
            r = config4_arm(pt, torch, np, card, bench, name, work.name)
            if name == "yoloe_infer":
                heads = r
    finally:
        work.cleanup()
    detection_ops(pt, torch, np, card, heads)
    del heads
    torch.cuda.empty_cache()
    ctc_and_ocr_training(pt, torch, np, card)
    vision_ops_checks(pt, torch, np, card)
    small_net_checks(pt, torch, np, card)
    print(f"config4: phase wall {time.time() - t_phase:.1f} s [{card}]",
          flush=True)


def config4_arm(pt, torch, np, card, bench, name, workdir):
    """One config-4 model: the fp32 artifact at a small batch against the
    live layer on the CPU; fp32 and bf16 artifacts at bench.py's batch,
    bf16 against fp32; rates, MFU, peak memory, idle share and device busy
    against the live layer. Returns the fp32 artifact's outputs at the
    check batch (YOLOE's heads feed the detection ops)."""
    pt.seed(SEED)
    net, shape, precision, variant, _ = bench.config4_model(pt, name)
    net.eval()
    check_b = OCR_CHECK_B if name == "ocr_rec_infer" else YOLOE_CHECK_B
    rng = np.random.default_rng(SEED)
    x = rng.random(shape, dtype=np.float32)
    xc = x[:check_b]
    pred, export_s, _ = deploy_saved(
        pt, net, os.path.join(workdir, f"{name}_check"),
        (check_b,) + shape[1:], "float32", None)
    got = [torch.as_tensor(o) for o in pred.run([xc])]
    with torch.inference_mode():
        ref = copy.deepcopy(net).cpu()(torch.from_numpy(xc))
    ref = ref if isinstance(ref, list) else [ref]
    errs = [rel_l2(g, r) for g, r in zip(got, ref)]
    print(f"config4: {variant} fp32 artifact (exported on the card in "
          f"{export_s:.1f} s) at batch {check_b} vs the live layer on the "
          f"CPU: relative L2 {[f'{e:.3g}' for e in errs]} (tol "
          f"{DEPLOY_TOL}, TF32 off) [{card}]", flush=True)
    check(len(got) == len(ref) and max(errs) <= DEPLOY_TOL,
          f"config4: {name} fp32 artifact vs CPU {errs}")
    heads = got
    del pred, ref

    flops_img = bench.model_flops(net, (1,) + shape[1:])
    live = {"float32": (net, torch.from_numpy(x).cuda())}
    live["bfloat16"] = (copy.deepcopy(net).to(torch.bfloat16),
                        live["float32"][1].bfloat16())
    outs, rows = {}, {}
    for prec in ("float32", "bfloat16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pred, export_s, _ = deploy_saved(
            pt, net, os.path.join(workdir, f"{name}_{prec}"), shape,
            "float32", None if prec == "float32" else prec)
        if name == "ocr_rec_infer":
            nodes = [str(n.target) for n in
                     pred._translated.program().graph.nodes]
            n_lstm = nodes.count("aten.lstm.input")
            check(n_lstm == 2, f"config4: {prec} OCR program holds "
                  f"{n_lstm} aten.lstm.input nodes, want 2")
        rate, spread = bench.predictor_rate(pred, x, C4_RUNS, C4_REPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        outs[prec] = [torch.as_tensor(o).float().cpu()
                      for o in pred.run([x])]
        busy, idle, wall = busy_ms(torch, pred.run, C4_RUNS)
        layer, xin = live[prec]
        feeds = [pred._feeds[n] for n in pred.get_input_names()]

        def eager(layer=layer, xin=xin):
            with torch.inference_mode():
                return layer(xin)

        def program(tl=pred._translated, feeds=feeds):
            with torch.inference_mode():
                return tl._run(feeds)

        live_busy = busy_ms(torch, eager, C4_RUNS)[0]
        # the loaded program run eagerly: the same op sequence as a
        # replay, without the graph
        prog_busy = busy_ms(torch, program, C4_RUNS)[0]
        rnn = lstm_kernels(torch, pred.run) \
            if name == "ocr_rec_infer" else {}
        rows[prec] = dict(rate=rate, spread=spread, busy=busy, idle=idle,
                          wall=wall, peak=peak, export_s=export_s,
                          live_busy=live_busy, prog_busy=prog_busy, rnn=rnn,
                          mfu=rate * flops_img / PEAK_BF16)
        del pred
        torch.cuda.empty_cache()
    for prec, row in rows.items():
        share = row["prog_busy"] / row["live_busy"]
        rnn = "" if not row["rnn"] else \
            f"; recurrent kernels per run {row['rnn']}"
        print(f"config4: {variant} {prec} artifact, batch {shape[0]}: "
              f"{row['rate']:.1f} imgs/s (spread {row['spread']:.3f}, "
              f"{C4_RUNS} runs x {C4_REPS}), MFU {row['mfu']:.4f} "
              f"({flops_img / 1e9:.4f} GFLOP per image), device busy per "
              f"run: replay {row['busy']:.3f} ms, the program eagerly "
              f"{row['prog_busy']:.3f}, the live layer "
              f"{row['live_busy']:.3f} (program / live {share:.4f}, tol 1 "
              f"+- {DEPLOY_DEVICE_SHARE}; replay / live "
              f"{row['busy'] / row['live_busy']:.4f}), idle share "
              f"{row['idle']:.4f} over {C4_RUNS} run()s, peak "
              f"{row['peak']:.2f} GiB, export {row['export_s']:.1f} s"
              f"{rnn} [{card}]", flush=True)
        if name == "ocr_rec_infer":
            check(abs(share - 1) <= DEPLOY_DEVICE_SHARE,
                  f"config4: {prec} OCR program {row['prog_busy']} ms vs "
                  f"live {row['live_busy']} ms per batch")
    errs = [float((b - a).abs().max() / a.abs().max())
            for a, b in zip(outs["float32"], outs["bfloat16"])]
    print(f"config4: {variant} bf16 vs fp32 at batch {shape[0]}, per "
          f"output max|got - ref| / max|ref| {[f'{e:.4g}' for e in errs]} "
          f"(tol {DEPLOY_QUANT_TOL}) [{card}]", flush=True)
    check(all(torch.isfinite(o).all() for o in outs["bfloat16"]) and
          max(errs) < DEPLOY_QUANT_TOL, f"config4: {name} bf16 vs fp32 "
          f"{errs}")
    return heads


def detection_ops(pt, torch, np, card, heads):
    """yolo_box on the detector's three fp32 heads (NHWC -> NCHW) on the
    card and on the CPU, then nms of one image's boxes: the same boxes and
    the same kept indices."""
    from paddle_tpu_torch.vision import ops
    anchors = ([10, 13], [30, 61], [116, 90])
    boxes, scores = {}, {}
    for where in ("cuda", "cpu"):
        bs, ss = [], []
        for h, anc, ratio in zip(heads, anchors, (8, 16, 32)):
            b, s = ops.yolo_box(h.to(where).permute(0, 3, 1, 2), None, anc,
                                80, 0.01, ratio)
            bs.append(b)
            ss.append(s)
        boxes[where] = torch.cat(bs, 1)
        scores[where] = torch.cat(ss, 1)
    err = max(float(((boxes["cuda"].cpu() - boxes["cpu"]).abs()
                      / (1 + boxes["cpu"].abs())).max()),
              float(((scores["cuda"].cpu() - scores["cpu"]).abs()
                     / (1 + scores["cpu"].abs())).max()))
    score0 = scores["cuda"][0].max(-1).values
    keep = ops.nms(boxes["cuda"][0], 0.5, score0, top_k=100)
    keep_cpu = ops.nms(boxes["cuda"][0].cpu(), 0.5, score0.cpu(), top_k=100)
    same = torch.equal(keep.cpu(), keep_cpu)
    print(f"config4: yolo_box on the three heads ({boxes['cuda'].shape[1]} "
          f"boxes per image) card vs CPU {err:.3g} (tol {SEQ_TOL} "
          f"(1 + |ref|)); nms of image 0 (IoU 0.5, top 100) on the card's "
          f"tensors and on their CPU copies: {len(keep)} kept, the same "
          f"indices {same} [{card}]", flush=True)
    check(err <= SEQ_TOL and same and keep.device.type == "cuda",
          f"config4: detection ops {err} {same}")


def ctc_and_ocr_training(pt, torch, np, card):
    """F.ctc_loss forward and backward at the OCR head's shapes, card
    against CPU; three SGD steps of PPOCRRec.loss, card against CPU."""
    F = pt.nn.functional
    rng = np.random.default_rng(SEED)
    logits = rng.standard_normal((CTC_T, CTC_B, CTC_C)).astype(np.float32)
    lab_len = rng.integers(1, CTC_L + 1, CTC_B)
    labels = rng.integers(1, CTC_C, (CTC_B, CTC_L)).astype(np.int32)
    in_len = np.full(CTC_B, CTC_T)
    in_len[::4] = rng.integers(2 * CTC_L + 1, CTC_T, len(in_len[::4]))
    res = {}
    for where in ("cuda", "cpu"):
        x = torch.tensor(logits, device=where, requires_grad=True)
        loss = F.ctc_loss(x, torch.from_numpy(labels).to(where), in_len,
                          lab_len, reduction="none")
        loss.sum().backward()
        res[where] = (loss.detach().cpu(), x.grad.cpu())
    errs = [float(((a.cpu() - b).abs() / (1 + b.abs())).max())
            for a, b in zip(res["cuda"], res["cpu"])]
    print(f"config4: ctc_loss T {CTC_T}, batch {CTC_B}, {CTC_C} classes, "
          f"labels of 1-{CTC_L}, {int((in_len < CTC_T).sum())} shorter "
          f"inputs: card vs CPU loss {errs[0]:.3g}, gradient {errs[1]:.3g} "
          f"(tol {SEQ_TOL} (1 + |ref|)) [{card}]", flush=True)
    check(max(errs) <= SEQ_TOL, f"config4: ctc card vs CPU {errs}")
    del res

    pt.seed(SEED)
    net = pt.models.pp_ocrv3_rec(n_classes=6625, scale=0.5, hidden_size=48)
    x = rng.random((OCR_TRAIN_B, 32, 320, 3), dtype=np.float32)
    labels = rng.integers(1, 6625, (OCR_TRAIN_B, 12)).astype(np.int32)
    lab_len = np.array([12, 5, 9, 1])
    losses = {}
    for where in ("cuda", "cpu"):
        m = copy.deepcopy(net).to(where)
        opt = pt.optimizer.SGD(learning_rate=0.05,
                               parameters=m.parameters())
        xs, ls = torch.from_numpy(x).to(where), \
            torch.from_numpy(labels).to(where)
        out = []
        for _ in range(3):
            loss = m.loss(m(xs), ls, lab_len)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.detach()))
        losses[where] = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    print(f"config4: PPOCRRec.loss, 3 SGD steps at batch {OCR_TRAIN_B}: "
          f"card {[round(v, 5) for v in losses['cuda']]}, CPU "
          f"{[round(v, 5) for v in losses['cpu']]}, max rel diff {rel:.3g} "
          f"(tol {OCR_TRAIN_TOL}) [{card}]", flush=True)
    check(rel <= OCR_TRAIN_TOL, f"config4: OCR training card vs CPU {rel}")


def _card_vs_cpu(torch, fn, arrays, grads=()):
    """fn on the card and on the CPU from the same numpy arrays: the worst
    (1 + |ref|) deviation over the outputs and the gradients of
    sum(out * 1.5) for the arrays at `grads`."""
    res = {}
    for where in ("cuda", "cpu"):
        ts = [torch.tensor(a, device=where,
                           requires_grad=i in grads and a.dtype.kind == "f")
              for i, a in enumerate(arrays)]
        out = fn(*ts)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        if grads:
            sum((o.float() * 1.5).sum() for o in out).backward()
        res[where] = [o.detach().cpu() for o in out] + \
            [ts[i].grad.cpu() for i in grads]
    return max(float(((a.double() - b.double()).abs()
                      / (1 + b.double().abs())).max())
               for a, b in zip(res["cuda"], res["cpu"]))


def vision_ops_checks(pt, torch, np, card):
    """Every vision op but decode_jpeg (PIL is not on the card's machine)
    on the card against the CPU at small sizes; the backward of
    deform_conv2d, roi_align, roi_pool, psroi_pool and yolo_loss."""
    from paddle_tpu_torch.vision import ops
    rng = np.random.default_rng(SEED)

    def n(*s):
        return rng.standard_normal(s).astype(np.float32)

    xy = rng.uniform(0, 8, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 6, (6, 2))], 1) \
        .astype(np.float32)
    bn = torch.tensor([2, 4])
    scores = rng.uniform(size=6).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.1, 0.9, (2, 3, 2)),
                         rng.uniform(0.05, 0.5, (2, 3, 2))], -1) \
        .astype(np.float32)
    labels = rng.integers(0, 3, (2, 3)).astype(np.int32)
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        f.write(rng.integers(0, 255, 64, dtype=np.uint8).tobytes())
        f.flush()
        raw = ops.read_file(f.name)
    cases = {
        "nms": (lambda b, s: ops.nms(b, 0.3, s), [boxes, scores], ()),
        "box_iou": (ops.box_iou, [boxes, boxes[::-1].copy()], ()),
        "yolo_box": (lambda a: ops.yolo_box(a, None, [10, 13, 16, 30], 3,
                                            0.5, 8), [n(2, 16, 4, 5)], ()),
        "roi_align": (lambda a, b: ops.roi_align(a, b, bn, 3),
                      [n(2, 3, 12, 12), boxes], (0,)),
        "deform_conv2d": (lambda a, o, w, b, m: ops.deform_conv2d(
            a, o, w, b, 1, 1, 1, 2, 1, m),
            [n(2, 4, 7, 6), n(2, 36, 7, 6), n(6, 4, 3, 3), n(6),
             rng.uniform(size=(2, 18, 7, 6)).astype(np.float32)],
            (0, 1, 2, 3, 4)),
        "roi_pool": (lambda a, b: ops.roi_pool(a, b, bn, (3, 2)),
                     [n(2, 3, 12, 12), boxes], (0,)),
        "psroi_pool": (lambda a, b: ops.psroi_pool(a, b, bn, 2),
                       [n(2, 12, 12, 12), boxes], (0,)),
        "yolo_loss": (lambda a, g, lab: ops.yolo_loss(
            a, g, lab, [10, 13, 16, 30, 33, 23], [1, 2], 3, 0.5, 32),
            [n(2, 16, 5, 6) * 0.5, gt, labels], (0,)),
    }
    errs = {k: _card_vs_cpu(torch, fn, arrays, grads)
            for k, (fn, arrays, grads) in cases.items()}
    check(raw.device.type == "cuda" and raw.numel() == 64 and
          raw.dtype == torch.uint8, f"config4: read_file {raw}")
    print(f"config4: vision.ops card vs CPU (forward; and backward for "
          f"roi_align, deform_conv2d, roi_pool, psroi_pool, yolo_loss): "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol "
          f"{SEQ_TOL} (1 + |ref|)); read_file onto the card [{card}]",
          flush=True)
    check(max(errs.values()) <= SEQ_TOL, f"config4: vision.ops {errs}")


def small_net_checks(pt, torch, np, card):
    """The six small-net families in eval mode at batch 2, card against
    CPU from the same weights."""
    cases = {"alexnet": 224, "squeezenet1_1": 64,
             "shufflenet_v2_x0_25": 64, "densenet121": 64,
             "googlenet": 64, "inception_v3": 107}
    errs = {}
    for name, size in cases.items():
        pt.seed(SEED)
        net = getattr(pt.vision.models, name)(num_classes=10)
        net.eval()
        x = np.random.default_rng(SEED).standard_normal(
            (2, 3, size, size)).astype(np.float32)
        with torch.inference_mode():
            got = net(torch.from_numpy(x).cuda())
            want = copy.deepcopy(net).cpu()(torch.from_numpy(x))
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        errs[name] = max(float(((g.cpu() - w).abs() / (1 + w.abs())).max())
                         for g, w in zip(got, want))
        del net
    print(f"config4: small nets in eval at batch 2, card vs CPU: "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol "
          f"{SEQ_TOL} (1 + |ref|)) [{card}]", flush=True)
    check(max(errs.values()) <= SEQ_TOL, f"config4: small nets {errs}")


def _span_means(docs):
    """name -> mean seconds of the spans of that name over trace docs."""
    acc = {}
    for d in docs:
        for s in d["spans"]:
            acc.setdefault(s["name"], []).append(s["t1"] - s["t0"])
    return {k: statistics.mean(v) for k, v in acc.items()}


def server_phase(pt, fa, torch, np, card, gpt2_path):
    """Slice 14 on the card: GPT-2 small's bf16 artifact (the deploy
    phase's) behind PredictorServer, with the monitor, tracing, the memory
    census, the flight recorder and an SLO on: 4 PredictorClient threads x
    2 traced 'PDRQ' requests of 1 x 1024 ids (each reply 1 x 1024 x 50257
    f32 logits) against the live-layer Predictor, one complete trace per
    request, the C client (built from csrc/ by paddle_tpu_torch._native)
    byte-equal to PredictorClient, a 'PDSQ' stream through LLMEngine
    (gpt2_small fp32, 16 slots x 1024 rows), an injected dispatch fault,
    an overload burst with its flight-recorder dump, the 'PDHQ' health
    JSON, the Prometheus text, the census against memory_allocated, and
    'PDDR'. Returns the flash forward's host launches."""
    import gc
    import socket
    import tempfile
    from paddle_tpu_torch import _native, monitor, obs
    from paddle_tpu_torch.inference.server import (PredictorClient,
                                                   PredictorServer)
    from paddle_tpu_torch.obs import memory, trace
    from paddle_tpu_torch.utils.train_profile import (graph_kernel_names,
                                                      kernel_counts)
    t_phase = time.perf_counter()
    pt.set_device("gpu")
    dumps = tempfile.TemporaryDirectory(prefix="flightrec_")
    pt.set_flags({"FLAGS_monitor": True, "FLAGS_trace": True,
                  "FLAGS_mem_census": True,
                  "FLAGS_obs_flight_recorder": True,
                  "FLAGS_obs_dump_dir": dumps.name,
                  "FLAGS_slo_latency_ms": SERVER_SLO_MS,
                  "FLAGS_slo_target": 0.99})
    for plane in (monitor, trace, memory, obs):
        plane.reset()
    servers, clients = [], []
    try:
        pt.seed(SEED)
        lm = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
        lm.eval()
        n_layers = len(lm.gpt.layers)
        vocab = lm.gpt.embeddings.word_embeddings.weight.shape[0]
        cfg = pt.inference.Config(gpt2_path)
        cfg.enable_use_gpu(device_id=0)
        pred = pt.inference.create_predictor(cfg)
        llm = pt.serving.LLMEngine(copy.deepcopy(lm), pt.serving.LLMConfig(
            num_slots=LLM_SLOTS, max_len=LLM_MAX_LEN,
            max_new_tokens=SERVER_NEW))
        engine = pt.serving.ServingEngine(pred, pt.serving.EngineConfig(
            max_batch_size=4, batch_timeout_ms=20.0))
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        with kept_graphs(torch):
            srv = PredictorServer(pred, engine=engine, llm_engine=llm)
            servers.append(srv)
            srv.start()       # warm-up: the artifact's eager run + capture
        start_s = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches
        caps = pred._translated.captures()
        check(len(caps) == 1, f"server: {len(caps)} captures of GPT-2's "
              "program")
        nodes = kernel_counts(graph_kernel_names(caps[0].graph))["flash_fwd"]
        check(launches == 2 * n_layers and nodes == n_layers,
              f"server: {launches} flash host launches at warm-up (want "
              f"{2 * n_layers}: the eager run and the capture), {nodes} "
              f"flash nodes in the captured graph (want {n_layers})")
        cap_mem = obs.executable_memory(caps[0])

        # ---- row 1 on the wire: 4 threads x 2 traced requests ----
        rng = np.random.default_rng(SEED)
        reqs = [[rng.integers(0, vocab, (1, 1024)).astype(np.int32)
                 for _ in range(2)] for _ in range(SERVER_THREADS)]
        results = [[None, None] for _ in range(SERVER_THREADS)]
        walls, errors = [], []

        def client(k):
            try:
                c = PredictorClient(srv.host, srv.port, timeout=300)
                clients.append(c)
                for j, ids in enumerate(reqs[k]):
                    t = time.perf_counter()
                    results[k][j] = c.run([ids])
                    walls.append(time.perf_counter() - t)
            except Exception as e:  # noqa: BLE001 — read after the join
                errors.append(f"{type(e).__name__}: {e}")

        batches0 = engine.stats()["counters"]["batches"]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(SERVER_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wire_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads),
              f"server: client threads {errors}")
        batches = engine.stats()["counters"]["batches"] - batches0
        check(fa.flash_attention_fwd.launches == launches,
              "server: a replay launched the flash kernel from the host")
        live = pt.inference.Predictor(
            copy.deepcopy(lm).to(torch.bfloat16),
            input_spec=[pt.InputSpec([4, 1024], "int32")])
        t_live = time.perf_counter()
        live.run_batch([reqs[0][0]])
        print(f"server: the live layer's Predictor through to_static: "
              f"first 1 x 1024 batch (export + eager run + capture) "
              f"{time.perf_counter() - t_live:.2f} s [{card}]", flush=True)
        worst = 0.0
        for k in range(SERVER_THREADS):
            for j in range(2):
                status, outs = results[k][j]
                got = outs[0] if status == 0 else None
                check(status == 0 and got.shape == (1, 1024, vocab) and
                      got.dtype == np.float32 and np.isfinite(got).all(),
                      f"server: request {k}.{j} status {status}")
                ref = live.run_batch([reqs[k][j]])[0]
                worst = max(worst, float(np.abs(got - ref).mean()
                                         / np.abs(ref).mean()))
        del live, results
        check(worst <= 2e-2, f"server: replies vs the live layer {worst}")

        # ---- one trace per request ----
        docs = trace.traces()
        roots = [d for d in docs if any(s["name"] == "client.send"
                                        for s in d["spans"])]
        check(len(roots) == 2 * SERVER_THREADS and trace.active_depth() == 0,
              f"server: {len(roots)} traces for {2 * SERVER_THREADS} "
              f"requests, {trace.active_depth()} spans open")
        want = {"client.send", "serving.request", "serving.queue_wait",
                "serving.dispatch", "serving.reply"}
        n_batch_spans = 0
        for d in roots:
            names = [s["name"] for s in d["spans"]]
            ids = {s["span_id"] for s in d["spans"]}
            check(want <= set(names) and len(names) == len(set(names)) and
                  all(s["t1"] is not None for s in d["spans"]) and
                  all(s["parent_id"] in ids for s in d["spans"]
                      if s["name"] != "client.send"),
                  f"server: trace {d['trace_id']}: {names}")
            n_batch_spans += names.count("serving.batch")
        check(n_batch_spans == batches, f"server: {n_batch_spans} batch "
              f"spans for {batches} batches")
        means = _span_means(roots)

        # ---- the C client, byte-equal to PredictorClient ----
        one = reqs[0][0]
        c = PredictorClient(srv.host, srv.port, timeout=300)
        clients.append(c)
        status, want_out = c.run([one])
        rc, got = _native.run(srv.host, srv.port, [one])
        rc2, got2 = _native.run(srv.host, srv.port, [one],
                                deadline_ms=60000)
        check(status == 0 and rc == 0 and rc2 == 0 and
              got[0].tobytes() == want_out[0].tobytes() and
              got2[0].tobytes() == want_out[0].tobytes(),
              f"server: C client rc {rc} / {rc2} against PredictorClient "
              f"{status}: bytes equal "
              f"{rc == 0 and got[0].tobytes() == want_out[0].tobytes()}")
        del got, got2, want_out

        # ---- 'PDSQ' through LLMEngine ----
        prompt = rng.integers(0, vocab, 64).tolist()
        seen = []
        status, toks = c.generate(prompt, SERVER_NEW,
                                  on_token=lambda i, t: seen.append((i, t)))
        direct = llm.submit(prompt, SERVER_NEW).result(300)
        check(status == 0 and len(toks) == SERVER_NEW and
              seen == list(enumerate(toks)) and direct == ("done", toks),
              f"server: 'PDSQ' status {status}, {len(toks)} tokens, in "
              f"order {seen == list(enumerate(toks))}, equal to the engine's "
              f"{direct[1] == toks}")

        # ---- an injected dispatch fault, then service as before ----
        pt.set_flags({"FLAGS_fault_inject": "serving.dispatch:error:times=1"})
        s1, msg = c.run([one])
        s2, _ = c.run([one])
        pt.set_flags({"FLAGS_fault_inject": ""})
        check(s1 == 1 and "serving.dispatch" in msg and s2 == 0,
              f"server: fault statuses {s1}, {s2}")

        # ---- overload: a queue of depth 1 and a burst ----
        burst = PredictorServer(pred, engine=pt.serving.ServingEngine(
            pred, pt.serving.EngineConfig(max_batch_size=4, queue_depth=1,
                                          warmup_on_start=False)))
        servers.append(burst)
        burst.start()
        statuses = []

        def burst_client():
            try:
                bc = PredictorClient(burst.host, burst.port, timeout=300)
                clients.append(bc)
                statuses.append(bc.run([one])[0])
            except Exception as e:  # noqa: BLE001 — read after the join
                errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=burst_client, daemon=True)
                   for _ in range(SERVER_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        burst.drain()
        files = [f for f in os.listdir(dumps.name) if f.endswith(".json")]
        reason = json.load(open(os.path.join(dumps.name, files[0])))[
            "reason"] if len(files) == 1 else None
        check(not errors and 2 in statuses and set(statuses) <= {0, 2} and
              reason == "serving_overload",
              f"server: burst statuses {sorted(statuses)} {errors}, dumps "
              f"{files} (reason {reason})")

        # ---- health, Prometheus, the census ----
        h = c.health()
        check(h["counters"]["completed"] >= 2 * SERVER_THREADS + 3 and
              set(h["slo"]["burn"]) == {"60", "300", "3600"} and
              h["monitor"]["counters"]["serving.completed"] >=
              h["counters"]["completed"] and h["llm"]["counters"][
                  "completed"] == 2,
              f"server: 'PDHQ' {sorted(h)}")
        text = monitor.prometheus_text().splitlines()
        fams = [ln.split()[2:4] for ln in text if ln.startswith("# TYPE")]
        single = [n for n, kind in fams if kind in ("counter", "gauge")]
        samples = {}
        for ln in text:
            if not ln.startswith("#"):
                name = ln.split("{")[0].split()[0]
                samples[name] = samples.get(name, 0) + 1
        check(len({n for n, _ in fams}) == len(fams) and
              all(samples.get(n) == 1 for n in single),
              "server: a Prometheus family without exactly one sample")
        gc.collect()
        torch.cuda.synchronize()
        rec = memory.census()
        allocated = torch.cuda.memory_allocated()
        pool = monitor.snapshot()["gauges"].get("mem.serving_bucket.bytes", 0)
        check(pool > 0 and rec["tagged_bytes"] <= rec["total_bytes"] <=
              allocated, f"server: census {rec['total_bytes']} (tagged "
              f"{rec['tagged_bytes']}) vs memory_allocated {allocated}, "
              f"mem.serving_bucket.bytes {pool}")

        # ---- 'PDDR': drained, then refused ----
        report = c.drain()
        refused = False
        try:
            socket.create_connection((srv.host, srv.port), timeout=5).close()
        except OSError:
            refused = True
        check(report.get("drained") and refused,
              f"server: drain report {report}, connect refused {refused}")
        walls.sort()
        rps = 2 * SERVER_THREADS / wire_s
        reply_mb = 1024 * vocab * 4 / 1e6
        print(f"server: GPT-2 small bf16 artifact behind PredictorServer "
              f"(start with warm-up and capture {start_s:.2f} s): "
              f"{2 * SERVER_THREADS} traced 'PDRQ' requests of 1 x 1024 ids "
              f"from {SERVER_THREADS} threads in {wire_s:.3f} s "
              f"({rps:.2f} requests/s, {batches} batches), wall per request "
              f"p50 {walls[len(walls) // 2] * 1e3:.1f} ms p99 (the max of "
              f"{len(walls)}) {walls[-1] * 1e3:.1f} ms; span means ms: "
              + ", ".join(f"{k.split('.')[-1]} {means[k] * 1e3:.2f}" for k in
                          ("serving.queue_wait", "serving.batch",
                           "serving.dispatch", "serving.reply",
                           "client.send") if k in means)
              + f"; the {reply_mb:.1f} MB reply write is "
              f"{means['serving.reply'] / means['client.send']:.3f} of the "
              f"client's wall; replies vs the live layer max relative "
              f"mean-abs error {worst:.3g} (tol 2e-2); {launches} flash host "
              f"launches at warm-up, {nodes} flash nodes a replay, so "
              f"{nodes * batches} flash forwards for the {batches} batches; "
              f"capture memory {cap_mem} [{card}]", flush=True)
        print(f"server: C client (PD_PredictorRun, PD_PredictorRunWith"
              f"Deadline) byte-equal to PredictorClient; 'PDSQ' "
              f"{SERVER_NEW} tokens in order, equal to LLMEngine.submit; "
              f"fault statuses {s1} then {s2}; burst statuses "
              f"{sorted(statuses)} with one dump ({files[0]}); census "
              f"{rec['total_bytes']} B of {allocated} B allocated, tagged "
              f"{ {k: v['bytes'] for k, v in rec['tags'].items()} }; "
              f"'PDDR' drained, connect refused; phase "
              f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
        return launches
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.stop(drain=False)
        pt.set_flags({"FLAGS_monitor": False, "FLAGS_trace": False,
                      "FLAGS_mem_census": False,
                      "FLAGS_obs_flight_recorder": False,
                      "FLAGS_obs_dump_dir": "flight_recorder",
                      "FLAGS_slo_latency_ms": 0.0, "FLAGS_fault_inject": ""})
        for plane in (monitor, trace, memory, obs):
            plane.reset()
        dumps.cleanup()
        torch.cuda.empty_cache()


def obs_phase(pt, fa, torch, np, card):
    """Slice 14's plane in TrainStep: 5 __call__ steps of gpt2_small at
    8 x 1024 in bf16 AMP under FLAGS_obs_timeline and FLAGS_mem_census,
    then run() over 6 steps (the capture and 5 replays): every steady step's
    phases cover its wall within [0.95, 1.05], device_compute the largest;
    the census's params, opt_slots and activations; 12 + 12 flash launches
    per eager step and 12 + 12 kernel nodes per replay. Returns the flash
    host launches."""
    from paddle_tpu_torch import monitor, obs
    from paddle_tpu_torch.obs import memory
    from paddle_tpu_torch.utils.train_profile import (graph_kernel_names,
                                                      kernel_counts)
    t_phase = time.perf_counter()
    pt.set_device("gpu")
    pt.set_flags({"FLAGS_monitor": True, "FLAGS_obs_timeline": True,
                  "FLAGS_mem_census": True})
    for plane in (monitor, memory, obs):
        plane.reset()
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused)
    try:
        pt.seed(SEED)
        model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
        n_layers = len(model.gpt.layers)
        vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
        step = pt.jit.TrainStep(model, pt.models.GPTPretrainingCriterion(),
                                opt, amp_dtype="bfloat16")
        ids = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, vocab, (TRAIN_B, TRAIN_S))).cuda()
        torch.cuda.synchronize()
        for c in counted:
            c.launches = 0
        for _ in range(OBS_STEPS):
            step(ids, ids)
        eager = [c.launches for c in counted]
        steps = monitor.snapshot()["counters"].get("jit.train_step.steps")
        rec = memory.census()
        xs = ids.expand(OBS_STEPS + 1, TRAIN_B, TRAIN_S).contiguous()
        n_before = len(obs.timeline().records())
        with kept_graphs(torch):
            losses = step.run(xs, xs)
        torch.cuda.synchronize()
        per_step = kernel_counts(graph_kernel_names(
            next(iter(step._graphs.values())).graph))
        launches = [c.launches for c in counted]
        recs = obs.timeline().records()
        calls, runs = recs[:OBS_STEPS], recs[n_before:]

        def cov(r):
            return sum(r["phases"].values()) / r["wall"]

        steady = calls[1:] + runs[1:]
        for r in steady:
            top = max(r["phases"], key=r["phases"].get)
            check(0.95 <= cov(r) <= 1.05 and top == "device_compute",
                  f"obs: step {r['step']} phases {r['phases']} cover "
                  f"{cov(r):.4f} of wall {r['wall']}")
        check(len(calls) == OBS_STEPS and "trace_compile" in
              calls[0]["phases"] and len(runs) == OBS_STEPS + 1 and
              "trace_compile" in runs[0]["phases"],
              f"obs: {len(calls)} __call__ records, {len(runs)} run() "
              "records")
        check(steps == OBS_STEPS and all(
            rec["tags"].get(t, {}).get("bytes", 0) > 0
            for t in ("params", "opt_slots", "activations")),
            f"obs: steps counter {steps}, census tags "
            f"{sorted(rec['tags'])}")
        check(eager == [OBS_STEPS * n_layers] * 2 and
              launches == [(OBS_STEPS + 2) * n_layers] * 2 and
              per_step["flash_fwd"] == n_layers and
              per_step["flash_bwd_fused"] == n_layers and
              bool(torch.isfinite(losses).all()),
              f"obs: flash launches {eager} after the eager steps, "
              f"{launches} after run() (the capture's eager step and "
              f"capture), graph nodes {per_step}")
        phases = {}
        for r in steady:
            for k, v in r["phases"].items():
                phases.setdefault(k, []).append(v * 1e3)
        print(f"obs: gpt2_small {TRAIN_B}x{TRAIN_S} bf16 AMP, {OBS_STEPS} "
              f"__call__ steps + run() of {OBS_STEPS + 1} (capture + "
              f"{OBS_STEPS} replays) under FLAGS_obs_timeline: phase "
              f"coverage of steady steps __call__ "
              f"{[round(cov(r), 4) for r in calls[1:]]}, run() "
              f"{[round(cov(r), 4) for r in runs[1:]]} (tol [0.95, 1.05]); "
              f"mean ms per steady phase "
              f"{ {k: round(statistics.mean(v), 3) for k, v in phases.items()} }"
              f"; wall ms __call__ "
              f"{statistics.mean(r['wall'] for r in calls[1:]) * 1e3:.2f}, "
              f"replay {statistics.mean(r['wall'] for r in runs[1:]) * 1e3:.2f}"
              f"; census tags (B) "
              f"{ {k: v['bytes'] for k, v in rec['tags'].items()} }; flash "
              f"host launches {launches}, kernel nodes a replay {per_step}; "
              f"phase {time.perf_counter() - t_phase:.1f} s [{card}]",
              flush=True)
        return dict(zip(("flash_fwd", "flash_bwd_fused"), launches))
    finally:
        pt.set_flags({"FLAGS_monitor": False, "FLAGS_obs_timeline": False,
                      "FLAGS_mem_census": False})
        for plane in (monitor, memory, obs):
            plane.reset()
        torch.cuda.empty_cache()


def dist_collectives(dist, torch, np, dev, r, w):
    """Every collective of parallel.collective on this rank's CUDA tensors
    (rank i's input from default_rng(SEED + i), integer-valued), each
    held against the value computed from every rank's input: exact in
    f32, 1e-2 relative in bf16. Returns {check: max relative error}."""
    n = 4 * w
    ins = [np.random.default_rng(SEED + i).integers(1, 4, n).astype(
        np.float32) for i in range(w)]
    errs = {}

    def held(name, got, want, dtype):
        got = got.float().cpu().numpy()
        want = np.asarray(want, np.float32)
        err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                            1e-6)))
        errs[name] = max(errs.get(name, 0.0), err)
        tol = 0.0 if dtype == torch.float32 else 1e-2
        check(got.shape == want.shape and err <= tol,
              f"dist: {name} {dtype} rank {r}: err {err} (tol {tol})")

    stack = np.stack(ins)
    ops = {"SUM": stack.sum(0), "MAX": stack.max(0), "MIN": stack.min(0),
           "PROD": stack.prod(0), "AVG": stack.mean(0)}
    for dtype in (torch.float32, torch.bfloat16):
        def mine():
            return torch.from_numpy(ins[r].copy()).to(dev, dtype)
        for name, want in ops.items():
            t = mine()
            dist.all_reduce(t, op=getattr(dist.ReduceOp, name))
            held(f"all_reduce_{name}", t, want, dtype)
        held("all_gather", dist.all_gather(None, mine()), stack, dtype)
        held("reduce_scatter", dist.reduce_scatter(None, mine()),
             stack.sum(0).reshape(w, -1)[r], dtype)
        t = mine()
        dist.broadcast(t, src=w - 1)
        held("broadcast", t, ins[w - 1], dtype)
        t = mine()
        dist.reduce(t, dst=0)
        held("reduce", t, stack.sum(0), dtype)
        t = torch.empty(4, dtype=dtype, device=dev)
        dist.scatter(t, list(mine().reshape(w, 4)), src=0)
        held("scatter", t, ins[0].reshape(w, 4)[r], dtype)
        held("alltoall", dist.alltoall(list(mine().reshape(w, 4))),
             stack.reshape(w, w, 4)[:, r], dtype)
        held("alltoall_single", dist.alltoall_single(mine()),
             stack.reshape(w, w, 4)[:, r].reshape(-1), dtype)
        held("p2p_shift", dist.p2p_shift(mine(), group=None),
             ins[(r - 1) % w], dtype)
        if w > 1:                        # no rank sends to itself
            got = torch.empty(n, dtype=dtype, device=dev)
            task = dist.isend(mine(), dst=(r + 1) % w)
            dist.recv(got, src=(r - 1) % w)
            task.wait()
            held("send_recv", got, ins[(r - 1) % w], dtype)
    objs = dist.all_gather_object([], {"rank": r})
    check(objs == [{"rank": i} for i in range(w)],
          f"dist: all_gather_object {objs}")
    dist.barrier()
    dist.wait(torch.ones(1, device=dev))
    return errs


def dist_rank(tag, outdir):
    """One rank of the dist phase (see the module docstring, phase 22):
    writes its results to outdir/<tag>_<rank>.json."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist, monitor, obs
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import HybridCommunicateGroup, SPMDTrainStep
    from paddle_tpu_torch.utils import bench
    t0 = time.perf_counter()
    pt.set_flags({"FLAGS_monitor": True, "FLAGS_obs_flight_recorder": True})
    w = int(os.environ["PADDLE_TRAINERS_NUM"])
    strategy = pt.parallel.DistributedStrategy()
    strategy.hybrid_configs["dp_degree"] = w
    hcg = dist.fleet.init(is_collective=True, strategy=strategy)
    r, dev = dist.get_rank(), dist.ParallelEnv().device
    res = {"rank": r, "world": w, "device": str(dev),
           "backend": dist.get_backend()}
    check(dev.type == "cuda" and dist.get_world_size() == w,
          f"dist: rank {r} on {dev}, world {dist.get_world_size()}")
    res["collective_errs"] = dist_collectives(dist, torch, np, dev, r, w)

    # ---- config 3: ERNIE-base, DP over the world, bucketed ----
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, 30522, (FLAGSHIP_B, FLAGSHIP_S))
                           .astype(np.int32)).to(dev)
    nsp = torch.from_numpy(rng.integers(0, 2, (FLAGSHIP_B,)).astype(
        np.int32)).to(dev)
    batch = (ids, ids, nsp)
    pt.seed(SEED)
    step = bench.dp_step(pt, hcg)
    net = step.model
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    ref = bench.flagship_step(pt)
    with torch.no_grad():
        for a, b in zip(ref.model.parameters(), net.parameters()):
            a.copy_(b)
    inputs, labels, _ = ref._prepare(batch, note=False)
    loss_ref, g_ref = ref._loss_and_grads(inputs, labels)
    loss_dp, g_dp = step.loss_and_grads(*batch)
    names = [n for n, _ in net.named_parameters()]
    rel = abs(float(loss_dp) - float(loss_ref)) / abs(float(loss_ref))
    low = sorted((cosine(a.float(), b.float()), n)
                 for a, b, n in zip(g_dp, g_ref, names))
    res["step1"] = {"loss_dp": float(loss_dp), "loss_one": float(loss_ref),
                    "rel_err": rel, "lowest_cosines": low[:3]}
    check(rel <= 1e-3, f"dist: rank {r} step-1 loss rel err {rel}")
    check(low[0][0] >= 0.999, f"dist: rank {r} gradient cosines {low[:3]}")
    # the initial gradient's global norm, for the ZeRO clip check below
    gnorm = float(torch.sqrt(sum(g.float().pow(2).sum() for g in g_dp)))
    res["step1"]["grad_norm"] = gnorm
    del ref, inputs, labels, loss_ref, g_ref, g_dp
    counter = "collective.c_allreduce_bucket.count"
    n_buckets = len(step.reducer.bucket_layout())
    losses, per_step = [], []
    for i in range(DIST_WARM + DIST_STEPS):
        before = monitor.snapshot()["counters"].get(counter, 0)
        losses.append(float(step(*batch)))
        per_step.append(monitor.snapshot()["counters"].get(counter, 0)
                        - before)
        if i == DIST_WARM - 1:
            torch.cuda.synchronize()
            t_steps = time.perf_counter()
    torch.cuda.synchronize()
    res["dp"] = {"losses": losses, "n_buckets": n_buckets,
                 "buckets_per_step": per_step,
                 "ms_per_step": (time.perf_counter() - t_steps) / DIST_STEPS
                 * 1e3,
                 "memory_allocated": torch.cuda.memory_allocated(dev),
                 "slot_bytes": step.memory_report(*batch)["slot_bytes"]}
    check(losses[-1] < losses[0] and all(np.isfinite(losses)),
          f"dist: rank {r} DP losses {losses}")
    check(per_step == [n_buckets] * len(per_step),
          f"dist: rank {r} c_allreduce_bucket per step {per_step}, "
          f"{n_buckets} buckets")
    sums = torch.stack([torch.stack([
        p.detach().view(torch.int32).sum(dtype=torch.int64).double(),
        p.detach().double().sum()]) for p in net.parameters()])
    gathered = dist.all_gather(None, sums)
    res["dp"]["bit_equal"] = bool((gathered == gathered[0]).all())
    check(res["dp"]["bit_equal"], f"dist: rank {r} parameters differ "
          "across ranks")
    dump = obs.recorder().payload(reason="dist")
    names_seen = [c[1] for c in dump["collectives"]]
    res["dp"]["recorded_buckets"] = names_seen.count("c_allreduce_bucket")
    check(res["dp"]["recorded_buckets"] >= n_buckets and all(
        len(c) == 3 for c in dump["collectives"]),
        f"dist: rank {r} flight recorder collectives {dump['collectives'][:4]}")
    # the step's collective sequence, traced without communicating: the
    # analysis phase holds the ranks' sequences against each other
    res["signature"] = [[d.op, d.axis, list(d.shape), d.dtype,
                         None if d.perm is None else list(d.perm)]
                        for d in step.collective_signature(*batch)]
    del step, net
    torch.cuda.empty_cache()

    # ---- ZeRO stages 1-3 over the world, from the same weights ----
    # (stage 3 gathers unit by unit: peak max_memory_allocated of each
    # stage's steps beside its bytes after them, and the most bytes of
    # whole parameters and their bf16 casts held at once, at most the root
    # group's plus the largest unit's; then one SGD step of stages 1 and 3
    # with ClipGradByGlobalNorm at half the initial gradient's norm: the
    # update is the clipped gradient, whose norm is the clip norm, and
    # stage 3 takes the norm over its slices)
    hz = HybridCommunicateGroup(hybrid_configs={"sharding_degree": w})
    res["zero"] = {}
    clip_norm = ZERO_CLIP_SHARE * gnorm
    start = {k: v.float().cpu().numpy() for k, v in init.items()}
    for stage in (1, 2, 3, "1clip", "3clip"):
        pt.seed(SEED)
        znet = pt.models.ErnieForPretraining(pt.models.ernie_base(
            hidden_dropout_prob=0.0))
        znet.set_state_dict(init)
        clipped = str(stage).endswith("clip")
        if clipped:
            zopt = pt.optimizer.SGD(
                parameters=znet.parameters(), learning_rate=ZERO_CLIP_LR,
                grad_clip=pt.nn.ClipGradByGlobalNorm(clip_norm))
        else:
            zopt = pt.optimizer.AdamW(parameters=znet.parameters(),
                                      learning_rate=1e-4)
        zstep = SPMDTrainStep(znet, bench.flagship_loss(pt), zopt,
                              mesh=hz.get_mesh(),
                              sharding_stage=int(str(stage)[0]),
                              amp_dtype="bfloat16", n_model_inputs=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zl = [float(zstep(*batch)) for _ in range(1 if clipped
                                                   else ZERO_STEPS)]
        torch.cuda.synchronize()
        zrel = None if clipped else \
            max(abs(a - b) / abs(b) for a, b in zip(zl, losses))
        units = zstep._units
        res["zero"][stage] = {
            "losses": zl, "max_rel_vs_dp": zrel,
            "memory_allocated": torch.cuda.memory_allocated(dev),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "peak_gathered_bytes": zstep.last_peak_gathered_bytes,
            "largest_unit_bytes": None if units is None else
            max(b for g, b in units.unit_bytes.items() if g >= 0),
            "root_bytes": None if units is None else units.unit_bytes[-1],
            "slot_bytes": zstep.memory_report(*batch)["slot_bytes"]}
        z = res["zero"][stage]
        check(zrel is None or zrel <= 1e-3, f"dist: rank {r} ZeRO-{stage} "
              f"losses {zl} vs {losses}")
        check(all(math.isfinite(x) for x in zl),
              f"dist: rank {r} ZeRO-{stage} losses {zl}")
        check(units is None or z["peak_gathered_bytes"] <=
              z["root_bytes"] + z["largest_unit_bytes"],
              f"dist: rank {r} ZeRO-{stage} peak gathered bytes "
              f"{z['peak_gathered_bytes']} vs root {z['root_bytes']} + "
              f"largest unit {z['largest_unit_bytes']}")
        if clipped:
            upd = {k: (start[k] - v) / ZERO_CLIP_LR
                   for k, v in zstep.state_dict()["params"].items()}
            z["update_norm"] = float(np.sqrt(sum(
                float(np.square(u, dtype=np.float64).sum())
                for u in upd.values())))
            z["clip_norm"] = clip_norm
            check(abs(z["update_norm"] - clip_norm) <= 1e-3 * clip_norm,
                  f"dist: rank {r} ZeRO-{stage} clipped update norm "
                  f"{z['update_norm']} vs clip norm {clip_norm}")
            if stage == "1clip":
                upd1 = upd
            else:
                z["update_rel_vs_1clip"] = float(np.sqrt(sum(
                    float(np.square(upd[k] - upd1[k], dtype=np.float64).sum())
                    for k in upd))) / res["zero"]["1clip"]["update_norm"]
                check(z["update_rel_vs_1clip"] <= 1e-3,
                      f"dist: rank {r} ZeRO-3 clipped update vs ZeRO-1's: "
                      f"rel {z['update_rel_vs_1clip']}")
        del zstep, znet, zopt
        torch.cuda.empty_cache()
    del start, upd, upd1
    dp_slots = res["dp"]["slot_bytes"]
    z1 = res["zero"][1]["slot_bytes"]
    check(z1 <= dp_slots / w * 1.01 + 1e6, f"dist: rank {r} ZeRO-1 slots "
          f"{z1} B vs DP {dp_slots} B over {w} ranks")

    # ---- rows 1-2 on this rank's card ----
    res["kernels"] = rows_on_rank(pt, fa, torch, dev, r, DIST_ATT, False,
                                  "dist")

    # ---- the allreduce arm ----
    res["allreduce"] = bench.allreduce_busbw(64 << 20)
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"{tag}_{r}.json"), "w") as f:
        json.dump(res, f)


def rows_on_rank(pt, fa, torch, dev, r, shape, causal, where):
    """scaled_dot_product_attention forward and backward in bf16 at
    `shape` (B, S, H, D) on this rank's card, through rows 1 and 2 (1 + 1
    launches), against the plain f32 math."""
    b_, s_, h_, d_ = shape
    g = torch.Generator(device="cpu").manual_seed(SEED + r)
    q, k, v, do = (torch.randn(b_, s_, h_, d_, generator=g).to(
        dev, torch.bfloat16).requires_grad_(i < 3) for i in range(4))
    for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_fused):
        c.launches = 0
    out = pt.nn.functional.scaled_dot_product_attention(q, k, v,
                                                        is_causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    launches = [fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd_fused.launches]
    q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k32) / math.sqrt(d_)
    if causal:
        scores = scores.masked_fill(torch.ones(
            s_, s_, dtype=torch.bool, device=dev).triu(1), float("-inf"))
    p_ = torch.softmax(scores, -1)
    ref_out = torch.einsum("bhqk,bkhd->bqhd", p_, v32)
    ref_grads = torch.autograd.grad(ref_out, (q32, k32, v32), do.float())
    tol, tol_g = tol_of(torch, torch.bfloat16), \
        tol_of(torch, torch.bfloat16, grad=True)
    errs = [close_enough(out, ref_out, tol)] + \
        [close_enough(a, b_ref, tol_g) for a, b_ref in
         zip((dq, dk, dv), ref_grads)]
    check(launches == [1, 1] and all(e[1] for e in errs),
          f"{where}: rank {r} on {dev}: flash launches {launches}, errors "
          f"{errs}")
    return {"launches": launches, "max_abs_err": [e[0] for e in errs],
            "tol": tol}


def join_all(ctxs, t0):
    """Join spawned worlds started together; each one's seconds from `t0`
    to its join. A failing world stops every other one before it raises."""
    walls = []
    try:
        for ctx in ctxs:
            ctx.join()
            walls.append(time.perf_counter() - t0)
    except BaseException:
        stop_worlds(ctxs)
        raise
    return walls


def stop_worlds(ctxs):
    """Kill every still-running rank of spawned worlds."""
    for ctx in ctxs:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(30)


def dist_phase(pt, torch, card):
    """Slice 15 on the card: the worlds this machine allows, each started
    by the port's spawn; the parent reads every rank's results and
    prints one line per world. Returns each world's per-rank traced
    collective sequences ([op, axis, shape, dtype, perm] lists)."""
    import tempfile
    from paddle_tpu_torch.parallel import spawn
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        w = min(n_cards, 8)
        worlds = [(f"nccl_w{w}", w, "nccl", ",".join(map(str, range(w))))]
    else:
        worlds = [("nccl_w1", 1, "nccl", "0"), ("gloo_w2", 2, "gloo", "0,0")]
    signatures = {}
    with tempfile.TemporaryDirectory(prefix="dist_") as d:
        # the worlds run at once (each its own rendezvous and files), then
        # are read one by one; a world's time is from the common start to
        # its own join
        t0 = time.perf_counter()
        ctxs = [spawn(dist_rank, args=(tag, d), nprocs=w, backend=backend,
                      gpus=gpus, timeout=DIST_TIMEOUT, join=False)
                for tag, w, backend, gpus in worlds]
        walls = join_all(ctxs, t0)
        for (tag, w, backend, gpus), wall in zip(worlds, walls):
            ranks = [json.load(open(os.path.join(d, f"{tag}_{r}.json")))
                     for r in range(w)]
            r0 = ranks[0]
            signatures[tag] = [x["signature"] for x in ranks]
            z3 = r0["zero"]["3"]
            # a world of one slices nothing: no unit is gathered
            units3 = "n/a (one rank)" if z3["peak_gathered_bytes"] is None \
                else (f"{z3['peak_gathered_bytes']:,} (fp32 whole + bf16 "
                      f"casts) <= the root group's {z3['root_bytes']:,} (the "
                      "word embeddings, read by the tied MLM head, stay "
                      f"gathered) + the largest unit's "
                      f"{z3['largest_unit_bytes']:,}")
            zc1, zc3 = r0["zero"]["1clip"], r0["zero"]["3clip"]
            ar = r0["allreduce"]
            bus = "n/a (one rank)" if ar["bus_gbps"] is None else \
                f"{ar['bus_gbps']:.2f} GB/s ({ar['note']})"
            print(f"dist [{tag}: {w} rank(s), {backend}, cards "
                  f"{[x['device'] for x in ranks]}]: collectives max rel "
                  f"err {max(max(x['collective_errs'].values()) for x in ranks):.3g} "
                  f"(f32 exact, bf16 1e-2); config 3 ERNIE-base "
                  f"{FLAGSHIP_B}x{FLAGSHIP_S} bf16 step-1 loss "
                  f"{r0['step1']['loss_dp']:.6f} vs one process "
                  f"{r0['step1']['loss_one']:.6f} (rel err "
                  f"{max(x['step1']['rel_err'] for x in ranks):.3g}, tol "
                  f"1e-3), lowest grad cosines {r0['step1']['lowest_cosines']}"
                  f" (tol 0.999); losses {[round(v, 4) for v in r0['dp']['losses']]}"
                  f"; {r0['dp']['n_buckets']} buckets, c_allreduce_bucket per "
                  f"step {r0['dp']['buckets_per_step']}, recorded "
                  f"{r0['dp']['recorded_buckets']}; parameters bit-equal "
                  f"across ranks {all(x['dp']['bit_equal'] for x in ranks)};"
                  f" ms/step {[round(x['dp']['ms_per_step'], 2) for x in ranks]}"
                  f" (with the other world on the card)"
                  f" ({FLAGSHIP_B * 1e3 / r0['dp']['ms_per_step']:.1f} "
                  f"samples/s); ZeRO max rel vs DP "
                  f"{ {s: round(z['max_rel_vs_dp'], 6) for s, z in r0['zero'].items() if z['max_rel_vs_dp'] is not None} }"
                  f" (tol 1e-3); memory_allocated MB DP "
                  f"{r0['dp']['memory_allocated'] / 2**20:.0f}, ZeRO "
                  f"{ {s: round(z['memory_allocated'] / 2**20) for s, z in r0['zero'].items()} }"
                  f"; peak max_memory_allocated MB over the ZeRO steps "
                  f"{ {s: round(z['max_memory_allocated'] / 2**20) for s, z in r0['zero'].items()} }"
                  f" (stage 3 with whole gathers held 1,653,798,400 B "
                  f"after its steps on two gloo ranks); stage-3 peak "
                  f"gathered bytes {units3}; one SGD step with a global-"
                  f"norm clip at {zc1['clip_norm']:.4g} (half the initial "
                  f"gradient norm {r0['step1']['grad_norm']:.4g}): update "
                  f"norm ZeRO-1 {zc1['update_norm']:.6g}, ZeRO-3 "
                  f"{zc3['update_norm']:.6g} (tol 1e-3 rel), ZeRO-3 update "
                  f"vs ZeRO-1's rel {zc3['update_rel_vs_1clip']:.3g} (tol "
                  "1e-3)"
                  f"; slot MB DP {r0['dp']['slot_bytes'] / 2**20:.1f}, ZeRO "
                  f"{ {s: round(z['slot_bytes'] / 2**20, 1) for s, z in r0['zero'].items()} }"
                  f"; rows 1-2 per rank launches "
                  f"{[x['kernels']['launches'] for x in ranks]} max abs err "
                  f"{[[round(e, 4) for e in x['kernels']['max_abs_err']] for x in ranks]}"
                  f" (tol {r0['kernels']['tol']} (1+|ref|)); allreduce 64 MB "
                  f"bus {bus} (with the other world on the card); world {wall:.1f} s "
                  f"(the worlds concurrent) "
                  f"[{card}]", flush=True)
    print(f"dist: phase {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return signatures


# ---- the config-5 phase ----
# gpt_pipeline_layer at gpt_10b's full width (hidden 4096, 64 heads of 64,
# FFN 16384, vocabulary 50304, sequence 2048), its depth cut from 48 to 4
# layers as bench.py's titan proxy is (bench.py:683-738); micro-batches
# of 1 x 2048, 4 of them per train_batch
C5_CFG = dict(vocab_size=50304, hidden_size=4096, num_layers=4,
              num_heads=64, max_seq_len=2048, dropout=0.0)
C5_MICRO, C5_MB, C5_STEPS = 4, 1, 2      # bf16 steps (cut from 3)
C5_ATT = (1, 2048, 64, 64)          # the micro-batch's attention, causal
C5_TIMEOUT = 600


def c5_batch(np, torch, cfg, micro, mb, device):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(
        0, cfg["vocab_size"], (micro * mb, cfg["max_seq_len"])).astype(
        np.int64)).to(device)


def c5_named(pl, params, grads):
    """{state-dict name: gradient} of a PipelineLayer's parameters."""
    by_id = {id(p): g for p, g in zip(params, grads)}
    return {n: by_id[id(p)] for n, p in pl.named_parameters()
            if id(p) in by_id}


def c5_losses_falling(losses):
    return all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def c5_single(pt, torch, np, cfg, devices, micro, mb, workdir, fa=None):
    """The single controller at pp 2 over `devices` (two slots): fp32
    forward_backward_pipeline against the same PipelineLayer run whole as
    one module over the same micro-batches (gradients accumulated, scaled
    by 1 / micro); bf16 against fp32; then bf16 train_batch steps with
    AdamW(1e-4) and ClipGradByGlobalNorm(1.0), the flash launches of one
    counted. Saves the initial state, the fp32 loss and gradients into
    `workdir` for the process world."""
    from paddle_tpu_torch.parallel import (DistributedStrategy,
                                           HybridCommunicateGroup,
                                           PipelineParallel)
    dev0 = torch.device(devices[0])
    pt.set_device("cpu" if dev0.type == "cpu" else "gpu")
    out = {}
    hcg = HybridCommunicateGroup(hybrid_configs={"pp_degree": 2},
                                 devices=devices)
    st = DistributedStrategy()
    st.pipeline_configs["accumulate_steps"] = micro
    pt.seed(SEED)
    pl = pt.models.gpt_pipeline_layer(num_stages=2, **cfg)
    out["params"] = sum(p.numel() for p in pl.parameters())
    torch.save({k: v.detach().cpu() for k, v in pl.state_dict().items()},
               os.path.join(workdir, "state.pt"))
    ids = c5_batch(np, torch, cfg, micro, mb, dev0)
    # the whole module, one micro-batch at a time (before the engine
    # places stage 1 on its slot)
    t0 = time.perf_counter()
    whole_loss = 0.0
    for x in ids.split(mb):
        loss = pl.loss_fn(pl(x), x) / micro
        loss.backward()
        whole_loss += float(loss.detach())
    whole = {n: p.grad for n, p in pl.named_parameters()}
    for p in pl.parameters():
        p.grad = None
    out["whole_s"] = time.perf_counter() - t0
    engine = PipelineParallel(pl, hcg, st)
    sync = (lambda: torch.cuda.synchronize()) if dev0.type == "cuda" \
        else (lambda: None)
    t0 = time.perf_counter()
    loss32, grads = engine.forward_backward_pipeline(ids, [ids])
    sync()
    out["fp32_s"] = time.perf_counter() - t0
    params = [p for mod in engine.stages for p in engine._stage_params(mod)]
    g32 = c5_named(pl, params, [g for gs in grads for g in gs])
    del grads
    out["loss32"], out["loss_whole"] = float(loss32), whole_loss
    out["rel_vs_whole"] = abs(out["loss32"] - whole_loss) / abs(whole_loss)
    cos = sorted((cosine(g32[n].float(), whole[n].float().to(
        g32[n].device)), n) for n in whole)
    out["lowest_vs_whole"] = cos[:3]
    del whole
    torch.save({n: g.detach().cpu() for n, g in g32.items()},
               os.path.join(workdir, "grads32.pt"))
    with pt.amp.auto_cast(dtype="bfloat16"):
        loss16, grads = engine.forward_backward_pipeline(ids, [ids])
    g16 = c5_named(pl, params, [g for gs in grads for g in gs])
    del grads
    out["loss16"] = float(loss16)
    out["rel_bf16"] = abs(out["loss16"] - out["loss32"]) / abs(out["loss32"])
    out["lowest_bf16"] = sorted((cosine(g16[n].float(), g32[n].float()), n)
                                for n in g32)[:3]
    del g16, g32
    opt = pt.optimizer.AdamW(parameters=pl.parameters(), learning_rate=1e-4,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    devs = sorted({str(d) for d in engine._stage_devices})
    if dev0.type == "cuda":
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
    losses = []
    with pt.amp.auto_cast(dtype="bfloat16"):
        for i in range(C5_STEPS):
            if i == 0 and fa is not None:
                for c in (fa.flash_attention_fwd,
                          fa.flash_attention_bwd_fused):
                    c.launches = 0
            if i == 1:
                sync()
                t0 = time.perf_counter()
            losses.append(float(engine.train_batch([ids, ids], opt)))
            if i == 0 and fa is not None:
                out["launches"] = [fa.flash_attention_fwd.launches,
                                   fa.flash_attention_bwd_fused.launches]
    sync()
    out["ms_per_batch"] = (time.perf_counter() - t0) / (C5_STEPS - 1) * 1e3
    out["tokens_per_s"] = ids.numel() / out["ms_per_batch"] * 1e3
    out["losses"] = losses
    out["peak_inflight"] = engine.last_peak_inflight
    out["max_memory_allocated"] = {
        d: torch.cuda.max_memory_allocated(d) for d in devs} \
        if dev0.type == "cuda" else None
    with open(os.path.join(workdir, "single.json"), "w") as f:
        json.dump({"cfg": cfg, "micro": micro, "mb": mb,
                   "loss32": out["loss32"]}, f)
    del engine, pl, opt
    return out


def c5_rank(workdir):
    """One rank of the config-5 process world (pp 2 x mp 2): fleet.init ->
    gpt_pipeline_layer(use_mp=True) -> distributed_model ->
    distributed_optimizer; the single controller's initial state loaded
    (the rank's stage, its mp slices); the fp32 step-1 loss and gathered
    gradients against the single controller's; bf16 train_batch steps;
    rows 1-2 at the micro-batch's attention shape. Writes
    workdir/rank_<r>.json."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import DistributedStrategy, fleet
    from paddle_tpu_torch.parallel.mp_layers import gather_whole
    on_cpu = os.environ.get("PADDLE_DISTRI_DEVICE") == "cpu"
    if on_cpu:
        pt.set_device("cpu")
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_rank = time.perf_counter()
    with open(os.path.join(workdir, "single.json")) as f:
        single = json.load(f)
    cfg, micro, mb = single["cfg"], single["micro"], single["mb"]
    st = DistributedStrategy()
    st.hybrid_configs.update(pp_degree=2, mp_degree=2)
    st.pipeline_configs["accumulate_steps"] = micro
    hcg = fleet.init(is_collective=True, strategy=st)
    r, dev = dist.get_rank(), dist.ParallelEnv().device
    check(on_cpu or dev.type == "cuda", f"config5: rank {r} on {dev}")
    pt.seed(SEED)
    pl = pt.models.gpt_pipeline_layer(num_stages=2, use_mp=True, **cfg)
    engine = fleet.distributed_model(pl)
    state = torch.load(os.path.join(workdir, "state.pt"), mmap=True)
    mine = set(pl.state_dict(keep_vars=True))
    pl.set_state_dict({k: v for k, v in state.items() if k in mine})
    del state
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        parameters=pl.parameters(), learning_rate=1e-4,
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
    ids = c5_batch(np, torch, cfg, micro, mb, dev)
    res = {"rank": r, "device": str(dev), "stage": hcg.get_stage_id(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "params": sum(p.numel() for p in pl.parameters())}
    loss32, grads = engine.forward_backward_pipeline(ids, [ids])
    g = c5_named(pl, engine._stage_params(engine._module), grads[0])
    ref = torch.load(os.path.join(workdir, "grads32.pt"), mmap=True)
    cos = []
    for n, p in pl.named_parameters():
        split = getattr(p, "_mp_split", None)
        gw = gather_whole(g[n], split) if split is not None else g[n]
        cos.append((cosine(gw.float(), ref[n].to(gw.device).float()), n))
    del ref, g, grads
    res["loss32"] = float(loss32)
    res["rel32"] = abs(res["loss32"] - single["loss32"]) / \
        abs(single["loss32"])
    res["lowest32"] = sorted(cos)[:3]
    check(res["rel32"] <= 1e-4 and res["lowest32"][0][0] >= 0.9999,
          f"config5: rank {r} fp32 step 1 loss {res['loss32']} vs "
          f"{single['loss32']} (rel {res['rel32']}), lowest cosines "
          f"{res['lowest32']}")
    sync = (lambda: None) if on_cpu else torch.cuda.synchronize
    if not on_cpu:
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    with pt.amp.auto_cast(dtype="bfloat16"):
        res["signature_len"] = len(engine.collective_signature([ids, ids],
                                                               opt))
        for i in range(C5_STEPS):
            if i == 0:
                for c in (fa.flash_attention_fwd,
                          fa.flash_attention_bwd_fused):
                    c.launches = 0
            if i == 1:
                sync()
                t0 = time.perf_counter()
            losses.append(float(engine.train_batch([ids, ids], opt)))
            if i == 0:
                res["launches"] = [fa.flash_attention_fwd.launches,
                                   fa.flash_attention_bwd_fused.launches]
    sync()
    res["ms_per_step"] = (time.perf_counter() - t0) / (C5_STEPS - 1) * 1e3
    res["losses"] = losses
    res["peak_inflight"] = engine.last_peak_inflight
    res["max_memory_allocated"] = None if on_cpu else \
        torch.cuda.max_memory_allocated(dev)
    check(c5_losses_falling(losses), f"config5: rank {r} bf16 losses "
          f"{losses}")
    check(engine.last_peak_inflight <= engine.num_stages,
          f"config5: rank {r} in flight {engine.last_peak_inflight}")
    if not on_cpu:
        layers = sum(1 for n in pl.state_dict(keep_vars=True)
                     if n.endswith("attention.qkv.weight"))
        want = [2 * layers * micro, layers * micro]
        check(res["launches"] == want, f"config5: rank {r} flash launches "
              f"{res['launches']} per train_batch, want {want}")
        res["kernels"] = rows_on_rank(pt, fa, torch, dev, r, C5_ATT, True,
                                      "config5")
    res["seconds"] = time.perf_counter() - t_rank
    with open(os.path.join(workdir, f"rank_{r}.json"), "w") as f:
        json.dump(res, f)


def config5_phase(pt, fa, torch, np, card):
    """Config 5's model-parallel half on the card: gpt_pipeline_layer at
    gpt_10b's width, 4 layers, through the single controller (pp 2 over
    two slots) and a pp 2 x mp 2 process world; rows 1-2 at its
    micro-batch's attention shape. Returns the flash launches of one
    single-controller train_batch."""
    import gc
    import tempfile
    from paddle_tpu_torch.parallel import spawn
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if n_cards >= 2 else ["cuda:0"] * 2
    L, M = C5_CFG["num_layers"], C5_MICRO
    rows = {"flash_fwd": fwd_case(fa, torch, *C5_ATT, torch.bfloat16, True)}
    rows.update(bwd_case(fa, torch, *C5_ATT, torch.bfloat16, True))
    for kname in ("flash_fwd", "flash_bwd_fused"):
        r = rows[kname]
        print(f"config5: {kname} at the gpt_10b micro-batch "
              f"(B 1, 64 heads, S 2048, D 64, causal, bf16): max_abs_err="
              f"{r['max_abs_err']:.3g} device_ms={r['device_ms']:.4f} "
              f"library_device_ms={fmt_ms(r['library_device_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) plain_ms="
              f"{r['plain_ms']:.4f} [{card}]", flush=True)
    with tempfile.TemporaryDirectory(prefix="config5_") as d:
        one = c5_single(pt, torch, np, C5_CFG, devices, M, C5_MB, d, fa)
        want = [2 * L * M, L * M]
        check(one["rel_vs_whole"] <= 1e-4 and
              one["lowest_vs_whole"][0][0] >= 0.9999,
              f"config5: fp32 pipeline vs the whole module: loss rel "
              f"{one['rel_vs_whole']}, lowest cosines "
              f"{one['lowest_vs_whole']}")
        check(one["rel_bf16"] <= 2e-2 and one["lowest_bf16"][0][0] >= 0.99,
              f"config5: bf16 vs fp32: loss rel {one['rel_bf16']}, lowest "
              f"cosines {one['lowest_bf16']}")
        check(one["launches"] == want, f"config5: flash launches "
              f"{one['launches']} per train_batch, want {want}")
        check(one["peak_inflight"] <= 2 and
              c5_losses_falling(one["losses"]),
              f"config5: in flight {one['peak_inflight']}, losses "
              f"{one['losses']}")
        print(f"config5 [single controller, pp 2 over {devices}]: "
              f"{one['params']:,} parameters, {M} micro-batches of {C5_MB} x "
              f"{C5_CFG['max_seq_len']}; fp32 step-1 loss {one['loss32']:.6f}"
              f" vs the whole module {one['loss_whole']:.6f} (rel "
              f"{one['rel_vs_whole']:.3g}, tol 1e-4), lowest grad cosines "
              f"{one['lowest_vs_whole']} (tol 0.9999); bf16 loss "
              f"{one['loss16']:.6f} (rel {one['rel_bf16']:.3g}, tol 2e-2), "
              f"lowest cosines {one['lowest_bf16']} (tol 0.99); flash "
              f"launches per train_batch {one['launches']} (2 L M, L M with "
              f"the recomputing backward); in flight "
              f"{one['peak_inflight']}; bf16 train_batch "
              f"{one['ms_per_batch']:.1f} ms, {one['tokens_per_s']:.0f} "
              f"tokens/s, losses {[round(x, 4) for x in one['losses']]}; "
              f"peak max_memory_allocated GiB "
              f"{ {k: round(v / 2**30, 2) for k, v in one['max_memory_allocated'].items()} }"
              f"; fp32 pipeline {one['fp32_s']:.1f} s, whole module "
              f"{one['whole_s']:.1f} s [{card}]", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        if n_cards >= 4:
            backend, gpus = "nccl", "0,1,2,3"
        else:
            backend, gpus = "gloo", "0,0,0,0"
        t0 = time.perf_counter()
        spawn(c5_rank, args=(d,), nprocs=4, backend=backend, gpus=gpus,
              timeout=C5_TIMEOUT)
        ranks = [json.load(open(os.path.join(d, f"rank_{r}.json")))
                 for r in range(4)]
    by_stage = {}
    for x in ranks:
        by_stage.setdefault(x["stage"], set()).add(x["signature_len"])
    check(all(len(v) == 1 for v in by_stage.values()),
          f"config5: signature lengths differ within a stage {by_stage}")
    last = [x for x in ranks if x["stage"] == 1][0]
    print(f"config5 [process world pp 2 x mp 2, {backend}, cards "
          f"{[x['device'] for x in ranks]}]: fp32 step-1 loss "
          f"{last['loss32']:.6f} vs the single controller "
          f"{one['loss32']:.6f} (rel {max(x['rel32'] for x in ranks):.3g}, "
          f"tol 1e-4), lowest gathered grad cosines "
          f"{min(x['lowest32'][0][0] for x in ranks):.8f} (tol 0.9999); "
          f"bf16 losses {[round(v, 4) for v in last['losses']]}; ms per "
          f"step {[round(x['ms_per_step'], 1) for x in ranks]}; parameters "
          f"per rank {[x['params'] for x in ranks]}; peak "
          f"max_memory_allocated GiB per rank "
          f"{[round(x['max_memory_allocated'] / 2**30, 2) for x in ranks]};"
          f" signature lengths by stage "
          f"{ {k: sorted(v) for k, v in by_stage.items()} }; flash "
          f"launches per train_batch {[x['launches'] for x in ranks]}; rows "
          f"1-2 per rank max abs err "
          f"{[[round(e, 4) for e in x['kernels']['max_abs_err']] for x in ranks]}"
          f"; world {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    print(f"config5: phase {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return {"launches": one["launches"], "rows": rows}


# ---- the fault-tolerance phase (slice 17) ----
# (a) the guard: GPT-2 small at the train phase's 8 x 1024, bf16 AMP +
# AdamW(1e-4); the uninterrupted run's steps, the step before which the
# SIGTERM arrives, the steps of the NaN check (the third poisoned)
GUARD_STEPS, GUARD_KILL_AT, GUARD_NAN_STEPS = 4, 2, 4
# (b) the meta-optimizers at the flagship's width (ERNIE-base, 32 x 128):
# gradient merge of k micro-batches (of 8), LocalSGD's k and steps, DGC's
# sparsity and steps, in a world of two (LocalSGD 4 steps: one averaging;
# cut from 8 to keep the whole smoke inside its time limit)
META_K = 4
LOCALSGD_K, LOCALSGD_STEPS, DGC_SPARSITY, DGC_STEPS = 4, 4, 0.999, 3
# (c) MoE: GPT-2 small's FFN width as 8 experts, top-2, on 4096 tokens
MOE_D, MOE_H, MOE_E, MOE_K, MOE_T, MOE_EP = 768, 3072, 8, 2, 4096, 4
MOE_REPS = 2      # timed repeats (cut from 5)
# (d) elastic: config 3's DP step per rank at 8 x 128 tokens, 3 epochs of
# 2 steps; a gang of 2 grown to 3
ELASTIC_EPOCHS, ELASTIC_STEPS, ELASTIC_B = 3, 2, 8
# the worlds of (b) and (d) run ERNIE-base at its width and 4 of its 12
# layers (a depth cut, with 4 -> 3 epochs above, to keep the whole smoke
# inside its time limit)
FAULT_ERNIE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=4,
                   num_attention_heads=12, intermediate_size=3072,
                   hidden_dropout_prob=0.0)
FAULT_TIMEOUT = 300
FLASH_ROWS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
              "flash_bwd_dkv")


def flash_counts(fa):
    return [fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
            fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv]


def guard_checks(pt, fa, torch, np, card, workdir):
    """(a) TrainGuard over GPT-2 small's TrainStep: a poisoned batch (its
    loss scale NaN) rolled back and skipped, parameters and AdamW slots
    bit-equal to the snapshot after it; under deterministic algorithms a
    SIGTERM before step GUARD_KILL_AT, the checkpoint, fresh objects from
    another seed and resume(), ending bit-equal to an uninterrupted run.
    Returns the flash launches of the guarded steps."""
    import signal
    from paddle_tpu_torch.guard import GuardConfig, PreemptedError, TrainGuard
    crit = pt.models.GPTPretrainingCriterion()

    def loss_fn(logits, labels, scale):
        return crit(logits, labels) * scale[0]

    def make(seed):
        pt.seed(seed)
        model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
        return pt.jit.TrainStep(model, loss_fn, opt, amp_dtype="bfloat16",
                                n_model_inputs=1)

    rng = np.random.default_rng(SEED + 17)
    one = torch.ones(1, device="cuda")
    batches = [(ids, ids, one) for ids in (
        torch.from_numpy(rng.integers(0, 50257, (TRAIN_B, TRAIN_S))).cuda()
        for _ in range(GUARD_STEPS))]
    counters = flash_counts(fa)
    res = {}

    def same_state(a, b):
        return all(np.array_equal(a["params"][n], b["params"][n])
                   for n in a["params"]) and all(
            np.array_equal(x[k], y[k]) for x, y in zip(a["slots"], b["slots"])
            for k in x) and a["step_count"] == b["step_count"] and \
            np.array_equal(a["t"], b["t"])

    # ---- a NaN step: rolled back bit-exactly and skipped ----
    for c in counters:
        c.launches = 0
    step = make(SEED)
    nan = torch.full((1,), float("nan"), device="cuda")
    with TrainGuard(step, config=GuardConfig(snapshot_interval=1,
                                             max_bad_steps=3)) as g:
        losses = []
        for i in range(GUARD_NAN_STEPS):
            g.set_cursor(0, i)
            if i == 2:
                before = step.state_dict()
                t0 = time.perf_counter()
                losses.append(g.step(batches[i][0], batches[i][1], nan))
                res["rollback_step_ms"] = (time.perf_counter() - t0) * 1e3
                after = step.state_dict()
            else:
                losses.append(g.step(*batches[i]))
    res["nan_losses"] = losses
    res["nan_bit_equal"] = same_state(before, after)
    res["nan_launches"] = [c.launches for c in counters]
    del step, g, before, after
    torch.cuda.empty_cache()
    check(losses[2] is None and all(
        math.isfinite(x) for i, x in enumerate(losses) if i != 2),
        f"fault: guard losses around the poisoned step {losses}")
    check(res["nan_bit_equal"], "fault: the rollback after the NaN step "
          "left parameters or slots unequal to the snapshot")
    n_layers = 12
    check(res["nan_launches"] == [n_layers * GUARD_NAN_STEPS] * 2 + [0, 0],
          f"fault: guard flash launches {res['nan_launches']} in "
          f"{GUARD_NAN_STEPS} steps (fwd, fused, dq, dkv)")

    # ---- preemption and resume, bit-identical ----
    ckpt = os.path.join(workdir, "guard")
    with determinism(torch, True):
        for c in counters:
            c.launches = 0
        step = make(SEED)
        with TrainGuard(step, config=GuardConfig(snapshot_interval=0)) as g:
            for i in range(GUARD_STEPS):
                g.set_cursor(0, i)
                g.step(*batches[i])
        final_a = {n: t.detach().clone()
                   for n, t in step.named_param_arrays().items()}
        del step, g
        step = make(SEED)
        cursor = None
        with TrainGuard(step, ckpt_dir=ckpt,
                        config=GuardConfig(snapshot_interval=0)) as g:
            try:
                for i in range(GUARD_STEPS):
                    g.set_cursor(0, i)
                    if i == GUARD_KILL_AT:
                        os.kill(os.getpid(), signal.SIGTERM)
                    t0 = time.perf_counter()
                    g.step(*batches[i])
            except PreemptedError as e:
                cursor = e.cursor
                res["preempt_step_ms"] = (time.perf_counter() - t0) * 1e3
        check(cursor == (0, GUARD_KILL_AT + 1),
              f"fault: the SIGTERM gave no PreemptedError at the step "
              f"(cursor {cursor})")
        del step, g
        torch.cuda.empty_cache()
        step = make(SEED + 1)
        with TrainGuard(step, ckpt_dir=ckpt,
                        config=GuardConfig(snapshot_interval=0)) as g:
            t0 = time.perf_counter()
            start = g.resume()
            res["resume_ms"] = (time.perf_counter() - t0) * 1e3
            for i in range(start[1], GUARD_STEPS):
                g.set_cursor(0, i)
                g.step(*batches[i])
        got = step.named_param_arrays()
        res["resume_bit_equal"] = all(torch.equal(got[n], final_a[n])
                                      for n in final_a)
        res["det_launches"] = [c.launches for c in counters]
    res["ckpt_bytes"] = sum(os.path.getsize(os.path.join(ckpt, f))
                            for f in os.listdir(ckpt))
    del step, g, got, final_a
    torch.cuda.empty_cache()
    n_det = GUARD_STEPS + GUARD_KILL_AT + 1 + GUARD_STEPS - GUARD_KILL_AT - 1
    check(res["resume_bit_equal"], "fault: the resumed run's parameters "
          "differ from the uninterrupted run's")
    check(res["det_launches"] == [n_layers * n_det, 0, n_layers * n_det,
                                  n_layers * n_det],
          f"fault: deterministic guard launches {res['det_launches']} in "
          f"{n_det} steps")
    res["launches"] = {k: res["nan_launches"][i] + res["det_launches"][i]
                       for i, k in enumerate(FLASH_ROWS)}
    print(f"fault [guard]: gpt2_small bf16 AMP {TRAIN_B}x{TRAIN_S}, "
          f"TrainGuard(snapshot_interval=1): losses "
          f"{[None if x is None else round(x, 4) for x in res['nan_losses']]}"
          f" (step 3's loss scale NaN: skipped), parameters and slots "
          f"bit-equal to the snapshot {res['nan_bit_equal']}, the bad step "
          f"with its rollback {res['rollback_step_ms']:.1f} ms; SIGTERM "
          f"before step {GUARD_KILL_AT + 1} -> PreemptedError at cursor "
          f"{cursor}, the step with the checkpoint "
          f"{res['preempt_step_ms']:.1f} ms ({res['ckpt_bytes']:,} bytes), "
          f"resume() from fresh objects {res['resume_ms']:.1f} ms, final "
          f"parameters bit-equal to the uninterrupted run "
          f"{res['resume_bit_equal']} (deterministic algorithms); flash "
          f"launches (fwd, fused, dq, dkv) {res['nan_launches']} in "
          f"{GUARD_NAN_STEPS} steps and {res['det_launches']} in {n_det} "
          f"deterministic steps [{card}]", flush=True)
    return res


def ernie_batch(np, torch, rows, seed, device):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, 30522, (rows, FLAGSHIP_S))
                           .astype(np.int64)).to(device)
    nsp = torch.from_numpy(rng.integers(0, 2, (rows,)).astype(np.int64)
                           ).to(device)
    return ids, nsp


def meta_checks(pt, torch, np, card):
    """(b) in this process: gradient merge (fleet's toggle, k META_K over
    micro-batches of FLAGSHIP_B / META_K, SGD(0.1) so each update is
    its gradient's) against one step on the whole batch, fp32, dropout 0;
    fleet.utils.recompute over the 12 encoder layers with dropout on
    against the plain backward, fp32, from one seed."""
    from paddle_tpu_torch.parallel import DistributedStrategy, fleet
    from paddle_tpu_torch.utils import bench
    loss_fn = bench.flagship_loss(pt)
    ids, nsp = ernie_batch(np, torch, FLAGSHIP_B, SEED + 3, "cuda")
    res = {}
    # ---- gradient merge ----
    pt.seed(SEED)
    net = pt.models.ErnieForPretraining(
        pt.models.ernie_base(hidden_dropout_prob=0.0))
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    big_loss = loss_fn(*net(ids), ids, nsp)
    big_loss.backward()
    big_loss = big_loss.detach()
    opt.step()
    opt.clear_grad()
    big = [p.detach().clone() for p in net.parameters()]
    net.set_state_dict(init)
    st = DistributedStrategy()
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": META_K, "avg": True}
    gm = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()), strategy=st)
    micro, rows = [], FLAGSHIP_B // META_K
    for i in range(META_K):
        sl = slice(i * rows, (i + 1) * rows)
        loss = loss_fn(*net(ids[sl]), ids[sl], nsp[sl])
        loss.backward()
        gm.step()
        gm.clear_grad()
        micro.append(float(loss.detach()))
    merged_loss = sum(micro) / META_K
    res["merge_loss_rel"] = abs(merged_loss - float(big_loss)) / \
        abs(float(big_loss))
    res["merge_param_rel"] = max(
        float((p.detach() - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for p, b in zip(net.parameters(), big))
    check(res["merge_loss_rel"] <= 1e-4 and res["merge_param_rel"] <= 1e-4,
          f"fault: gradient merge against the large batch: loss rel "
          f"{res['merge_loss_rel']}, parameter rel {res['merge_param_rel']}")
    del net, opt, gm, big, init
    torch.cuda.empty_cache()
    # ---- recompute over the encoder layers, dropout on ----
    pt.seed(SEED)
    net = pt.models.ErnieForPretraining(pt.models.ernie_base())
    layers = list(net.ernie.layers)

    def grads(rc):
        for p in net.parameters():
            p.grad = None
        if rc:
            for layer in layers:
                layer.forward = (lambda fwd: lambda *a: fleet.utils.recompute(
                    fwd, *a))(type(layer).forward.__get__(layer))
        try:
            pt.seed(SEED + 5)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss = loss_fn(*net(ids), ids, nsp)
            loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        finally:
            for layer in layers:
                layer.__dict__.pop("forward", None)
        return float(loss), [p.grad.clone() for p in net.parameters()], peak

    loss_p, g_p, peak_p = grads(False)
    loss_r, g_r, peak_r = grads(True)
    errs = [close_enough(a, b, 1e-5) for a, b in zip(g_r, g_p)]
    res["recompute"] = {"loss": [loss_p, loss_r],
                        "max_abs_err": max(e for e, _ in errs),
                        "ok": all(ok for _, ok in errs),
                        "peak": [peak_p, peak_r]}
    check(loss_p == loss_r and res["recompute"]["ok"],
          f"fault: recompute against the plain backward: losses "
          f"{loss_p} {loss_r}, max abs err {res['recompute']['max_abs_err']}")
    del net, g_p, g_r
    torch.cuda.empty_cache()
    print(f"fault [meta]: ERNIE-base {FLAGSHIP_B}x{FLAGSHIP_S} fp32; "
          f"fleet gradient_merge k {META_K} over "
          f"{FLAGSHIP_B // META_K}x{FLAGSHIP_S} "
          f"micro-batches vs one SGD(0.1) step on the whole batch: loss rel "
          f"{res['merge_loss_rel']:.3g}, max parameter rel "
          f"{res['merge_param_rel']:.3g} (tol 1e-4); fleet.utils.recompute "
          f"over the 12 encoder layers, dropout 0.1: loss {loss_r:.6f} "
          f"(plain {loss_p:.6f}), gradients max abs err "
          f"{res['recompute']['max_abs_err']:.3g} (tol 1e-5 (1+|ref|)), "
          f"peak max_memory_allocated {peak_r / 2**20:.0f} MB vs plain "
          f"{peak_p / 2**20:.0f} MB [{card}]", flush=True)
    return res


def meta_rank(outdir):
    """One rank of (b)'s world of two: ERNIE-base fp32 on batches of this
    rank's own (16 x 128); LocalSGD (fleet's toggle, k LOCALSGD_K, the
    default mean over the world) over LOCALSGD_STEPS AdamW steps, then
    DGC (sparsity DGC_SPARSITY, momentum 0.9, SGD(0.1), its allreduce the
    world's mean of what each rank sends). Writes outdir/meta_<r>.json."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.guard import fingerprint
    from paddle_tpu_torch.parallel import (DistributedStrategy, collective,
                                           fleet, init_parallel_env)
    from paddle_tpu_torch.parallel.meta_optimizers import DGCMomentumOptimizer
    from paddle_tpu_torch.utils import bench
    env = init_parallel_env()
    r, w, dev = env.rank, env.world_size, env.device
    loss_fn = bench.flagship_loss(pt)
    res = {"device": str(dev)}

    def fps(net):
        out = []
        collective.all_gather_object(
            out, fingerprint(dict(net.named_parameters())))
        return out

    pt.seed(SEED)
    net = pt.models.ErnieForPretraining(pt.models.ErnieModel(**FAULT_ERNIE))
    st = DistributedStrategy()
    st.localsgd = True
    st.localsgd_configs = {"k_steps": LOCALSGD_K}
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, parameters=net.parameters()), strategy=st)
    rows = FLAGSHIP_B // 2
    equal, t0 = [], time.perf_counter()
    for step in range(1, LOCALSGD_STEPS + 1):
        ids, nsp = ernie_batch(np, torch, rows, SEED + 100 * r + step, dev)
        loss_fn(*net(ids), ids, nsp).backward()
        opt.step()
        opt.clear_grad()
        f = fps(net)
        equal.append(f[0] == f[1])
    res["localsgd"] = {"equal": equal, "s": time.perf_counter() - t0}
    del net, opt
    torch.cuda.empty_cache()

    def world_mean(t):
        sent.append(t.clone())
        t = t.clone()
        collective.all_reduce(t)
        return t / w

    pt.seed(SEED)
    net = pt.models.ErnieForPretraining(pt.models.ErnieModel(**FAULT_ERNIE))
    params = list(net.parameters())
    opt = DGCMomentumOptimizer(
        pt.optimizer.SGD(learning_rate=0.1, parameters=params),
        momentum=0.9, sparsity=DGC_SPARSITY, allreduce=world_mean)
    equal, counts_ok, exact, ties, t0 = [], True, True, 0, time.perf_counter()
    for step in range(DGC_STEPS):
        ids, nsp = ernie_batch(np, torch, rows, SEED + 200 * r + step, dev)
        loss_fn(*net(ids), ids, nsp).backward()
        grads = [p.grad.clone() for p in params]
        prev = [(opt._u.get(id(p)), opt._v.get(id(p))) for p in params]
        sent = []
        opt.step()
        opt.clear_grad()
        for p, g, (u0, v0), s in zip(params, grads, prev, sent):
            u = g if u0 is None else 0.9 * u0 + g
            acc = u if v0 is None else v0 + u
            k = max(1, int(p.numel() * (1.0 - DGC_SPARSITY)))
            thresh = torch.topk(acc.abs().reshape(-1), k).values[-1]
            n_ge = int((acc.abs() >= thresh).sum())
            n_sent = int((s != 0).sum())
            if n_ge > k:
                ties += 1
            counts_ok &= n_ge == n_sent and (n_ge == k or int(
                (acc.abs() == thresh).sum()) > 1)
            exact &= bool(torch.equal(opt._v[id(p)] + s, acc))
        f = fps(net)
        equal.append(f[0] == f[1])
    res["dgc"] = {"equal": equal, "counts_ok": bool(counts_ok),
                  "exact": bool(exact), "tie_params": ties,
                  "n_params": len(params), "s": time.perf_counter() - t0}
    with open(os.path.join(outdir, f"meta_{r}.json"), "w") as f:
        json.dump(res, f)


def moe_rank(outdir):
    """One rank of (c)'s world of MOE_EP: its quarter of MOE_T tokens
    through MoELayer at ep MOE_EP (its experts) and with every expert
    local, fp32 then bf16; outputs, aux, gradients (the all-local expert
    gradients summed over the world), dropped assignments, ms per
    forward + backward. Writes outdir/moe_<r>.json."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import collective, init_parallel_env
    from paddle_tpu_torch.parallel.moe import MoELayer, top_k_gating
    env = init_parallel_env()
    r, w, dev = env.rank, env.world_size, env.device
    world = collective.get_group(0)
    t_local = MOE_T // w
    x_all = np.random.default_rng(SEED + 31).normal(
        size=(MOE_T, MOE_D)).astype(np.float32)
    x0 = torch.from_numpy(x_all[r * t_local:(r + 1) * t_local]).to(dev)
    res = {"device": str(dev)}
    for dtype in ("float32", "bfloat16"):
        out = {}
        for tag, ep in (("ep", world), ("local", None)):
            layer = MoELayer(MOE_D, MOE_H, MOE_E, top_k=MOE_K, ep_axis=ep,
                             seed=SEED, dtype=dtype)
            x = x0.to(layer.wg.dtype).detach().clone().requires_grad_()
            y, aux = layer(x, return_aux=True)
            ((y.float() ** 2).sum() + aux).backward()
            grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
            out[tag] = (y.detach(), float(aux.detach()), x.grad.clone(),
                        grads)
            times = []
            for _ in range(MOE_REPS):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                y2, aux2 = layer(x, return_aux=True)
                ((y2.float() ** 2).sum() + aux2).backward()
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            out[tag + "_ms"] = statistics.median(times)
            if tag == "local":
                with torch.no_grad():
                    dispatch, _, _ = top_k_gating(x @ layer.wg, MOE_K)
                res["dropped"] = MOE_K * t_local - int(dispatch.sum())
            del layer
        y_ep, aux_ep, xg_ep, g_ep = out["ep"]
        y_lo, aux_lo, xg_lo, g_lo = out["local"]
        tol = 1e-5 if dtype == "float32" else tol_of(torch, torch.bfloat16)
        row = {"y": close_enough(y_ep, y_lo, tol),
               "aux_equal": aux_ep == aux_lo, "aux": aux_ep,
               "ms": {"ep": out["ep_ms"], "local": out["local_ms"]}}
        if dtype == "float32":
            per = MOE_E // w
            errs = [close_enough(xg_ep, xg_lo, tol),
                    close_enough(g_ep["wg"], g_lo["wg"], tol)]
            for n in ("w1", "b1", "w2", "b2"):
                whole = g_lo[n].clone()
                collective.all_reduce(whole)
                errs.append(close_enough(g_ep[n],
                                         whole[r * per:(r + 1) * per], tol))
            row["grads"] = [max(e for e, _ in errs), all(ok for _, ok in errs)]
        res[dtype] = row
        del out, y_ep, y_lo, xg_ep, xg_lo, g_ep, g_lo
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, f"moe_{r}.json"), "w") as f:
        json.dump(res, f)


def elastic_rank(workdir):
    """One rank of (d)'s gang (started by launch_elastic as `chip_smoke.py
    --elastic-rank DIR`): config 3's DP step over the gang's gloo world,
    ELASTIC_B x 128 per rank, under AutoCheckpoint for ELASTIC_EPOCHS
    epochs of ELASTIC_STEPS steps. Rank 1 exits 9 on the first launch;
    the gang of two waits at epoch 2 until the scale-out stops it. Rank 0
    commits the snapshots and logs each epoch to DIR/elastic.log."""
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    ws = int(os.environ["PADDLE_TRAINERS_NUM"])
    launch = int(os.environ["PADDLE_ELASTIC_RESTART_COUNT"])
    if rank == 1 and launch == 0:
        return 9
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework.sharded_io import (AutoCheckpoint,
                                                       load_sharded,
                                                       save_sharded)
    from paddle_tpu_torch.parallel import DistributedStrategy, fleet
    from paddle_tpu_torch.utils import bench
    t_rank = time.perf_counter()
    st = DistributedStrategy()
    st.hybrid_configs["dp_degree"] = ws
    hcg = fleet.init(is_collective=True, strategy=st)
    dev = pt.distributed.ParallelEnv().device
    pt.seed(SEED)
    step = bench.dp_step(pt, hcg, FAULT_ERNIE)

    def save(path):
        if rank != 0:
            return
        sd = step.state_dict()
        flat = {f"params/{n}": v for n, v in sd["params"].items()}
        for i, s in enumerate(sd["slots"]):
            flat.update({f"slots/{i}/{k}": v for k, v in s.items()})
        flat["step_count"] = np.array(sd["step_count"])
        save_sharded(flat, path, process_index=0)

    def load(path):
        a = load_sharded(path)
        n_slots = 1 + max(int(k.split("/")[1]) for k in a
                          if k.startswith("slots/"))
        slots = [{} for _ in range(n_slots)]
        for k, v in a.items():
            if k.startswith("slots/"):
                _, i, name = k.split("/", 2)
                slots[int(i)][name] = v
        step.set_state_dict({
            "params": {k[7:]: v for k, v in a.items()
                       if k.startswith("params/")},
            "slots": slots, "step_count": int(a["step_count"])})

    acp = AutoCheckpoint(os.path.join(workdir, "ckpt"), save, load)
    if rank == 0:
        epochs = acp.train_epoch_range(ELASTIC_EPOCHS)
    else:
        start = acp.completed_epochs()   # read-only: rank 0 commits
        if start:
            load(acp._status()["snapshot"])
        epochs = range(start, ELASTIC_EPOCHS)
    log = open(os.path.join(workdir, "elastic.log"), "a") if rank == 0 \
        else None
    for epoch in epochs:
        if log:
            print(f"ws{ws} launch{launch} epoch{epoch} "
                  f"t={time.perf_counter() - t_rank:.1f}", file=log,
                  flush=True)
        while ws == 2 and epoch == 2:
            time.sleep(0.05)     # until the scale-out stops this gang
        for i in range(ELASTIC_STEPS):
            ids, nsp = ernie_batch(np, torch, ELASTIC_B * ws,
                                   SEED + 1000 * epoch + i, dev)
            loss = float(step(ids, ids, nsp))
        if log:
            print(f"ws{ws} launch{launch} epoch{epoch} loss {loss:.6f}",
                  file=log, flush=True)
    if log:
        print(f"ws{ws} launch{launch} done", file=log, flush=True)
        log.close()
    return 0


def fault_phase(pt, fa, torch, np, card):
    """Slice 17 on the card: (a) the guard, (b) the meta-optimizers, (c)
    MoE with expert parallelism, (d) elastic relaunch with
    AutoCheckpoint. Returns the flash launches of the guard's steps."""
    import datetime
    import tempfile
    import torch.distributed as tdist
    from paddle_tpu_torch.parallel import spawn
    from paddle_tpu_torch.parallel.elastic import (ElasticManager,
                                                   launch_elastic)
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    pt.set_device("gpu")
    with tempfile.TemporaryDirectory(prefix="fault_") as d:
        t0 = time.perf_counter()
        guard = guard_checks(pt, fa, torch, np, card, d)
        t_guard = time.perf_counter() - t0
        t0 = time.perf_counter()
        # ---- (b) LocalSGD and DGC in a world of two and (c) MoE over a
        # world of MOE_EP, both started now and run beside the in-process
        # meta checks (each world its own rendezvous and files) ----
        worlds = [
            spawn(meta_rank, args=(d,), nprocs=2,
                  backend="nccl" if n_cards >= 2 else "gloo",
                  gpus="0,1" if n_cards >= 2 else "0,0",
                  timeout=FAULT_TIMEOUT, join=False),
            spawn(moe_rank, args=(d,), nprocs=MOE_EP,
                  backend="nccl" if n_cards >= MOE_EP else "gloo",
                  gpus=",".join(str(i if n_cards >= MOE_EP else 0)
                                for i in range(MOE_EP)),
                  timeout=FAULT_TIMEOUT, join=False)]
        try:
            meta_checks(pt, torch, np, card)
        except BaseException:
            stop_worlds(worlds)
            raise
        t_meta, t_moe = join_all(worlds, t0)
        meta = [json.load(open(os.path.join(d, f"meta_{r}.json")))
                for r in range(2)]
        m0 = meta[0]
        avg_steps = [s for s in range(1, LOCALSGD_STEPS + 1)
                     if s % LOCALSGD_K == 0]
        print(f"fault [meta]: world of two ({'nccl' if n_cards >= 2 else 'gloo'}"
              f", {[x['device'] for x in meta]}), ERNIE-base width, 4 layers, "
              f"fp32 at "
              f"{FLAGSHIP_B // 2}x{FLAGSHIP_S} per rank: LocalSGD k "
              f"{LOCALSGD_K} parameters bit-equal across ranks after each "
              f"step {m0['localsgd']['equal']} ({LOCALSGD_STEPS} AdamW steps, "
              f"{m0['localsgd']['s']:.1f} s); DGC sparsity {DGC_SPARSITY}: "
              f"bit-equal after each step {m0['dgc']['equal']}, sent count = "
              f"top-k's k per parameter (ties widening "
              f"{m0['dgc']['tie_params']} of {m0['dgc']['n_params']}) "
              f"{m0['dgc']['counts_ok']}, residual + sent == accumulation "
              f"exactly {m0['dgc']['exact']} ({DGC_STEPS} steps, "
              f"{m0['dgc']['s']:.1f} s) [{card}]", flush=True)
        for x in meta:
            check(all(x["localsgd"]["equal"][s - 1] for s in avg_steps) and
                  not x["localsgd"]["equal"][0],
                  f"fault: LocalSGD fingerprints {x['localsgd']['equal']}")
            check(all(x["dgc"]["equal"]) and x["dgc"]["counts_ok"] and
                  x["dgc"]["exact"], f"fault: DGC invariants {x['dgc']}")
        moe = [json.load(open(os.path.join(d, f"moe_{r}.json")))
               for r in range(MOE_EP)]
        for x in moe:
            f32, b16 = x["float32"], x["bfloat16"]
            check(f32["y"][1] and f32["grads"][1] and f32["aux_equal"],
                  f"fault: MoE ep {MOE_EP} vs all-local fp32 {f32}")
            check(b16["y"][1] and b16["aux_equal"],
                  f"fault: MoE ep {MOE_EP} vs all-local bf16 {b16}")
        print(f"fault [moe]: MoELayer({MOE_D}, {MOE_H}, {MOE_E} experts, "
              f"top {MOE_K}) on {MOE_T} tokens, ep {MOE_EP} "
              f"({'nccl' if n_cards >= MOE_EP else 'gloo'}, "
              f"{[x['device'] for x in moe]}) vs every expert local on each "
              f"rank's {MOE_T // MOE_EP}: fp32 output max abs err "
              f"{max(x['float32']['y'][0] for x in moe):.3g}, gradients "
              f"{max(x['float32']['grads'][0] for x in moe):.3g} (tol 1e-5 "
              f"(1+|ref|)), aux equal {all(x['float32']['aux_equal'] for x in moe)}"
              f"; bf16 output {max(x['bfloat16']['y'][0] for x in moe):.3g} "
              f"(tol {tol_of(torch, torch.bfloat16)}); dropped assignments "
              f"per rank {[x['dropped'] for x in moe]} of "
              f"{MOE_K * MOE_T // MOE_EP}; ms per forward + backward fp32 ep "
              f"{MOE_EP} {[round(x['float32']['ms']['ep'], 2) for x in moe]}, "
              f"ep 1 {[round(x['float32']['ms']['local'], 2) for x in moe]}; "
              f"bf16 ep {MOE_EP} "
              f"{[round(x['bfloat16']['ms']['ep'], 2) for x in moe]}, ep 1 "
              f"{[round(x['bfloat16']['ms']['local'], 2) for x in moe]} "
              f"(beside the LocalSGD/DGC world and the meta checks) "
              f"[{card}]", flush=True)
        # ---- (d) elastic relaunch and scale-out ----
        t0 = time.perf_counter()
        store = tdist.TCPStore("127.0.0.1", 0, is_master=True,
                               wait_for_workers=False,
                               timeout=datetime.timedelta(seconds=60))
        log = os.path.join(d, "elastic.log")
        joined = threading.Event()

        def join_after_two_epochs():
            deadline = time.monotonic() + FAULT_TIMEOUT
            while time.monotonic() < deadline:
                if os.path.exists(log) and \
                        "ws2 launch1 epoch2" in open(log).read():
                    ElasticManager(store, rank=-1,
                                   world_size=0).announce_join("node-3")
                    joined.set()
                    return
                time.sleep(0.05)

        th = threading.Thread(target=join_after_two_epochs, daemon=True)
        th.start()
        res = launch_elastic(
            os.path.abspath(__file__), ["--elastic-rank", d], nprocs=2,
            max_restarts=2, timeout=FAULT_TIMEOUT, store=store, max_np=3,
            backend="gloo", gpus=",".join(
                str(i if n_cards >= 3 else 0) for i in range(3)),
            log_dir=os.path.join(d, "logs"))
        th.join(timeout=5)
        lines = open(log).read().split("\n") if os.path.exists(log) else []
        starts = [ln for ln in lines if " loss " not in ln and "epoch" in ln]
        ws3 = [ln for ln in starts if ln.startswith("ws3")]
        first3 = int(ws3[0].split("epoch")[1].split()[0]) if ws3 else None
        t_el = time.perf_counter() - t0
        print(f"fault [elastic]: launch_elastic, a gang of 2 (gloo, "
              f"{'cuda:0-2' if n_cards >= 3 else 'cuda:0'}), ERNIE-base width "
              f"(4 layers) DP "
              f"{ELASTIC_B}x{FLAGSHIP_S} per rank under AutoCheckpoint, "
              f"{ELASTIC_EPOCHS} epochs of {ELASTIC_STEPS} steps: success "
              f"{res.success}, restarts {res.restarts}, return codes "
              f"{res.returncodes}, join announced {joined.is_set()}; rank 0's "
              f"log {[ln.split(' t=')[0] for ln in starts]}; the gang of 3 "
              f"resumed at epoch {first3}; {t_el:.1f} s [{card}]",
              flush=True)
        if not res.success:
            logs = os.path.join(d, "logs")
            for name in sorted(os.listdir(logs)) if os.path.isdir(logs) \
                    else []:
                print(f"fault [elastic]: {name} tail: "
                      f"{open(os.path.join(logs, name)).read()[-3000:]}",
                      flush=True)
        check(res.success and res.restarts >= 1 and
              len(res.returncodes) == 3 and joined.is_set(),
              f"fault: elastic result {res.success} {res.restarts} "
              f"{res.returncodes}")
        check(first3 is not None and first3 == 2 and
              any(ln.startswith("ws3") and "done" in ln for ln in lines),
              f"fault: the gang of 3 did not resume at the committed epoch "
              f"2: {lines}")
    print(f"fault: phase {time.perf_counter() - t_phase:.1f} s (guard "
          f"{t_guard:.1f}, meta {t_meta:.1f}, moe {t_moe:.1f}, elastic "
          f"{t_el:.1f}) [{card}]", flush=True)
    return guard["launches"]


# ---- the static phase: to_static, dy2static and Program on the card ----
STATIC_RUNS, STATIC_REPS, STATIC_STEPS = 6, 2, 3   # cut from 20, 3
STATIC_BF16_TOL = 2e-2


def _static_flow(pt):
    """The dy2static case: a tensor if / elif, a tensor while with break,
    a for over range(tensor) with continue, an early return."""
    def flow(x, n):
        s = x.sum()
        if s > 0:
            y = x * 2.0
        elif s > -10.0:
            y = x - 1.0
        else:
            y = -x
        acc = y * 0.0
        k = 0.0
        while k < 100.0:
            acc = acc + y
            if acc.abs().sum() > 50.0:
                break
            k = k + 1.0
        j = 0
        for j in range(n):
            if j % 2 == 1:
                continue
            acc = acc + 1.0
        if acc.mean() > 1000.0:
            return acc * 0.0
        return acc + k
    return flow


def _gated_sum(x):
    if x.sum() > 0:
        return (x * 3.0).sum()
    return (x * 5.0).sum()


def static_phase(pt, fa, torch, np, card, programs):
    """Slice 18 on the card (phase 25 of the docstring). Returns the flash
    kernels' host launches of (b)'s main path; puts (d)'s two Programs in
    `programs` (for the analysis phase)."""
    import tempfile
    from paddle_tpu_torch.utils import bench
    from paddle_tpu_torch.utils.train_profile import kernel_launches
    t_phase = time.perf_counter()
    pt.set_device("gpu")
    sf_type = pt.jit.StaticFunction
    work = tempfile.TemporaryDirectory(prefix="static_")
    try:
        # ---- (a) ResNet-50 NHWC fp32 through to_static ----
        pt.seed(SEED)
        net = pt.models.resnet50(data_format="NHWC")
        net.eval()
        live_net = copy.deepcopy(net)
        x_np = np.random.default_rng(SEED).random((DEPLOY_B, 224, 224, 3),
                                                  dtype=np.float32)
        x = torch.from_numpy(x_np).cuda()
        with torch.no_grad():
            eager = net(x)
        pt.jit.to_static(net)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            first = net(x)
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        with torch.no_grad():
            replayed = net(x)
        n_prog, n_cap = len(net.forward._programs), len(
            net.forward.captures())
        e1, e2 = rel_l2(first, eager), rel_l2(replayed, eager)
        check(n_prog == 1 and n_cap == 1,
              f"static: {n_prog} programs, {n_cap} captures (want 1, 1)")
        check(e1 <= DEPLOY_TOL and e2 <= DEPLOY_TOL,
              f"static: to_static vs eager {e1}, {e2}")

        def replay():
            with torch.no_grad():
                return net(x)

        rate, spread, _ = bench._timed_rate(
            lambda: [replay() for _ in range(STATIC_RUNS)],
            DEPLOY_B * STATIC_RUNS, STATIC_REPS, torch.device("cuda"))
        busy, idle, wall = busy_ms(torch, replay, STATIC_RUNS)
        path = os.path.join(work.name, "r50_static")
        t0 = time.perf_counter()
        pt.jit.save(net, path, input_spec=[pt.InputSpec(
            [DEPLOY_B, 224, 224, 3], "float32")])
        save_s = time.perf_counter() - t0
        cfg = pt.inference.Config(path)
        cfg.enable_use_gpu(device_id=0)
        art = pt.inference.create_predictor(cfg)
        e_art = rel_l2(art.run([x_np])[0], eager)
        check(e_art <= DEPLOY_TOL, f"static: saved artifact vs eager {e_art}")
        art_rate, art_spread = bench.predictor_rate(art, x_np, STATIC_RUNS,
                                                    STATIC_REPS)
        del art
        live = pt.inference.Predictor(live_net, input_spec=[pt.InputSpec(
            [DEPLOY_B, 224, 224, 3], "float32")])
        t0 = time.perf_counter()
        e_live = rel_l2(live.run([x_np])[0], eager)
        live_s = time.perf_counter() - t0
        check(isinstance(live._fn, sf_type) and len(live._fn._programs) == 1
              and len(live._fn.captures()) == 1 and e_live <= DEPLOY_TOL,
              f"static: live-layer predictor {type(live._fn)} vs eager "
              f"{e_live}")
        live_rate, live_spread = bench.predictor_rate(live, x_np,
                                                      STATIC_RUNS,
                                                      STATIC_REPS)
        n_bufs = len(live.bucket_buffers())
        print(f"static: (a) ResNet-50 NHWC fp32 through jit.to_static, "
              f"batch {DEPLOY_B}, no_grad: first call (export + capture) "
              f"{export_s:.1f} s, {n_prog} program and {n_cap} capture; "
              f"relative L2 vs the eager layer first {e1:.3g}, replay "
              f"{e2:.3g} (tol {DEPLOY_TOL}); replay {rate:.1f} imgs/s "
              f"(spread {spread:.3f}, {STATIC_RUNS} calls x {STATIC_REPS}), "
              f"device busy {busy:.3f} ms per call, idle share {idle:.4f} "
              f"(profiled wall {wall:.3f} ms); jit.save of the to_static'd "
              f"layer {save_s:.1f} s -> create_predictor: relative L2 "
              f"{e_art:.3g}, {art_rate:.1f} imgs/s (spread "
              f"{art_spread:.3f}); a Predictor over the live layer (through "
              f"to_static: first run {live_s:.1f} s, {n_bufs} bucket "
              f"buffers) relative L2 {e_live:.3g}, {live_rate:.1f} imgs/s "
              f"(spread {live_spread:.3f}) [{card}]", flush=True)
        del live, live_net
        torch.cuda.empty_cache()

        # dropout in a replay draws fresh bits
        drop = pt.jit.to_static(pt.nn.Dropout(0.5))
        ones = torch.ones(4096, device="cuda")
        with torch.no_grad():
            masks = [drop(ones).clone() for _ in range(3)]
        n_drop = len(drop.forward.captures())
        fresh = not torch.equal(masks[1], masks[2])
        share = float((masks[2] == 0).float().mean())
        print(f"static: a to_static'd Dropout(0.5) in training mode, no_grad "
              f"on the card: {n_drop} capture, replays draw fresh bits "
              f"{fresh}, dropped share {share:.3f} [{card}]", flush=True)
        check(n_drop == 1 and fresh and 0.4 < share < 0.6,
              f"static: dropout replay {n_drop} {fresh} {share}")

        # ---- (d) on (a)'s Program ----
        prog = programs["ResNet-50"] = net.forward.program()
        hist = prog.op_histogram()
        convs = sum(v for k, v in hist.items() if "conv" in k)
        check(convs == 53 and hist.get("aten.linear") == 1,
              f"static: ResNet-50 histogram {hist}")
        params = list(pt.jit.split_state(net)[0].values())
        with torch.no_grad():
            base = prog.run(*params, x)
            pass_err = {}
            for name in ("dead_op_elim", "remat", "bf16_io"):
                t0 = time.perf_counter()
                out = prog.apply_pass(name).run(*params, x)
                pass_err[name] = (rel_l2(out.float(), base),
                                  time.perf_counter() - t0)
            pruned = prog.prune([0])
            pass_err["prune"] = (rel_l2(pruned.run(*params, x), base), 0.0)
        print(f"static: (d) ResNet-50's Program: {len(prog.ops())} ops, "
              f"{convs} convolutions, {hist.get('aten.linear')} linear, "
              f"{prog.num_blocks()} block; relative L2 to the unpassed "
              f"program (and the seconds of pass + export + run): "
              f"{ {k: (float(f'{e:.3g}'), round(t, 1)) for k, (e, t) in pass_err.items()} } "
              f"(tol {DEPLOY_TOL}, bf16_io {STATIC_BF16_TOL}) [{card}]",
              flush=True)
        for name, (e, _) in pass_err.items():
            check(e <= (STATIC_BF16_TOL if name == "bf16_io" else DEPLOY_TOL),
                  f"static: ResNet-50 {name} {e}")
        del net, prog, params, base, eager, first, replayed, x
        torch.cuda.empty_cache()

        # ---- (b) GPT-2 small through to_static, trained ----
        launches = gpt2_static(pt, fa, torch, np, card, kernel_launches,
                               programs)

        # ---- (c) dy2static on the card ----
        flow_py = _static_flow(pt)
        flow = pt.jit.to_static(flow_py)
        cases = [(np.full(6, 0.5, np.float32), 5),
                 (np.full(6, -0.5, np.float32), 4),
                 (np.full(6, -3.0, np.float32), 0)]
        for arr, n in cases:
            xs = pt.to_tensor(arr)
            ns = pt.to_tensor(np.asarray(n, np.int32))
            got = flow(xs, ns)
            want = flow_py(xs, n)
            check(torch.equal(torch.as_tensor(got), torch.as_tensor(want)),
                  f"static: dy2static {arr[0]} {n}: {got} vs {want}")
        fhist = flow.program().op_histogram()
        check(fhist.get("higher_order.cond", 0) >= 3 and
              fhist.get("higher_order.while_loop", 0) == 2,
              f"static: dy2static program {fhist}")
        gated = pt.jit.to_static(_gated_sum)
        grads = []
        for sign in (1.0, -1.0):
            for fn in (gated, _gated_sum):
                v = pt.to_tensor(np.full(4, sign, np.float32),
                                 stop_gradient=False)
                fn(v).backward()
                grads.append(v.grad.clone())
        check(torch.equal(grads[0], grads[1]) and
              torch.equal(grads[2], grads[3]) and
              float(grads[0][0]) == 3.0 and float(grads[2][0]) == 5.0,
              f"static: gradient through cond {grads}")
        print(f"static: (c) dy2static on the card: the flow function equal "
              f"to its eager run at {len(cases)} inputs, its program "
              f"{ {k: v for k, v in fhist.items() if 'higher_order' in k} } "
              f"({flow.program().num_blocks()} blocks); the gradient through "
              f"a cond {float(grads[0][0])} / {float(grads[2][0])}, equal to "
              f"eager [{card}]", flush=True)
    finally:
        work.cleanup()
    print(f"static: phase wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return launches


def gpt2_static(pt, fa, torch, np, card, kernel_launches, programs):
    """(b) and (d) on GPT-2 small: to_static training against eager."""
    pt.seed(SEED)
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    n_layers = len(model.gpt.layers)
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)).cuda()
    eager_fwd = type(model).forward.__get__(model)
    pt.jit.to_static(model)
    F = pt.nn.functional

    def step(fwd, opt):
        with pt.amp.auto_cast(dtype="bfloat16"):
            logits = fwd(ids)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, vocab).float(),
                               ids[:, 1:].reshape(-1)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    def loop(fwd, n=STATIC_STEPS):
        opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
        losses, ms = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(step(fwd, opt))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(losses).float(), ms, opt

    counters = {"flash_fwd": fa.flash_attention_fwd,
                "flash_bwd_fused": fa.flash_attention_bwd_fused,
                "flash_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_bwd_dkv": fa.flash_attention_bwd_dkv}
    # the main path: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    losses, ms, opt = loop(model)
    launches = {k: c.launches for k, c in counters.items()}
    check(launches["flash_fwd"] == n_layers * STATIC_STEPS and
          launches["flash_bwd_fused"] == n_layers * STATIC_STEPS and
          launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          f"static: GPT-2 to_static launches {launches}")
    lo = losses.tolist()
    check(all(math.isfinite(v) for v in lo) and lo[-1] < lo[0],
          f"static: GPT-2 to_static losses {lo}")
    # one step of each backward under the profiler: its host launches
    # exactly, and in its device trace each kernel that ran and none that
    # did not (a trace can lose kernel records, never add one: PERF.md)
    traced, host = {}, {}
    for det in (False, True):
        with determinism(torch, det):
            for c in counters.values():
                c.launches = 0
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                step(model, opt)
                torch.cuda.synchronize()
            host[det] = tuple(c.launches for c in counters.values())
        k = kernel_launches(prof)
        traced[det] = tuple(k[name] for name in counters)
    want = {False: (n_layers, n_layers, 0, 0), True: (n_layers, 0, n_layers,
                                                      n_layers)}
    for det in (False, True):
        check(host[det] == want[det] and all(
            (0 < t <= w) if w else t == 0
            for t, w in zip(traced[det], want[det])),
            f"static: a step (deterministic {det}): host launches "
            f"{host[det]}, device trace {traced[det]}, want {want[det]}")
    # a no-grad replay reads the weights the optimizer updated in place
    with torch.no_grad(), pt.amp.auto_cast(dtype="bfloat16"):
        before = model(ids).float()
    step(model, opt)
    with torch.no_grad(), pt.amp.auto_cast(dtype="bfloat16"):
        after = model(ids).float()
        eager_after = eager_fwd(ids).float()
    n_cap = len(model.forward.captures())
    moved = rel_l2(after, before)
    e_after = rel_l2(after, eager_after)
    check(n_cap == 1 and moved > 0 and e_after <= 1e-3,
          f"static: replay after opt.step(): {n_cap} captures, moved "
          f"{moved}, vs eager {e_after}")
    # parity from one state under deterministic algorithms
    finals, det_losses = [], []
    for fwd in (model, eager_fwd):
        model.load_state_dict(saved)
        with determinism(torch, True):
            dl, _, _ = loop(fwd)
        det_losses.append(dl)
        finals.append([p.detach().float().clone()
                       for p in model.parameters()])
    rel = ((det_losses[0] - det_losses[1]).abs() /
           det_losses[1].abs()).max().item()
    names = [n for n, _ in model.named_parameters()]
    low = min((cosine(a, b), n) for a, b, n in zip(*finals, names))
    del finals
    print(f"static: (b) GPT-2 small through jit.to_static, {TRAIN_B} x "
          f"{TRAIN_S}, bf16 auto_cast, AdamW, {STATIC_STEPS} steps of "
          f"loss.backward() across the static boundary: losses "
          f"{[round(v, 4) for v in lo]}, ms per step {[round(v, 1) for v in ms]} "
          f"(the first exports); host launches {launches}; one step's "
          f"(fwd, fused, dq, dk/dv) host launches {host[False]} and "
          f"deterministic {host[True]}, in the device trace {traced[False]} "
          f"and {traced[True]}; a no-grad replay after opt.step() "
          f"moved {moved:.3g} and is {e_after:.3g} from eager ({n_cap} "
          f"capture); vs the eager loop from one state, deterministic: max "
          f"rel loss diff {rel:.3g} (tol 1e-4), lowest parameter cosine "
          f"{low[0]:.8f} ({low[1]}, tol 0.9999) [{card}]", flush=True)
    check(rel <= 1e-4, f"static: to_static vs eager losses {det_losses}")
    check(low[0] >= 0.9999, f"static: parameter cosine {low}")

    # ---- (d) on (b)'s Program ----
    prog = programs["GPT-2"] = model.forward.program()
    hist = prog.op_histogram()
    check(hist.get("aten.linear") == 4 * n_layers,
          f"static: GPT-2 histogram {hist}")
    params = list(pt.jit.split_state(model)[0].values())
    with torch.no_grad():
        base = prog.run(*params, ids).float()
        errs = {}
        for name in ("dead_op_elim", "remat", "bf16_io"):
            t0 = time.perf_counter()
            out = prog.apply_pass(name).run(*params, ids).float()
            errs[name] = (rel_l2(out, base), time.perf_counter() - t0)
            del out
    print(f"static: (d) GPT-2's Program (auto_cast bf16): {len(prog.ops())} "
          f"ops, {hist.get('aten.linear')} linears, flash nodes "
          f"{sum(v for k, v in hist.items() if 'flash' in k)}; relative L2 "
          f"to the unpassed program (seconds): "
          f"{ {k: (float(f'{e:.3g}'), round(t, 1)) for k, (e, t) in errs.items()} } "
          f"(tol {STATIC_BF16_TOL}) [{card}]", flush=True)
    for name, (e, _) in errs.items():
        check(e <= STATIC_BF16_TOL, f"static: GPT-2 {name} {e}")
    del model, prog, params, base
    torch.cuda.empty_cache()
    return launches


# ---- slice 19: tpu-lint and the persistent compile cache ----
# the warm-start workload's processes (each a fresh interpreter: imports,
# the kernels' load, then its exports or loads); its signatures (2 of the
# to_static predictor, GPT-2's 3 serve buckets, 1 training step, 2
# TransformerEncoderLayers differing only in their activation); an entry's
# size limit (it holds no weights); the activation layers' gap to eager
# (fp32, TF32 off)
WARM_TIMEOUT = 600
WARM_SIGNATURES = 8
WARM_ENTRY_MAX = 50 * 2 ** 20
WARM_ACT_TOL = 1e-4


def analysis_phase(pt, torch, card, programs, signatures):
    """Slice 19's tpu-lint on the card (phase 26 of the docstring)."""
    import collections
    import io
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import cli, concurrency, graph
    from paddle_tpu_torch.parallel.collective import CollectiveDesc
    from paddle_tpu_torch.static.program import op_names
    t_phase = time.perf_counter()
    for name, prog in programs.items():
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            lint = prog.apply_pass("lint").lint_findings
            conc = prog.apply_pass("concurrency").concurrency_findings
        seconds = time.perf_counter() - t0
        names = op_names(prog.exported().graph_module)
        flash = names.count("paddle_tpu_torch.flash_fwd")
        rules = dict(collections.Counter(f.rule for f in lint + conc))
        errors = [f.format() for f in lint + conc if f.severity == "error"]
        callbacks = [f.format() for f in lint if f.rule == "host-callback"]
        print(f"analysis: {name}'s to_static Program exported on the card "
              f"({len(names)} ops, {flash} flash_fwd nodes): the lint pass "
              f"{len(lint)} finding(s) {rules}, the concurrency pass "
              f"{len(conc)}; {seconds:.2f} s for both [{card}]", flush=True)
        check(not errors and not callbacks and not conc,
              f"analysis: {name}: errors {errors[:3]}, host callbacks "
              f"{callbacks[:3]}, concurrency {[f.format() for f in conc]}")
        if name == "GPT-2":
            check(flash == 12, f"analysis: GPT-2 flash nodes {flash}")
    # the dist phase's ranks, each sequence traced without communicating
    for tag, ranks in signatures.items():
        seqs = {f"rank{r}": [CollectiveDesc(op, tuple(ax) if isinstance(
            ax, list) else ax, shape, dtype, perm)
            for op, ax, shape, dtype, perm in sig]
            for r, sig in enumerate(ranks)}
        fs = graph.verify_collective_order(seqs)
        ref = seqs["rank0"]
        skewed = graph.verify_collective_order(
            {"rank0": ref, "rank1 (its last collective dropped)": ref[:-1]})
        print(f"analysis: verify_collective_order over the dist phase's "
              f"{tag} world: {len(seqs)} rank(s), {len(ref)} collectives "
              f"each ({', '.join(sorted({d.op for d in ref}))}), "
              f"{len(fs)} finding(s); a rank with its last collective "
              f"dropped: {[f.message[:120] for f in skewed]} [{card}]",
              flush=True)
        check(ref and fs == [] and [f.rule for f in skewed] ==
              ["collective-order"], f"analysis: {tag} {fs} {skewed}")
    # the self-gates on this checkout
    pkg = os.path.join(HERE, "paddle_tpu_torch")
    t0 = time.perf_counter()
    conc, n_files, sites = concurrency.analyze_paths([pkg])
    dirs = [os.path.join(pkg, d) for d in ("models", "nn", "ops")]
    lint, n_lint = analysis.lint_paths(dirs, all_functions=True)
    rc = cli.main(dirs, stdout=io.StringIO())
    print(f"analysis: the concurrency pass over paddle_tpu_torch ({n_files} "
          f"files): {len(conc)} finding(s), {len(concurrency.find_cycles(sites))} "
          f"lock cycles; the lint (--all) over models/, nn/, ops/ "
          f"({n_lint} files): {len(lint)} finding(s); `python -m "
          f"paddle_tpu_torch.analysis` over them exits {rc}; "
          f"{time.perf_counter() - t0:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    check(not conc and not lint and rc == 0 and not
          concurrency.find_cycles(sites), f"analysis: self-gates {conc} "
          f"{lint}")


def _cached_fn(x):
    return (x * 2.0 + 1.0).tanh()


def _doctor_manifest(d, key, **fields):
    path = os.path.join(d, key + ".json")
    with open(path) as f:
        manifest = json.load(f)
    manifest.update(fields)
    with open(path, "w") as f:
        json.dump(manifest, f)


def warm_start_phase(pt, torch, np, card, cache_dir=None):
    """Slice 19's persistent compile cache on the card (phase 27 of the
    docstring), over `cache_dir` (an empty directory the caller keeps for
    the fleet phase's replicas, or one of the arm's own). Returns the flash
    kernels' host launches of both processes' main paths."""
    import shutil
    import tempfile
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.core import compile_cache as cc
    from paddle_tpu_torch.utils import bench
    from paddle_tpu_torch.utils import warm_start as ws
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary = bench.warm_start(device="gpu", timeout=WARM_TIMEOUT,
                               cache_dir=cache_dir)
    check("error" not in summary, f"warm_start: {summary.get('error')}")
    runs, rows = summary["records"], summary["entries"]
    cold, warm = runs["cold"], runs["warm"]
    digests = {arm: ws.digests(r) for arm, r in runs.items()}
    n_layers = 12
    want_serve = {"flash_fwd": 2 * n_layers * 3, "flash_bwd_fused": 0,
                  "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    want_train = {"flash_fwd": 2 * n_layers, "flash_bwd_fused": 0,
                  "flash_bwd_dq": 2 * n_layers, "flash_bwd_dkv": 2 * n_layers}
    for arm, r in runs.items():
        check(r["gpt_serve"]["launches"] == want_serve and
              r["gpt_train"]["launches"] == want_train,
              f"warm_start: {arm} flash host launches serve "
              f"{r['gpt_serve']['launches']}, train "
              f"{r['gpt_train']['launches']}")
        check(r["gpt_serve"]["flash_nodes"] == [n_layers] * 3 and
              r["gpt_train"]["flash_nodes"] == [n_layers] and
              r["gpt_serve"]["finite"] and
              all(math.isfinite(v) for v in r["gpt_train"]["losses"]),
              f"warm_start: {arm} flash nodes {r['gpt_serve']['flash_nodes']}"
              f" {r['gpt_train']['flash_nodes']}, losses "
              f"{r['gpt_train']['losses']}")
    check(cold["report"]["exports"] == cold["compile_cache"]["stores"] ==
          WARM_SIGNATURES and cold["compile_cache"]["export_skips"] == 0,
          f"warm_start: cold {cold['report']}")
    check(warm["report"]["exports"] == 0 and warm["report"]["warm"] and
          warm["compile_cache"]["hits"] == WARM_SIGNATURES and
          warm["compile_cache"]["misses"] == 0 and
          warm["compile_cache"]["fallbacks"] == 0,
          f"warm_start: warm {warm['report']}")
    check(digests["warm"] == digests["cold"] and summary["bit_identical"],
          f"warm_start: digests {digests}")
    for arm, r in runs.items():
        act = r["activations"]
        check(act["differ"] and act["max_abs_err"] <= WARM_ACT_TOL,
              f"warm_start: {arm} relu / gelu TransformerEncoderLayers "
              f"{act}")
    check(len(rows) == WARM_SIGNATURES and
          all(r["bytes"] < WARM_ENTRY_MAX for r in rows),
          f"warm_start: entries {[(r['label'], r['bytes']) for r in rows]}")
    pairs = [(c["label"], c["export_s"], w["load_s"], w["bytes"])
             for c, w in zip(cold["programs"], warm["programs"])]
    print(f"warm_start: {WARM_SIGNATURES} to_static signatures (the "
          f"predictor's 2, GPT-2 small's 3 serve buckets at 1024 tokens in "
          f"bf16, its bf16 training step at {TRAIN_B} x {TRAIN_S}, the relu "
          f"and gelu TransformerEncoderLayers: outputs differ "
          f"{warm['activations']['differ']}, max |export - eager| "
          f"{max(r['activations']['max_abs_err'] for r in runs.values()):.3g}"
          f"): per "
          f"signature (label, cold export s, warm load s, entry bytes) "
          f"{[(l, round(e, 3), round(ld, 3), b) for l, e, ld, b in pairs]} "
          f"[{card}]", flush=True)
    print(f"warm_start: cold process exports {cold['report']['exports']}, "
          f"stores {cold['compile_cache']['stores']}, wall "
          f"{cold['wall_s']:.1f} s; warm process exports "
          f"{warm['report']['exports']}, hits {warm['compile_cache']['hits']}"
          f", warm {warm['report']['warm']}, wall {warm['wall_s']:.1f} s; "
          f"GPT-2's serve warm-up (3 signatures: export or load, eager run, "
          f"capture) cold {cold['gpt_serve']['warm_start_ms']:.0f} ms, warm "
          f"{warm['gpt_serve']['warm_start_ms']:.0f} ms; the first "
          f"to_static training step cold {cold['t_first_train_s']:.2f} s, "
          f"warm {warm['t_first_train_s']:.2f} s (then "
          f"{cold['gpt_train']['ms'][1]:.1f} / "
          f"{warm['gpt_train']['ms'][1]:.1f} ms); serve, train and LeNet "
          f"digests bit-identical {digests['warm'] == digests['cold']}; "
          f"flash host launches per process: serve warm-up "
          f"{warm['gpt_serve']['launches']['flash_fwd']} (12 a forward: "
          f"eager run + capture of 3 signatures), 2 training steps "
          f"{ {k: v for k, v in warm['gpt_train']['launches'].items() if v} } "
          f"(deterministic: rows 1, 3, 4); flash_fwd nodes per loaded "
          f"program {warm['gpt_serve']['flash_nodes']} + "
          f"{warm['gpt_train']['flash_nodes']}; trace_compile (captures "
          f"included) cold {cold['trace_compile']}, warm "
          f"{warm['trace_compile']} [{card}]", flush=True)

    # a bad entry falls back to a fresh export, counted and pruned
    x = torch.linspace(-2, 2, 4096, device="cuda").reshape(64, 64)
    fn = pt.jit.to_static(_cached_fn)
    seen = {}
    with tempfile.TemporaryDirectory(prefix="cc_fallback_") as d:
        pt.set_flags({"FLAGS_compile_cache_dir": d})
        try:
            for damage in ("corrupt", "torn", "stale_torch_version",
                           "wrong_topology"):
                shutil.rmtree(d, ignore_errors=True)
                fn.release()
                with (faults.inject("compile_cache.write:torn")
                      if damage == "torn" else contextlib.nullcontext()):
                    want = fn(x)
                (row,) = cc.entries(d)
                if damage == "corrupt":
                    with open(os.path.join(d, row["key"] + ".bin"),
                              "r+b") as f:
                        f.seek(64)
                        f.write(b"\x00\xff\x00")
                elif damage == "stale_torch_version":
                    _doctor_manifest(d, row["key"], torch_version="0.0.1")
                elif damage == "wrong_topology":
                    _doctor_manifest(d, row["key"], topology="elsewhere")
                fn.release()
                before, exports = cc.fallbacks, cc.exports
                got = fn(x)
                seen[damage] = (cc.fallbacks - before, cc.exports - exports,
                                torch.equal(got, want), cc.verify(d))
        finally:
            pt.set_flags({"FLAGS_compile_cache_dir": ""})
    print(f"warm_start: a damaged entry on the card (fallbacks, exports, "
          f"output equal, verify after): {seen}; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    check(all(v == (1, 1, True, (1, [])) for v in seen.values()),
          f"warm_start: fallbacks {seen}")
    return {k: cold["gpt_serve"]["launches"][k] + cold["gpt_train"][
        "launches"][k] + warm["gpt_serve"]["launches"][k] +
        warm["gpt_train"]["launches"][k] for k in want_serve}


# ---- the ps phase: the parameter-server tier driving a CTR-DNN ----
# PaddleRec models/rank/dnn (config.yaml): 26 sparse slots over one table
# of sparse_feature_number rows of sparse_feature_dim, 13 dense features,
# fc_sizes, batch 512; ids per slot from a Zipf law
PS_SLOTS, PS_DENSE, PS_VOCAB, PS_DIM = 26, 13, 1_000_001, 9
PS_FC, PS_B = (512, 256, 128, 32), 512
PS_STEPS, PS_PARITY_STEPS, PS_LOCAL_STEPS, PS_WARM = 40, 5, 3, 3
PS_ZIPF, PS_LR = 1.2, 0.001
PS_SGD_LR = 0.25          # exact in f32: the wire carries the rate as f32
PS_SNAP_AT = 30           # the snapshot: steps after it are a WAL suffix


def ps_write_slots(np, d, n, seed):
    """MultiSlotDataFeed files of n Criteo-shaped samples: 26 one-id
    sparse slots (Zipf ids, each slot in its own stretch of the table), 13
    dense floats, a click that depends on two dense features and one slot."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(PS_ZIPF, (n, PS_SLOTS)) - 1
           + np.arange(PS_SLOTS) * (PS_VOCAB // PS_SLOTS)) % PS_VOCAB
    dense = rng.standard_normal((n, PS_DENSE)).astype(np.float32)
    click = ((dense[:, 0] + 0.5 * dense[:, 1] + (ids[:, 0] % 3 == 0) - 0.5)
             > 0).astype(np.int64)
    files = []
    for part, rows in enumerate(np.array_split(np.arange(n), 4)):
        path = os.path.join(d, f"part-{part}")
        with open(path, "w") as f:
            for i in rows:
                f.write(" ".join(f"1 {v}" for v in ids[i]) + f" {PS_DENSE} "
                        + " ".join(f"{v:.6f}" for v in dense[i])
                        + f" 1 {click[i]}\n")
        files.append(path)
    return files


def ps_dataset(pt, files, seed):
    ds = pt.distributed.InMemoryDataset()
    slots = [f"C{i}" for i in range(1, PS_SLOTS + 1)]
    ds.init(batch_size=PS_B, use_slots=slots + ["dense", "click"],
            slot_types=["uint64"] * PS_SLOTS + ["float", "uint64"])
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.local_shuffle(seed=seed)
    return ds


def ps_tower(pt, torch, device):
    """The CTR-DNN's dense tower from the seed, built on the CPU (so every
    run starts from the same weights) and moved to `device`."""
    pt.set_device("cpu")
    pt.seed(SEED)
    layers, width = [], PS_SLOTS * PS_DIM + PS_DENSE
    for h in PS_FC:
        layers += [pt.nn.Linear(width, h), pt.nn.ReLU()]
        width = h
    tower = pt.nn.Sequential(*layers, pt.nn.Linear(width, 2))
    tower.to(device)
    pt.set_device("gpu" if device.type == "cuda" else "cpu")
    return tower


def ps_arrays(np, batch):
    ids = np.stack([batch[f"C{i}"][:, 0] for i in range(1, PS_SLOTS + 1)],
                   1).astype(np.int64)
    return ids, batch["dense"], batch["click"][:, 0].astype(np.int64)


def ps_legs(pt):
    """{leg: seconds so far} of DistributedEmbedding's monitor legs."""
    return {k: pt.monitor.histogram(f"ps.embedding.{k}").sum
            for k in ("pull", "h2d", "d2h", "push")}


def ps_step(torch, lookup, tower, opt, ce, ids, dense, click, device):
    """One CTR-DNN step, as every run of the phase takes it: the rows of
    `ids` (pulled by a DistributedEmbedding, or a local sparse Embedding's),
    the tower, the loss, its backward (which pushes a DistributedEmbedding's
    row gradients) and the optimizer step. Returns the rows and the loss."""
    rows = lookup(ids)
    feat = torch.cat([rows.reshape(PS_B, -1),
                      torch.from_numpy(dense).to(device)], 1)
    loss = ce(tower(feat), torch.from_numpy(click).to(device))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return rows, loss


def ps_servers(pt, wal_dir, optimizer, lr):
    """A python PsServer (with a WAL) and a NativePsServer; the table made
    over the wire on both, ids split by id % 2."""
    from paddle_tpu_torch.distributed import ps
    py = ps.PsServer("127.0.0.1", 0, wal_dir=wal_dir)
    py.run()
    nat = ps.NativePsServer()
    client = ps.PsClient([f"127.0.0.1:{py.port}", f"127.0.0.1:{nat.port}"])
    client.create_sparse_table("emb", PS_DIM, optimizer=optimizer, lr=lr,
                               seed=SEED + 20)
    return py, nat, client


def ps_train(pt, torch, np, ds, device, optimizer, lr, steps, wal_dir,
             trace_ds=None, snapshot_at=None):
    """The CTR flow through the PS for `steps` batches of `ds` on
    `device`: Executor.train_from_dataset over a program that pulls the
    rows (DistributedEmbedding), runs the tower, pushes through the
    Communicator and flushes. Returns the losses, the tower's final
    state, the per-step records, the python server's state and the rows
    of the ids it saw. With `trace_ds`, each record also holds the step's
    monitor legs (`ps.embedding.{pull,h2d,d2h,push}`), and the same
    program then runs over `trace_ds` under the profiler for the device's
    busy time and idle share."""
    from paddle_tpu_torch.distributed import ps
    py, nat, client = ps_servers(pt, wal_dir, optimizer, lr)
    comm = ps.Communicator(client)
    out = {}
    try:
        pt.set_device("gpu" if device.type == "cuda" else "cpu")
        emb = ps.DistributedEmbedding(client, "emb", PS_DIM,
                                      communicator=comm)
        tower = ps_tower(pt, torch, device)
        opt = (pt.optimizer.Adam if optimizer == "adam" else
               pt.optimizer.SGD)(parameters=tower.parameters(),
                                 learning_rate=lr)
        ce = pt.nn.CrossEntropyLoss()
        recs, seen, limit = [], [], [steps]

        def program(batch):
            t_in = time.perf_counter()
            if len(recs) >= limit[0]:
                return float("nan")      # past the run: no step
            if snapshot_at is not None and len(recs) == snapshot_at:
                t0 = time.perf_counter()
                py.snapshot()
                out["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
            ids, dense, click = ps_arrays(np, batch)
            seen.append(ids)
            legs0 = ps_legs(pt)
            t0 = time.perf_counter()
            rows, loss = ps_step(torch, emb, tower, opt, ce, ids, dense,
                                 click, device)
            lv = float(loss.detach())
            t1 = time.perf_counter()
            comm.flush()
            t2 = time.perf_counter()
            check(rows.device == device, f"ps: rows on {rows.device}")
            rec = {"loss": lv, "in": t_in, "out": t2,
                   "step_ms": (t2 - t0) * 1e3, "flush_ms": (t2 - t1) * 1e3}
            rec.update({k: (v - legs0[k]) * 1e3
                        for k, v in ps_legs(pt).items()})
            recs.append(rec)
            return lv

        exe = pt.static.Executor()
        if trace_ds is not None:
            pt.monitor.enable()
        losses = [x for x in exe.train_from_dataset(program, ds)
                  if not math.isnan(x)]
        if trace_ds is not None:
            pt.monitor.disable()
            pt.monitor.reset()
            n0, limit[0] = len(recs), math.inf
            from paddle_tpu_torch.utils import bench
            busy, idle, wall = bench.busy_ms(
                lambda: exe.train_from_dataset(program, trace_ds), 1, device)
            out["traced_steps"] = len(recs) - n0
            out["busy_ms"], out["idle_share"], out["traced_ms"] = \
                busy, idle, wall
        check(all(p.device == device for p in tower.parameters()),
              "ps: the tower left the device")
        out.update(losses=losses, recs=recs,
                   tower={k: v.detach().cpu().numpy()
                          for k, v in tower.state_dict().items()},
                   applied_lsn=py.applied_lsn,
                   table=py.table("emb").snapshot_arrays(),
                   ids=np.unique(np.concatenate(seen)))
        out["rows"] = client.pull_sparse("emb", out["ids"])
    finally:
        comm.stop()
        client.close()
        py.stop()
        nat.stop()
    return out


def ps_local(pt, torch, np, ds, device, init_rows, ids_all, lr, steps,
             opt_name="sgd", lazy=False):
    """One process: a local Embedding(sparse=True) over the table,
    seeded with `init_rows` at `ids_all`, the same tower and loss, the
    sparse rule on `device`."""
    pt.set_device("gpu" if device.type == "cuda" else "cpu")
    emb = pt.nn.Embedding(PS_VOCAB, PS_DIM, sparse=True)
    with torch.no_grad():
        emb.weight.zero_()
        emb.weight[torch.from_numpy(ids_all).to(emb.weight.device)] = \
            torch.from_numpy(init_rows).to(emb.weight.device)
    emb.to(device)
    tower = ps_tower(pt, torch, device)
    if opt_name == "sgd":
        opt = pt.optimizer.SGD(parameters=list(emb.parameters())
                               + list(tower.parameters()), learning_rate=lr)
    else:
        opt = pt.optimizer.Adam(parameters=list(emb.parameters())
                                + list(tower.parameters()),
                                learning_rate=lr, lazy_mode=lazy)
    ce = pt.nn.CrossEntropyLoss()
    emb.weight.register_hook(
        lambda g: check(g.is_sparse, "ps: the local gradient is dense"))
    losses = []
    it = iter(ds)
    for _ in range(steps):
        ids, dense, click = ps_arrays(np, next(it))
        _, loss = ps_step(torch, lambda i: emb(torch.from_numpy(i).to(
            device)), tower, opt, ce, ids, dense, click, device)
        losses.append(float(loss.detach()))
    return losses, {k: v.detach().cpu().numpy()
                    for k, v in tower.state_dict().items()}, \
        emb.weight.detach().cpu().numpy()


def ps_push_rate(pt, np, server, rows, reps=5):
    """Rows per second of synchronous sparse pushes of `rows` ids x 9 to
    one server, through a client of that server alone."""
    from paddle_tpu_torch.distributed import ps
    client = ps.PsClient([f"127.0.0.1:{server.port}"])
    try:
        client.create_sparse_table("rate", PS_DIM, optimizer="adam",
                                   lr=PS_LR, seed=1)
        ids = np.arange(rows, dtype=np.int64) * 2
        g = np.full((rows, PS_DIM), 1e-3, np.float32)
        client.push_sparse("rate", ids, g)           # the rows exist
        t0 = time.perf_counter()
        for _ in range(reps):
            client.push_sparse("rate", ids, g)
        return rows * reps / (time.perf_counter() - t0)
    finally:
        client.close()


def ps_dev(np, got, want):
    return float(np.max(np.abs(got - want) / (1 + np.abs(want))))


def ps_phase(pt, torch, np, card, dev=None):
    """The CTR flow through the parameter-server tier (see the
    module docstring, phase 28) on `dev` (cuda:0)."""
    import tempfile
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.utils import bench
    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory(prefix="ps_") as d:
        t0 = time.perf_counter()
        n = PS_B * (PS_STEPS + 8)
        files = ps_write_slots(np, d, n, SEED + 21)
        ds = ps_dataset(pt, files, SEED + 22)
        data_s = time.perf_counter() - t0
        check(ds.get_memory_data_size() == n, "ps: dataset size")
        # the traced run: the same program over one of the four files
        trace_ds = ps_dataset(pt, files[:1], SEED + 23)
        # (a) the main run: Adam table, 40 steps on the card, timed
        main = ps_train(pt, torch, np, ds, dev, "adam", PS_LR, PS_STEPS,
                        os.path.join(d, "wal_main"), trace_ds=trace_ds,
                        snapshot_at=PS_SNAP_AT)
        losses = main["losses"]
        check(len(losses) == PS_STEPS and all(map(math.isfinite, losses)),
              f"ps: {len(losses)} steps, losses {losses}")
        first, last = (statistics.mean(losses[:5]),
                       statistics.mean(losses[-5:]))
        check(last < first, f"ps: the loss did not fall ({first} -> {last})")
        # every part of the split over the steady steps; samples/s over
        # the wall of train_from_dataset's steady steps (batch assembly
        # included), the snapshot's own time taken out
        steady = main["recs"][PS_WARM:PS_STEPS]
        step_ms = statistics.mean(r["step_ms"] for r in steady)
        flush_ms = statistics.mean(r["flush_ms"] for r in steady)
        legs = {k: statistics.mean(r[k] for r in steady)
                for k in ("pull", "h2d", "d2h", "push")}
        device_ms = step_ms - flush_ms - sum(legs.values())
        loop_ms = (steady[-1]["out"] - steady[0]["in"]) * 1e3 \
            - main["snapshot_ms"]
        loop_step_ms = loop_ms / len(steady)
        rate = len(steady) * PS_B / loop_ms * 1e3
        # (b) recovery: restart the python server over its WAL directory
        t0 = time.perf_counter()
        again = ps.PsServer("127.0.0.1", 0,
                            wal_dir=os.path.join(d, "wal_main"))
        recover_ms = (time.perf_counter() - t0) * 1e3
        try:
            same_lsn = again.applied_lsn == main["applied_lsn"]
            got = again.table("emb").snapshot_arrays()
            bit = sorted(got) == sorted(main["table"]) and all(
                np.array_equal(got[k], main["table"][k]) for k in got)
        finally:
            again.stop()
        check(same_lsn and bit, f"ps: recovery lsn {same_lsn} bit-equal "
              f"{bit}")
        # (c) the card against the port's CPU run (Adam table)
        cpu_run = ps_train(pt, torch, np, ds, cpu, "adam", PS_LR,
                           PS_PARITY_STEPS, os.path.join(d, "wal_cpu"))
        card_vs_cpu = ps_dev(np, np.array(losses[:PS_PARITY_STEPS]),
                             np.array(cpu_run["losses"]))
        check(card_vs_cpu <= 1e-4, f"ps: card vs CPU losses {card_vs_cpu}")
        # (d) the PS against one process: SGD table and tower
        sgd = ps_train(pt, torch, np, ds, dev, "sgd", PS_SGD_LR,
                       PS_PARITY_STEPS, os.path.join(d, "wal_sgd"))
        py, nat, client = ps_servers(pt, os.path.join(d, "wal_init"), "sgd",
                                     PS_SGD_LR)
        try:
            init_rows = client.pull_sparse("emb", sgd["ids"])
        finally:
            client.close()
            py.stop()
            nat.stop()
        l_loss, l_tower, l_emb = ps_local(pt, torch, np, ds, dev, init_rows,
                                          sgd["ids"], PS_SGD_LR,
                                          PS_PARITY_STEPS)
        one_loss = ps_dev(np, np.array(sgd["losses"]), np.array(l_loss))
        one_tower = max(ps_dev(np, sgd["tower"][k], l_tower[k])
                        for k in l_tower)
        one_rows = ps_dev(np, sgd["rows"], l_emb[sgd["ids"]])
        check(one_loss <= 1e-5 and one_tower <= 1e-5,
              f"ps: PS vs one process losses {one_loss}, tower {one_tower}")
        # (e) a local sparse Embedding under sparse Adam, card vs CPU
        adam_dev = {}
        for lazy in (False, True):
            runs = [ps_local(pt, torch, np, ds, where, init_rows,
                             sgd["ids"], PS_LR, PS_LOCAL_STEPS, "adam", lazy)
                    for where in (dev, cpu)]
            adam_dev[lazy] = max(
                ps_dev(np, np.array(runs[0][0]), np.array(runs[1][0])),
                max(ps_dev(np, runs[0][1][k], runs[1][1][k])
                    for k in runs[1][1]),
                ps_dev(np, runs[0][2], runs[1][2]))
            check(adam_dev[lazy] <= 1e-5, f"ps: local sparse Adam lazy="
                  f"{lazy} card vs CPU {adam_dev[lazy]}")
        pt.set_device("gpu")
        # (f) push throughput to each server, and the durability arm
        py = ps.PsServer()
        py.run()
        nat = ps.NativePsServer()
        try:
            rows = PS_B * PS_SLOTS // 2
            rate_py = ps_push_rate(pt, np, py, rows)
            rate_nat = ps_push_rate(pt, np, nat, rows)
        finally:
            py.stop()
            nat.stop()
        dur = bench.ps_durability()
    ps_s = time.perf_counter() - t_phase
    print(f"ps: CTR-DNN (26 slots x 1,000,001 x 9, 13 dense, fc "
          f"{list(PS_FC)}, batch {PS_B}) from {n} Zipf({PS_ZIPF}) samples "
          f"in 4 slot files ({data_s:.2f} s to write and load) through "
          f"InMemoryDataset -> train_from_dataset -> DistributedEmbedding "
          f"over a python PsServer (WAL) + a NativePsServer, Adam table, "
          f"rows and tower on {dev}: {PS_STEPS} steps, loss {losses[0]:.5f}"
          f" -> {losses[-1]:.5f} (mean of 5 {first:.5f} -> {last:.5f}); "
          f"{rate:.1f} samples/s ({len(steady)} steady steps of "
          f"train_from_dataset in {loop_ms:.3f} ms, the snapshot's "
          f"{main['snapshot_ms']:.3f} ms taken out); ms per steady step "
          f"{loop_step_ms:.3f}: batch assembly between steps "
          f"{loop_step_ms - step_ms:.3f}, pull {legs['pull']:.3f}, H2D "
          f"{legs['h2d']:.3f}, "
          f"device forward + backward + tower update {device_ms:.3f}, D2H "
          f"{legs['d2h']:.3f}, push (enqueue) {legs['push']:.3f}, flush "
          f"{flush_ms:.3f}; the same program traced over "
          f"{main.get('traced_steps')} more batches: wall "
          f"{fmt_ms(main['traced_ms'])} ms, device busy "
          f"{fmt_ms(main['busy_ms'])} ms, idle share "
          f"{fmt_ms(main['idle_share'])} [{card}]", flush=True)
    print(f"ps: checks: card vs CPU losses over {PS_PARITY_STEPS} steps "
          f"{card_vs_cpu:.3g} (tol 1e-4 (1+|ref|)); SGD table vs one process "
          f"(local Embedding(sparse=True) + sparse SGD on the card) losses "
          f"{one_loss:.3g}, tower {one_tower:.3g} (tol 1e-5), rows "
          f"{one_rows:.3g}; local sparse Adam card vs CPU over "
          f"{PS_LOCAL_STEPS} steps non-lazy {adam_dev[False]:.3g}, lazy "
          f"{adam_dev[True]:.3g} (tol 1e-5); recovery (snapshot at step "
          f"{PS_SNAP_AT} {main['snapshot_ms']:.2f} ms + WAL suffix) "
          f"{recover_ms:.2f} ms, bit-equal, applied_lsn "
          f"{main['applied_lsn']} [{card}]", flush=True)
    print(f"ps: push throughput ({rows} rows x {PS_DIM} a push, Adam) python "
          f"server {rate_py:.0f} rows/s, native server {rate_nat:.0f} rows/s;"
          f" ps_durability per push (64 x 16, SGD) WAL off "
          f"{dur['per_push_us_off']:.1f} us, on {dur['per_push_us_on']:.1f} "
          f"us ({dur['overhead_pct']:.1f}%), snapshot "
          f"{dur['snapshot_ms']:.2f} ms, recover {dur['recover_ms']:.2f} ms;"
          f" phase {ps_s:.1f} s [{card}]", flush=True)


# the fleet phase: GPT-2 small replicas behind a FleetRouter (bf16, one
# 1 x 1024 bucket each, replying with the next token's logits), the
# distinct prompts, the requests of each throughput arm (two rounds of
# half of them, pooled), the client threads; the SIGKILL burst's requests
# and the settled count at which the kill lands; the CTR tenant's served
# batches while the trainer pushes (one push a step at the ps phase's step
# time, 153 ms in PR 20's chip run), the visibility rounds, the exporter
# tax's requests per arm (in alternating blocks); the autoscaler's spike
# clients and its queue capacity; the staleness bound; the rollback
# guard's interval; the replies' tolerance against a Predictor built apart
# (bf16 logits, as the static phase's GPT-2)
FLEET_SEQ, FLEET_PROMPTS, FLEET_REQS, FLEET_THREADS = 1024, 8, 64, 4
FLEET_BURST, FLEET_KILL_AT = 64, 8
CTR_SERVES, CTR_VIS, CTR_TAX, CTR_TAX_BLOCK = 300, 100, 300, 50
CTR_PUSH_S = 0.15
FLEET_SPIKE, FLEET_QCAP = 8, 1
CTR_STALE_S, CTR_GUARD_S = 5.0, 0.2
CTR_TAX_INTERVAL_S = 0.25       # FLAGS_telemetry_interval_s's default
FLEET_REPLY_TOL = 2e-2
FLEET_TIMEOUT = 120


def fleet_flags(pt, cache_dir):
    """The fleet's fast membership and telemetry clocks (the reference's
    chaos tests' settings), the planes the fleet reads, and the compile
    cache that warm-starts every replica after the first."""
    pt.set_flags({"FLAGS_monitor": True, "FLAGS_telemetry": True,
                  "FLAGS_telemetry_interval_s": 0.05,
                  "FLAGS_fleet_heartbeat_s": 0.1,
                  "FLAGS_fleet_lease_ttl_s": 0.6,
                  "FLAGS_fleet_health_interval_s": 0.1,
                  "FLAGS_fleet_hbm_budget_mb": 4096.0,
                  "FLAGS_compile_cache_dir": cache_dir})


def fleet_gpt(pt, torch, device):
    """GPT-2 small at full width in bf16, from the seed, on `device`,
    answering a prompt with its next token's logits (1 x 50304), as a
    generation front end asks: every position's logits would make each
    reply 206 MB of host copies and wire."""

    class NextToken(pt.nn.Layer):
        def __init__(self, lm):
            super().__init__()
            self.lm = lm

        def forward(self, input_ids):
            return self.lm(input_ids)[:, -1]

    pt.set_device(device)
    pt.seed(SEED)
    lm = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    lm.eval()
    return NextToken(lm.bfloat16())


def cache_delta(fn):
    """(fn(), the compile cache's hits, misses and process exports
    during the call)."""
    from paddle_tpu_torch.core import compile_cache as cc
    before = (cc.hits, cc.misses, cc.exports)
    out = fn()
    return out, {k: v - b for k, v, b in zip(
        ("hits", "misses", "exports"), (cc.hits, cc.misses, cc.exports),
        before)}


def fleet_predictor(pt, lm):
    """The live layer's Predictor (to_static; its one 1 x 1024 bucket
    exported, or loaded from the compile cache, and captured at start),
    on the device `lm` was built on."""
    return pt.inference.Predictor(
        lm, input_spec=[pt.InputSpec([4, FLEET_SEQ], "int32")])


def fleet_agent(pt, lm, store):
    """One GPT-2 replica: `fleet_predictor` behind a ReplicaAgent, which
    serves (and probes) where the Predictor lives."""
    from paddle_tpu_torch.serving import EngineConfig, ReplicaAgent
    agent = ReplicaAgent(fleet_predictor(pt, lm), store, fleet="smoke",
                         engine_config=EngineConfig(
                             max_batch_size=1, batch_sizes=(1,),
                             batch_timeout_ms=1.0))
    try:
        return agent.start()
    except BaseException:
        agent.stop(drain=False)
        raise


def fleet_replica(workdir):
    """A GPT-2 replica in its own process (`chip_smoke.py --fleet-replica
    DIR`), on the device its caller names in DIR/spec.json, joined to the
    caller's store; it writes DIR/ready.json and serves until it is
    killed or DIR/stop appears."""
    import datetime
    spec = json.load(open(os.path.join(workdir, "spec.json")))
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as tdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    fleet_flags(pt, spec["cache_dir"])
    store = tdist.TCPStore("127.0.0.1", spec["port"], is_master=False,
                           timeout=datetime.timedelta(seconds=60))
    agent = fleet_agent(pt, fleet_gpt(pt, torch, spec["device"]), store)
    stats = agent.server.stats()
    with open(os.path.join(workdir, "ready.json.tmp"), "w") as f:
        json.dump({"replica_id": agent.replica_id, "pid": os.getpid(),
                   "warm_start_ms": stats.get("warm_start_ms"),
                   "compile_cache": stats.get("compile_cache")}, f,
                  default=str)
    os.replace(os.path.join(workdir, "ready.json.tmp"),
               os.path.join(workdir, "ready.json"))
    while not os.path.exists(os.path.join(workdir, "stop")):
        time.sleep(0.1)
    agent.stop(drain=False)
    return 0


def ctr_tenant(pt, torch, np, dirname, tower, fan, device):
    """The CTR-DNN tenant: each generation's table (`load_serving_tables`)
    joins `fan`, the tables the DeltaSubscriber fills; a request's 512 x
    26 ids are looked up on the host and their rows moved to the card in
    one copy, then the tower and the click probability."""
    from paddle_tpu_torch.serving import (EngineConfig, ModelTenant,
                                          load_serving_tables)

    def factory(arrays, meta):
        table = load_serving_tables(arrays, meta)["emb"]
        fan.append(table)

        def handler(ids, dense):
            rows = torch.from_numpy(table.lookup(ids)).to(device)
            feat = torch.cat([rows.reshape(ids.shape[0], -1),
                              torch.from_numpy(dense).to(device)], 1)
            with torch.no_grad():
                p = torch.softmax(tower(feat), -1)[:, 1]
            return p.cpu().numpy()
        return handler

    return ModelTenant("ctr", dirname, factory, engine_config=EngineConfig(
        max_batch_size=PS_B, batch_sizes=(PS_B,), batch_timeout_ms=1.0,
        warmup_on_start=False))


class _Fan:
    """The DeltaSubscriber's table: every install goes to each serving
    generation's table (one per hosting replica and reload)."""

    def __init__(self, first):
        self.tables = [first]

    def append(self, t):
        self.tables.append(t)

    def install_delta(self, batch):
        for t in list(self.tables):
            t.install_delta(batch)

    def mark_fresh(self):
        for t in list(self.tables):
            t.mark_fresh()


def ctr_batch(np, rng):
    ids = (rng.zipf(PS_ZIPF, (PS_B, PS_SLOTS)) - 1
           + np.arange(PS_SLOTS) * (PS_VOCAB // PS_SLOTS)) % PS_VOCAB
    return ids.astype(np.int64), \
        rng.standard_normal((PS_B, PS_DENSE)).astype(np.float32)


def _p(xs, q):
    import numpy as _np
    return float(_np.quantile(_np.asarray(xs), q)) if xs else float("nan")


def fleet_phase(pt, fa, torch, np, card, cache_dir=None):
    """The serving fleet and the telemetry plane on the card: two
    in-process GPT-2-small replicas and one in a child process behind a
    FleetRouter over a TCPStore, each a ReplicaAgent -> PredictorServer ->
    ServingEngine over the live layer's Predictor (row 1 in each forward),
    warm-started after the first from the compile cache; a
    TelemetryCollector fed by every replica's exporter, subscribed by the
    router; each replica's reply (the child's too) against a Predictor
    built apart; requests/s through the router against one replica; the
    CTR-DNN (the ps phase's width) as a
    ModelTenant on both in-process replicas, its embedding read from an
    OnlineServingTable that a DeltaSubscriber fills from a PsServer while a
    trainer pushes: staleness under its bound, push -> servable p50 /
    p99, a poisoned generation rolled back by OnlineRollbackGuard; the
    exporter's tax on the tenant's p99; `monitor top` and `monitor fleet`;
    the child SIGKILLed mid-burst with the sequence ledger's audit; the
    Autoscaler growing the pool 2 -> 3 under a queue spike (the new replica
    from the cache) and draining it back. Returns the flash forward's host
    launches. `cache_dir` is the compile cache the replicas share (the
    warm_start phase's directory), else a new one: the first replica
    exports the next-token program into it, every later one loads it."""
    import contextlib as _ctx
    import datetime
    import io
    import signal
    import subprocess
    import tempfile
    import torch.distributed as tdist
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed.ps import (DeltaSubscriber, PsClient,
                                                 PsServer)
    from paddle_tpu_torch.guard import guard_state_version
    from paddle_tpu_torch.inference.server import PredictorClient
    from paddle_tpu_torch.obs import telemetry
    from paddle_tpu_torch.serving import (Autoscaler, FleetRouter,
                                          OnlineRollbackGuard,
                                          OnlineServingTable, ReplicaPool,
                                          ScalePolicy,
                                          save_serving_generation)
    t_phase = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="fleet_")
    cache_dir = cache_dir or os.path.join(work.name, "cache")
    from paddle_tpu_torch.core import flags as _fl
    saved = {k: _fl.flag(k) for k in (
        "monitor", "telemetry", "telemetry_interval_s", "fleet_heartbeat_s",
        "fleet_lease_ttl_s", "fleet_health_interval_s",
        "fleet_hbm_budget_mb", "compile_cache_dir")}
    fleet_flags(pt, cache_dir)
    monitor.reset()
    device, dev = "gpu:0", torch.device("cuda", 0)
    store = tdist.TCPStore("127.0.0.1", 0, is_master=True,
                           wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=60))
    agents, child, router, col, auto = [], None, None, None, None
    sub = server = client = guard = None
    stop_clients = threading.Event()
    try:
        col = telemetry.TelemetryCollector(store, fleet="smoke").start()
        lm = fleet_gpt(pt, torch, device)
        vocab = lm.lm.gpt.embeddings.word_embeddings.weight.shape[0]
        n_layers = len(lm.lm.gpt.layers)
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = 0     # the main path from here

        # ---- replica 0 (from the given cache, or exporting into a new
        # one), the child, replica 1 (from the cache) ----
        t0 = time.perf_counter()
        agent, cold_cc = cache_delta(
            lambda: fleet_agent(pt, copy.deepcopy(lm), store))
        agents.append(agent)
        cold_s = time.perf_counter() - t0
        cold_launches = fa.flash_attention_fwd.launches
        with open(os.path.join(work.name, "spec.json"), "w") as f:
            json.dump({"port": store.port, "cache_dir": cache_dir,
                       "device": str(dev)}, f)
        t_child = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fleet-replica",
             work.name], cwd=HERE,
            stdout=open(os.path.join(work.name, "child.log"), "w"),
            stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        agent, warm_cc = cache_delta(
            lambda: fleet_agent(pt, copy.deepcopy(lm), store))
        agents.append(agent)
        warm_s = time.perf_counter() - t0
        check(cold_launches >= 2 * n_layers and
              fa.flash_attention_fwd.launches >= 4 * n_layers,
              f"fleet: {cold_launches} / {fa.flash_attention_fwd.launches} "
              f"flash host launches at the replicas' warm-ups (want at "
              f"least {2 * n_layers} each: the eager run and the capture)")
        print(f"fleet: flash_fwd host launches at the warm-ups: cold "
              f"{cold_launches}, cold + warm "
              f"{fa.flash_attention_fwd.launches} [{card}]", flush=True)
        check(warm_cc["hits"] >= 1 and warm_cc["exports"] == 0,
              f"fleet: replica 1 did not load from the cache {warm_cc}")
        router = FleetRouter(store, fleet="smoke").start()
        router.attach_telemetry(col)
        check(sorted(router.replicas) == [0, 1],
              f"fleet: router sees {sorted(router.replicas)}")

        # ---- each replica's reply against a Predictor built apart from
        # the replicas (its warm-up's launches are not the main path's) ----
        rng = np.random.default_rng(SEED)
        reqs = [rng.integers(0, vocab, (1, FLEET_SEQ)).astype(np.int32)
                for _ in range(FLEET_PROMPTS)]
        n_before = fa.flash_attention_fwd.launches
        want = fleet_predictor(pt, copy.deepcopy(lm)).run_batch(
            [reqs[0]])[0]
        ref_launches = fa.flash_attention_fwd.launches - n_before
        reply_errs = {}

        def reply_err(who, st, out):
            check(st == 0 and out[0].shape == (1, vocab) and
                  np.isfinite(out[0]).all(),
                  f"fleet: {who}'s reply: status {st}")
            reply_errs[who] = float(np.abs(out[0] - want).max())
            check(reply_errs[who] <= FLEET_REPLY_TOL,
                  f"fleet: {who}'s reply differs from the Predictor built "
                  f"apart by {reply_errs[who]} (tol {FLEET_REPLY_TOL})")

        def ask(who, host, port):
            c = PredictorClient(host, port, timeout=FLEET_TIMEOUT)
            try:
                reply_err(who, *c.run([reqs[0]]))
            finally:
                c.close()
        for a in agents:
            ask(f"replica {a.replica_id}", a.host, a.port)
        reply_err("the router", *router.run([reqs[0]], deadline_ms=60000))

        def burst(fn, n, threads=FLEET_THREADS):
            errors, lat = [], []

            def one(k):
                try:
                    for j in range(k, n, threads):
                        t = time.perf_counter()
                        st, _ = fn(reqs[j % len(reqs)])
                        if st != 0:
                            errors.append(st)
                        lat.append(time.perf_counter() - t)
                except Exception as e:  # noqa: BLE001 — read after join
                    errors.append(f"{type(e).__name__}: {e}")
            ts = [threading.Thread(target=one, args=(k,), daemon=True)
                  for k in range(threads)]
            t = time.perf_counter()
            [x.start() for x in ts]
            [x.join(FLEET_TIMEOUT) for x in ts]
            wall = time.perf_counter() - t
            check(not errors and not any(x.is_alive() for x in ts),
                  f"fleet: burst errors {errors[:3]}")
            return wall, lat

        one_clients = [PredictorClient(agents[0].host, agents[0].port,
                                       timeout=FLEET_TIMEOUT)
                       for _ in range(FLEET_THREADS)]
        lock = threading.Lock()

        def via_one(ids):
            with lock:
                c = one_clients.pop()
            try:
                return c.run([ids])
            finally:
                with lock:
                    one_clients.append(c)

        # two rounds of each arm (one, router, router, one), pooled
        arms = {"one": via_one,
                "router": lambda ids: router.run([ids], deadline_ms=60000)}
        walls, lats = {"one": 0.0, "router": 0.0}, {"one": [], "router": []}
        for arm in ("one", "router", "router", "one"):
            wall, lat = burst(arms[arm], FLEET_REQS // 2)
            walls[arm] += wall
            lats[arm] += lat
        for c in one_clients:
            c.close()
        rps = {arm: FLEET_REQS / walls[arm] for arm in walls}
        print(f"fleet: GPT-2 small bf16 1 x {FLEET_SEQ} -> the next token's "
              f"logits (1 x {vocab} f32): through the router over 2 "
              f"replicas {rps['router']:.2f} requests/s (p50 "
              f"{_p(lats['router'], 0.5) * 1e3:.2f} ms, p90 "
              f"{_p(lats['router'], 0.9) * 1e3:.2f} ms) against one replica "
              f"direct {rps['one']:.2f} (p50 {_p(lats['one'], 0.5) * 1e3:.2f}"
              f" ms, p90 {_p(lats['one'], 0.9) * 1e3:.2f} ms); "
              f"{FLEET_REQS} requests per arm from {FLEET_THREADS} clients "
              f"in two rounds (one, router, router, one); replies against a "
              f"Predictor built apart, max abs err {reply_errs} (tol "
              f"{FLEET_REPLY_TOL}); warm-ups (load or export + eager run + "
              f"capture) replica 0 {cold_s:.2f} s (cache {cold_cc}), "
              f"replica 1 {warm_s:.2f} s (hits {warm_cc.get('hits')}) "
              f"[{card}]", flush=True)

        # ---- the CTR tenant on the online table ----
        server = PsServer("127.0.0.1", 0)
        server.run()
        client = PsClient([f"127.0.0.1:{server.port}"])
        client.create_sparse_table("emb", PS_DIM, optimizer="sgd", lr=0.1,
                                   seed=SEED + 20)
        crng = np.random.default_rng(SEED + 1)
        batches = [ctr_batch(np, crng) for _ in range(4)]
        for ids, _ in batches:          # the trainer's first pulls
            client.pull_sparse("emb", ids.reshape(-1))
        live = OnlineServingTable("emb", PS_DIM,
                                  max_staleness_s=CTR_STALE_S)
        fan = _Fan(live)
        sub = DeltaSubscriber({"emb": fan},
                              endpoint=f"127.0.0.1:{server.port}",
                              subscriber_id="smoke", interval_ms=20.0,
                              pull_timeout_s=10.0).start()
        deadline = time.monotonic() + 30
        while len(live) < 1000 and time.monotonic() < deadline:
            time.sleep(0.02)
        gen_dir = os.path.join(work.name, "ctr")
        save_serving_generation(gen_dir, {"emb": live})
        tower = ps_tower(pt, torch, dev)
        for a in agents:
            a.host_model(ctr_tenant(pt, torch, np, gen_dir, tower, fan, dev))
        router.refresh()
        grads = np.full((PS_B * PS_SLOTS, PS_DIM), 0.01, np.float32)
        stale, preds, errs, pushes = [], [], [], [0]
        served = threading.Event()

        def trainer():
            # a push a step until the last served request has come back
            try:
                while not served.is_set():
                    client.push_sparse(
                        "emb", batches[pushes[0] % 4][0].reshape(-1), grads)
                    pushes[0] += 1
                    served.wait(CTR_PUSH_S)
            except Exception as e:  # noqa: BLE001
                errs.append(f"{type(e).__name__}: {e}")
        tt = threading.Thread(target=trainer, daemon=True)
        tt.start()
        ctr_lat = []
        for i in range(CTR_SERVES):
            ids, dense = batches[i % 4]
            t = time.perf_counter()
            st, out = router.run([ids, dense], deadline_ms=30000,
                                 model="ctr")
            ctr_lat.append(time.perf_counter() - t)
            check(st == 0, f"fleet: ctr request {i} status {st}: {out}")
            preds.append(out[0])
            stale.append(max(t.staleness_s() for t in fan.tables))
        served.set()
        tt.join(FLEET_TIMEOUT)
        check(not errs and not tt.is_alive(), f"fleet: trainer {errs}")
        p = np.concatenate(preds)
        check(p.shape == (CTR_SERVES * PS_B,) and np.isfinite(p).all() and
              ((p >= 0) & (p <= 1)).all(), "fleet: ctr predictions")
        check(max(stale) < CTR_STALE_S,
              f"fleet: the online table was {max(stale):.3f} s stale")
        vis = []
        probe_ids = batches[0][0][:1, :1].reshape(-1)
        one_grad = np.full((1, PS_DIM), 0.01, np.float32)
        for _ in range(CTR_VIS):
            cur = fan.tables[-1]
            before = cur.lookup(probe_ids)[0, 0]
            t = time.perf_counter()
            client.push_sparse("emb", probe_ids, one_grad)
            while cur.lookup(probe_ids)[0, 0] == before and \
                    time.perf_counter() - t < 10:
                time.sleep(0.0005)
            vis.append(time.perf_counter() - t)
        check(max(vis) < 10, "fleet: a push never became servable")

        # ---- the exporter's tax on the tenant's p99: the arms in
        # alternating blocks, each arm's latencies pooled ----
        def ctr_lats(n):
            lat = []
            for i in range(n):
                ids, dense = batches[i % 4]
                t = time.perf_counter()
                st, _ = router.run([ids, dense], deadline_ms=30000,
                                   model="ctr")
                lat.append(time.perf_counter() - t)
                check(st == 0, "fleet: ctr request in the tax arms")
            return lat

        def exporters(on, interval_s=None):
            # off: every replica's exporter stopped (its 'bye' tells the
            # collector); on: a fresh one each, as ReplicaAgent.start makes
            for a in agents:
                if a._exporter is not None:
                    a._exporter.stop()
                a._exporter = telemetry.TelemetryExporter(
                    store, source=f"replica-{a.replica_id}", role="replica",
                    fleet="smoke", meta={"replica_id": a.replica_id},
                    interval_s=interval_s).start() if on else None

        tax = {"off": [], "on": []}
        for b in range(2 * CTR_TAX // CTR_TAX_BLOCK):   # the default interval
            arm = ("off", "on")[b % 2]
            exporters(arm == "on", CTR_TAX_INTERVAL_S)
            tax[arm] += ctr_lats(CTR_TAX_BLOCK)
        exporters(True)
        p99_off, p99_on = _p(tax["off"], 0.99), _p(tax["on"], 0.99)

        # ---- a poisoned generation, rolled back within one interval ----
        bad = OnlineServingTable("emb", PS_DIM)
        arrays = fan.tables[-1].export_arrays()
        keys, rows = arrays["emb::keys"], arrays["emb::rows"].copy()
        rows[:] = np.nan
        bad.load_arrays(keys, rows, fan.tables[-1].applied_version)
        v_good = guard_state_version(gen_dir)
        res = router.rollout("ctr", gen_dir, *_gen_arrays(bad),
                             probes=[list(batches[0])] * 2)
        check(res.promoted, f"fleet: the poisoned rollout {res}")
        t_poison = time.perf_counter()
        probe = batches[1]

        def probe_fn():
            st, out = router.run(list(probe), deadline_ms=30000,
                                 model="ctr")
            if st != 0:
                raise RuntimeError(f"status {st}")
            return out[0]
        guard = OnlineRollbackGuard(probe_fn,
                                    lambda: router.rollback_model("ctr"),
                                    interval_s=CTR_GUARD_S).start()
        deadline = time.monotonic() + 30
        while guard.rollbacks < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        rollback_s = time.perf_counter() - t_poison
        guard.stop()
        check(guard.rollbacks == 1 and
              rollback_s < CTR_GUARD_S + 5.0,
              f"fleet: rollback after {rollback_s:.3f} s ({guard.rollbacks})")
        after = probe_fn()
        check(np.isfinite(after).all() and
              guard_state_version(gen_dir) == v_good and
              all(a.tenants["ctr"].version == v_good for a in agents),
              "fleet: the rolled-back generation does not serve")
        entry = [e for e in guard.ledger if e["action"] == "rollback"][0]
        print(f"fleet: CTR-DNN tenant ({PS_SLOTS} slots over a "
              f"{PS_VOCAB:,} x {PS_DIM} table, batch {PS_B}) on the online "
              f"table while a trainer pushed ({pushes[0]} pushes of "
              f"{PS_B * PS_SLOTS} rows, one every {CTR_PUSH_S} s): staleness "
              f"max {max(stale):.4f} s "
              f"(bound {CTR_STALE_S}), push -> servable p50 "
              f"{_p(vis, 0.5) * 1e3:.2f} ms, p99 {_p(vis, 0.99) * 1e3:.2f} ms "
              f"({CTR_VIS} rounds), served p50 "
              f"{_p(ctr_lat, 0.5) * 1e3:.2f} ms, p99 "
              f"{_p(ctr_lat, 0.99) * 1e3:.2f} ms ({CTR_SERVES} requests); "
              f"the poisoned generation "
              f"v{res.version} rolled back to v{v_good} in "
              f"{rollback_s * 1e3:.1f} ms (guard interval "
              f"{CTR_GUARD_S * 1e3:.0f} ms, {entry['reason']}); exporter "
              f"tax on the tenant's p99: off {p99_off * 1e3:.3f} ms (p50 "
              f"{_p(tax['off'], 0.5) * 1e3:.3f}), on {p99_on * 1e3:.3f} ms "
              f"(p50 {_p(tax['on'], 0.5) * 1e3:.3f}) "
              f"({(p99_on / p99_off - 1) * 100:+.1f}%, {CTR_TAX} requests per "
              f"arm in alternating blocks of {CTR_TAX_BLOCK}, exporters "
              f"pushing every {CTR_TAX_INTERVAL_S} s) [{card}]", flush=True)

        # ---- monitor top and monitor fleet ----
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(
                [r for r in col.fleet_table() if r["alive"]]) < 2:
            time.sleep(0.05)
        top = io.StringIO()
        with _ctx.redirect_stdout(top):
            rc = monitor._main(["top", f"{col.host}:{col.port}"])
        dump = router.dump(os.path.join(work.name, "fleet_dump.json"))
        fl = io.StringIO()
        with _ctx.redirect_stdout(fl):
            rc2 = monitor._main(["fleet", dump])
        check(rc == 0 and "replica-0" in top.getvalue() and
              "replica-1" in top.getvalue() and rc2 == 0 and
              f"{len(router.replicas)} replica(s)" in fl.getvalue(),
              f"fleet: monitor top / fleet\n{top.getvalue()}\n"
              f"{fl.getvalue()}")
        print(top.getvalue() + fl.getvalue(), flush=True)

        # ---- the child replica SIGKILLed mid-burst ----
        deadline = time.monotonic() + FLEET_TIMEOUT
        ready = os.path.join(work.name, "ready.json")
        while not os.path.exists(ready) and child.poll() is None and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        check(os.path.exists(ready), "fleet: the child replica never came "
              "up:\n" + open(os.path.join(work.name, "child.log")).read()
              [-3000:])
        info = json.load(open(ready))
        child_s = time.perf_counter() - t_child
        cid = int(info["replica_id"])
        router.refresh()
        check(cid in [h.replica_id for h in router.healthy_replicas()],
              "fleet: the child replica is not routed to")
        h = router.replicas[cid]
        ask(f"the child replica {cid}", h.host, h.port)
        audit0 = router.ledger.audit()
        killed, deaths = {}, []
        col.subscribe(lambda ev: deaths.append(time.monotonic())
                      if ev.get("kind") == "death" and
                      (ev.get("detail") or {}).get("replica_id") == cid
                      else None)

        def killer():
            while router.ledger.audit()["settled"] < \
                    audit0["settled"] + FLEET_KILL_AT:
                time.sleep(0.002)
            killed["t"] = time.monotonic()
            os.kill(child.pid, signal.SIGKILL)
        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        kill_wall, _ = burst(
            lambda ids: router.run([ids], deadline_ms=60000), FLEET_BURST)
        kt.join(10)
        child.wait(30)
        audit = router.ledger.audit()
        check("t" in killed and child.returncode == -signal.SIGKILL and
              deaths and cid not in [h.replica_id
                                     for h in router.healthy_replicas()],
              f"fleet: the SIGKILLed replica {cid} is still routed to "
              f"(deaths {deaths})")
        failover_ms = (deaths[0] - killed["t"]) * 1e3
        check(audit["lost"] == 0 and audit["duplicates"] == 0 and
              audit["open"] == 0 and audit["issued"] ==
              audit["settled"] + audit["rejected"] and
              audit["settled"] - audit0["settled"] == FLEET_BURST,
              f"fleet: the ledger after the SIGKILL {audit}")
        print(f"fleet: child replica {cid} (its own process on the caller's "
              f"{dev}, up in {child_s:.1f} s, warm_start_ms "
              f"{info['warm_start_ms']}, cache {info['compile_cache']}) "
              f"(reply max abs err {reply_errs[f'the child replica {cid}']}) "
              f"SIGKILLed mid-burst of {FLEET_BURST} (after "
              f"{FLEET_KILL_AT} settled): marked dead "
              f"{failover_ms:.1f} ms after the kill (the collector's EOF "
              f"death event); ledger {audit}; every sequence settled once; "
              f"{FLEET_BURST / kill_wall:.2f} requests/s through the burst "
              f"[{card}]",
              flush=True)

        # ---- the autoscaler: 2 -> 3 under a queue spike, back to 2 ----
        spawned_cc = []

        def spawn():
            a, delta = cache_delta(
                lambda: fleet_agent(pt, copy.deepcopy(lm), store))
            spawned_cc.append(delta)
            return a
        pool = ReplicaPool(router, spawn, spawn_timeout_s=FLEET_TIMEOUT)
        policy = ScalePolicy(burn_high=1e9, burn_low=0.0, queue_high=0.5,
                             queue_low=0.2, min_replicas=2, max_replicas=3,
                             cooldown_s=0.5, idle_after_s=1.0,
                             zero_after_s=3600.0, step=1)
        auto = Autoscaler(col, pool, policy=policy, interval_s=0.05,
                          queue_capacity=FLEET_QCAP).start()
        check(pool.actual() == 2, f"fleet: {pool.actual()} replicas before "
              "the spike")

        def spiker():
            while not stop_clients.is_set():
                try:
                    router.run([reqs[0]], deadline_ms=60000)
                except Exception:  # noqa: BLE001 — the spike's own load
                    pass
        spikers = [threading.Thread(target=spiker, daemon=True)
                   for _ in range(FLEET_SPIKE)]
        t_spike = time.monotonic()
        [s.start() for s in spikers]
        deadline = t_spike + FLEET_TIMEOUT
        # the spike runs on until the new replica answers its probe: the
        # new replica warms up under the load that called for it
        while auto.target < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        t_decided = time.monotonic()
        decided_ms = (t_decided - t_spike) * 1e3
        while pool.actual() < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        first_new_ms = (time.monotonic() - t_spike) * 1e3
        spawn_ms = (time.monotonic() - t_decided) * 1e3
        grew = pool.actual()
        stop_clients.set()
        t_calm = time.monotonic()
        [s.join(FLEET_TIMEOUT) for s in spikers]
        new_cc = spawned_cc[0] if spawned_cc else {}
        deadline = time.monotonic() + 30
        while (pool.actual() > 2 or auto.ledger.snapshot()["counts"].get(
                "in", 0) < 1) and time.monotonic() < deadline:
            time.sleep(0.02)
        drain_ms = (time.monotonic() - t_calm) * 1e3
        snap = auto.snapshot()
        check(grew == 3 and pool.actual() == 2 and
              snap["ledger"]["counts"].get("out", 0) >= 1 and
              snap["ledger"]["counts"].get("in", 0) >= 1,
              f"fleet: the pool went 2 -> {grew} -> {pool.actual()}: "
              f"{snap['ledger']['decisions'][-3:]}")
        check(new_cc.get("hits", 0) >= 1 and new_cc.get("exports") == 0,
              f"fleet: the new replica did not start from the cache {new_cc}")
        launches = fa.flash_attention_fwd.launches - ref_launches
        check(launches >= 6 * n_layers,
              f"fleet: {launches} flash host launches over the phase")
        print(f"fleet: autoscaler 2 -> {grew} -> {pool.actual()} under "
              f"{FLEET_SPIKE} spike clients: the scale-out decided "
              f"{decided_ms:.1f} ms into the spike, "
              f"time_to_first_new_replica_ms {first_new_ms:.1f} (decision -> "
              f"healthy {spawn_ms:.1f} ms with the spike still on; the new "
              f"replica warm from the compile cache: {new_cc}), drained "
              f"back {drain_ms:.1f} ms after the spike ended; decisions "
              f"{snap['ledger']['counts']}; flash_fwd host launches "
              f"{launches} (the in-process replicas' warm-ups; the "
              f"Predictor built apart's {ref_launches} not counted); HBM "
              f"{agents[0].server.stats().get('hbm')}; phase "
              f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
        return launches
    finally:
        stop_clients.set()
        if guard is not None:
            guard.stop()
        if auto is not None:
            auto.close(stop_pool=True)
        if router is not None:
            router.close()
        for a in agents:
            a.stop(drain=False)
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(30)
        if sub is not None:
            sub.stop()
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        if col is not None:
            col.stop()
        pt.set_flags(saved)
        monitor.reset()
        work.cleanup()


def _gen_arrays(table):
    """(arrays, meta) of a one-table serving generation, as
    `save_serving_generation` writes them."""
    arrays = table.export_arrays()
    return arrays, {"online_tables": {table.name: {
        "dim": table.dim, "version": int(table.applied_version)}}}


def ptxas(path):
    """{kernel symbol: {"registers": N, "spill": [stores, loads]}} from a
    built library's `-Xptxas -v` log."""
    out, name = {}, "?"
    with open(path + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                out.setdefault(name, {})["spill"] = [int(m.group(1)),
                                                     int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def spills(path):
    """The kernels of a built library whose `-Xptxas -v` report spills."""
    return [f"{k}: spill stores/loads {v['spill']}"
            for k, v in ptxas(path).items() if any(v.get("spill", ()))]


def kernel_rows(root=HERE, dtype_name="bfloat16"):
    """`python3 chip_smoke.py --rows [ROOT] [DTYPE]`: one JSON line of the
    seven attention kernels' device ms (a CUDA graph of 20 calls, median
    of 10 replays) from ROOT's own package and its own `chip_smoke.py`
    cases, at the train shape (rows 1-4; rows 1-2 also at the titan shape)
    and at the sp hop (rows 5-7), with the registers and spills of every
    kernel symbol from ROOT's build logs. Run on two trees in turn in one
    card session (parent, change, change, parent), it compares their
    kernel rows on the same card. ROOT defaults to this checkout."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: --rows needs an NVIDIA GPU")
    root = os.path.abspath(root)
    sys.path.insert(0, root)        # ROOT's package and ROOT's cases
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as tra
    check(os.path.dirname(os.path.abspath(cs.__file__)) == root and
          os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__)))
          == os.path.join(root, "paddle_tpu_torch"),
          f"--rows: imported {cs.__file__} and {fa.__file__}, not {root}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    libs = {"flash_fwd": fa.build(), "flash_bwd": fa.build_bwd(),
            "ring_attention": tra.build()}
    rows = {}
    for tag, (b, s, h, d, causal) in (("train", (TRAIN_B, TRAIN_S, 12, 64,
                                                 True)),
                                      ("titan", (TITAN_B, TITAN_S, 64, 64,
                                                 False))):
        rows[f"flash_fwd@{tag}"] = cs.fwd_case(
            fa, torch, b, s, h, d, dtype, causal)["device_ms"]
        bwd = cs.bwd_case(fa, torch, b, s, h, d, dtype, causal)
        for kname in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
            rows[f"{kname}@{tag}"] = bwd[kname]["device_ms"]
    steps = cs.ring_step_case(tra, torch, 96, 128, 64, dtype, False, step=1)
    for kname, r in steps.items():
        rows[f"{kname}@sp_hop"] = r["device_ms"]
    hop = [(128 * i, 128 * ((i - 1) % 4)) for i in range(4)]
    rows["ring_dq_step@sp_hop"] = cs.dq_step_case(
        tra, torch, 96, 128, 128, 64, dtype, False, hop)["device_ms"]
    print(json.dumps({"root": root, "card": gpu_name_and_limit(),
                      "dtype": dtype_name, "device_ms": rows,
                      "ptxas": {k: ptxas(p) for k, p in libs.items()}}),
          flush=True)
    return 0


PHASE_WALLS = {}


def time_phases():
    """Wrap every `*_phase` function of this module so that its wall
    seconds land in PHASE_WALLS (printed before the summary)."""
    g = globals()
    for name, fn in list(g.items()):
        if name.endswith("_phase") and callable(fn):
            def timed(*args, _fn=fn, _name=name[:-len("_phase")], **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    PHASE_WALLS[_name] = round(
                        PHASE_WALLS.get(_name, 0.0) +
                        time.perf_counter() - t0, 1)
            g[name] = timed


def main() -> int:
    t_main = time.perf_counter()
    time_phases()
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail(f"no paddle_tpu_torch package beside {__file__}: run from the "
             "root of a checkout")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as tra
    check("jax" not in sys.modules, "jax was imported")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card}", flush=True)

    # ---- build: one nvcc per kernel source, all started together ----
    builds = {"flash_fwd": fa.build, "flash_bwd": fa.build_bwd,
              "ring_attention": tra.build}
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(lambda f: f(), builds.values())))
    build_s = time.time() - t0
    print(f"build: {build_s:.1f} s for {sorted(paths)}; ptxas spills: "
          f"{ {k: spills(p) for k, p in paths.items()} }", flush=True)

    # ---- kernels vs their plain versions ----
    fwd_cases = [(4, 1024, 12, 64, torch.bfloat16, True),   # serving shape
                 (TRAIN_B, TRAIN_S, 12, 64, torch.bfloat16, True),  # train
                 (4, 1024, 6, 128, torch.bfloat16, True),
                 (4, 1024, 3, 256, torch.bfloat16, True),
                 (1, 4096, 12, 64, torch.float32, False),   # fp32 from 4096
                 (4, 1000, 12, 64, torch.bfloat16, True),   # ragged S
                 (2, 2048, 64, 64, torch.bfloat16, False)]  # titan layer
    fwd_rows = []
    for case in fwd_cases:
        r = fwd_case(fa, torch, *case)
        fwd_rows.append(r)
        print(f"kernels: flash_fwd {r['shape']} {r['dtype']} "
              f"causal={r['causal']} max_abs_err out={r['max_abs_err']:.3g} "
              f"(tol {r['tol_out']}) lse={r['max_abs_err_lse']:.3g} "
              f"(tol {r['tol_lse']}) kernel_ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"library_device_ms={fmt_ms(r['library_device_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
              flush=True)
    bwd_cases = [(TRAIN_B, TRAIN_S, 12, 64, torch.bfloat16, True),  # train
                 (TRAIN_B, TRAIN_S, 12, 64, torch.bfloat16, False),
                 (TRAIN_B, TRAIN_S, 6, 128, torch.bfloat16, True),
                 (TRAIN_B, TRAIN_S, 3, 256, torch.bfloat16, True),
                 (1, 4096, 12, 64, torch.float32, False),
                 (TRAIN_B, 1000, 12, 64, torch.bfloat16, True),    # ragged
                 (2, 2048, 64, 64, torch.bfloat16, False)]         # titan
    bwd_rows = []
    for case in bwd_cases:
        rows = bwd_case(fa, torch, *case)
        bwd_rows.append(rows)
        for kname in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
            r = rows[kname]
            print(f"kernels: {kname} {r['shape']} {r['dtype']} "
                  f"causal={r['causal']} max_abs_err={r['max_abs_err']:.3g} "
                  f"(tol {r['tol']}) kernel_ms={r['ms']:.4f} "
                  f"device_ms={r['device_ms']:.4f} (entry alone; wrapper "
                  f"{r['wrapper_device_ms']:.4f}) "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"library_device_ms={fmt_ms(r['library_device_ms'])} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
                  flush=True)
        print(f"kernels: fused vs two-pass dq max abs diff "
              f"{rows['fused_vs_two_pass_dq_err']:.3g} at "
              f"{rows['flash_bwd_fused']['shape']} (dk, dv bit-equal) "
              f"[{card}]", flush=True)
    serving_row, train_fwd_row = fwd_rows[0], fwd_rows[1]
    train_rows = dict(bwd_rows[0], fwd=train_fwd_row)
    # (BH, Sq, Sk, D, dtype, causal, (q_off, k_off))
    bf = torch.bfloat16
    ring_cases = [(96, 128, 128, 64, bf, False, (128, 256)),  # sp train hop
                  (12, 1024, 1024, 64, bf, True, (1024, 1024)),  # diagonal
                  (12, 1024, 1024, 64, bf, True, (2048, 0)),     # past
                  (12, 1024, 1024, 64, bf, True, (0, 1024)),     # future
                  (12, 128, 128, 64, bf, True, (96, 0)),    # off the tiles
                  (12, 128, 256, 64, bf, True, (128, 0)),   # Sq != Sk
                  (6, 1024, 1024, 128, bf, True, (1024, 1024)),
                  (3, 1024, 1024, 256, bf, True, (1024, 1024)),
                  (12, 256, 256, 64, torch.float32, True, (256, 128))]
    ring_rows = []
    for case in ring_cases:
        rows = ring_case(tra, torch, *case)
        ring_rows.append(rows)
        for kname, r in rows.items():
            lib = "n/a" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f} library_device_ms=" \
                f"{fmt_ms(r['library_device_ms'])}"
            grp = "" if r["max_abs_err_group"] is None else \
                f" group-of-2 step max_abs_err={r['max_abs_err_group']:.3g}"
            fut = " (future hop: exact 0 / -1e30, accumulators unchanged)" \
                if r["future"] else ""
            print(f"kernels: {kname} BH,Sq,Sk,D={r['shape']} {r['dtype']} "
                  f"causal={r['causal']} offs={r['offs']}"
                  f"{fut}"
                  f" max_abs_err={r['max_abs_err']:.3g} (tol {r['tol']}){grp} "
                  f"kernel_ms={r['ms']:.4f} device_ms={r['device_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
                  flush=True)
    # the step kernels on the 4 slots of one card at the sp train's hop
    # (non-causal, timed) and with causal offsets (past, diagonal, future
    # slots in one launch)
    step_rows = {}
    for causal in (False, True):
        rows = ring_step_case(tra, torch, 96, 128, 64, bf, causal, step=1)
        step_rows[causal] = rows
        for kname, r in rows.items():
            print(f"kernels: {kname} step n,BH,Sq,Sk,D={r['shape']} "
                  f"{r['dtype']} causal={r['causal']} offs={r['offs']} "
                  f"max_abs_err={r['max_abs_err']:.3g} (tol {r['tol']}) "
                  f"kernel_ms={r['ms']:.4f} per launch, device_ms="
                  f"{r['device_ms']:.4f} per launch, "
                  f"{r['device_ms_per_hop']:.4f} per slot-hop; plain_ms="
                  f"{r['plain_ms']:.4f} library_ms={fmt_ms(r['library_ms'])}"
                  f" library_device_ms={fmt_ms(r['library_device_ms'])} "
                  f"(one hop {fmt_ms(r['library_hop_device_ms'])}) bound_ms="
                  f"{r['bound_ms']:.4f} per launch, "
                  f"{r['bound_ms_per_hop']:.4f} per slot-hop "
                  f"({r['bound_by']}) [{card}]", flush=True)
    # the dq step on the 4 slots of a ring step, adding into non-zero
    # accumulators: (BH, Sq, Sk, D, dtype, causal, [(q_off, k_off)] * 4)
    sp_hop = [(128 * i, 128 * ((i - 1) % SP_DEGREE)) for i in range(SP_DEGREE)]
    diag = [(1024 * i, 1024 * i) for i in range(SP_DEGREE)]
    dq_cases = [(96, 128, 128, 64, bf, False, sp_hop),     # the sp train's
                (96, 128, 128, 64, bf, True, sp_hop),      # past/future/...
                (12, 1024, 1024, 64, bf, True, diag),      # diagonal
                (12, 1024, 1024, 64, bf, True,             # wholly future
                 [(1024 * i, 1024 * (i + 1)) for i in range(SP_DEGREE)]),
                (12, 128, 128, 64, bf, True,               # off the tiles
                 [(96, 0), (160, 32), (32, 0), (0, 200)]),
                (12, 100, 200, 64, bf, True,               # ragged Sq
                 [(150, 0), (50, 0), (250, 100), (0, 100)]),
                (6, 1024, 1024, 128, bf, True, diag),
                (3, 1024, 1024, 256, bf, True, diag),
                (12, 256, 256, 64, torch.float32, True,
                 [(256, 128), (0, 0), (512, 0), (0, 256)])]
    dq_rows = []
    for case in dq_cases:
        r = dq_step_case(tra, torch, *case)
        dq_rows.append(r)
        print(f"kernels: ring_dq_step step n,BH,Sq,Sk,D={r['shape']} "
              f"{r['dtype']} causal={r['causal']} offs={r['offs']} "
              f"max_abs_err={r['max_abs_err']:.3g} (tol {r['tol']}; future "
              f"slots' accumulators bit-unchanged) kernel_ms={r['ms']:.4f} "
              f"per launch, device_ms={r['device_ms']:.4f} per launch, "
              f"{r['device_ms_per_hop']:.4f} "
              f"per slot-hop; plain_ms={r['plain_ms']:.4f} "
              f"library_ms={fmt_ms(r['library_ms'])} library_device_ms="
              f"{fmt_ms(r['library_device_ms'])} (one hop "
              f"{fmt_ms(r['library_hop_device_ms'])}) bound_ms="
              f"{r['bound_ms']:.4f} per launch, "
              f"{r['bound_ms_per_hop']:.4f} per slot-hop ({r['bound_by']}) "
              f"[{card}]", flush=True)
    # ---- the seven kernels in fp16 at their main paths' shapes, beside
    # their bf16 rows of this session ----
    f16 = torch.float16
    fp16_rows = {}
    for tag, case, bf in (("train", (TRAIN_B, TRAIN_S, 12, 64, True),
                           (fwd_rows[1], bwd_rows[0])),
                          ("titan", (TITAN_B, TITAN_S, 64, 64, False),
                           (fwd_rows[6], bwd_rows[6]))):
        b_, s_, h_, d_, c_ = case
        rows = dict(bwd_case(fa, torch, b_, s_, h_, d_, f16, c_),
                    flash_fwd=fwd_case(fa, torch, b_, s_, h_, d_, f16, c_))
        fp16_rows[tag] = rows
        for kname in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                      "flash_bwd_dkv"):
            r = rows[kname]
            ref = bf[0] if kname == "flash_fwd" else bf[1][kname]
            print(f"kernels: fp16 {kname} at the {tag} shape {r['shape']} "
                  f"causal={r['causal']} max_abs_err={r['max_abs_err']:.3g} "
                  f"(tol {r.get('tol', r.get('tol_out'))}) device_ms="
                  f"{r['device_ms']:.4f} (bf16 {ref['device_ms']:.4f}, "
                  f"ratio {r['device_ms'] / ref['device_ms']:.3f}) SDPA fp16 "
                  f"library_device_ms={fmt_ms(r['library_device_ms'])} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"plain_ms={r['plain_ms']:.4f} [{card}]", flush=True)
    fp16_steps = ring_step_case(tra, torch, 96, 128, 64, f16, False, step=1)
    fp16_steps["ring_dq_step"] = dq_step_case(tra, torch, 96, 128, 128, 64,
                                              f16, False, sp_hop)
    for kname in RING_KERNELS:
        r = fp16_steps[kname]
        ref = dq_rows[0] if kname == "ring_dq_step" else \
            step_rows[False][kname]
        print(f"kernels: fp16 {kname} at the sp hop {r['shape']} "
              f"max_abs_err={r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"device_ms={r['device_ms']:.4f} per launch of 4 slots, "
              f"{r['device_ms_per_hop']:.4f} per slot-hop (bf16 "
              f"{ref['device_ms']:.4f}, ratio "
              f"{r['device_ms'] / ref['device_ms']:.3f}) SDPA fp16 "
              f"library_device_ms={fmt_ms(r['library_device_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.4f} [{card}]", flush=True)

    ring_devices = [torch.device("cuda", i) for i in range(SP_DEGREE)] \
        if torch.cuda.device_count() >= SP_DEGREE else \
        [torch.device("cuda", 0)] * SP_DEGREE
    ring_phase(fa, tra, torch, card, ring_devices)
    fp16_phase(fa, tra, torch, card, ring_devices)

    # ---- the main paths, each with its counts set to 0 just before ----
    train_launches = train_phase(pt, fa, torch, np, card, train_rows)
    serve_launches = serve_phase(pt, fa, torch, np, card)
    sp_launches = sp_train_phase(pt, fa, tra, torch, np, card, ring_devices)
    flagship_phase(pt, torch, card)
    titan = titan_phase(pt, fa, torch, card)
    graph_phase(pt, torch, np, card)
    fp16_flash = fp16_titan_phase(pt, fa, torch, np, card)
    fp16_ring = fp16_sp_phase(pt, tra, torch, np, card, ring_devices)
    llm_phase(pt, fa, tra, torch, np, card)
    dygraph = dygraph_phase(pt, fa, torch, np, card)
    op_phase(pt, torch, np, card)
    conv_phase(pt, torch, np, card)
    import tempfile
    gpt2_dir = tempfile.TemporaryDirectory(prefix="gpt2_artifact_")
    try:
        deploy_launches = deploy_phase(pt, fa, torch, np, card,
                                       gpt2_dir.name)
        seq_launches = seq_phase(pt, fa, torch, np, card)
        config4_phase(pt, torch, np, card)
        server_launches = server_phase(pt, fa, torch, np, card,
                                       os.path.join(gpt2_dir.name, "gpt2"))
    finally:
        gpt2_dir.cleanup()
    obs_launches = obs_phase(pt, fa, torch, np, card)
    dist_signatures = dist_phase(pt, torch, card)
    c5 = config5_phase(pt, fa, torch, np, card)
    fault_launches = fault_phase(pt, fa, torch, np, card)
    programs = {}
    static_launches = static_phase(pt, fa, torch, np, card, programs)
    analysis_phase(pt, torch, card, programs, dist_signatures)
    del programs
    warm_cache = tempfile.TemporaryDirectory(prefix="warm_cache_")
    try:
        warm = warm_start_phase(pt, torch, np, card, warm_cache.name)
        ps_phase(pt, torch, np, card)
        fleet_launches = fleet_phase(pt, fa, torch, np, card,
                                     cache_dir=warm_cache.name)
    finally:
        warm_cache.cleanup()

    summary = {"flash_fwd": dict(serving_row,
                                 launches=c5["launches"][0]
                                 + train_launches["flash_fwd"]
                                 + serve_launches + titan["launches"][0]
                                 + dygraph["launches"]["flash_fwd"]
                                 + deploy_launches
                                 + seq_launches["flash_fwd"]
                                 + server_launches
                                 + obs_launches["flash_fwd"]
                                 + fault_launches["flash_fwd"]
                                 + static_launches["flash_fwd"]
                                 + warm["flash_fwd"] + fleet_launches)}
    for kname in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        summary[kname] = dict(train_rows[kname],
                              launches=train_launches[kname]
                              + fault_launches[kname]
                              + static_launches[kname] + warm[kname] + (
                                  c5["launches"][1] + titan["launches"][1]
                                  + dygraph["launches"][kname]
                                  + seq_launches[kname]
                                  + obs_launches[kname]
                                  if kname == "flash_bwd_fused" else 0))
    # the ring kernels at the sp train's hop, launches from the sp train:
    # the step kernels over the 4 slots of a ring step
    for kname in RING_KERNELS:
        row = dq_rows[0] if kname == "ring_dq_step" else \
            step_rows[False][kname]
        summary[kname] = dict(row, launches=sp_launches[kname])
    # fp16: rows 1-4 at the titan shape, launches from path A; rows 5-7 at
    # the sp hop, launches from path B
    summary16 = {kname: dict(fp16_rows["titan"][kname],
                             launches=fp16_flash[kname])
                 for kname in fp16_flash}
    for kname in RING_KERNELS:
        summary16[kname] = dict(fp16_steps[kname], launches=fp16_ring[kname])
    paths16 = {k: "fp16 titan" for k in fp16_flash}
    paths16.update({k: "fp16 sp" for k in RING_KERNELS})
    entries = [(k, r, "train + serve + titan + dygraph + deploy + seq + "
                "server + obs + config5 + fault + static + warm_start + "
                "fleet"
                if k == "flash_fwd"
                else "train + titan + dygraph + seq + obs + config5 + fault "
                "+ static" if k == "flash_bwd_fused" else
                "sp train" if k.startswith("ring") else
                "train + fault + static + warm_start")
               for k, r in summary.items()] + \
        [(k, r, paths16[k]) for k, r in summary16.items()]
    for kname, r, path in entries:
        print(f"kernels: {kname} summary at {r['shape']} {r['dtype']}: "
              f"max_abs_err={r['max_abs_err']:.3g} kernel_ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={fmt_ms(r['library_ms'])} "
              f"library_device_ms={fmt_ms(r['library_device_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"launches={r['launches']} ({path}) [{card}]", flush=True)
    kernels = [{"name": kname, "dtype": r["dtype"], "route": "cuda",
                "source": SOURCES[kname],
                "replaces": REPLACES[kname], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"],
                **{k: r[k] for k in ("device_ms_per_hop", "bound_ms_per_hop",
                                     "library_hop_device_ms") if k in r}}
               for kname, r, _ in entries]
    print(f"smoke: wall {time.perf_counter() - t_main:.1f} s, the kernels' "
          f"build {build_s:.1f} s of it; phase walls s {PHASE_WALLS} "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rows"]:
        sys.exit(kernel_rows(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--elastic-rank"]:    # a rank of the fault phase
        sys.exit(elastic_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--fleet-replica"]:   # a replica of the fleet phase
        sys.exit(fleet_replica(sys.argv[2]))
    sys.exit(main())
