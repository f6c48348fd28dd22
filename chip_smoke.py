#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a) and ``nvcc``. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``mxnet_tpu_torch/kernels/
   csrc`` (one ``nvcc`` per source, all started together) and prints the
   build time and the compiler's register/spill report; reads the SASS of
   the bf16 tensor-core kernels B1, B2, B3, B5, B6 and B7 (``cuobjdump
   -sass``) and fails unless each has wgmma (HGMMA) and TMA load (UTMALDG)
   instructions and spills nothing beyond the bytes ``TC_SPILLS`` lists
   (B7 at D 256 and at D 128 with block_k 128), and that the wide route's
   kernels (D above 256) spill nothing and hold mma.sync (HMMA) in bf16;
3. holds the flash-attention forward (B5) against its plain PyTorch
   version on the card, at the shapes the serving and training paths give
   it and a few more (causal and not, a ``kv_len`` mask, D = 128, D = 8, 32,
   96, 192 and 256 zero-padded to 64, 128 or 256 lanes, D = 320, 384, 512
   and 1024 on the wide route, float32 and bfloat16), and times
   the kernel, the plain version and one library call (SDPA, a yardstick
   only: the port never calls it) at the training shape, a tensor-parallel
   rank's (4, 4, 2048, 64), the prefill buckets 256, 1024 and 2048 and
   ``tools/bench_e2e.py`` measure_mp's D 32 attention (2, 8, 64, 32) and
   its mp=2 rank's (2, 4, 64, 32), (4, 8, 1024, 256) and 192, and
   (2, 8, 1024, 512) on the wide route;
4. drives the serving path at full width — the 12-layer, d_model 512
   transformer (random weights from seed 0) behind
   ``GenerateServer(slots=8, page_size=16)`` — with 16 concurrent requests
   of 8..1500 prompt tokens and 32 new tokens each, checks every request,
   the page accounting and that every prefill went through B5 (12
   launches per prefill), and holds the served logits of two requests
   against the one-shot forward on the card; then replays two traces of
   ``tools/bench_serve.py`` at that width: the shared-prefix one (64
   Poisson requests, a 0.7 share under one 496-token prefix, 4 slots) with
   ``prefix_cache`` off and on (outputs equal but at bf16 near-ties, exact
   prefill-token accounting, every shared request a hit, no leaked page,
   the shared pages' bytes unchanged, 12 B5 launches per full prefill and
   none per tail prefill, served logits within ``LOGIT_TOL`` of the
   forward; TTFT both ways), and the decode-heavy one (12 requests, 48 new
   tokens) with ``spec_k`` 0 and 6 over a 1-layer self-draft (the same
   checks, the draft sharing the target's tensors, 13 B5 launches per
   admission; tokens/s both ways, ``acceptance_rate``, a round's host
   time split into draft steps and verify), then one request under
   ``MXNET_FAULT_SPEC=generate:stall@req=1``;
5. holds the fused ResNet convolution (B1: BN-apply + ReLU prologue,
   stats epilogue) against its plain version at every shape of a
   ResNet-50 forward at each batch of the serving ladder (1, 4, 16, 64)
   and at a data-parallel rank's 32 rows, in bf16 and fp32, with and
   without the stats, and
   times the kernel, the plain version and the library equivalent (cuDNN
   on the already-activated input, plus the BN-apply + ReLU it saves) at
   each shape;
6. serves the fused ResNet-50 (1000 classes, 224x224, random weights from
   seed 0) through ``ModelServer`` in bf16 on the ladder (1, 4, 16, 64):
   checks its logits against the unfused graph in fp32 on the card and
   that a forward launches B1 52 times, then serves 48 seeded requests of
   1..16 images from 4 threads and prints images/s, latency, the forward
   time per bucket, the device's busy share and peak memory;
7. holds the two backward kernels, B6 (dq) and B7 (dk, dv), against the
   plain backward in the same way (D 8, 32, 96, 192 and 256 padded too,
   D 320, 384, 512 and 1024 on the wide route),
   with the
   SDPA backward as the yardstick, at both training shapes and the two D
   32 shapes;
8. computes the loss and every parameter gradient of a 2-layer, d_model
   512 model in fp32 on the card (B5, B6, B7) and on the CPU (the plain
   versions) and holds them together;
9. trains the full-width model — 12 layers, d_model 512, vocab 32000,
   bf16 compute, random weights from seed 0 — through ``make_train_step``
   on one seeded (8, 2049) batch: a warm-up step and 5 timed steps, with
   finite and falling loss, 12 launches of each of B5, B6 and B7 per step,
   and one ``remat=True`` step with the same loss and 24 B5 launches;
10. holds the fused ResNet backward kernels, B2 (weight gradient: the
   forward's BN-apply + ReLU recomputed on the x side, the g side whole or
   rebuilt by the next BN's backward) and B3 (data gradient with that
   rebuild, the input BN's relu mask and its (dbeta, dgamma) sums, the
   shortcut's extra term), against their plain versions at every call of
   a ResNet-50 train step, with the options each call uses, at batch 64,
   32 (a data-parallel rank's rows) and 2, in bf16 (every call on the
   tensor cores) and fp32, and times the
   kernels, the plain versions and the library route (the elementwise
   parts, then cuDNN's weight-only or input-only convolution backward);
11. computes one step's gradients of a tiny fp32 fused ResNet on the card
   and on the CPU and holds them together, and holds the full-width fused
   bf16 gradients against the unfused fp32 graph's (cuDNN, TF32 off);
12. trains the fused ResNet-50 as ``bench.py`` configures it — 1000
   classes, 224x224, bf16 compute, Xavier weights from seed 0, SGD lr 0.1,
   momentum 0.9, wd 1e-4 — through ``TrainStep`` at batch 64 on one seeded
   batch: a warm-up step, 5 timed steps and a profiled one, with a first
   loss near ln 1000, a falling loss, moving statistics that move and 52
   B1, 52 B2 and 48 B3 launches a step, none on the CUDA-core route;
13. drives ``TrainStep``'s options on the same net, batch and optimizer:
   each remat mode (False, True, "conv", "pass") for a warm-up and 3 timed
   steps, with its losses and params against remat=False, its median step
   time, peak memory, ``residual_stats`` and B1/B2/B3 launches a step
   (B1 twice a forward under remat=True); the layout pass with remat="pass"
   (transposes, copies a step, losses within 1e-2 of passes off); the
   sentinel on a batch with one NaN pixel (record and skip with no host
   sync, skip leaving params, optimizer state and aux bit for bit, halt
   raising; the NaN reaches the loss: the prologue ReLU passes it on);
   ``metric_stats`` against the host's numpy;
14. runs ``Module.fit`` on the fused ResNet-50 (fp32, batch 64, 8 batches);
15. trains the same net data parallel, one process a device over
   ``torch.distributed``, at global batch 64: ``TrainStep(mesh=
   make_mesh({"dp": 1}))`` over NCCL in bf16 for 3 steps, bit for bit
   ``mesh=None`` from the same init (a one-rank mesh runs no collective),
   52/52/48 launches a step, a profiled step with its NCCL kernels; then 2
   ranks sharing the card over gloo (NCCL refuses two ranks on one device;
   the kernels are built before they start), fp32, 32 rows a rank (B1-B3
   are held against their plain versions at 32 rows in steps 4 and 8):
   the tiny fused ResNet's first loss, gradients and 3 losses within 1e-4
   of one device; at full width the first loss within 1e-4, the whole
   gradient as close to one device's as one device's with the batch
   reordered (2x), and each tensor within 1e-4 or 2x its largest gap
   under 3 reorders; the ranks' params, aux
   and optimizer state bit for bit equal, ZeRO within rtol 1e-5 / atol 1e-6
   of the replicated update at <= 0.51 of its optimizer bytes a rank, and
   ``Module.fit(kvstore="tpu")`` over 4 copies of one batch with the
   same params and metric on both ranks. Rates of the shared card are not
   scaling rates;
16. trains the full-width transformer Megatron's way over
   ``train_mesh(mp=2)`` (dp 1 x mp 2) as 2 gloo ranks sharing the card,
   each with half the heads, vocab rows and d_ff, at batch (4, 2049):
   one fp32 step (TF32 off) with the loss within 1e-5 and every unsharded
   gradient within 1e-4 relative L2 of one device's, then 2 warm-up and 5
   timed bf16 steps (sgd with momentum) beside one device's in the same
   call, with 12 launches of each of B5, B6 and B7 a step on each rank,
   the param bytes a rank at their exact share (0.5097), 2 sums a block
   (``block_collective_counts``) and the replicated params bit for bit
   equal on the ranks; then serves through ``GenerateServer`` over
   ``GenerativePredictor(mesh=)`` on the leader (rank 0) while rank 1
   follows in lockstep: step 4's workload (every served row within
   ``LOGIT_TOL`` of the one-device forward, chains against the one-device
   server's by the near-tie rule) and the shared-prefix trace with the
   cache on (its exact counts), half the KV bytes a rank, 12 B5 launches a
   prefill on each rank, tokens/s and TTFT beside one device's;
17. runs ``Module.fit`` on the image-classification builders at
   full width, fp32, TF32 off, sgd with momentum, 1000 classes, batch 32
   of 224x224 images: alexnet, vgg-16, inception-bn, mobilenet 1.0 and
   resnext-50 (32x4d), then lenet and mlp at MNIST shape, batch 64; one
   warm-up batch and 4 timed batches of one batch repeated (the loss must
   fall), printing seconds a batch, images/s, peak memory and a profiled
   batch's device time; holds the networks without dropout card vs CPU
   (the first loss within 1e-4, the gradients within 3x the gap one
   rounding of the inputs and weights gives) and, for alexnet and vgg,
   the inference logits within 1e-4 and each dropout layer's keep rate
   within 5 sigma; holds one ``nd.RNN`` (lstm, PTB-medium: T 35, N 32,
   650 wide, 2 layers) at p = 0 card vs CPU within 1e-4 and times it at
   p = 0.5; no hand-written kernel launches there;
18. trains the PTB-medium LSTM language model (Zaremba et al. 2014:
   vocabulary 10000, 650 wide, 2 layers, 35 steps, batch 20, dropout 0.5;
   examples/rnn/lstm_bucketing.py's graph, Embedding first) through
   ``Module.fit`` in fp32 with SGD at learning rate 1.0 from uniform
   +-0.05 weights on a seeded Zipf token stream: a warm-up batch and 4
   timed ones (the loss must start near ln 10000 and fall), printing
   tokens/s, peak memory and a profiled batch's busy share; holds the
   first loss (within 1e-4) and the gradients (within 3x the one-rounding
   yardstick) card vs CPU at batch 4 with dropout 0;
19. serves the trained LM's next token through ``AOTPredictor`` (a graph
   of Embedding, SequenceMask, RNN, SequenceLast, FullyConnected, softmax
   and topk) for 40 padded prompts on the ladder (1, 4, 16), a bucket
   filled partly, and holds the top 5 against the CPU's (values within
   1e-4, ids equal but at ties), printing requests/s and the busy share;
20. holds every one of the 95 tensor ops of Queue A item 7b, forward and
   gradient, card vs CPU within 1e-4 of each tensor's largest magnitude,
   on tests/test_op_sweep.py's specs and on indices out of range or
   negative, ties and the hypot kink; B1-B7 launch 0 times in 18-20;
21. trains SSD300 (VGG16-reduced, 20 VOC classes, 300x300, 8732 anchors:
   models/ssd.py's ``get_symbol_train``) through ``Module.fit`` in fp32 at
   batch 32 with example/ssd's SGD (lr 0.004, momentum 0.9, wd 5e-4) from
   Xavier weights on one seeded synthetic batch (1-8 boxes an image, padded
   with -1) repeated: a warm-up batch and 4 timed ones (the cls_prob
   cross-entropy must fall), printing seconds a batch, images/s, peak
   memory and a profiled batch's busy share and launches; holds the first
   forward (cls_label equal, cls_prob and loc_loss within 1e-4) and the
   gradients (within 3x the one-rounding yardstick) card vs CPU at batch 2;
22. serves the trained detector (``get_symbol``: softmax and
   MultiBoxDetection's NMS) through ``AOTPredictor`` on the ladder (1, 4,
   16) for 5 requests of 26 images, printing requests/s, the NMS rounds
   and the busy share, and holds one request of that predictor against
   the CPU: the network's outputs within 1e-5, and the card's
   MultiBoxDetection on them against the CPU's (classes and kept mask
   equal, scores and boxes within 1e-5); then the whole graph the same way
   on one request with the class heads reduced to separated biases;
23. holds the 17 names of Queue A item 7d (contrib and vision ops) forward
   and gradient card vs CPU on tests/test_op_sweep.py's specs, a
   MultiBoxTarget whose forced matches collide and MultiBoxDetection over
   8732 anchors, holds Proposal at its default size (6000 candidates, 300
   kept) card vs CPU with its NMS rounds and time, and holds
   the 14 random names of item 7c by their moments (20000 draws a row) and
   bit for bit across two runs; B1-B7 launch 0 times in 21-23;
24. serves int8 post-training-quantized models (``AOTPredictor(quant=
   "int8")``, ``ops/quantized.py``): holds each int8 product of ResNet-50
   (53 convolutions and fc1, at batch 1 and 64) on the card against
   float64 of the same int8 operands, the int32 accumulation bit for bit,
   and ``_quantize_int8`` at k + 0.5 steps of its scale against the CPU's,
   timing each product at batch 64 beside cuDNN's bf16 convolution; trains
   ``tools/bench_serve.py``'s quant MLP (dim 256, hidden 512, 6 layers, 64
   classes) through ``Module.fit`` on its clustered task, calibrates on 8
   batches of 64, holds int8-vs-bf16 top-1 agreement >= 0.99 on 2048 rows
   and 7 quantized ops, and serves bf16 and int8 behind ``ModelServer``
   under its closed loop (24 clients, think 2 ms, 8 rows, 2.5 s a mode):
   req/s and p50/p99; hot-swaps the MLP from a ``save_checkpoint`` pair
   under load (``swap_from_checkpoint``), the int8 outputs equal to a fresh
   bind's; then the unfused ResNet-50 at full width: 54 quantized ops, the
   card's int8 graph against the CPU's on the same int8 weights and scales
   (node by node on the card's inputs: the int8 ops equal, the float ops
   within 1e-6; free running: the activations that cross a re-quantize
   boundary counted by layer, the logits within the CPU's own
   int8-vs-fp32 gap), and the 48-request
   trace in bf16 and int8 (images/s, p50/p99, peak memory, a profiled
   batch of 64); B1-B7 launch 0 times there;
25. runs the schedule autotuner (``mxnet_tpu_torch.tune``): holds every
   candidate tile of B5-B7 (at (8, 8, 1024, 128) and the training shape)
   and of B1-B3 (at 64 x 14 x 14 x 256 -> 256, 3x3) against the plain
   versions at the same tile, B1 bit for bit across ``chan_block``; runs
   ``python -m mxnet_tpu_torch.tune --compare``'s flow on a temporary
   table at the CLI's defaults and at the training key (8, 8, 2048, 2048,
   64, 1) and prints each key's winner, device / event ms beside the
   default's, ``speedup_vs_default``, n_timed / n_pruned and the ranked
   and exhaustive wall times; a second run must be all cache hits; one
   transformer train step and one fused ResNet-50 ``TrainStep`` with the
   table armed must hit their keys with the same launch counts (12/12/12,
   52/52/48) and losses within 2**-6 of the untuned steps; ``Module.fit``
   with ``MXNET_TUNE_BACKGROUND=1`` on the fused ResNet-50 must commit a
   key at an epoch-end drain boundary. Every phase before it runs on an
   empty table of the run's own (the hand tiles);
26. drives the data plane as ``bench.py``'s ``fit`` variant does:
   ``Module.fit`` of the unfused ResNet-50 v2 in fp32 (kvstore 'tpu', the
   fused SPMD group engaged; SGD lr 0.1, momentum 0.9, Xavier, 3 epochs)
   over 4 batches of 128 records (64, then 32, on out-of-memory) written
   by ``write_record_shards``, through ``ShardedRecordStream`` (2 decode
   workers, prefetch 4) -> ``ShardedBatchIter`` -> ``DeviceQueueIter``;
   prints bench.py's fit record (images/s, host syncs, put and feed-stall
   ms, records read, input wait and its p99) with the input-wait share
   and a profiled fourth epoch's device busy share, and the same fit from
   the same decoded arrays in memory (``NDArrayIter``); checks every
   record read once an epoch, a falling epoch cross-entropy and the first
   epoch's placed batches against a synchronous read (sha1); then the
   fused ResNet-50 behind the same feed for one epoch of 6 batches of 64
   (52/52/48 launches a batch), and the port's copy of
   ``tools/bench_data.py``'s ``measure`` (2048 records of (3, 64, 64),
   sync against prefetched, the deterministic replay);
27. drives the sparse paths (``sparse_phase``): the Criteo-shaped linear
   classification of ``examples/sparse/linear_classification.py`` (1e6
   hashed features, 13 integer and 26 categorical fields, 39 nonzeros a
   row, batch 8192, 20 batches made from seed 0 as CSR triples:
   ``nd.dot(csr, w)``, ``nd.dot(csr, err, transpose_a=True)``, lazy SGD on
   the row-sparse gradient, twice bit-identical, then lazy Adam):
   ``csr·dense`` and ``csrᵀ·dense`` card vs CPU within 1e-4, the lazy
   updates' touched rows within 1e-5 and every other row bit for bit,
   accuracy rising, device times of the products and the update beside
   the dense ``torch.matmul`` on the densified batch, seconds a batch and
   the device busy share; then ``Module.fit`` of the MovieLens-20M-shaped
   matrix factorization (138,493 users, 27,278 items, factor 64, batch
   8192, 40 batches, SGD momentum on a ``kv.create('local')`` instance,
   ``sparse_row_id_fn``): falling MSE, ``row_sparse_pull`` exact, the
   store's values on the card;
28. drives the parameter-server tier (``embed_phase``): the port's copy
   of ``tools/bench_embed.py``'s ``measure`` with 4 servers on the card
   (131072 rows, dim 64, batch 4096, 8 iterations, zipf 1.2): its record
   under the reference's keys, ``as_dense()`` against a numpy replay of
   the pushes as sent within 1e-5, ``mem_ratio_max <= 1/4 + 0.01``, the
   stored tables on the card; again at 2,097,152 rows without the naive
   and sync legs; again at 131072 rows with each server in a process of
   its own, no naive leg (the pipelined client against the synchronous
   one); then ``Module.fit`` of a small MLP through two servers
   on the card (falling loss, the servers' weights equal the module's).
   B1-B7 launch 0 times on both;
29. trains the MoE transformer (``n_experts=8`` on the full-width model:
   12 layers, d_model 512, vocab 32000, bf16, every expert computed as the
   JAX package's dense soft-gated mixture) through ``make_train_step``
   (SGD lr 0.1, momentum 0.9) on one seeded (8, 2049) batch: a warm-up
   and 5 timed steps, the first loss within ln(32000) +- 0.25, a falling
   loss, 12 launches of each of B5, B6 and B7 a step, tokens/s, step
   times, peak memory and the busy share; then a 2-layer fp32 MoE's
   gradients card vs CPU as in 8, each tensor within the larger of 1e-4
   and 3x the gap one rounding of the weights gives on the CPU (8 experts
   hold 8x the ReLU units whose kinks flip under any summation order);
30. serves that MoE model behind ``GenerateServer(slots=8, page_size=16)``
   with step 4's 16 prompts, 32 new tokens each: 12 B5 launches a prefill,
   two requests' served logits within ``LOGIT_TOL`` of the forward and
   every greedy chain against the forward's argmax by the near-tie rule;
   again with ``prefix_cache=True, spec_k=4`` over a 1-layer self-draft
   (13 B5 launches a prefill), its chains against the first run's by that
   rule; tokens/s and TTFT p50 of both;
31. runs the MoE (4 layers, fp32, TF32 off) over ``train_mesh(mp=2)`` on 2
   gloo ranks sharing the card: a loss forward's collectives equal
   ``block_collective_counts`` (2 sums a block), the loss within 1e-5 of
   one device's, every unsharded gradient (``moe_gate_weight``'s too,
   summed over the mp group in the backward) within the zoo yardstick of
   one device's, the gate's gradient bit for bit equal on the ranks;
32. trains Gluon's ``resnet50_v1`` (1000 classes) from the vision model
   zoo, hybridized, fp32 with TF32 off, with ``Trainer`` (sgd lr 0.1 a
   256 images scaled to the batch, 0.0125, momentum 0.9, wd 1e-4) on
   ``SoftmaxCrossEntropyLoss`` at (32, 3, 224, 224): a warm-up and 5 timed
   steps on one seeded batch (the loss must fall), images/s, peak
   memory and the busy share; checks the eager and hybridized forwards
   against each other, the card against the port's CPU forward on the same
   weights at batch 2 (within 3x the gap one rounding gives), ``export`` ->
   ``AOTPredictor`` against the Gluon forward, and one network of each
   other zoo family (resnet v2, vgg with BatchNorm, alexnet, squeezenet,
   mobilenet, densenet, inception v3 at 299) eager against hybridized;
   B1-B7 launch 0 times there;
33. serves the fused ResNet-50 (bf16, ladder 1, 4, 16) from a fleet on
   one host (``fleet_phase``): a port ``Tracker`` in the script's process
   and 3 replica processes on cuda:0 (``python -m
   mxnet_tpu_torch.serving.fleet replica``) behind a ``FleetRouter``: 16
   routed requests of 1..4 images against an in-process bf16
   ``AOTPredictor`` of the same checkpoint (``RESNET_LOGIT_TOL`` of the
   largest output, top-1 >= ``RESNET_TOP1``); 16 closed-loop clients for
   one window at 1 replica and one at 3 with a replica SIGKILLed midway
   (images/s, p50/p99, and 0 failed); a rolling ``fleet_swap`` to the
   seed-1 checkpoint under load (0 dropped, 0 errors, then the seed-1
   outputs); a ``FleetAutoscaler`` over a stepped load low -> high -> low
   whose actuator spawns and retires replica processes (peak >= 2, back to
   1, 0 failed); a two-tenant QoS trace (the bulk tenant over its quota,
   the latency tenant's p99 alone and beside it); one embedding lookup
   replica over two in-process parameter servers, routed against its
   in-process predictor. Each replica writes its B1 launches when it
   stops: > 0 and a multiple of 52 for every replica that served and
   stopped (the killed one cannot report);
34. drives the single-process tail (``tail_phase``): compiles a saxpy and
   a row softmax from CUDA source at run time (``rtc.CudaModule``, NVRTC,
   sm_90a), prints the first compile's seconds and the cached second's,
   holds them against torch (saxpy bit for bit, the softmax within
   ``TAIL_SOFTMAX_TOL`` per element) and refuses a CPU NDArray; gives the
   full-width fused ResNet-50 (fp32, batch 64, one seeded batch) a
   ``Custom`` softmax-loss head whose body launches that softmax and forms
   p - onehot(label) on the card, and holds its outputs and every
   gradient against ``SoftmaxOutput``'s within ``TAIL_HEAD_TOL``; trains
   it 4 batches by ``Module.fit`` under ``Monitor(interval=2)``, the
   profiler in mode ``all`` and ``LogMetricsCallback`` (B1/B2/B3 52/52/48
   a batch, a falling loss, one Monitor row for each output and argument
   of each monitored batch and two of them against torch's norm, 4
   forward, backward and forward_backward events and the body's, the
   updater's and the Monitor's operator events, the event file read back
   with steps 1..4), printing images/s and the busy share beside the
   ``module_fit`` phase's; and checks ``print_summary``'s total of the
   ResNet-50 symbol (25.5 M) against the arguments' sizes;
35. shards a symbol over ``train_mesh(mp=2)`` on 2 gloo ranks sharing the
   card (``mp_symbol_phase``; ``MPS_RULES``: the fused ResNet-50's stage-3
   and stage-4 conv weights on their output channels, fc1 on its rows):
   (a) trains it by ``Module.fit(kvstore='tpu')`` under
   ``MXNET_MP_SIZE=2``, fp32 (TF32 off), 4 batches of 32, holding the
   first step's gradients and the fitted params, unsharded, against one
   device's within max(1e-4, 3x the gap one rounding of the params gives),
   B1/B2/B3 52/52/48 a batch on each rank and the param bytes a rank at the
   ratio the rules give; (b) serves it in bf16 from
   ``AOTPredictor(mesh=, param_rules=)`` behind ``ModelServer`` (logits
   within 0.02 of the largest of the unsharded predictor's, B1 52 a
   forward on each rank, images/s beside the unsharded predictor's), and
   binds ``resnet.init_params``' weights sharded and unsharded in bf16 and
   fp32 (fp32 logits within 1e-4 of the largest; the sharded bf16 logits'
   RMS distance from fp32 within 3x the unsharded bf16's; the gaps printed
   in bf16 ulps); (c)
   serves the full-width transformer by ``GenerateServer(spec_k=4)`` with
   a 1-layer self-draft over the sharded predictor (chains equal to one
   device's but at near-ties, B5 launches, token accounting and the
   acceptance rate); (d) serves (b) from a 2-member replica group of
   ``fleet replica --group-size 2`` processes behind ``FleetRouter`` (its
   logits within 0.02 of the largest of the unsharded predictor's), then
   SIGKILLs the follower: the group drains (``NoLiveReplica``, failovers
   and lost requests 0);
36. prints one JSON line describing each kernel, then the result line
   ``{"ok": true, "device": {...}}`` last.

Every time of a kernel, of its plain version and of its library call is
taken on two timers (``_time_ms``): CUDA events around each call, which
also hold the wrapper's host time whenever the card waits for it, and the
same events behind a spin kernel queued first, which hide it (device
time only).

Any failed phase exits non-zero before the result line. Without a CUDA
device, or without the package beside it, it exits non-zero at once.

    python3 chip_smoke.py --grad-repeat N

runs only the phases before the fp32 gradient check (the grad phase),
then that check N + 1 times, the allocator's cached blocks filled with
NaN before each repeat, and fails unless each repeat passes and gives the
card's loss and gradients of the first bit for bit. A failed grad check
names, in its error, the gaps, which side a second computation moves, the
host's CPU and the card's clocks and ECC count.
"""
import gc
import json
import logging
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

FULL = dict(vocab=32000, d_model=512, n_heads=8, n_layers=12, d_ff=2048,
            max_len=2048, dtype="bfloat16")
N_REQUESTS, NEW_TOKENS, PROMPT_LENS = 16, 32, (8, 1500)
# Logits at full width have a std of about 0.45 (embed std 0.02, d_model
# 512). bf16 keeps 8 significant bits, and the served path (padded prefill,
# paged decode) rounds at other places than the one-shot forward across 12
# layers; the measured gap on an H100 is about 0.023, so 0.05 leaves twice
# that. Only the decode positions cross-check attention: prompt positions
# go through the flash kernel on both sides.
LOGIT_TOL = 0.05
# kernel vs plain: out is held per query row against that row's own scale,
# max_d |out - ref| / max_d |ref| (two bf16 ulps, 2**-6; fp32 summation
# order only), so rows over thousands of keys, whose |out| is ~0.05, are
# held as tightly as rows over a few; lse (fp32 in both) absolutely
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -6, 1e-3)}
# backward kernels vs plain: each gradient row (dq per query row, dk and dv
# per key row) against the row's own scale, by the same reasoning. The
# scale is clamped from below at 1% of the tensor's largest row: a row
# whose exact value is 0 (dq of query row 0 under causal, where one live
# key gives ds = 0) comes out of both sides as ~1e-7 of rounding noise,
# which has no scale of its own
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# the training phase: full width, 8 sequences of 2048 tokens (+1 target)
TRAIN_BATCH, TRAIN_STEPS = (8, 2049), 5
# first loss of random weights: logits have std ~0.45 (sqrt(512) * 0.02),
# so the cross-entropy is about ln(32000) + 0.45**2 / 2 = 10.47
FIRST_LOSS, FIRST_LOSS_TOL = 10.47, 0.25
# remat recomputes the same bf16 forward: the loss moves by rounding only
REMAT_LOSS_TOL = 1e-2
# card-vs-CPU gradients: fp32 everywhere (TF32 off), summation order only
GRAD_CFG = dict(vocab=32000, d_model=512, n_heads=8, n_layers=2, d_ff=2048,
                max_len=2048, dtype="float32")
GRAD_BATCH, GRAD_TOL = (2, 257), 1e-4
# image serving: fused ResNet-50 at full width on the serving ladder
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
RESNET_LADDER = (1, 4, 16, 64)
# the data-parallel path (dp_training_phase): a global batch of 64 over 2
# ranks, 3 steps. B1-B3 are held against their plain versions at the rows
# a rank holds too
DP_BATCH, DP_STEPS, DP_RANKS = 64, 3, 2
DP_RANK_ROWS = DP_BATCH // DP_RANKS
RESNET_REQUESTS, RESNET_MAX_IMAGES, RESNET_THREADS = 48, 16, 4
RESNET_CHECK_IMAGES = 16
# B1 launches per forward: 3 per unit, 4 in each of the 4 downsample units
RESNET_UNITS = 16
B1_PER_FORWARD = RESNET_UNITS * 3 + 4
# B1 vs plain: each output pixel (a row of Co channels) against its own
# scale, as for B5; the stats per channel against that channel's sum of |y|
# (sum of y^2 for the squares)
CONV_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# B1 is timed at batch 64; its JSON entry is the stage-1 3x3, (h, ci, co,
# k, stride), whose max_abs_err comes from the bf16 check at that batch
CONV_TIME_BATCH, CONV_MAIN = 64, (56, 64, 64, 3, 1)
# fused bf16 logits against the unfused fp32 graph, relative to the largest
# |logit| (~10 with these weights), and the share of images whose top-1
# class must agree. bf16 keeps 8 significant bits and every unit rounds its
# activations; the measured gap on an H100 is 0.0054, so 0.02 leaves ~4x
RESNET_LOGIT_TOL, RESNET_TOP1 = 0.02, 0.9
# fused ResNet-50 training, bench.py's configuration, at batch 64 on one card
CARD = "cuda"
RESNET_TRAIN_BATCH, RESNET_TRAIN_STEPS = 64, 5
RESNET_OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
# launches a train step: B1 as in a forward; B2 three a unit plus the
# downsample shortcut's dw in 4 units; B3 three a unit (the shortcut's data
# gradient rides conv1's as its extra term)
B2_PER_STEP = RESNET_UNITS * 3 + 4
B3_PER_STEP = RESNET_UNITS * 3
# first loss of Xavier weights: ln(1000) = 6.91 plus half the logits'
# variance; the pooled features (relu of a unit-variance BN output) and a
# Xavier FC give logits of std ~0.5, so ~7.0; the band allows twice that
RESNET_FIRST_LOSS, RESNET_FIRST_LOSS_TOL = 6.91, 0.5
# B2 and B3 against their plain versions at the calls of a train step at
# batch 64, at a data-parallel rank's 32 rows and at batch 2 (ragged
# tiles). B3 is held as B1 is (CONV_TOL,
# per input pixel; its stats per channel against the channel's sum of
# |e| and of |e * xhat|). B2 per (tap, Co) column of dw against the
# column's largest sum of |terms|: both sides multiply the same rounded
# operands in f32, so only the order of the sums differs, in both types
GRAD_CHECK_BATCHES = (RESNET_TRAIN_BATCH, DP_RANK_ROWS, 2)
WGRAD_TOL = 1e-4
# the stage-1 3x3, as conv2 of a stage-1 unit calls them: (n, h, ci, co, k,
# stride), the g side rebuilt by bn3's backward
GRAD_MAIN = (RESNET_TRAIN_BATCH, 56, 64, 64, 3, 1)
# card vs CPU gradients of the tiny fused ResNet (tests/test_fused_resnet.py's
# _tiny_resnet), one step at batch 4, fp32 on both sides, TF32 off
TINY_RESNET = dict(units=[2, 1], num_stages=2, filter_list=[8, 16, 32],
                   num_classes=5, image_shape=(3, 64, 64), bottle_neck=True)
TINY_BATCH = 4
# full-width fused bf16 gradients against the unfused fp32 graph's, per
# parameter tensor, at Xavier init. bf16 noise dominates many of them there
# (a BN gamma or beta whose exact gradient is ~0: the net is invariant to
# scaling a BN's gamma and beta together where a BN follows), in the fused
# graph and the unfused one alike, so the yardstick is the unfused graph
# in bf16 (the library route): every tensor's relative L2 gap to fp32 is
# at most FUSED_GRAD_RATIO times the library's own. One rule for all 155
FUSED_CHECK_BATCH = 8
FUSED_GRAD_RATIO = 1.5


def _card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


# the bf16 tensor-core kernels B1, B2, B3, B5, B6 and B7: (library, a
# string their mangled names hold)
TC_KERNELS = (("fused_conv_fwd", "conv_fwd_tc_kernel"),
              ("fused_conv_wgrad", "conv_wgrad_tc_kernel"),
              ("fused_conv_dgrad", "conv_dgrad_tc_kernel"),
              ("flash_attention_fwd", "flash_fwd_tc_kernel"),
              ("flash_attention_bwd", "flash_bwd_dq_tc_kernel"),
              ("flash_attention_bwd", "flash_bwd_dkv_tc_kernel"))


# the tensor-core instantiations that spill, with the stack and local
# bytes cuobjdump -res-usage gives them (measured on the H100 build, PERF.md
# section 6): B7 where a consumer warpgroup keeps two 64-column panels of
# both dK and dV (128 accumulator floats) beside the two 64 x 64 score
# tiles, under the 168 registers a thread that a CTA of 288 threads (9
# warps, allocated as 12) leaves: D 256, and D 128 at block_k 128; and B7
# at D 128 with two query sub-tiles a slot (8 bytes). Any other
# instantiation must not spill, and these not more than this
TC_SPILLS = {("flash_bwd_dkv_tc_kernel", "128, 1, 2"): 8,
             ("flash_bwd_dkv_tc_kernel", "128, 2, 1"): 520,
             ("flash_bwd_dkv_tc_kernel", "128, 2, 2"): 408,
             ("flash_bwd_dkv_tc_kernel", "256, 1, 1"): 256}


def _cuobjdump(nvcc):
    """cuobjdump beside nvcc, else Triton's copy."""
    cands = [os.path.join(os.path.dirname(nvcc), "cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for cand in cands:
        if os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("cuobjdump not found in %s" % cands)


_DUMPS = {}


def _dump(tool, flag, lib):
    """``cuobjdump <flag> <lib>``'s output, run once a (flag, library)."""
    key = (flag, str(lib))
    if key not in _DUMPS:
        _DUMPS[key] = subprocess.run([tool, flag, str(lib)],
                                     capture_output=True, text=True,
                                     timeout=120, check=True).stdout
    return _DUMPS[key]


def _res_usage(tool, lib):
    """{mangled kernel name: (registers, local-memory bytes)} from
    ``cuobjdump -res-usage``; spilled registers live in local memory, so a
    kernel with 0 bytes of it spills nothing."""
    out = _dump(tool, "-res-usage", lib)
    report, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        fields = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", line))
        if name and len(fields) == 3:
            report[name] = (int(fields["REG"]),
                            int(fields["STACK"]) + int(fields["LOCAL"]))
            name = None
    return report


# the wide route of B5-B7 (D above 256, csrc/flash_attention_wide.cuh):
# mma.sync (HMMA) in bfloat16, fp32 FMAs in float32; none may spill
WIDE_KERNELS = (("flash_attention_fwd", "wide_fwd_kernel"),
                ("flash_attention_bwd", "wide_dq_kernel"),
                ("flash_attention_bwd", "wide_dkv_kernel"))


def _sass_counts(tool, lib_path, kernel, marks):
    """{mangled name of each instantiation of ``kernel``: [count of each of
    ``marks`` in its SASS]} (``cuobjdump -sass``)."""
    sass = _dump(tool, "-sass", lib_path)
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                counts[name] = [0] * len(marks)
        elif name:
            for i, mark in enumerate(marks):
                counts[name][i] += mark in line
    if not counts:
        raise RuntimeError("sass: no %s in %s" % (kernel, lib_path))
    return counts


def sass_phase(build):
    """Counts the wgmma (HGMMA) and TMA load (UTMALDG) instructions in the
    SASS of the bf16 tensor-core kernels (``cuobjdump -sass``) and prints
    their registers and stack/local bytes (``cuobjdump -res-usage``, which
    reads the built library, so a cached build is checked too); fails if
    either count is 0 or an instantiation uses local memory (spills),
    beyond the bytes ``TC_SPILLS`` lists for it. The wide route's kernels
    (``WIDE_KERNELS``) must have mma.sync (HMMA) in bfloat16 and spill
    nothing."""
    from concurrent.futures import ThreadPoolExecutor

    tool = _cuobjdump(build._nvcc())
    libs = sorted({lib for lib, _k in WIDE_KERNELS + TC_KERNELS})
    # each library's two dumps once, all together
    with ThreadPoolExecutor(2 * len(libs)) as pool:
        list(pool.map(lambda a: _dump(tool, *a),
                      [(flag, build.lib_path(lib)) for lib in libs
                       for flag in ("-sass", "-res-usage")]))
    for lib, kernel in WIDE_KERNELS:
        usage = _res_usage(tool, build.lib_path(lib))
        for name, (n_mma,) in sorted(_sass_counts(
                tool, build.lib_path(lib), kernel, ("HMMA",)).items()):
            bf16 = "bfloat16" in name
            regs, local = usage[name]
            print("sass %s<%s>: HMMA %d; registers %d, stack and local bytes "
                  "%d" % (kernel, "bfloat16" if bf16 else "float32", n_mma,
                          regs, local))
            if local or (bf16 and not n_mma):
                raise RuntimeError("sass: %s spills or (bf16) has no "
                                   "mma.sync" % name)
    for lib, kernel in TC_KERNELS:
        counts = _sass_counts(tool, build.lib_path(lib), kernel,
                              ("HGMMA", "UTMALDG"))
        usage = _res_usage(tool, build.lib_path(lib))
        for name, (n_mma, n_tma) in sorted(counts.items()):
            args = re.findall(r"Li(\d+)E", name.split(kernel, 1)[1])
            if name not in usage:
                raise RuntimeError("sass: no resource usage for %s" % name)
            regs, local = usage[name]
            print("sass %s<%s>: HGMMA %d, UTMALDG %d; registers %d, stack "
                  "and local bytes %d" % (kernel, ", ".join(args), n_mma,
                                          n_tma, regs, local))
            if not (n_mma and n_tma):
                raise RuntimeError("sass: %s has no wgmma or no TMA load"
                                   % name)
            allowed = TC_SPILLS.get((kernel, ", ".join(args)), 0)
            if local > allowed:
                raise RuntimeError("sass: %s spills (%d bytes of stack and "
                                   "local memory, %d listed)"
                                   % (name, local, allowed))
    _DUMPS.clear()


# the spin kernel counts cycles; at most ~2e9 of them a second on an H100,
# so a spin sized at this rate lasts at least as long on a slower clock
SPIN_CYCLES_PER_S = 2e9


def _time_ms(torch, fn, reps=30, warmup=5):
    """``(event, device)`` ms of one call of ``fn``, each the median over
    ``reps`` calls. ``event``: CUDA events around the call, which also
    hold the wrapper's host time whenever the card waits for it.
    ``device``: the same, behind a spin kernel queued first that lasts
    twice the longest host time of a warm call, so the host has queued the
    whole call before the start event fires: device time only."""
    host = 0.0
    for i in range(warmup):
        t0 = time.perf_counter()
        fn()
        if i >= warmup // 2:          # the first calls may build or tune
            host = max(host, time.perf_counter() - t0)
    spin = int(max(2 * host, 1e-4) * SPIN_CYCLES_PER_S)
    out = []
    for device in (False, True):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if device:
                torch.cuda._sleep(spin)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        out.append(times[len(times) // 2])
    return tuple(out)


def _both(t):
    """A ``_time_ms`` pair as text: event / device ms."""
    return "%.4f / %.4f" % t


def _timed(ms, plain_ms, lib_ms):
    """A JSON entry's times: the event timer's under the contract's keys,
    the device timer's beside them."""
    out = {}
    for key, t in (("ms", ms), ("plain_ms", plain_ms),
                   ("library_ms", lib_ms)):
        out[key], out[key + "_device"] = t
    return out


# B5-B7 by input type: bf16 (the main path) on the tensor cores, fp32 on
# the CUDA cores
TC_DESIGN = "wgmma+TMA (bf16); CUDA cores (fp32)"
WIDE_ROUTE = ("D > 256: column groups of the output on the grid, mma.sync "
              "(bf16); CUDA cores (fp32)")

# per kernel: products of 2*d operations per live score, and the tensors
# it must move: (B, H, Sq, D)- and (B, H, Sk, D)-sized ones in the input
# type, and fp32 (B, H, Sq) rows
KERNEL_WORK = {
    "flash_attention_fwd": (2, 2, 2, 1),      # q.k, p.v; q, out; k, v; lse
    "flash_attention_bwd_dq": (3, 3, 2, 2),   # q.k, do.v, ds.k; q, do, dq;
                                              # k, v; lse, delta
    "flash_attention_bwd_dkv": (4, 2, 4, 2),  # q.k, do.v, p.do, ds.q; q, do;
                                              # k, v, dk, dv; lse, delta
}


def _live_scores(sq, sk, causal, kv_len):
    """Scores a (batch, head) pair needs: the unmasked ones."""
    if not causal:
        return sq * kv_len
    return sum(min(r + 1, kv_len) for r in range(sq))


def _attention_flops(kernel, b, h, sq, sk, d, causal, kv_len):
    """Operations ``kernel`` needs on these inputs: 2*d per product and
    live score."""
    return 2.0 * d * KERNEL_WORK[kernel][0] * b * h * _live_scores(
        sq, sk, causal, kv_len)


def _attention_bound(kernel, b, h, sq, sk, d, causal, kv_len, dtype):
    """Least time (ms) the card needs for ``kernel`` on these inputs: the
    operations they need over the peak rate for the input type, or each
    input read once and each output written once over the memory rate,
    whichever is larger; and which of the two it is."""
    _products, n_q, n_k, n_rows = KERNEL_WORK[kernel]
    flops = _attention_flops(kernel, b, h, sq, sk, d, causal, kv_len)
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = b * h * d * itemsize * (n_q * sq + n_k * sk) \
        + n_rows * b * h * sq * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def _row_err(torch, x, ref, floor_frac=0.0):
    """Largest row error relative to the row's own scale, max_d |x - ref|
    / max_d |ref|, the scale clamped at ``floor_frac`` of the largest."""
    diff = (x.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    floor = max(floor_frac * scale.max().item(), 1e-6)
    return (diff / scale.clamp_min(floor)).max().item()


def _device_profile(torch, fn, top=8, also=(), stats=None):
    """Run ``fn`` under torch.profiler and print the device busy share of
    its wall time (merged kernel intervals over the host-clock window), the
    device kernels that take the most time, and those whose names hold a
    string of ``also``; returns the names of those last (a list). A
    ``stats`` dict receives ``wall_ms``, ``busy_ms`` and ``launches``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not busy:
        print("profile: device busy share not measured (the profiler saw "
              "no device time)")
        return []
    print("profile: wall %.1f ms, device busy %.1f ms = %.3f of wall "
          "(idle %.3f), %d kernel launches"
          % (wall_us / 1e3, busy / 1e3, busy / wall_us, 1 - busy / wall_us,
             len(spans)))
    if stats is not None:
        stats.update(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                     launches=len(spans))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(kernels, key=dev_us, reverse=True)
    rows = rows[:top] + [e for e in rows[top:]
                         if any(name in e.key for name in also)]
    for e in rows:
        print("profile:   %7.2f ms %5.1f%% of busy  x%-5d %s"
              % (dev_us(e) / 1e3, 100 * dev_us(e) / busy, e.count,
                 e.key[:90]))
    if stats is not None:
        # where the host's time goes: the host ops with the most self time
        host = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in host[:top]:
            print("profile:   host %7.2f ms self %5.1f%% of wall  x%-5d %s"
                  % (e.self_cpu_time_total / 1e3,
                     100 * e.self_cpu_time_total / wall_us, e.count,
                     e.key[:80]))
    return [e.key for e in kernels if any(name in e.key for name in also)]


def _inputs(torch, gen, shapes, dt):
    return [torch.randn(*shape, device="cuda", generator=gen).to(dt)
            for shape in shapes]


# (B, H, S, D) of attention in the training phase: bf16, causal
TRAIN_ATTN = (TRAIN_BATCH[0], FULL["n_heads"], TRAIN_BATCH[1] - 1,
              FULL["d_model"] // FULL["n_heads"])


# C9, C11: head dims the kernels are not built for run zero-padded to 64,
# 128 or 256 lanes; held at D 8, 32, 96, 192 and 256 (cases of (b, h, sq,
# sk, causal, kv_len) each), and timed at tools/bench_e2e.py measure_mp's
# attention (d_model 256 over 8 heads, sequence 64, 2 rows) and an mp=2
# rank's
PAD_DIMS = (8, 32, 96, 192, 256)
PAD_CASES = ((2, 4, 200, 200, True, 200), (2, 4, 96, 160, False, 130))
PAD_ATTN = ((2, 8, 64, 32), (2, 4, 64, 32))


# C11: B5-B7 timed at D 192 and 256 (padded to 256 lanes) beside SDPA
D256_ATTN = ((4, 8, 1024, 256), (4, 8, 1024, 192))
# C12: head dims above 256 run on the wide route (csrc/flash_attention_wide
# .cuh), padded to a multiple of 128: held at D 320, 384, 512 and 1024 (the
# cases of PAD_CASES, both dtypes) and timed at (2, 8, 1024, 512) beside SDPA
WIDE_DIMS = (320, 384, 512, 1024)
WIDE_ATTN = ((2, 8, 1024, 512),)


def _pad_dim_times(torch, fa, gen, name, shapes=PAD_ATTN):
    """``name``'s event / device ms at ``shapes`` (bf16, causal; the D 32
    shapes of ``PAD_ATTN`` by default), beside its plain version, SDPA and
    the bound; a dict by shape."""
    import torch.nn.functional as F

    out = {}
    for b, h, s, d in shapes:
        q, k, v, do = _inputs(torch, gen, [(b, h, s, d)] * 4, torch.bfloat16)
        o, lse = fa.flash_attention_reference(q, k, v, causal=True)
        delta = fa.attention_delta(o, do)
        if name == "flash_attention_fwd":
            fn = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa
            plain = lambda: fa.flash_attention_reference(  # noqa: E731
                q, k, v, causal=True)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True)
        else:
            kernel = fa.flash_attention_bwd_dq if name.endswith("dq") \
                else fa.flash_attention_bwd_dkv
            fn = lambda: kernel(q, k, v, do, lse, delta,  # noqa: E731
                                causal=True)
            plain = lambda: fa.flash_attention_bwd_reference(  # noqa: E731
                q, k, v, o, lse, do, causal=True)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            so = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                so, (qg, kg, vg), do, retain_graph=True)
        ms, plain_ms, lib_ms = (_time_ms(torch, f) for f in (fn, plain, lib))
        bound_ms, bound_by = _attention_bound(name, b, h, s, s, d, True, s,
                                              "bfloat16")
        print("time %s bf16 (%d,%d,%d,%d) causal, padded to %d lanes "
              "(event / device): kernel %s ms (%.2fx / %.2fx SDPA), plain %s "
              "ms, SDPA %s ms, bound %.6f ms (%s)"
              % (name, b, h, s, d, fa._kernel_head_dim(d, name), _both(ms),
                 ms[0] / lib_ms[0], ms[1] / lib_ms[1], _both(plain_ms),
                 _both(lib_ms), bound_ms, bound_by))
        out["x".join(map(str, (b, h, s, d)))] = dict(
            {"bound_ms": bound_ms, "bound_by": bound_by},
            **_timed(ms, plain_ms, lib_ms))
    return out


def _wide_misaligned(torch, fa, gen, shape=(2, 4, 96, 384)):
    """The wide route's element-by-element loads: q, k, v and dout that
    start off a 16-byte boundary (views one element into a buffer), causal,
    B5 against the plain forward and B6/B7 against the plain backward, in
    both dtypes."""
    n = int(math.prod(shape))
    for dt in ("bfloat16", "float32"):
        buf = torch.randn(4 * n + 1, device="cuda",
                          generator=gen).to(getattr(torch, dt))
        q, k, v, do = (buf[1 + i * n:1 + (i + 1) * n].view(shape)
                       for i in range(4))
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
        delta = fa.attention_delta(ref, do)
        grads = (fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                           causal=True),
                 *fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta,
                                             causal=True))
        refs = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do,
                                                causal=True)
        torch.cuda.synchronize()
        e_fwd = _row_err(torch, out, ref)
        e_bwd = max(_row_err(torch, g, r, floor_frac=1e-2)
                    for g, r in zip(grads, refs))
        ok = e_fwd <= KERNEL_TOL[dt][0] and e_bwd <= BWD_TOL[dt] and \
            (lse - ref_lse).abs().max().item() <= KERNEL_TOL[dt][1]
        print("kernel %s %s causal, operands off a 16-byte boundary (the "
              "wide route's element loads): out row-relative %.3g, "
              "dq/dk/dv %.3g  %s" % (dt, shape, e_fwd, e_bwd,
                                     "ok" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("flash attention's wide route disagrees with "
                               "its plain versions on misaligned operands")


def kernel_phase(torch, fa):
    """B5 against its plain version on the card; returns the JSON entry
    fields measured here, at the training shape (launches are filled in
    by the training phase)."""
    import torch.nn.functional as F

    # the plain version's products must be full fp32 to be a reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, sq, sk, d, dt):
        return _inputs(torch, gen, [(b, h, s, d) for s in (sq, sk, sk)], dt)

    buckets = [16 << i for i in range(8)]             # 16 .. 2048
    cases = [("bfloat16", 1, 8, s, s, 64, True, s) for s in buckets]
    cases += [("float32", 1, 8, s, s, 64, True, s) for s in (16, 1024, 2048)]
    for dt in ("bfloat16", "float32"):
        cases += [(dt, 1, 8, 1024, 1024, 64, False, 1024),
                  (dt, 1, 8, 1024, 1024, 64, False, 1000),
                  (dt, 1, 8, 777, 1000, 64, True, 900),
                  (dt, 2, 4, 512, 512, 128, True, 512)]
        cases += [(dt, b, h, sq, sk, d, causal, kv_len)
                  for d in PAD_DIMS + WIDE_DIMS
                  for b, h, sq, sk, causal, kv_len in PAD_CASES]
    for b, h, s, d in (MP_ATTN, TRAIN_ATTN):
        cases.append(("bfloat16", b, h, s, s, d, True, s))
    main_err = mp_err = 0.0
    for (dt, b, h, sq, sk, d, causal, kv_len) in cases:
        q, k, v = inputs(b, h, sq, sk, d, getattr(torch, dt))
        out, lse = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                      return_lse=True)
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        e_out = (out.float() - ref.float()).abs().max().item()
        e_row = _row_err(torch, out, ref)
        e_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = KERNEL_TOL[dt]
        ok = e_row <= tol_out and e_lse <= tol_lse and \
            bool(torch.isfinite(out).all())
        print("kernel %-8s B=%d H=%d Sq=%-4d Sk=%-4d D=%-3d causal=%d "
              "kv_len=%-4d  max|out-ref|=%.3g  row-relative %.3g (tol %g)  "
              "max|lse-ref|=%.3g (tol %g)  %s"
              % (dt, b, h, sq, sk, d, causal, kv_len, e_out, e_row, tol_out,
                 e_lse, tol_lse, "ok" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("flash_attention_fwd disagrees with its "
                               "plain version")
        if (dt, b, h, sq, sk, d, causal, kv_len) == cases[-1]:
            main_err = e_out
        if (dt, b, h, sq, sk, d, causal, kv_len) == cases[-2]:
            mp_err = e_out

    _wide_misaligned(torch, fa, gen)

    # times at the prefill buckets the serving path runs, each beside one
    # SDPA forward of the same call, and at the training shape
    for sb in (256, 1024, 2048):
        qb, kb, vb = inputs(1, 8, sb, sb, 64, torch.bfloat16)
        t = _time_ms(torch, lambda: fa.flash_attention(qb, kb, vb,
                                                       causal=True))
        t_lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True))
        bms, _ = _attention_bound("flash_attention_fwd", 1, 8, sb, sb, 64,
                                  True, sb, "bfloat16")
        print("time flash_attention_fwd bf16 (1,8,%d,64) causal (event / "
              "device): %s ms, SDPA %s ms (bound %.4f ms)"
              % (sb, _both(t), _both(t_lib), bms))
    timed = {}
    for shape in (TRAIN_ATTN, MP_ATTN):
        b, h, s, d = shape
        q, k, v = inputs(b, h, s, s, d, torch.bfloat16)
        ms = _time_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                        causal=True))
        plain_ms = _time_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, causal=True), reps=10)
        lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        bound_ms, bound_by = _attention_bound("flash_attention_fwd", b, h, s,
                                              s, d, True, s, "bfloat16")
        flops = _attention_flops("flash_attention_fwd", b, h, s, s, d, True,
                                 s)
        print("time flash_attention_fwd bf16 (%d,%d,%d,%d) causal (event / "
              "device): kernel %s ms (%.1f TFLOP/s device, %.2fx bound, "
              "%.2fx / %.2fx SDPA), plain %s ms, SDPA %s ms, bound %.6f ms "
              "(%s)" % (b, h, s, d, _both(ms), flops / ms[1] / 1e9,
                        ms[1] / bound_ms, ms[0] / lib_ms[0],
                        ms[1] / lib_ms[1], _both(plain_ms), _both(lib_ms),
                        bound_ms, bound_by))
        timed[shape] = dict({"bound_ms": bound_ms, "bound_by": bound_by,
                             "shape": list(shape)},
                            **_timed(ms, plain_ms, lib_ms))
    return dict({"name": "flash_attention_fwd", "route": "cuda",
                 "source": "mxnet_tpu_torch/kernels/csrc/flash_attention_fwd"
                           ".cu",
                 "replaces": "mxnet_tpu/kernels/flash_attention.py:65",
                 "design": TC_DESIGN, "max_abs_err": main_err,
                 "library": "SDPA forward",
                 "mp": dict(timed[MP_ATTN], max_abs_err=mp_err),
                 "d32": _pad_dim_times(torch, fa, gen,
                                       "flash_attention_fwd"),
                 "d256": _pad_dim_times(torch, fa, gen,
                                        "flash_attention_fwd", D256_ATTN),
                 "d512": _pad_dim_times(torch, fa, gen,
                                        "flash_attention_fwd", WIDE_ATTN),
                 "largest_d_held": max(WIDE_DIMS), "wide_route": WIDE_ROUTE},
                **timed[TRAIN_ATTN])


def backward_phase(torch, fa):
    """B6 and B7 against the plain backward on the card; returns their
    JSON entries, measured at the training shape (launches are filled in
    by the training phase)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [("bfloat16", 1, 8, s, s, 64, True, s) for s in (64, 256, 1024)]
    cases += [("float32", 1, 8, s, s, 64, True, s) for s in (16, 1024)]
    for dt in ("bfloat16", "float32"):
        cases += [(dt, 1, 8, 1024, 1024, 64, False, 1024),
                  (dt, 1, 8, 1024, 1024, 64, False, 1000),
                  (dt, 1, 8, 777, 1000, 64, True, 900),
                  (dt, 1, 4, 1000, 600, 64, True, 600),
                  (dt, 2, 4, 512, 512, 128, True, 512)]
        cases += [(dt, b, h, sq, sk, d, causal, kv_len)
                  for d in PAD_DIMS + WIDE_DIMS
                  for b, h, sq, sk, causal, kv_len in PAD_CASES]
    for b, h, s, d in (MP_ATTN, TRAIN_ATTN):
        cases.append(("bfloat16", b, h, s, s, d, True, s))
    main_err = {}
    for case in cases:
        dt, b, h, sq, sk, d, causal, kv_len = case
        q, k, v, do = _inputs(torch, gen, [(b, h, sq, d), (b, h, sk, d),
                                           (b, h, sk, d), (b, h, sq, d)],
                              getattr(torch, dt))
        kw = dict(causal=causal, kv_len=kv_len)
        out, lse = fa.flash_attention_reference(q, k, v, **kw)
        delta = fa.attention_delta(out, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        errs, rows = {}, {}
        for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            errs[name] = (g.float() - r.float()).abs().max().item()
            rows[name] = _row_err(torch, g, r, floor_frac=1e-2)
        ok = max(rows.values()) <= BWD_TOL[dt] and all(
            bool(torch.isfinite(g).all()) for g in (dq, dk, dv)) and not (
            dk[:, :, kv_len:].any() or dv[:, :, kv_len:].any())
        print("backward %-8s B=%d H=%d Sq=%-4d Sk=%-4d D=%-3d causal=%d "
              "kv_len=%-4d  max|d-ref| dq %.3g dk %.3g dv %.3g  row-relative "
              "dq %.3g dk %.3g dv %.3g (tol %g)  %s"
              % (dt, b, h, sq, sk, d, causal, kv_len, errs["dq"], errs["dk"],
                 errs["dv"], rows["dq"], rows["dk"], rows["dv"], BWD_TOL[dt],
                 "ok" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("flash attention backward kernels disagree "
                               "with the plain backward")
        if case in cases[-2:]:          # (b, h, s, d) of the two shapes
            main_err[(b, h, sq, d)] = {"dq": errs["dq"],
                                       "dkv": max(errs["dk"], errs["dv"])}

    # times at the training shape and a mp rank's; the plain backward and
    # the SDPA backward compute dq, dk and dv together, so B6 and B7 share
    # them
    timed = {"dq": {}, "dkv": {}}
    for shape in (TRAIN_ATTN, MP_ATTN):
        b, h, s, d = shape
        q, k, v, do = _inputs(torch, gen, [(b, h, s, d)] * 4, torch.bfloat16)
        out, lse = fa.flash_attention_reference(q, k, v, causal=True)
        delta = fa.attention_delta(out, do)
        kw = dict(causal=True)
        dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw))
        dkv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw))
        plain_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw), reps=10)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_ms = _time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do, retain_graph=True))
        for key, name, ms in (("dq", "flash_attention_bwd_dq", dq_ms),
                              ("dkv", "flash_attention_bwd_dkv", dkv_ms)):
            bound_ms, bound_by = _attention_bound(name, b, h, s, s, d, True,
                                                  s, "bfloat16")
            flops = _attention_flops(name, b, h, s, s, d, True, s)
            print("time %s bf16 (%d,%d,%d,%d) causal (event / device): "
                  "kernel %s ms (%.1f TFLOP/s device, %.2fx bound, %.2fx / "
                  "%.2fx SDPA backward), plain backward %s ms, SDPA backward "
                  "%s ms (both shared by B6 and B7), bound %.6f ms (%s)"
                  % (name, b, h, s, d, _both(ms), flops / ms[1] / 1e9,
                     ms[1] / bound_ms, ms[0] / lib_ms[0], ms[1] / lib_ms[1],
                     _both(plain_ms), _both(lib_ms), bound_ms, bound_by))
            timed[key][shape] = dict(
                {"bound_ms": bound_ms, "bound_by": bound_by,
                 "shape": list(shape),
                 "max_abs_err": main_err[shape][key]},
                **_timed(ms, plain_ms, lib_ms))
    return [dict({
        "name": name, "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "mxnet_tpu/kernels/flash_attention.py:%d" % line,
        "design": TC_DESIGN,
        "plain": "flash_attention_bwd_reference: dq, dk and dv together, "
                 "shared by B6 and B7",
        "library": "SDPA backward: dq, dk and dv together, shared by B6 and "
                   "B7", "mp": timed[key][MP_ATTN],
        "d32": _pad_dim_times(torch, fa, gen, name),
        "d256": _pad_dim_times(torch, fa, gen, name, D256_ATTN),
        "d512": _pad_dim_times(torch, fa, gen, name, WIDE_ATTN),
        "largest_d_held": max(WIDE_DIMS), "wide_route": WIDE_ROUTE},
        **timed[key][TRAIN_ATTN])
        for key, name, line in (("dq", "flash_attention_bwd_dq", 103),
                                ("dkv", "flash_attention_bwd_dkv", 131))]


def _counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


def _reset_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkv.launches = 0


def grad_phase(torch, np, cfg_kw=GRAD_CFG, label="grad", nudges=0):
    """Loss and every parameter gradient of a 2-layer fp32 model, on the
    card (B5, B6, B7) against the CPU (the plain versions), from the same
    params and tokens. TF32 is off (set in kernel_phase): fp32 products
    in full precision on both sides. Each tensor is held by max|card -
    cpu| / max|cpu| within GRAD_TOL; with ``nudges`` > 0 within the larger
    of GRAD_TOL and MP_RATIO times the same gap between the CPU's gradient
    and the CPU's after one rounding of every weight (the largest of
    ``nudges`` such moves)."""
    from mxnet_tpu_torch.models import transformer as tfm

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("%s: TF32 must be off for an fp32 reference"
                           % label)
    cfg = tfm.TransformerConfig(**cfg_kw)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, GRAD_BATCH)

    def loss_grads(dev, ps):
        loss_fn, _ = tfm.make_loss_fn(cfg, device=dev)
        p = {k: v.to(dev, copy=True).requires_grad_()
             for k, v in ps.items()}
        loss = loss_fn(p, tokens)
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss.item(), {k: g.cpu() for k, g in zip(p, grads)}

    def gap(g, ref):
        return ((g - ref).abs().max() / ref.abs().max().clamp_min(
            1e-30)).item()

    got = {dev: loss_grads(dev, params) for dev in ("cuda", "cpu")}
    yard = {k: 0.0 for k in params}
    for i in range(nudges):
        rng = np.random.RandomState(400 + i)
        moved = loss_grads("cpu", {k: torch.from_numpy(_zoo_nudged(
            np, v.numpy(), rng)) for k, v in params.items()})[1]
        for k, g in moved.items():
            yard[k] = max(yard[k], gap(g, got["cpu"][1][k]))
    worst, over = 0.0, []
    for k, g_cpu in got["cpu"][1].items():
        rel = gap(got["cuda"][1][k], g_cpu)
        worst = max(worst, rel)
        limit = max(GRAD_TOL, MP_RATIO * yard[k])
        if rel > limit:
            over.append(k)
        print("%s %-18s max|card - cpu| / max|cpu| = %.3g%s"
              % (label, k, rel, " (one rounding on the CPU %.3g, limit %.3g)"
                 % (yard[k], limit) if nudges else ""))
    print("%s: loss card %.7f cpu %.7f; worst gradient %.3g (tol %g%s), "
          "%d layers, %d experts, fp32, tokens %s"
          % (label, got["cuda"][0], got["cpu"][0], worst, GRAD_TOL,
             " or %g x one rounding's gap" % MP_RATIO if nudges else "",
             cfg.n_layers, cfg.n_experts, GRAD_BATCH))
    if over or abs(got["cuda"][0] - got["cpu"][0]) > \
            GRAD_TOL * abs(got["cpu"][0]):
        raise RuntimeError("%s: card gradients differ from the CPU's: %s"
                           % (label, _grad_fault(torch, got, loss_grads,
                                                 params, gap, over)))
    return got


def grad_repeat(torch, np, fa, fb, n):
    """``chip_smoke.py --grad-repeat N``: the phases that precede the grad
    check in a full run, then the check ``N`` more times, each after the
    allocator's cached blocks were filled with NaN; every repeat must pass
    the check and give the card's loss and gradients of the first bit for
    bit (the kernels have one writer per element and no atomics)."""
    for name, fn, args in (
            ("kernel", kernel_phase, (torch, fa)),
            ("serving", serving_phase, (torch, np, fa)),
            ("prefix_serving", prefix_serving_phase, (torch, np, fa)),
            ("spec_serving", spec_serving_phase, (torch, np, fa)),
            ("conv_kernel", conv_kernel_phase, (torch, fb)),
            ("resnet_serving", resnet_serving_phase, (torch, np, fb)),
            ("backward", backward_phase, (torch, fa))):
        fn(*args)
        print("grad repeat: phase %s done" % name)
    first = grad_phase(torch, np)["cuda"]
    for i in range(n):
        junk = [torch.full((1 << (18 + i % 6),), float("nan"), device="cuda")
                for _ in range(40)]
        del junk
        got = grad_phase(torch, np)["cuda"]
        same = got[0] == first[0] and all(
            torch.equal(g, first[1][k]) for k, g in got[1].items())
        print("grad repeat %d of %d: the card's loss and gradients bit for "
              "bit the first's: %s" % (i + 1, n, same))
        if not same:
            raise RuntimeError("grad repeat %d: the card's gradients moved"
                               % (i + 1))

def _grad_fault(torch, got, loss_grads, params, gap, over):
    """What a failed card-against-CPU gradient check found, for its error
    message (a refused run may show only its standard error): the losses,
    each failing tensor's gap, whether a second computation on each side
    repeats the first bit for bit (which side moved), the host's CPU and
    the card's clocks and ECC count. The check fails all the same."""
    again = {dev: loss_grads(dev, params) for dev in ("cuda", "cpu")}
    repeat = {dev: again[dev][0] == got[dev][0] and all(
        torch.equal(g, got[dev][1][k]) for k, g in again[dev][1].items())
        for dev in again}
    cpu_model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            cpu_model = next((ln.split(":", 1)[1].strip() for ln in f
                              if ln.startswith("model name")), cpu_model)
    except OSError:
        pass
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "ecc.errors.uncorrected.volatile.total", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = "nvidia-smi failed: %s" % e
    return ("%s; loss card %.7f cpu %.7f; gaps %s; a second computation "
            "repeats the first bit for bit: card %s, cpu %s (its gaps %s); "
            "host CPU %s, %d torch threads, capability %s; card %s"
            % (over, got["cuda"][0], got["cpu"][0],
               {k: "%.3g" % gap(got["cuda"][1][k], got["cpu"][1][k])
                for k in over}, repeat["cuda"], repeat["cpu"],
               {k: "%.3g" % gap(again["cuda"][1][k], again["cpu"][1][k])
                for k in over}, cpu_model, torch.get_num_threads(),
               torch.backends.cpu.get_cpu_capability(),
               card))


def training_phase(torch, np, fa):
    """The training path at full width; returns the launch counts of the
    timed steps (B5, B6, B7)."""
    from mxnet_tpu_torch.models import transformer as tfm

    gc.collect()          # what earlier phases left in reference cycles
    held = torch.cuda.memory_allocated()
    cfg = tfm.TransformerConfig(**FULL)
    opt = dict(name="sgd", learning_rate=0.1, momentum=0.9)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, TRAIN_BATCH)
    n_tok = TRAIN_BATCH[0] * (TRAIN_BATCH[1] - 1)
    step, place = tfm.make_train_step(cfg, optimizer=opt)
    carry = place(params)
    t0 = time.perf_counter()
    carry, loss = step(carry, tokens)                    # warm-up
    losses = [loss.item()]
    print("train warm-up step: loss %.5f, %.3f s" % (
        losses[0], time.perf_counter() - t0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    _reset_counts(fa)
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        carry, loss = step(carry, tokens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _counts(fa)
    peak = torch.cuda.max_memory_allocated()
    print("train: %d steps at tokens %s (%d target tokens a step): losses "
          "%s; step times %s s; %.1f tokens/s; peak memory %.2f GiB "
          "(%.2f GiB held before the phase); launches B5 %d, B6 %d, B7 %d"
          % (TRAIN_STEPS, TRAIN_BATCH, n_tok,
             " ".join("%.5f" % x for x in losses),
             " ".join("%.4f" % x for x in secs),
             n_tok * TRAIN_STEPS / sum(secs), peak / 2 ** 30, held / 2 ** 30,
             *launches))
    _device_profile(torch, lambda: step(carry, tokens),
                    also=[name for _lib, name in TC_KERNELS])

    if not all(np.isfinite(losses)):
        raise RuntimeError("train: a loss is not finite: %s" % losses)
    if abs(losses[0] - FIRST_LOSS) > FIRST_LOSS_TOL:
        raise RuntimeError("train: first loss %.4f, expected %.2f +- %.2f"
                           % (losses[0], FIRST_LOSS, FIRST_LOSS_TOL))
    if not losses[-1] < losses[0]:
        raise RuntimeError("train: loss did not fall: %s" % losses)
    want = tuple(cfg.n_layers * TRAIN_STEPS for _ in range(3))
    if launches != want:
        raise RuntimeError("train: launches B5/B6/B7 %s, want %s (%d layers "
                           "x %d steps)" % (launches, want, cfg.n_layers,
                                            TRAIN_STEPS))

    # remat: one step from the same params gives the same loss, with the
    # forward recomputed in the backward
    del carry
    cfg.remat = True
    step, place = tfm.make_train_step(cfg, optimizer=opt)
    carry = place(params)
    _reset_counts(fa)
    carry, loss = step(carry, tokens)
    remat_loss, remat_launches = loss.item(), _counts(fa)
    print("train remat: loss %.5f (without remat %.5f), launches B5 %d, B6 "
          "%d, B7 %d" % (remat_loss, losses[0], *remat_launches))
    if abs(remat_loss - losses[0]) > REMAT_LOSS_TOL or remat_launches != (
            2 * cfg.n_layers, cfg.n_layers, cfg.n_layers):
        raise RuntimeError("train remat: loss %.5f vs %.5f, launches %s"
                           % (remat_loss, losses[0], remat_launches))
    return launches


def _serving_prompts(np, vocab):
    """serving_phase's N_REQUESTS seeded prompts and the generator that
    made them (its warm-up requests come from it next)."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, (int(n),)).astype(np.int32)
               for n in rng.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                    N_REQUESTS)]
    if len({p.tobytes() for p in prompts}) != N_REQUESTS:
        raise RuntimeError("seeded prompts are not distinct")
    return prompts, rng


def _serve_burst(torch, np, fa, srv, prompts, rng, watch):
    """The serving workload on ``srv``: a warm-up request per prefill
    bucket the prompts use (the timed run then pays no first-call costs:
    lazy CUDA module loading, cuBLAS heuristics; counters are reset after
    it), then every prompt submitted at once, NEW_TOKENS new each, with
    each prefill and decode call timed and the served logits of the
    prompts ``watch`` indexes recorded by position. Checks the requests,
    the page accounting and 12 B5 launches a prefill; returns a dict."""
    from mxnet_tpu_torch import profiler

    pred = srv.predictor
    vocab = pred.config.vocab
    for b in sorted({pred.pick_bucket(len(p)) for p in prompts}):
        srv.generate(rng.randint(0, vocab, (min(b, pred.max_ctx - 1),)),
                     max_new_tokens=2)
    watched = {prompts[i].tobytes(): {} for i in watch}
    prefill, decode = pred.prefill, pred.decode
    call_s = {"prefill": [], "decode": []}

    def rec_prefill(tokens, pages):
        t = time.perf_counter()
        logits = prefill(tokens, pages)
        call_s["prefill"].append(time.perf_counter() - t)
        key = np.asarray(tokens, np.int32).tobytes()
        if key in watched:
            watched[key][len(tokens) - 1] = logits.copy()
        return logits

    def rec_decode(tokens, positions, block_tables, active):
        t = time.perf_counter()
        logits = decode(tokens, positions, block_tables, active)
        call_s["decode"].append(time.perf_counter() - t)
        for s in np.flatnonzero(active):
            key = srv._slot_req[s].tokens.tobytes()
            if key in watched:
                watched[key][int(positions[s])] = logits[s].copy()
        return logits

    pred.prefill, pred.decode = rec_prefill, rec_decode
    try:
        torch.cuda.synchronize()
        profiler.generate_reset()
        _reset_counts(fa)
        t0 = time.perf_counter()
        futs = [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        stats = srv.stats()
        pool = pred.pool.stats()
    finally:
        pred.prefill, pred.decode = prefill, decode
    for i, r in enumerate(results):
        if len(r["tokens"]) != NEW_TOKENS or r["finish_reason"] != "length":
            raise RuntimeError("request %d: %d tokens, reason %r"
                               % (i, len(r["tokens"]), r["finish_reason"]))
    if stats["pages_in_use"] != 0 or pool["in_use"] != 0:
        raise RuntimeError("KV pages leaked: %r" % pool)
    n_layers = pred.config.n_layers
    if stats["prefills"] != N_REQUESTS or \
            launches != n_layers * stats["prefills"]:
        raise RuntimeError("flash launches %d != %d layers x %d prefills"
                           % (launches, n_layers, stats["prefills"]))
    return dict(results=results, wall=wall, stats=stats, pool=pool,
                launches=launches, call_s=call_s, watched=watched,
                tokens=sum(len(r["tokens"]) for r in results))


def _served_rows_err(np, fwd, params, prompts, results, watched, label):
    """Largest |served - forward| over the recorded rows of each watched
    request (all its NEW_TOKENS rows must be there), the forward run once
    on the request's chain."""
    errs = []
    for p, r in zip(prompts, results):
        rows = watched.get(p.tobytes())
        if rows is None:
            continue
        want = list(range(len(p) - 1, len(p) + NEW_TOKENS - 1))
        if sorted(rows) != want:
            raise RuntimeError("%s: served logits recorded at %d positions, "
                               "want %d" % (label, len(rows), len(want)))
        errs.append(_rows_vs_forward(np, fwd, params, list(p) + list(
            r["tokens"][:-1]), rows, label))
    return errs


def serving_phase(torch, np, fa):
    """The serving path at full width; returns the flash launch count."""
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.serving import GenerateServer

    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0)
    prompts, rng = _serving_prompts(np, cfg.vocab)
    srv = GenerateServer(cfg, params, slots=8, page_size=16)
    try:
        pred = srv.predictor
        run = _serve_burst(torch, np, fa, srv, prompts, rng, (0, 1))
        # where the device time goes: the first 8 prompts again, 8 new
        # tokens each, under torch.profiler (after the counts were read)
        _device_profile(torch, lambda: [
            f.result(timeout=600) for f in
            [srv.submit(p, max_new_tokens=8) for p in prompts[:8]]])
    finally:
        srv.close()
    stats, pool, wall = run["stats"], run["pool"], run["wall"]
    print("serve: %d requests, prompts %d..%d tokens, %d new tokens each; "
          "%d generated in %.3f s wall = %.1f tokens/s; busy tokens/s %s; "
          "TTFT p50 %.1f ms p99 %.1f ms; decode steps %d, slot occupancy "
          "%s; pages high water %d of %d; flash launches %d (%d layers x %d "
          "prefills)" % (N_REQUESTS, min(map(len, prompts)),
                         max(map(len, prompts)), NEW_TOKENS, run["tokens"],
                         wall, run["tokens"] / wall, stats.get("tokens_s"),
                         stats["ttft_p50_ms"], stats["ttft_p99_ms"],
                         stats["decode_steps"], stats.get("slot_occupancy"),
                         pool["high_water"], pool["num_pages"],
                         run["launches"], cfg.n_layers, stats["prefills"]))
    for kind, secs in run["call_s"].items():
        secs = sorted(secs)
        print("serve %s calls: %d, total %.3f s, median %.2f ms, max %.2f ms "
              "(host clock, each call ends in a device sync)"
              % (kind, len(secs), sum(secs), secs[len(secs) // 2] * 1e3,
                 secs[-1] * 1e3))

    # served logits against the one-shot forward on the card
    fwd = tfm.make_forward_fn(cfg)
    errs = _served_rows_err(np, fwd, pred._params, prompts, run["results"],
                            run["watched"], "serve")
    for i, err in enumerate(errs):
        print("parity request %d (prompt %d): max|served - forward| = %.4g "
              "(tol %g)" % (i, len(prompts[i]), err, LOGIT_TOL))
    if max(errs) > LOGIT_TOL:
        raise RuntimeError("served logits differ from the forward by %.4g"
                           % max(errs))
    return run["launches"]


# the shared-prefix trace of tools/bench_serve.py's prefix-share mode at full
# width: 64 Poisson requests at 400/s into 4 slots, pages of 16 tokens; a 0.7
# share are one 496-token prefix plus a 4..12-token tail, the rest unrelated
# 24..48-token prompts; 4 new tokens each, seed 0
PREFIX_TRACE = dict(requests=64, rate=400.0, slots=4, page=16, prefix=496,
                    share=0.7, tail=(4, 12), free=(24, 48), new=4, seed=0)
# the decode-heavy trace of its spec mode, at full width instead of the
# bench's narrow model: 12 Poisson requests at 50/s into 4 slots, prompts of
# 8..16 tokens, 48 new tokens each; spec_k 6 with a 1-layer self-draft; the
# upper layers damped by 1e-3 (_damp_upper_layers)
SPEC_TRACE = dict(requests=12, rate=50.0, slots=4, page=16, prompt=(8, 16),
                  new=48, k=6, draft=1, damp=1e-3, seed=0)


def _prefix_workload(vocab):
    """(prefix, [(arrival s, prompt, shared)]): tools/bench_serve.py's
    _sample_prefix_workload, the same draws from ``random.Random(seed)``."""
    import random

    t_ = PREFIX_TRACE
    rng = random.Random(t_["seed"])
    prefix = [rng.randrange(1, vocab) for _ in range(t_["prefix"])]
    t, work = 0.0, []
    for _ in range(t_["requests"]):
        t += rng.expovariate(t_["rate"])
        if rng.random() < t_["share"]:
            prompt = prefix + [rng.randrange(1, vocab) for _ in range(
                rng.randint(*t_["tail"]))]
            shared = True
        else:
            prompt = [rng.randrange(1, vocab)
                      for _ in range(rng.randint(*t_["free"]))]
            shared = False
        work.append((t, prompt, shared))
    return prefix, work


def _spec_workload(vocab):
    """[(arrival s, prompt)]: tools/bench_serve.py's measure_spec trace."""
    import random

    t_ = SPEC_TRACE
    rng = random.Random(t_["seed"])
    t, work = 0.0, []
    for _ in range(t_["requests"]):
        t += rng.expovariate(t_["rate"])
        work.append((t, [rng.randrange(1, vocab)
                         for _ in range(rng.randint(*t_["prompt"]))]))
    return work


def _damp_upper_layers(params, eps):
    """tools/bench_serve.py's helper: scale the residual-branch output
    projections of every layer but the first toward zero, a deep network
    whose upper layers contribute little, where a truncated self-draft is
    accepted often. The acceptance rate is printed beside the speedup it
    conditions."""
    out = {}
    for k, v in params.items():
        v = v.clone()
        if k in ("attn_out_weight", "ffn_down_weight") and v.shape[0] > 1:
            v[1:] *= eps
        out[k] = v
    return out


def _replay(np, srv, work, new_tokens):
    """Submit ``work`` ((arrival s, prompt, ...) rows) at its arrival times;
    returns (results, wall s)."""
    futs = []
    t0 = time.perf_counter()
    for row in work:
        now = time.perf_counter() - t0
        if now < row[0]:
            time.sleep(row[0] - now)
        futs.append(srv.submit(np.asarray(row[1], np.int32),
                               max_new_tokens=new_tokens))
    results = [f.result(timeout=600) for f in futs]
    return results, time.perf_counter() - t0


def _pctl(xs, q):
    xs = sorted(xs)
    return xs[int(round(q * (len(xs) - 1)))]


def _timed_calls(fn, acc):
    """``fn`` wrapped to add its calls and host seconds to ``acc``, a
    ``[calls, seconds]`` list."""
    def wrapped(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        acc[0] += 1
        acc[1] += time.perf_counter() - t0
        return out

    return wrapped


def _near_tie_pairs(torch, np, fwd, params, pairs, label):
    """Greedy chains of one prompt from two paths that round differently in
    bf16 must agree up to their first difference; there, the one-shot
    forward on the common chain must show a near-tie: a top-2 gap of at
    most 2 * LOGIT_TOL, with both chains' tokens within LOGIT_TOL of its top
    logit. The rest of a pair is not compared. ``pairs`` holds (prompt,
    chain a, chain b); prints how many parted and at what gaps, and raises
    on a difference the forward does not explain."""
    parted = []
    for prompt, a, b in pairs:
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            raise RuntimeError("%s: chains of %d and %d tokens agree on "
                               "their common part" % (label, len(a), len(b)))
        chain = np.asarray(list(prompt) + list(a[:i]), np.int32)[None]
        row = fwd(params, chain)[0, -1].float().cpu().numpy()
        top = np.sort(row)[::-1]
        gap = float(top[0] - top[1])
        ok = gap <= 2 * LOGIT_TOL and row[a[i]] >= top[0] - LOGIT_TOL and \
            row[b[i]] >= top[0] - LOGIT_TOL
        parted.append((i, gap))
        print("%s: a pair parted at new token %d: forward top-2 gap %.4f "
              "(bound %.2f), tokens %d / %d at %.4f / %.4f below the top: %s"
              % (label, i, gap, 2 * LOGIT_TOL, a[i], b[i], top[0] - row[a[i]],
                 top[0] - row[b[i]], "a near-tie" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("%s: chains part at new token %d where the "
                               "forward shows no near-tie (gap %.4f)"
                               % (label, i, gap))
    print("%s: %d of %d pairs equal, %d parted at near-ties (gaps %s)"
          % (label, len(pairs) - len(parted), len(pairs), len(parted),
             ", ".join("%.4f" % g for _, g in parted) or "none"))
    return parted


def _rows_vs_forward(np, fwd, params, chain, rows, label):
    """Largest |served - forward| over the rows ``{position: logits}`` of
    one request, the forward run once on its whole chain."""
    ref = fwd(params, np.asarray(chain, np.int32)[None])[0]
    ref = ref.float().cpu().numpy()
    got = np.stack([rows[p] for p in sorted(rows)])
    if not np.isfinite(got).all() or got.shape[1] != ref.shape[1]:
        raise RuntimeError("%s: served logits not finite / wrong shape"
                           % label)
    return float(np.abs(got - ref[sorted(rows)]).max())


def _kv_digest(torch, kv, pages):
    import hashlib

    return hashlib.sha256(kv[:, :, pages].contiguous().view(
        torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def _prefix_run(torch, np, fa, srv, prefix, work, watch, fwd, fwd_params):
    """PREFIX_TRACE through ``srv``, warmed as the bench warms it, with the
    served logits of the requests ``watch`` indexes held against ``fwd``
    on ``fwd_params``; returns the run's dict (checked by
    ``_check_prefix_runs``)."""
    from mxnet_tpu_torch import profiler

    t_ = PREFIX_TRACE
    on = srv.prefix is not None
    pred = srv.predictor
    # warm-up outside the clock, as the bench does: one request per
    # full-prefill bucket (distinct fillers, so none shares a prefix), then
    # clear the index, seed the prefix and warm the tail buckets
    need = {pred.pick_bucket(len(w[1])) for w in work}
    for i, b in enumerate(sorted(need)):
        srv.generate(np.full((min(b, pred.max_ctx - 3),), 2 + i, np.int32),
                     max_new_tokens=2)
    digest = pages = None
    if on:
        srv.clear_prefix()
        srv.generate(np.asarray(prefix + [1], np.int32), max_new_tokens=2)
        pages = srv.prefix.match(prefix + [1], pred.pool)
        pred.pool.unref(pages)
        if len(pages) != t_["prefix"] // t_["page"]:
            raise RuntimeError("prefix: the seeding request indexed %d "
                               "pages" % len(pages))
        digest = _kv_digest(torch, pred._kv, pages)
        for tb in sorted({pred.pick_bucket(len(w[1]) - len(prefix))
                          for w in work if w[2]}):
            n = min(tb, pred.max_ctx - len(prefix) - 3)
            srv.generate(np.asarray(prefix + [1] * n, np.int32),
                         max_new_tokens=2)
    # the served logits of the watched requests: the tail prefill's (or
    # the full prefill's) last row, every decode row
    watched = {np.asarray(work[i][1], np.int32).tobytes(): {} for i in watch}
    tails = {np.asarray(work[i][1][len(prefix):], np.int32).tobytes():
             work[i][1] for i in watch}
    prefill, extend_tail, decode = pred.prefill, pred.extend_tail, \
        pred.decode

    def rec_prefill(tokens, pages):
        logits = prefill(tokens, pages)
        key = np.asarray(tokens, np.int32).tobytes()
        if key in watched:
            watched[key][len(tokens) - 1] = logits.copy()
        return logits

    def rec_tail(tokens, start_pos, pages):
        logits = extend_tail(tokens, start_pos, pages)
        full = tails.get(np.asarray(tokens, np.int32).tobytes())
        if full is not None:
            key = np.asarray(full, np.int32).tobytes()
            watched[key][len(full) - 1] = logits.copy()
        return logits

    def rec_decode(tokens, positions, block_tables, active):
        logits = decode(tokens, positions, block_tables, active)
        for s in np.flatnonzero(active):
            key = srv._slot_req[s].tokens.tobytes()
            if key in watched:
                watched[key][int(positions[s])] = logits[s].copy()
        return logits

    pred.prefill, pred.extend_tail, pred.decode = \
        rec_prefill, rec_tail, rec_decode
    try:
        torch.cuda.synchronize()
        profiler.generate_reset()
        _reset_counts(fa)
        results, wall = _replay(np, srv, work, t_["new"])
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        stats = srv.stats()
    finally:
        pred.prefill, pred.extend_tail, pred.decode = \
            prefill, extend_tail, decode
    in_use, index_pages = pred.pool.in_use, (srv.prefix.pages if on else 0)
    after = _kv_digest(torch, pred._kv, pages) if on else None
    srv.clear_prefix()
    errs = [_rows_vs_forward(
        np, fwd, fwd_params, work[i][1] + results[i]["tokens"][:-1],
        watched[np.asarray(work[i][1], np.int32).tobytes()], "prefix")
        for i in watch]
    return dict(results=results, wall=wall, stats=stats, launches=launches,
                pool=pred.pool.stats(), in_use=in_use,
                index_pages=index_pages, errs=errs, digests=(digest, after))


def _print_prefix_run(label, run, shared):
    results, stats = run["results"], run["stats"]
    ttft = [r["ttft_s"] for r in results]
    ttft_sh = [results[i]["ttft_s"] for i in shared]
    print("%s: %d requests (%d shared) in %.3f s wall; TTFT p50 %.2f ms p99 "
          "%.2f ms (shared requests p50 %.2f ms p99 %.2f ms); busy_seconds "
          "%s; prefills %d, prefill_tokens %d, saved %d, prefix_hits %d, "
          "shared_pages %d, evictions %d, page_ref_high_water %s, "
          "prefix_pages %s; decode steps %d; B5 launches %d; served vs "
          "forward worst %.4f over %d requests (tol %g)"
          % (label, len(results), len(shared), run["wall"],
             _pctl(ttft, 0.5) * 1e3, _pctl(ttft, 0.99) * 1e3,
             _pctl(ttft_sh, 0.5) * 1e3, _pctl(ttft_sh, 0.99) * 1e3,
             stats.get("busy_seconds"), stats["prefills"],
             stats["prefill_tokens"], stats["prefill_tokens_saved"],
             stats["prefix_hits"], stats["shared_pages"],
             stats["prefix_evictions"], stats.get("page_ref_high_water"),
             stats.get("prefix_pages"), stats["decode_steps"],
             run["launches"], max(run["errs"]), len(run["errs"]), LOGIT_TOL))


def _check_prefix_run(run, n_layers, n_shared, on):
    """One run's checks: every request whole, served logits within
    LOGIT_TOL, no page leaked, 12 B5 launches a full prefill; with the
    cache on, every shared request a hit, the pages in use the index's
    and the shared prefix pages' bytes unchanged."""
    t_ = PREFIX_TRACE
    for i, r in enumerate(run["results"]):
        if len(r["tokens"]) != t_["new"] or r["finish_reason"] != "length":
            raise RuntimeError("prefix request %d: %d tokens, %r"
                               % (i, len(r["tokens"]), r["finish_reason"]))
    if max(run["errs"]) > LOGIT_TOL:
        raise RuntimeError("prefix: served logits differ from the forward "
                           "by %.4g" % max(run["errs"]))
    p = run["pool"]
    if p["in_use"] != 0 or p["allocs"] != p["frees"]:
        raise RuntimeError("prefix: KV pages leaked: %r" % p)
    st = run["stats"]
    full = st["prefills"] - st["prefix_hits"]
    if st["prefills"] != t_["requests"] or \
            run["launches"] != n_layers * full:
        raise RuntimeError("prefix: B5 launches %d != %d layers x %d full "
                           "prefills" % (run["launches"], n_layers, full))
    if st["prefix_hits"] != (n_shared if on else 0):
        raise RuntimeError("prefix: %d hits for %d shared requests"
                           % (st["prefix_hits"], n_shared))
    if on and run["in_use"] != run["index_pages"]:
        raise RuntimeError("prefix: %d pages in use with %d indexed"
                           % (run["in_use"], run["index_pages"]))
    before, after = run["digests"]
    if before != after:
        raise RuntimeError("prefix: a shared prefix page was written")


def prefix_serving_phase(torch, np, fa):
    """The shared-prefix trace with the prefix cache off, then on; returns
    the B5 launches of the cache-on run."""
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.serving import GenerateServer

    t_ = PREFIX_TRACE
    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0)
    prefix, work = _prefix_workload(cfg.vocab)
    shared = [i for i, w in enumerate(work) if w[2]]
    fwd = tfm.make_forward_fn(cfg)
    runs = {}
    for on in (False, True):
        srv = GenerateServer(cfg, params, slots=t_["slots"],
                             page_size=t_["page"], prefix_cache=on)
        try:
            runs[on] = _prefix_run(torch, np, fa, srv, prefix, work,
                                   shared[:2], fwd, srv.predictor._params)
        finally:
            srv.close()
        _print_prefix_run("prefix %s" % ("on" if on else "off"), runs[on],
                          shared)
        _check_prefix_run(runs[on], cfg.n_layers, len(shared), on)
    off, on = runs[False], runs[True]
    st_on, st_off = on["stats"], off["stats"]
    if st_on["prefill_tokens"] + st_on["prefill_tokens_saved"] != \
            st_off["prefill_tokens"]:
        raise RuntimeError("prefix: prefill tokens %d + saved %d != %d"
                           % (st_on["prefill_tokens"],
                              st_on["prefill_tokens_saved"],
                              st_off["prefill_tokens"]))
    before, after = on["digests"]
    print("prefix: the %d shared prefix pages digest %s after seeding, %s "
          "after the trace" % (t_["prefix"] // t_["page"], before, after))
    _near_tie_pairs(torch, np, fwd, _on_card(torch, params),
                    [(w[1], a["tokens"], b["tokens"]) for w, a, b in
                     zip(work, off["results"], on["results"])], "prefix")
    p99 = [_pctl([r["ttft_s"] for r in run["results"]], 0.99)
           for run in (off, on)]
    p50 = [_pctl([r["ttft_s"] for r in run["results"]], 0.5)
           for run in (off, on)]
    print("prefix: TTFT p50 off/on %.2f, p99 off/on %.2f; wall off %.3f s, "
          "on %.3f s; prefill_tokens off %d, on %d + saved %d"
          % (p50[0] / p50[1], p99[0] / p99[1], off["wall"], on["wall"],
             st_off["prefill_tokens"], st_on["prefill_tokens"],
             st_on["prefill_tokens_saved"]))
    return on["launches"]


def _on_card(torch, params):
    """The whole params on the card, fp32."""
    return {k: v.to(CARD, torch.float32) for k, v in params.items()}


def spec_serving_phase(torch, np, fa):
    """The decode-heavy trace with spec_k 0, then 6 with a 1-layer
    self-draft, and one request under generate:stall; returns the B5
    launches of the speculative run."""
    from mxnet_tpu_torch import chaos, profiler
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.serving import GenerateServer

    t_ = SPEC_TRACE
    cfg = tfm.TransformerConfig(**FULL)
    params = _damp_upper_layers(tfm.init_params(cfg, seed=0), t_["damp"])
    work = _spec_workload(cfg.vocab)
    runs = {}
    for k in (0, t_["k"]):
        kw = dict(spec_k=k, draft=t_["draft"]) if k else dict(spec_k=0)
        srv = GenerateServer(cfg, params, slots=t_["slots"],
                             page_size=t_["page"], **kw)
        try:
            pred, draft = srv.predictor, srv.draft_predictor
            for b in sorted({pred.pick_bucket(len(w[1])) for w in work}):
                srv.generate(np.ones((min(b, pred.max_ctx - k - 3),),
                                     np.int32), max_new_tokens=k + 2)
            # the target's logits rows of the first two requests: decode
            # rows (k = 0) or verify rows (k > 0), each with its input
            # token, in call order
            watched = {np.asarray(w[1], np.int32).tobytes(): []
                       for w in work[:2]}
            split = {"draft": [0, 0.0], "verify": [0, 0.0]}
            decode, extend = pred.decode, pred.extend
            timed_extend = _timed_calls(extend, split["verify"])

            def rec_decode(tokens, positions, block_tables, active):
                logits = decode(tokens, positions, block_tables, active)
                for s in np.flatnonzero(active):
                    key = srv._slot_req[s].tokens.tobytes()
                    if key in watched:
                        watched[key].append([(int(positions[s]),
                                              int(tokens[s]),
                                              logits[s].copy())])
                return logits

            def rec_extend(tokens, positions, block_tables, valid):
                logits = timed_extend(tokens, positions, block_tables, valid)
                for s in range(len(tokens)):
                    r = srv._slot_req[s]
                    if r is not None and r.tokens.tobytes() in watched:
                        watched[r.tokens.tobytes()].append(
                            [(int(positions[s, j]), int(tokens[s, j]),
                              logits[s, j].copy())
                             for j in np.flatnonzero(valid[s])])
                return logits

            if draft is not None:
                draft_decode = draft.decode
                draft.decode = _timed_calls(draft_decode, split["draft"])
            pred.decode, pred.extend = rec_decode, rec_extend
            torch.cuda.synchronize()
            profiler.generate_reset()
            _reset_counts(fa)
            results, wall = _replay(np, srv, work, t_["new"])
            torch.cuda.synchronize()
            launches = fa.flash_attention.launches
            stats = srv.stats()
            pred.decode, pred.extend = decode, extend
            pools = [pred.pool.stats()]
            shares = True
            if draft is not None:
                draft.decode = draft_decode
                pools.append(draft.pool.stats())
                shares = all(
                    v.untyped_storage().data_ptr()
                    == pred._params[name].untyped_storage().data_ptr()
                    for name, v in draft._params.items())
            fwd = tfm.make_forward_fn(cfg)
            errs, n_rows = [], 0
            for w, r in zip(work[:2], results[:2]):
                chain = list(w[1]) + r["tokens"]
                rows = {}
                for call in watched[np.asarray(w[1], np.int32).tobytes()]:
                    for p, tok, logits in call:
                        # a row is on the chain while its input tokens are
                        # the chain's; past the chain's end, or after a
                        # rejected proposal, the call's rows are not
                        if p >= len(chain) or chain[p] != tok:
                            break
                        rows[p] = logits
                n_rows += len(rows)
                errs.append(_rows_vs_forward(np, fwd, pred._params,
                                             chain, rows, "spec"))
            # one round under torch.profiler, split on the host's clock
            one = {"draft": [0, 0.0], "verify": [0, 0.0]}
            if draft is not None:
                draft.decode = _timed_calls(draft_decode, one["draft"])
                pred.extend = _timed_calls(extend, one["verify"])
                prof = {}
                # a prefill, then one round: its k proposals cover the
                # second token, whatever the draft gets right
                _device_profile(torch, lambda: srv.generate(
                    np.asarray(work[0][1], np.int32), max_new_tokens=2),
                    stats=prof)
                draft.decode, pred.extend = draft_decode, extend
                print("spec one round: %d draft steps %.2f ms, %d verify "
                      "%.2f ms on the host's clock; request wall %.2f ms, "
                      "device busy %.2f ms (prefill included)"
                      % (one["draft"][0], one["draft"][1] * 1e3,
                         one["verify"][0], one["verify"][1] * 1e3,
                         prof.get("wall_ms", float("nan")),
                         prof.get("busy_ms", float("nan"))))
                runs["stall"] = _stall_check(np, chaos, srv, work)
            runs[k] = dict(results=results, wall=wall, stats=stats,
                           launches=launches, pools=pools, shares=shares,
                           errs=errs, fwd=fwd, params=pred._params)
            n_tok = sum(len(r["tokens"]) for r in results)
            rounds = stats.get("spec_rounds") or stats["decode_steps"]
            print("spec k=%d: %d requests, %d tokens in %.3f s wall = %.1f "
                  "tokens/s; busy_seconds %s; decode steps %d, spec_rounds "
                  "%d, draft_proposed %d, accepted %d, acceptance_rate %s; "
                  "prefills %d; B5 launches %d; host per round: draft %.2f "
                  "steps %.3f ms, verify %.3f ms, busy %.3f ms (prefills "
                  "included); %d rows vs forward %s (tol %g)"
                  % (k, len(results), n_tok, wall, n_tok / wall,
                     stats.get("busy_seconds"), stats["decode_steps"],
                     stats["spec_rounds"], stats["draft_proposed"],
                     stats["draft_accepted"], stats.get("acceptance_rate"),
                     stats["prefills"], launches,
                     split["draft"][0] / rounds, split["draft"][1] / rounds
                     * 1e3, split["verify"][1] / rounds * 1e3,
                     stats["busy_seconds"] / rounds * 1e3, n_rows,
                     " ".join("%.4f" % e for e in errs), LOGIT_TOL))
        finally:
            srv.close()

    base, spec = runs[0], runs[t_["k"]]
    for k, run in ((0, base), (t_["k"], spec)):
        for i, r in enumerate(run["results"]):
            if len(r["tokens"]) != t_["new"] or \
                    r["finish_reason"] != "length":
                raise RuntimeError("spec k=%d request %d: %d tokens, %r"
                                   % (k, i, len(r["tokens"]),
                                      r["finish_reason"]))
        if max(run["errs"]) > LOGIT_TOL:
            raise RuntimeError("spec k=%d: served logits differ from the "
                               "forward by %.4g" % (k, max(run["errs"])))
        if any(p["in_use"] != 0 or p["allocs"] != p["frees"]
               for p in run["pools"]):
            raise RuntimeError("spec k=%d: KV pages leaked: %r"
                               % (k, run["pools"]))
        per_prefill = cfg.n_layers + (t_["draft"] if k else 0)
        if run["stats"]["prefills"] != t_["requests"] or \
                run["launches"] != per_prefill * run["stats"]["prefills"]:
            raise RuntimeError("spec k=%d: B5 launches %d != %d x %d "
                               "prefills" % (k, run["launches"], per_prefill,
                                             run["stats"]["prefills"]))
    st = spec["stats"]
    if not (st["spec_rounds"] > 0 and st["draft_proposed"] > 0):
        raise RuntimeError("spec: no speculative round ran: %r" % st)
    if not spec["shares"]:
        raise RuntimeError("spec: the draft's tensors are not the target's")
    _near_tie_pairs(torch, np, spec["fwd"], spec["params"],
                    [(w[1], a["tokens"], b["tokens"]) for w, a, b in
                     zip(work, base["results"], spec["results"])], "spec")
    rate = [sum(len(r["tokens"]) for r in run["results"]) / run["wall"]
            for run in (base, spec)]
    print("spec: tokens/s k=0 %.1f, k=%d %.1f, speedup %.3f at "
          "acceptance_rate %s; %s"
          % (rate[0], t_["k"], rate[1], rate[1] / rate[0],
             st.get("acceptance_rate"), runs["stall"]))
    return spec["launches"]


def _stall_check(np, chaos, srv, work):
    """One request under MXNET_FAULT_SPEC=generate:stall@req=1 with an EOS
    its chain hits, and four behind it (one waits for a slot): the stalled
    request finishes "length" at the cap past its EOS, the others are
    served, and every page comes back."""
    prompt = np.asarray(work[0][1], np.int32)
    cap = 8
    chain = srv.generate(prompt, max_new_tokens=cap)["tokens"]
    eos = chain[1]
    os.environ["MXNET_FAULT_SPEC"] = "generate:stall@req=1"
    chaos.reset_engine()
    try:
        futs = [srv.submit(prompt, max_new_tokens=cap, eos_id=eos)
                for _ in range(srv.predictor.slots + 1)]
        res = [f.result(timeout=300) for f in futs]
    finally:
        del os.environ["MXNET_FAULT_SPEC"]
        chaos.reset_engine()
    stalled = res[0]
    pools = [srv.predictor.pool.in_use, srv.draft_predictor.pool.in_use]
    if stalled["finish_reason"] != "length" or \
            len(stalled["tokens"]) != cap or \
            eos not in stalled["tokens"][:-1] or any(pools):
        raise RuntimeError("stall: %r, pages in use %s" % (stalled, pools))
    reasons = [r["finish_reason"] for r in res[1:]]
    return ("generate:stall@req=1: the stalled request passed its EOS and "
            "finished %r with %d tokens; %d behind it finished %s; pages in "
            "use %s" % (stalled["finish_reason"], len(stalled["tokens"]),
                        len(reasons), "/".join(reasons), pools))



def _resnet_conv_calls(n):
    """The B1 calls of a fused ResNet-50 forward at batch ``n``:
    ``{(n, h, ci, co, k, stride): count}``, from the unit widths."""
    calls = {}
    h, ci = 56, 64
    for stage, units in enumerate((3, 4, 6, 3)):
        nf = 256 << stage
        c = nf // 4
        for u in range(units):
            s = 2 if stage and u == 0 else 1
            for shape in ((n, h, ci, c, 1, 1), (n, h, c, c, 3, s),
                          (n, h // s, c, nf, 1, 1)) + \
                    (((n, h, ci, nf, 1, s),) if u == 0 else ()):
                calls[shape] = calls.get(shape, 0) + 1
            h, ci = h // s, nf
    return calls


def _conv_bound(n, h, ci, co, k, stride, dtype, stats):
    """Least time (ms) for one B1 call: its operations over the peak rate
    of its type, or x, w, y, the prologue vectors (and the stats) each
    moved once over the memory rate, whichever is larger."""
    ho = h // stride
    flops = 2.0 * n * ho * ho * k * k * ci * co
    isz = 2 if dtype == "bfloat16" else 4
    nbytes = isz * (n * h * h * ci + k * k * ci * co + n * ho * ho * co) \
        + 4 * 2 * ci + (4 * 2 * co if stats else 0)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def conv_kernel_phase(torch, fb):
    """B1 against its plain version on the card at every shape of a
    ResNet-50 forward, at every batch of the serving ladder and at a
    data-parallel rank's rows; times at batch 64. Returns the JSON entry fields measured here, at the stage-1
    3x3 shape (launches are filled in by the serving phase)."""
    import torch.nn.functional as F

    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("conv: TF32 must be off for an fp32 reference")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(n, h, ci, co, k, dt):
        x = torch.randn(n, h, h, ci, device="cuda", generator=gen).to(dt)
        w = (torch.randn(k, k, ci, co, device="cuda", generator=gen)
             / (k * k * ci) ** 0.5).to(dt)
        scale = torch.rand(ci, device="cuda", generator=gen) + 0.5
        bias = torch.randn(ci, device="cuda", generator=gen) * 0.5
        return x, w, (scale, bias, True)

    # every call the served path makes: each shape of the forward at each
    # bucket of the ladder, in both types, with and without the stats
    shapes = sorted((h, ci, co, k, s)
                    for (_n, h, ci, co, k, s) in _resnet_conv_calls(1))
    main_err = None
    for n in RESNET_LADDER + (DP_RANK_ROWS,):
        for dt in ("float32", "bfloat16"):
            worst = {"row": (0.0, None), "stats": (0.0, None)}
            for (h, ci, co, k, s) in shapes:
                x, w, pro = inputs(n, h, ci, co, k, getattr(torch, dt))
                for stats in (False, True):
                    y, st = fb.conv_fwd(x, w, stride=s, prologue=pro,
                                        emit_stats=stats)
                    ref, ref_st = fb.conv_fwd_reference(
                        x, w, stride=s, prologue=pro, emit_stats=stats)
                    torch.cuda.synchronize()
                    e_row = _row_err(torch, y, ref)
                    e_st = 0.0
                    if stats:
                        yf = ref.float()
                        scale = torch.stack([yf.abs().sum((0, 1, 2)),
                                             (yf * yf).sum((0, 1, 2))])
                        e_st = ((st - ref_st).abs() / scale.clamp_min(1e-6)
                                ).max().item()
                    ok = e_row <= CONV_TOL[dt] and e_st <= CONV_TOL[dt] and \
                        bool(torch.isfinite(y).all())
                    where = "(%d,%d,%d,%d)->%d k=%d s=%d stats=%d" % (
                        n, h, h, ci, co, k, s, stats)
                    if e_row > worst["row"][0]:
                        worst["row"] = (e_row, where)
                    if e_st > worst["stats"][0]:
                        worst["stats"] = (e_st, where)
                    if not ok:
                        print("conv %-8s %s  row-relative %.3g  "
                              "stats-relative %.3g (tol %g)  FAIL"
                              % (dt, where, e_row, e_st, CONV_TOL[dt]))
                        raise RuntimeError("fused_conv_fwd disagrees with "
                                           "its plain version")
                    if (n, h, ci, co, k, s, dt, stats) == \
                            (CONV_TIME_BATCH,) + CONV_MAIN + ("bfloat16",
                                                              False):
                        main_err = (y.float() - ref.float()).abs().max() \
                            .item()
            print("conv batch %-2d %-8s: %d shapes x {stats, none} held; "
                  "worst row-relative %.3g at %s; worst stats-relative %.3g "
                  "at %s (tol %g)"
                  % (n, dt, len(shapes), worst["row"][0], worst["row"][1],
                     worst["stats"][0], worst["stats"][1], CONV_TOL[dt]))

    # times at batch 64, bf16, as the serving path runs them (no stats)
    rows, main = [], None
    total = {"ms": [0.0, 0.0], "plain_ms": [0.0, 0.0],
             "library_ms": [0.0, 0.0], "bound_ms": 0.0}
    for (n, h, ci, co, k, s), count in sorted(
            _resnet_conv_calls(CONV_TIME_BATCH).items()):
        x, w, pro = inputs(n, h, ci, co, k, torch.bfloat16)
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        scale, bias, _ = pro

        def library():
            a = torch.relu(x.float() * scale + bias).to(x.dtype)
            return F.conv2d(a.permute(0, 3, 1, 2), w_lib, stride=s,
                            padding=k // 2)

        ms = _time_ms(torch, lambda: fb.conv_fwd(x, w, stride=s,
                                                 prologue=pro))
        plain_ms = _time_ms(torch, lambda: fb.conv_fwd_reference(
            x, w, stride=s, prologue=pro), reps=10)
        lib_ms = _time_ms(torch, library)
        bound_ms, bound_by = _conv_bound(n, h, ci, co, k, s, "bfloat16",
                                         False)
        flops = 2.0 * n * (h // s) ** 2 * k * k * ci * co
        print("time fused_conv_fwd bf16 (%d,%d,%d,%d)->%d k=%d s=%d x%d per "
              "forward (event / device): kernel %s ms (%.1f TFLOP/s "
              "device), plain %s ms, library %s ms, bound %.5f ms (%s)"
              % (n, h, h, ci, co, k, s, count, _both(ms), flops / ms[1] / 1e9,
                 _both(plain_ms), _both(lib_ms), bound_ms, bound_by))
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms)):
            for i in (0, 1):
                total[key][i] += count * v[i]
        total["bound_ms"] += count * bound_ms
        if (h, ci, co, k, s) == CONV_MAIN:
            main = dict({"bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": main_err,
                         "shape": [n, h, h, ci, co, k, s]},
                        **_timed(ms, plain_ms, lib_ms))
        rows.append(count)
    print("time fused_conv_fwd bf16, all %d B1 calls of a batch-64 forward "
          "(event / device): kernel %s ms, plain %s ms, library %s ms, bound "
          "%.4f ms" % (sum(rows), _both(tuple(total["ms"])),
                       _both(tuple(total["plain_ms"])),
                       _both(tuple(total["library_ms"])), total["bound_ms"]))
    if sum(rows) != B1_PER_FORWARD:
        raise RuntimeError("conv: %d B1 calls per forward, want %d"
                           % (sum(rows), B1_PER_FORWARD))
    return dict({"name": "fused_conv_fwd", "route": "cuda",
                 "source": "mxnet_tpu_torch/kernels/csrc/fused_conv_fwd.cu",
                 "replaces": "mxnet_tpu/kernels/fused_block.py:484",
                 "design": "wgmma+TMA, 4-D box maps of x, the BN-apply "
                           "prologue in registers (bf16); CUDA cores (fp32, "
                           "and bf16 rows TMA cannot load)",
                 "library": "BN-apply + ReLU, then cuDNN conv2d (NHWC)",
                 "forward_total_ms": total}, **main)


def _resnet_images(np, seed, n):
    return np.random.RandomState(seed).randn(
        n, *RESNET["image_shape"]).astype(np.float32)


def _resnet_requests(np):
    """The ResNet-50 serving trace: RESNET_REQUESTS requests of 1 to
    RESNET_MAX_IMAGES seeded images each. Returns ``(sizes, images)``."""
    rng = np.random.RandomState(0)
    sizes = [int(v) for v in rng.randint(1, RESNET_MAX_IMAGES + 1,
                                         RESNET_REQUESTS)]
    return sizes, [_resnet_images(np, 100 + i, n)
                   for i, n in enumerate(sizes)]


def _resnet_trace(srv, name, images):
    """Submit ``images`` to model ``name`` from RESNET_THREADS client
    threads, thread k taking every RESNET_THREADS-th request from k.
    Returns ``(first outputs in request order, wall seconds)``."""
    import threading

    futures = [None] * len(images)

    def client(k):
        for i in range(k, len(images), RESNET_THREADS):
            futures[i] = srv.submit(name, images[i])

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(RESNET_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outs = [f.result(timeout=600)[0] for f in futures]
    return outs, time.perf_counter() - t0


def resnet_serving_phase(torch, np, fb):
    """Fused ResNet-50 behind ModelServer on the card; returns the B1
    launch count of the served traffic."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.serving import AOTPredictor, ModelServer

    gc.collect()
    fused = resnet.get_symbol(fused=True, **RESNET)
    unfused = resnet.get_symbol(fused=False, **RESNET)
    ops = [nd.op.name for nd in fused._topo() if not nd.is_variable()]
    if ops.count("FusedBottleneckUnit") != RESNET_UNITS or \
            ops.count("transpose") != 2:
        raise RuntimeError("fusion pass gave %d fused units and %d transposes"
                           % (ops.count("FusedBottleneckUnit"),
                              ops.count("transpose")))
    one = (1,) + RESNET["image_shape"]
    args, auxs = resnet.init_params(fused, one, seed=0)
    print("resnet: fused graph of %d ops (%d FusedBottleneckUnit, 2 "
          "transpose), %.2f M parameters" % (
              len(ops), RESNET_UNITS,
              sum(v.size for v in args.values()) / 1e6))

    # fused bf16 against the unfused graph in fp32 (cuDNN, TF32 off)
    x = _resnet_images(np, 1, RESNET_CHECK_IMAGES)
    kw = dict(data_shapes={"data": one}, ladder=(RESNET_CHECK_IMAGES,),
              output_names=["fc1_output"])
    ref = AOTPredictor(unfused, args, auxs, dtype="float32",
                       **kw).predict(x)[0]
    pred = AOTPredictor(fused, args, auxs, dtype="bfloat16", **kw)
    pred.predict(x)                                   # warm-up
    _reset_fb_counts(fb)
    got = pred.predict(x)[0]
    per_forward = fb.conv_fwd.launches
    core_routes = fb.conv_fwd.core_route_launches
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    top1 = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
    print("resnet check: %d images, fused bf16 vs unfused fp32 logits: max "
          "|diff| %.4g, largest |logit| %.4g, relative %.4g (tol %g); top-1 "
          "agreement %.3f (want >= %g); logit std %.4g; B1 launches per "
          "forward %d" % (RESNET_CHECK_IMAGES, err, scale, err / scale,
                          RESNET_LOGIT_TOL, top1, RESNET_TOP1,
                          float(ref.std()), per_forward))
    if not np.isfinite(got).all() or got.shape != (RESNET_CHECK_IMAGES,
                                                   RESNET["num_classes"]):
        raise RuntimeError("resnet: logits not finite / wrong shape")
    if err > RESNET_LOGIT_TOL * scale or top1 < RESNET_TOP1:
        raise RuntimeError("resnet: fused bf16 logits differ from the "
                           "unfused fp32 graph")
    if per_forward != B1_PER_FORWARD or core_routes:
        raise RuntimeError("resnet: %d B1 launches per forward, want %d, "
                           "%d of them on the CUDA cores, want 0"
                           % (per_forward, B1_PER_FORWARD, core_routes))
    del pred

    sizes, images = _resnet_requests(np)
    srv = ModelServer(ladder=RESNET_LADDER, dtype="bfloat16")
    try:
        model = srv.add_model("resnet50", symbol=fused, arg_params=args,
                              aux_params=auxs, data_shapes={"data": one})
        # warm-up, one forward per bucket (lazy CUDA module loading, cuDNN
        # heuristics); then the forward time per bucket, host clock, each
        # ending in the copy of the outputs to the host
        bucket_ms = {}
        for b in RESNET_LADDER:
            batch = {"data": _resnet_images(np, 7, b)}
            model.run_bucket(batch, b)
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                model.run_bucket(batch, b)
                secs.append(time.perf_counter() - t0)
            bucket_ms[b] = sorted(secs)[2] * 1e3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiler.serving_reset()
        _reset_fb_counts(fb)
        results, wall = _resnet_trace(srv, "resnet50", images)
        launches = fb.conv_fwd.launches
        core_routes = fb.conv_fwd.core_route_launches
        stats = srv.stats()["resnet50"]
        peak = torch.cuda.max_memory_allocated()
        # where the device time goes: 8 requests again under torch.profiler
        _device_profile(torch, lambda: [
            f.result(timeout=600)[0] for f in
            [srv.submit("resnet50", img) for img in images[:8]]])
        alone = [model.predict(images[i])[0] for i in (0, 1)]
    finally:
        srv.close()

    for i, (n, r) in enumerate(zip(sizes, results)):
        if r.shape != (n, RESNET["num_classes"]) or not np.isfinite(r).all() \
                or np.abs(r.sum(-1) - 1).max() > 1e-2:
            raise RuntimeError("resnet request %d: bad output %s"
                               % (i, r.shape))
    for i in (0, 1):
        gap = float(np.abs(alone[i] - results[i]).max())
        print("resnet request %d (%d images): served in a batch vs alone, max "
              "|diff| of probabilities %.3g" % (i, sizes[i], gap))
        if gap > 1e-2:
            raise RuntimeError("resnet: batched answer differs from alone")
    n_img = sum(sizes)
    print("resnet serve: %d requests of 1..%d images (%d images) from %d "
          "threads in %.3f s wall = %.1f images/s; latency p50 %.1f ms p99 "
          "%.1f ms; %d batches, mean %.2f images, fill %.3f; forward per "
          "bucket (host clock) %s; peak memory %.2f GiB; B1 launches %d "
          "(%d per forward x %d batches), %d of them on the CUDA cores"
          % (len(sizes), RESNET_MAX_IMAGES, n_img, RESNET_THREADS, wall,
             n_img / wall, stats["p50_ms"], stats["p99_ms"],
             stats["batches"], stats["avg_batch_rows"], stats["batch_fill"],
             ", ".join("%d: %.2f ms" % kv for kv in sorted(bucket_ms.items())),
             peak / 2 ** 30, launches, B1_PER_FORWARD, stats["batches"],
             core_routes))
    if launches != B1_PER_FORWARD * stats["batches"] or launches == 0 \
            or core_routes:
        raise RuntimeError("resnet: B1 launches %d != %d x %d batches, or "
                           "%d on the CUDA cores" % (
                               launches, B1_PER_FORWARD, stats["batches"],
                               core_routes))
    if stats["requests"] != len(sizes) or stats["errors"]:
        raise RuntimeError("resnet: serving stats %r" % stats)
    return launches


def _resnet_grad_calls(n):
    """The B2 and B3 calls of a fused ResNet-50 train step at batch ``n``,
    as ``_unit_bwd`` makes them: ``{(kind, n, h, ci, co, k, stride, bnbwd,
    extra): count}``, h the conv input's height, ``bnbwd`` whether the g
    side is rebuilt from (e, y_raw), ``extra`` the shortcut's (co2, s2)
    term of conv1's B3."""
    calls = {}

    def add(*key):
        calls[key] = calls.get(key, 0) + 1

    h, ci = 56, 64
    for stage, units in enumerate((3, 4, 6, 3)):
        nf = 256 << stage
        c = nf // 4
        for u in range(units):
            s = 2 if stage and u == 0 else 1
            ho = h // s
            add("dgrad", n, ho, c, nf, 1, 1, False, None)       # conv3: e2
            add("wgrad", n, ho, c, nf, 1, 1, False, None)       # dw3
            add("wgrad", n, h, c, c, 3, s, True, None)          # dw2
            add("dgrad", n, h, c, c, 3, s, True, None)          # conv2: e1
            add("wgrad", n, h, ci, c, 1, 1, True, None)         # dw1
            add("dgrad", n, h, ci, c, 1, 1, True,               # conv1: e0
                (nf, s) if u == 0 else None)
            if u == 0:
                add("wgrad", n, h, ci, nf, 1, s, False, None)   # dwsc
            h, ci = ho, nf
    return calls


def _grad_inputs(torch, gen, key, dt):
    """Seeded operands of one B2/B3 call on the card: x (the conv input),
    w, the x-side prologue, the g side (whole, or (e, y_raw) and the five
    BN-backward constants), the input BN's mask and the extra term."""
    _kind, n, h, ci, co, k, s, bnbwd, extra = key
    ho = h // s

    def rnd(*shape):
        return torch.randn(*shape, device=CARD, generator=gen)

    def pos(*shape):
        return torch.rand(*shape, device=CARD, generator=gen) + 0.5

    x = rnd(n, h, h, ci).to(dt)
    w = (rnd(k, k, ci, co) / (k * k * ci) ** 0.5).to(dt)
    pro = (pos(ci), rnd(ci) * 0.5, True)
    g_parts, consts = rnd(n, ho, ho, co).to(dt), None
    if bnbwd:
        g_parts = (g_parts, rnd(n, ho, ho, co).to(dt))
        consts = (pos(co), rnd(co) * 0.2, pos(co), rnd(co) * 0.01,
                  rnd(co) * 0.01)
    mask = (x, pos(ci), rnd(ci) * 0.5, rnd(ci) * 0.3, pos(ci))
    ex = None
    if extra is not None:
        co2, s2 = extra
        ex = (rnd(n, h // s2, h // s2, co2).to(dt),
              (rnd(1, 1, ci, co2) / ci ** 0.5).to(dt), s2)
    return x, w, pro, g_parts, consts, mask, ex


def _wgrad_err(torch, fb, dw, ref, x, g_parts, w_shape, stride, pro, consts):
    """Largest |dw - ref| of each (tap, Co) column over the column's largest
    sum of |terms| (the same product on absolute values)."""
    h = fb._apply_prologue(x, pro).float().abs()
    g = fb._g_value(g_parts, consts).to(x.dtype).float().abs()
    k = int(w_shape[0])
    terms = torch.nn.grad.conv2d_weight(
        h.permute(0, 3, 1, 2), (int(w_shape[3]), int(w_shape[2]), k, k),
        g.permute(0, 3, 1, 2), stride=stride, padding=k // 2)
    col = terms.permute(2, 3, 1, 0).amax(dim=2).clamp_min(1e-30)
    return ((dw - ref).abs().amax(dim=2) / col).max().item()


def _grad_bound(key, dtype):
    """Least time (ms) for one B2 or B3 call: its operations over the peak
    rate of its type, or every operand read once and every output written
    once over the memory rate, whichever is larger."""
    kind, n, h, ci, co, k, s, bnbwd, extra = key
    ho = h // s
    isz = 2 if dtype == "bfloat16" else 4
    flops = 2.0 * n * ho * ho * k * k * ci * co
    g_side = (2 if bnbwd else 1) * n * ho * ho * co * isz + \
        (5 * 4 * co if bnbwd else 0)
    if kind == "wgrad":
        nbytes = isz * n * h * h * ci + g_side + 4 * k * k * ci * co \
            + 4 * 2 * ci
    else:
        # w, y_in and e_out, the mask's 4 vectors and the stats
        nbytes = g_side + isz * (k * k * ci * co + 2 * n * h * h * ci) \
            + 4 * 4 * ci + 4 * 2 * ci
        if extra is not None:
            co2, s2 = extra
            flops += 2.0 * n * (h // s2) ** 2 * ci * co2
            nbytes += isz * (n * (h // s2) ** 2 * co2 + ci * co2)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def _grad_library(torch, fb, key, ops):
    """One call's library route, a timing yardstick only: the elementwise
    parts in PyTorch around cuDNN's weight-only (B2) or input-only (B3)
    convolution backward."""
    kind, _n, _h, _ci, _co, k, s, _bnbwd, _extra = key
    x, w, pro, g_parts, consts, mask, ex = ops
    cb = torch.ops.aten.convolution_backward
    w_lib = w.permute(3, 2, 0, 1)

    def g_side():
        if consts is None:
            return g_parts
        return fb._bnbwd_value(g_parts[0], g_parts[1], consts).to(x.dtype)

    if kind == "wgrad":
        def library():
            a = torch.relu(x.float() * pro[0] + pro[1]).to(x.dtype)
            return cb(g_side().permute(0, 3, 1, 2), a.permute(0, 3, 1, 2),
                      w_lib, None, [s, s], [k // 2] * 2, [1, 1], False,
                      [0, 0], 1, [False, True, False])[1]
        return library

    def library():
        dx = cb(g_side().permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_lib,
                None, [s, s], [k // 2] * 2, [1, 1], False, [0, 0], 1,
                [True, False, False])[0]
        if ex is not None:
            dx = dx + cb(ex[0].permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                         ex[1].permute(3, 2, 0, 1), None, [ex[2]] * 2, [0, 0],
                         [1, 1], False, [0, 0], 1, [True, False, False])[0]
        t = dx.permute(0, 2, 3, 1).float()
        _y, gamma, beta, mu, inv = mask
        xhat = (x.float() - mu) * inv
        e = torch.where(gamma * xhat + beta > 0, t, 0.0)
        return e.to(x.dtype), torch.stack([e.sum((0, 1, 2)),
                                           (e * xhat).sum((0, 1, 2))])
    return library


def _grad_call(fb, key, ops, plain=False):
    kind, _n, _h, _ci, _co, _k, s, _bnbwd, _extra = key
    x, w, pro, g_parts, consts, mask, ex = ops
    if kind == "wgrad":
        fn = fb.conv_wgrad_reference if plain else fb.conv_wgrad
        return fn(x, g_parts, w.shape, stride=s, x_prologue=pro,
                  g_bnbwd=consts)
    fn = fb.conv_dgrad_reference if plain else fb.conv_dgrad
    return fn(g_parts, w, x.shape, stride=s, g_bnbwd=consts, out_mask=mask,
              extra=ex)


def conv_grad_kernel_phase(torch, fb):
    """B2 and B3 against their plain versions at every call of a ResNet-50
    train step (the options each call uses), at batch 64, 32 (a
    data-parallel rank's rows) and 2, in bf16 and fp32; times at batch 64 in bf16. Returns their JSON entry fields,
    measured at the stage-1 3x3 (launches are filled in by the training
    phase)."""
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("conv grad: TF32 must be off for an fp32 "
                           "reference")
    gen = torch.Generator(device=CARD).manual_seed(3)
    main_err = {}
    for n in GRAD_CHECK_BATCHES:
        calls = sorted(_resnet_grad_calls(n), key=str)
        for dt in ("float32", "bfloat16"):
            worst = {"wgrad": (0.0, None), "dgrad": (0.0, None),
                     "stats": (0.0, None)}
            routes = _core_routes(fb)
            for key in calls:
                kind, _n, h, ci, co, k, s, bnbwd, extra = key
                ops = _grad_inputs(torch, gen, key, getattr(torch, dt))
                got = _grad_call(fb, key, ops)
                ref = _grad_call(fb, key, ops, plain=True)
                torch.cuda.synchronize()
                where = "%s (%d,%d,%d,%d)->%d k=%d s=%d bnbwd=%d extra=%s" % (
                    kind, n, h, h, ci, co, k, s, bnbwd, extra)
                if kind == "wgrad":
                    x, w, pro, g_parts, consts = ops[:5]
                    err = _wgrad_err(torch, fb, got, ref, x, g_parts,
                                     w.shape, s, pro, consts)
                    ok = err <= WGRAD_TOL and bool(torch.isfinite(got).all())
                    errs = {"wgrad": err}
                    abs_err = (got - ref).abs().max().item()
                else:
                    (e, st), (e_ref, st_ref) = got, ref
                    x, mask = ops[0], ops[5]
                    xhat = (x.float() - mask[3]) * mask[4]
                    ef = e_ref.float()
                    scale = torch.stack([ef.abs().sum((0, 1, 2)),
                                         (ef * xhat).abs().sum((0, 1, 2))])
                    errs = {"dgrad": _row_err(torch, e, e_ref),
                            "stats": ((st - st_ref).abs()
                                      / scale.clamp_min(1e-6)).max().item()}
                    ok = max(errs.values()) <= CONV_TOL[dt] and \
                        bool(torch.isfinite(e).all())
                    abs_err = (e.float() - ef).abs().max().item()
                for name, v in errs.items():
                    if v > worst[name][0]:
                        worst[name] = (v, where)
                if not ok:
                    print("conv grad %-8s %s  %s  FAIL" % (dt, where, errs))
                    raise RuntimeError("fused_conv_%s disagrees with its "
                                       "plain version" % kind)
                if dt == "bfloat16" and (n, h, ci, co, k, s) == GRAD_MAIN:
                    main_err[kind] = abs_err
                del ops, got, ref
            if _core_routes(fb) != routes:
                raise RuntimeError("conv grad: a ResNet-50 call took the "
                                   "CUDA-core route: %s -> %s"
                                   % (routes, _core_routes(fb)))
            print("conv grad batch %-2d %-8s: %d B2/B3 calls held; worst B2 "
                  "column-relative %.3g at %s (tol %g); worst B3 "
                  "pixel-relative %.3g at %s, stats-relative %.3g at %s "
                  "(tol %g)" % (n, dt, len(calls), worst["wgrad"][0],
                                worst["wgrad"][1], WGRAD_TOL,
                                worst["dgrad"][0], worst["dgrad"][1],
                                worst["stats"][0], worst["stats"][1],
                                CONV_TOL[dt]))

    # times at batch 64, bf16, every call of a step
    entries = {}
    total = {kind: {"ms": [0.0, 0.0], "plain_ms": [0.0, 0.0],
                    "library_ms": [0.0, 0.0], "bound_ms": 0.0, "calls": 0}
             for kind in ("wgrad", "dgrad")}
    for key, count in sorted(_resnet_grad_calls(RESNET_TRAIN_BATCH).items(),
                             key=str):
        kind, n, h, ci, co, k, s, bnbwd, extra = key
        ops = _grad_inputs(torch, gen, key, torch.bfloat16)
        ms = _time_ms(torch, lambda: _grad_call(fb, key, ops))
        plain_ms = _time_ms(torch, lambda: _grad_call(fb, key, ops,
                                                      plain=True), reps=10)
        lib_ms = _time_ms(torch, _grad_library(torch, fb, key, ops))
        bound_ms, bound_by = _grad_bound(key, "bfloat16")
        flops = 2.0 * n * (h // s) ** 2 * k * k * ci * co
        print("time fused_conv_%s bf16 (%d,%d,%d,%d)->%d k=%d s=%d bnbwd=%d "
              "extra=%s x%d per step (event / device): kernel %s ms (%.1f "
              "TFLOP/s device), plain %s ms, library %s ms, bound %.5f ms "
              "(%s)" % (kind, n, h, h, ci, co, k, s, bnbwd, extra, count,
                        _both(ms), flops / ms[1] / 1e9, _both(plain_ms),
                        _both(lib_ms), bound_ms, bound_by))
        t = total[kind]
        for name, v in (("ms", ms), ("plain_ms", plain_ms),
                        ("library_ms", lib_ms)):
            for i in (0, 1):
                t[name][i] += count * v[i]
        t["bound_ms"] += count * bound_ms
        t["calls"] += count
        if (n, h, ci, co, k, s) == GRAD_MAIN:
            entries[kind] = dict({"bound_ms": bound_ms, "bound_by": bound_by,
                                  "max_abs_err": main_err[kind],
                                  "shape": list(GRAD_MAIN),
                                  "g_side": "(e, y_raw) rebuilt by bn3's "
                                            "backward"},
                                 **_timed(ms, plain_ms, lib_ms))
        del ops
    for kind, want in (("wgrad", B2_PER_STEP), ("dgrad", B3_PER_STEP)):
        t = total[kind]
        print("time fused_conv_%s bf16, all %d calls of a batch-64 step "
              "(event / device): kernel %s ms, plain %s ms, library %s ms, "
              "bound %.4f ms" % (kind, t["calls"], _both(tuple(t["ms"])),
                                 _both(tuple(t["plain_ms"])),
                                 _both(tuple(t["library_ms"])),
                                 t["bound_ms"]))
        if t["calls"] != want:
            raise RuntimeError("conv grad: %d %s calls a step, want %d"
                               % (t["calls"], kind, want))
    out = []
    for kind, line, lib in (
            ("wgrad", 607, "BN-apply + ReLU (and the g-side rebuild), then "
             "cuDNN's weight-only convolution backward"),
            ("dgrad", 737, "the g-side rebuild, cuDNN's input-only "
             "convolution backward, then the mask and the stats")):
        out.append(dict({
            "name": "fused_conv_%s" % kind, "route": "cuda",
            "source": "mxnet_tpu_torch/kernels/csrc/fused_conv_%s.cu" % kind,
            "replaces": "mxnet_tpu/kernels/fused_block.py:%d" % line,
            "design": "bf16: wgmma+TMA on 4-D box maps, both operands "
                      "from shared memory, the x-side BN prologue (B2) and "
                      "the g-side rebuild applied there in place; fp32: "
                      "CUDA cores", "library": lib,
            "step_total_ms": total[kind]}, **entries[kind]))
    return out


def _resnet_batch(np, seed, n):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(n, *RESNET["image_shape"]).astype(np.float32),
            "softmax_label": rng.randint(0, RESNET["num_classes"], (n,))
            .astype(np.float32)}


def _fb_counts(fb):
    return (fb.conv_fwd.launches, fb.conv_wgrad.launches,
            fb.conv_dgrad.launches)


def _core_routes(fb):
    """B1, B2 and B3 launches on the CUDA-core route (bf16 shapes TMA
    cannot load)."""
    return (fb.conv_fwd.core_route_launches,
            fb.conv_wgrad.core_route_launches,
            fb.conv_dgrad.core_route_launches)


def _reset_fb_counts(fb):
    fb.conv_fwd.launches = fb.conv_wgrad.launches = \
        fb.conv_dgrad.launches = 0
    fb.conv_fwd.core_route_launches = fb.conv_wgrad.core_route_launches = \
        fb.conv_dgrad.core_route_launches = 0


def resnet_train_grad_phase(torch, np, fb):
    """One step's gradients of a tiny fp32 fused ResNet on the card against
    the CPU; then full-width fused bf16 gradients against the unfused fp32
    graph's on the card, from the same params and batch."""
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("resnet grad: TF32 must be off for an fp32 "
                           "reference")
    sym = resnet.resnet(fused=True, **TINY_RESNET)
    shape = (TINY_BATCH, 3) + TINY_RESNET["image_shape"][1:]
    rng = np.random.RandomState(4)
    batch = {"data": rng.randn(*shape).astype(np.float32),
             "softmax_label": rng.randint(0, TINY_RESNET["num_classes"],
                                          (TINY_BATCH,)).astype(np.float32)}
    got = {}
    for dev in (CARD, "cpu"):
        ts = TrainStep(sym, RESNET_OPT, device=dev)
        p, _o, a = ts.init_params({"data": shape,
                                   "softmax_label": (TINY_BATCH,)},
                                  initializer=Xavier(), seed=0)
        _reset_fb_counts(fb)
        loss, grads, _aux = ts.value_and_grad(p, a, batch)
        got[dev] = (loss.item(), {k: g.cpu() for k, g in grads.items()},
                    _fb_counts(fb))
    # each tensor against its own largest |gradient|, clamped from below at
    # 1% of the largest of any tensor: bn0's gamma has an exact gradient of
    # 0 here (BN -> ReLU -> BN is invariant to scaling gamma and beta
    # together, and beta is 0), so both sides give rounding noise of
    # ~1e-6 of the others, which has no scale of its own
    floor = 1e-2 * max(g.abs().max().item() for g in got["cpu"][1].values())
    errs = sorted((((got[CARD][1][k] - g_cpu).abs().max()
                    / g_cpu.abs().max().clamp_min(floor)).item(), k)
                  for k, g_cpu in got["cpu"][1].items())
    worst = errs[-1]
    print("resnet grad tiny: loss card %.7f cpu %.7f; worst gradients %s "
          "(tol %g), %d tensors, fp32, batch %d; card launches B1 %d, B2 "
          "%d, B3 %d" % (got[CARD][0], got["cpu"][0],
                         ", ".join("%.3g at %s" % e for e in errs[-3:]),
                         GRAD_TOL, len(got["cpu"][1]), TINY_BATCH,
                         *got[CARD][2]))
    if worst[0] > GRAD_TOL or abs(got[CARD][0] - got["cpu"][0]) > \
            GRAD_TOL * abs(got["cpu"][0]) or got[CARD][2] != (11, 11, 9):
        raise RuntimeError("resnet grad: card gradients differ from the "
                           "CPU's, or the tiny net missed its kernels")

    # full width: fused bf16 against unfused fp32, same params and batch,
    # with the unfused graph in bf16 as the yardstick of bf16 noise
    n = FUSED_CHECK_BATCH
    shapes = {"data": (n,) + RESNET["image_shape"], "softmax_label": (n,)}
    steps = {name: TrainStep(resnet.get_symbol(fused=fused, **RESNET),
                             RESNET_OPT, compute_dtype=cd, device=CARD)
             for name, fused, cd in (("fused", True, "bfloat16"),
                                     ("unfused", False, None),
                                     ("library", False, "bfloat16"))}
    params, _o, aux = steps["fused"].init_params(shapes, initializer=Xavier(),
                                                 seed=0)
    batch = _resnet_batch(np, 1, n)
    loss, grads = {}, {}
    for name, ts in steps.items():
        lv, g, _ = ts.value_and_grad(params, aux, batch)
        loss[name], grads[name] = lv.item(), {k: v.float() for k, v in
                                             g.items()}
    rows = []
    for k, u in grads["unfused"].items():
        f, lib = grads["fused"][k], grads["library"][k]
        norm = u.norm().clamp_min(1e-30)
        rel, rel_lib = ((f - u).norm() / norm).item(), \
            ((lib - u).norm() / norm).item()
        cos = (torch.dot(f.flatten(), u.flatten())
               / (f.norm() * norm).clamp_min(1e-30)).item()
        rows.append((rel / max(rel_lib, 1e-30), rel, rel_lib, cos, k))
    rows.sort()
    for ratio, rel, rel_lib, cos, k in rows:
        print("resnet grad   %-34s fused bf16 relative L2 %.4g, cosine %.5f; "
              "unfused bf16 %.4g; ratio %.4g" % (k, rel, cos, rel_lib, ratio))

    def median(v):
        return sorted(v)[len(v) // 2]

    print("resnet grad full width, batch %d, %d parameter tensors: loss fused "
          "bf16 %.5f, unfused fp32 %.5f, unfused bf16 %.5f; fused bf16 vs "
          "fp32: relative L2 median %.4g max %.4g, cosine median %.5f min "
          "%.5f; unfused bf16 vs fp32: relative L2 median %.4g; ratio of the "
          "two gaps median %.4g, worst %.4g at %s (limit %g)"
          % (n, len(rows), loss["fused"], loss["unfused"], loss["library"],
             median([r[1] for r in rows]), max(r[1] for r in rows),
             median([r[3] for r in rows]), min(r[3] for r in rows),
             median([r[2] for r in rows]), median([r[0] for r in rows]),
             rows[-1][0], rows[-1][4], FUSED_GRAD_RATIO))
    if rows[-1][0] > FUSED_GRAD_RATIO or not all(
            np.isfinite(v) for v in loss.values()):
        raise RuntimeError("resnet grad: fused bf16 gradients are further "
                           "from fp32 than the unfused bf16 graph's")


def resnet_training_phase(torch, np, fb):
    """The fused ResNet-50 train step as bench.py configures it, at batch
    64; returns the launch counts of the timed steps (B1, B2, B3)."""
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep, functional_optimizer

    gc.collect()
    n = RESNET_TRAIN_BATCH
    sym = resnet.get_symbol(fused=True, **RESNET)
    ts = TrainStep(sym, functional_optimizer(**RESNET_OPT),
                   compute_dtype="bfloat16", device=CARD)
    t0 = time.perf_counter()
    params, opt_state, aux = ts.init_params(
        {"data": (n,) + RESNET["image_shape"], "softmax_label": (n,)},
        initializer=Xavier(), seed=0)
    carry = ts.place(params, opt_state, aux)
    batch = _resnet_batch(np, 0, n)
    batch = {k: torch.as_tensor(v).to(CARD) for k, v in batch.items()}
    print("resnet train: %d parameter tensors (%.2f M), %d aux; init %.2f s"
          % (len(params), sum(v.numel() for v in params.values()) / 1e6,
             len(aux), time.perf_counter() - t0))
    means0 = {k: v.clone() for k, v in aux.items() if "moving_mean" in k}
    t0 = time.perf_counter()
    carry, loss = ts(carry, batch)                       # warm-up
    losses = [loss.item()]
    print("resnet train warm-up step: loss %.5f, %.3f s"
          % (losses[0], time.perf_counter() - t0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    _reset_fb_counts(fb)
    for _ in range(RESNET_TRAIN_STEPS):
        t0 = time.perf_counter()
        carry, loss = ts(carry, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _fb_counts(fb)
    core_routes = _core_routes(fb)
    peak = torch.cuda.max_memory_allocated()
    print("resnet train: %d steps at batch %d: losses %s; step times %s s; "
          "%.1f images/s; peak memory %.2f GiB; launches B1 %d, B2 %d, B3 %d "
          "(%s a step), on the CUDA cores B1 %d, B2 %d, B3 %d"
          % (RESNET_TRAIN_STEPS, n, " ".join("%.5f" % x for x in losses),
             " ".join("%.4f" % x for x in secs),
             n * RESNET_TRAIN_STEPS / sum(secs), peak / 2 ** 30, *launches,
             "/".join("%g" % (c / RESNET_TRAIN_STEPS) for c in launches),
             *core_routes))
    _device_profile(torch, lambda: ts(carry, batch), top=10)

    moved = sum(int(bool((aux[k] != v).any())) for k, v in means0.items())
    if not all(np.isfinite(losses)):
        raise RuntimeError("resnet train: a loss is not finite: %s" % losses)
    if abs(losses[0] - RESNET_FIRST_LOSS) > RESNET_FIRST_LOSS_TOL:
        raise RuntimeError("resnet train: first loss %.4f, expected %.2f +- "
                           "%.2f" % (losses[0], RESNET_FIRST_LOSS,
                                     RESNET_FIRST_LOSS_TOL))
    if not losses[-1] < losses[1]:
        raise RuntimeError("resnet train: loss did not fall over the timed "
                           "steps: %s" % losses)
    if moved != len(means0):
        raise RuntimeError("resnet train: %d of %d moving means moved"
                           % (moved, len(means0)))
    want = tuple(c * RESNET_TRAIN_STEPS for c in (B1_PER_FORWARD, B2_PER_STEP,
                                                  B3_PER_STEP))
    if launches != want or any(core_routes):
        raise RuntimeError("resnet train: launches B1/B2/B3 %s, want %s; on "
                           "the CUDA cores %s, want none"
                           % (launches, want, core_routes))
    print("resnet train: %d of %d moving means moved" % (moved, len(means0)))
    return launches


# TrainStep's single-device options on the same net, batch and optimizer as
# resnet_training_phase: each remat mode, the layout pass, the sentinel,
# return_outputs with metric_stats
REMAT_MODES = (False, True, "conv", "pass")
OPTIONS_STEPS = 3
# B1 launches a step under each remat mode: remat=True reruns every fused
# unit's forward in the backward; conv and pass keep the units' outputs
B1_REMAT_FACTOR = {False: 1, True: 2, "conv": 1, "pass": 1}
# the layout pass reorders the head's BatchNorm reductions (NHWC, axis 3)
LAYOUT_LOSS_TOL = 1e-2
# metric_stats' summed cross-entropy (f32 on the card) against the host's
# float64 sum of the returned probabilities
METRIC_CE_TOL = 1e-4


def _count_copies(torch, fn):
    """The aten clones (contiguous() and reshape copies) that ``fn`` makes,
    counted through a TorchDispatchMode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket is torch.ops.aten.clone:
                n[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return n[0]


def _n_transposes(sym):
    return sum(1 for n in sym._topo()
               if not n.is_variable() and n.op.name == "transpose")


def trainstep_options_phase(torch, np, fb):
    """TrainStep's options on the full-width fused ResNet-50 in bf16 at
    batch 64: each remat mode (losses and params against remat=False, step
    time, peak memory, residual_stats, B1/B2/B3 launches a step); the
    layout pass with remat="pass"; the sentinel on a batch with one NaN
    pixel (record without a host sync, skip as a bit-identical no-op, halt
    raising); metric_stats against the host. Returns the B1, B2 and B3
    launches of the timed remat and layout steps."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep

    gc.collect()
    n = RESNET_TRAIN_BATCH
    shapes = {"data": (n,) + RESNET["image_shape"], "softmax_label": (n,)}
    sym = resnet.get_symbol(fused=True, **RESNET)

    def step_of(**kw):
        return TrainStep(sym, RESNET_OPT, compute_dtype="bfloat16",
                         device=CARD, **kw)

    params0, opt0, aux0 = step_of().init_params(shapes, initializer=Xavier(),
                                                seed=0)

    def fresh():
        return tuple({k: v.clone() for k, v in d.items()}
                     for d in (params0, opt0, aux0))

    batch = {k: torch.as_tensor(v).to(CARD)
             for k, v in _resnet_batch(np, 0, n).items()}
    bad = {k: v.clone() for k, v in batch.items()}
    bad["data"][0, 0, 0, 0] = float("nan")
    want_step = (B1_PER_FORWARD, B2_PER_STEP, B3_PER_STEP)
    total = [0, 0, 0]

    def run(ts, label):
        """A warm-up step and OPTIONS_STEPS timed ones from the seed-0
        params, then a profiled one (device busy time): (losses, params on
        the host after the timed steps, median step s, peak bytes, launches
        a step)."""
        carry = ts.place(*fresh())
        carry, loss = ts(carry, batch)
        losses = [loss.item()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_fb_counts(fb)
        secs = []
        for _ in range(OPTIONS_STEPS):
            t0 = time.perf_counter()
            carry, loss = ts(carry, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(loss.item())
        counts = _fb_counts(fb)
        if any(_core_routes(fb)):
            raise RuntimeError("trainstep %s: launches on the CUDA-core "
                               "route %s" % (label, _core_routes(fb)))
        for i, c in enumerate(counts):
            total[i] += c
        peak = torch.cuda.max_memory_allocated()
        params = {k: v.cpu() for k, v in carry[0].items()}
        print("trainstep %s, one more step:" % label)
        _device_profile(torch, lambda: ts(carry, batch), top=0)
        del carry
        return (losses, params, sorted(secs)[len(secs) // 2], peak,
                tuple(c / OPTIONS_STEPS for c in counts))

    runs = {}
    for mode in REMAT_MODES:
        ts = step_of(remat=mode)
        res = ts.residual_stats(params0, aux0, batch)
        gc.collect()
        runs[mode] = run(ts, "remat=%r" % (mode,)) + (res,)
        want = (want_step[0] * B1_REMAT_FACTOR[mode],) + want_step[1:]
        losses, params, sec, peak, per_step, res = runs[mode]
        ref_losses, ref_params = runs[False][0], runs[False][1]
        gap = max(float((params[k] - ref_params[k]).abs().max())
                  for k in ref_params)
        same = losses == ref_losses and gap == 0.0
        print("trainstep remat=%-6r losses %s; %s; median step %.4f s, "
              "%.1f images/s; peak %.2f GiB; residual_stats %.1f MiB in %d "
              "storages; launches a step B1 %g, B2 %g, B3 %g (want %d/%d/%d)"
              % (mode, " ".join("%.5f" % x for x in losses),
                 "bit-identical to remat=False" if same else
                 "largest param gap to remat=False %.3g" % gap, sec, n / sec,
                 peak / 2 ** 30, res["residual_bytes"] / 2 ** 20,
                 res["n_residuals"], *per_step, *want))
        if per_step != want:
            raise RuntimeError("trainstep remat=%r: launches a step %s, "
                               "want %s" % (mode, per_step, want))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
            raise RuntimeError("trainstep remat=%r: losses %s" % (mode,
                                                                   losses))
        if not same and mode != True:  # noqa: E712
            # conv and pass recompute only elementwise nodes: same bits
            raise RuntimeError("trainstep remat=%r: training differs from "
                               "remat=False (losses %s vs %s, param gap %g)"
                               % (mode, losses, ref_losses, gap))
    if not runs["pass"][5]["residual_bytes"] <= \
            runs[False][5]["residual_bytes"]:
        raise RuntimeError("trainstep: remat='pass' keeps more than False")
    print("trainstep remat on %s: %s" % (_card_line(), "; ".join(
        "%r median step %.4f s, peak %.2f GiB" % (m, r[2], r[3] / 2 ** 30)
        for m, r in runs.items())))

    # the layout pass under remat="pass"
    ts = step_of(remat="pass", train_passes=("layout",))
    plain = step_of(remat="pass")
    t_before, t_after = _n_transposes(sym), _n_transposes(ts.symbol)
    axes = [n.attrs.get("axis", 1) for n in ts.symbol._topo()
            if not n.is_variable() and n.op.name == "BatchNorm"]
    copies = {}
    for name, s in (("passes off", plain), ("layout", ts)):
        c, _ = s(s.place(*fresh()), batch)
        torch.cuda.synchronize()
        copies[name] = _count_copies(torch, lambda: s(c, batch))
        del c
    losses, _p, sec, peak, per_step = run(ts, "layout")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, runs[False][0]))
    print("trainstep layout pass + remat='pass': transposes %d -> %d, "
          "BatchNorm axes %s; aten copies a step %d (passes off %d); losses "
          "%s, largest relative gap to passes off %.3g (tol %g); median step "
          "%.4f s; peak %.2f GiB; launches a step B1 %g, B2 %g, B3 %g"
          % (t_before, t_after, axes, copies["layout"], copies["passes off"],
             " ".join("%.5f" % x for x in losses), rel, LAYOUT_LOSS_TOL, sec,
             peak / 2 ** 30, *per_step))
    if rel > LAYOUT_LOSS_TOL or per_step != want_step or 3 not in axes:
        raise RuntimeError("trainstep layout: losses %s (gap %g), launches "
                           "%s, BatchNorm axes %s" % (losses, rel, per_step,
                                                      axes))

    # the sentinel, on a batch with one NaN pixel after a healthy step
    ts = step_of(sentinel="record")
    carry = ts.place(*fresh())
    carry, _ = ts(carry, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, _ = ts(carry, batch)
        carry, _ = ts(carry, bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rec = ts.health_stats(carry)
    # the NaN pixel reaches the stem's BatchNorm statistics, hence the
    # gradients, and through the fused units' prologue ReLU, which passes a
    # NaN on as jnp.maximum does, the loss
    print("trainstep sentinel record: 3 steps, the last 2 without a host "
          "sync; %s" % rec)
    if (rec["healthy"], rec["unhealthy"], rec["skipped"], rec["consec"],
            rec["nonfinite_loss"], rec["nonfinite_grad"]) != \
            (2, 1, 0, 1, 1, 1):
        raise RuntimeError("trainstep sentinel record: counters %s" % rec)

    ts = step_of(sentinel="skip")
    carry = ts.place(*fresh())
    carry, _ = ts(carry, batch)
    keep = [v.clone() for d in (carry[0], carry[2]) for v in d.values()] + \
        [v.clone() for k, v in carry[1].items() if k != ts._SENT]
    step_before = carry[3].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, _ = ts(carry, bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = [v for d in (carry[0], carry[2]) for v in d.values()] + \
        [v for k, v in carry[1].items() if k != ts._SENT]
    same = all(torch.equal(a, b) for a, b in zip(after, keep))
    skip = ts.health_stats(carry)
    print("trainstep sentinel skip: unhealthy step without a host sync; "
          "params, optimizer state and aux %s; step counter %d -> %d; %s"
          % ("bit-identical" if same else "CHANGED", int(step_before),
             int(carry[3]), skip))
    if not same or int(carry[3]) != int(step_before) or skip["skipped"] != 1:
        raise RuntimeError("trainstep sentinel skip: not a no-op")

    ts = step_of(sentinel="halt")
    profiler.pipeline_reset()
    carry = ts.place(*fresh())
    carry, _ = ts(carry, batch)
    try:
        ts(carry, bad)
    except MXNetError as e:
        halted = str(e)
    else:
        raise RuntimeError("trainstep sentinel halt: did not raise")
    syncs = profiler.pipeline_stats(reset=True).get("host_syncs")
    print("trainstep sentinel halt: raised %r; host syncs %s (one a step)"
          % (halted[:60], syncs))
    if syncs != 2:
        raise RuntimeError("trainstep sentinel halt: %s host syncs, want 2"
                           % syncs)

    ts = step_of(return_outputs=True, metric_stats=True)
    carry = ts.place(*fresh())
    carry, (loss, outs, stats) = ts(carry, batch)
    probs = outs[0].float().cpu().numpy().astype(np.float64)
    lbl = batch["softmax_label"].cpu().numpy().astype(np.int64)
    correct = int((probs.argmax(1) == lbl).sum())
    ce = float(-np.log(probs[np.arange(n), lbl] + 1e-12).sum())
    got = {k: float(v) for k, v in stats.items()}
    print("trainstep metric_stats: %s; host: correct %d, sum_ce %.6f"
          % (got, correct, ce))
    if int(got["n"]) != n or int(got["correct"]) != correct or \
            abs(got["sum_ce"] - ce) > METRIC_CE_TOL * abs(ce) or \
            abs(got["sum_loss"] - loss.item() * n) > 1e-6 * abs(ce):
        raise RuntimeError("trainstep metric_stats differ from the host's")
    print("trainstep: B1 %d, B2 %d, B3 %d launches in the timed steps of "
          "the 4 remat modes and the layout run" % tuple(total))
    return tuple(total)


# Module.fit on the fused ResNet-50: the user's symbolic training path, fp32
# parameters (Module's default), 2 epochs over 4 copies of one seeded batch
FIT_BATCH, FIT_COPIES, FIT_EPOCHS = RESNET_TRAIN_BATCH, 4, 2
FIT_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
# card vs CPU: the tiny fused net's gradients through Executor.forward_backward
FIT_GRAD_TOL = 1e-4
TRAINSTEP_FP32_STEPS = 5
# images/s (median batch) and device busy share of a profiled batch of the
# module_fit phase, printed beside the tail phase's Custom-headed fit
FIT_RATES = {}


def _fit_card_vs_cpu(torch, np, fb, mx):
    """The tiny fused fp32 ResNet through ``Executor.forward_backward`` on the
    card and on the CPU; gradients against the CPU's, each tensor against
    its own largest |gradient| floored at 1% of the largest of any."""
    from mxnet_tpu_torch.models import resnet

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("module fit: TF32 must be off for an fp32 "
                           "reference")
    sym = resnet.resnet(fused=True, **TINY_RESNET)
    shape = (TINY_BATCH, 3) + TINY_RESNET["image_shape"][1:]
    args, auxs = resnet.init_params(sym, shape, seed=0)
    rng = np.random.RandomState(4)
    batch = {"data": rng.randn(*shape).astype(np.float32),
             "softmax_label": rng.randint(0, TINY_RESNET["num_classes"],
                                          (TINY_BATCH,)).astype(np.float32)}
    got = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        ex = sym.simple_bind(ctx, data=shape, softmax_label=(TINY_BATCH,))
        for d, src in ((ex.arg_dict, args), (ex.aux_dict, auxs)):
            for k, v in src.items():
                d[k][:] = v
        before = _fb_counts(fb)
        ex.forward_backward(**batch)
        got[where] = (
            ex.outputs[0].asnumpy(),
            {k: v.asnumpy() for k, v in ex.grad_dict.items()
             if k not in batch},
            tuple(a - b for a, b in zip(_fb_counts(fb), before)))
    card, cpu = got["card"], got["cpu"]
    floor = 1e-2 * max(float(np.abs(g).max()) for g in cpu[1].values())
    errs = sorted((float(np.abs(card[1][k] - g).max())
                   / max(float(np.abs(g).max()), floor), k)
                  for k, g in cpu[1].items())
    out_err = float(np.abs(card[0] - cpu[0]).max())
    print("module fit tiny: Executor.forward_backward card vs cpu, %d "
          "gradients, worst %s (tol %g), outputs %.3g; card launches B1 %d, "
          "B2 %d, B3 %d" % (len(errs), ", ".join("%.3g at %s" % e
                                                for e in errs[-3:]),
                            FIT_GRAD_TOL, out_err, *card[2]))
    if errs[-1][0] > FIT_GRAD_TOL or out_err > FIT_GRAD_TOL or \
            card[2] != (11, 11, 9):
        raise RuntimeError("module fit: the card's Executor gradients differ "
                           "from the CPU's, or the tiny net missed its "
                           "kernels")


def module_fit_phase(torch, np, fb):
    """``Module.fit`` on the full-width fused ResNet-50 at batch 64, fp32,
    as a user runs it; returns the fit's launch counts (B1, B2, B3)."""
    import logging
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import resnet

    gc.collect()
    _fit_card_vs_cpu(torch, np, fb, mx)
    n, ctx = FIT_BATCH, mx.gpu(0)
    rng = np.random.RandomState(0)
    one = rng.randn(n, *RESNET["image_shape"]).astype(np.float32)
    labels = rng.randint(0, RESNET["num_classes"], (n,)).astype(np.float32)
    x = np.concatenate([one] * FIT_COPIES)
    y = np.concatenate([labels] * FIT_COPIES)
    tmp = tempfile.mkdtemp(prefix="module_fit_")
    prefix = os.path.join(tmp, "r50")
    try:
        sym = resnet.get_symbol(fused=True, **RESNET)
        mod = mx.mod.Module(sym, context=ctx)
        it = mx.io.NDArrayIter(x, y, batch_size=n)
        per_batch = []      # (seconds, cross-entropy, B1, B2, B3)
        last = {"t": None, "counts": (0, 0, 0)}

        def on_batch(param):
            torch.cuda.synchronize()
            now = time.perf_counter()
            probs = mod.get_outputs()[0].asnumpy()
            lbl = param.locals["data_batch"].label[0].asnumpy().astype(int)
            ce = float(-np.log(probs[np.arange(n), lbl] + 1e-12).mean())
            counts = _fb_counts(fb)
            per_batch.append((now - last["t"], ce) + tuple(
                a - b for a, b in zip(counts, last["counts"])))
            last["t"], last["counts"] = time.perf_counter(), counts

        logging.getLogger().setLevel(logging.WARNING)
        mx.random.seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_fb_counts(fb)
        t0 = time.perf_counter()
        last["t"] = t0
        mod.fit(it, num_epoch=FIT_EPOCHS, optimizer="sgd",
                optimizer_params=FIT_OPT, initializer=mx.init.Xavier(),
                eval_metric=["acc", "ce"],
                epoch_end_callback=mx.callback.do_checkpoint(prefix),
                batch_end_callback=[on_batch, mx.callback.Speedometer(n, 1)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, core_routes = _fb_counts(fb), _core_routes(fb)
        peak = torch.cuda.max_memory_allocated()
        secs = [b[0] for b in per_batch]
        losses = [b[1] for b in per_batch]
        steady = sorted(secs[1:])
        med = steady[len(steady) // 2]
        print("module fit: %d parameter tensors, %d aux; %d batches of %d in "
              "%.2f s (first batch, with its set-up, %.3f s); seconds a batch "
              "after the first: median %.4f, range %.4f-%.4f; %.1f images/s "
              "(median); peak memory %.2f GiB; launches B1 %d, B2 %d, B3 %d "
              "(a batch: %s), on the CUDA cores %d/%d/%d"
              % (len(mod._param_names), len(mod._aux_names), len(secs), n,
                 wall, secs[0], med, steady[0], steady[-1], n / med,
                 peak / 2 ** 30, *launches,
                 " ".join("%d/%d/%d" % b[2:] for b in per_batch),
                 *core_routes))
        print("module fit: cross-entropy a batch %s"
              % " ".join("%.5f" % v for v in losses))
        arg_params, aux_params = mod.get_params()

        # the checkpoint of the last epoch holds exactly get_params()
        _sym, ck_args, ck_aux = mx.model.load_checkpoint(prefix, FIT_EPOCHS)
        same = all(torch.equal(ck[k].tensor, mine[k].tensor)
                   for ck, mine in ((ck_args, arg_params),
                                    (ck_aux, aux_params)) for k in mine) \
            and sorted(ck_args) == sorted(arg_params) \
            and sorted(ck_aux) == sorted(aux_params)
        moved = sum(int(bool(v.asnumpy().any())) for k, v in
                    aux_params.items() if k.endswith("moving_mean"))
        n_means = sum(k.endswith("moving_mean") for k in aux_params)
        # the checkpoint bound for inference gives the trained module's
        # outputs on the batch, bit for bit
        batch = mx.io.DataBatch([mx.nd.array(one, ctx=mx.cpu())])
        mod.forward(batch, is_train=False)
        want = mod.get_outputs()[0].asnumpy()
        inf = mx.mod.Module.load(prefix, FIT_EPOCHS, context=ctx)
        inf.bind([("data", (n,) + RESNET["image_shape"])],
                 for_training=False)
        inf.forward(batch)
        same_outputs = np.array_equal(inf.get_outputs()[0].asnumpy(), want)
        del inf
        print("module fit: checkpoint epoch %d equals get_params() bit for "
              "bit: %s; Module.load bound for inference gives the trained "
              "outputs bit for bit: %s; %d of %d moving means moved"
              % (FIT_EPOCHS, same, same_outputs, moved, n_means))

        # where a batch goes: a profiled batch, then the updater alone
        data_batch = next(iter(it))
        it.reset()

        def one_batch():
            mod.forward_backward(data_batch)
            mod.update()

        prof = {}
        _device_profile(torch, one_batch, top=10, stats=prof)
        FIT_RATES["module_fit"] = (n / med, prof.get("busy_ms", 0.0)
                                   / prof.get("wall_ms", 1.0))
        _device_profile(torch, mod.update, top=3)
        upd = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mod.update()
            torch.cuda.synchronize()
            upd.append(time.perf_counter() - t1)
        upd.sort()
        print("module fit: the updater (%d parameters, one update each) "
              "takes %.4f s a batch (median of 5, synchronized), %.3f of "
              "the median batch" % (len(mod._param_names), upd[2],
                                    upd[2] / med))
        del mod
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the same net, batch and optimizer through TrainStep in fp32, this call
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.parallel import TrainStep

    gc.collect()
    ts = TrainStep(sym, dict(name="sgd", **FIT_OPT), compute_dtype=None,
                   device=CARD)
    carry = ts.place(*ts.init_params(
        {"data": (n,) + RESNET["image_shape"], "softmax_label": (n,)},
        initializer=Xavier(), seed=0))
    tbatch = {"data": torch.as_tensor(one).to(CARD),
              "softmax_label": torch.as_tensor(labels).to(CARD)}
    carry, _loss = ts(carry, tbatch)
    step_s = []
    for _ in range(TRAINSTEP_FP32_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, _loss = ts(carry, tbatch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    step_s.sort()
    ts_med = step_s[len(step_s) // 2]
    print("module fit vs TrainStep(compute_dtype=None), fp32, batch %d, same "
          "optimizer, this call: Module.fit %.1f images/s (median batch "
          "%.4f s), TrainStep %.1f images/s (median step %.4f s, range "
          "%.4f-%.4f)" % (n, n / med, med, n / ts_med, ts_med, step_s[0],
                          step_s[-1]))
    del ts, carry

    per = [b[2:] for b in per_batch]
    want_per = (B1_PER_FORWARD, B2_PER_STEP, B3_PER_STEP)
    if not all(np.isfinite(losses)):
        raise RuntimeError("module fit: a loss is not finite: %s" % losses)
    if abs(losses[0] - math.log(RESNET["num_classes"])) > \
            RESNET_FIRST_LOSS_TOL:
        raise RuntimeError("module fit: first batch cross-entropy %.4f, "
                           "expected ln %d +- %.2f" % (
                               losses[0], RESNET["num_classes"],
                               RESNET_FIRST_LOSS_TOL))
    if not losses[-1] < losses[0]:
        raise RuntimeError("module fit: loss did not fall: %s" % losses)
    if any(p != want_per for p in per) or any(core_routes):
        raise RuntimeError("module fit: launches a batch %s, want %s; on the "
                           "CUDA cores %s, want none"
                           % (per, want_per, core_routes))
    if moved != n_means or not same or not same_outputs:
        raise RuntimeError("module fit: moving means moved %d of %d, "
                           "checkpoint equal %s, loaded outputs equal %s"
                           % (moved, n_means, same, same_outputs))
    return launches


# data parallelism on the fused ResNet-50 (bench.py's TrainStep(mesh=) and
# Module.fit(kvstore="tpu")): one process a device over torch.distributed.
# The host has one card, so this measures correctness, not scaling: a mesh
# of one rank over NCCL, then two ranks sharing cuda:0 over gloo (NCCL
# refuses two ranks on one device). Rates printed from the two ranks are of
# two processes sharing one card. DP_BATCH, DP_STEPS, DP_RANKS: above.
# the 2-rank fp32 step against one device at the same global batch. On the
# tiny fused ResNet (64x64 images), whose gradients are well conditioned:
# the loss, each gradient tensor against its largest |value| floored at 1%
# of the largest of any (bn0's gamma has an exact gradient of 0), and 3
# losses, within DP_GRAD_TOL. At full width the Xavier-init fp32 gradients
# are not: any other order of the same sums moves the worst tensors by a
# few percent (this phase prints both gaps), so there the first loss is
# held to DP_GRAD_TOL, the whole gradient's relative L2 gap to one device
# at most DP_GAP_RATIO times the gap one device shows when the batch's
# rows come in another order (the same sums in another order), and each
# tensor's gap (as on the tiny net) within DP_GRAD_TOL or at most
# DP_GAP_RATIO times the largest of that tensor's gaps under DP_REORDERS
# such orders: a unit whose sum is dropped or whose kernel is wrong moves
# its own tensors by far more than rounding does
DP_GRAD_TOL = 1e-4
DP_GAP_RATIO = 2.0
DP_REORDERS = 3
# ZeRO against the replicated update on the same ranks
DP_ZERO_RTOL, DP_ZERO_ATOL = 1e-5, 1e-6
DP_TIMEOUT = 420


def _param_digest(params):
    """One sha256 over every param's bytes, in name order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_steps(torch, ts, carry, batch, steps):
    """``steps`` synchronized steps: (carry, losses, seconds)."""
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, loss = ts(carry, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return carry, losses, secs


def _dp_one_rank_nccl(torch, np, fb):
    """TrainStep(mesh=make_mesh({"dp": 1})) over NCCL against mesh=None
    from the same init, bf16: 3 steps each, bit for bit; launches of the
    mesh's steps; a profiled mesh step with its NCCL kernels."""
    import torch.distributed as dist

    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    n = DP_BATCH
    sym = resnet.get_symbol(fused=True, **RESNET)
    one = TrainStep(sym, RESNET_OPT, compute_dtype="bfloat16", device=CARD)
    init = one.init_params({"data": (n,) + RESNET["image_shape"],
                            "softmax_label": (n,)}, initializer=Xavier(),
                           seed=0)
    batch = _resnet_batch(np, 0, n)

    def fresh():
        return [{k: v.clone() for k, v in d.items()} for d in init]

    carry_one, l_one, s_one = _dp_steps(torch, one, one.place(*fresh()),
                                        batch, DP_STEPS)
    mesh = make_mesh({"dp": 1})
    try:
        ts = TrainStep(sym, RESNET_OPT, mesh=mesh, compute_dtype="bfloat16")
        carry = ts.place(*fresh())
        torch.cuda.reset_peak_memory_stats()
        _reset_fb_counts(fb)
        carry, l_mesh, s_mesh = _dp_steps(torch, ts, carry, batch, DP_STEPS)
        launches, core = _fb_counts(fb), _core_routes(fb)
        peak = torch.cuda.max_memory_allocated()
        same = [all(torch.equal(a[k], b[k]) for k in a)
                for a, b in ((carry[0], carry_one[0]),
                             (carry[2], carry_one[2]),
                             (carry[1], carry_one[1]))]
        print("dp nccl 1 rank (backend %s, world %d), bf16, batch %d: losses "
              "%s vs mesh=None %s; params, aux, optimizer state bit for bit "
              "%s; step times %s s (mesh=None %s s); peak memory %.2f GiB; "
              "launches B1 %d, B2 %d, B3 %d in %d steps, on the CUDA cores "
              "%d/%d/%d"
              % (dist.get_backend(), dist.get_world_size(), n,
                 " ".join("%.5f" % x for x in l_mesh),
                 " ".join("%.5f" % x for x in l_one), same,
                 " ".join("%.4f" % x for x in s_mesh),
                 " ".join("%.4f" % x for x in s_one), peak / 2 ** 30,
                 *launches, DP_STEPS, *core))
        nccl = _device_profile(torch, lambda: ts(carry, batch), top=6,
                               also=("nccl", "Nccl"))
        # a one-rank mesh has no data group: no collective runs
        print("dp nccl: NCCL kernels in the profiled step: %s"
              % (", ".join(k[:60] for k in nccl) or "none"))
    finally:
        del mesh
        dist.destroy_process_group()
    want = tuple(c * DP_STEPS for c in (B1_PER_FORWARD, B2_PER_STEP,
                                        B3_PER_STEP))
    if l_mesh != l_one or not all(same):
        raise RuntimeError("dp nccl: the mesh of one rank is not bit for bit "
                           "mesh=None: losses %s vs %s, params/aux/opt %s"
                           % (l_mesh, l_one, same))
    if launches != want or any(core):
        raise RuntimeError("dp nccl: launches %s, want %s; CUDA cores %s"
                           % (launches, want, core))
    return launches


def _run_ranks(entry, world, timeout, label, *args):
    """Spawn ``world`` processes sharing the card, each running ``entry(rank,
    world, port, out_dir, *args)`` (a function of this script that writes
    ``rank<r>.json`` into ``out_dir``; ``port`` is a free localhost port
    for its process group), wait for them within ``timeout`` s, killing
    them past it, and return their results in rank order and the wall
    seconds, start-up included. A rank that raises fails the call."""
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as tmp_mp

    out_dir = tempfile.mkdtemp(prefix="ranks_")
    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        ctx = tmp_mp.start_processes(entry, args=(world, port, out_dir,
                                                  *args),
                                     nprocs=world, join=False,
                                     start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise RuntimeError("%s: the ranks did not finish within "
                                       "%d s" % (label, timeout))
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        return ranks, time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _dp_gloo_rank(rank, world, port, out_dir):
    """One of the ranks sharing cuda:0 over gloo (a spawned process)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch.kernels import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ZeRO against replicated compares runs bit for bit where the math is
    # elementwise: cuDNN's backward must not pick an atomic algorithm
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                            rank=rank, world_size=world)
    try:
        res = _dp_gloo_work(torch, np, fb, rank, world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)


def _grad_errs(grads, ref):
    """Each tensor's largest error against its largest |value|, floored at
    1% of the largest of any, sorted."""
    floor = 1e-2 * max(g.abs().max().item() for g in ref.values())
    return sorted((((grads[k] - g).abs().max()
                    / g.abs().max().clamp_min(floor)).item(), k)
                  for k, g in ref.items())


def _l2_gap(grads, ref):
    """The whole gradient's relative L2 distance to ``ref``."""
    num = sum(float((grads[k].double() - g.double()).square().sum())
              for k, g in ref.items())
    den = sum(float(g.double().square().sum()) for g in ref.values())
    return math.sqrt(num / den)


def _dp_tiny(torch, np, mesh, rank):
    """The tiny fused ResNet at global batch 64 on the ranks against one
    device: the first loss, the gradients, 3 losses."""
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep

    n = DP_BATCH
    sym = resnet.resnet(fused=True, **TINY_RESNET)
    shape = (n, 3) + TINY_RESNET["image_shape"][1:]
    rng = np.random.RandomState(4)
    batch = {"data": rng.randn(*shape).astype(np.float32),
             "softmax_label": rng.randint(0, TINY_RESNET["num_classes"],
                                          (n,)).astype(np.float32)}
    ts = TrainStep(sym, RESNET_OPT, mesh=mesh)
    init = ts.init_params({"data": shape, "softmax_label": (n,)},
                          initializer=Xavier(), seed=0)
    copies = [[{k: v.clone() for k, v in d.items()} for d in init]
              for _ in range(3)]
    carry = ts.place(*copies[0])
    loss, grads, _ = ts.value_and_grad(carry[0], carry[2], batch)
    _c, losses, _s = _dp_steps(torch, ts, carry, batch, DP_STEPS)
    out = {"first_loss": float(loss), "losses": losses,
           "digest": _param_digest(_c[0])}
    if rank == 0:
        ref = TrainStep(sym, RESNET_OPT, device=CARD)
        p, _o, a = copies[1]
        rloss, rgrads, _ = ref.value_and_grad(p, a, batch)
        _c, rlosses, _s = _dp_steps(torch, ref, ref.place(*copies[2]),
                                    batch, DP_STEPS)
        out.update(ref_first_loss=float(rloss), ref_losses=rlosses,
                   grad_errs=_grad_errs(grads, rgrads)[-3:],
                   grad_tensors=len(rgrads))
    return out


def _dp_gloo_work(torch, np, fb, rank, world):
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    n = DP_BATCH
    shapes = {"data": (n,) + RESNET["image_shape"], "softmax_label": (n,)}
    sym = resnet.get_symbol(fused=True, **RESNET)
    mesh = make_mesh({"dp": world}, backend="gloo")
    batch = _resnet_batch(np, 0, n)
    res = {"rank": rank, "tiny": _dp_tiny(torch, np, mesh, rank)}

    def step_of(zero=False):
        return TrainStep(sym, RESNET_OPT, mesh=mesh, zero=zero)

    ts = step_of()
    init = ts.init_params(shapes, initializer=Xavier(), seed=0)

    def fresh():
        return [{k: v.clone() for k, v in d.items()} for d in init]

    # the first step's loss and gradients of the global batch; on rank 0,
    # one device's, on the batch and on its rows in DP_REORDERS other orders
    carry = ts.place(*fresh())
    loss, grads, _aux = ts.value_and_grad(carry[0], carry[2], batch)
    res["first_loss"] = float(loss)
    if rank == 0:
        ref = TrainStep(sym, RESNET_OPT, device=CARD)
        p, _o, a = fresh()
        rloss, rgrads, _ = ref.value_and_grad(p, a, batch)
        errs = {k: e for e, k in _grad_errs(grads, rgrads)}
        envelope, perm_gaps = dict.fromkeys(errs, 0.0), []
        for seed in range(1, 1 + DP_REORDERS):
            perm = np.random.RandomState(seed).permutation(n)
            p, _o, a = fresh()
            _pl, pgrads, _ = ref.value_and_grad(
                p, a, {k: v[perm] for k, v in batch.items()})
            for e, k in _grad_errs(pgrads, rgrads):
                envelope[k] = max(envelope[k], e)
            perm_gaps.append(_l2_gap(pgrads, rgrads))
            del pgrads
        # each tensor's gap over its limit, the largest first
        ratios = sorted(((errs[k] / max(DP_GAP_RATIO * envelope[k],
                                        DP_GRAD_TOL), k, errs[k],
                          envelope[k]) for k in errs), reverse=True)
        res.update(ref_first_loss=float(rloss),
                   grad_errs=sorted((e, k) for k, e in errs.items())[-3:],
                   perm_errs=sorted((e, k) for k, e in envelope.items())[-3:],
                   tensor_ratios=ratios[:3],
                   tensors_over=[r for r in ratios if r[0] > 1.0],
                   gap=_l2_gap(grads, rgrads), perm_gap=perm_gaps[0],
                   perm_gaps=perm_gaps, grad_tensors=len(rgrads))
        del rgrads
    del grads
    # 3 replicated steps, timed, with their launches and memory
    torch.cuda.reset_peak_memory_stats()
    _reset_fb_counts(fb)
    carry, res["losses"], res["secs"] = _dp_steps(torch, ts, carry, batch,
                                                  DP_STEPS)
    res["launches"], res["core_routes"] = _fb_counts(fb), _core_routes(fb)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["digest"] = _param_digest(carry[0])
    res["aux_digest"] = _param_digest(carry[2])
    res["opt_digest"] = _param_digest(carry[1])
    res["memory"] = ts.memory_stats(carry)
    rep_params = {k: v.clone() for k, v in carry[0].items()}
    # a fourth step, profiled on rank 0: every rank runs it (a collective)
    if rank == 0:
        _device_profile(torch, lambda: ts(carry, batch), top=6,
                        also=("nccl", "Memcpy"))
    else:
        ts(carry, batch)
        torch.cuda.synchronize()
    del carry
    if rank == 0:
        ref_carry = ref.place(*fresh())
        _c, res["ref_losses"], res["ref_secs"] = _dp_steps(
            torch, ref, ref_carry, batch, DP_STEPS)
        del ref, ref_carry, _c
    gc.collect()
    # ZeRO from the same init against the replicated run
    zs = step_of(zero=True)
    zcarry = zs.place(*fresh())
    zcarry, res["zero_losses"], res["zero_secs"] = _dp_steps(
        torch, zs, zcarry, batch, DP_STEPS)
    res["zero_memory"] = zs.memory_stats(zcarry)
    bad = [k for k, v in rep_params.items()
           if not torch.allclose(zcarry[0][k], v, rtol=DP_ZERO_RTOL,
                                 atol=DP_ZERO_ATOL)]
    res["zero_param_mismatches"] = bad
    res["zero_max_abs"] = max((zcarry[0][k] - v).abs().max().item()
                              for k, v in rep_params.items())
    res["zero_digest"] = _param_digest(zcarry[0])
    del zs, zcarry, rep_params
    gc.collect()
    res["fit"] = _dp_module_fit(torch, np, fb, n)
    return res


def _dp_module_fit(torch, np, fb, n):
    """Module.fit(kvstore="tpu") on this rank: one epoch over 4 copies of
    one batch, fp32, with accuracy and cross-entropy kept on the card."""
    import logging

    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(0)
    one = rng.randn(n, *RESNET["image_shape"]).astype(np.float32)
    labels = rng.randint(0, RESNET["num_classes"], (n,)).astype(np.float32)
    it = mx.io.NDArrayIter(np.concatenate([one] * FIT_COPIES),
                           np.concatenate([labels] * FIT_COPIES),
                           batch_size=n)
    from mxnet_tpu_torch.models import resnet

    mod = mx.mod.Module(resnet.get_symbol(fused=True, **RESNET),
                        context=mx.gpu(0))
    metric = mx.metric.create(["acc", "ce"])
    per = []

    def on_batch(param):
        torch.cuda.synchronize()
        per.append(time.perf_counter())

    logging.getLogger().setLevel(logging.WARNING)
    mx.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_fb_counts(fb)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore="tpu", optimizer="sgd",
            optimizer_params=FIT_OPT, initializer=mx.init.Xavier(),
            eval_metric=metric, batch_end_callback=on_batch)
    res = {"fused": mod._fused is not None,
           "mesh_ranks": int(mod._kvstore.mesh.size()),
           "metric": dict(metric.get_name_value()),
           "secs": [b - a for a, b in zip([t0] + per[:-1], per)],
           "launches": _fb_counts(fb),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "digest": _param_digest({k: v.tensor for k, v in
                                    mod.get_params()[0].items()})}
    it.reset()
    data_batch = next(iter(it))
    _device_profile(torch, lambda: mod.forward_backward(data_batch), top=4)
    return res


def dp_training_phase(torch, np, fb):
    """Data-parallel training of the fused ResNet-50 at global batch 64: a
    mesh of one rank over NCCL (bit for bit mesh=None), then 2 ranks sharing
    the card over gloo (fp32 against one device, ZeRO against replicated,
    Module.fit(kvstore="tpu")). Returns (B1, B2, B3) launches of the NCCL
    mesh's steps and of each gloo rank's replicated steps."""
    gc.collect()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nccl = _dp_one_rank_nccl(torch, np, fb)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()
    ranks, wall = _run_ranks(_dp_gloo_rank, DP_RANKS, DP_TIMEOUT, "dp gloo")
    r0 = ranks[0]
    n = DP_BATCH
    tiny = r0["tiny"]
    tiny_gaps = [abs(a - b) / abs(b) for a, b in zip(
        [tiny["first_loss"]] + tiny["losses"],
        [tiny["ref_first_loss"]] + tiny["ref_losses"])]
    print("dp gloo %d ranks sharing one card (%.1f s with start-up), fp32, "
          "global batch %d (%d rows a rank); tiny fused ResNet: first loss "
          "%.7f vs one device %.7f, losses %s vs %s (worst gap %.3g), "
          "worst gradients %s of %d tensors (tol %g)"
          % (DP_RANKS, wall, n, n // DP_RANKS, tiny["first_loss"],
             tiny["ref_first_loss"],
             " ".join("%.7f" % x for x in tiny["losses"]),
             " ".join("%.7f" % x for x in tiny["ref_losses"]),
             max(tiny_gaps), ", ".join("%.3g at %s" % tuple(e)
                                       for e in tiny["grad_errs"]),
             tiny["grad_tensors"], DP_GRAD_TOL))
    first_gap = abs(r0["first_loss"] - r0["ref_first_loss"]) / \
        abs(r0["ref_first_loss"])
    print("dp gloo full width: first loss %.6f vs one device %.6f (gap "
          "%.3g, tol %g); whole-gradient relative L2 gap %.4g against one "
          "device, %.4g for one device with the rows reordered (ratio %.3g, "
          "limit %g; the other reorders %s); worst tensors, ranks %s, "
          "largest of %d reorders %s; each tensor's gap over max(%g x its "
          "largest reordered gap, %g): worst %s, %d of %d over 1; losses %s "
          "vs one device %s"
          % (r0["first_loss"], r0["ref_first_loss"], first_gap, DP_GRAD_TOL,
             r0["gap"], r0["perm_gap"], r0["gap"] / r0["perm_gap"],
             DP_GAP_RATIO, " ".join("%.4g" % x for x in r0["perm_gaps"][1:]),
             ", ".join("%.3g at %s" % tuple(e) for e in r0["grad_errs"]),
             DP_REORDERS,
             ", ".join("%.3g at %s" % tuple(e) for e in r0["perm_errs"]),
             DP_GAP_RATIO, DP_GRAD_TOL,
             ", ".join("%.3g at %s (%.3g vs %.3g)" % tuple(e)
                       for e in r0["tensor_ratios"]),
             len(r0["tensors_over"]), r0["grad_tensors"],
             " ".join("%.6f" % x for x in r0["losses"]),
             " ".join("%.6f" % x for x in r0["ref_losses"])))
    for r in ranks:
        print("dp gloo rank %d: step times %s s (two processes share one "
              "card: not a scaling rate); peak memory %.2f GiB; launches "
              "B1 %d, B2 %d, B3 %d in %d steps, on the CUDA cores %s; "
              "ZeRO step times %s s; optimizer bytes %d replicated, %d "
              "ZeRO (%.4f); ZeRO params vs replicated: max |diff| %.3g, "
              "%d outside rtol %g atol %g"
              % (r["rank"], " ".join("%.4f" % x for x in r["secs"]),
                 r["peak_gib"], *r["launches"], DP_STEPS, r["core_routes"],
                 " ".join("%.4f" % x for x in r["zero_secs"]),
                 r["memory"]["opt_bytes_per_dev"],
                 r["zero_memory"]["opt_bytes_per_dev"],
                 r["zero_memory"]["opt_bytes_per_dev"]
                 / r["memory"]["opt_bytes_per_dev"],
                 r["zero_max_abs"], len(r["zero_param_mismatches"]),
                 DP_ZERO_RTOL, DP_ZERO_ATOL))
        f = r["fit"]
        print("dp gloo rank %d Module.fit(kvstore='tpu'): fused group %s, "
              "mesh of %d ranks, %d batches, seconds a batch %s (shared "
              "card), peak memory %.2f GiB, metric %s, launches B1 %d, B2 "
              "%d, B3 %d"
              % (r["rank"], f["fused"], f["mesh_ranks"], len(f["secs"]),
                 " ".join("%.4f" % x for x in f["secs"]), f["peak_gib"],
                 f["metric"], *f["launches"]))
    print("dp gloo: the one-device reference step times %s s (same card, "
          "one process)" % " ".join("%.4f" % x for x in r0["ref_secs"]))

    same = {key: len({r[key] for r in ranks}) == 1
            for key in ("digest", "aux_digest", "opt_digest")}
    same["tiny"] = len({r["tiny"]["digest"] for r in ranks}) == 1
    fit_same = len({json.dumps(r["fit"]["metric"], sort_keys=True)
                    for r in ranks}) == 1 and \
        len({r["fit"]["digest"] for r in ranks}) == 1
    print("dp gloo: ranks bit for bit equal: params %s, aux %s, optimizer "
          "state %s; Module.fit params and metric equal on the ranks %s"
          % (same["digest"], same["aux_digest"], same["opt_digest"],
             fit_same))
    want = tuple(c * DP_STEPS for c in (B1_PER_FORWARD, B2_PER_STEP,
                                        B3_PER_STEP))
    fit_want = tuple(c * FIT_COPIES for c in (B1_PER_FORWARD, B2_PER_STEP,
                                              B3_PER_STEP))
    if max(tiny_gaps) > DP_GRAD_TOL or \
            tiny["grad_errs"][-1][0] > DP_GRAD_TOL:
        raise RuntimeError("dp gloo: 2 ranks differ from one device beyond "
                           "%g on the tiny net" % DP_GRAD_TOL)
    if first_gap > DP_GRAD_TOL or \
            r0["gap"] > DP_GAP_RATIO * r0["perm_gap"] or r0["tensors_over"]:
        raise RuntimeError("dp gloo: full width, first loss gap %g, gradient "
                           "gap %g against %g reordered, tensors over their "
                           "limit %s" % (first_gap, r0["gap"],
                                         r0["perm_gap"],
                                         r0["tensors_over"][:5]))
    if not all(same.values()) or not fit_same:
        raise RuntimeError("dp gloo: the ranks differ: %s, fit %s"
                           % (same, fit_same))
    for r in ranks:
        zero_ratio = r["zero_memory"]["opt_bytes_per_dev"] / \
            r["memory"]["opt_bytes_per_dev"]
        if r["zero_param_mismatches"] or zero_ratio > 0.51 \
                or not r["zero_memory"]["zero"]:
            raise RuntimeError("dp gloo rank %d: ZeRO params off %s, bytes "
                               "ratio %.4f" % (r["rank"],
                                               r["zero_param_mismatches"][:5],
                                               zero_ratio))
        if tuple(r["launches"]) != want or any(r["core_routes"]):
            raise RuntimeError("dp gloo rank %d: launches %s, want %s"
                               % (r["rank"], r["launches"], want))
        f = r["fit"]
        if not f["fused"] or f["mesh_ranks"] != DP_RANKS or \
                tuple(f["launches"]) != fit_want or \
                not all(np.isfinite(list(f["metric"].values()))):
            raise RuntimeError("dp gloo rank %d: Module.fit %s" % (
                r["rank"], f))
    return nccl, [tuple(r["launches"]) for r in ranks]


# Tensor parallelism over the mp axis (mp_training_phase, mp_serving_phase):
# train_mesh(mp=2), dp 1 x mp 2, as 2 gloo ranks sharing the card (NCCL
# refuses two ranks on one device; the kernels are built before they start).
# A rank holds half the heads, half the vocab rows and half of d_ff, and
# attends over MP_ATTN. Rates of a shared card, with every collective
# staged through the host by gloo, are not scaling rates.
MP_RANKS = 2
MP_BATCH, MP_WARMUP, MP_STEPS = (4, 2049), 2, 5
MP_ATTN = (MP_BATCH[0], FULL["n_heads"] // MP_RANKS, MP_BATCH[1] - 1,
           FULL["d_model"] // FULL["n_heads"])
# mp against one device in fp32 (TF32 off): the loss relative; the
# gradients by their relative L2 distance, as the zoo's: the whole gradient
# within MP_RATIO times the gap one device's own gradient shows when every
# parameter element moves by one rounding (MP_NUDGES such moves), and each
# tensor within the larger of MP_GRAD_TOL and MP_RATIO times its own such
# gap. Measured on the CPU at 6 layers (d_model 256): a pre-activation of
# ffn-up within ~1e-7 of 0 flips its ReLU under any change of rounding, and
# one flip moves the gradients of every layer below it by 3e-4 to 1e-3
# (mp against one device and one rounding move alike), so 1e-4 cannot hold
# for every tensor at full width
MP_LOSS_TOL, MP_GRAD_TOL = 1e-5, 1e-4
MP_RATIO, MP_NUDGES = 3.0, 3
# a rank's share of the params, exact from the shapes: 28140544 of 55206912
MP_PARAM_RATIO = 28140544 / 55206912
MP_TIMEOUT = 420
# the shared-prefix trace's counts, exact by construction of the trace
PREFIX_EXACT = dict(prefix_hits=42, prefill_tokens=1093,
                    prefill_tokens_saved=20832)


def _mp_gloo_rank(rank, world, port, out_dir, work):
    """One rank of the mp phases (a spawned process): TF32 off, a gloo
    group with a time limit of its own, then ``_mp_<work>_work``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MP_TIMEOUT))
    try:
        res = globals()["_mp_%s_work" % work](torch, np, fa, rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f, default=float)


def _rel_l2(torch, grads, ref):
    """Each tensor's relative L2 distance to ``ref``, and the whole
    gradient's under the key None."""
    out, num, den = {}, 0.0, 0.0
    for k, g in ref.items():
        d = float(torch.linalg.vector_norm((grads[k] - g).double()))
        n = float(torch.linalg.vector_norm(g.double()))
        out[k] = d / n
        num, den = num + d * d, den + n * n
    out[None] = (num / den) ** 0.5
    return out


def _mp_steps(torch, fa, tpl, step, place, params, tokens):
    """MP_WARMUP steps, then MP_STEPS timed ones (each ends in a device
    sync), the launch and collective counts of the timed ones; returns
    (the dict, the carry)."""
    carry = place(params)
    losses = []
    for _ in range(MP_WARMUP):
        carry, loss = step(carry, tokens)
        losses.append(loss.item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    tpl.reset_counts()
    secs = []
    for _ in range(MP_STEPS):
        t0 = time.perf_counter()
        carry, loss = step(carry, tokens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    n_tok = MP_BATCH[0] * (MP_BATCH[1] - 1)
    return dict(losses=losses, secs=secs, launches=list(_counts(fa)),
                collectives=tpl.counts(),
                tokens_s=n_tok * MP_STEPS / sum(secs),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30), carry


def _mp_train_work(torch, np, fa, rank):
    import torch.distributed as dist

    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl
    from mxnet_tpu_torch.parallel.mesh import train_mesh

    cfg = tfm.TransformerConfig(**FULL)
    cfg32 = tfm.TransformerConfig(**dict(FULL, dtype="float32"))
    opt = dict(name="sgd", learning_rate=0.1, momentum=0.9)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, MP_BATCH)
    res = {"rank": rank}
    ref = None
    if rank == 0:
        # one device, alone on the card while rank 1 waits: the fp32 loss
        # and gradients, the one-rounding yardstick, then the bf16 steps
        loss_fn, _ = tfm.make_loss_fn(cfg32)

        def loss_grads(ps):
            p = {k: v.to(CARD, copy=True).requires_grad_()
                 for k, v in ps.items()}
            loss = loss_fn(p, tokens)
            return loss.item(), dict(zip(p, torch.autograd.grad(
                loss, list(p.values()))))

        ref = loss_grads(params)
        res["yard"] = {}
        for i in range(MP_NUDGES):
            rng = np.random.RandomState(200 + i)
            nudged = loss_grads({k: torch.from_numpy(_zoo_nudged(
                np, v.numpy(), rng)) for k, v in params.items()})[1]
            for k, v in _rel_l2(torch, nudged, ref[1]).items():
                res["yard"][k] = max(res["yard"].get(k, 0.0), v)
            del nudged
        res["one"], carry = _mp_steps(torch, fa, tpl, *tfm.make_train_step(
            cfg, optimizer=opt), params, tokens)
        del carry
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = train_mesh(mp=MP_RANKS)
    loss_fn, _ = tfm.make_loss_fn(cfg32, mesh)
    shards = {k: v.requires_grad_() for k, v in
              tfm.shard_params(params, cfg32, mesh).items()}
    loss = loss_fn(shards, tokens)
    grads = tfm.unshard(dict(zip(shards, torch.autograd.grad(
        loss, list(shards.values())))), cfg32, mesh)
    res["fp32_loss"] = loss.item()
    if ref is not None:
        res["ref_loss"] = ref[0]
        res["gaps"] = _rel_l2(torch, grads, ref[1])
    del loss, grads, ref
    res["param_bytes"] = sum(v.numel() * v.element_size()
                             for v in shards.values())
    res["whole_param_bytes"] = sum(v.numel() * 4 for v in params.values())
    del shards
    gc.collect()
    torch.cuda.empty_cache()
    res["counts"] = tfm.block_collective_counts(cfg, mesh)
    res["mp"], carry = _mp_steps(torch, fa, tpl, *tfm.make_train_step(
        cfg, mesh, optimizer=opt), params, tokens)
    sharded = {k for k, spec in tfm.param_specs(cfg, mesh).items()
               if "mp" in spec}
    res["replicated_digest"] = _param_digest(
        {k: v for k, v in carry[0].items() if k not in sharded})
    per_step = {k: v // MP_STEPS for k, v in res["mp"]["collectives"].items()}
    profiler.mp_reset()
    profiler.mp_record(
        mp_size=MP_RANKS, dp_size=1, group_size=MP_RANKS,
        param_bytes_per_chip=res["param_bytes"],
        live_bytes_per_chip=int(res["mp"]["peak_gib"] * 2 ** 30),
        psum_per_block=res["counts"]["psum_per_block"],
        psum_outside=res["counts"]["psum_outside"],
        all_gather_per_step=per_step["gather_from_mp"],
        collectives_per_step=per_step["reduce_from_mp"]
        + per_step["copy_to_mp"] + per_step["gather_from_mp"])
    res["mp_stats"] = profiler.mp_stats()
    return res


def mp_training_phase(torch, np, fa):
    """The full-width transformer trained over train_mesh(mp=2) on 2 gloo
    ranks sharing the card, against one device in the same call; returns
    each rank's B5, B6, B7 launches in the timed steps."""
    gc.collect()
    torch.cuda.empty_cache()
    ranks, wall = _run_ranks(_mp_gloo_rank, MP_RANKS, MP_TIMEOUT, "mp train",
                             "train")
    r0 = ranks[0]
    one = r0["one"]
    loss_gap = abs(r0["fp32_loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    # JSON keys are strings: the whole gradient's None became "null"
    gaps, yard = r0["gaps"], r0["yard"]
    whole, whole_yard = gaps.pop("null"), yard.pop("null")
    over = sorted((g / max(MP_GRAD_TOL, MP_RATIO * yard[k]), k)
                  for k, g in gaps.items())
    ratio = r0["param_bytes"] / r0["whole_param_bytes"]
    print("mp train: %d gloo ranks sharing one card, train_mesh(mp=%d) = dp "
          "1 x mp %d, %.1f s with start-up; fp32 (TF32 off) batch %s: loss "
          "%.7f vs one device %.7f (relative gap %.3g, tol %g); gradients "
          "unsharded vs one device, relative L2: whole %.4g against %.4g "
          "under %d one-rounding moves (ratio %.2f, limit %g); %d of %d "
          "tensors within %g; each tensor over max(%g, %g x its one-rounding "
          "gap), worst %s; param bytes a rank %d of %d (%.4f, exact %.4f); "
          "collectives of a loss forward %s"
          % (MP_RANKS, MP_RANKS, MP_RANKS, wall, MP_BATCH, r0["fp32_loss"],
             r0["ref_loss"], loss_gap, MP_LOSS_TOL, whole, whole_yard,
             MP_NUDGES, whole / whole_yard, MP_RATIO,
             sum(g <= MP_GRAD_TOL for g in gaps.values()), len(gaps),
             MP_GRAD_TOL, MP_GRAD_TOL, MP_RATIO,
             ", ".join("%.3g at %s (%.3g vs %.3g)" % (r, k, gaps[k], yard[k])
                       for r, k in over[-3:]),
             r0["param_bytes"], r0["whole_param_bytes"], ratio,
             MP_PARAM_RATIO, r0["counts"]))
    for label, run in [("one device", one)] + [
            ("mp rank %d" % r["rank"], r["mp"]) for r in ranks]:
        print("mp train %s, bf16, sgd momentum: losses %s; step times %s s; "
              "%.1f tokens/s; peak memory %.2f GiB; launches B5 %d, B6 %d, "
              "B7 %d in %d steps; collective calls %s"
              % (label, " ".join("%.5f" % x for x in run["losses"]),
                 " ".join("%.4f" % x for x in run["secs"]), run["tokens_s"],
                 run["peak_gib"], *run["launches"], MP_STEPS,
                 run["collectives"]))
    print("mp train: mp_stats %s; replicated params bit for bit on the ranks "
          "%s" % (r0["mp_stats"], len({r["replicated_digest"]
                                       for r in ranks}) == 1))

    want = [FULL["n_layers"] * MP_STEPS] * 3
    if loss_gap > MP_LOSS_TOL or whole > MP_RATIO * whole_yard or \
            over[-1][0] > 1:
        raise RuntimeError("mp train: fp32 loss gap %g, whole gradient gap "
                           "%g against %g, worst tensor %s"
                           % (loss_gap, whole, whole_yard, over[-1]))
    if abs(ratio - MP_PARAM_RATIO) > 1e-12:
        raise RuntimeError("mp train: param bytes ratio %.6f, want %.6f"
                           % (ratio, MP_PARAM_RATIO))
    if r0["counts"]["psum_per_block"] != 2:
        raise RuntimeError("mp train: %s" % r0["counts"])
    if len({r["replicated_digest"] for r in ranks}) != 1:
        raise RuntimeError("mp train: the replicated params differ")
    for label, run in [("one device", one)] + [("rank %d" % r["rank"],
                                                 r["mp"]) for r in ranks]:
        losses = run["losses"]
        if run["launches"] != want or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            raise RuntimeError("mp train %s: launches %s (want %s), losses "
                               "%s" % (label, run["launches"], want, losses))
    return [r["mp"]["launches"] for r in ranks]


def _mp_serve_work(torch, np, fa, rank):
    import torch.distributed as dist

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.serving import GenerateServer
    from mxnet_tpu_torch.serving.generate import GenerativePredictor

    t_ = PREFIX_TRACE
    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0)
    prompts, _ = _serving_prompts(np, cfg.vocab)
    prefix, work = _prefix_workload(cfg.vocab)
    shared = [i for i, w in enumerate(work) if w[2]]
    shapes = (dict(slots=8, page_size=16),
              dict(slots=t_["slots"], page_size=t_["page"]))
    res = {"rank": rank}
    if rank == 0:
        fwd = tfm.make_forward_fn(cfg)
        card = _on_card(torch, params)
        # one device, alone on the card while rank 1 waits
        one = {}
        srv = GenerateServer(cfg, params, **shapes[0])
        try:
            one["burst"] = _serve_burst(torch, np, fa, srv, prompts,
                                        _serving_prompts(np, cfg.vocab)[1],
                                        ())
        finally:
            srv.close()
        srv = GenerateServer(cfg, params, prefix_cache=True, **shapes[1])
        try:
            one["prefix"] = _prefix_run(torch, np, fa, srv, prefix, work,
                                        shared[:2], fwd, card)
        finally:
            srv.close()
        _check_prefix_run(one["prefix"], cfg.n_layers, len(shared), True)
    dist.barrier()
    mesh = train_mesh(mp=MP_RANKS)
    if rank != 0:
        res["follow"] = []
        for kw in shapes:
            pred = GenerativePredictor(cfg, params, mesh=mesh, **kw)
            _reset_counts(fa)
            calls = pred.follow()
            res["follow"].append(dict(calls=calls,
                                      b5=fa.flash_attention.launches,
                                      kv_bytes=pred._kv.numel()
                                      * pred._kv.element_size()))
        return res

    srv = GenerateServer(cfg, params, mesh=mesh, **shapes[0])
    try:
        burst = _serve_burst(torch, np, fa, srv, prompts,
                             _serving_prompts(np, cfg.vocab)[1],
                             range(N_REQUESTS))
        res["sharded_stats"] = srv.predictor.sharded_stats()
    finally:
        srv.close()
    srv = GenerateServer(cfg, params, mesh=mesh, prefix_cache=True,
                         **shapes[1])
    try:
        run = _prefix_run(torch, np, fa, srv, prefix, work,
                          range(len(work)), fwd, card)
    finally:
        srv.close()
    _print_prefix_run("mp prefix on", run, shared)
    _check_prefix_run(run, cfg.n_layers, len(shared), True)
    errs = _served_rows_err(np, fwd, card, prompts, burst["results"],
                            burst["watched"], "mp serve")
    if max(errs) > LOGIT_TOL:
        raise RuntimeError("mp serve: served logits differ from the forward "
                           "by %.4g" % max(errs))
    parted = {
        "burst": _near_tie_pairs(torch, np, fwd, card, [
            (p, a["tokens"], b["tokens"]) for p, a, b in zip(
                prompts, burst["results"], one["burst"]["results"])],
            "mp serve vs one device"),
        "prefix": _near_tie_pairs(torch, np, fwd, card, [
            (w[1], a["tokens"], b["tokens"]) for w, a, b in zip(
                work, run["results"], one["prefix"]["results"])],
            "mp prefix vs one device")}
    exact = {k: run["stats"][k] for k in PREFIX_EXACT}
    if exact != PREFIX_EXACT or exact != {
            k: one["prefix"]["stats"][k] for k in PREFIX_EXACT}:
        raise RuntimeError("mp prefix: counts %s, want %s (one device %s)"
                           % (exact, PREFIX_EXACT, one["prefix"]["stats"]))

    def summary(b, p):
        calls = {k: sorted(v) for k, v in b["call_s"].items()}
        return dict(tokens_s=b["tokens"] / b["wall"], wall=b["wall"],
                    prefill_ms=calls["prefill"][len(calls["prefill"]) // 2]
                    * 1e3,
                    decode_ms=calls["decode"][len(calls["decode"]) // 2]
                    * 1e3,
                    ttft_p50_ms=b["stats"]["ttft_p50_ms"],
                    ttft_p99_ms=b["stats"]["ttft_p99_ms"],
                    prefills=b["stats"]["prefills"], b5=b["launches"],
                    prefix_wall=p["wall"], prefix_b5=p["launches"],
                    prefix_ttft_p50_ms=_pctl([r["ttft_s"] for r in
                                              p["results"]], 0.5) * 1e3,
                    prefix_ttft_p99_ms=_pctl([r["ttft_s"] for r in
                                              p["results"]], 0.99) * 1e3)

    res.update(mp=summary(burst, run), one=summary(one["burst"],
                                                   one["prefix"]),
               worst_err=max(errs), rows=len(errs) * NEW_TOKENS,
               prefix_errs=max(run["errs"]), exact=exact,
               parted={k: len(v) for k, v in parted.items()})
    return res


def mp_serving_phase(torch, np, fa):
    """GenerateServer over GenerativePredictor(mesh=train_mesh(mp=2)) on 2
    gloo ranks sharing the card (rank 0 leads, rank 1 follows): the
    serving workload, then the shared-prefix trace with the cache on,
    against one device in the same call; returns each rank's B5 launches
    (the leader's timed burst, the follower's whole run of the burst's
    predictor)."""
    gc.collect()
    torch.cuda.empty_cache()
    ranks, wall = _run_ranks(_mp_gloo_rank, MP_RANKS, MP_TIMEOUT, "mp serve",
                             "serve")
    lead, follower = ranks
    st = lead["sharded_stats"]
    print("mp serve: %d gloo ranks sharing one card, %.1f s with start-up; "
          "sharded_stats %s; every served row of %d requests (%d rows) vs "
          "the one-device forward: worst %.4f (tol %g); prefix trace rows "
          "worst %.4f; prefix counts %s; chains parted from one device's at "
          "near-ties %s" % (MP_RANKS, wall, st, N_REQUESTS, lead["rows"],
                            lead["worst_err"], LOGIT_TOL,
                            lead["prefix_errs"], lead["exact"],
                            lead["parted"]))
    for label in ("mp", "one"):
        m = lead[label]
        print("mp serve %s: %.1f tokens/s (%.3f s wall), TTFT p50 %.1f ms p99 "
              "%.1f ms, median call (host clock) prefill %.2f ms, decode "
              "%.2f ms, %d prefills, B5 %d; prefix trace (cache on) %.3f s "
              "wall, TTFT p50 %.2f ms p99 %.2f ms, B5 %d"
              % ("mp=2 leader" if label == "mp" else "one device",
                 m["tokens_s"], m["wall"], m["ttft_p50_ms"], m["ttft_p99_ms"],
                 m["prefill_ms"], m["decode_ms"], m["prefills"], m["b5"],
                 m["prefix_wall"],
                 m["prefix_ttft_p50_ms"], m["prefix_ttft_p99_ms"],
                 m["prefix_b5"]))
    for i, f in enumerate(follower["follow"]):
        print("mp serve follower, predictor %d: calls %s, B5 launches %d, KV "
              "bytes %d" % (i, f["calls"], f["b5"], f["kv_bytes"]))
    if st["kv_bytes_per_chip"] * MP_RANKS != st["kv_bytes_total"] or \
            follower["follow"][0]["kv_bytes"] != st["kv_bytes_per_chip"]:
        raise RuntimeError("mp serve: KV bytes a rank %s" % st)
    for f in follower["follow"]:
        if f["b5"] != FULL["n_layers"] * f["calls"]["prefill"]:
            raise RuntimeError("mp serve follower: B5 %d for %d prefills"
                               % (f["b5"], f["calls"]["prefill"]))
    return [lead["mp"]["b5"], follower["follow"][0]["b5"]]


# Module.fit on the image-classification zoo: the builders of
# mxnet_tpu_torch/models at full ImageNet width, fp32 (TF32 off), through the
# nn ops (cuDNN and cuBLAS: no hand-written kernel lies on this path, so B1-B7
# launch 0 times here). One batch repeated ZOO_COPIES times: a warm-up batch,
# then the timed ones, so the loss must fall.
ZOO_NETS = (("alexnet", {}), ("vgg", dict(num_layers=16)),
            ("inception-bn", {}), ("mobilenet", dict(multiplier=1.0)),
            ("resnext", dict(num_layers=50, num_group=32)))
ZOO_SHAPE, ZOO_CLASSES, ZOO_BATCH = (3, 224, 224), 1000, 32
ZOO_MNIST = (("lenet", {}), ("mlp", {}))
ZOO_MNIST_SHAPE, ZOO_MNIST_CLASSES, ZOO_MNIST_BATCH = (1, 28, 28), 10, 64
ZOO_COPIES = 5
ZOO_OPT = dict(learning_rate=0.01, momentum=0.9, wd=1e-4)
# card vs CPU. The networks that draw nothing: the first batch's loss
# within ZOO_TOL, and the gradients as close to the CPU's as the card's own
# gradients move when every image and parameter element moves by one
# rounding (ZOO_NUDGES such moves; the whole gradient's relative L2 gap and
# each tensor's within ZOO_RATIO times theirs): at Xavier init these fp32
# gradients are ill-conditioned (full-width ResNet-50 gradients move 2-4%
# under any reordering of their sums), so the 1e-4 bar of each tensor is printed and
# not held. The networks with dropout: the logits of an inference forward
# within ZOO_TOL of the largest, and each dropout layer's keep rate in one
# training forward within ZOO_SIGMAS standard deviations of 1 - p. These
# run at ZOO_CHECK_BATCH: the CPU's side of them is most of the phase.
ZOO_NO_RNG = ("inception-bn", "mobilenet", "resnext")
ZOO_CHECK_BATCH = 8
ZOO_TOL = 1e-4
ZOO_RATIO, ZOO_NUDGES = 3.0, 3
ZOO_SIGMAS = 5.0
# one RNN op at PTB-medium size: (T, N, I) = (35, 32, 650), 650 hidden, 2
# layers, lstm; p = 0 held card vs CPU, p = 0.5 timed
ZOO_RNN = dict(seq=35, batch=32, size=650, layers=2)


def _zoo_batch(np, shape, classes, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, classes, (n,)).astype(np.float32))


def _zoo_ce(np, probs, y):
    return float(-np.log(probs[np.arange(len(y)), y.astype(int)]
                         + 1e-12).mean())


def _zoo_fit(torch, np, mx, network, kw, shape, classes, n):
    """``Module.fit`` of one network on the card; its per-batch times and
    losses, peak memory and a profiled batch."""
    from mxnet_tpu_torch import models

    gc.collect()
    torch.cuda.empty_cache()
    sym = models.get_symbol(network, num_classes=classes, **kw)
    x, y = _zoo_batch(np, shape, classes, n, 0)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    it = mx.io.NDArrayIter(np.concatenate([x] * ZOO_COPIES),
                           np.concatenate([y] * ZOO_COPIES), batch_size=n)
    per, last = [], {}

    def on_batch(_param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        per.append((now - last["t"],
                    _zoo_ce(np, mod.get_outputs()[0].asnumpy(), y)))
        last["t"] = time.perf_counter()

    mx.random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last["t"] = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=ZOO_OPT,
            initializer=mx.init.Xavier(), batch_end_callback=on_batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    it.reset()
    data_batch = next(iter(it))

    def one_batch():
        mod.forward_backward(data_batch)
        mod.update()

    prof = {}
    _device_profile(torch, one_batch, top=3, stats=prof)
    secs = sorted(p[0] for p in per[1:])
    med = secs[len(secs) // 2]
    row = dict(network=network, batch=n, s_batch=med, images_s=n / med,
               first_s=per[0][0], peak_gib=peak / 2 ** 30,
               busy_ms=prof.get("busy_ms"), wall_ms=prof.get("wall_ms"),
               losses=[p[1] for p in per])
    print("model zoo: %s%s batch %d: %.4f s a batch (median of %d, range "
          "%.4f-%.4f; first with its set-up %.3f s), %.1f images/s, peak "
          "memory %.2f GiB, a profiled batch busy %s of %s ms; loss %s"
          % (network, "".join(" %s=%s" % kv for kv in kw.items()), n, med,
             len(secs), secs[0], secs[-1], per[0][0], n / med,
             peak / 2 ** 30, "%.1f" % prof["busy_ms"] if prof else "n/a",
             "%.1f" % prof["wall_ms"] if prof else "n/a",
             " ".join("%.5f" % p[1] for p in per)))
    del mod
    if not all(math.isfinite(p[1]) for p in per) or \
            not per[-1][1] < per[0][1]:
        raise RuntimeError("model zoo: %s loss did not fall: %s"
                           % (network, row["losses"]))
    return row


def _zoo_params(np, mx, sym, shapes):
    """Xavier weights from seed 0 (host draws: the same on any device)."""
    ex = sym.simple_bind(mx.cpu(), grad_req="null", **shapes)
    mx.random.seed(0)
    init = mx.init.Xavier()
    out = {}
    for d in (ex.arg_dict, ex.aux_dict):
        for name, arr in d.items():
            if name not in shapes:
                init(mx.init.InitDesc(name), arr)
                out[name] = arr.asnumpy()
    return out


def _zoo_nudged(np, a, rng):
    return (a * (1 + rng.choice([-1.0, 1.0], a.shape) * 2.0 ** -23)) \
        .astype(np.float32)


def _zoo_grads_vs_cpu(np, mx, network, kw):
    """Loss and gradients of one training forward_backward, card vs CPU,
    with the card's one-rounding yardstick."""
    from mxnet_tpu_torch import models

    sym = models.get_symbol(network, num_classes=ZOO_CLASSES, **kw)
    n = ZOO_CHECK_BATCH
    x, y = _zoo_batch(np, ZOO_SHAPE, ZOO_CLASSES, n, 1)
    shapes = dict(data=(n,) + ZOO_SHAPE, softmax_label=(n,))
    params = _zoo_params(np, mx, sym, shapes)

    def run(ctx, nudge=None):
        rng = None if nudge is None else np.random.RandomState(nudge)
        ex = sym.simple_bind(ctx, **shapes)
        for d in (ex.arg_dict, ex.aux_dict):
            for name, arr in d.items():
                v = {"data": x, "softmax_label": y}.get(name)
                v = params[name] if v is None else v
                if rng is not None and name != "softmax_label":
                    v = _zoo_nudged(np, v, rng)
                arr[:] = v
        ex.forward_backward()
        return (_zoo_ce(np, ex.outputs[0].asnumpy(), y),
                {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if k not in shapes})

    cpu_ce, cpu = run(mx.cpu())
    card_ce, card = run(mx.gpu(0))
    nudged = [run(mx.gpu(0), 200 + i)[1] for i in range(ZOO_NUDGES)]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    def whole(a, b):
        return float(np.sqrt(sum(float(((a[k] - b[k]) ** 2).sum())
                                 for k in b)
                             / sum(float((v ** 2).sum())
                                   for v in b.values())))

    floor = 1e-2 * max(float(np.abs(g).max()) for g in cpu.values())
    own = max((float(np.abs(card[k] - g).max())
               / max(float(np.abs(g).max()), floor), k)
              for k, g in cpu.items())
    loss_err = abs(card_ce - cpu_ce) / abs(cpu_ce)
    gap, yard = whole(card, cpu), max(whole(g, card) for g in nudged)
    worst = max((rel(card[k], g), k) for k, g in cpu.items())
    tyard = max(rel(g[k], card[k]) for g in nudged for k in card)
    print("model zoo card vs cpu: %s, %d gradients: first loss %.6f vs "
          "%.6f (relative %.3g, tol %g); the worst tensor %.3g of its "
          "largest at %s (the 1e-4 bar, not held); whole gradient relative "
          "L2 %.4g against %.4g under %d one-rounding moves (ratio %.2f, "
          "limit %g); worst tensor %.4g at %s against %.4g (ratio %.2f)"
          % (network, len(cpu), card_ce, cpu_ce, loss_err, ZOO_TOL, own[0],
             own[1], gap, yard, ZOO_NUDGES, gap / max(yard, 1e-30),
             ZOO_RATIO, worst[0], worst[1], tyard,
             worst[0] / max(tyard, 1e-30)))
    if loss_err > ZOO_TOL or gap > ZOO_RATIO * yard or \
            worst[0] > max(ZOO_RATIO * tyard, ZOO_TOL):
        raise RuntimeError("model zoo: %s card vs cpu out of bounds"
                           % network)


def _zoo_dropout_checks(np, mx, network, kw):
    """The logits of an inference forward, card vs CPU, and the keep rate
    of each dropout layer in one training forward on the card."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.ops import registry

    sym = models.get_symbol(network, num_classes=ZOO_CLASSES, **kw)
    logits = sym.get_internals()["fc8_output"]
    n = ZOO_CHECK_BATCH
    x, y = _zoo_batch(np, ZOO_SHAPE, ZOO_CLASSES, n, 2)
    shapes = dict(data=(n,) + ZOO_SHAPE)
    params = _zoo_params(np, mx, logits, shapes)
    outs = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        ex = logits.simple_bind(ctx, grad_req="null", **shapes)
        for name, arr in ex.arg_dict.items():
            arr[:] = x if name == "data" else params[name]
        ex.forward(is_train=False)
        outs.append(ex.outputs[0].asnumpy())
        del ex
    err = float(np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max())

    op = registry.get("Dropout")
    orig, kept = op.fn, []

    def counting(gen, data, **attrs):
        out = orig(gen, data, **attrs)
        if attrs.get("__is_train__"):
            kept.append((int((out[1] != 0).sum()), out[1].numel(),
                         1.0 - attrs.get("p", 0.5)))
        return out

    ex = sym.simple_bind(mx.gpu(0), grad_req="null", softmax_label=(n,),
                         **shapes)
    for name, arr in ex.arg_dict.items():
        arr[:] = {"data": x, "softmax_label": y}.get(name, params.get(name))
    op.fn = counting
    try:
        mx.random.seed(0)
        ex.forward(is_train=True)
        ex.outputs[0].asnumpy()
    finally:
        op.fn = orig
    del ex
    sig = [abs(k / m - q) / math.sqrt(q * (1 - q) / m) for k, m, q in kept]
    print("model zoo card vs cpu: %s inference logits within %.3g of the "
          "largest (tol %g); keep rates %s of %s in one training forward, "
          "%s sigma (limit %g)"
          % (network, err, ZOO_TOL,
             " ".join("%.5f" % (k / m) for k, m, _q in kept),
             " ".join("%.2f" % q for _k, _m, q in kept),
             " ".join("%.2f" % v for v in sig), ZOO_SIGMAS))
    if err > ZOO_TOL or len(kept) != 2 or max(sig) > ZOO_SIGMAS:
        raise RuntimeError("model zoo: %s logits or dropout keep rate out "
                           "of bounds" % network)


def _zoo_rnn(torch, np, mx):
    """``nd.RNN`` (lstm, 2 layers) under autograd, card vs CPU at p = 0,
    then timed at p = 0.5 in training."""
    from mxnet_tpu_torch.ops.rnn import param_size

    c = ZOO_RNN
    t, n, h, layers = c["seq"], c["batch"], c["size"], c["layers"]
    rng = np.random.RandomState(3)
    host = [rng.randn(t, n, h).astype(np.float32),
            rng.uniform(-0.07, 0.07, param_size("lstm", h, layers, False, h))
            .astype(np.float32),
            (0.1 * rng.randn(layers, n, h)).astype(np.float32),
            (0.1 * rng.randn(layers, n, h)).astype(np.float32)]
    cots = [rng.randn(t, n, h).astype(np.float32),
            rng.randn(layers, n, h).astype(np.float32),
            rng.randn(layers, n, h).astype(np.float32)]
    attrs = dict(state_size=h, num_layers=layers, mode="lstm",
                 state_outputs=True)

    def run(ctx, p, train=True):
        arrs = [mx.nd.array(v, ctx=ctx) for v in host]
        for a in arrs:
            a.attach_grad()
        with mx.autograd.record(train_mode=train):
            outs = mx.nd.RNN(*arrs, p=p, **attrs)
        mx.autograd.backward(outs, [mx.nd.array(g, ctx=ctx) for g in cots])
        return [o.asnumpy() for o in outs] + [a.grad.asnumpy()
                                              for a in arrs]

    cpu, card = run(mx.cpu(), 0.0), run(mx.gpu(0), 0.0)
    names = ("out", "h", "c", "d data", "d parameters", "d state",
             "d state_cell")
    errs = [(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)), nm)
            for nm, a, b in zip(names, card, cpu)]
    secs = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(mx.gpu(0), 0.5)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    secs = sorted(secs[1:])
    med = secs[len(secs) // 2]
    print("model zoo rnn: lstm T %d N %d I=H %d, %d layers: card vs cpu at "
          "p=0 worst %.3g at %s (tol %g); p=0.5 training forward + backward "
          "%.4f s (median of %d, range %.4f-%.4f), %.0f tokens/s"
          % (t, n, h, layers, max(errs)[0], max(errs)[1], ZOO_TOL, med,
             len(secs), secs[0], secs[-1], t * n / med))
    if max(errs)[0] > ZOO_TOL:
        raise RuntimeError("model zoo: the RNN on the card differs from "
                           "the CPU's")
    return med


def model_zoo_fit_phase(torch, np, fa, fb):
    """``Module.fit`` on the image-classification builders at full width
    and lenet/mlp at MNIST shape, the card-vs-CPU checks and one RNN op;
    returns the launches of B5, B6, B7, B1, B2 and B3 meanwhile (0: no
    hand-written kernel lies on this path)."""
    import mxnet_tpu_torch as mx

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("model zoo: TF32 must be off for fp32")
    before = _counts(fa) + _fb_counts(fb)
    t0 = time.perf_counter()
    rows = [_zoo_fit(torch, np, mx, net, kw, ZOO_SHAPE, ZOO_CLASSES,
                     ZOO_BATCH) for net, kw in ZOO_NETS]
    rows += [_zoo_fit(torch, np, mx, net, kw, ZOO_MNIST_SHAPE,
                      ZOO_MNIST_CLASSES, ZOO_MNIST_BATCH)
             for net, kw in ZOO_MNIST]
    launches = tuple(a - b for a, b in zip(_counts(fa) + _fb_counts(fb),
                                           before))
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for net, kw in ZOO_NETS:
        if net in ZOO_NO_RNG:
            _zoo_grads_vs_cpu(np, mx, net, kw)
        else:
            _zoo_dropout_checks(np, mx, net, kw)
        gc.collect()
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _zoo_rnn(torch, np, mx)
    print("model zoo: the fits %.1f s, the card-vs-CPU checks %.1f s, the "
          "RNN %.1f s" % (t1 - t0, t2 - t1, time.perf_counter() - t2))
    print("model zoo: %s" % json.dumps([
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in r.items() if k != "losses"} for r in rows]))
    if any(launches):
        raise RuntimeError("model zoo: hand-written kernels launched %s"
                           % (launches,))
    return launches


# The PTB-medium LSTM language model (Zaremba, Sutskever & Vinyals 2014,
# arXiv:1409.2329, section 4: vocabulary 10000, 650 wide, 2 layers, 35
# unrolled steps, batch 20, dropout 0.5, SGD at learning rate 1.0, uniform
# init in +-0.05) built as examples/rnn/lstm_bucketing.py's lstm_lm_sym
# (Embedding -> swapaxes -> RNN(lstm) -> swapaxes -> Reshape ->
# FullyConnected -> SoftmaxOutput) with one bucket and a plain Module,
# through the tensor ops of item 7b and the nn ops (cuBLAS, no hand-written
# kernel: B1-B7 launch 0 times here). The corpus is synthetic: a Zipf
# stream over the vocabulary from a numpy seed (no PTB file in the repo).
# The loss is a per-token mean (rescale_grad 1/(batch*35)), as the paper's.
LM = dict(vocab=10000, embed=650, hidden=650, layers=2, seq=35, batch=20)
LM_P = 0.5
LM_LR = 1.0
LM_BATCHES = 5                # one warm-up, four timed
LM_INIT = 0.05
LM_STATES = ("lstm_state", "lstm_state_cell")   # zero, not trained
LM_CHECK_BATCH = 4            # card vs CPU, p = 0
LM_TOL = 1e-4
LM_RATIO, LM_NUDGES = 3.0, 3
# serving: a next-token graph (Embedding -> SequenceMask -> RNN ->
# SequenceLast -> FullyConnected -> softmax -> topk) through AOTPredictor;
# 40 prompts of 5..35 tokens, padded to 35, in requests of these sizes
# (the 3 fills a bucket of 4 partly)
LM_LADDER = (1, 4, 16)
LM_REQUESTS = (16, 16, 4, 3, 1)
LM_TOPK = 5
LM_TIE = 1e-6


def lm_symbol(mx, vocab, num_hidden, num_embed, num_layers, p=0.0):
    """``lstm_lm_sym`` of examples/rnn/lstm_bucketing.py (its ``seq_len``
    argument is unused there), with ``RNN``'s dropout ``p``; ``mx`` is
    either package."""
    data = mx.sym.var("data")
    label = mx.sym.var("softmax_label")
    embed = mx.sym.Embedding(data=data, input_dim=vocab,
                             output_dim=num_embed, name="embed")
    rnn = mx.sym.RNN(data=mx.sym.swapaxes(embed, dim1=0, dim2=1),
                     state_size=num_hidden, num_layers=num_layers,
                     mode="lstm", name="lstm", **({"p": p} if p else {}))
    hidden = mx.sym.Reshape(mx.sym.swapaxes(rnn, dim1=0, dim2=1),
                            shape=(-1, num_hidden))
    pred = mx.sym.FullyConnected(data=hidden, num_hidden=vocab, name="pred")
    label = mx.sym.Reshape(label, shape=(-1,))
    return mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def lm_next_token_symbol(mx, vocab, num_hidden, num_embed, num_layers,
                         k=LM_TOPK):
    """The next token's top ``k`` (probabilities, ids) after each padded
    prompt: inputs lead with the batch (``data`` (N, T), ``sequence_length``
    (N,)), as ``AOTPredictor`` rebinds the leading axis; the parameter
    names are ``lm_symbol``'s."""
    length = mx.sym.var("sequence_length")
    embed = mx.sym.Embedding(data=mx.sym.var("data"), input_dim=vocab,
                             output_dim=num_embed, name="embed")
    embed = mx.sym.SequenceMask(embed, length, use_sequence_length=True,
                                axis=1)
    rnn = mx.sym.RNN(data=mx.sym.swapaxes(embed, dim1=0, dim2=1),
                     state_size=num_hidden, num_layers=num_layers,
                     mode="lstm", name="lstm")
    last = mx.sym.SequenceLast(rnn, length, use_sequence_length=True,
                               axis=0)
    pred = mx.sym.FullyConnected(data=last, num_hidden=vocab, name="pred")
    return mx.sym.topk(mx.sym.softmax(pred), k=k, ret_typ="both")


def lm_params(np, sym, batch, seq, seed=0):
    """Every parameter uniform in +-LM_INIT from a numpy seed, the RNN
    states zero (host arrays: the same on any device)."""
    shapes, _, _ = sym.infer_shape(data=(batch, seq),
                                   softmax_label=(batch, seq))
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        out[name] = np.zeros(shape, np.float32) if name in LM_STATES else \
            rng.uniform(-LM_INIT, LM_INIT, shape).astype(np.float32)
    return out


def lm_corpus(np, rows, seq, vocab, seed=1):
    """``(data, label)`` of ``rows`` windows of a Zipf token stream, the
    label the next token."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    stream = rng.choice(vocab, rows * seq + 1, p=p / p.sum())
    x = stream[:-1].reshape(rows, seq).astype(np.float32)
    y = stream[1:].reshape(rows, seq).astype(np.float32)
    return x, y


def _lm_loss(torch, probs, label):
    """The mean cross-entropy of (rows, vocab) probabilities on the card
    (one scalar to the host)."""
    t = label.reshape(-1).long()
    return float(-torch.log(probs.gather(1, t[:, None]) + 1e-12).mean())


def _lm_fit(torch, np, mx):
    """``Module.fit`` of the full-width LM on the card: per-batch times and
    losses, a profiled batch, peak memory; returns the trained params."""
    c = LM
    sym = lm_symbol(mx, c["vocab"], c["hidden"], c["embed"], c["layers"],
                    p=LM_P)
    params = lm_params(np, sym, c["batch"], c["seq"])
    x, y = lm_corpus(np, c["batch"] * LM_BATCHES, c["seq"], c["vocab"])
    it = mx.io.NDArrayIter(x, y, batch_size=c["batch"])
    mod = mx.mod.Module(sym, context=mx.Context.from_device(CARD),
                        fixed_param_names=list(LM_STATES))
    per, last = [], {}

    def on_batch(_param):
        lbl = torch.from_numpy(y[len(per) * c["batch"]:
                                 (len(per) + 1) * c["batch"]]).to(CARD)
        loss = _lm_loss(torch, mod.get_outputs()[0].tensor, lbl)
        now = time.perf_counter()
        per.append((now - last["t"], loss))
        last["t"] = time.perf_counter()

    mx.random.seed(0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last["t"] = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(learning_rate=LM_LR,
                                  rescale_grad=1.0 / (c["batch"] * c["seq"])),
            initializer=mx.init.Uniform(LM_INIT),
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in params.items()},
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    it.reset()
    data_batch = next(iter(it))

    def one_batch():
        mod.forward_backward(data_batch)
        mod.update()

    prof = {}
    _device_profile(torch, one_batch, top=4, stats=prof)
    secs = sorted(p[0] for p in per[1:])
    med = secs[len(secs) // 2]
    tokens = c["batch"] * c["seq"]
    print("lm fit: PTB-medium LSTM LM (vocab %d, %d wide, %d layers, T %d, "
          "batch %d, p %.1f), fp32, sgd lr %g: %.4f s a batch (median of "
          "%d, range %.4f-%.4f; first with its set-up %.3f s), %.1f "
          "tokens/s, peak memory %.3f GiB, a profiled batch busy %s of %s "
          "ms (%s); loss %s"
          % (c["vocab"], c["hidden"], c["layers"], c["seq"], c["batch"],
             LM_P, LM_LR, med, len(secs), secs[0], secs[-1], per[0][0],
             tokens / med, peak / 2 ** 30,
             "%.1f" % prof["busy_ms"] if prof else "n/a",
             "%.1f" % prof["wall_ms"] if prof else "n/a",
             "busy share %.3f" % (prof["busy_ms"] / prof["wall_ms"])
             if prof else "busy share not measured",
             " ".join("%.5f" % p[1] for p in per)))
    if len(per) != LM_BATCHES or \
            not all(math.isfinite(p[1]) for p in per) or \
            not per[-1][1] < per[0][1] or \
            abs(per[0][1] - math.log(c["vocab"])) > 0.5:
        raise RuntimeError("lm fit: the loss did not start near ln %d and "
                           "fall: %s" % (c["vocab"], [p[1] for p in per]))
    arg, _aux = mod.get_params()
    trained = {k: v.asnumpy() for k, v in arg.items()}
    del mod
    return trained, dict(s_batch=med, tokens_s=tokens / med,
                         peak_gib=peak / 2 ** 30, busy_ms=prof.get("busy_ms"),
                         wall_ms=prof.get("wall_ms"))


def _lm_grads_vs_cpu(np, mx):
    """The first loss and every gradient at batch LM_CHECK_BATCH, p = 0,
    card vs CPU, with the card's one-rounding yardstick (the weights moved
    by one rounding, LM_NUDGES times)."""
    c = LM
    n = LM_CHECK_BATCH
    sym = lm_symbol(mx, c["vocab"], c["hidden"], c["embed"], c["layers"])
    params = lm_params(np, sym, n, c["seq"], seed=2)
    x, y = lm_corpus(np, n, c["seq"], c["vocab"], seed=3)
    shapes = dict(data=(n, c["seq"]), softmax_label=(n, c["seq"]))

    def run(ctx, nudge=None):
        rng = None if nudge is None else np.random.RandomState(nudge)
        ex = sym.simple_bind(ctx, **shapes)
        for name, arr in ex.arg_dict.items():
            v = {"data": x, "softmax_label": y}.get(name)
            if v is None:
                v = params[name]
                if rng is not None and name not in LM_STATES:
                    v = _zoo_nudged(np, v, rng)
            arr[:] = v
        ex.forward_backward()
        probs = ex.outputs[0].asnumpy()
        ce = float(-np.log(probs[np.arange(n * c["seq"]),
                                 y.reshape(-1).astype(int)] + 1e-12).mean())
        return ce, {k: g.asnumpy() for k, g in ex.grad_dict.items()
                    if k not in shapes and k not in LM_STATES}

    cpu_ce, cpu = run(mx.cpu())
    card_ce, card = run(mx.Context.from_device(CARD))
    nudged = [run(mx.Context.from_device(CARD), 300 + i)[1] for i in range(LM_NUDGES)]
    _lm_check(np, "lm", "batch %d, p=0" % n, cpu_ce, card_ce, cpu, card,
              nudged)


def _lm_check(np, label, what, cpu_ce, card_ce, cpu, card, nudged):
    """The LM yardstick: the card's loss within LM_TOL of the CPU's, and
    its gradients, whole and each tensor, within LM_RATIO times the gap
    that one rounding of the weights gives on the card (``nudged``, one
    gradient map a rounding), floored at LM_TOL."""
    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    def whole(a, b):
        return float(np.sqrt(sum(float(((a[k] - b[k]) ** 2).sum())
                                 for k in b)
                             / sum(float((v ** 2).sum())
                                   for v in b.values())))

    loss_err = abs(card_ce - cpu_ce) / abs(cpu_ce)
    gap, yard = whole(card, cpu), max(whole(g, card) for g in nudged)
    worst = max((rel(card[k], g), k) for k, g in cpu.items())
    tyard = max(rel(g[k], card[k]) for g in nudged for k in card)
    print("%s card vs cpu: %s, %d gradients: first loss %.6f vs "
          "%.6f (relative %.3g, tol %g); whole gradient relative L2 %.4g "
          "against %.4g under %d one-rounding moves of the weights (ratio "
          "%.2f, limit %g); worst tensor %.4g at %s against %.4g (ratio "
          "%.2f)" % (label, what, len(cpu), card_ce, cpu_ce, loss_err,
                     LM_TOL, gap, yard, len(nudged),
                     gap / max(yard, 1e-30), LM_RATIO, worst[0], worst[1],
                     tyard, worst[0] / max(tyard, 1e-30)))
    if loss_err > LM_TOL or gap > max(LM_RATIO * yard, LM_TOL) or \
            worst[0] > max(LM_RATIO * tyard, LM_TOL):
        raise RuntimeError("%s: card vs cpu out of bounds" % label)


def lm_fit_phase(torch, np, fa, fb):
    """The LM through ``Module.fit`` on the card and its card-vs-CPU
    check; returns the trained parameters, the fit's numbers and the
    launches of B5, B6, B7, B1, B2 and B3 meanwhile (0)."""
    import mxnet_tpu_torch as mx

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("lm: TF32 must be off for fp32")
    _reset_counts(fa)
    _reset_fb_counts(fb)
    trained, row = _lm_fit(torch, np, mx)
    launches = _counts(fa) + _fb_counts(fb)
    gc.collect()
    torch.cuda.empty_cache()
    _lm_grads_vs_cpu(np, mx)
    if any(launches):
        raise RuntimeError("lm fit: hand-written kernels launched %s"
                           % (launches,))
    return trained, row, launches


def _lm_prompts(np, n, seed=4):
    """``n`` prompts of 5..35 tokens, padded with 0 to 35."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(5, LM["seq"] + 1, n)
    x, _y = lm_corpus(np, n, LM["seq"], LM["vocab"], seed=seed)
    x[np.arange(LM["seq"])[None, :] >= lens[:, None]] = 0
    return x, lens.astype(np.float32)


def lm_serving_phase(torch, np, fa, fb, trained):
    """The trained LM's next-token top 5 through ``AOTPredictor`` on the
    card against the CPU's; returns the launches of B5-B7, B1-B3 (0)."""
    import warnings

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import AOTPredictor

    c = LM
    sym = lm_next_token_symbol(mx, c["vocab"], c["hidden"], c["embed"],
                               c["layers"])
    params = {k: v for k, v in trained.items() if k not in LM_STATES}
    x, lens = _lm_prompts(np, sum(LM_REQUESTS))
    preds = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the zero-filled RNN states
        for dev in ("cpu", CARD):
            preds[dev] = AOTPredictor(
                sym, params, data_shapes={"data": (1, c["seq"]),
                                          "sequence_length": (1,)},
                ladder=LM_LADDER, device=dev)
    starts = np.cumsum((0,) + LM_REQUESTS)

    def serve(dev):
        out = [preds[dev].predict({"data": x[a:b],
                                   "sequence_length": lens[a:b]})
               for a, b in zip(starts[:-1], starts[1:])]
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]))

    cpu_vals, cpu_idx = serve("cpu")
    serve(CARD)                              # warm-up
    _reset_counts(fa)
    _reset_fb_counts(fb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, idx = serve(CARD)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts(fa) + _fb_counts(fb)
    prof = {}
    _device_profile(torch, lambda: serve(CARD), top=4, stats=prof)
    err = float(np.abs(vals - cpu_vals).max())
    # an index may differ only where the CPU's neighbouring values tie
    near = np.zeros(idx.shape, bool)
    near[:, 1:] |= np.abs(np.diff(cpu_vals, axis=1)) <= LM_TIE
    near[:, :-1] |= np.abs(np.diff(cpu_vals, axis=1)) <= LM_TIE
    bad = (idx != cpu_idx) & ~near
    n = len(x)
    print("lm serving: %d next-token requests (prompts %d-%d tokens) in "
          "requests of %s rows on the ladder %s: %.4f s, %.1f requests/s, "
          "a profiled pass busy %s of %s ms (%s); top-%d values within %.3g "
          "of the CPU's (tol %g), indices equal but %d (all at ties <= %g)"
          % (n, int(lens.min()), int(lens.max()),
             "/".join(str(r) for r in LM_REQUESTS), LM_LADDER, secs,
             n / secs, "%.1f" % prof["busy_ms"] if prof else "n/a",
             "%.1f" % prof["wall_ms"] if prof else "n/a",
             "busy share %.3f" % (prof["busy_ms"] / prof["wall_ms"])
             if prof else "busy share not measured", LM_TOPK, err, LM_TOL,
             int((idx != cpu_idx).sum()), LM_TIE))
    if vals.shape != (n, LM_TOPK) or not np.isfinite(vals).all() or \
            err > LM_TOL or bad.any():
        raise RuntimeError("lm serving: the card's top %d differ from the "
                           "CPU's" % LM_TOPK)
    if any(launches):
        raise RuntimeError("lm serving: hand-written kernels launched %s"
                           % (launches,))
    return dict(requests_s=n / secs, busy_ms=prof.get("busy_ms"),
                wall_ms=prof.get("wall_ms")), launches


# the op sweep of item 7b on the card: tests/test_op_sweep.py's spec of
# each of the 95 names (its input builders, copied: the card's machine has
# no JAX; tests/test_torch_text_models.py holds the copy equal to the
# sweep's), forward and gradient card vs CPU within SWEEP_TOL of each
# tensor's largest magnitude, and the edge cases the two packages follow
# the reference in (indices out of range or negative, ties, the hypot kink)
SWEEP_TOL = 1e-4


def _sweep_u(np, shape, lo=0.5, hi=1.5, seed=0):
    r = np.random.RandomState(hash((shape, lo, hi, seed)) % (2 ** 31))
    return r.uniform(lo, hi, size=shape).astype(np.float32)


def _sweep_n(np, shape, seed=0, scale=1.0):
    r = np.random.RandomState(hash((shape, seed)) % (2 ** 31))
    return (r.randn(*shape) * scale).astype(np.float32)


def _sweep_distinct(np, shape, seed=0, lo=0.5, hi=2.0):
    vals = np.linspace(lo, hi, int(np.prod(shape)), dtype=np.float32)
    np.random.RandomState(seed).shuffle(vals)
    return vals.reshape(shape)


def _sweep_ints(np, shape, hi, seed=0):
    return np.random.RandomState(seed).randint(0, hi, size=shape) \
        .astype(np.int32)


def _sweep_spd(np, b, n, seed=0):
    a = _sweep_n(np, (b, n, n), seed=seed)
    return (np.einsum("bij,bkj->bik", a, a) + 3 * np.eye(n)) \
        .astype(np.float32)


def _sweep_sym(np, b, n, seed=0):
    a = _sweep_n(np, (b, n, n), seed=seed)
    return (0.5 * (a + a.transpose(0, 2, 1))
            + np.diag(np.arange(1.0, n + 1.0)).astype(np.float32))


def sweep_specs(np):
    """name -> (inputs, attrs, indices of the inputs to differentiate or
    None for every float one): tests/test_op_sweep.py's specs of the 95
    names of item 7b."""
    def U(shape, lo=0.5, hi=1.5, seed=0):
        return _sweep_u(np, shape, lo, hi, seed)

    def N(shape, seed=0, scale=1.0):
        return _sweep_n(np, shape, seed, scale)

    d23 = N((2, 3), seed=1)
    seq, lens = N((4, 2, 3), seed=4), np.array([3, 4], dtype=np.float32)
    bl, br = U((2, 1, 4), seed=23), U((1, 3, 4), seed=24)
    tril = np.linalg.cholesky(_sweep_spd(np, 1, 3)).astype(np.float32)
    s = {}
    for name in ("log10", "log2", "log1p", "expm1", "cbrt", "rcbrt",
                 "gamma", "gammaln", "sin", "cos", "sinh", "cosh",
                 "degrees", "radians", "erf", "softsign", "logical_not"):
        s[name] = ([U((2, 3), seed=5)], {}, None)
    s["tan"] = ([U((2, 3), lo=0.1, hi=1.2, seed=6)], {}, None)
    s["arcsin"] = ([U((2, 3), lo=-0.8, hi=0.8, seed=7)], {}, None)
    s["arccos"] = ([U((2, 3), lo=-0.8, hi=0.8, seed=7)], {}, None)
    s["arctan"] = ([N((2, 3), seed=8)], {}, None)
    s["arctanh"] = ([U((2, 3), lo=-0.8, hi=0.8, seed=9)], {}, None)
    s["arcsinh"] = ([N((2, 3), seed=10)], {}, None)
    s["arccosh"] = ([U((2, 3), lo=1.2, hi=2.5, seed=11)], {}, None)
    s["erfinv"] = ([U((2, 3), lo=-0.7, hi=0.7, seed=12)], {}, None)
    s["smooth_l1"] = ([N((2, 3), seed=13)], {"scalar": 1.0}, None)
    s["fix"] = ([U((2, 3), lo=0.2, hi=0.4, seed=14)], {}, None)
    s["_scatter_elemwise_div"] = ([U((2, 3), seed=21), U((2, 3), seed=22)],
                                  {}, None)
    s["_identity_with_attr_like_rhs"] = ([d23, d23], {}, None)
    for name in ("broadcast_hypot", "broadcast_logical_and",
                 "broadcast_logical_or", "broadcast_logical_xor"):
        s[name] = ([bl, br], {}, None)
    s["_hypot_scalar"] = ([U((2, 3), seed=27)], {"scalar": 1.7}, None)
    for name in ("_logical_and_scalar", "_logical_or_scalar",
                 "_logical_xor_scalar"):
        s[name] = ([U((2, 3), seed=28)], {"scalar": 1.0}, None)
    s["nansum"] = ([N((2, 3, 4), seed=29)], {"axis": 1}, None)
    s["nanprod"] = ([U((2, 3), seed=30)], {"axis": 1}, None)
    s["_square_sum"] = ([N((2, 3), seed=33)], {"axis": 1}, None)
    s["cumsum"] = ([N((2, 3), seed=34)], {"axis": 1}, None)
    s["argmax_channel"] = ([_sweep_distinct(np, (2, 5))], {}, None)
    s["reshape_like"] = ([d23, N((3, 2), seed=35)], {}, None)
    s["flip"] = ([N((2, 3), seed=39)], {"axis": 1}, None)
    s["tile"] = ([d23], {"reps": (2, 2)}, None)
    s["repeat"] = ([d23], {"repeats": 2, "axis": 1}, None)
    s["broadcast_axis"] = ([N((1, 3), seed=42)], {"axis": 0, "size": 4},
                           None)
    s["depth_to_space"] = ([N((1, 4, 2, 2), seed=43)], {"block_size": 2},
                           None)
    s["space_to_depth"] = ([N((1, 1, 4, 4), seed=44)], {"block_size": 2},
                           None)
    s["diag"] = ([N((3, 3), seed=45)], {}, None)
    s["slice"] = ([N((3, 4), seed=46)], {"begin": (0, 1), "end": (2, 3)},
                  None)
    s["slice_axis"] = ([N((3, 4), seed=47)],
                       {"axis": 1, "begin": 1, "end": 3}, None)
    s["slice_like"] = ([N((3, 4), seed=48), N((2, 2), seed=49)], {}, None)
    s["SliceChannel"] = ([N((2, 4, 3), seed=50)],
                         {"num_outputs": 2, "axis": 1}, None)
    s["stack"] = ([d23, N((2, 3), seed=52)], {"axis": 1, "num_args": 2},
                  None)
    s["pad"] = ([U((2, 3, 6, 6), seed=3)],
                {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)},
                None)
    s["batch_take"] = ([N((3, 4), seed=55), _sweep_ints(np, (3,), 4)], {},
                       (0,))
    s["pick"] = ([N((3, 4), seed=56),
                  _sweep_ints(np, (3,), 4).astype(np.float32)],
                 {"axis": 1}, (0,))
    s["gather_nd"] = ([N((4, 3), seed=57), _sweep_ints(np, (1, 2), 3)], {},
                      (0,))
    s["scatter_nd"] = ([N((2, 4), seed=58), _sweep_ints(np, (1, 2), 3)],
                       {"shape": (4, 4)}, (0,))
    s["_scatter_set_nd"] = ([N((4, 4), seed=59), N((2,), seed=60),
                             np.array([[0, 1], [1, 2]], np.int32)],
                            {"shape": (4, 4)}, (0, 1))
    s["Embedding"] = ([_sweep_ints(np, (2, 3), 7).astype(np.float32),
                       N((7, 4), seed=61)],
                      {"input_dim": 7, "output_dim": 4}, (1,))
    s["where"] = ([_sweep_ints(np, (2, 3), 2).astype(np.float32), d23,
                   N((2, 3), seed=62)], {}, (1, 2))
    s["_slice_assign"] = ([N((3, 4), seed=63), N((2, 2), seed=64)],
                          {"begin": (0, 1), "end": (2, 3)}, None)
    s["_slice_assign_scalar"] = ([N((3, 4), seed=65)],
                                 {"begin": (0, 1), "end": (2, 3),
                                  "scalar": 2.0}, None)
    s["add_n"] = ([d23, N((2, 3), seed=79)], {}, None)
    for name in ("SequenceLast", "SequenceMask", "SequenceReverse"):
        s[name] = ([seq, lens], {"use_sequence_length": True}, (0,))
    s["SequenceMask"][1]["value"] = 0.0
    s["khatri_rao"] = ([N((2, 3), seed=107), N((4, 3), seed=108)],
                       {"num_args": 2}, None)
    s["_linalg_gemm"] = ([N((2, 3), seed=109), N((3, 4), seed=110),
                          N((2, 4), seed=111)], {}, None)
    s["_linalg_gemm2"] = ([N((2, 3), seed=112), N((3, 4), seed=113)], {},
                          None)
    s["_linalg_syrk"] = ([N((2, 3), seed=114)], {}, None)
    s["_linalg_potrf"] = ([_sweep_spd(np, 1, 3)], {}, None)
    s["_linalg_potri"] = ([tril], {}, None)
    s["_linalg_trmm"] = ([tril, N((1, 3, 3), seed=115)], {}, None)
    s["_linalg_trsm"] = ([tril, N((1, 3, 3), seed=116)], {}, None)
    s["_linalg_sumlogdiag"] = ([_sweep_spd(np, 1, 3)], {}, None)
    s["_linalg_extractdiag"] = ([N((3, 3), seed=117)], {}, None)
    s["_linalg_extracttrian"] = ([N((3, 3), seed=118)], {}, None)
    s["_linalg_makediag"] = ([N((3,), seed=119)], {}, None)
    s["_linalg_syevd"] = ([_sweep_sym(np, 1, 3)], {}, None)
    s["_linalg_gelqf"] = ([N((1, 2, 3), seed=120)], {}, None)
    s["sort"] = ([_sweep_distinct(np, (2, 5))], {"axis": 1}, None)
    s["argsort"] = ([_sweep_distinct(np, (2, 5))], {"axis": 1}, None)
    s["topk"] = ([_sweep_distinct(np, (2, 5))], {"axis": 1, "k": 2}, None)
    s["shuffle"] = ([_sweep_distinct(np, (2, 3))], {}, None)
    s["_zeros"] = ([], {"shape": (2, 3)}, None)
    s["_ones"] = ([], {"shape": (2, 3)}, None)
    s["_full"] = ([], {"shape": (2, 3), "value": 1.5}, None)
    s["_eye"] = ([], {"N": 3}, None)
    s["_arange"] = ([], {"start": 0.0, "stop": 5.0}, None)
    s["cast_storage"] = ([np.array([[0, 1.5], [0, 0]], np.float32)],
                         {"stype": "csr"}, None)
    s["_sparse_retain"] = ([N((4, 3), seed=138),
                            np.array([0, 2], np.float32)], {}, None)
    s["_CrossDeviceCopy"] = ([d23], {}, None)
    return s


def sweep_edge_cases(np):
    """(id, name, inputs, attrs, inputs to differentiate): indices out of
    range and negative, ties, the hypot kink, lengths past the end."""
    rng = np.random.RandomState(9)
    w = rng.randn(5, 3).astype(np.float32)
    tie = np.array([[1.0, 2.0, 1.0, 2.0], [3.0, 3.0, 3.0, 1.0]], np.float32)
    seq = rng.randn(4, 3, 2).astype(np.float32)
    return [
        ("embedding-wrap-nan", "Embedding",
         [np.array([[-1.0, 5.0, 1.7], [7.0, 0.0, -5.0]], np.float32), w],
         {"input_dim": 5, "output_dim": 3}, (1,)),
        ("gather_nd-clamp-wrap", "gather_nd",
         [w[:4], np.array([[9, -1], [0, 7]], np.int32)], {}, (0,)),
        ("batch_take-clamp-wrap", "batch_take",
         [rng.randn(4, 5).astype(np.float32),
          np.array([-1, 7, -9, 2], np.float32)], {}, (0,)),
        ("scatter_nd-drop", "scatter_nd",
         [rng.randn(4, 3).astype(np.float32),
          np.array([[0, -1, 5, 1]], np.int32)], {"shape": (3, 3)}, (0,)),
        ("scatter_set_nd-drop", "_scatter_set_nd",
         [rng.randn(3, 3).astype(np.float32),
          rng.randn(4, 3).astype(np.float32),
          np.array([[0, -1, 5, 1]], np.int32)], {"shape": (3, 3)}, (0, 1)),
        ("sparse_retain-drop", "_sparse_retain",
         [rng.randn(4, 2).astype(np.float32),
          np.array([-1, 9, 1], np.float32)], {}, None),
        ("sequence_last-zero-and-past", "SequenceLast",
         [seq, np.array([0, 9, 2], np.float32)],
         {"use_sequence_length": True}, (0,)),
        ("sequence_reverse-past", "SequenceReverse",
         [seq, np.array([6, 2, 0], np.float32)],
         {"use_sequence_length": True}, (0,)),
        ("argsort-ties-descending", "argsort", [tie],
         {"is_ascend": False}, None),
        ("topk-ties", "topk", [tie], {"k": 3, "ret_typ": "both"}, (0,)),
        ("sort-ties", "sort", [tie], {"is_ascend": False}, (0,)),
        ("hypot-kink", "broadcast_hypot",
         [np.zeros((2, 2), np.float32),
          np.array([[0.0, 1.0], [0.0, -2.0]], np.float32)], {}, (0, 1)),
        ("slice-negative-step", "slice", [rng.randn(5, 4).astype(np.float32)],
         {"begin": (None, 3), "end": (None, 0), "step": (None, -2)}, None),
    ]


def _sweep_run(torch, np, op, inputs, attrs, diff, device, seed=1234):
    """The op's outputs and the gradients of <cotangent, float outputs>
    for ``diff`` (host numpy), on ``device``."""
    tens = [torch.tensor(x, device=device,
                         requires_grad=diff is not None and i in diff)
            for i, x in enumerate(inputs)]
    gen = ()
    if op.needs_rng:
        gen = (torch.Generator(device=device),)
        gen[0].manual_seed(0)
    if not tens:
        with torch.device(device):
            outs = op.fn(*gen, **attrs)
    else:
        outs = op.fn(*gen, *tens, **attrs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = []
    heads = [o for o in outs if o.requires_grad]
    if diff and heads:
        rng = np.random.RandomState(seed)
        cots = [torch.tensor(rng.randn(*o.shape).astype(np.float32),
                             device=device) for o in heads]
        got = torch.autograd.grad(heads, [tens[i] for i in diff], cots,
                                  allow_unused=True)
        grads = [np.zeros(np.shape(inputs[i]), np.float32) if g is None
                 else g.cpu().numpy() for i, g in zip(diff, got)]
    return [o.detach().cpu().numpy() for o in outs], grads


def _sign_normalised(np, name, outs):
    """syevd's rows and gelqf's (L columns, Q rows) with the sign of their
    largest entry made positive: unique only up to it."""
    if name == "_linalg_syevd":
        u = outs[0]
        s = np.sign(np.take_along_axis(u, np.abs(u).argmax(-1)[..., None],
                                       -1))
        return [u * s, outs[1]]
    if name == "_linalg_gelqf":
        q = outs[1]
        s = np.sign(np.take_along_axis(q, np.abs(q).argmax(-1)[..., None],
                                       -1))
        return [outs[0] * np.swapaxes(s, -1, -2), q * s]
    return outs


def _sweep_err(np, a, b):
    """The largest difference over the CPU tensor's largest magnitude
    (NaNs must sit at the same places)."""
    if a.shape != b.shape or a.dtype != b.dtype or \
            not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) \
        if a.size else 0.0


def tensor_sweep_phase(torch, np, fa, fb):
    """Every name of item 7b forward and gradient card vs CPU, plus the
    edge cases; returns the launches of B5-B7, B1-B3 meanwhile (0)."""
    from mxnet_tpu_torch.ops import registry

    _reset_counts(fa)
    _reset_fb_counts(fb)
    cases = [(name, name, *spec) for name, spec in
             sorted(sweep_specs(np).items())] + sweep_edge_cases(np)
    worst, held, grads = [], set(), 0
    for cid, name, inputs, attrs, diff in cases:
        op = registry.get(name)
        if diff is None and not op.nondiff:
            diff = tuple(i for i, x in enumerate(inputs)
                         if x.dtype == np.float32)
        if op.nondiff or name in ("_linalg_syevd", "_linalg_gelqf"):
            diff = None
        cpu = _sweep_run(torch, np, op, inputs, attrs, diff, "cpu")
        card = _sweep_run(torch, np, op, inputs, attrs, diff, CARD)
        if name == "shuffle":
            rows = sorted(map(tuple, card[0][0].tolist()))
            errs = [0.0 if rows == sorted(map(tuple, inputs[0].tolist()))
                    else float("inf")]
        else:
            errs = [_sweep_err(np, a, b) for a, b in
                    zip(_sign_normalised(np, name, card[0]),
                        _sign_normalised(np, name, cpu[0]))]
            errs += [_sweep_err(np, a, b) for a, b in zip(card[1], cpu[1])]
            grads += len(card[1])
        if len(card[0]) != len(cpu[0]) or len(card[1]) != len(cpu[1]):
            errs.append(float("inf"))
        worst.append((max(errs), cid))
        held.add(name)
    worst.sort(reverse=True)
    launches = _counts(fa) + _fb_counts(fb)
    print("tensor sweep: %d of the 95 names of item 7b and %d edge cases, "
          "card vs cpu, %d gradients: worst %.3g at %s (tol %g); next %s"
          % (len(held), len(cases) - len(sweep_specs(np)), grads,
             worst[0][0], worst[0][1], SWEEP_TOL,
             ", ".join("%.2g %s" % w for w in worst[1:4])))
    bad = [w for w in worst if not w[0] <= SWEEP_TOL]
    if len(held) != 95 or bad:
        raise RuntimeError("tensor sweep: out of bounds: %s" % bad[:5])
    if any(launches):
        raise RuntimeError("tensor sweep: hand-written kernels launched %s"
                           % (launches,))
    return launches


# SSD300 (Liu et al. 2016, arXiv:1512.02325; example/ssd's VGG16-reduced
# config of 77.8 VOC07 mAP): 20 VOC classes, 300x300 images, 8732 anchors,
# the training and detection graphs of models/ssd.py at full width, fp32,
# TF32 off. Training: Module.fit with SGD as example/ssd's train.py (lr
# 0.004, momentum 0.9, wd 5e-4) at batch 32 from Xavier weights, on one
# synthetic batch repeated (images from a seed, 1-8 boxes an image padded to
# 8 rows with -1): a warm-up batch and 4 timed ones. Serving: the trained
# weights in AOTPredictor on the ladder (1, 4, 16). cuDNN and cuBLAS carry
# the path: B1-B7 launch 0 times.
SSD_CLASSES = 20
SSD_SHAPE = (3, 300, 300)
SSD_ANCHORS = 8732
SSD_BATCH = 32
SSD_BATCHES = 5               # one warm-up, four timed
SSD_BOXES = 8
SSD_OPT = dict(learning_rate=0.004, momentum=0.9, wd=5e-4)
SSD_CHECK_BATCH = 2           # card vs CPU
SSD_TOL = 1e-4
SSD_RATIO, SSD_NUDGES = 3.0, 3
SSD_LADDER = (1, 4, 16)
SSD_REQUESTS = (16, 4, 1, 3, 2)
SSD_DET_TOL = 1e-5
SSD_IOU_MARGIN = 1e-6


def ssd_batch(np, n, seed=0, classes=None, shape=None, boxes=None):
    """``n`` images (normal noise) and their labels (n, boxes, 5): 1 to
    ``boxes`` boxes of random class, corners in [0, 1], the rest -1
    (SSD_CLASSES, SSD_SHAPE and SSD_BOXES by default)."""
    classes = classes or SSD_CLASSES
    shape = shape or SSD_SHAPE
    boxes = boxes or SSD_BOXES
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    y = np.full((n, boxes, 5), -1.0, np.float32)
    for i in range(n):
        k = rng.randint(1, boxes + 1)
        lo = rng.uniform(0.0, 0.7, (k, 2))
        wh = rng.uniform(0.05, 0.3, (k, 2))
        y[i, :k, 0] = rng.randint(0, classes, k)
        y[i, :k, 1:3] = lo
        y[i, :k, 3:5] = np.minimum(lo + wh, 1.0)
    return x, y


def ssd_ce(torch, cls_prob, cls_label):
    """The mean cross-entropy of ``cls_prob`` (N, C+1, A) at the matched
    classes ``cls_label`` (N, A), example/ssd's MultiBoxMetric's first
    half, as a 0-d tensor."""
    p = cls_prob.gather(1, cls_label.long()[:, None, :])
    return -torch.log(p + 1e-12).mean()


def _ssd_metric(torch, mx):
    """A Module.fit metric keeping each batch's ``ssd_ce`` on the card (the
    outputs are not copied to the host; read once a batch)."""
    class SSDCrossEntropy(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("ssd_ce")
            self.last = None

        def update_dict(self, label, pred):
            outs = list(pred.values())
            self.last = ssd_ce(torch, outs[0].tensor, outs[2].tensor)

    return SSDCrossEntropy()


def _ssd_fit(torch, np, mx):
    """``Module.fit`` of SSD300 on the card: per-batch times and losses, a
    profiled batch, peak memory; returns the trained params and a row."""
    from mxnet_tpu_torch.models import ssd

    gc.collect()
    torch.cuda.empty_cache()
    sym = ssd.get_symbol_train(num_classes=SSD_CLASSES)
    n = SSD_BATCH
    x, y = ssd_batch(np, n)
    it = mx.io.NDArrayIter({"data": np.concatenate([x] * SSD_BATCHES)},
                           {"label": np.concatenate([y] * SSD_BATCHES)},
                           batch_size=n)
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    metric = _ssd_metric(torch, mx)
    per, last = [], {}

    def on_batch(_param):
        loss = float(metric.last)
        now = time.perf_counter()
        per.append((now - last["t"], loss))
        last["t"] = time.perf_counter()

    mx.random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last["t"] = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SSD_OPT,
            initializer=mx.init.Xavier(), eval_metric=metric,
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    it.reset()
    data_batch = next(iter(it))

    def one_batch():
        mod.forward_backward(data_batch)
        mod.update()

    prof = {}
    _device_profile(torch, one_batch, top=6, stats=prof)
    secs = sorted(p[0] for p in per[1:])
    med = secs[len(secs) // 2]
    outs = mod.get_outputs()
    shapes = [tuple(o.shape) for o in outs]
    labels = outs[2].asnumpy()
    row = dict(batch=n, s_batch=med, images_s=n / med, first_s=per[0][0],
               peak_gib=peak / 2 ** 30, busy_ms=prof.get("busy_ms"),
               wall_ms=prof.get("wall_ms"), launches=prof.get("launches"),
               losses=[p[1] for p in per])
    print("ssd fit: SSD300 VGG16-reduced, %d classes, %d anchors, fp32, sgd "
          "lr %g: batch %d, %.4f s a batch (median of %d, range %.4f-%.4f; "
          "first with its set-up %.3f s), %.1f images/s, peak memory %.2f "
          "GiB, a profiled batch busy %s of %s ms (%s), %s launches; "
          "positive anchors %d of %d; cls_prob cross-entropy %s"
          % (SSD_CLASSES, SSD_ANCHORS, SSD_OPT["learning_rate"], n, med,
             len(secs), secs[0], secs[-1], per[0][0], n / med,
             peak / 2 ** 30, "%.1f" % prof["busy_ms"] if prof else "n/a",
             "%.1f" % prof["wall_ms"] if prof else "n/a",
             "busy share %.3f" % (prof["busy_ms"] / prof["wall_ms"])
             if prof else "busy share not measured",
             prof.get("launches", "n/a"), int((labels > 0).sum()),
             labels.size, " ".join("%.5f" % p[1] for p in per)))
    if shapes != [(n, SSD_CLASSES + 1, SSD_ANCHORS), (n, SSD_ANCHORS * 4),
                  (n, SSD_ANCHORS)] or len(per) != SSD_BATCHES or \
            not all(math.isfinite(p[1]) for p in per) or \
            not per[-1][1] < per[0][1]:
        raise RuntimeError("ssd fit: shapes %s, the loss did not fall: %s"
                           % (shapes, row["losses"]))
    arg, _aux = mod.get_params()
    trained = {k: v.asnumpy() for k, v in arg.items()}
    del mod
    return trained, row


def _ssd_vs_cpu(torch, np, mx):
    """The first forward's three outputs and the gradients of one
    forward_backward at batch SSD_CHECK_BATCH, card vs CPU: cls_label
    equal, cls_prob and loc_loss within SSD_TOL of their largest, the
    gradients against the card's one-rounding yardstick (as the zoo's)."""
    from mxnet_tpu_torch.models import ssd

    n = SSD_CHECK_BATCH
    sym = ssd.get_symbol_train(num_classes=SSD_CLASSES)
    x, y = ssd_batch(np, n, seed=1)
    shapes = dict(data=(n,) + SSD_SHAPE, label=(n, SSD_BOXES, 5))
    params = _zoo_params(np, mx, sym, shapes)

    def run(ctx, nudge=None):
        rng = None if nudge is None else np.random.RandomState(nudge)
        ex = sym.simple_bind(ctx, **shapes)
        for name, arr in ex.arg_dict.items():
            v = {"data": x, "label": y}.get(name)
            v = params[name] if v is None else v
            if rng is not None and name != "label":
                v = _zoo_nudged(np, v, rng)
            arr[:] = v
        ex.forward_backward()
        return ([o.asnumpy() for o in ex.outputs],
                {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if k not in shapes})

    cpu_out, cpu = run(mx.cpu())
    card_out, card = run(mx.gpu(0))
    nudged = [run(mx.gpu(0), 400 + i)[1] for i in range(SSD_NUDGES)]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    def whole(a, b):
        return float(np.sqrt(sum(float(((a[k] - b[k]) ** 2).sum())
                                 for k in b)
                             / sum(float((v ** 2).sum())
                                   for v in b.values())))

    out_err = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
               for a, b in zip(card_out[:2], cpu_out[:2])]
    labels_equal = np.array_equal(card_out[2], cpu_out[2])
    gap, yard = whole(card, cpu), max(whole(g, card) for g in nudged)
    worst = max((rel(card[k], g), k) for k, g in cpu.items())
    tyard = max(rel(g[k], card[k]) for g in nudged for k in card)
    print("ssd card vs cpu: batch %d, %d gradients: cls_label %s (%d "
          "positive anchors), cls_prob %.3g and loc_loss %.3g of their "
          "largest (tol %g); whole gradient relative L2 %.4g against %.4g "
          "under %d one-rounding moves (ratio %.2f, limit %g); worst tensor "
          "%.4g at %s against %.4g (ratio %.2f)"
          % (n, len(cpu), "equal" if labels_equal else "DIFFERENT",
             int((cpu_out[2] > 0).sum()), out_err[0], out_err[1], SSD_TOL,
             gap, yard, SSD_NUDGES, gap / max(yard, 1e-30), SSD_RATIO,
             worst[0], worst[1], tyard, worst[0] / max(tyard, 1e-30)))
    if not labels_equal or max(out_err) > SSD_TOL or \
            gap > max(SSD_RATIO * yard, SSD_TOL) or \
            worst[0] > max(SSD_RATIO * tyard, SSD_TOL):
        raise RuntimeError("ssd: card vs cpu out of bounds")


def ssd_fit_phase(torch, np, fa, fb):
    """SSD300 through ``Module.fit`` on the card and its card-vs-CPU
    check; returns the trained params, the fit's row and the launches of
    B5, B6, B7, B1, B2 and B3 meanwhile (0)."""
    import mxnet_tpu_torch as mx

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("ssd: TF32 must be off for fp32")
    _reset_counts(fa)
    _reset_fb_counts(fb)
    trained, row = _ssd_fit(torch, np, mx)
    launches = _counts(fa) + _fb_counts(fb)
    gc.collect()
    torch.cuda.empty_cache()
    _ssd_vs_cpu(torch, np, mx)
    if any(launches):
        raise RuntimeError("ssd fit: hand-written kernels launched %s"
                           % (launches,))
    return trained, row, launches


def _iou_margin(np, det, nms):
    """The smallest |IoU - nms| over pairs of boxes of one class (the
    margin by which a suppression could flip)."""
    b = det[:, 2:6]
    x1, y1, x2, y2 = (b[:, k] for k in range(4))
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    iw = np.maximum(np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1),
                    0)
    ih = np.maximum(np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1),
                    0)
    inter = iw * ih
    union = area[:, None] + area - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-30), 0.0)
    same = det[:, None, 0] == det[None, :, 0]
    return float(np.abs(iou - nms)[same].min())


# the detection graph's outputs served by the timed predictor and read
# for the card-vs-CPU check
SSD_INTERNALS = ("detection", "cls_prob", "multibox_loc_pred",
                 "multibox_anchors")


def _separated_heads(np, params, classes):
    """``params`` with every class head (``cls_pred<i>``) reduced to its
    bias: the weights 0, and group g (one anchor slot of one feature map)
    scoring class g % classes + 1 at the logit 1 + 0.15 g. The anchors of
    a group tie exactly on each device (a stable sort keeps them in index
    order) and the groups' scores lie about 0.01 apart, so the ranking is
    one on both devices; the boxes and the NMS still come from the trained
    network."""
    import re

    heads = sorted((int(m.group(1)), k) for k in params
                   for m in [re.search(r"cls_pred(\d+)_weight$", k)] if m)
    out = dict(params)
    g = 0
    for _i, w in heads:
        b = w[:-len("weight")] + "bias"
        out[w] = np.zeros_like(params[w])
        bias = np.zeros((np.size(params[b]) // (classes + 1), classes + 1),
                        np.float32)
        for slot in range(len(bias)):
            bias[slot, g % classes + 1] = 1.0 + 0.15 * g
            g += 1
        out[b] = bias.reshape(np.shape(params[b]))
    return out


def _det_diff(np, card, cpu):
    """(classes and kept mask equal, largest score or box gap) of two
    (1, A, 6) detections."""
    return (np.array_equal(card[..., 0], cpu[..., 0]),
            float(np.abs(card[..., 1:] - cpu[..., 1:]).max()))


def ssd_detect_phase(torch, np, fa, fb, trained):
    """The trained SSD300's detections through ``AOTPredictor`` on the
    card, timed, serving the detections beside the network's outputs
    (SSD_INTERNALS). One request of the timed predictor is held against
    the CPU in two halves: the network's outputs (cls_prob, loc_pred within
    SSD_DET_TOL of their largest, the anchors equal), and the card's
    MultiBoxDetection against the CPU's on the card's network outputs
    (classes and kept mask equal, scores and boxes within SSD_DET_TOL).
    After 4 steps the classes' probabilities are nearly uniform, so the
    two devices' roundings reorder nearly tied scores: that graph's
    ranking is not comparable between them. So the whole graph is held
    card vs CPU on one request too with the class heads reduced to
    separated biases (``_separated_heads``): the same classes and kept
    mask, scores and boxes within SSD_DET_TOL. Returns a row and the
    launches of B5-B7, B1-B3 (0)."""
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import contrib, registry
    from mxnet_tpu_torch.serving import AOTPredictor

    sym = ssd.get_symbol(num_classes=SSD_CLASSES)
    names = set(sym.list_arguments())
    params = {k: v for k, v in trained.items() if k in names}
    x, _y = ssd_batch(np, sum(SSD_REQUESTS), seed=2)
    shapes = {"data": (1,) + SSD_SHAPE}
    served = AOTPredictor(sym, params, data_shapes=shapes, ladder=SSD_LADDER,
                          device=CARD, output_names=SSD_INTERNALS)
    starts = np.cumsum((0,) + SSD_REQUESTS)

    def serve():
        return np.concatenate([served.predict({"data": x[a:b]})[0]
                               for a, b in zip(starts[:-1], starts[1:])])

    serve()                                  # warm-up
    _reset_counts(fa)
    _reset_fb_counts(fb)
    contrib.nms_rounds[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = serve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rounds = contrib.nms_rounds[0]
    launches = _counts(fa) + _fb_counts(fb)
    prof = {}
    _device_profile(torch, serve, top=4, stats=prof)
    card_det, prob, loc, anc = served.predict({"data": x[:1]})
    cpu = AOTPredictor(sym, params, data_shapes=shapes, ladder=(1,),
                       device="cpu", output_names=SSD_INTERNALS) \
        .predict({"data": x[:1]})
    net_err = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
               for a, b in zip((prob, loc), cpu[1:3])]
    anchors_equal = np.array_equal(anc, cpu[3])
    det_node = sym._entries[0][0]
    cpu_det = registry.get(det_node.op.name).fn(
        *(torch.from_numpy(v) for v in (prob, loc, anc)),
        **det_node.attrs).numpy()
    same, det_err = _det_diff(np, card_det, cpu_det)
    sep = _separated_heads(np, params, SSD_CLASSES)
    whole = [AOTPredictor(sym, sep, data_shapes=shapes, ladder=(1,),
                          device=dev).predict({"data": x[:1]})[0]
             for dev in (CARD, "cpu")]
    whole_same, whole_err = _det_diff(np, *whole)
    kept = card_det[0, :, 0] >= 0
    whole_kept = whole[0][0, :, 0] >= 0
    n = len(x)
    print("ssd detect: %d images in requests of %s on the ladder %s: %.4f s, "
          "%.1f requests/s, %.1f images/s; NMS rounds %d (%.1f an image); a "
          "profiled pass busy %s of %s ms (%s), %s launches; one request of "
          "the timed predictor card vs cpu: cls_prob %.3g and loc_pred %.3g "
          "of their largest, anchors %s; MultiBoxDetection on the card's "
          "outputs: %d of %d boxes kept, classes and kept mask %s, scores "
          "and boxes within %.3g; the whole graph with separated class "
          "heads: %d kept, classes and kept mask %s, scores and boxes within "
          "%.3g (tol %g)"
          % (n, "/".join(str(r) for r in SSD_REQUESTS), SSD_LADDER, secs,
             len(SSD_REQUESTS) / secs, n / secs, rounds, rounds / n,
             "%.1f" % prof["busy_ms"] if prof else "n/a",
             "%.1f" % prof["wall_ms"] if prof else "n/a",
             "busy share %.3f" % (prof["busy_ms"] / prof["wall_ms"])
             if prof else "busy share not measured",
             prof.get("launches", "n/a"), net_err[0], net_err[1],
             "equal" if anchors_equal else "DIFFERENT", int(kept.sum()),
             len(kept), "equal" if same else "DIFFERENT", det_err,
             int(whole_kept.sum()), "equal" if whole_same else "DIFFERENT",
             whole_err, SSD_DET_TOL))
    for flag, card_d, cpu_d, what in (
            (same, card_det, cpu_det, "MultiBoxDetection"),
            (whole_same, whole[0], whole[1], "whole graph")):
        if not flag:
            both = (card_d[0, :, 0] >= 0) | (cpu_d[0, :, 0] >= 0)
            print("ssd detect (%s): smallest |IoU - nms_threshold| among the "
                  "kept boxes of one class %.3g (a flip within %g is a tie)"
                  % (what, _iou_margin(np, cpu_d[0][both], 0.5),
                     SSD_IOU_MARGIN))
    if dets.shape != (n, SSD_ANCHORS, 6) or not np.isfinite(dets).all() or \
            not same or det_err > SSD_DET_TOL or \
            max(net_err) > SSD_DET_TOL or not anchors_equal or \
            not whole_same or whole_err > SSD_DET_TOL or \
            not 0 < whole_kept.sum() < SSD_ANCHORS:
        raise RuntimeError("ssd detect: the card's detections differ from "
                           "the CPU's")
    if any(launches):
        raise RuntimeError("ssd detect: hand-written kernels launched %s"
                           % (launches,))
    return dict(requests_s=len(SSD_REQUESTS) / secs, images_s=n / secs,
                nms_rounds=rounds, busy_ms=prof.get("busy_ms"),
                wall_ms=prof.get("wall_ms"),
                launches=prof.get("launches")), launches


# the op sweep of items 7c and 7d on the card: tests/test_op_sweep.py's
# spec of each of the 31 names (its input builders, copied; held equal by
# tests/test_torch_contrib_ops.py), the 17 of 7d forward and gradient card
# vs CPU (floats within SWEEP_TOL of each tensor's largest magnitude,
# integers and masks equal), plus a full-size MultiBoxDetection, the
# MultiBoxTarget collision and Proposal at its default size; the 14 random names by moments at a fixed seed
# (RANDOM_SIGMAS standard errors of the mean, RANDOM_STD_TOL of the
# standard deviation) and bit for bit across two runs
RANDOM_DRAWS = 20000
RANDOM_SIGMAS = 6.0
RANDOM_STD_TOL = 0.05


def contrib_sweep_specs(np):
    """name -> (inputs, attrs, indices of the inputs to differentiate or
    None): tests/test_op_sweep.py's specs of the 31 names of items 7c and
    7d."""
    def U(shape, lo=0.5, hi=1.5, seed=0):
        return _sweep_u(np, shape, lo, hi, seed)

    def N(shape, seed=0, scale=1.0):
        return _sweep_n(np, shape, seed, scale)

    def f32(a):
        return np.array(a, np.float32)

    anch = f32([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]])
    rpn = {"feature_stride": 4, "scales": (8,), "ratios": (1.0,),
           "rpn_pre_nms_top_n": 4, "rpn_post_nms_top_n": 2,
           "rpn_min_size": 1}
    s = {
        "ROIPooling": ([U((1, 2, 8, 8), seed=86), f32([[0, 1, 1, 6, 6]])],
                       {"pooled_size": (2, 2), "spatial_scale": 1.0}, (0,)),
        "_contrib_PSROIPooling": (
            [U((1, 8, 6, 6), seed=87), f32([[0, 0, 0, 5, 5]])],
            {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 2},
            (0,)),
        "_contrib_DeformablePSROIPooling": (
            [U((1, 8, 6, 6), seed=88), f32([[0, 0, 0, 5, 5]]),
             N((1, 4, 2, 2), seed=89, scale=0.05)],
            {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 2,
             "group_size": 2, "trans_std": 0.1, "no_trans": False}, (0,)),
        "_contrib_DeformableConvolution": (
            [U((1, 2, 5, 5), seed=90), N((1, 18, 5, 5), seed=91, scale=0.05),
             N((3, 2, 3, 3), seed=92, scale=0.3), N((3,), seed=93)],
            {"kernel": (3, 3), "num_filter": 3, "pad": (1, 1)}, (0, 2, 3)),
        "_contrib_ctc_loss": ([N((4, 2, 5), seed=102), f32([[1, 2], [3, 0]])],
                              {}, (0,)),
        "_contrib_fft": ([N((2, 8), seed=121)], {}, None),
        "_contrib_ifft": ([N((2, 16), seed=122)], {}, None),
        "_contrib_count_sketch": (
            [N((2, 8), seed=123), _sweep_ints(np, (8,), 4).astype(np.float32),
             (2 * _sweep_ints(np, (8,), 2, seed=9) - 1).astype(np.float32)],
            {"out_dim": 4}, None),
        "_contrib_quantize": ([U((2, 3), lo=-1, hi=1), f32([-1.0]),
                               f32([1.0])], {}, None),
        "_contrib_dequantize": (
            [(_sweep_ints(np, (2, 3), 255) - 127).astype(np.uint8),
             f32([-1.0]), f32([1.0])], {"out_type": "float32"}, None),
        "_contrib_quantize_2bit": ([N((8,), seed=124), np.zeros(8,
                                                                np.float32)],
                                   {"threshold": 0.5}, None),
        "_contrib_dequantize_2bit": ([np.zeros(4, np.float32)],
                                     {"threshold": 0.5}, None),
        "_contrib_MultiBoxPrior": ([U((1, 3, 4, 4))],
                                   {"sizes": (0.5,), "ratios": (1.0,)}, None),
        "_contrib_MultiBoxTarget": (
            [anch, f32([[[0, 0.1, 0.1, 0.4, 0.4]]]), U((1, 2, 2), seed=125)],
            {}, None),
        "_contrib_MultiBoxDetection": (
            [U((1, 2, 2), seed=126), N((1, 8), seed=127, scale=0.1), anch],
            {}, None),
        "_contrib_Proposal": (
            [U((1, 2, 4, 4), seed=128), N((1, 4, 4, 4), seed=129, scale=0.1),
             f32([[16, 16, 1]])], rpn, None),
        "_contrib_MultiProposal": (
            [U((1, 2, 4, 4), seed=128), N((1, 4, 4, 4), seed=129, scale=0.1),
             f32([[16, 16, 1]])], rpn, None),
    }
    for name in ("_random_uniform", "_random_normal", "_random_exponential",
                 "_random_gamma", "_random_poisson",
                 "_random_negative_binomial",
                 "_random_generalized_negative_binomial"):
        s[name] = ([], {"shape": (3, 4)}, None)
    s["_random_randint"] = ([], {"low": 0, "high": 5, "shape": (3, 4)}, None)
    s["_sample_uniform"] = ([U((3,), lo=0.0, hi=0.3), U((3,), lo=0.5, hi=1.0)],
                            {"shape": (4,)}, None)
    s["_sample_normal"] = ([N((3,), seed=132), U((3,), seed=133)],
                           {"shape": (4,)}, None)
    s["_sample_gamma"] = ([U((3,), seed=134), U((3,), seed=135)],
                          {"shape": (4,)}, None)
    s["_sample_exponential"] = ([U((3,), seed=136)], {"shape": (4,)}, None)
    s["_sample_poisson"] = ([U((3,), seed=137)], {"shape": (4,)}, None)
    s["_sample_multinomial"] = ([U((2, 4), lo=0.1, hi=1.0)], {"shape": (3,)},
                                None)
    return s


def random_moment_cases(np):
    """name -> (inputs, attrs, the mean and standard deviation of each
    parameter row): RANDOM_DRAWS draws a row."""
    n = (RANDOM_DRAWS,)

    def f32(a):
        return np.array(a, np.float32)

    return {
        "_random_uniform": ([], dict(low=-2.0, high=4.0, shape=n),
                            [1.0], [3.0 ** 0.5]),
        "_random_normal": ([], dict(loc=3.0, scale=2.0, shape=n), [3.0],
                           [2.0]),
        "_random_gamma": ([], dict(alpha=3.0, beta=2.0, shape=n), [6.0],
                          [2.0 * 3.0 ** 0.5]),
        "_random_exponential": ([], dict(lam=2.0, shape=n), [0.5], [0.5]),
        "_random_poisson": ([], dict(lam=4.0, shape=n), [4.0], [2.0]),
        # k (1 - p) / p and k (1 - p) / p**2
        "_random_negative_binomial": ([], dict(k=3, p=0.4, shape=n), [4.5],
                                      [11.25 ** 0.5]),
        # mu and mu + alpha mu**2
        "_random_generalized_negative_binomial": (
            [], dict(mu=2.0, alpha=0.5, shape=n), [2.0], [2.0]),
        "_random_randint": ([], dict(low=0, high=5, shape=n), [2.0],
                            [2.0 ** 0.5]),
        "_sample_uniform": ([f32([0.0, 10.0]), f32([1.0, 20.0])],
                            dict(shape=n), [0.5, 15.0],
                            [12.0 ** -0.5, 10.0 * 12.0 ** -0.5]),
        "_sample_normal": ([f32([0.0, 10.0]), f32([1.0, 0.1])],
                           dict(shape=n), [0.0, 10.0], [1.0, 0.1]),
        "_sample_gamma": ([f32([1.0, 4.0]), f32([1.0, 0.5])], dict(shape=n),
                          [1.0, 2.0], [1.0, 1.0]),
        "_sample_exponential": ([f32([1.0, 4.0])], dict(shape=n),
                                [1.0, 0.25], [1.0, 0.25]),
        "_sample_poisson": ([f32([1.0, 6.0])], dict(shape=n), [1.0, 6.0],
                            [1.0, 6.0 ** 0.5]),
        # draws of the classes 0, 1, 2 at 0.1, 0, 0.9
        "_sample_multinomial": ([f32([[0.1, 0.0, 0.9]])], dict(shape=n),
                                [1.8], [0.6]),
    }


def moment_errors(np, draws, mean, std):
    """For each row of ``draws`` (the parameter rows, draws last): its
    mean's distance in standard errors and its standard deviation's
    relative distance."""
    rows = np.asarray(draws, np.float64).reshape(len(mean), -1)
    m = rows.mean(axis=1)
    s = rows.std(axis=1)
    n = rows.shape[1]
    return ([float(abs(a - b) / (c / n ** 0.5)) for a, b, c in
             zip(m, mean, std)],
            [float(abs(a - c) / c) for a, c in zip(s, std)])


def contrib_edge_cases(np):
    """(case id, name, inputs, attrs, diff): the MultiBoxTarget collision
    (two boxes with one best anchor, padded rows after a box whose best
    anchor is anchor 0) and MultiBoxDetection over SSD300's 8732 anchors."""
    from mxnet_tpu_torch.models.ssd import _RATIOS, _SIZES
    from mxnet_tpu_torch.ops import registry

    import torch

    prior = registry.get("_contrib_MultiBoxPrior").fn
    anc = torch.cat([prior(torch.empty(1, 1, f, f), sizes=s, ratios=r,
                           clip=True)
                     for f, s, r in zip((38, 19, 10, 5, 3, 1), _SIZES,
                                        _RATIOS)], 1).numpy()
    rng = np.random.RandomState(11)
    logits = rng.randn(2, SSD_CLASSES + 1, SSD_ANCHORS) * 2
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(2, SSD_ANCHORS * 4) * 0.2).astype(np.float32)
    return [
        ("MultiBoxTarget-collision", "_contrib_MultiBoxTarget",
         list(multibox_collision_case(np)), {}, None),
        ("MultiBoxDetection-8732", "_contrib_MultiBoxDetection",
         [prob, loc, anc], {}, None),
        ("MultiBoxDetection-8732-force", "_contrib_MultiBoxDetection",
         [prob, loc, anc], {"force_suppress": True}, None),
    ]


def multibox_collision_case(np):
    """(anchor, label, cls_pred): in image 0 a box whose best anchor is
    anchor 0 (IoU 1/3, under the 0.5 threshold) followed by padded rows
    (whose best anchor is anchor 0 too: the last write wins, so the box
    loses its forced match), and two boxes whose best anchor is anchor 3
    (the later one keeps it); in image 1 the box after the pads."""
    anc = np.array([[[0.0, 0.0, 0.2, 0.2], [0.3, 0.3, 0.5, 0.5],
                     [0.6, 0.6, 0.8, 0.8], [0.1, 0.5, 0.4, 0.9]]],
                   np.float32)
    pad = [-1.0] * 5
    lab = np.array([
        [[1, 0.0, 0.0, 0.2 * 3 ** 0.5, 0.2 * 3 ** 0.5],
         [0, 0.1, 0.55, 0.4, 0.9], [2, 0.12, 0.5, 0.41, 0.88], pad, pad],
        [pad, pad, [0, 0.6, 0.62, 0.8, 0.8], pad,
         [1, 0.0, 0.0, 0.2 * 3 ** 0.5, 0.2 * 3 ** 0.5]]], np.float32)
    return anc, lab, np.zeros((2, 3, 4), np.float32)


def contrib_sweep_phase(torch, np, fa, fb):
    """Every name of items 7c and 7d on the card: 7d's forward and gradient
    against the CPU's, 7c's by moments and reruns; returns the launches
    of B5-B7, B1-B3 meanwhile (0)."""
    from mxnet_tpu_torch.ops import contrib, registry

    _reset_counts(fa)
    _reset_fb_counts(fb)
    specs = contrib_sweep_specs(np)
    edges = contrib_edge_cases(np)
    cases = [(name, name, *spec) for name, spec in sorted(specs.items())
             if not registry.get(name).needs_rng] + edges
    worst, held, grads = [], set(), 0
    contrib.nms_rounds[0] = 0
    for cid, name, inputs, attrs, diff in cases:
        op = registry.get(name)
        if diff is None and not op.nondiff:
            diff = tuple(i for i, x in enumerate(inputs)
                         if x.dtype == np.float32)
        if op.nondiff:
            diff = None
        cpu = _sweep_run(torch, np, op, inputs, attrs, diff, "cpu")
        card = _sweep_run(torch, np, op, inputs, attrs, diff, CARD)
        errs = [_sweep_err(np, a, b) if a.dtype.kind == "f" else
                (0.0 if np.array_equal(a, b) else float("inf"))
                for a, b in zip(card[0], cpu[0])]
        if name == "_contrib_MultiBoxDetection":
            # classes and the kept mask equal; scores and boxes as floats
            a, b = card[0][0], cpu[0][0]
            errs[0] = _sweep_err(np, a[..., 1:], b[..., 1:])
            if not np.array_equal(a[..., 0], b[..., 0]):
                errs.append(float("inf"))
        if name == "_contrib_MultiBoxTarget":
            errs[2] = 0.0 if np.array_equal(card[0][2], cpu[0][2]) \
                else float("inf")
            errs[1] = 0.0 if np.array_equal(card[0][1], cpu[0][1]) \
                else float("inf")
        errs += [_sweep_err(np, a, b) for a, b in zip(card[1], cpu[1])]
        grads += len(card[1])
        if len(card[0]) != len(cpu[0]) or len(card[1]) != len(cpu[1]):
            errs.append(float("inf"))
        worst.append((max(errs), cid))
        held.add(name)
    proposal_rounds = contrib.nms_rounds[0]
    # Proposal at its default size (6000 candidates, 300 kept), card vs cpu
    rpn = registry.get("_contrib_Proposal")
    rng = np.random.RandomState(3)
    big_np = [rng.uniform(0, 1, (1, 24, 38, 50)).astype(np.float32),
              (rng.randn(1, 48, 38, 50) * 0.1).astype(np.float32),
              np.array([[600.0, 800.0, 1.0]], np.float32)]
    big = [torch.tensor(v, device=CARD) for v in big_np]
    rpn.fn(*big)
    contrib.nms_rounds[0] = 0
    big_card = rpn.fn(*big).cpu().numpy()
    big_rounds = contrib.nms_rounds[0]
    big_cpu = rpn.fn(*(torch.from_numpy(v) for v in big_np)).numpy()
    worst.append((_sweep_err(np, big_card, big_cpu), "Proposal-default"))
    prof = {}
    _device_profile(torch, lambda: rpn.fn(*big), top=2, stats=prof)
    rnd_worst = []
    for name, (inputs, attrs, mean, std) in \
            sorted(random_moment_cases(np).items()):
        op = registry.get(name)
        runs = [_sweep_run(torch, np, op, inputs, attrs, None, CARD)[0][0]
                for _ in range(2)]
        dm, ds = moment_errors(np, runs[0], mean, std)
        rerun = np.array_equal(runs[0], runs[1])
        spec = specs[name]
        small = _sweep_run(torch, np, op, spec[0], spec[1], None, CARD)[0][0]
        cpu_small = _sweep_run(torch, np, op, spec[0], spec[1], None,
                               "cpu")[0][0]
        ok = rerun and max(dm) <= RANDOM_SIGMAS and \
            max(ds) <= RANDOM_STD_TOL and small.shape == cpu_small.shape \
            and small.dtype == cpu_small.dtype
        rnd_worst.append((max(dm), max(ds), name, ok))
        held.add(name)
    worst.sort(reverse=True)
    rnd_worst.sort(reverse=True)
    launches = _counts(fa) + _fb_counts(fb)
    print("contrib sweep: %d of the 31 names of items 7c and 7d; 7d card vs "
          "cpu, %d gradients, %d edge cases: worst %.3g at %s (tol %g); next "
          "%s; NMS %d rounds in the sweep; Proposal at its default (6000 "
          "candidates, 300 kept, 38x50x12 anchors): %d NMS rounds, %s "
          "launches in %s ms; 7c by moments of %d draws a row: worst mean "
          "%.2f standard errors (limit %g) at %s, worst std %.4f relative "
          "(limit %g), "
          "reruns bit for bit %s"
          % (len(held), grads, len(edges), worst[0][0],
             worst[0][1], SWEEP_TOL,
             ", ".join("%.2g %s" % w for w in worst[1:5]), proposal_rounds,
             big_rounds, prof.get("launches", "n/a"),
             "%.1f" % prof["wall_ms"] if prof else "n/a", RANDOM_DRAWS,
             rnd_worst[0][0], RANDOM_SIGMAS, rnd_worst[0][2],
             max(r[1] for r in rnd_worst), RANDOM_STD_TOL,
             "all" if all(r[3] for r in rnd_worst) else "NOT all"))
    bad = [w for w in worst if not w[0] <= SWEEP_TOL]
    bad += [r for r in rnd_worst if not r[3]]
    if len(held) != 31 or bad:
        raise RuntimeError("contrib sweep: out of bounds: %s" % bad[:5])
    if any(launches):
        raise RuntimeError("contrib sweep: hand-written kernels launched %s"
                           % (launches,))
    return launches


# int8 post-training-quantized serving (ops/quantized.py, ir/quantize.py,
# AOTPredictor(quant="int8")): tools/bench_serve.py's quant trace
# (measure_quant, :1164-1231) at its own sizes, the bench MLP trained by
# _train_model's recipe (:1134-1161) through the port's Module.fit
QUANT_MLP = dict(dim=256, hidden=512, layers=6, classes=64)
QUANT_TRAIN = dict(n=4096, batch=256, epochs=6, lr=0.05, momentum=0.9)
QUANT_TRACE = dict(clients=24, think_ms=2.0, rows=8, seconds=2.5,
                   ladder=(1, 4, 16, 64))
QUANT_CALIB = (8, 64)          # batches, rows a batch
QUANT_CORPUS = 2048
QUANT_TOP1 = 0.99              # int8 vs bf16 top-1 on the trained MLP
QUANT_MLP_OPS = 7              # 6 hidden FCs and the head
# the unfused ResNet-50: 53 convolutions and fc1
QUANT_RESNET_OPS = 54
QUANT_RESNET_CALIB = (8, 16)
# card int8 vs the port's CPU int8 on the same quantized weights and
# scales. Node by node, the CPU's node fed the card's inputs: the int8 ops
# equal (0), every float op within QUANT_FORCED_TOL of the node's largest
# |value| (measured on an H100: BatchNorm 1.19e-7, Pooling 9.98e-8). Free
# running, those ulps move values across re-quantize boundaries (2
# activations of 802816 at the first unit's conv1, 2.3% of all by fc1, at
# most 4 steps), so the logits are held to the CPU's own int8-vs-fp32 gap
# times QUANT_CARD_CPU_RATIO (measured 0.56), a coarse bound only: a card
# forward that did not quantize would land near 1.0x too. What ties the
# served path to the node-by-node hold is the predictor's own logits
# against the card's chain over the same graph, within QUANT_TIE_TOL of the
# largest |logit|
QUANT_FORCED_TOL = 1e-6
QUANT_CARD_CPU_RATIO = 1.0
QUANT_TIE_TOL = 1e-6
QUANT_BATCHES = (1, 64)        # the int8 op checks at every ResNet-50 shape
QUANT_SCALE = 0.0123456        # _quantize_int8 at its k + 0.5 boundaries


def quant_mlp_symbol(mx, dim, hidden, layers, classes):
    """tools/bench_serve.py's ``build_model`` graph."""
    net = mx.sym.var("data")
    for i in range(layers):
        net = mx.sym.Activation(mx.sym.FullyConnected(
            data=net, num_hidden=hidden, name="fc%d" % i), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data=net, num_hidden=classes, name="head"), name="softmax")


def quant_sampler(np, dim, classes, seed=0):
    """``_train_model``'s clustered task: ``sample(count, seed) -> (x,
    y)``."""
    centers = np.random.RandomState(seed).randn(classes, dim).astype(
        np.float32) * 1.5

    def sample(count, sample_seed):
        r = np.random.RandomState(sample_seed)
        y = r.randint(0, classes, count)
        return (centers[y] + r.randn(count, dim).astype(np.float32),
                y.astype(np.float32))

    return sample


def _quant_train_mlp(torch, np, mx):
    """The bench MLP trained on the card by ``_train_model``'s recipe
    through ``Module.fit``; its args (numpy) and the sampler."""
    import logging

    cfg, tr = QUANT_MLP, QUANT_TRAIN
    sym = quant_mlp_symbol(mx, **cfg)
    sample = quant_sampler(np, cfg["dim"], cfg["classes"])
    x, y = sample(tr["n"], 1)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    logging.getLogger().setLevel(logging.WARNING)
    mx.random.seed(0)
    t0 = time.perf_counter()
    mod.fit(mx.io.NDArrayIter(x, y, tr["batch"], label_name="softmax_label"),
            num_epoch=tr["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": tr["lr"],
                              "momentum": tr["momentum"]},
            initializer=mx.init.Xavier())
    torch.cuda.synchronize()
    args, _aux = mod.get_params()
    print("quant: bench MLP (dim %d, hidden %d, %d layers, %d classes) "
          "trained on the card, %d epochs of %d rows in %.1f s"
          % (cfg["dim"], cfg["hidden"], cfg["layers"], cfg["classes"],
             tr["epochs"], tr["n"], time.perf_counter() - t0))
    return sym, {k: v.asnumpy() for k, v in args.items()}, sample


def _quant_client(srv, name, stop_at, think_s, x, seed, out):
    """bench_serve's closed-loop client: think (exponential), submit, wait,
    record the latency."""
    import random

    rng = random.Random(seed)
    lat, errors = [], 0
    while time.perf_counter() < stop_at:
        time.sleep(rng.expovariate(1.0 / think_s))
        t0 = time.perf_counter()
        try:
            srv.submit(name, x).result(timeout=60)
            lat.append(time.perf_counter() - t0)
        except Exception:
            errors += 1
    out.append((lat, errors))


def _quant_closed_loop(np, srv, name, dim):
    """``run_mode``'s load on a resident model, every bucket >= the request
    rows warmed first; req/s and latency p50/p99 (ms)."""
    import threading

    tr = QUANT_TRACE
    for b in sorted({b for b in tr["ladder"] if b >= tr["rows"]}):
        srv.predict(name, np.zeros((b, dim), np.float32))
    results = []
    t0 = time.perf_counter()
    stop_at = t0 + tr["seconds"]
    threads = [threading.Thread(target=_quant_client, args=(
        srv, name, stop_at, tr["think_ms"] / 1e3,
        np.random.RandomState(1000 + i).randn(tr["rows"], dim).astype(
            np.float32), 1000 + i, results))
        for i in range(tr["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lats = sorted(x for lat, _e in results for x in lat)
    return dict(req_s=len(lats) / wall, requests=len(lats),
                errors=sum(e for _l, e in results),
                p50_ms=_pctl(lats, 0.5) * 1e3, p99_ms=_pctl(lats, 0.99) * 1e3)


def _resnet_int8_calls(sym):
    """The distinct int8 products of the unfused ResNet-50 at batch 1:
    ``{(kind, data shape, weight shape, stride, pad): count}``."""
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(1,) + RESNET["image_shape"])
    shape_of = dict(zip(internals.list_outputs(), outs))
    calls = {}
    for node in sym._topo():
        if node.is_variable() or node.op.name not in ("Convolution",
                                                      "FullyConnected"):
            continue
        inp = node.inputs[0][0]
        data = shape_of[inp.name if inp.is_variable()
                        else inp.name + "_output"]
        w = shape_of[node.inputs[1][0].name]
        if node.op.name == "FullyConnected":
            key = ("fc", (1, math.prod(data[1:])), tuple(w), (), ())
        else:
            key = ("conv", tuple(data), tuple(w),
                   tuple(node.attrs.get("stride") or (1, 1)),
                   tuple(node.attrs.get("pad") or (0, 0)))
        calls[key] = calls.get(key, 0) + 1
    return calls


def _quant_ops_check(torch, np, tq, calls):
    """Part 1: each int8 product of ResNet-50 on the card at batch 1 and 64
    against float64 of the same int8 operands on the CPU, the int32
    accumulations bit for bit (at batch 64, on images 0 and 63; every image
    against float64 on the card), then _quantize_int8 at its boundaries;
    times of the int8 op against cuDNN's bf16 convolution at batch 64."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cpu").manual_seed(0)
    checked, timed = 0, []
    for (kind, data, w, stride, pad), count in sorted(calls.items()):
        if w[0] % 8:
            raise RuntimeError("int8 %s %s: %d output channels, not a "
                               "multiple of 8" % (kind, w, w[0]))
        for n in QUANT_BATCHES:
            x = torch.randint(-127, 128, (n,) + data[1:], generator=gen,
                              dtype=torch.int8)
            wq = torch.randint(-127, 128, w, generator=gen,
                               dtype=torch.int8)
            xc, wc = x.to(CARD), wq.to(CARD)
            if kind == "fc":
                acc = tq.int8_linear_acc(xc, wc)
                cpu = x.double() @ wq.double().t()
                card64 = xc.double() @ wc.double().t()
                rows = slice(None)
            else:
                acc = tq.int8_conv_acc(xc, wc, stride, pad, (1, 1), 1)
                rows = [0, n - 1] if n > 1 else [0]
                cpu = F.conv2d(x[rows].double(), wq.double(), stride=stride,
                               padding=pad)
                card64 = F.conv2d(xc.double(), wc.double(), stride=stride,
                                  padding=pad)
            torch.cuda.synchronize()
            ok = acc.dtype == torch.int32 and torch.equal(
                acc[rows].cpu().double(), cpu) and torch.equal(
                acc.double(), card64)
            if not ok:
                raise RuntimeError("int8 %s x %s %s at batch %d: the int32 "
                                   "accumulation differs from float64"
                                   % (kind, data[1:], w, n))
            checked += 1
            if n != 64:
                continue
            ws = torch.rand(w[0], device=CARD) * 1e-3
            if kind == "fc":
                op = lambda: tq._int8_fully_connected(   # noqa: E731
                    xc, wc, ws, num_hidden=w[0], no_bias=True, scale=0.01)
                xb, wb = xc.bfloat16(), wc.bfloat16()
                lib = lambda: F.linear(xb, wb)          # noqa: E731
                macs = n * w[0] * w[1]
                out_elems = n * w[0]
            else:
                op = lambda: tq._int8_convolution(      # noqa: E731
                    xc, wc, ws, kernel=w[2:], stride=stride, pad=pad,
                    num_filter=w[0], no_bias=True, scale=0.01)
                xb, wb = xc.bfloat16(), wc.bfloat16()
                lib = lambda: F.conv2d(xb, wb, stride=stride,  # noqa: E731
                                       padding=pad)
                oh = (data[2] + 2 * pad[0] - w[2]) // stride[0] + 1
                ow = (data[3] + 2 * pad[1] - w[3]) // stride[1] + 1
                macs = n * oh * ow * w[0] * int(np.prod(w[1:]))
                out_elems = n * oh * ow * w[0]
            ms, lib_ms = _time_ms(torch, op), _time_ms(torch, lib)
            nbytes = x.numel() + wq.numel() + 4 * out_elems
            bound = max(2.0 * macs / 1979e12, nbytes / PEAK_BYTES) * 1e3
            timed.append((kind, data[1:], w, stride, count, ms, lib_ms,
                          bound))
    for kind, data, w, stride, count, ms, lib_ms, bound in timed:
        print("quant op %-4s x %-14s w %-18s stride %s x%-2d at batch 64 "
              "(event / device): int8 %s ms, cuDNN/cuBLAS bf16 %s ms, int8 "
              "bound %.4f ms" % (kind, "x".join(map(str, data)),
                                 "x".join(map(str, w)), stride[0] if stride
                                 else 1, count, _both(ms), _both(lib_ms),
                                 bound))
    per_fwd = [sum(t[4] * t[5][i] for t in timed) for i in (0, 1)]
    lib_fwd = [sum(t[4] * t[6][i] for t in timed) for i in (0, 1)]
    print("quant ops: %d calls held bit for bit (%d distinct products x "
          "batches %s); at batch 64 a forward's products take %.3f / %.3f ms "
          "int8 against %.3f / %.3f ms bf16 (event / device, summed over "
          "the %d calls); routes so far %s"
          % (checked, len(calls), QUANT_BATCHES, *per_fwd, *lib_fwd,
             sum(calls.values()), tq.routes))
    # _quantize_int8: k + 0.5 steps of the scale and one ulp either side
    base = ((np.arange(-130, 130) + 0.5) * QUANT_SCALE).astype(np.float32)
    vals = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])
    xv = torch.from_numpy(vals)
    got = tq._quantize_int8(xv.to(CARD), scale=QUANT_SCALE)
    want = tq._quantize_int8(xv, scale=QUANT_SCALE)
    flips = int((got.cpu().float() != want).sum())
    print("quant: _quantize_int8 on the card vs the CPU at %d boundary "
          "values: %d differ; int8 %s" % (len(vals), flips, got.dtype))
    if flips or got.dtype != torch.int8:
        raise RuntimeError("_quantize_int8: the card rounds %d boundary "
                           "values unlike the CPU" % flips)


def _quant_mlp(torch, np, mx):
    """Parts 2 and 4: the bench MLP's int8 vs bf16 agreement and closed-loop
    pair behind ModelServer; swap_from_checkpoint while the server is
    live."""
    import shutil
    import tempfile
    import threading

    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch.serving import AOTPredictor, ModelServer

    cfg = QUANT_MLP
    sym, args, sample = _quant_train_mlp(torch, np, mx)
    calib = [{"data": sample(QUANT_CALIB[1], 500 + i)[0]}
             for i in range(QUANT_CALIB[0])]
    corpus, labels = sample(QUANT_CORPUS, 900)
    shapes = {"data": (1, cfg["dim"])}
    profiler.pass_reset()
    pb = AOTPredictor(sym, args, data_shapes=shapes, ladder=(QUANT_CORPUS,),
                      dtype="bfloat16")
    pq = AOTPredictor(sym, args, data_shapes=shapes, ladder=(QUANT_CORPUS,),
                      quant="int8", calib_data=calib)
    top_b = pb.predict(corpus)[0].argmax(1)
    top_q = pq.predict(corpus)[0].argmax(1)
    agree = float((top_q == top_b).mean())
    stats = profiler.pass_stats(reset=True)
    n_ops = pq.bind_stats["quantized_ops"]
    print("quant MLP: int8 vs bf16 top-1 agreement %.4f on %d rows (limit "
          ">= %g); accuracy bf16 %.4f int8 %.4f; quantized_ops %d; quantize "
          "pass %s; calibration (absmax, scale): %s"
          % (agree, QUANT_CORPUS, QUANT_TOP1, float((top_b == labels).mean()),
             float((top_q == labels).mean()), n_ops,
             stats["passes"]["quantize"],
             ", ".join("%s %.4f %.6g" % (k, v["absmax"], v["scale"])
                       for k, v in sorted(stats["calibration"].items()))))
    if agree < QUANT_TOP1 or n_ops != QUANT_MLP_OPS:
        raise RuntimeError("quant MLP: agreement %.4f (>= %g), %d quantized "
                           "ops (want %d)" % (agree, QUANT_TOP1, n_ops,
                                              QUANT_MLP_OPS))
    del pb, pq
    rows = {}
    for mode, kw in (("bf16", dict(dtype="bfloat16")),
                     ("int8", dict(quant="int8", calib_data=calib))):
        profiler.serving_reset()
        with ModelServer(ladder=QUANT_TRACE["ladder"],
                         queue_depth=4 * QUANT_TRACE["clients"] + 8,
                         submit_timeout=60) as srv:
            srv.add_model("mlp", symbol=sym, arg_params=args,
                          data_shapes=shapes, **kw)
            rows[mode] = _quant_closed_loop(np, srv, "mlp", cfg["dim"])
        r = rows[mode]
        print("quant MLP serve %s: %d clients, think %.0f ms, %d rows a "
              "request, %.0f s: %.1f req/s (%d requests, %d errors), "
              "latency p50 %.2f ms p99 %.2f ms"
              % (mode, QUANT_TRACE["clients"], QUANT_TRACE["think_ms"],
                 QUANT_TRACE["rows"], QUANT_TRACE["seconds"], r["req_s"],
                 r["requests"], r["errors"], r["p50_ms"], r["p99_ms"]))
        if r["errors"] or not r["requests"]:
            raise RuntimeError("quant MLP serve %s: %r" % (mode, r))
    print("quant MLP serve: int8 / bf16 req/s %.3f, p99 %.3f"
          % (rows["int8"]["req_s"] / rows["bf16"]["req_s"],
             rows["int8"]["p99_ms"] / rows["bf16"]["p99_ms"]))

    # part 4: the trained weights saved; the live server moved to perturbed
    # ones, then swapped back from the checkpoint under load
    tmp = tempfile.mkdtemp(prefix="quant_swap_")
    try:
        prefix = os.path.join(tmp, "mlp")
        save_checkpoint(prefix, 0, sym, {k: mx.nd.array(v, ctx=mx.cpu())
                                         for k, v in args.items()}, {})
        moved = {k: (v + 0.05 * np.abs(v).max() * np.random.RandomState(3)
                     .randn(*v.shape)).astype(np.float32)
                 for k, v in args.items()}
        x = sample(64, 901)[0]
        with ModelServer(ladder=QUANT_TRACE["ladder"]) as srv:
            srv.add_model("mlp", symbol=sym, arg_params=args,
                          data_shapes=shapes, quant="int8", calib_data=calib)
            srv.swap("mlp", moved)
            perturbed = srv.predict("mlp", x)[0]
            stop = threading.Event()
            errors = []

            def load():
                while not stop.is_set():
                    try:
                        srv.predict("mlp", x[:8])
                    except Exception as e:       # noqa: BLE001
                        errors.append(e)

            threads = [threading.Thread(target=load) for _ in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.2)
            n_swapped = srv.swap_from_checkpoint("mlp", prefix=prefix,
                                                 epoch=0)
            time.sleep(0.2)
            stop.set()
            for t in threads:
                t.join()
            restored = srv.predict("mlp", x)[0]
        fresh = AOTPredictor(sym, args, data_shapes=shapes,
                             ladder=QUANT_TRACE["ladder"], quant="int8",
                             calib_data=calib).predict(x)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    equal = bool(np.array_equal(restored, fresh))
    print("quant swap_from_checkpoint: %d params swapped under load (%d "
          "errors); int8 outputs equal a fresh int8 bind's: %s (perturbed "
          "weights moved them by %.4g)"
          % (n_swapped, len(errors), equal,
             float(np.abs(perturbed - restored).max())))
    if not equal or errors or np.array_equal(perturbed, restored):
        raise RuntimeError("quant swap_from_checkpoint: restored %s, %d "
                           "errors" % (equal, len(errors)))
    return rows


def _node_chain(torch, qsym, params, x, device):
    """Every node of ``qsym`` evaluated one at a time on ``device`` through
    ``eval_node``, as ``AOTPredictor._run`` does; a variable is its entry of
    ``params``, or ``x``. Returns ``(nodes, ids, outs)``: the topo order,
    node id -> index, and index -> the node's outputs."""
    from mxnet_tpu_torch.executor import INFERENCE_SEED, eval_node

    nodes = qsym._topo()
    ids = {id(n): i for i, n in enumerate(nodes)}
    outs = {}
    with torch.inference_mode():
        for i, node in enumerate(nodes):
            if node.is_variable():
                v = params[node.name] if node.name in params else \
                    torch.from_numpy(x)
                outs[i] = (v.to(device),)
                continue
            outs[i] = eval_node(node, [outs[ids[id(n)]][k]
                                       for n, k in node.inputs],
                                False, INFERENCE_SEED, i, device)
    return nodes, ids, outs


def _quant_flips(torch, np, qsym, params, x):
    """The int8 graph node by node, card against CPU on one input. Free
    running (each side on its own inputs): per ``_quantize_int8`` node the
    activations whose int8 value differs (flips) and by how many steps.
    Teacher-forced (the CPU's node on the card's inputs): per op the
    largest gap relative to the node's largest |value|. Returns
    ``(flips, forced)``: ``[(node, flipped, total, max steps)]`` and
    ``{op: gap}``."""
    from mxnet_tpu_torch.executor import INFERENCE_SEED, eval_node

    nodes, ids, card = _node_chain(torch, qsym, params, x, CARD)
    cpu = _node_chain(torch, qsym, params, x, "cpu")[2]
    flips, forced = [], {}
    with torch.inference_mode():
        for i, node in enumerate(nodes):
            if node.is_variable():
                continue
            ref = eval_node(node, [card[ids[id(n)]][k].cpu()
                                   for n, k in node.inputs],
                            False, INFERENCE_SEED, i, "cpu")
            for a, b in zip(card[i], ref):
                a, b = a.cpu().double(), b.double()
                gap = (a - b).abs().max().item() / max(
                    b.abs().max().item(), 1e-30)
                forced[node.op.name] = max(forced.get(node.op.name, 0.0),
                                           gap)
            if node.op.name == "_quantize_int8":
                d = (card[i][0].cpu().float() - cpu[i][0]).abs()
                flips.append((node.name, int((d > 0).sum()), d.numel(),
                              int(d.max().item())))
    return flips, forced


def _quant_resnet(torch, np):
    """Part 3: the unfused ResNet-50 at full width, int8 against bf16 behind
    ModelServer on the 48-request trace, the card's int8 logits against the
    CPU's on the same quantized weights and scales."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.serving import AOTPredictor, ModelServer

    gc.collect()
    torch.cuda.empty_cache()
    sym = resnet.get_symbol(fused=False, **RESNET)
    one = (1,) + RESNET["image_shape"]
    args, auxs = resnet.init_params(sym, one, seed=0)
    calib = [{"data": _resnet_images(np, 300 + i, QUANT_RESNET_CALIB[1])}
             for i in range(QUANT_RESNET_CALIB[0])]
    t0 = time.perf_counter()
    profiler.pass_reset()
    kw = dict(data_shapes={"data": one}, ladder=(RESNET_CHECK_IMAGES,),
              output_names=["fc1_output"])
    pq = AOTPredictor(sym, args, auxs, quant="int8", calib_data=calib, **kw)
    bind_s = time.perf_counter() - t0
    n_ops = pq.bind_stats["quantized_ops"]
    gauges = profiler.pass_stats(reset=True).get("calibration", {})
    print("quant resnet: unfused ResNet-50, calibrated on %d batches of %d "
          "and bound in %.1f s; quantized_ops %d (want %d); %d calibration "
          "gauges, scales %.4g..%.4g"
          % (*QUANT_RESNET_CALIB, bind_s, n_ops, QUANT_RESNET_OPS,
             len(gauges), min(g["scale"] for g in gauges.values()),
             max(g["scale"] for g in gauges.values())))
    if n_ops != QUANT_RESNET_OPS:
        raise RuntimeError("quant resnet: %d quantized ops" % n_ops)

    # the card's int8 logits against the CPU's, the same quantized graph
    # (scales) and weights; the yardstick is the CPU's int8-vs-fp32 gap
    x = _resnet_images(np, 1, RESNET_CHECK_IMAGES)
    card = pq.predict(x)[0]
    # the predictor's own run (folded constants, _run) against the card's
    # node-by-node chain over the same graph, which _quant_flips holds to
    # the CPU node by node
    nodes, ids, chain = _node_chain(torch, pq._sym, pq._params, x, CARD)
    (out_node, out_k), = pq._sym._entries
    chained = chain[ids[id(out_node)]][out_k].cpu().numpy()
    tie = float(np.abs(card - chained).max()) / float(np.abs(chained).max())
    del nodes, ids, chain
    print("quant resnet tie: predictor int8 logits vs the card's node-by-"
          "node chain, max |diff| relative to the largest |logit| %.4g "
          "(limit %g)" % (tie, QUANT_TIE_TOL))
    if not tie <= QUANT_TIE_TOL:
        raise RuntimeError("quant resnet: the predictor's int8 run is %.4g "
                           "off the node-by-node chain" % tie)
    kw.pop("output_names")
    cpu_q = AOTPredictor(pq._sym, args, auxs, device="cpu", **kw)
    same_w = all(torch.equal(a.cpu(), b) for a, b in
                 zip(pq._consts, cpu_q._consts) if a.dtype == torch.int8)
    cpu_int8 = cpu_q.predict(x)[0]
    kw["output_names"] = ["fc1_output"]
    cpu_fp32 = AOTPredictor(sym, args, auxs, device="cpu", **kw).predict(
        x)[0]
    bf16 = AOTPredictor(sym, args, auxs, dtype="bfloat16", **kw).predict(
        x)[0]
    gap = float(np.abs(card - cpu_int8).max())
    yard = float(np.abs(cpu_int8 - cpu_fp32).max())
    top2 = np.sort(bf16, 1)[:, -2:]
    print("quant resnet check: %d images; card int8 vs CPU int8 (same int8 "
          "weights: %s) max |diff| %.4g, CPU int8 vs CPU fp32 %.4g: ratio "
          "%.4f (limit %g); card int8 vs card bf16 top-1 agreement %.3f, "
          "bf16 top-2 logit gaps min %.3g median %.3g"
          % (RESNET_CHECK_IMAGES, same_w, gap, yard, gap / yard,
             QUANT_CARD_CPU_RATIO, float((card.argmax(1) == bf16.argmax(1))
                                         .mean()),
             float((top2[:, 1] - top2[:, 0]).min()),
             float(np.median(top2[:, 1] - top2[:, 0]))))
    flips, forced = _quant_flips(torch, np, pq._sym, pq._params, x[:4])
    first = next((f for f in flips if f[1]), None)
    print("quant resnet flips, free running (4 images): %d of %d quantized "
          "activations differ card vs CPU, at most %d step(s); first at %s "
          "(%d of %d); by node: %s"
          % (sum(f[1] for f in flips), sum(f[2] for f in flips),
             max(f[3] for f in flips), first and first[0],
             first[1] if first else 0, first[2] if first else 0,
             " ".join("%s:%d" % (f[0], f[1]) for f in flips)))
    print("quant resnet teacher-forced (the CPU's node on the card's "
          "inputs), largest gap relative to the node's largest |value|, by "
          "op: %s" % ", ".join("%s %.3g" % kv for kv in sorted(
              forced.items())))
    exact = ("_quantize_int8", "_quantize_rows_int8", "_int8_convolution",
             "_int8_fully_connected")
    bad = {k: v for k, v in forced.items()
           if v > (0.0 if k in exact else QUANT_FORCED_TOL)}
    if bad or not (same_w and np.isfinite(card).all()
                   and gap <= QUANT_CARD_CPU_RATIO * yard):
        raise RuntimeError("quant resnet: card int8 off the CPU's: nodes %s, "
                           "logits %.4g of the yardstick" % (bad, gap / yard))
    del pq, cpu_q

    sizes, images = _resnet_requests(np)
    rows = {}
    for mode, pkw in (("bf16", dict(dtype="bfloat16")),
                      ("int8", dict(quant="int8", calib_data=calib))):
        gc.collect()
        torch.cuda.empty_cache()
        profiler.serving_reset()
        with ModelServer(ladder=RESNET_LADDER) as srv:
            model = srv.add_model("r50", symbol=sym, arg_params=args,
                                  aux_params=auxs, data_shapes={"data": one},
                                  **pkw)
            for b in RESNET_LADDER:
                model.run_bucket({"data": _resnet_images(np, 7, b)}, b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out, wall = _resnet_trace(srv, "r50", images)
            st = srv.stats()["r50"]
            peak = torch.cuda.max_memory_allocated()
            batch = {"data": _resnet_images(np, 8, 64)}
            print("quant resnet profile, %s, one batch of 64:" % mode)
            prof = {}
            _device_profile(torch, lambda: model.run_bucket(batch, 64),
                            top=10, stats=prof)
        rows[mode] = dict(images_s=sum(sizes) / wall, p50_ms=st["p50_ms"],
                          p99_ms=st["p99_ms"], peak_gib=peak / 2 ** 30,
                          out=out, busy_ms=prof.get("busy_ms"),
                          wall_ms=prof.get("wall_ms"))
        print("quant resnet serve %s: %d requests (%d images) from %d "
              "threads in %.3f s = %.1f images/s; latency p50 %.1f ms p99 "
              "%.1f ms; %d batches; peak memory %.2f GiB"
              % (mode, len(sizes), sum(sizes), RESNET_THREADS, wall,
                 rows[mode]["images_s"], st["p50_ms"], st["p99_ms"],
                 st["batches"], peak / 2 ** 30))
        if st["errors"] or any(not np.isfinite(o).all() for o in out):
            raise RuntimeError("quant resnet serve %s: %r" % (mode, st))
    agree = float(np.mean(np.concatenate(
        [a.argmax(1) == b.argmax(1) for a, b in zip(rows["int8"]["out"],
                                                    rows["bf16"]["out"])])))
    print("quant resnet serve: int8 / bf16 images/s %.3f, p99 %.3f; served "
          "top-1 agreement %.3f (Xavier weights: near-tied logits, no limit)"
          % (rows["int8"]["images_s"] / rows["bf16"]["images_s"],
             rows["int8"]["p99_ms"] / rows["bf16"]["p99_ms"], agree))
    return rows


def quant_serving_phase(torch, np, fa, fb):
    """Int8 post-training-quantized serving on the card: the int8 ops at
    every ResNet-50 shape, the bench MLP's quant trace, the unfused
    ResNet-50 int8 vs bf16, swap_from_checkpoint; returns the launches of
    B5-B7 and B1-B3 on the path (0 each: no hand-written kernel there)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import quantized as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    calls = _resnet_int8_calls(resnet.get_symbol(fused=False, **RESNET))
    t0 = time.perf_counter()
    _quant_ops_check(torch, np, tq, calls)
    print("quant ops phase part: %.1f s" % (time.perf_counter() - t0))
    _reset_counts(fa)
    _reset_fb_counts(fb)
    routes0 = dict(tq.routes)
    _quant_mlp(torch, np, mx)
    _quant_resnet(torch, np)
    launches = _counts(fa) + _fb_counts(fb)
    print("quant routes on the path: %s; B5-B7 and B1-B3 launches %s"
          % ({k: tq.routes[k] - routes0[k] for k in tq.routes}, launches))
    if any(launches) or tq.routes["f32_exact"] != routes0["f32_exact"]:
        raise RuntimeError("quant: hand-written kernels launched %s, or "
                           "the grouped route ran" % (launches,))
    return launches


# the autotuner on the card (tune_phase): the CLI's on-device defaults
# (conv 64x14x14x256 -> 256 3x3, flash 8x8x1024 D 128 causal bf16 and its
# decode shape) and the transformer's training key
TUNE_CONV = (64, 14, 256, 256, 3, 1)
TUNE_FLASH = (8, 8, 1024, 128)
TUNE_TRAIN_KEY = (TRAIN_ATTN[0], TRAIN_ATTN[1], TRAIN_ATTN[2], TRAIN_ATTN[2],
                  TRAIN_ATTN[3], 1)
# the tuned steps' losses against the untuned ones': the tiles change only
# the order of f32 sums (B2, B3's split) and of the online softmax (B5-B7)
TUNE_LOSS_TOL = 2.0 ** -6
# Module.fit with the background tuner: the fused ResNet-50, fp32, 2 epochs
# of 2 batches of 8 (one slot at each epoch end)
TUNE_FIT_BATCH, TUNE_FIT_BATCHES, TUNE_FIT_EPOCHS = 8, 2, 2


def _tile_checks(torch, fa, fb):
    """Every candidate tile of B5-B7 at TUNE_FLASH and at the training
    shape, and of B1-B3 at TUNE_CONV, against the plain versions at the
    same tile on the card; B1 bit for bit across chan_block."""
    from mxnet_tpu_torch import tune

    gen = torch.Generator(device="cuda").manual_seed(7)
    for b, h, s, d in (TUNE_FLASH, TRAIN_ATTN):
        q, k, v, do = _inputs(torch, gen, [(b, h, s, d)] * 4, torch.bfloat16)
        for cand in tune.flash_candidates(s, s, d=d, dtype="bfloat16"):
            if cand["status"] not in ("default", "candidate"):
                continue
            tile = dict(cand["schedule"])
            out, lse = fa.flash_attention(q, k, v, causal=True,
                                          return_lse=True, **tile)
            ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True,
                                                        **tile)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                           **tile)
            refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                    causal=True, **tile)
            torch.cuda.synchronize()
            e_out = _row_err(torch, out, ref)
            e_lse = (lse - ref_lse).abs().max().item()
            e_bwd = max(_row_err(torch, g, r, floor_frac=1e-2)
                        for g, r in zip(grads, refs))
            ok = e_out <= KERNEL_TOL["bfloat16"][0] and e_bwd <= \
                BWD_TOL["bfloat16"] and e_lse <= KERNEL_TOL["bfloat16"][1]
            print("tune tile B5-B7 bf16 (%d,%d,%d,%d) causal %s: out %.3g, "
                  "lse %.3g, dq/dk/dv %.3g row-relative  %s"
                  % (b, h, s, d, tile, e_out, e_lse, e_bwd,
                     "ok" if ok else "FAIL"))
            if not ok:
                raise RuntimeError("tune: B5-B7 at %s disagree with the "
                                   "plain versions" % tile)
    n, hw, ci, co, kk, stride = TUNE_CONV
    xs, ws = (n, hw, hw, ci), (kk, kk, ci, co)
    x, w, pro, (e, y), consts, mask, _ex = _grad_inputs(
        torch, gen, ("dgrad", n, hw, ci, co, kk, stride, True, None),
        torch.bfloat16)
    first = None
    for kernel in tune.FUSED_KINDS:
        for cand in tune.fused_candidates(kernel, xs, ws, stride):
            if cand["status"] not in ("default", "candidate"):
                continue
            sched = cand["schedule"]
            if kernel == "fused_fwd":
                got = fb.conv_fwd(x, w, stride=stride, prologue=pro,
                                  emit_stats=True, schedule=sched)
                ref = fb.conv_fwd_reference(x, w, stride=stride,
                                            prologue=pro, emit_stats=True,
                                            schedule=sched)
                err = _row_err(torch, got[0], ref[0])
                same = first is None or (torch.equal(got[0], first[0])
                                         and torch.equal(got[1], first[1]))
                first = got if first is None else first
                ok = err <= CONV_TOL["bfloat16"] and same
                what = "row-relative %.3g, bit for bit with the first " \
                    "chan_block %s" % (err, same)
            elif kernel == "fused_wgrad":
                kw = dict(stride=stride, x_prologue=pro, g_bnbwd=consts,
                          schedule=sched)
                dw = fb.conv_wgrad(x, (e, y), ws, **kw)
                ref = fb.conv_wgrad_reference(x, (e, y), ws, **kw)
                err = _wgrad_err(torch, fb, dw, ref, x, (e, y), ws, stride,
                                 pro, consts)
                ok = err <= WGRAD_TOL
                what = "column-relative %.3g" % err
            else:
                kw = dict(stride=stride, g_bnbwd=consts, out_mask=mask,
                          schedule=sched)
                got = fb.conv_dgrad((e, y), w, xs, **kw)
                ref = fb.conv_dgrad_reference((e, y), w, xs, **kw)
                err = _row_err(torch, got[0], ref[0])
                ok = err <= CONV_TOL["bfloat16"]
                what = "row-relative %.3g" % err
            torch.cuda.synchronize()
            print("tune tile %s bf16 %s %s: %s  %s"
                  % (kernel, "x".join(map(str, TUNE_CONV)), sched, what,
                     "ok" if ok else "FAIL"))
            if not ok:
                raise RuntimeError("tune: %s at %s disagrees with its plain "
                                   "version" % (kernel, sched))


def _tune_cli(argv):
    """One run of ``python -m mxnet_tpu_torch.tune`` in this process: its
    report (the JSON of its last line)."""
    from mxnet_tpu_torch.tune import __main__ as cli

    return cli.run(argv)


def _print_tune_report(rep, label):
    for key, r in rep["tune"].items():
        w = r["winner"]
        if r["cache_hit"]:
            print("tune %s %s: cache hit, schedule %s" % (label, key,
                                                          w["schedule"]))
            continue
        exh = r.get("exhaustive") or {}
        print("tune %s %s: winner %s, device / event ms %.5f / %.5f, default "
              "%s %.5f / %.5f, speedup_vs_default %.3f; n_timed %d, n_pruned "
              "%d; ranked %s wall %.3f s, exhaustive wall %s s (n_timed %s)"
              % (label, key, w["schedule"], w["ms_per_iter"],
                 w["event_ms_per_iter"], w["default_schedule"],
                 w["default_ms_per_iter"], w["default_event_ms_per_iter"],
                 w["speedup_vs_default"], r["n_timed"], r["n_pruned"],
                 (r.get("ranker") or {}).get("mode"), r.get("wall_s") or 0,
                 exh.get("wall_s"), exh.get("n_timed")))
        for t in r["trajectory"]:
            print("tune %s   %-9s %s%s" % (
                label, t["status"], t["schedule"],
                "  device / event ms %.5f / %.5f" % (
                    t["ms_per_iter"], t["event_ms_per_iter"])
                if "ms_per_iter" in t else
                "  (%s)" % t["reason"] if "reason" in t else ""))


def _tuned_steps(torch, np, fa, fb, tune, profiler):
    """One transformer train step and one fused ResNet-50 TrainStep from the
    same params, untuned (MXNET_TPU_TUNE=0) and with the table armed:
    (losses, launches, tuning_stats of the armed runs)."""
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import TrainStep, functional_optimizer

    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, TRAIN_BATCH)
    n = RESNET_TRAIN_BATCH
    sym = resnet.get_symbol(fused=True, **RESNET)
    batch = {k: torch.as_tensor(v).to(CARD)
             for k, v in _resnet_batch(np, 0, n).items()}
    out = {}
    for armed in ("0", "1"):
        os.environ["MXNET_TPU_TUNE"] = armed
        tune.reset()
        profiler.tuning_reset()
        step, place = tfm.make_train_step(
            cfg, optimizer=dict(name="sgd", learning_rate=0.1, momentum=0.9))
        _reset_counts(fa)
        _carry, loss = step(place(params), tokens)
        t_loss, t_launch = loss.item(), _counts(fa)
        del _carry
        ts = TrainStep(sym, functional_optimizer(**RESNET_OPT),
                       compute_dtype="bfloat16", device=CARD)
        p, o, a = ts.init_params({"data": (n,) + RESNET["image_shape"],
                                  "softmax_label": (n,)},
                                 initializer=Xavier(), seed=0)
        _reset_fb_counts(fb)
        _carry, loss = ts(ts.place(p, o, a), batch)
        torch.cuda.synchronize()
        out[armed] = ((t_loss, loss.item()), (t_launch, _fb_counts(fb)),
                      profiler.tuning_stats())
        del _carry, p, o, a, ts
        gc.collect()
    os.environ.pop("MXNET_TPU_TUNE", None)
    return out


def tune_phase(torch, np, fa, fb):
    """The schedule autotuner on the card: every tile against its plain
    version; ``python -m mxnet_tpu_torch.tune --compare`` on a temporary
    table at the CLI's defaults and at the transformer's training key, then
    a second run that must be all cache hits; one transformer train step
    and one fused ResNet-50 TrainStep with the table armed (hits for their
    keys, the same launch counts, losses within the kernels' tolerance of
    the untuned steps); ``Module.fit`` with ``MXNET_TUNE_BACKGROUND=1``,
    which must commit a key at a drain boundary."""
    import logging
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler, tune
    from mxnet_tpu_torch.models import resnet

    _tile_checks(torch, fa, fb)
    prev = os.environ.get("MXNET_TPU_TUNE_TABLE")
    tmp = tempfile.mkdtemp(prefix="tune_table_")
    os.environ["MXNET_TPU_TUNE_TABLE"] = os.path.join(tmp, "table.json")
    try:
        tune.reset()
        profiler.tuning_reset()
        b, h, s, d, _causal = TUNE_TRAIN_KEY[0], TUNE_TRAIN_KEY[1], \
            TUNE_TRAIN_KEY[2], TUNE_TRAIN_KEY[4], 1
        n, hw, ci, co, _k, _s = TUNE_CONV
        conv = ["--batch", str(n), "--hw", str(hw), "--ci", str(ci), "--co",
                str(co)]
        train = ["--kernels", "flash_attention", "--no-decode",
                 "--flash-batch", str(b), "--heads", str(h), "--seq", str(s),
                 "--head-dim", str(d)]
        t0 = time.perf_counter()
        first = _tune_cli(["--compare"] + conv)
        first["tune"].update(_tune_cli(["--compare"] + train)["tune"])
        print("tune --compare: %d keys in %.1f s, table %s"
              % (len(first["tune"]), time.perf_counter() - t0,
                 first["table"]))
        _print_tune_report(first, "compare")
        keys = set(first["tune"])
        want = {tune.make_key(k, (n, hw, hw, ci, co, _k, _s), "bfloat16",
                              "cuda") for k in tune.FUSED_KINDS}
        want |= {tune.make_key("flash_attention", shape, "bfloat16", "cuda")
                 for shape in ((8, 8, 1024, 1024, 128, 1),
                               (8, 8, 1, 1024, 128, 0), TUNE_TRAIN_KEY)}
        if keys != want or first["backend"] != "cuda":
            raise RuntimeError("tune: keys %s, want %s" % (sorted(keys),
                                                           sorted(want)))
        again = _tune_cli(conv)
        again["tune"].update(_tune_cli(train)["tune"])
        hits = sum(r["cache_hit"] and r["n_timed"] == 0
                   for r in again["tune"].values())
        print("tune second run: %d of %d keys cache hits"
              % (hits, len(again["tune"])))
        if hits != len(want):
            raise RuntimeError("tune: the second run timed again")
        print(json.dumps({"tune": {k: {
            f: r["winner"].get(f) for f in (
                "schedule", "ms_per_iter", "event_ms_per_iter",
                "default_schedule", "default_ms_per_iter",
                "default_event_ms_per_iter", "speedup_vs_default")}
            for k, r in first["tune"].items()}, "backend": "cuda",
            "table": first["table"]}))

        steps = _tuned_steps(torch, np, fa, fb, tune, profiler)
        (t0_loss, r0_loss), launch0, _ = steps["0"]
        (t1_loss, r1_loss), launch1, stats = steps["1"]
        conv_keys = [k for k in want if k.startswith("fused_")]
        train_key = tune.make_key("flash_attention", TUNE_TRAIN_KEY,
                                  "bfloat16", "cuda")
        hit = {k: (stats.get("kernels") or {}).get(k, {}).get("source")
               for k in conv_keys + [train_key]}
        print("tune consult: transformer step loss untuned %.6f, tuned "
              "%.6f; ResNet-50 step loss untuned %.6f, tuned %.6f; launches "
              "untuned %s, tuned %s; table hits %d, misses %d, fallbacks %d; "
              "sources %s" % (t0_loss, t1_loss, r0_loss, r1_loss, launch0,
                              launch1, stats.get("hits", 0),
                              stats.get("misses", 0),
                              stats.get("fallbacks", 0), hit))
        want_launch = ((FULL["n_layers"],) * 3,
                       (B1_PER_FORWARD, B2_PER_STEP, B3_PER_STEP))
        if launch0 != launch1 or tuple(map(tuple, launch1)) != want_launch:
            raise RuntimeError("tune: launches %s / %s, want %s"
                               % (launch0, launch1, want_launch))
        if any(v != "table" for v in hit.values()):
            raise RuntimeError("tune: the steps missed their keys: %s" % hit)
        for a, b_ in ((t0_loss, t1_loss), (r0_loss, r1_loss)):
            if abs(a - b_) > TUNE_LOSS_TOL * abs(a):
                raise RuntimeError("tune: tuned loss %.6f vs %.6f" % (b_, a))

        # background tuning at Module.fit's drain boundary
        tune.reset()
        profiler.tuning_reset()
        os.environ["MXNET_TUNE_BACKGROUND"] = "1"
        nb = TUNE_FIT_BATCH
        rng = np.random.RandomState(1)
        x = rng.randn(nb * TUNE_FIT_BATCHES,
                      *RESNET["image_shape"]).astype(np.float32)
        y = rng.randint(0, RESNET["num_classes"],
                        (nb * TUNE_FIT_BATCHES,)).astype(np.float32)
        logging.getLogger().setLevel(logging.WARNING)
        mod = mx.mod.Module(resnet.get_symbol(fused=True, **RESNET),
                            context=mx.gpu(0))
        before = len(tune.get_table())
        t0 = time.perf_counter()
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=nb),
                num_epoch=TUNE_FIT_EPOCHS, optimizer="sgd",
                optimizer_params=FIT_OPT, initializer=mx.init.Xavier())
        torch.cuda.synchronize()
        bg = profiler.tuning_stats()
        tune.get_table().reload()
        committed = len(tune.get_table()) - before
        print("tune background: Module.fit %d epochs of %d batches of %d in "
              "%.1f s; slots %d, commits %d, table entries +%d; %d misses "
              "left in the registry" % (
                  TUNE_FIT_EPOCHS, TUNE_FIT_BATCHES, nb,
                  time.perf_counter() - t0, bg.get("bg_slots", 0),
                  bg.get("bg_commits", 0), committed,
                  len(tune.recorded_misses())))
        if bg.get("bg_commits", 0) < 1 or committed < 1:
            raise RuntimeError("tune: the background tuner committed nothing")
        return first
    finally:
        os.environ.pop("MXNET_TUNE_BACKGROUND", None)
        if prev is None:
            os.environ.pop("MXNET_TPU_TUNE_TABLE", None)
        else:
            os.environ["MXNET_TPU_TUNE_TABLE"] = prev
        tune.reset()


# The data plane (bench.py's fit and data variants, through the port):
# Module.fit of the unfused ResNet-50 v2 in fp32 over on-disk record
# shards, ShardedRecordStream -> ShardedBatchIter -> DeviceQueueIter, batch
# 128 (64, then 32, only on out-of-memory), 4 batches an epoch, 3 epochs;
# the same fit fed by NDArrayIter from the same decoded arrays in memory;
# a fused leg (B1-B3 behind the same feed, one epoch of 6 batches at 64);
# and the port's copy of tools/bench_data.py's measure at its defaults
DATA_FIT = dict(batches=(128, 64, 32), per_epoch=4, epochs=3, workers=2,
                prefetch=4, shape=(3, 224, 224), lr=0.1, momentum=0.9)
DATA_FUSED = dict(batch=64, per_epoch=6)
DATA_BENCH = dict(records=2048, shape=(3, 64, 64), batch=64, workers=2,
                  prefetch=4, num_shards=8, compute_ms=20.0, decode_reps=12)


def _fit_records(np, n, shape, seed=0):
    """bench.py's synthetic records: ``<f label><uint8 pixels>``."""
    import struct

    rng = np.random.RandomState(seed)
    px = int(np.prod(shape))
    return [struct.pack("<f", float(rng.randint(0, 1000)))
            + rng.randint(0, 256, px, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _batch_digest(np, batch):
    """sha1 over a batch's data and label bytes (host copies)."""
    import hashlib

    h = hashlib.sha1()
    for a in list(batch.data) + list(batch.label or []):
        h.update(np.ascontiguousarray(
            a.asnumpy() if hasattr(a, "asnumpy") else a).tobytes())
    return h.hexdigest()


def _data_stream(mpath, batch, shape, workers, prefetch):
    from functools import partial

    from mxnet_tpu_torch.data import (LocalLeaseAuthority, ShardedBatchIter,
                                      ShardedRecordStream, decode_image_f32)

    stream = ShardedRecordStream(
        mpath, lease_client=LocalLeaseAuthority(ttl=600.0), rank=0,
        decode=partial(decode_image_f32, shape=shape), workers=workers,
        prefetch=prefetch, chunk=batch)
    return ShardedBatchIter(stream, batch, shape)


def _fit_run(torch, np, mx, sym, make_train, batch, n, epochs, digest=False,
             fb=None):
    """``Module.fit`` of ``sym`` on ``[gpu(0)]`` with kvstore 'tpu' over
    ``make_train(module)``, then (past one epoch) one more epoch under the
    profiler; returns the record: images/s over epochs 1.. (epoch 0 pays
    the set-up), each epoch's mean cross-entropy (read once an epoch), the
    profiler's pipeline and io stats at each epoch's end, the first
    epoch's batch digests (``digest``), B1-B3 launches a batch (``fb``)
    and the profiled epoch's wall and device busy time."""
    from mxnet_tpu_torch import profiler

    per_epoch = n // batch
    mod = mx.mod.Module(sym, context=[mx.gpu(0)])
    train = make_train(mod)
    rec = {"times": [], "io": [], "pipe": [], "ce": [], "digests": [],
           "per_batch": [], "profile": {}, "epochs": epochs}
    last = {"counts": _fb_counts(fb) if fb else (0, 0, 0)}

    def on_batch(param):
        if digest and param.epoch == 0:
            rec["digests"].append(_batch_digest(np,
                                                param.locals["data_batch"]))
        if fb is not None:
            counts = _fb_counts(fb)
            rec["per_batch"].append(tuple(
                a - b for a, b in zip(counts, last["counts"])))
            last["counts"] = counts
        if param.nbatch == per_epoch - 1:
            rec["ce"].append(float(param.eval_metric.get()[1]))

    def on_epoch(*_):
        torch.cuda.synchronize()
        rec["times"].append(time.perf_counter())
        rec["io"].append(profiler.io_stats())
        rec["pipe"].append(profiler.pipeline_stats())

    kw = dict(kvstore="tpu", optimizer="sgd",
              optimizer_params={"learning_rate": DATA_FIT["lr"],
                                "momentum": DATA_FIT["momentum"]},
              eval_metric="ce", batch_end_callback=on_batch,
              epoch_end_callback=on_epoch)
    try:
        mx.random.seed(0)
        profiler.pipeline_reset()
        profiler.io_reset()
        torch.cuda.synchronize()
        rec["t0"] = time.perf_counter()
        mod.fit(train, num_epoch=epochs, initializer=mx.init.Xavier(), **kw)
        rec["fused"] = mod._fused is not None
        if epochs > 1:
            # one more epoch through the same feed under the profiler: the
            # device's busy share of the fit loop
            _device_profile(torch, lambda: mod.fit(
                train, begin_epoch=epochs, num_epoch=epochs + 1, **kw),
                top=5, stats=rec["profile"])
    finally:
        close = getattr(train, "close", None)
        if callable(close):
            close()
        del mod
        gc.collect()
    t = rec["times"]
    rec["img_s"] = n * (epochs - 1) / (t[epochs - 1] - t[0]) \
        if epochs > 1 else n / (t[0] - rec["t0"])
    return rec


def _fit_summary(rec, batch):
    """bench.py's fit record, under its key names, at the last epoch's end
    (fit resets the feed after it, and the feed reads ahead into an epoch
    nobody trains), with the input-wait share of epochs 1.. and the
    profiled epoch's device busy share."""
    e = rec["epochs"]
    pipe, io = rec["pipe"][e - 1], rec["io"][e - 1]
    wall = rec["times"][e - 1] - rec["times"][0]
    waited = io.get("wait_seconds", 0.0) - rec["io"][0].get("wait_seconds",
                                                             0.0)
    out = {"img_s": rec["img_s"], "variant": "fit", "batch": batch,
           "host_syncs": pipe.get("host_syncs", 0),
           "avg_put_ms": pipe.get("avg_put_ms"),
           "avg_stall_feed_ms": pipe.get("avg_stall_feed_ms"),
           "io_records": io.get("records", 0),
           "io_wait_s": io.get("wait_seconds", 0.0),
           "io_wait_p99_ms": io.get("input_wait_p99_ms"),
           "input_wait_share": waited / wall, "epoch_ce": rec["ce"][:e],
           "fused": rec["fused"]}
    p = rec["profile"]
    if p:
        out["profiled_epoch_busy_share"] = p["busy_ms"] / p["wall_ms"]
    return out


def _data_bench_decode(raw, seed, shape=(3, 64, 64), reps=12):
    """tools/bench_data.py's decode_heavy: decode_image_f32 plus ``reps``
    dense passes over the pixels (a JPEG decode and augmentation's cost).
    Module level: the spawn pool pickles it by reference."""
    import numpy as np

    from mxnet_tpu_torch.data import decode_image_f32

    img, label = decode_image_f32(raw, seed, shape=shape)
    x = img
    for _ in range(reps):
        x = np.sqrt(x * x + 1e-6)
    return x.astype(np.float32), label


def _data_bench_pass(np, mpath, shape, batch, workers, prefetch, compute_s,
                     reps):
    """One warm-up epoch, then one measured epoch under a fixed simulated
    step (the host sleeps); returns (records/s, input-wait share, p50 ms,
    p99 ms) (tools/bench_data.py's _run_pass)."""
    from functools import partial

    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.data import (LocalLeaseAuthority, ShardedBatchIter,
                                      ShardedRecordStream)

    stream = ShardedRecordStream(
        mpath, lease_client=LocalLeaseAuthority(ttl=600.0), rank=0,
        decode=partial(_data_bench_decode, shape=shape, reps=reps),
        workers=workers, prefetch=prefetch, chunk=batch)
    it = ShardedBatchIter(stream, batch, shape)
    try:
        for _ in it:
            pass
        it.reset()
        next(it)
        profiler.io_reset()
        consumed = 0
        t0 = time.perf_counter()
        for b in it:
            consumed += b.data[0].shape[0]
            time.sleep(compute_s)
        wall = time.perf_counter() - t0
        st = profiler.io_stats()
        return (consumed / wall, st.get("wait_seconds", 0.0) / wall,
                st.get("input_wait_p50_ms"), st.get("input_wait_p99_ms"))
    finally:
        stream.close()


def _replay_identical(np, mpath, shape, batch):
    """Epoch 0 read whole, and split across a mid-epoch handoff between two
    consumers, decodes to the same bytes (tools/bench_data.py's
    replay_identical)."""
    import hashlib
    from functools import partial

    from mxnet_tpu_torch.data import (LocalLeaseAuthority,
                                      ShardedRecordStream, decode_image_f32)

    def stream(auth, rank):
        return ShardedRecordStream(
            mpath, lease_client=auth, rank=rank,
            decode=partial(decode_image_f32, shape=shape), workers=0,
            prefetch=0, chunk=batch, deterministic=True)

    def hashes(pairs):
        return {(s, i): hashlib.sha1(img.tobytes() + np.float32(
            lbl).tobytes()).hexdigest() for s, i, (img, lbl) in pairs}

    full_stream = stream(LocalLeaseAuthority(ttl=600.0), 0)
    try:
        full = hashes(full_stream.epoch_records())
    finally:
        full_stream.close()
    auth = LocalLeaseAuthority(ttl=600.0)
    a = stream(auth, 0)
    it = a.epoch_records()
    half = [next(it) for _ in range(len(full) // 2)]
    it.close()
    a.close()
    b = stream(auth, 1)
    try:
        rest = list(b.epoch_records())
    finally:
        b.close()
    return hashes(half + rest) == full


def data_bench_measure(np, root, records, shape, batch, workers, prefetch,
                       num_shards, compute_ms, decode_reps):
    """The port's copy of tools/bench_data.py's ``measure``: sync and
    prefetched passes and the deterministic-replay check, one record."""
    import struct

    from mxnet_tpu_torch.data import write_record_shards

    rng = np.random.RandomState(0)
    n = int(np.prod(shape))
    mpath = write_record_shards(
        root, "benchimgs",
        [struct.pack("<f", float(i % 1000))
         + rng.randint(0, 256, n, dtype=np.uint8).tobytes()
         for i in range(records)], num_shards=num_shards)
    sync_rs, sync_frac, _, _ = _data_bench_pass(
        np, mpath, shape, batch, 0, 0, compute_ms / 1000.0, decode_reps)
    pre_rs, pre_frac, p50, p99 = _data_bench_pass(
        np, mpath, shape, batch, workers, prefetch, compute_ms / 1000.0,
        decode_reps)
    return {"metric": "data_plane_throughput", "value": pre_rs,
            "unit": "records/s", "variant": "data", "records_s": pre_rs,
            "sync_records_s": sync_rs, "speedup_vs_sync": pre_rs / sync_rs,
            "input_wait_frac_prefetch": pre_frac,
            "input_wait_frac_sync": sync_frac, "input_wait_p50_ms": p50,
            "input_wait_p99_ms": p99,
            "deterministic_replay_identical": bool(_replay_identical(
                np, mpath, shape, batch)),
            "records": records, "batch": batch, "decode_workers": workers,
            "prefetch": prefetch, "compute_ms": compute_ms,
            "decode_reps": decode_reps}


def data_plane_phase(torch, np, fa, fb):
    """The port's data plane on the card (see DATA_FIT); returns the launch
    counts of B5, B6, B7, B1, B2, B3 on its main path (the unfused fit runs
    none of them; the fused leg runs B1-B3)."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.data import (decode_image_f32,
                                      iter_manifest_records, record_seed,
                                      write_record_shards)
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel.feed import DeviceQueueIter

    shape = DATA_FIT["shape"]
    epochs, per_epoch = DATA_FIT["epochs"], DATA_FIT["per_epoch"]
    try:
        import PIL
        pil = "Pillow %s" % PIL.__version__
    except ImportError:
        pil = "no Pillow (encoded images cannot be decoded; .npy records can)"
    print("data plane: %s on this machine" % pil)
    root = tempfile.mkdtemp(prefix="data_plane_")
    gc.collect()
    try:
        _reset_counts(fa)
        _reset_fb_counts(fb)
        sym = resnet.get_symbol(num_classes=1000, num_layers=50,
                                image_shape=shape, fused=False)

        def feed(mpath, batch):
            return lambda mod: DeviceQueueIter(_data_stream(
                mpath, batch, shape, DATA_FIT["workers"],
                DATA_FIT["prefetch"]), module=mod)

        rec = None
        for batch in DATA_FIT["batches"]:
            n = per_epoch * batch
            mpath = write_record_shards(root, "fitimgs%d" % batch,
                                        _fit_records(np, n, shape))
            try:
                rec = _fit_run(torch, np, mx, sym, feed(mpath, batch), batch,
                               n, epochs, digest=True)
                break
            except torch.cuda.OutOfMemoryError:
                gc.collect()
                torch.cuda.empty_cache()
                print("data plane fit: out of memory at batch %d" % batch)
        if rec is None:
            raise RuntimeError("data plane fit: out of memory at every "
                               "batch")
        unfused_launches = _counts(fa) + _fb_counts(fb)
        fit = _fit_summary(rec, batch)
        print("data plane fit, unfused ResNet-50 fp32 (ShardedRecordStream "
              "-> ShardedBatchIter -> DeviceQueueIter; %d records of %d "
              "bytes in %d shards, %d epochs): %s"
              % (n, 4 + int(np.prod(shape)), 8, epochs, json.dumps(fit)))

        # the first epoch's batches as the feed placed them, against a
        # synchronous read (prefetch 0, workers 0) of the same shards
        sync = _data_stream(mpath, batch, shape, 0, 0)
        try:
            want = [_batch_digest(np, b) for b in sync]
        finally:
            sync.close()
        digests_equal = want == rec["digests"]
        print("data plane fit: the first epoch's %d placed batches' sha1 "
              "equal a synchronous read's: %s" % (len(want), digests_equal))

        # the same fit from the same (epoch 0) decoded arrays in memory
        rows = [decode_image_f32(raw, record_seed(0, s, i), shape=shape)
                for s, i, raw in iter_manifest_records(mpath)]
        x = np.stack([r[0] for r in rows])
        y = np.asarray([r[1] for r in rows], np.float32)
        del rows
        mem = _fit_run(torch, np, mx, sym,
                       lambda mod: mx.io.NDArrayIter(x, y, batch_size=batch),
                       batch, n, epochs)
        mem_fit = _fit_summary(mem, batch)
        del x, y
        print("data plane fit, the same from NDArrayIter in memory: %s; "
              "record shards / memory images/s %.3f"
              % (json.dumps(mem_fit), fit["img_s"] / mem_fit["img_s"]))

        # the fused leg: B1-B3 behind the same feed
        fbatch = DATA_FUSED["batch"]
        fn = DATA_FUSED["per_epoch"] * fbatch
        fpath = write_record_shards(root, "fusedimgs",
                                    _fit_records(np, fn, shape, seed=1))
        _reset_counts(fa)
        _reset_fb_counts(fb)
        fused = _fit_run(torch, np, mx, resnet.get_symbol(
            num_classes=1000, num_layers=50, image_shape=shape, fused=True),
            feed(fpath, fbatch), fbatch, fn, 1, fb=fb)
        fused_launches = _counts(fa) + _fb_counts(fb)
        want_per = (B1_PER_FORWARD, B2_PER_STEP, B3_PER_STEP)
        print("data plane fused leg, fused ResNet-50 fp32 behind the same "
              "feed, 1 epoch of %d batches of %d: launches B1 %d, B2 %d, "
              "B3 %d (a batch: %s), mean cross-entropy %.5f, %.1f images/s "
              "with the set-up" % (
                  DATA_FUSED["per_epoch"], fbatch, *fused_launches[3:],
                  " ".join("%d/%d/%d" % p for p in fused["per_batch"]),
                  fused["ce"][0], fused["img_s"]))

        bench = data_bench_measure(np, os.path.join(root, "bench"),
                                   **DATA_BENCH)
        print("data plane data (tools/bench_data.py's measure, the port's "
              "copy): %s" % json.dumps(bench))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    ce = rec["ce"][:epochs]
    if not (rec["fused"] and mem["fused"] and fused["fused"]):
        raise RuntimeError("data plane: the fused SPMD group was not engaged")
    if fit["io_records"] != epochs * n:
        raise RuntimeError("data plane: %d records read in %d epochs of %d"
                           % (fit["io_records"], epochs, n))
    if not all(math.isfinite(v) for v in ce + mem["ce"] + fused["ce"]) or \
            not ce[-1] < ce[0]:
        raise RuntimeError("data plane: epoch cross-entropy %s (and %s, "
                           "%s): not finite, or not falling" % (
                               ce, mem["ce"], fused["ce"]))
    if not digests_equal:
        raise RuntimeError("data plane: the placed batches differ from a "
                           "synchronous read of the same shards")
    if any(unfused_launches):
        raise RuntimeError("data plane: the unfused fit launched hand "
                           "kernels %s" % (unfused_launches,))
    if len(fused["per_batch"]) != DATA_FUSED["per_epoch"] or \
            any(p != want_per for p in fused["per_batch"]):
        raise RuntimeError("data plane: fused leg launches a batch %s, want "
                           "%s" % (fused["per_batch"], want_per))
    if not bench["deterministic_replay_identical"]:
        raise RuntimeError("data plane: the deterministic replay differs")
    return fused_launches


# ---------------------------------------------------------------------------
# sparse arrays and the parameter-server tier (sparse_phase, embed_phase)
# ---------------------------------------------------------------------------
# Criteo-shaped sparse linear classification (the path of
# examples/sparse/linear_classification.py): 13 integer and 26 categorical
# fields hashed into 1,000,000 features, 39 nonzeros a row
SPARSE_LC = dict(features=1000000, int_fields=13, cat_fields=26,
                 batch=8192, batches=20, seed=0,
                 sgd=dict(learning_rate=20.0, wd=0.0),
                 adam=dict(learning_rate=0.05))
# MovieLens-20M-shaped matrix factorization (examples/recommenders/
# matrix_fact.py at GroupLens's ml-20m counts) through Module.fit with
# sparse_row_id_fn on a kv.create("local") instance
SPARSE_MF = dict(users=138493, items=27278, factor=64, batch=8192,
                 batches=40, rank=8, zipf=1.1, seed=1,
                 opt=dict(learning_rate=5.0, momentum=0.9))
SPARSE_DOT_TOL = 1e-4           # card vs CPU, relative to the largest |ref|
SPARSE_UPDATE_TOL = 1e-5        # touched rows, card vs CPU
SPARSE_FIRST_LAST = 3           # batches averaged at each end
# tools/bench_embed.py's measure defaults, then 32x the rows
EMBED_BENCH = dict(rows=131072, dim=64, servers=4, batch=4096, iters=8,
                   naive_batch=512, naive_iters=2, zipf_a=1.2, seed=0)
EMBED_BIG_ROWS = 2097152
EMBED_REPLAY_TOL = 1e-5
# the dense Module.fit through two in-process servers
SERVER_FIT = dict(n=600, dim=20, hidden=32, classes=5, batch=100, epochs=8)


def _card_ctx(torch, mx):
    """The context of the card (``CARD``)."""
    return mx.Context.from_device(torch.device(CARD))


def _sync(torch):
    if CARD == "cuda":
        torch.cuda.synchronize()


def _free(torch):
    gc.collect()
    if CARD == "cuda":
        torch.cuda.empty_cache()



def _field_ids(np, field, values, features):
    """Hashed feature ids of one field's values (stable, int64)."""
    return (np.int64(field) * 1000003 + values.astype(np.int64)
            * 2654435761) % features


def _finite_zipf(np, rng, n_ids, size, s):
    """``size`` ids in [0, n_ids) with P(k) proportional to 1/(k+1)**s
    (the popular ids first, as real catalogs are)."""
    cdf = np.cumsum(1.0 / np.arange(1, n_ids + 1, dtype=np.float64) ** s)
    return np.minimum(np.searchsorted(cdf / cdf[-1], rng.rand(size)),
                      n_ids - 1)


def criteo_batches(np, features, batch, batches, int_fields=13,
                   cat_fields=26, seed=0):
    """Criteo-shaped CSR batches from a seed, as (data, indices, indptr,
    label) triples: each integer field a log-scaled count in its own
    hashed column, each categorical field a zipf-distributed category
    hashed with its field; labels from a hidden linear model."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(features).astype(np.float32)
    card = rng.randint(10, 200000, cat_fields)
    nnz_row = int_fields + cat_fields
    int_cols = _field_ids(np, np.arange(int_fields), np.zeros(int_fields),
                          features)
    out = []
    for _ in range(batches):
        counts = rng.geometric(0.05, (batch, int_fields)) - 1
        ivals = (np.log1p(counts) / 5.0).astype(np.float32)
        cids = np.stack([_field_ids(np, int_fields + f, _finite_zipf(
            np, rng, card[f], batch, 1.1), features)
            for f in range(cat_fields)], 1)
        idx = np.concatenate([np.broadcast_to(int_cols, (batch, int_fields)),
                              cids], 1).reshape(-1)
        vals = np.concatenate([ivals, np.ones((batch, cat_fields),
                                              np.float32)], 1).reshape(-1)
        logit = (vals * w_true[idx]).reshape(batch, nnz_row).sum(1)
        y = (logit + 0.3 * rng.randn(batch) > 0).astype(np.float32)
        ptr = np.arange(batch + 1, dtype=np.int64) * nnz_row
        out.append((vals, idx.astype(np.int64), ptr, y))
    return out


def _lc_step(torch, mx, csr, w, y, batch):
    """One batch of the example's loop: score, accuracy (on the card),
    the logistic gradient csr^T (p - y) / B as a row-sparse array over
    the batch's features."""
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

    prob = mx.nd.sigmoid(mx.nd.dot(csr, w))
    acc = ((prob > 0.5) == y).mean()
    g = mx.nd.dot(csr, (prob - y) / batch, transpose_a=True)
    nz = mx.nd.NDArray(torch.unique(csr.indices.tensor), csr.context)
    return acc, RowSparseNDArray(g[nz], nz, w.shape, ctx=csr.context)


def _lc_run(torch, np, mx, batches, ctx, opt_name, opt_kw, w0, cfg):
    """The classification leg: ``len(batches)`` batches from ``w0``;
    returns (weight NDArray, per-batch accuracy, seconds)."""
    opt = mx.optimizer.create(opt_name, **opt_kw)
    w = mx.nd.array(w0, ctx=ctx)
    state = opt.create_state(0, w)
    accs = []
    shape = (cfg["batch"], cfg["features"])
    _sync(torch)
    t0 = time.perf_counter()
    for vals, idx, ptr, y in batches:
        csr = mx.nd.sparse.csr_matrix((vals, idx, ptr), shape=shape,
                                      ctx=ctx)
        acc, grad = _lc_step(torch, mx, csr, w,
                             mx.nd.array(y[:, None], ctx=ctx),
                             cfg["batch"])
        accs.append(acc)
        opt.update(0, w, grad, state)
    accs = [float(a.asscalar()) for a in accs]
    return w, accs, time.perf_counter() - t0


def _rel_err(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _first_last(xs):
    k = SPARSE_FIRST_LAST
    return sum(xs[:k]) / k, sum(xs[-k:]) / k


def _sparse_classification(torch, np, mx):
    """The Criteo-shaped leg: card vs CPU checks of the products and the
    lazy updates, times at the full shape, 20 batches of lazy SGD twice
    (bit-identical) and once more profiled, 20 batches of lazy Adam."""
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

    cfg = SPARSE_LC
    d, b = cfg["features"], cfg["batch"]
    t0 = time.perf_counter()
    batches = criteo_batches(np, d, b, cfg["batches"],
                             cfg["int_fields"], cfg["cat_fields"],
                             cfg["seed"])
    gen_s = time.perf_counter() - t0
    w0 = (np.random.RandomState(5).randn(d, 1) * 0.01).astype(np.float32)
    touched = np.unique(np.concatenate([bt[1] for bt in batches]))
    print("sparse classification: %d batches of %d rows x %d features, %d "
          "nonzeros a row (%d integer + %d categorical fields), made from "
          "seed %d in %.1f s; %d of %d features ever touched"
          % (cfg["batches"], b, d, cfg["int_fields"] + cfg["cat_fields"],
             cfg["int_fields"], cfg["cat_fields"], cfg["seed"], gen_s,
             touched.size, d))

    # -- card vs CPU: the products and one lazy update of each kind -----
    gpu, cpu = _card_ctx(torch, mx), mx.cpu()
    vals, idx, ptr, y = batches[0]
    csr = {c: mx.nd.sparse.csr_matrix((vals, idx, ptr), shape=(b, d), ctx=c)
           for c in (gpu, cpu)}
    rng = np.random.RandomState(6)
    rhs = rng.randn(d, 1).astype(np.float32)
    err = rng.randn(b, 1).astype(np.float32)
    errs = {}
    for name, arg, tr in (("csr.dense", rhs, False),
                          ("csrT.dense", err, True)):
        got = {c: mx.nd.dot(csr[c], mx.nd.array(arg, ctx=c),
                            transpose_a=tr).tensor for c in (gpu, cpu)}
        errs[name] = _rel_err(got[gpu], got[cpu])
    acc, grad = _lc_step(torch, mx, csr[gpu], mx.nd.array(w0, ctx=gpu),
                         mx.nd.array(y[:, None], ctx=gpu), b)
    rows = grad.indices.tensor
    untouched = torch.ones(d, dtype=torch.bool, device=CARD)
    untouched[rows] = False
    for name, kw in (("sgd", dict(learning_rate=0.5, wd=1e-4)),
                     ("sgd_momentum", dict(learning_rate=0.5, momentum=0.9)),
                     ("adam", dict(learning_rate=0.01))):
        out = {}
        for c in (gpu, cpu):
            opt = mx.optimizer.create(name.split("_")[0], **kw)
            w = mx.nd.array(w0, ctx=c)
            st = opt.create_state(0, w)
            g = RowSparseNDArray(grad.data.copyto(c), grad.indices.copyto(c),
                                 grad.shape, ctx=c)
            for _ in range(2):
                opt.update(0, w, g, st)
            out[c] = w.tensor
        w0_t = torch.from_numpy(w0).to(CARD)
        if not torch.equal(out[gpu][untouched], w0_t[untouched]):
            raise RuntimeError("sparse: lazy %s moved a row absent from the "
                               "gradient" % name)
        errs["lazy " + name] = _rel_err(out[gpu][rows], out[cpu][rows.cpu()])
    print("sparse classification, card vs CPU on batch 0 (%d touched rows): "
          "%s (relative to the largest |ref|); rows absent from the "
          "gradient bit for bit unchanged" % (
              rows.numel(), ", ".join("%s %.3g" % kv for kv in errs.items())))
    for name, e in errs.items():
        tol = SPARSE_UPDATE_TOL if name.startswith("lazy") else SPARSE_DOT_TOL
        if not e <= tol:
            raise RuntimeError("sparse: %s card vs CPU %.3g > %g"
                               % (name, e, tol))
    c = csr[gpu]
    del csr

    # -- device times at the Criteo shape --------------------------------
    w_t = mx.nd.array(rhs, ctx=gpu)
    e_t = mx.nd.array(err, ctx=gpu)
    times = {"csr.dense": _time_ms(torch, lambda: mx.nd.dot(c, w_t)),
             "csrT.dense": _time_ms(torch, lambda: mx.nd.dot(
                 c, e_t, transpose_a=True))}
    opt = mx.optimizer.create("sgd", learning_rate=0.5, momentum=0.9)
    w_u = mx.nd.array(w0, ctx=gpu)
    st = opt.create_state(0, w_u)
    times["lazy sgd_momentum"] = _time_ms(
        torch, lambda: opt.update(0, w_u, grad, st))
    _free(torch)
    dense = c.tostype("default").tensor          # (8192, 1e6) fp32
    times["dense matmul X.w"] = _time_ms(
        torch, lambda: torch.matmul(dense, w_t.tensor), reps=10, warmup=3)
    times["dense matmul X^T.err"] = _time_ms(
        torch, lambda: torch.matmul(dense.t(), e_t.tensor), reps=10,
        warmup=3)
    dense_gb = dense.numel() * 4 / 1e9
    del dense
    _free(torch)
    print("sparse classification times at (%d x %d, %d nonzeros), event / "
          "device ms: %s; the dense products on the densified batch "
          "(%.1f GB fp32, TF32 off)" % (b, d, idx.size, "; ".join(
              "%s %s" % (k, _both(t)) for k, t in times.items()), dense_gb))

    # -- the leg: lazy SGD twice (bit-identical), profiled, lazy Adam ----
    w1, acc1, s1 = _lc_run(torch, np, mx, batches, gpu, "sgd", cfg["sgd"],
                           w0, cfg)
    w2, acc2, s2 = _lc_run(torch, np, mx, batches, gpu, "sgd", cfg["sgd"],
                           w0, cfg)
    identical = torch.equal(w1.tensor, w2.tensor) and acc1 == acc2
    untouched = torch.ones(d, dtype=torch.bool, device=CARD)
    untouched[torch.from_numpy(touched).to(CARD)] = False
    w0_t = torch.from_numpy(w0).to(CARD)
    kept = torch.equal(w1.tensor[untouched], w0_t[untouched])
    stats = {}
    _device_profile(torch, lambda: _lc_run(torch, np, mx, batches[:5], gpu,
                                           "sgd", cfg["sgd"], w0, cfg),
                    top=6, stats=stats)
    wa, acca, sa = _lc_run(torch, np, mx, batches, gpu, "adam", cfg["adam"],
                           w0, cfg)
    kept_a = torch.equal(wa.tensor[untouched], w0_t[untouched])
    for name, accs, secs in (("lazy SGD", acc1, s1), ("lazy Adam", acca, sa)):
        first, last = _first_last(accs)
        print("sparse classification %s (%s): %d batches in %.2f s, %.4f s a "
              "batch; accuracy first %d batches %.4f, last %d %.4f"
              % (name, json.dumps(cfg["sgd" if "SGD" in name else "adam"]),
                 len(accs), secs, secs / len(accs), SPARSE_FIRST_LAST, first,
                 SPARSE_FIRST_LAST, last))
        if not last > first:
            raise RuntimeError("sparse: %s accuracy did not improve: %s"
                               % (name, accs))
    print("sparse classification lazy SGD: second run %.2f s, weights and "
          "accuracies bit-identical to the first: %s; %d never-touched rows "
          "bit for bit the initial values (SGD %s, Adam %s); 5 profiled "
          "batches: device busy share %s"
          % (s2, identical, int(untouched.sum()), kept, kept_a,
             "%.3f" % (stats["busy_ms"] / stats["wall_ms"]) if stats
             else "not measured"))
    if not identical:
        raise RuntimeError("sparse: two runs of the classification leg "
                           "differ")
    if not (kept and kept_a):
        raise RuntimeError("sparse: a never-touched weight row moved")
    return {"lc_s_batch": s1 / len(acc1), "adam_s_batch": sa / len(acca),
            "lc_busy": stats}


def mf_ratings(np, users, items, n, rank, zipf, seed):
    """Synthetic ratings from a hidden rank-``rank`` model, user and item
    ids from finite Zipf laws (popular ids first, as real catalogs are)."""
    rng = np.random.RandomState(seed)
    gu = (rng.randn(users, rank) / np.sqrt(rank)).astype(np.float32)
    gi = rng.randn(items, rank).astype(np.float32)
    u = _finite_zipf(np, rng, users, n, zipf)
    i = _finite_zipf(np, rng, items, n, zipf)
    r = (gu[u] * gi[i]).sum(1) + 0.1 * rng.randn(n)
    return u.astype(np.float32), i.astype(np.float32), r.astype(np.float32)


def mf_symbol(mx, users, items, factor):
    user, item = mx.sym.var("user"), mx.sym.var("item")
    u = mx.sym.Embedding(data=user, input_dim=users, output_dim=factor,
                         name="user_embed")
    i = mx.sym.Embedding(data=item, input_dim=items, output_dim=factor,
                         name="item_embed")
    return mx.sym.LinearRegressionOutput(
        data=mx.sym.sum(u * i, axis=1), label=mx.sym.var("score"),
        name="lro")


def _sparse_mf(torch, np, mx):
    """The MovieLens-20M-shaped Module.fit with sparse_row_id_fn."""
    cfg = SPARSE_MF
    n = cfg["batch"] * cfg["batches"]
    u, i, r = mf_ratings(np, cfg["users"], cfg["items"], n, cfg["rank"],
                         cfg["zipf"], cfg["seed"])
    it = mx.io.NDArrayIter({"user": u, "item": i}, {"score": r},
                           cfg["batch"], shuffle=False)
    mod = mx.mod.Module(mf_symbol(mx, cfg["users"], cfg["items"],
                                  cfg["factor"]),
                        context=_card_ctx(torch, mx),
                        data_names=("user", "item"), label_names=("score",))
    kv = mx.kv.create("local")
    pulled, losses = [], []

    def row_ids(batch):
        pulled.append(1)
        return {"user_embed_weight": batch.data[0],
                "item_embed_weight": batch.data[1]}

    def batch_loss(p):
        pred = mod.get_outputs()[0].tensor
        lab = p.locals["data_batch"].label[0].tensor.to(pred.device)
        losses.append(float(((pred - lab) ** 2).mean()))

    def fit():
        it.reset()
        mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
                optimizer_params=cfg["opt"],
                initializer=mx.init.Normal(0.1), eval_metric="mse",
                batch_end_callback=batch_loss, sparse_row_id_fn=row_ids,
                force_init=True)

    _sync(torch)
    t0 = time.perf_counter()
    fit()
    _sync(torch)
    secs = time.perf_counter() - t0
    first, last = _first_last(losses)
    n_prep = len(pulled)
    store_devices = {v.tensor.device.type for v in kv._store.values()}
    # row_sparse_pull returns exactly the rows asked for
    ids = np.array([5, 0, cfg["users"] - 1, 5, 77], np.int64)
    want = mod.get_params()[0]["user_embed_weight"].asnumpy()
    card = _card_ctx(torch, mx)
    rsp = mx.nd.sparse.zeros("row_sparse", want.shape, ctx=card)
    kv.row_sparse_pull("user_embed_weight", out=rsp,
                       row_ids=mx.nd.array(ids, ctx=card))
    dense = mx.nd.zeros(want.shape, ctx=card)
    kv.row_sparse_pull("user_embed_weight", out=dense,
                       row_ids=mx.nd.array(ids, ctx=card))
    uniq = np.unique(ids)
    dense_np = dense.asnumpy()
    exact = (rsp.indices.asnumpy().tolist() == uniq.tolist()
             and np.array_equal(rsp.data.asnumpy(), want[uniq])
             and np.array_equal(dense_np[uniq], want[uniq])
             and not np.delete(dense_np, uniq, axis=0).any())
    stats = {}
    n_prof = len(losses)
    _device_profile(torch, fit, top=6, stats=stats)
    print("sparse MF Module.fit (%d users, %d items, factor %d, batch %d, "
          "%d batches, SGD %s, kv.create('local') instance, "
          "sparse_row_id_fn): %.2f s, %.4f s a batch, %d prepares; MSE first "
          "%d batches %.4f, last %d %.4f; a second, profiled epoch: device "
          "busy share %s; row_sparse_pull exact (row-sparse and dense outs): "
          "%s; the store's values on %s"
          % (cfg["users"], cfg["items"], cfg["factor"], cfg["batch"],
             n_prof, json.dumps(cfg["opt"]), secs, secs / n_prof,
             n_prep, SPARSE_FIRST_LAST, first, SPARSE_FIRST_LAST, last,
             "%.3f" % (stats["busy_ms"] / stats["wall_ms"]) if stats
             else "not measured", exact, "/".join(sorted(store_devices))))
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise RuntimeError("sparse MF: loss did not fall: %s" % losses)
    if n_prep != cfg["batches"] - 1:
        raise RuntimeError("sparse MF: %d prepares, want %d"
                           % (n_prep, cfg["batches"] - 1))
    if not exact:
        raise RuntimeError("sparse MF: row_sparse_pull did not return "
                           "exactly the rows asked for")
    if store_devices != {CARD}:
        raise RuntimeError("sparse MF: the local store's values are on %s"
                           % store_devices)
    return {"mf_s_batch": secs / n_prof, "mf_busy": stats}


def sparse_phase(torch, np, fa, fb):
    """The sparse paths on the card (SPARSE_LC, SPARSE_MF); returns the
    launch counts of B5, B6, B7, B1, B2, B3 there (all 0: the JAX package
    leaves this work to XLA)."""
    import mxnet_tpu_torch as mx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _free(torch)
    _reset_counts(fa)
    _reset_fb_counts(fb)
    lc = _sparse_classification(torch, np, mx)
    mf = _sparse_mf(torch, np, mx)
    launches = _counts(fa) + _fb_counts(fb)
    print("sparse phase: %s; B5-B7 and B1-B3 launches %s" % (
        json.dumps({k: v for k, v in {**lc, **mf}.items()
                    if not k.endswith("busy")}), launches))
    if any(launches):
        raise RuntimeError("sparse: hand kernels launched %s" % (launches,))
    return launches


def _zipf_ids(np, rng, n, rows, a):
    """Zipfian ids clipped into the vocabulary (the hot head at low
    ids)."""
    return np.minimum(rng.zipf(a, n).astype(np.int64) - 1, rows - 1)


def embed_bench_measure(np, rows=131072, dim=64, servers=4, batch=4096,
                        iters=8, naive_batch=512, naive_iters=2,
                        zipf_a=1.2, seed=0, naive=True, sync=True,
                        check=None, profile=None, uris=None):
    """The port's copy of tools/bench_embed.py's ``measure``: in-process
    servers on the card (the default device) hold the row shards, or the
    servers at ``uris``; dedup train rounds (pull, scatter push) async,
    pull-only against the naive per-id baseline, the synchronous client,
    the 2-bit wire; per-server memory. ``check`` (a dict, in-process
    servers only) receives the raw-wire table's initial dense copy, the
    pushes as sent, its dense copy after the timed rounds and the servers'
    stored devices; ``profile`` is called with four more train rounds to
    run (after the memory read)."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.embedding import ShardedEmbeddingTable
    from mxnet_tpu_torch.kvstore_server import KVStoreServer, ServerKVStore

    srvs = []
    if uris is None:
        srvs = [KVStoreServer(num_workers=1, device=CARD)
                for _ in range(servers)]
        for s in srvs:
            s.serve_in_background()
        uris = ",".join(s.addr for s in srvs)
    rng = np.random.RandomState(seed)
    batches = [_zipf_ids(np, rng, batch, rows, zipf_a) for _ in range(iters)]
    uniq_frac = float(np.mean([np.unique(b).size / b.size for b in batches]))
    clients = []

    def client(pipeline=True, wire="raw"):
        kv = ServerKVStore(uris, pipeline=pipeline)
        clients.append(kv)
        kv.set_optimizer("sgd", learning_rate=0.05, momentum=0.9,
                         rescale_grad=1.0 / batch)
        t = ShardedEmbeddingTable("bench_emb", kv, rows, dim, wire=wire)
        t0 = time.perf_counter()
        t.init(seed=seed)
        return kv, t, time.perf_counter() - t0

    def train_round(t, ids):
        uniq, inverse, vecs = t.pull(ids)
        t.push(uniq, vecs * 0.01)

    def timed_rounds(t, kv, n):
        train_round(t, batches[0])
        kv.wait_outstanding()
        t0 = time.perf_counter()
        for i in range(n):
            train_round(t, batches[i % iters])
        kv.wait_outstanding()
        return (n * batch) / (time.perf_counter() - t0)

    rec = {"rows": rows, "dim": dim, "servers": servers, "batch": batch,
           "zipf_a": zipf_a, "unique_frac": round(uniq_frac, 4),
           "table_mb": round(rows * dim * 4 / 1e6, 1),
           "cores": len(os.sched_getaffinity(0))}
    try:
        profiler.embedding_reset()
        profiler.comm_reset()
        kv, t, init_s = client()
        rec["init_s"] = init_s
        if check is not None:
            check["init"] = t.as_dense()
            check["pushes"] = pushes = []
            push = t.push

            def recorded(ids, grads, priority=0):
                pushes.append((np.array(ids), np.array(grads)))
                return push(ids, grads, priority=priority)

            t.push = recorded
        rec["train_rows_s"] = timed_rounds(t, kv, iters)
        t0 = time.perf_counter()
        for i in range(iters):
            t.pull(batches[i % iters])
        rec["pull_rows_s"] = (iters * batch) / (time.perf_counter() - t0)
        stats = profiler.embedding_stats()
        rec["dedup_ratio"] = stats.get("dedup_ratio")
        rec["pull_p99_ms"] = stats.get("pull_p99_ms")
        rec["push_p99_ms"] = stats.get("push_p99_ms")
        rec["comm"] = {op: {k: s[k] for k in ("count", "avg_ms")
                            if k in s}
                       for op, s in profiler.comm_stats().items()}
        if check is not None:
            check["after"] = t.as_dense()
            check["pushes"] = list(check["pushes"])  # those before "after"
            check["devices"] = {k: d for s in srvs
                                for k, d in s.stored_devices().items()}
        if naive:
            t.dedup = False
            t0 = time.perf_counter()
            for i in range(max(1, naive_iters)):
                t.pull(batches[i % iters][:naive_batch])
            rec["naive_pull_rows_s"] = (max(1, naive_iters) * naive_batch) \
                / (time.perf_counter() - t0)
            t.dedup = True
            rec["speedup_dedup_vs_naive"] = rec["pull_rows_s"] / max(
                rec["naive_pull_rows_s"], 1e-9)
        mem = kv.server_memory()
        per = [m["embed_store_bytes"] + m["embed_opt_bytes"] for m in mem]
        rec["per_server_mb"] = [round(x / 1e6, 2) for x in per]
        rec["mem_ratio_max"] = max(per) / max(sum(per), 1)
        profiler.memory_record(embedding_per_server_bytes=per,
                               embedding_total_bytes=sum(per),
                               embedding_servers=servers)
        if profile is not None:
            def rounds():
                for _ in range(4):
                    train_round(t, batches[1])
                kv.wait_outstanding()

            profile(rounds)
        if sync:
            kv_s, t_s, _ = client(pipeline=False)
            rec["sync_train_rows_s"] = timed_rounds(t_s, kv_s, iters)
            rec["async_vs_sync"] = rec["train_rows_s"] / max(
                rec["sync_train_rows_s"], 1e-9)
        kv_2b, t_2b, _ = client(wire="2bit")
        rec["train_rows_s_2bit"] = timed_rounds(t_2b, kv_2b, iters)
    finally:
        for kv in clients:
            kv.close()
        for s in srvs:
            s.shutdown()
    return rec


# one KVStoreServer on the card in a process of its own: prints its
# address, serves until its stdin closes
_SERVER_PROC = (
    "import sys; sys.path.insert(0, sys.argv[1]); "
    "from mxnet_tpu_torch.kvstore_server import KVStoreServer; "
    "s = KVStoreServer(num_workers=1, device=sys.argv[2]); "
    "s.serve_in_background(); print(s.addr, flush=True); "
    "sys.stdin.read(); s.shutdown()")


def embed_out_of_process(np, cfg):
    """The embed measure with each server in a process of its own (as a
    deployment runs them), no naive leg: the pipelined client against the
    synchronous one without the servers sharing the client's interpreter.
    Every server process is stopped before this returns."""
    procs = [subprocess.Popen([sys.executable, "-c", _SERVER_PROC, ROOT,
                               CARD], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(cfg["servers"])]
    try:
        addrs = [p.stdout.readline().strip() for p in procs]
        if not all(addrs):
            raise RuntimeError("embed: a server process did not start: %s"
                               % [p.poll() for p in procs])
        return embed_bench_measure(np, naive=False, uris=",".join(addrs),
                                   **cfg)
    finally:
        for p in procs:
            p.stdin.close()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _embed_replay(np, check, batch):
    """The raw-wire table replayed in numpy from its initial copy through
    the pushes as sent: lazy momentum SGD (lr 0.05, momentum 0.9, rescale
    1/batch), duplicates summed first as the client does."""
    w = check["init"].astype(np.float32).copy()
    m = np.zeros_like(w)
    for ids, grads in check["pushes"]:
        uniq, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((uniq.size, w.shape[1]), np.float32)
        np.add.at(g, inv, grads.astype(np.float32))
        g = g * np.float32(1.0 / batch)
        m[uniq] = np.float32(0.9) * m[uniq] - np.float32(0.05) * g
        w[uniq] = w[uniq] + m[uniq]
    return w


def _server_module_fit(torch, np, mx):
    """Module.fit of a small MLP through two in-process servers (on the
    card): the loss falls and the servers hold the module's weights."""
    from mxnet_tpu_torch.kvstore_server import KVStoreServer, ServerKVStore

    cfg = SERVER_FIT
    rng = np.random.RandomState(0)
    x = rng.randn(cfg["n"], cfg["dim"]).astype(np.float32)
    y = np.argmax(x @ rng.randn(cfg["dim"], cfg["classes"]), 1).astype(
        np.float32)
    srvs = [KVStoreServer(num_workers=1, device=CARD) for _ in range(2)]
    for s in srvs:
        s.serve_in_background()
    kv = ServerKVStore([s.addr for s in srvs])
    try:
        it = mx.io.NDArrayIter({"data": x}, {"softmax_label": y},
                               batch_size=cfg["batch"], shuffle=False)
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc1",
                                    num_hidden=cfg["hidden"])
        net = mx.sym.Activation(net, name="relu1", act_type="relu")
        net = mx.sym.FullyConnected(net, name="fc2",
                                    num_hidden=cfg["classes"])
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(net, context=_card_ctx(torch, mx))
        ce = []

        def batch_ce(p):
            prob = mod.get_outputs()[0].tensor
            lab = p.locals["data_batch"].label[0].tensor.long().to(
                prob.device)
            ce.append(float(-prob.gather(1, lab[:, None]).clamp_min(
                1e-12).log().mean()))

        t0 = time.perf_counter()
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Xavier(), kvstore=kv,
                eval_metric="acc", num_epoch=cfg["epochs"],
                batch_end_callback=batch_ce)
        secs = time.perf_counter() - t0
        it.reset()
        acc = dict(mod.score(it, mx.metric.create("acc")))["accuracy"]
        arg, _ = mod.get_params()
        same = True
        for k, v in arg.items():
            held = np.empty(v.shape, np.float32)
            kv.pull(k, out=held)
            same = same and np.array_equal(held, v.asnumpy())
        devices = {d.type for s in srvs for d in s.stored_devices().values()}
        per_epoch = len(ce) // cfg["epochs"]
        first = sum(ce[:per_epoch]) / per_epoch
        last = sum(ce[-per_epoch:]) / per_epoch
        print("server tier Module.fit (MLP %d-%d-%d, %d epochs of %d batches "
              "through 2 servers on %s, SGD momentum on the servers): %.2f s; "
              "cross-entropy first epoch %.4f, last %.4f; accuracy %.4f; "
              "weights pulled from the servers equal the module's: %s; fused "
              "step engaged: %s"
              % (cfg["dim"], cfg["hidden"], cfg["classes"], cfg["epochs"],
                 per_epoch, "/".join(sorted(devices)), secs, first, last,
                 acc, same, mod._fused is not None))
    finally:
        kv.close()
        for s in srvs:
            s.shutdown()
    if not (last < first and acc > 0.9 and same and mod._fused is None
            and devices == {CARD}):
        raise RuntimeError("server tier fit: loss %s -> %s, acc %s, "
                           "weights equal %s, devices %s"
                           % (first, last, acc, same, devices))


def embed_phase(torch, np, fa, fb):
    """The server tier and ``bench.py``'s embed variant on the card
    (EMBED_BENCH in-process and with the servers in processes of their
    own, EMBED_BIG_ROWS, SERVER_FIT); returns the launch counts of B5, B6,
    B7, B1, B2, B3 there (all 0)."""
    import mxnet_tpu_torch as mx

    _reset_counts(fa)
    _reset_fb_counts(fb)
    cfg = dict(EMBED_BENCH)
    check = {}
    stats = {}
    rec = embed_bench_measure(
        np, check=check, profile=lambda fn: _device_profile(
            torch, fn, top=6, stats=stats), **cfg)
    replay = _embed_replay(np, check, cfg["batch"])
    replay_err = float(np.abs(check["after"] - replay).max()
                       / max(np.abs(replay).max(), 1e-30))
    n_pushes = len(check["pushes"])
    cuda_tables = {d.type for d in check["devices"].values()} == {CARD}
    rec["busy_share_4_rounds"] = (stats["busy_ms"] / stats["wall_ms"]
                                  if stats else "not measured")
    print("embed (the port's copy of tools/bench_embed.py's measure, %d "
          "servers on the card): %s" % (cfg["servers"], json.dumps(rec)))
    print("embed check: as_dense() after the timed rounds against a numpy "
          "replay of the %d pushes as sent (lazy momentum SGD): %.3g "
          "relative; stored tables on %s; mem_ratio_max %.4f (limit %.4f)"
          % (n_pushes, replay_err,
             "/".join(sorted({d.type for d in check["devices"].values()})),
             rec["mem_ratio_max"], 1.0 / cfg["servers"] + 0.01))
    if not replay_err <= EMBED_REPLAY_TOL:
        raise RuntimeError("embed: the table differs from the replay "
                           "(%.3g)" % replay_err)
    if not cuda_tables:
        raise RuntimeError("embed: stored tables not on the card: %s"
                           % check["devices"])
    if not rec["mem_ratio_max"] <= 1.0 / cfg["servers"] + 0.01:
        raise RuntimeError("embed: mem_ratio_max %.4f" % rec["mem_ratio_max"])
    big = dict(cfg, rows=EMBED_BIG_ROWS)
    big_check = {}
    rec_big = embed_bench_measure(np, naive=False, sync=False,
                                  check=big_check, **big)
    big_cuda = {d.type for d in big_check["devices"].values()} == {CARD}
    print("embed at %d rows (%.2f GB fp32 table + as much momentum across "
          "%d servers on the card; init %.2f s, each sub-table crossing the "
          "loopback once; no naive or sync legs): %s"
          % (EMBED_BIG_ROWS, EMBED_BIG_ROWS * cfg["dim"] * 4 / 1e9,
             cfg["servers"], rec_big["init_s"], json.dumps(rec_big)))
    if not (big_cuda and rec_big["mem_ratio_max"]
            <= 1.0 / cfg["servers"] + 0.01):
        raise RuntimeError("embed big: tables on the card %s, "
                           "mem_ratio_max %.4f" % (big_cuda,
                                                   rec_big["mem_ratio_max"]))
    del big_check
    rec_oop = embed_out_of_process(np, cfg)
    print("embed with each of the %d servers in a process of its own on the "
          "card (no naive leg): %s; pipelined client against the "
          "synchronous one: in-process %.3f, out of process %.3f"
          % (cfg["servers"], json.dumps(rec_oop), rec["async_vs_sync"],
             rec_oop["async_vs_sync"]))
    if not rec_oop["mem_ratio_max"] <= 1.0 / cfg["servers"] + 0.01:
        raise RuntimeError("embed out of process: mem_ratio_max %.4f"
                           % rec_oop["mem_ratio_max"])
    _server_module_fit(torch, np, mx)
    launches = _counts(fa) + _fb_counts(fb)
    print("embed phase: B5-B7 and B1-B3 launches %s" % (launches,))
    if any(launches):
        raise RuntimeError("embed: hand kernels launched %s" % (launches,))
    return launches


# ---------------------------------------------------------------------------
# the MoE transformer (ROADMAP.md Queue A item 8c, first part): FULL with 8
# experts in every block, each computed (the dense soft-gated mixture)
# ---------------------------------------------------------------------------
MOE = dict(FULL, n_experts=8)
MOE_BATCH, MOE_STEPS = (8, 2049), 5
# first loss of random weights: the same tied head as the dense model, so
# ln(32000) plus half the logits' variance (~0.1), held to ln(32000) +- 0.25
MOE_FIRST_LOSS, MOE_FIRST_LOSS_TOL = math.log(32000), 0.25
# card vs CPU gradients of a 2-layer fp32 MoE, by grad_phase's rule with
# the one-rounding yardstick: 8 experts hold 8x the dense model's ReLU
# units, and a pre-activation within ~1e-7 of 0 flips its ReLU under any
# change of summation order (measured on the H100: ffn_up's gradient 3.9e-3
# from the CPU's, above 1e-4, at this size)
MOE_GRAD_CFG = dict(GRAD_CFG, n_experts=8)
# the second serving run: prefix cache on, spec_k 4 over a 1-layer
# self-draft
MOE_SPEC_K, MOE_DRAFT = 4, 1
# mp=2 on 2 gloo ranks sharing the card: the MoE at 4 layers, fp32 (TF32
# off), one loss and gradient against one device's, held as
# mp_training_phase holds the dense model's
MOE_MP = dict(MOE, n_layers=4, dtype="float32")
MOE_MP_BATCH = (4, 1025)


def _moe_steps(torch, fa, step, carry, tokens, steps):
    """``steps`` timed train steps (each ends in a device sync) and their
    launches; returns (losses, seconds, launches, carry)."""
    losses, secs = [], []
    _reset_counts(fa)
    for _ in range(steps):
        t0 = time.perf_counter()
        carry, loss = step(carry, tokens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return losses, secs, _counts(fa), carry


def moe_training_phase(torch, np, fa):
    """The MoE transformer at full width (MOE) through make_train_step: a
    warm-up step and MOE_STEPS timed ones on one seeded MOE_BATCH batch,
    then the 2-layer fp32 MoE's gradients card vs CPU; returns the timed
    steps' B5, B6, B7 launches."""
    from mxnet_tpu_torch.models import transformer as tfm

    _free(torch)
    held = torch.cuda.memory_allocated()
    cfg = tfm.TransformerConfig(**MOE)
    opt = dict(name="sgd", learning_rate=0.1, momentum=0.9)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, MOE_BATCH)
    n_tok = MOE_BATCH[0] * (MOE_BATCH[1] - 1)
    step, place = tfm.make_train_step(cfg, optimizer=opt)
    carry = place(params)
    t0 = time.perf_counter()
    carry, loss = step(carry, tokens)                    # warm-up
    losses = [loss.item()]
    print("moe train warm-up step: loss %.5f, %.3f s" % (
        losses[0], time.perf_counter() - t0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed, secs, launches, carry = _moe_steps(torch, fa, step, carry, tokens,
                                              MOE_STEPS)
    losses += timed
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(v.numel() for v in params.values())
    print("moe train: %d layers x %d experts (d_ff %d each, %d params), %s, "
          "%d steps at tokens %s: losses %s; step times %s s; %.1f tokens/s; "
          "peak memory %.2f GiB (%.2f GiB held before the phase); launches "
          "B5 %d, B6 %d, B7 %d"
          % (cfg.n_layers, cfg.n_experts, cfg.d_ff, n_params, cfg.dtype,
             MOE_STEPS,
             MOE_BATCH, " ".join("%.5f" % x for x in losses),
             " ".join("%.4f" % x for x in secs),
             n_tok * MOE_STEPS / sum(secs), peak / 2 ** 30, held / 2 ** 30,
             *launches))
    _device_profile(torch, lambda: step(carry, tokens),
                    also=[name for _lib, name in TC_KERNELS])
    del carry
    _free(torch)
    if not all(np.isfinite(losses)):
        raise RuntimeError("moe train: a loss is not finite: %s" % losses)
    if abs(losses[0] - MOE_FIRST_LOSS) > MOE_FIRST_LOSS_TOL:
        raise RuntimeError("moe train: first loss %.4f, expected %.2f +- %.2f"
                           % (losses[0], MOE_FIRST_LOSS, MOE_FIRST_LOSS_TOL))
    if not losses[-1] < losses[0]:
        raise RuntimeError("moe train: loss did not fall: %s" % losses)
    want = tuple(cfg.n_layers * MOE_STEPS for _ in range(3))
    if launches != want:
        raise RuntimeError("moe train: launches B5/B6/B7 %s, want %s"
                           % (launches, want))
    grad_phase(torch, np, MOE_GRAD_CFG, "moe grad", nudges=MP_NUDGES)
    return launches


def _argmax_chain(np, fwd, params, prompt, chain):
    """The forward's argmax at each new position of ``chain``, teacher
    forced on ``chain``."""
    rows = fwd(params, np.asarray(list(prompt) + list(chain[:-1]),
                                  np.int32)[None])[0, len(prompt) - 1:]
    return [int(t) for t in rows.argmax(-1).cpu().numpy()]


def moe_serving_phase(torch, np, fa):
    """The MoE model behind GenerateServer(slots=8, page_size=16) with the
    serving phase's 16 prompts (32 new tokens each): B5 12 times a
    prefill, the served logits of two requests within LOGIT_TOL of the
    forward and every greedy chain against the forward's argmax by the
    near-tie rule; again with the prefix cache and spec_k 4 (a 1-layer
    self-draft), the chains against the first run's by that rule. Returns
    the B5 launches of the first run."""
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.serving import GenerateServer

    _free(torch)
    cfg = tfm.TransformerConfig(**MOE)
    params = tfm.init_params(cfg, seed=0)
    prompts, rng = _serving_prompts(np, cfg.vocab)
    srv = GenerateServer(cfg, params, slots=8, page_size=16)
    try:
        pred = srv.predictor
        run = _serve_burst(torch, np, fa, srv, prompts, rng, (0, 1))
        fwd = tfm.make_forward_fn(cfg)
        errs = _served_rows_err(np, fwd, pred._params, prompts,
                                run["results"], run["watched"], "moe serve")
        chains = [list(r["tokens"]) for r in run["results"]]
        _near_tie_pairs(torch, np, fwd, pred._params, [
            (p, c, _argmax_chain(np, fwd, pred._params, p, c))
            for p, c in zip(prompts, chains)], "moe serve vs forward argmax")
    finally:
        srv.close()
    stats = run["stats"]
    print("moe serve: %d requests, prompts %d..%d tokens, %d new tokens each; "
          "%d generated in %.3f s wall = %.1f tokens/s; TTFT p50 %.1f ms p99 "
          "%.1f ms; flash launches %d (%d layers x %d prefills); served rows "
          "vs forward max %.4g (tol %g)"
          % (N_REQUESTS, min(map(len, prompts)), max(map(len, prompts)),
             NEW_TOKENS, run["tokens"], run["wall"],
             run["tokens"] / run["wall"], stats["ttft_p50_ms"],
             stats["ttft_p99_ms"], run["launches"], cfg.n_layers,
             stats["prefills"], max(errs), LOGIT_TOL))
    if max(errs) > LOGIT_TOL:
        raise RuntimeError("moe serve: served logits differ from the forward "
                           "by %.4g" % max(errs))

    srv = GenerateServer(cfg, params, slots=8, page_size=16,
                         prefix_cache=True, spec_k=MOE_SPEC_K,
                         draft=MOE_DRAFT)
    try:
        pred = srv.predictor
        for b in sorted({pred.pick_bucket(len(p)) for p in prompts}):
            srv.generate(rng.randint(0, cfg.vocab, (min(
                b, pred.max_ctx - MOE_SPEC_K - 3),)), max_new_tokens=2)
        torch.cuda.synchronize()
        from mxnet_tpu_torch import profiler

        profiler.generate_reset()
        _reset_counts(fa)
        t0 = time.perf_counter()
        futs = [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        spec = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spec_launches = fa.flash_attention.launches
        spec_stats = srv.stats()
    finally:
        srv.close()
    spec_chains = [list(r["tokens"]) for r in spec]
    if any(len(c) != NEW_TOKENS for c in spec_chains):
        raise RuntimeError("moe serve spec: chains of %s tokens"
                           % [len(c) for c in spec_chains])
    _near_tie_pairs(torch, np, fwd, _on_card(torch, params), [
        (p, a, b) for p, a, b in zip(prompts, chains, spec_chains)],
        "moe serve, prefix cache + spec_k %d vs plain" % MOE_SPEC_K)
    per = cfg.n_layers + MOE_DRAFT
    print("moe serve, prefix cache + spec_k %d (%d-layer self-draft): %.1f "
          "tokens/s; TTFT p50 %.1f ms; acceptance %s; prefix hits %d; flash "
          "launches %d (%d a prefill of target and draft x %d prefills)"
          % (MOE_SPEC_K, MOE_DRAFT, sum(map(len, spec_chains)) / wall,
             spec_stats["ttft_p50_ms"], spec_stats.get("acceptance_rate"),
             spec_stats["prefix_hits"], spec_launches, per,
             spec_stats["prefills"]))
    if spec_launches != per * spec_stats["prefills"]:
        raise RuntimeError("moe serve spec: flash launches %d != %d x %d "
                           "prefills" % (spec_launches, per,
                                         spec_stats["prefills"]))
    return run["launches"]


def _mp_moe_work(torch, np, fa, rank):
    """One rank of moe_mp_phase: rank 0 first runs one device's fp32 loss
    and gradients and their one-rounding yardstick, then both ranks the
    loss and gradients on train_mesh(mp=2)."""
    import torch.distributed as dist

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl
    from mxnet_tpu_torch.parallel.mesh import train_mesh

    cfg = tfm.TransformerConfig(**MOE_MP)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, MOE_MP_BATCH)
    res = {"rank": rank}
    ref = None
    if rank == 0:
        loss_fn, _ = tfm.make_loss_fn(cfg)

        def loss_grads(ps):
            p = {k: v.to(CARD, copy=True).requires_grad_()
                 for k, v in ps.items()}
            loss = loss_fn(p, tokens)
            return loss.item(), dict(zip(p, torch.autograd.grad(
                loss, list(p.values()))))

        ref = loss_grads(params)
        res["yard"] = {}
        for i in range(MP_NUDGES):
            rng = np.random.RandomState(300 + i)
            nudged = loss_grads({k: torch.from_numpy(_zoo_nudged(
                np, v.numpy(), rng)) for k, v in params.items()})[1]
            for k, v in _rel_l2(torch, nudged, ref[1]).items():
                res["yard"][k] = max(res["yard"].get(k, 0.0), v)
            del nudged
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = train_mesh(mp=MP_RANKS)
    loss_fn, _ = tfm.make_loss_fn(cfg, mesh)
    shards = {k: v.requires_grad_() for k, v in
              tfm.shard_params(params, cfg, mesh).items()}
    res["counts"] = tfm.block_collective_counts(cfg, mesh)
    _reset_counts(fa)
    tpl.reset_counts()
    loss = loss_fn(shards, tokens)
    res["forward_collectives"] = tpl.counts()
    grads = dict(zip(shards, torch.autograd.grad(loss,
                                                 list(shards.values()))))
    torch.cuda.synchronize()
    res["launches"] = list(_counts(fa))
    res["gate_grad_digest"] = _param_digest(
        {"moe_gate_weight": grads["moe_gate_weight"]})
    grads = tfm.unshard(grads, cfg, mesh)
    res["loss"] = loss.item()
    if ref is not None:
        res["ref_loss"] = ref[0]
        res["gaps"] = _rel_l2(torch, grads, ref[1])
    return res


def moe_mp_phase(torch, np, fa):
    """The MoE (MOE_MP: 4 layers, fp32, TF32 off) over train_mesh(mp=2) on 2
    gloo ranks sharing the card: the collectives of a loss forward equal
    block_collective_counts (2 sums a block: the gate's sum over the group
    is a backward one), the loss within MP_LOSS_TOL of one device's, every
    unsharded gradient (the gate's included) within max(MP_GRAD_TOL,
    MP_RATIO x its one-rounding gap) and the whole within MP_RATIO x its
    own, the gate's gradient bit for bit equal on the ranks. Returns each
    rank's B5, B6, B7 launches of the loss and gradient."""
    _free(torch)
    ranks, wall = _run_ranks(_mp_gloo_rank, MP_RANKS, MP_TIMEOUT, "moe mp",
                             "moe")
    r0 = ranks[0]
    loss_gap = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    gaps, yard = r0["gaps"], r0["yard"]
    whole, whole_yard = gaps.pop("null"), yard.pop("null")
    over = sorted((g / max(MP_GRAD_TOL, MP_RATIO * yard[k]), k)
                  for k, g in gaps.items())
    counts, fc = r0["counts"], r0["forward_collectives"]
    n_layers = MOE_MP["n_layers"]
    psums = fc["reduce_from_mp"] + fc["reduce_from_data"]
    print("moe mp: %d gloo ranks sharing one card, train_mesh(mp=%d), %d "
          "layers x %d experts, fp32 (TF32 off), tokens %s, %.1f s with "
          "start-up: loss %.7f vs one device %.7f (relative gap %.3g, tol "
          "%g); gradients unsharded vs one device, relative L2: whole %.4g "
          "against %.4g under %d one-rounding moves (ratio %.2f, limit %g); "
          "moe_gate_weight %.3g (its one-rounding gap %.3g); worst tensors "
          "%s; collectives of a loss forward %s against "
          "block_collective_counts %s; gate gradient bit for bit on the "
          "ranks %s; launches B5, B6, B7 a rank %s"
          % (MP_RANKS, MP_RANKS, n_layers, MOE_MP["n_experts"], MOE_MP_BATCH,
             wall, r0["loss"], r0["ref_loss"], loss_gap, MP_LOSS_TOL, whole,
             whole_yard, MP_NUDGES, whole / whole_yard, MP_RATIO,
             gaps["moe_gate_weight"], yard["moe_gate_weight"],
             ", ".join("%.3g at %s (%.3g vs %.3g)" % (r, k, gaps[k], yard[k])
                       for r, k in over[-3:]), fc, counts,
             len({r["gate_grad_digest"] for r in ranks}) == 1,
             " / ".join("%d, %d, %d" % tuple(r["launches"]) for r in ranks)))
    if loss_gap > MP_LOSS_TOL or whole > MP_RATIO * whole_yard or \
            over[-1][0] > 1:
        raise RuntimeError("moe mp: fp32 loss gap %g, whole gradient gap %g "
                           "against %g, worst tensor %s"
                           % (loss_gap, whole, whole_yard, over[-1]))
    if counts["psum_per_block"] != 2 or \
            psums != counts["psum_per_block"] * n_layers \
            + counts["psum_outside"] or \
            fc["gather_from_mp"] != counts["all_gather"]:
        raise RuntimeError("moe mp: collectives %s against %s"
                           % (fc, counts))
    if len({r["gate_grad_digest"] for r in ranks}) != 1:
        raise RuntimeError("moe mp: the gate's gradient differs on the ranks")
    for r in ranks:
        if r["launches"] != [n_layers] * 3:
            raise RuntimeError("moe mp rank %d: launches %s"
                               % (r["rank"], r["launches"]))
    return [r["launches"] for r in ranks]


# ---------------------------------------------------------------------------
# Gluon (ROADMAP.md Queue A item 9, first part): ResNet-50 v1 from the
# vision model zoo, hybridized, trained with Trainer in fp32 (TF32 off)
# ---------------------------------------------------------------------------
GLUON_BATCH, GLUON_STEPS, GLUON_SIDE = 32, 5, 224
# sgd with momentum 0.9 and wd 1e-4 at lr 0.1 for 256 images, scaled
# linearly to the batch (0.0125 at 32): at lr 0.1 on one repeated batch of
# 32 the loss rose (measured on the H100: 7.58 -> 12.48 in 5 steps)
GLUON_OPT = dict(learning_rate=0.1 * GLUON_BATCH / 256, momentum=0.9,
                 wd=1e-4)
GLUON_CHECK_BATCH = 2
# eager against hybridized forwards and export -> AOTPredictor on the
# card: the same ops on the same card, relative to the largest |logit|
GLUON_SAME_TOL = 1e-5
# the other families, one network each, and their input side
GLUON_FAMILIES = (("resnet50_v2", 224), ("vgg16_bn", 224), ("alexnet", 224),
                  ("squeezenet1.1", 224), ("mobilenet1.0", 224),
                  ("densenet121", 224), ("inceptionv3", 299))


def _gluon_rel(np, a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _gluon_card_vs_cpu(torch, np, mx, vision, net, path):
    """ResNet-50 v1's predict-mode logits at GLUON_CHECK_BATCH, card vs the
    port's CPU forward on the same weights (``path``, a .params file), by
    relative L2 against MP_RATIO (3) times the gap one rounding of the
    inputs and weights gives on the CPU; returns (gap, yardstick)."""
    x = np.random.RandomState(5).uniform(
        -1, 1, (GLUON_CHECK_BATCH, 3, GLUON_SIDE, GLUON_SIDE)).astype(
            np.float32)
    card = net(mx.nd.array(x, ctx=_card_ctx(torch, mx))).asnumpy()
    with mx.cpu():
        cpu = vision.resnet50_v1(classes=1000)
        cpu.initialize()
        cpu.load_params(path)
        ref = cpu(mx.nd.array(x)).asnumpy()
        rng = np.random.RandomState(6)
        for p in cpu.collect_params().values():
            p.set_data(_zoo_nudged(np, p.data().asnumpy(), rng))
        nudged = cpu(mx.nd.array(_zoo_nudged(np, x, rng))).asnumpy()

    def rel_l2(a, b):
        return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(
            b.ravel()))

    return rel_l2(card, ref), rel_l2(nudged, ref)


def gluon_phase(torch, np, fa, fb):
    """Gluon's ResNet-50 v1 (1000 classes) at (GLUON_BATCH, 3, 224, 224),
    fp32 with TF32 off, hybridized, trained by Trainer (sgd, GLUON_OPT) on
    the softmax cross-entropy: a warm-up and GLUON_STEPS timed steps on one
    seeded batch (the loss must fall). Checks eager against hybridized,
    card against the port's CPU forward, export -> AOTPredictor against the
    Gluon forward, and one network of each other zoo family eager against
    hybridized on the card. Returns the launches of B5, B6, B7, B1, B2, B3
    there (all 0: Gluon's convolutions and products are cuDNN's and
    cuBLAS's)."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.serving import AOTPredictor

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("gluon: TF32 must be off")
    _free(torch)
    _reset_counts(fa)
    _reset_fb_counts(fb)
    ctx = _card_ctx(torch, mx)
    tmp = tempfile.mkdtemp(prefix="gluon_")
    with ctx:
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier())
        small = mx.nd.array(np.random.RandomState(4).uniform(
            -1, 1, (GLUON_CHECK_BATCH, 3, GLUON_SIDE, GLUON_SIDE)).astype(
                np.float32))
        eager = net(small).asnumpy()
        net.save_params(os.path.join(tmp, "r50.params"))
        net.hybridize()
        hybrid = net(small).asnumpy()
        eager_gap = _gluon_rel(np, hybrid, eager)
        card_gap, yard = _gluon_card_vs_cpu(
            torch, np, mx, vision, net, os.path.join(tmp, "r50.params"))
        net.export(os.path.join(tmp, "r50"))
        sym = mx.sym.load(os.path.join(tmp, "r50-symbol.json"))
        saved = mx.nd.load(os.path.join(tmp, "r50-0000.params"))
        pred = AOTPredictor(
            sym, {k[4:]: v.asnumpy() for k, v in saved.items()
                  if k.startswith("arg:")},
            {k[4:]: v.asnumpy() for k, v in saved.items()
             if k.startswith("aux:")},
            data_shapes={"data": (GLUON_CHECK_BATCH, 3, GLUON_SIDE,
                              GLUON_SIDE)},
            ladder=(GLUON_CHECK_BATCH,))
        aot_gap = _gluon_rel(np, pred.predict({"data": small.asnumpy()})[0],
                             hybrid)
        del pred
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_OPT))
        lossf = gluon.loss.SoftmaxCrossEntropyLoss()
        rng = np.random.RandomState(0)
        x = mx.nd.array(rng.uniform(
            -1, 1, (GLUON_BATCH, 3, GLUON_SIDE, GLUON_SIDE)).astype(
                np.float32))
        y = mx.nd.array(rng.randint(0, 1000, GLUON_BATCH).astype(np.float32))

        def train_step():
            with autograd.record():
                loss = lossf(net(x), y)
            loss.backward()
            trainer.step(GLUON_BATCH)
            return float(loss.mean().asscalar())

        t0 = time.perf_counter()
        losses = [train_step()]
        warm = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(GLUON_STEPS):
            t0 = time.perf_counter()
            losses.append(train_step())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        stats = {}
        _device_profile(torch, train_step, top=6, stats=stats)
        graphs = len(net._cached)
        del net, trainer
        _free(torch)
        families = []
        for name, side in GLUON_FAMILIES:
            other = vision.get_model(name, classes=1000)
            other.initialize(mx.init.Xavier())
            xin = mx.nd.array(np.random.RandomState(7).uniform(
                -1, 1, (GLUON_CHECK_BATCH, 3, side, side)).astype(np.float32))
            a = other(xin).asnumpy()
            other.hybridize()
            b = other(xin).asnumpy()
            families.append((name, side, a.shape, _gluon_rel(np, b, a),
                             bool(np.isfinite(a).all())))
            del other
            _free(torch)
    launches = _counts(fa) + _fb_counts(fb)
    print("gluon resnet50_v1: 1000 classes, fp32 (TF32 off), hybridized (%d "
          "graphs), Trainer sgd %s, batch %d of %dx%d: losses %s; warm-up "
          "%.3f s, step times %s s; %.1f images/s; peak memory %.2f GiB; "
          "busy share %s"
          % (graphs, GLUON_OPT, GLUON_BATCH, GLUON_SIDE, GLUON_SIDE, " ".join(
              "%.5f" % v for v in losses), warm,
             " ".join("%.4f" % v for v in secs),
             GLUON_BATCH * GLUON_STEPS / sum(secs), peak / 2 ** 30,
             "%.3f" % (stats["busy_ms"] / stats["wall_ms"]) if stats
             else "not measured"))
    print("gluon checks at batch %d: hybridized vs eager %.3g (tol %g); card "
          "vs the port's CPU forward relative L2 %.4g against %.4g under one "
          "rounding of inputs and weights (ratio %.2f, limit %g); export -> "
          "AOTPredictor vs the Gluon forward %.3g (tol %g)"
          % (GLUON_CHECK_BATCH, eager_gap, GLUON_SAME_TOL, card_gap, yard,
             card_gap / max(yard, 1e-30), MP_RATIO, aot_gap, GLUON_SAME_TOL))
    for name, side, shape, gap, finite in families:
        print("gluon %s at %dx%d: output %s, hybridized vs eager %.3g, "
              "finite %s" % (name, side, side, shape, gap, finite))
    print("gluon phase: B5-B7 and B1-B3 launches %s" % (launches,))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError("gluon: losses %s" % losses)
    if eager_gap > GLUON_SAME_TOL or aot_gap > GLUON_SAME_TOL or \
            card_gap > MP_RATIO * yard:
        raise RuntimeError("gluon: hybridized %g, AOT %g, card vs CPU %g "
                           "against %g" % (eager_gap, aot_gap, card_gap, yard))
    for name, side, shape, gap, finite in families:
        if gap > GLUON_SAME_TOL or not finite or \
                shape != (GLUON_CHECK_BATCH, 1000):
            raise RuntimeError("gluon %s: %s, gap %g, finite %s"
                               % (name, shape, gap, finite))
    if any(launches):
        raise RuntimeError("gluon: hand kernels launched %s" % (launches,))
    return launches


# ---------------------------------------------------------------------------
# Gluon's recurrent layers and the module front end (ROADMAP.md Queue A
# item 9, second part): the PTB-medium LSTM LM (LM) through BucketingModule
# and a Gluon word LM of the same width, fp32 with TF32 off
# ---------------------------------------------------------------------------
RNN_DEFAULT_BUCKET = 35
# the default bucket first, then each bucket again, interleaved
RNN_ORDER = (35, 10, 20, 35, 10, 20)
RNN_OPT = dict(learning_rate=0.5, momentum=0.9)
RNN_CHECK_BUCKET = 10          # card vs CPU at this bucket
RNN_GLUON_STEPS = 4            # after one warm-up step
# eager against hybridized: the same ops on the same card, relative to the
# largest |value|
RNN_SAME_TOL = 1e-5
# LSTMCell unroll against the fused layer: fp32, another product order
RNN_CELL_TOL = dict(rtol=1e-4, atol=1e-5)
CONV_LSTM = dict(batch=8, channels=32, side=32, hidden=64, kernel=3, steps=3)


def _rnn_bucketing(mx, ctx, default):
    """A BucketingModule of ``lm_symbol`` (one symbol for every length) on
    ``ctx``, the RNN states fixed."""
    c = LM

    def sym_gen(_key):
        return (lm_symbol(mx, c["vocab"], c["hidden"], c["embed"],
                          c["layers"]), ("data",), ("softmax_label",))

    return mx.mod.BucketingModule(sym_gen, default_bucket_key=default,
                                  context=ctx,
                                  fixed_param_names=list(LM_STATES))


def _rnn_batch(np, mx, key, seed):
    """A DataBatch of ``key`` tokens a row from ``lm_corpus`` (host)."""
    c = LM
    x, y = lm_corpus(np, c["batch"], key, c["vocab"], seed=seed)
    return mx.io.DataBatch(
        data=[mx.nd.array(x, ctx=mx.cpu())],
        label=[mx.nd.array(y, ctx=mx.cpu())], bucket_key=key,
        provide_data=[mx.io.DataDesc("data", (c["batch"], key))],
        provide_label=[mx.io.DataDesc("softmax_label", (c["batch"], key))])


def _rnn_bind(mx, mod, key, params):
    c = LM
    mod.bind(data_shapes=[("data", (c["batch"], key))],
             label_shapes=[("softmax_label", (c["batch"], key))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()},
                    aux_params={})


def _rnn_shared(mod):
    """Whether every bucket's executor holds the default bucket's
    parameter and gradient arrays (the same storage) and its updater."""
    default = mod._buckets[mod._default_bucket_key]
    dgroup = default._exec_group

    def ptrs(blocks):
        return [b[0].tensor.untyped_storage().data_ptr() if b[0] is not None
                else None for b in blocks]

    ok = True
    for bucket in mod._buckets.values():
        group = bucket._exec_group
        ok = ok and ptrs(group.param_arrays) == ptrs(dgroup.param_arrays) \
            and ptrs(group.grad_arrays) == ptrs(dgroup.grad_arrays) \
            and bucket._updater is default._updater
    return ok


def _rnn_bucketed_lm(torch, np, mx):
    """The bucketed LM on the card: RNN_ORDER batches (each bucket bound on
    its first batch) under sgd with momentum; per-batch times and losses,
    tokens/s over the batches after each bucket's first, peak memory, and
    whether the buckets share storage and optimizer state."""
    c = LM
    ctx = _card_ctx(torch, mx)
    mod = _rnn_bucketing(mx, ctx, RNN_DEFAULT_BUCKET)
    params = lm_params(np, lm_symbol(mx, c["vocab"], c["hidden"], c["embed"],
                                     c["layers"]), c["batch"],
                       RNN_DEFAULT_BUCKET)
    _free(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _rnn_bind(mx, mod, RNN_DEFAULT_BUCKET, params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        RNN_OPT, rescale_grad=1.0 / (c["batch"] * RNN_DEFAULT_BUCKET)))
    rows = []
    seen = set()
    for i, key in enumerate(RNN_ORDER):
        batch = _rnn_batch(np, mx, key, seed=10 + i)
        t0 = time.perf_counter()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        loss = _lm_loss(torch, mod.get_outputs()[0].tensor,
                        batch.label[0].tensor.to(CARD))
        rows.append((key, time.perf_counter() - t0, loss, key in seen))
        seen.add(key)
    peak = torch.cuda.max_memory_allocated()
    momentum = mod._buckets[RNN_DEFAULT_BUCKET]._updater.states
    warm = [r for r in rows if r[3]]
    tokens_s = c["batch"] * sum(r[0] for r in warm) / sum(r[1] for r in warm)
    out = dict(rows=rows, tokens_s=tokens_s, peak_gib=peak / 2 ** 30,
               buckets=sorted(mod._buckets), shared=_rnn_shared(mod),
               n_states=len(momentum))
    del mod
    _free(torch)
    return out


def _rnn_bucket_grads_vs_cpu(torch, np, mx):
    """One training batch at bucket RNN_CHECK_BUCKET through a
    BucketingModule, card vs CPU, held to the LM yardstick."""
    c = LM
    key = RNN_CHECK_BUCKET
    params = lm_params(np, lm_symbol(mx, c["vocab"], c["hidden"], c["embed"],
                                     c["layers"]), c["batch"], key, seed=2)
    batch = _rnn_batch(np, mx, key, seed=3)
    y = batch.label[0].asnumpy()

    def run(ctx, nudge=None):
        p = params
        if nudge is not None:
            rng = np.random.RandomState(nudge)
            p = {k: v if k in LM_STATES else _zoo_nudged(np, v, rng)
                 for k, v in params.items()}
        mod = _rnn_bucketing(mx, ctx, key)
        _rnn_bind(mx, mod, key, p)
        mod.forward(batch, is_train=True)
        mod.backward()
        probs = mod.get_outputs()[0].asnumpy()
        ce = float(-np.log(probs[np.arange(len(probs)),
                                 y.reshape(-1).astype(int)] + 1e-12).mean())
        group = mod._curr_module._exec_group
        grads = {n: g[0].asnumpy() for n, g in zip(group.param_names,
                                                   group.grad_arrays)
                 if g[0] is not None and n not in LM_STATES}
        del mod
        return ce, grads

    cpu_ce, cpu = run(mx.cpu())
    card_ce, card = run(_card_ctx(torch, mx))
    nudged = [run(_card_ctx(torch, mx), 310 + i)[1]
              for i in range(LM_NUDGES)]
    _lm_check(np, "rnn bucketed lm", "bucket %d, batch %d" % (key,
                                                               c["batch"]),
              cpu_ce, card_ce, cpu, card, nudged)


def _rnn_word_lm(mx):
    """Embedding -> rnn.LSTM (2 layers) -> Dense of LM's widths, on
    (T, N) token ids."""
    from mxnet_tpu_torch import gluon

    c = LM

    class WordLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.embed = gluon.nn.Embedding(c["vocab"], c["embed"])
                self.rnn = gluon.rnn.LSTM(c["hidden"],
                                          num_layers=c["layers"],
                                          input_size=c["embed"])
                self.out = gluon.nn.Dense(c["vocab"], flatten=False,
                                          in_units=c["hidden"])

        def forward(self, x):
            return self.out(self.rnn(self.embed(x)))

    return WordLM()


def _rnn_gluon_grads(mx, net, x, y):
    """Loss (mean token cross-entropy) and gradients of one batch."""
    from mxnet_tpu_torch import autograd, gluon

    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        out = net(x)
        loss = lossf(out.reshape((-1, LM["vocab"])), y.reshape((-1,)))
    loss.backward()
    grads = {k[len(net.prefix):]: p.grad().asnumpy() for k, p in
             net.collect_params().items()}
    return out, float(loss.mean().asscalar()), grads


def _rnn_gluon_lm(torch, np, mx, tmp):
    """The Gluon word LM at (LM seq, LM batch) on the card: eager against
    hybridized (output and gradients), the fused layer against an
    LSTMCell unroll of its weights, card against the port's CPU
    (the LM yardstick), then RNN_GLUON_STEPS timed Trainer steps."""
    from mxnet_tpu_torch import autograd, gluon

    c = LM
    ctx = _card_ctx(torch, mx)
    x_np, y_np = lm_corpus(np, c["batch"], c["seq"], c["vocab"], seed=21)
    x_np, y_np = x_np.T.copy(), y_np.T.copy()          # (T, N)
    out = {}
    with ctx:
        net = _rnn_word_lm(mx)
        net.initialize(mx.init.Uniform(LM_INIT))
        x, y = mx.nd.array(x_np), mx.nd.array(y_np)
        eager, _loss, eg = _rnn_gluon_grads(mx, net, x, y)
        eager = eager.asnumpy()
        net.save_params(os.path.join(tmp, "wlm.params"))
        # the fused layer against a cell unroll of its weights
        emb = net.embed(x)
        fused = net.rnn(emb).asnumpy()
        cells = gluon.rnn.SequentialRNNCell()
        with cells.name_scope():
            for _ in range(c["layers"]):
                cells.add(gluon.rnn.LSTMCell(c["hidden"]))
        cells.initialize()
        cells.unroll(1, emb[0:1], layout="TNC")
        for layer, cell in enumerate(cells):
            for name in ("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias"):
                getattr(cell, name).set_data(
                    net.rnn.params.get("l%d_%s" % (layer, name)).data())
        unrolled, _states = cells.unroll(c["seq"], emb, layout="TNC")
        unrolled = unrolled.asnumpy()
        cell_gap = float(np.abs(unrolled - fused).max())
        cell_ok = bool(np.allclose(unrolled, fused, **RNN_CELL_TOL))
        net.hybridize()
        hybrid, card_ce, card = _rnn_gluon_grads(mx, net, x, y)
        hybrid = hybrid.asnumpy()
        out["hybrid_gap"] = _gluon_rel(np, hybrid, eager)
        out["hybrid_grad_gap"] = max(
            float(np.linalg.norm(card[k] - eg[k])
                  / max(np.linalg.norm(eg[k]), 1e-30)) for k in eg)
        out["cell_gap"], out["cell_ok"] = cell_gap, cell_ok
        out["graphs"] = len(net._cached)
        # card (the hybridized run) against the port's CPU, same weights
        nudged = []
        for i in range(LM_NUDGES):
            other = _rnn_word_lm(mx)
            other.initialize()
            other.load_params(os.path.join(tmp, "wlm.params"))
            nrng = np.random.RandomState(320 + i)
            for p in other.collect_params().values():
                p.set_data(_zoo_nudged(np, p.data().asnumpy(), nrng))
            nudged.append(_rnn_gluon_grads(mx, other, x, y)[2])
            del other
    with mx.cpu():
        cpu_net = _rnn_word_lm(mx)
        cpu_net.initialize()
        cpu_net.load_params(os.path.join(tmp, "wlm.params"))
        _cpu_out, cpu_ce, cpu = _rnn_gluon_grads(
            mx, cpu_net, mx.nd.array(x_np), mx.nd.array(y_np))
        del cpu_net
    _lm_check(np, "rnn gluon lm", "(T %d, N %d)" % (c["seq"], c["batch"]),
              cpu_ce, card_ce, cpu, card, nudged)
    with ctx:
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(learning_rate=LM_LR))
        lossf = gluon.loss.SoftmaxCrossEntropyLoss()
        losses, secs = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(RNN_GLUON_STEPS + 1):
            xs, ys = lm_corpus(np, c["batch"], c["seq"], c["vocab"],
                               seed=30 + step)
            xb, yb = mx.nd.array(xs.T.copy()), mx.nd.array(ys.T.copy())
            t0 = time.perf_counter()
            with autograd.record():
                loss = lossf(net(xb).reshape((-1, c["vocab"])),
                             yb.reshape((-1,)))
            loss.backward()
            trainer.step(c["batch"] * c["seq"])
            losses.append(float(loss.mean().asscalar()))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["losses"], out["secs"] = losses, secs
        out["tokens_s"] = c["batch"] * c["seq"] * RNN_GLUON_STEPS / \
            sum(secs[1:])
        del net, trainer
    _free(torch)
    return out


def _rnn_conv_lstm(torch, np, mx):
    """A Conv2DLSTMCell unrolled CONV_LSTM["steps"] steps: output and
    gradients card vs the port's CPU on the same weights, against the
    rounding yardstick."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.contrib.rnn import Conv2DLSTMCell

    c = CONV_LSTM
    shape = (c["channels"], c["side"], c["side"])
    rng = np.random.RandomState(40)
    x = rng.uniform(-1, 1, (c["batch"], c["steps"]) + shape).astype(
        np.float32)
    head = rng.uniform(-1, 1, (c["batch"], c["steps"], c["hidden"],
                               c["side"], c["side"])).astype(np.float32)
    def run(ctx, nudge=None):
        with ctx:
            cell = Conv2DLSTMCell(shape, c["hidden"], c["kernel"],
                                  c["kernel"], i2h_pad=c["kernel"] // 2,
                                  prefix="conv_lstm_")
            cell.initialize()
            params = cell.collect_params()
            nrng = None if nudge is None else np.random.RandomState(nudge)
            for k, p in params.items():
                v = weights[k] if nrng is None else \
                    _zoo_nudged(np, weights[k], nrng)
                p.set_data(mx.nd.array(v))
            xs = mx.nd.array(x)
            with autograd.record():
                seq, _states = cell.unroll(c["steps"], xs)
                loss = (seq * mx.nd.array(head)).sum()
            loss.backward()
            grads = {k: p.grad().asnumpy() for k, p in params.items()}
            return float(loss.asscalar()), grads

    with mx.cpu():
        mx.random.seed(41)
        init = Conv2DLSTMCell(shape, c["hidden"], c["kernel"], c["kernel"],
                              i2h_pad=c["kernel"] // 2, prefix="conv_lstm_")
        init.initialize(mx.init.Xavier())
        weights = {k: rng.uniform(-0.1, 0.1, p.shape).astype(np.float32)
                   if k.endswith("bias") else p.data().asnumpy()
                   for k, p in init.collect_params().items()}
    cpu_loss, cpu = run(mx.cpu())
    card_loss, card = run(_card_ctx(torch, mx))
    nudged = [run(_card_ctx(torch, mx), 330 + i)[1]
              for i in range(LM_NUDGES)]
    _lm_check(np, "rnn conv lstm", "batch %d, %d steps, %dx%dx%d -> %d"
              % (c["batch"], c["steps"], *shape, c["hidden"]),
              cpu_loss, card_loss, cpu, card, nudged)


def rnn_phase(torch, np, fa, fb):
    """The recurrent paths on the card, fp32 with TF32 off: the PTB-medium
    LSTM LM (LM widths, lm_symbol) through BucketingModule over buckets
    (10, 20, 35), default 35, in RNN_ORDER (loss finite and falling, the
    buckets sharing parameter, gradient and optimizer storage, tokens/s,
    peak memory) and one bucket card vs CPU; a Gluon word LM (Embedding,
    rnn.LSTM of 2 layers, Dense) at (LM seq, LM batch): eager against
    hybridized, an LSTMCell unroll against the fused layer, card against
    CPU, and RNN_GLUON_STEPS Trainer steps; a Conv2DLSTMCell card against
    CPU. Returns the launches of B5, B6, B7, B1, B2, B3 there (all 0: the
    recurrent layers run cuBLAS and cuDNN)."""
    import tempfile

    import mxnet_tpu_torch as mx

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("rnn: TF32 must be off")
    _free(torch)
    _reset_counts(fa)
    _reset_fb_counts(fb)
    mx.random.seed(0)
    tmp = tempfile.mkdtemp(prefix="rnn_")
    bucketed = _rnn_bucketed_lm(torch, np, mx)
    _rnn_bucket_grads_vs_cpu(torch, np, mx)
    word = _rnn_gluon_lm(torch, np, mx, tmp)
    _rnn_conv_lstm(torch, np, mx)
    launches = _counts(fa) + _fb_counts(fb)
    rows = bucketed["rows"]
    c = LM
    print("rnn bucketed lm: PTB-medium LSTM LM (vocab %d, %d wide, %d "
          "layers, batch %d) through BucketingModule, buckets %s (default "
          "%d), fp32 (TF32 off), sgd %s: batches (bucket, s, loss) %s; "
          "%.1f tokens/s over the batches after each bucket's first; peak "
          "memory %.3f GiB; buckets share parameter, gradient and optimizer "
          "storage %s (%d momentum states)"
          % (c["vocab"], c["hidden"], c["layers"], c["batch"],
             bucketed["buckets"], RNN_DEFAULT_BUCKET, RNN_OPT,
             " ".join("(%d, %.4f, %.5f)" % r[:3] for r in rows),
             bucketed["tokens_s"], bucketed["peak_gib"], bucketed["shared"],
             bucketed["n_states"]))
    print("rnn gluon lm: Embedding(%d, %d) -> rnn.LSTM(%d, %d layers) -> "
          "Dense(%d), hybridized (%d graphs), Trainer sgd lr %g at (T %d, "
          "N %d): losses %s; step times %s s; %.1f tokens/s; peak memory "
          "%.3f GiB; hybridized vs eager %.3g (gradients %.3g, tol %g); "
          "LSTMCell unroll vs the fused layer max |gap| %.3g (rtol %g, atol "
          "%g)" % (c["vocab"], c["embed"], c["hidden"], c["layers"],
                   c["vocab"], word["graphs"], LM_LR, c["seq"], c["batch"],
                   " ".join("%.5f" % v for v in word["losses"]),
                   " ".join("%.4f" % v for v in word["secs"]),
                   word["tokens_s"], word["peak_gib"], word["hybrid_gap"],
                   word["hybrid_grad_gap"], RNN_SAME_TOL, word["cell_gap"],
                   RNN_CELL_TOL["rtol"], RNN_CELL_TOL["atol"]))
    print("rnn phase: B5-B7 and B1-B3 launches %s" % (launches,))
    losses = [r[2] for r in rows]
    first35 = [r[2] for r in rows if r[0] == RNN_DEFAULT_BUCKET]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0] or not first35[-1] < first35[0]:
        raise RuntimeError("rnn bucketed lm: losses %s" % losses)
    if bucketed["buckets"] != [10, 20, 35] or not bucketed["shared"]:
        raise RuntimeError("rnn bucketed lm: buckets %s, shared %s"
                           % (bucketed["buckets"], bucketed["shared"]))
    if not all(math.isfinite(v) for v in word["losses"]) or \
            not word["losses"][-1] < word["losses"][0]:
        raise RuntimeError("rnn gluon lm: losses %s" % word["losses"])
    if word["hybrid_gap"] > RNN_SAME_TOL or \
            word["hybrid_grad_gap"] > RNN_SAME_TOL or not word["cell_ok"]:
        raise RuntimeError("rnn gluon lm: hybridized %g (gradients %g), "
                           "cell unroll %g" % (word["hybrid_gap"],
                                               word["hybrid_grad_gap"],
                                               word["cell_gap"]))
    if any(launches):
        raise RuntimeError("rnn: hand kernels launched %s" % (launches,))
    return launches

# ---------------------------------------------------------------------------
# the serving fleet on one host (fleet_phase)
# ---------------------------------------------------------------------------
# what a replica serves: the fused ResNet-50 in bf16 on the card; the CPU
# rehearsal sets FLEET_MODEL = "mlp" (tools/bench_serve.py's build_model
# shape), FLEET_DTYPE = "float32", CARD = "cpu" and FLEET_B1 = 0
FLEET_MODEL, FLEET_DTYPE = "resnet50", "bfloat16"
FLEET_MLP = dict(dim=16, hidden=32, layers=2, classes=4)
FLEET_LADDER = (1, 4, 16)
FLEET_REPLICAS = 3
FLEET_B1 = B1_PER_FORWARD       # B1 launches a forward of a replica
FLEET_PARITY = 16               # routed requests held against the predictor
FLEET_MAX_IMAGES = 4            # images a request: 1..4
FLEET_CLIENTS = 16              # closed-loop clients of a scaling window
FLEET_WINDOW_S = 5.0            # each scaling window; the kill at its half
FLEET_SWAP_CLIENTS = 8
FLEET_VIEW_S = 0.5              # replicas publish, routers refresh
FLEET_AUTOSCALE = dict(min_replicas=1, max_replicas=2, interval=0.5,
                       up_load=2.0, down_load=0.5, hysteresis=2,
                       cooldown=1.0)
FLEET_HOLD_S = 2.0              # load held once the fleet scaled up
FLEET_QOS_S = 3.0               # each QoS window
FLEET_QOS = dict(bulk_clients=8, bulk_images=4, bulk_rate=20.0, burst=1.0)
FLEET_LOOKUP = dict(users=100000, items=50000, dim=64,
                    rows=(1, 3, 8, 16))
FLEET_LOOKUP_TOL = 1e-4
FLEET_BOOT_S = 240.0            # a replica's start (import, load, warm-up)

# each replica process: the fleet entry point, then, at a graceful stop,
# its launch counts (B5, B6, B7, B1, B2, B3, B1 on the CUDA cores) to the
# file FLEET_LAUNCHES names. Nothing of this rides the replica's wire ops
_FLEET_BOOT = (
    "import os, sys\n"
    "sys.path.insert(0, os.environ['FLEET_ROOT'])\n"
    "from mxnet_tpu_torch.kernels import flash_attention as fa\n"
    "from mxnet_tpu_torch.kernels import fused_block as fb\n"
    "from mxnet_tpu_torch.serving import fleet\n"
    "rc = fleet.main(sys.argv[1:])\n"
    "counts = (fa.flash_attention.launches,\n"
    "          fa.flash_attention_bwd_dq.launches,\n"
    "          fa.flash_attention_bwd_dkv.launches, fb.conv_fwd.launches,\n"
    "          fb.conv_wgrad.launches, fb.conv_dgrad.launches,\n"
    "          fb.conv_fwd.core_route_launches)\n"
    "with open(os.environ['FLEET_LAUNCHES'], 'w') as f:\n"
    "    f.write(' '.join(str(n) for n in counts))\n"
    "sys.exit(rc)\n")


def _fleet_model(np, mx, seed):
    """``(symbol, arg_params, aux_params, data shape)`` of the served
    model, weights from ``seed`` (numpy)."""
    if FLEET_MODEL == "resnet50":
        from mxnet_tpu_torch.models import resnet

        sym = resnet.get_symbol(fused=True, **RESNET)
        one = (1,) + RESNET["image_shape"]
        args, auxs = resnet.init_params(sym, one, seed=seed)
        return sym, args, auxs, one
    c = FLEET_MLP
    net = mx.sym.var("data")
    for i in range(c["layers"]):
        net = mx.sym.Activation(mx.sym.FullyConnected(
            data=net, num_hidden=c["hidden"], name="fc%d" % i),
            act_type="relu")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data=net, num_hidden=c["classes"], name="head"), name="softmax")
    one = (1, c["dim"])
    arg_shapes, _, _ = net.infer_shape(data=one)
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*sh) * 0.05).astype(np.float32)
            for n, sh in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    return net, args, {}, one


class _FleetProcs:
    """The replica processes of the phase: spawned on CARD, their logs
    and launch files under ``tmp``; ``stop`` ends every one of them."""

    def __init__(self, coord, prefix, shape, tmp):
        self.coord, self.prefix, self.shape, self.tmp = \
            coord, prefix, shape, tmp
        self.procs, self.logs, self.killed = {}, [], set()

    def spawn(self, rank, extra=(), knobs=None):
        host, port = self.coord.rsplit(":", 1)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DMLC_") and k != "MXNET_FAULT_SPEC"}
        env.update(knobs or {})
        env.update(DMLC_ROLE="replica", DMLC_REPLICA_ID=str(rank),
                   DMLC_PS_ROOT_URI=host, DMLC_PS_ROOT_PORT=port,
                   MXNET_FLEET_VIEW_INTERVAL=str(FLEET_VIEW_S),
                   FLEET_ROOT=ROOT,
                   FLEET_LAUNCHES=os.path.join(self.tmp, "launches-%d"
                                               % rank))
        log = open(os.path.join(self.tmp, "replica-%d.log" % rank), "w")
        self.logs.append(log)
        self.procs[rank] = subprocess.Popen(
            [sys.executable, "-c", _FLEET_BOOT, "replica", "--prefix",
             self.prefix, "--epoch", "0", "--data-shape",
             "data:" + ",".join(str(d) for d in self.shape), "--ladder",
             ",".join(str(b) for b in FLEET_LADDER), "--dtype",
             FLEET_DTYPE, "--device", CARD, *extra], env=env, cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT)
        return rank

    def kill(self, rank):
        import signal

        self.procs[rank].send_signal(signal.SIGKILL)
        self.killed.add(rank)

    def tails(self):
        out = []
        for rank in sorted(self.procs):
            path = os.path.join(self.tmp, "replica-%d.log" % rank)
            with open(path) as f:
                out.append("replica %d (rc %s): %s" % (
                    rank, self.procs[rank].poll(), f.read()[-1500:]))
        return "\n".join(out)

    def launches(self):
        """``{rank: (B5, B6, B7, B1, B2, B3, B1 on CUDA cores)}`` of every
        replica that stopped gracefully."""
        out = {}
        for rank in sorted(self.procs):
            path = os.path.join(self.tmp, "launches-%d" % rank)
            if os.path.exists(path):
                with open(path) as f:
                    out[rank] = tuple(int(v) for v in f.read().split())
        return out

    def stop(self, timeout=60.0):
        deadline = time.monotonic() + timeout
        for p in self.procs.values():
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=15)
        for log in self.logs:
            log.close()


def _fleet_serving(router):
    router.refresh_view(force=True)
    return sum(1 for _a, st, alive, _l in router.replicas()
               if alive and st == "serving")


def _fleet_wait(router, procs, want, seconds, what):
    """Block until exactly ``want`` replicas serve; raises (with the
    replicas' log tails) after ``seconds`` or when a live replica's
    process died."""
    deadline = time.monotonic() + seconds
    while True:
        n = _fleet_serving(router)
        if n == want:
            return n
        dead = [r for r, p in procs.procs.items()
                if p.poll() not in (None, 0) and r not in procs.killed]
        if dead or time.monotonic() > deadline:
            raise RuntimeError("fleet %s: %d replicas serving, want %d "
                               "(dead: %s)\n%s" % (what, n, want, dead,
                                                   procs.tails()))
        time.sleep(0.2)


def _fleet_images(np, shape, seed):
    """One seeded batch a request size, 1..FLEET_MAX_IMAGES."""
    rng = np.random.RandomState(seed)
    return {n: rng.randn(n, *shape[1:]).astype(np.float32)
            for n in range(1, FLEET_MAX_IMAGES + 1)}


def _fleet_load(np, router, pool, clients, stop, seed, out, tenant=None,
                sizes=None, quota=None):
    """``clients`` closed-loop threads routing requests of 1..
    FLEET_MAX_IMAGES images (or ``sizes``) until ``stop`` is set; each
    appends (images, seconds) or an error to ``out``. A request the
    tenant's quota refuses (``quota``, the typed error) is counted apart
    and the client pauses 10 ms."""
    import threading

    def client(k):
        rng = np.random.RandomState(seed + k)
        while not stop.is_set():
            n = int(sizes if sizes else rng.randint(1, FLEET_MAX_IMAGES + 1))
            t0 = time.perf_counter()
            try:
                router.request("model", pool[n], tenant=tenant)
            except Exception as e:
                if quota is not None and isinstance(e, quota):
                    out["quota"] += 1
                    time.sleep(0.01)
                    continue
                out["errors"].append("%s: %s" % (type(e).__name__, e))
                continue
            out["done"].append((n, time.perf_counter() - t0))

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    return threads


def _fleet_new_out():
    return {"done": [], "errors": [], "quota": 0}


def _fleet_summary(out, seconds):
    lat = sorted(s for _n, s in out["done"])
    images = sum(n for n, _s in out["done"])
    return {"requests": len(lat), "images": images,
            "images_s": images / seconds,
            "p50_ms": _pctl(lat, 0.50) * 1e3 if lat else float("nan"),
            "p99_ms": _pctl(lat, 0.99) * 1e3 if lat else float("nan"),
            "errors": len(out["errors"]), "quota": out["quota"]}


def _fleet_window(np, router, pool, seconds, seed, kill=None):
    """One closed-loop window of FLEET_CLIENTS clients; ``kill()`` runs at
    its half. Returns the clients' summary and the router's counters."""
    import threading

    from mxnet_tpu_torch import profiler

    profiler.fleet_reset()
    stop, out = threading.Event(), _fleet_new_out()
    t0 = time.perf_counter()
    threads = _fleet_load(np, router, pool, FLEET_CLIENTS, stop, seed, out)
    if kill is not None:
        time.sleep(seconds / 2)
        kill()
        time.sleep(seconds / 2)
    else:
        time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    return _fleet_summary(out, wall), profiler.fleet_stats(), out


def _fleet_parity(np, router, pred, pool_seed, shape, label):
    """FLEET_PARITY routed requests of 1..FLEET_MAX_IMAGES seeded images
    against ``pred`` (the in-process predictor of the same weights):
    ``(max |diff|, largest |output|, top-1 agreement, images)``."""
    rng = np.random.RandomState(pool_seed)
    errs, scale, agree, total = [], 0.0, 0, 0
    for i in range(FLEET_PARITY):
        n = int(rng.randint(1, FLEET_MAX_IMAGES + 1))
        x = rng.randn(n, *shape[1:]).astype(np.float32)
        got = router.request("model", x)[0]
        ref = pred.predict(x)[0]
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError("fleet %s request %d: output %s, want %s"
                               % (label, i, got.shape, ref.shape))
        errs.append(float(np.abs(got - ref).max()))
        scale = max(scale, float(np.abs(ref).max()))
        agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
        total += n
    return max(errs), scale, agree / total, total


def fleet_phase(torch, np, fa, fb):
    """The serving fleet on one host (docstring item 33). Returns the
    launches of B5, B6, B7, B1, B2, B3 summed over the replicas that
    stopped gracefully (the killed one cannot report)."""
    import shutil
    import tempfile
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.embedding import (EmbeddingLookupServer,
                                           ShardedEmbeddingTable)
    from mxnet_tpu_torch.kvstore_server import KVStoreServer, ServerKVStore
    from mxnet_tpu_torch.serving import (AOTPredictor, FleetAutoscaler,
                                         FleetRouter, QosPolicy,
                                         TenantQuotaExceeded)
    from mxnet_tpu_torch.tracker import Tracker

    _free(torch)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fleet_")
    cpu = mx.cpu()
    prefixes, weights = [], []
    for seed in (0, 1):
        sym, args, auxs, shape = _fleet_model(np, mx, seed)
        prefix = os.path.join(tmp, "v%d" % seed)
        mx.model.save_checkpoint(
            prefix, 0, sym, {k: mx.nd.array(v, ctx=cpu)
                             for k, v in args.items()},
            {k: mx.nd.array(v, ctx=cpu) for k, v in auxs.items()})
        prefixes.append(prefix)
        weights.append((args, auxs))
    t_ckpt = time.perf_counter() - t_phase
    cores = len(os.sched_getaffinity(0)) \
        if hasattr(os, "sched_getaffinity") else os.cpu_count()
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    procs = _FleetProcs(trk.addr, prefixes[0], shape, tmp)
    router = scaler = lookup = None
    kv, servers = None, []
    stops = []
    report = {}
    try:
        t0 = time.perf_counter()
        for rank in range(FLEET_REPLICAS):
            procs.spawn(rank)
        # the in-process predictor of the same checkpoint, meanwhile
        pred = AOTPredictor(sym, weights[0][0], weights[0][1],
                            data_shapes={"data": shape},
                            ladder=FLEET_LADDER, dtype=FLEET_DTYPE,
                            device=CARD)
        pred.predict(np.zeros(shape, np.float32))
        router = FleetRouter(tracker_uri=trk.addr, view_interval=FLEET_VIEW_S,
                             timeout=60.0)
        _fleet_wait(router, procs, FLEET_REPLICAS, FLEET_BOOT_S, "boot")
        report["boot_s"] = time.perf_counter() - t0
        pool = _fleet_images(np, shape, 5)
        # every bucket of every replica once before anything is timed
        for addr, _st, _al, _ld in router.replicas():
            with FleetRouter(replicas=[addr], view_interval=FLEET_VIEW_S,
                             timeout=60.0) as one:
                for b in FLEET_LADDER[1:]:
                    one.request("model", np.repeat(pool[1], b, axis=0))
        report["parity"] = _fleet_parity(np, router, pred, 11, shape,
                                         "parity")

        # scaling: a window at 1 replica (the others drained), then one
        # at 3 with the highest rank SIGKILLed at its half
        with router._view_lock:
            by_rank = {h.rank: h.addr for h in router._handles.values()}
        for rank in range(1, FLEET_REPLICAS):
            router.drain(by_rank[rank])
        _fleet_wait(router, procs, 1, 30.0, "drain")
        report["one"] = _fleet_window(np, router, pool, FLEET_WINDOW_S, 100)
        for rank in range(1, FLEET_REPLICAS):
            router.resume(by_rank[rank])
        _fleet_wait(router, procs, FLEET_REPLICAS, 30.0, "resume")
        victim = FLEET_REPLICAS - 1
        report["three"] = _fleet_window(
            np, router, pool, FLEET_WINDOW_S, 200,
            kill=lambda: procs.kill(victim))
        _fleet_wait(router, procs, FLEET_REPLICAS - 1, 30.0, "after kill")

        # rolling swap to the seed-1 checkpoint under load
        profiler.fleet_reset()
        stop, out = threading.Event(), _fleet_new_out()
        stops.append(stop)
        threads = _fleet_load(np, router, pool, FLEET_SWAP_CLIENTS, stop,
                              300, out)
        time.sleep(0.5)
        t0 = time.perf_counter()
        swapped = router.fleet_swap(prefix=prefixes[1], epoch=0)
        swap_s = time.perf_counter() - t0
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        pred.swap_params(*weights[1])
        report["swap"] = (swapped, swap_s, _fleet_summary(
            out, swap_s + 1.0), profiler.fleet_stats(),
            _fleet_parity(np, router, pred, 12, shape, "swap"))
        del pred
        _free(torch)

        # autoscale: low (2 -> 1), high (1 -> 2, a spawned process), low
        profiler.fleet_reset()
        profiler.autoscale_reset()
        directives = []

        def actuate(d):
            directives.append(dict(d))
            live = [r for r, p in procs.procs.items()
                    if p.poll() is None and r not in d["retired"]
                    and r not in procs.killed]
            while len(live) < d["desired"]:
                live.append(procs.spawn(max(procs.procs) + 1))

        scaler = FleetAutoscaler(tracker_uri=trk.addr, actuate_fn=actuate,
                                 **FLEET_AUTOSCALE)
        scaling = threading.Thread(target=scaler.run_forever, daemon=True)
        t0 = time.perf_counter()
        scaling.start()
        _fleet_wait(router, procs, 1, 60.0, "autoscale low")
        t_low = time.perf_counter() - t0
        stop, out = threading.Event(), _fleet_new_out()
        stops.append(stop)
        threads = _fleet_load(np, router, pool, FLEET_CLIENTS, stop, 400,
                              out)
        t1 = time.perf_counter()
        peak = _fleet_wait(router, procs, 2, FLEET_BOOT_S, "autoscale high")
        t_high = time.perf_counter() - t1
        time.sleep(FLEET_HOLD_S)
        peak = max(peak, _fleet_serving(router))
        stop.set()
        for t in threads:
            t.join(timeout=120)
        high_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        final = _fleet_wait(router, procs, 1, 60.0, "autoscale low again")
        t_back = time.perf_counter() - t2
        scaler.close()
        scaling.join(timeout=30)
        scaler = None
        report["autoscale"] = (t_low, t_high, t_back, peak, final,
                               directives, profiler.autoscale_stats(),
                               _fleet_summary(out, high_s),
                               profiler.fleet_stats())

        # QoS: the latency tenant alone, then beside an over-quota bulk
        # tenant, on the 1-replica fleet
        qos = QosPolicy(tenants={
            "lat": {"priority": "latency"},
            "bulk": {"priority": "bulk",
                     "req_rate": FLEET_QOS["bulk_rate"]}},
            burst_seconds=FLEET_QOS["burst"])
        qrouter = FleetRouter(tracker_uri=trk.addr,
                              view_interval=FLEET_VIEW_S, timeout=60.0,
                              qos=qos)
        try:
            qos_runs = []
            for with_bulk in (False, True):
                profiler.qos_reset()
                stop = threading.Event()
                stops.append(stop)
                lat_out, bulk_out = _fleet_new_out(), _fleet_new_out()
                threads = _fleet_load(np, qrouter, pool, 1, stop, 500,
                                      lat_out, tenant="lat", sizes=1)
                if with_bulk:
                    threads += _fleet_load(
                        np, qrouter, pool, FLEET_QOS["bulk_clients"], stop,
                        600, bulk_out, tenant="bulk",
                        sizes=FLEET_QOS["bulk_images"],
                        quota=TenantQuotaExceeded)
                time.sleep(FLEET_QOS_S)
                stop.set()
                for t in threads:
                    t.join(timeout=120)
                qos_runs.append((_fleet_summary(lat_out, FLEET_QOS_S),
                                 _fleet_summary(bulk_out, FLEET_QOS_S),
                                 profiler.qos_stats()))
        finally:
            qrouter.close()
        report["qos"] = qos_runs

        # one lookup replica over two parameter servers on the card
        c = FLEET_LOOKUP
        servers = [KVStoreServer(device=CARD) for _ in range(2)]
        for srv in servers:
            srv.serve_in_background()
        kv = ServerKVStore(",".join(srv.addr for srv in servers))
        rng = np.random.RandomState(21)
        tables = {}
        for key, rows in (("user", c["users"]), ("item", c["items"])):
            tables[key] = ShardedEmbeddingTable(key, kv, rows, c["dim"])
            tables[key].init(init_array=rng.randn(rows, c["dim"])
                             .astype(np.float32))
        tsym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=1,
                                     name="tower")
        tower = AOTPredictor(
            tsym, {"tower_weight": rng.randn(1, 2 * c["dim"])
                   .astype(np.float32) / np.sqrt(2 * c["dim"]),
                   "tower_bias": np.zeros((1,), np.float32)},
            data_shapes={"data": (1, 2 * c["dim"])}, ladder=FLEET_LADDER,
            device=CARD)
        lookup = EmbeddingLookupServer("rec", tables, tower,
                                       tracker_uri=trk.addr)
        lookup.serve_in_background()
        router.refresh_view(force=True)
        lookup_err, lookup_scale = 0.0, 0.0
        for n in c["rows"]:
            req = {"user": rng.randint(0, c["users"], n),
                   "item": rng.randint(0, c["items"], n)}
            got = router.request("rec", req)[0]
            ref = lookup.predictor.predict(req)[0]
            lookup_err = max(lookup_err, float(np.abs(got - ref).max()))
            lookup_scale = max(lookup_scale, float(np.abs(ref).max()))
        report["lookup"] = (lookup_err, lookup_scale, len(c["rows"]))
    except Exception:
        print(procs.tails())
        raise
    finally:
        for stop in stops:
            stop.set()
        if scaler is not None:
            scaler.close()
        stopped = 0
        if router is not None:
            try:
                stopped = router.stop_fleet()
            finally:
                router.close()
        procs.stop()
        if lookup is not None:
            lookup.shutdown()
        if kv is not None:
            kv.close()
        for srv in servers:
            srv.shutdown()
        trk.shutdown()
    launches = procs.launches()
    shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)

    err, scale, top1, n_img = report["parity"]
    print("fleet: %d replica processes of the %s (%s, ladder %s) on %s, up "
          "in %.1f s (checkpoints written in %.1f s); host cores %d"
          % (FLEET_REPLICAS, "fused ResNet-50" if FLEET_MODEL == "resnet50"
             else "MLP", FLEET_DTYPE, FLEET_LADDER, CARD,
             report["boot_s"], t_ckpt, cores))
    print("fleet parity: %d routed requests (%d images) vs the in-process "
          "%s AOTPredictor of the checkpoint: max |diff| %.4g, largest "
          "|output| %.4g, relative %.4g (tol %g), top-1 agreement %.3f "
          "(want >= %g)" % (FLEET_PARITY, n_img, FLEET_DTYPE, err, scale,
                            err / scale, RESNET_LOGIT_TOL, top1,
                            RESNET_TOP1))
    for key, label in (("one", "1 replica"),
                       ("three", "%d replicas, rank %d SIGKILLed at %.1f s"
                        % (FLEET_REPLICAS, FLEET_REPLICAS - 1,
                           FLEET_WINDOW_S / 2))):
        summ, stats, _out = report[key]
        print("fleet window (%s): %d clients, %d requests, %d images in "
              "%.1f s = %.1f images/s; latency p50 %.1f ms p99 %.1f ms; "
              "failed %d (client errors %d), retried %d, failovers %d, "
              "inflight_lost %d, shed %d"
              % (label, FLEET_CLIENTS, summ["requests"], summ["images"],
                 FLEET_WINDOW_S, summ["images_s"], summ["p50_ms"],
                 summ["p99_ms"], stats.get("failed", 0), summ["errors"],
                 stats.get("retries", 0), stats.get("failovers", 0),
                 stats.get("inflight_lost", 0),
                 stats.get("overload_rejections", 0)))
    swapped, swap_s, swap_sum, swap_stats, swap_par = report["swap"]
    print("fleet swap: fleet_swap to the seed-1 checkpoint under %d "
          "clients: %d replicas in %.2f s; %d requests served, %d dropped, "
          "failed %d, retried %d, draining rejections %d; after it %d "
          "routed requests vs the seed-1 predictor: relative %.4g, top-1 "
          "%.3f" % (FLEET_SWAP_CLIENTS, swapped, swap_s,
                    swap_sum["requests"], swap_sum["errors"],
                    swap_stats.get("failed", 0),
                    swap_stats.get("retries", 0),
                    swap_stats.get("draining_rejections", 0),
                    FLEET_PARITY, swap_par[0] / swap_par[1], swap_par[2]))
    (t_low, t_high, t_back, peak, final, directives, as_stats, as_sum,
     as_fleet) = report["autoscale"]
    print("fleet autoscale: %s; low -> %d replica in %.1f s, high (%d "
          "clients) -> %d in %.1f s (a replica process spawned and "
          "booted), low again -> %d in %.1f s; directives %s; %s; under "
          "load %d requests, %.1f images/s, p99 %.1f ms, failed %d "
          "(client errors %d)"
          % (FLEET_AUTOSCALE, 1, t_low, FLEET_CLIENTS, peak, t_high, final,
             t_back, [(d["desired"], d["retired"]) for d in directives],
             as_stats, as_sum["requests"], as_sum["images_s"],
             as_sum["p99_ms"], as_fleet.get("failed", 0), as_sum["errors"]))
    (lat_alone, _b0, _q0), (lat_mixed, bulk, qstats) = report["qos"]
    print("fleet qos: latency tenant alone %d requests, p50 %.1f ms p99 "
          "%.1f ms; beside the bulk tenant (%d clients of %d images, "
          "req_rate %g/s) p50 %.1f ms p99 %.1f ms; bulk admitted %d "
          "(served %d), quota rejections %d (client side %d); qosStats %s"
          % (lat_alone["requests"], lat_alone["p50_ms"],
             lat_alone["p99_ms"], FLEET_QOS["bulk_clients"],
             FLEET_QOS["bulk_images"], FLEET_QOS["bulk_rate"],
             lat_mixed["p50_ms"], lat_mixed["p99_ms"],
             qstats.get("bulk", {}).get("admitted", 0), bulk["requests"],
             qstats.get("bulk", {}).get("quota_rejections", 0),
             bulk["quota"], qstats))
    l_err, l_scale, l_n = report["lookup"]
    print("fleet lookup: one lookup replica (user %d x %d, item %d x %d on "
          "2 parameter servers on %s, a %d -> 1 tower) routed %d requests "
          "vs its in-process predictor: max |diff| %.3g, largest %.3g "
          "(tol %g)" % (FLEET_LOOKUP["users"], FLEET_LOOKUP["dim"],
                        FLEET_LOOKUP["items"], FLEET_LOOKUP["dim"], CARD,
                        2 * FLEET_LOOKUP["dim"], l_n, l_err, l_scale,
                        FLEET_LOOKUP_TOL))
    print("fleet launches (B5, B6, B7, B1, B2, B3, B1 on CUDA cores) per "
          "replica that stopped gracefully: %s; killed %s; %d stopped by "
          "stop_fleet" % (launches, sorted(procs.killed), stopped))
    print("fleet phase: %.1f s" % (time.perf_counter() - t_phase))

    if err > RESNET_LOGIT_TOL * scale or top1 < RESNET_TOP1:
        raise RuntimeError("fleet: routed outputs differ from the predictor")
    for key in ("one", "three"):
        summ, stats, out = report[key]
        if stats.get("failed", 0) or summ["errors"] or not summ["requests"]:
            raise RuntimeError("fleet window %s: failed %s, errors %s"
                               % (key, stats.get("failed"),
                                  out["errors"][:3]))
    if swapped != FLEET_REPLICAS - 1 or swap_sum["errors"] or \
            swap_stats.get("failed", 0) or \
            swap_par[0] > RESNET_LOGIT_TOL * swap_par[1] or \
            swap_par[2] < RESNET_TOP1:
        raise RuntimeError("fleet swap: swapped %d, dropped %d, failed %s, "
                           "relative %.4g" % (swapped, swap_sum["errors"],
                                              swap_stats.get("failed"),
                                              swap_par[0] / swap_par[1]))
    if peak < 2 or final != 1 or as_fleet.get("failed", 0) or \
            as_sum["errors"] or not as_stats.get("scale_ups"):
        raise RuntimeError("fleet autoscale: peak %d, final %d, failed %s, "
                           "errors %d, stats %s" % (
                               peak, final, as_fleet.get("failed"),
                               as_sum["errors"], as_stats))
    bulk_stats = qstats.get("bulk", {})
    cap = FLEET_QOS["bulk_rate"] * (FLEET_QOS_S + FLEET_QOS["burst"]) + 1
    if not bulk_stats.get("quota_rejections") or \
            bulk_stats.get("admitted", 0) > cap or lat_mixed["errors"] or \
            lat_alone["errors"] or bulk["errors"]:
        raise RuntimeError("fleet qos: bulk %s (cap %d), errors %d/%d/%d"
                           % (bulk_stats, cap, lat_alone["errors"],
                              lat_mixed["errors"], bulk["errors"]))
    if l_err > FLEET_LOOKUP_TOL * max(1.0, l_scale):
        raise RuntimeError("fleet lookup: routed scores differ by %g"
                           % l_err)
    expect = set(procs.procs) - procs.killed
    if set(launches) != expect:
        raise RuntimeError("fleet: launch counts from %s, want %s"
                           % (sorted(launches), sorted(expect)))
    for rank, n in launches.items():
        b1 = n[3]
        if n[6] or any(n[i] for i in (0, 1, 2, 4, 5)) or \
                (b1 % FLEET_B1 if FLEET_B1 else b1) or \
                (FLEET_B1 and not b1):
            raise RuntimeError("fleet: replica %d launches %s (want B1 > 0, "
                               "a multiple of %d, nothing else)"
                               % (rank, n, FLEET_B1))
    return tuple(sum(n[i] for n in launches.values()) for i in range(6))


# the single-process tail (docstring item 34): run-time compiled CUDA
# (rtc), a Custom loss head on the full-width fused ResNet-50 against the
# built-in SoftmaxOutput, Module.fit with that head under a Monitor, the
# profiler (mode all) and LogMetricsCallback, and print_summary.
TAIL_BATCHES = 4            # Module.fit batches: one seeded batch, 4 times
TAIL_MON_INTERVAL = 2       # batches 0 and 2 are monitored
TAIL_SOFTMAX_TOL = 1e-6     # rtc row softmax vs torch, per element, relative
TAIL_HEAD_TOL = 1e-4        # Custom vs SoftmaxOutput: outputs, gradients
TAIL_YARD_RATIO = 3.0       # or this times the gap one rounding of fc1 gives
TAIL_STAT_TOL = 1e-5        # a logged Monitor stat vs torch's norm
TAIL_THREADS = 256          # threads a row of the softmax (a power of 2)
TAIL_RTC = r"""
extern "C" __global__ void saxpy(const float *x, float *y, float a, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = a * x[i] + y[i];
}

// one block a row of a (rows, cols) row-major matrix; blockDim.x threads
// (a power of 2) stride over the columns and reduce in shared memory
extern "C" __global__ void row_softmax(const float *x, float *y, int cols) {
    extern __shared__ float red[];
    const float *xr = x + (size_t)blockIdx.x * cols;
    float *yr = y + (size_t)blockIdx.x * cols;
    float m = -3.402823466e+38f;
    for (int j = threadIdx.x; j < cols; j += blockDim.x) m = fmaxf(m, xr[j]);
    red[threadIdx.x] = m;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s)
            red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
        __syncthreads();
    }
    m = red[0];
    __syncthreads();
    float sum = 0.f;
    for (int j = threadIdx.x; j < cols; j += blockDim.x) {
        float e = expf(xr[j] - m);
        yr[j] = e;
        sum += e;
    }
    red[threadIdx.x] = sum;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    float total = red[0];
    for (int j = threadIdx.x; j < cols; j += blockDim.x) yr[j] = yr[j] / total;
}
"""
# --fmad=false: a * x + y rounds its product and its sum apart, as torch's
# two ops do (NVRTC contracts them into one fma by default)
TAIL_RTC_OPTIONS = ("--fmad=false",)


def _rtc_softmax(kernel, x, out):
    n, c = x.shape
    kernel.launch([x, out, c], x.context, (n, 1, 1), (TAIL_THREADS, 1, 1),
                  TAIL_THREADS * 4)


def _register_rtc_head(mx, kernel):
    """The Custom softmax-loss head: its forward launches the rtc row
    softmax into its output, its backward forms p - onehot(label) with
    NDArray ops on the card (need_top_grad=False: a loss head)."""

    class RtcSoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            _rtc_softmax(kernel, in_data[0], out_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = out_data[0]
            self.assign(in_grad[0], req[0],
                        p - mx.nd.one_hot(in_data[1], depth=p.shape[1]))
            self.assign(in_grad[1], req[1], mx.nd.zeros_like(in_data[1]))

    @mx.operator.register("rtc_softmax_loss")
    class RtcSoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return RtcSoftmax()


def _custom_headed(mx, resnet):
    fc = resnet.get_symbol(fused=True, **RESNET).get_internals()[
        "fc1_output"]
    return mx.sym.Custom(data=fc, label=mx.sym.var("softmax_label"),
                         op_type="rtc_softmax_loss", name="softmax")


def _tail_rtc(torch, np, mx):
    """Step 1: compile, cache and launch; returns the row-softmax kernel."""
    t0 = time.perf_counter()
    mod = mx.rtc.CudaModule(TAIL_RTC, options=TAIL_RTC_OPTIONS)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = mx.rtc.CudaModule(TAIL_RTC, options=TAIL_RTC_OPTIONS)
    second = time.perf_counter() - t0
    if not again.cached:
        raise RuntimeError("tail: the second compile missed the rtc cache")
    saxpy = mod.get_kernel("saxpy", "const float *x, float *y, float a, "
                           "int n")
    softmax = mod.get_kernel("row_softmax", "const float *x, float *y, "
                             "int cols")
    gen = torch.Generator(device=CARD).manual_seed(0)
    n = 1 << 20
    x = torch.randn(n, device=CARD, generator=gen)
    y = torch.randn(n, device=CARD, generator=gen)
    want = 2.5 * x + y
    ys = mx.nd.NDArray(y.clone())
    saxpy.launch([mx.nd.NDArray(x), ys, 2.5, n], mx.gpu(0),
                 ((n + 255) // 256, 1, 1), (256, 1, 1))
    rows, cols = FIT_BATCH, RESNET["num_classes"]
    logits = torch.randn(rows, cols, device=CARD, generator=gen) * 4
    out = mx.nd.NDArray(torch.empty_like(logits))
    _rtc_softmax(softmax, mx.nd.NDArray(logits), out)
    torch.cuda.synchronize()
    ref = torch.softmax(logits, dim=1)
    soft_err = float(((out.tensor - ref).abs() / ref.abs()).max())
    exact = torch.equal(ys.tensor, want)
    refused = False
    try:
        saxpy.launch([mx.nd.NDArray(x.cpu()), ys, 1.0, n], mx.gpu(0),
                     (1, 1, 1), (256, 1, 1))
    except mx.MXNetError as e:
        refused = "is on cpu" in str(e)
    print("tail rtc: NVRTC compile of saxpy + row_softmax %.3f s (first, "
          "cached: %s), %.4f s (second, from the cache: %s); saxpy of %d "
          "equal to torch bit for bit: %s; row softmax at (%d, %d) max "
          "relative error %.3g (tol %g); a CPU NDArray refused by name: %s"
          % (first, mod.cached, second, again.cached, n, exact, rows, cols,
             soft_err, TAIL_SOFTMAX_TOL, refused))
    if not exact or soft_err > TAIL_SOFTMAX_TOL or not refused:
        raise RuntimeError("tail: the rtc kernels differ from torch, or a "
                           "CPU NDArray was not refused")
    return softmax


def _tail_heads(torch, np, mx, resnet):
    """Step 2: the Custom head against SoftmaxOutput, one batch, fp32.
    The two heads' probabilities differ by a rounding (the rtc softmax sums
    in another order than torch's). SoftmaxOutput runs twice more with
    fc1's weights and bias moved by one rounding each (the head's input
    moved by about a rounding): a tensor whose gradient is a near-complete
    cancellation (bn0's) moves by more than TAIL_HEAD_TOL under that alone.
    Each tensor is held to TAIL_HEAD_TOL, or to TAIL_YARD_RATIO times the
    larger of its two one-rounding gaps where those exceed it."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("tail: TF32 must be off for the fp32 comparison")
    n = FIT_BATCH
    shape = (n,) + RESNET["image_shape"]
    builtin = resnet.get_symbol(fused=True, **RESNET)
    custom = _custom_headed(mx, resnet)
    args, auxs = resnet.init_params(builtin, shape, seed=0)
    batch = _resnet_batch(np, 7, n)
    runs = []
    for sym, nudge in ((builtin, None), (custom, None), (builtin, 300),
                       (builtin, 301)):
        rng = None if nudge is None else np.random.RandomState(nudge)
        ex = sym.simple_bind(mx.gpu(0), data=shape, softmax_label=(n,))
        for d, src in ((ex.arg_dict, args), (ex.aux_dict, auxs)):
            for k, v in src.items():
                if rng is not None and k in ("fc1_weight", "fc1_bias"):
                    v = _zoo_nudged(np, v, rng)
                d[k][:] = v
        ex.forward_backward(**batch)
        runs.append((ex.outputs[0].asnumpy(),
                     {k: v.asnumpy() for k, v in ex.grad_dict.items()
                      if k not in batch}))
        del ex
        _free(torch)
    (ref_out, ref_g), (out, g) = runs[0], runs[1]
    if sorted(ref_g) != sorted(g):
        raise RuntimeError("tail: the two heads' graphs take gradients of "
                           "other parameters")
    floor = 1e-2 * max(float(np.abs(v).max()) for v in ref_g.values())

    def gap(a, k):
        return float(np.abs(a[k] - ref_g[k]).max()) / max(
            float(np.abs(ref_g[k]).max()), floor)

    rows = sorted((gap(g, k), max(gap(r[1], k) for r in runs[2:]), k)
                  for k in ref_g)
    allowed = {k: max(TAIL_HEAD_TOL, TAIL_YARD_RATIO * yard)
               for _e, yard, k in rows}
    out_err = float(np.abs(out - ref_out).max() / np.abs(ref_out).max())
    yard_out = max(float(np.abs(r[0] - ref_out).max()) for r in runs[2:]) \
        / float(np.abs(ref_out).max())
    over = [r for r in rows if r[0] > TAIL_HEAD_TOL]
    print("tail heads: the full-width fused ResNet-50, fp32, batch %d, one "
          "seeded batch from init_params(seed=0): Custom (rtc softmax, "
          "p - onehot) vs SoftmaxOutput, outputs %.3g (fc1 moved by one "
          "rounding: %.3g), %d gradients, worst %s (gap, the one-rounding "
          "gap; each against its largest |value|, floored at 1%% of the "
          "largest; tol %g, or %g x the one-rounding gap); %d above %g: %s"
          % (n, out_err, yard_out, len(rows),
             ", ".join("%.3g (%.3g) at %s" % r for r in rows[-3:]),
             TAIL_HEAD_TOL, TAIL_YARD_RATIO, len(over), TAIL_HEAD_TOL,
             ", ".join("%s %.3g (%.3g)" % (r[2], r[0], r[1])
                       for r in over)))
    if out_err > TAIL_HEAD_TOL or any(e > allowed[k] for e, _r, k in rows):
        raise RuntimeError("tail: the Custom head differs from SoftmaxOutput")


class _Collect(logging.Handler):
    """The Monitor rows toc_print logs: (step, name, value)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rows = []

    def emit(self, record):
        m = re.match(r"Batch: +(\d+) (\S+) +(\S+)\t$", record.getMessage())
        if m:
            self.rows.append((int(m.group(1)), m.group(2),
                              float(m.group(3))))


def _read_scalars(path):
    """``{tag: [(step, value)]}`` of a TF event file: TFRecord framing
    around Event protos (field 2 step, field 5 summary -> value -> tag 1,
    simple_value 2); unknown fields are skipped."""
    import struct

    def fields(buf):
        i = 0
        while i < len(buf):
            key, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                key |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            num, wire = key >> 3, key & 7
            if wire == 0:
                v, shift = 0, 0
                while True:
                    b = buf[i]
                    i += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
            elif wire == 1:
                v, i = buf[i:i + 8], i + 8
            elif wire == 5:
                v, i = buf[i:i + 4], i + 4
            else:
                ln, shift = 0, 0
                while True:
                    b = buf[i]
                    i += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                v, i = buf[i:i + ln], i + ln
            yield num, v

    out = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack("<Q", data[off:off + 8])
        event = data[off + 12:off + 12 + ln]
        off += 16 + ln
        ev = dict(fields(event))
        if 5 not in ev:
            continue
        for num, val in fields(ev[5]):
            if num != 1:
                continue
            v = dict(fields(val))
            step = ev.get(2, 0)
            step = step - (1 << 64) if step >= 1 << 63 else step
            out.setdefault(v[1].decode(), []).append(
                (step, struct.unpack("<f", v[2])[0]))
    return out


def tail_phase(torch, np, fa, fb):
    """The single-process tail on the card (docstring item 34). Returns
    the launches of B5, B6, B7, B1, B2, B3 in the Custom-headed
    ``Module.fit``."""
    import contextlib
    import glob
    import io
    import json as _json
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.models import resnet

    _free(torch)
    softmax = _tail_rtc(torch, np, mx)
    _register_rtc_head(mx, softmax)
    _tail_heads(torch, np, mx, resnet)

    # step 3: Module.fit with the Custom head, a Monitor, the profiler in
    # mode all and LogMetricsCallback
    n = FIT_BATCH
    b = _resnet_batch(np, 0, n)
    x = np.concatenate([b["data"]] * TAIL_BATCHES)
    y = np.concatenate([b["softmax_label"]] * TAIL_BATCHES)
    tmp = tempfile.mkdtemp(prefix="tail_")
    sym = _custom_headed(mx, resnet)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    it = mx.io.NDArrayIter(x, y, batch_size=n)
    mon = mx.mon.Monitor(TAIL_MON_INTERVAL)
    tb = mx.contrib.tensorboard.LogMetricsCallback(
        os.path.join(tmp, "tb"), prefix="train")
    per_batch = []      # (seconds, cross-entropy, B1, B2, B3)
    checks = []         # (step, name, torch's stat)
    last = {"t": None, "counts": (0, 0, 0)}

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        probs = mod.get_outputs()[0].asnumpy()
        lbl = param.locals["data_batch"].label[0].asnumpy().astype(int)
        ce = float(-np.log(probs[np.arange(n), lbl] + 1e-12).mean())
        counts = _fb_counts(fb)
        per_batch.append((now - last["t"], ce) + tuple(
            a - c for a, c in zip(counts, last["counts"])))
        if param.nbatch % TAIL_MON_INTERVAL == 0:
            exe = mod._exec_group.execs[0]
            for name, t in (("fc1_weight", exe.arg_dict["fc1_weight"].tensor),
                            ("softmax_output", exe.outputs[0].tensor)):
                # torch's norm in float64: its float32 vector_norm can be
                # further from the exact value than the Monitor's stat
                checks.append((param.nbatch + 1, name, float(
                    torch.linalg.vector_norm(t.double())
                    / math.sqrt(t.numel()))))
        last["t"], last["counts"] = time.perf_counter(), _fb_counts(fb)

    collect = _Collect()
    root = logging.getLogger()
    root.addHandler(collect)
    root.setLevel(logging.INFO)
    trace = os.path.join(tmp, "trace.json")
    try:
        mx.random.seed(0)
        profiler.set_config(mode="all", filename=trace)
        torch.cuda.synchronize()
        _reset_counts(fa)
        _reset_fb_counts(fb)
        profiler.set_state("run")
        last["t"] = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=FIT_OPT,
                initializer=mx.init.Xavier(), eval_metric=["acc", "ce"],
                batch_end_callback=[on_batch, tb], monitor=mon)
        torch.cuda.synchronize()
        profiler.set_state("stop")
        launches = _counts(fa) + _fb_counts(fb)
        profiler.dump_profile()
    finally:
        profiler.set_state("stop")
        profiler.set_config()
        root.removeHandler(collect)
        root.setLevel(logging.WARNING)
    tb.summary_writer.close()
    with open(trace) as f:
        events = _json.load(f)["traceEvents"]
    cats = {}
    for e in events:
        cats.setdefault(e["cat"], []).append(e["name"])
    op_names = {}
    for name in cats.get("operator", []):
        op_names[name] = op_names.get(name, 0) + 1
    (event_file,) = glob.glob(os.path.join(tmp, "tb", "events.out.*"))
    scalars = _read_scalars(event_file)

    # where a batch of the Custom-headed fit goes (profiler off)
    data_batch = next(iter(it))
    it.reset()

    def one_batch():
        mod.forward_backward(data_batch)
        mod.update()

    prof = {}
    _device_profile(torch, one_batch, top=6, stats=prof)
    busy = prof.get("busy_ms", 0.0) / prof.get("wall_ms", 1.0)
    arg_names = sym.list_arguments()
    del mod
    shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)

    secs = [p[0] for p in per_batch]
    losses = [p[1] for p in per_batch]
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2]
    fit_rate, fit_busy = FIT_RATES.get("module_fit", (float("nan"),) * 2)
    print("tail fit: Module.fit of the Custom-headed fused ResNet-50, fp32, "
          "%d batches of %d, Monitor(interval=%d), profiler mode all, "
          "LogMetricsCallback; launches a batch %s (B5-B7 %d, %d, %d); "
          "cross-entropy %s; seconds a batch %s; %.1f images/s (median "
          "after the first), device busy %.3f of a profiled batch; the "
          "module_fit phase this call: %.1f images/s, busy %.3f"
          % (len(per_batch), n, TAIL_MON_INTERVAL,
             " ".join("%d/%d/%d" % p[2:] for p in per_batch),
             *launches[:3], " ".join("%.5f" % v for v in losses),
             " ".join("%.4f" % v for v in secs), n / med, busy, fit_rate,
             fit_busy))
    monitored = sorted({s for s, _k, _v in collect.rows})
    want_names = ["softmax_output"] + arg_names
    by_step = {s: [k for s2, k, _ in collect.rows if s2 == s]
               for s in monitored}
    logged = {(s, k): v for s, k, v in collect.rows}
    stat_errs = [abs(logged[(s, k)] - v) / abs(v) for s, k, v in checks]
    print("tail monitor: %d rows at steps %s (%d a step: 1 output, %d "
          "arguments); fc1_weight and softmax_output stats vs torch's "
          "float64 norm/sqrt(size), worst relative %.3g (tol %g)"
          % (len(collect.rows), monitored, len(want_names),
             len(arg_names), max(stat_errs) if stat_errs else float("nan"),
             TAIL_STAT_TOL))
    print("tail trace: %d events; by category %s; operator events by "
          "name (top 6) %s"
          % (len(events), {k: len(v) for k, v in sorted(cats.items())},
             sorted(op_names.items(), key=lambda kv: -kv[1])[:6]))
    print("tail events: %s" % ", ".join(
        "%s steps %s" % (tag, [s for s, _v in vals])
        for tag, vals in sorted(scalars.items())))

    # step 4: print_summary of the ResNet-50 symbol
    summary = io.StringIO()
    full = resnet.get_symbol(fused=True, **RESNET)
    with contextlib.redirect_stdout(summary):
        total = mx.viz.print_summary(full, shape={"data": (1, 3, 224, 224)})
    arg_shapes, _, _ = full.infer_shape(data=(1, 3, 224, 224))
    want_total = sum(int(np.prod(s)) for k, s in zip(full.list_arguments(),
                                                     arg_shapes)
                     if k not in ("data", "softmax_label"))
    lines = summary.getvalue().splitlines()
    print("tail summary: print_summary of the fused ResNet-50 at (1, 3, "
          "224, 224): %d lines, %r; the arguments' sizes sum to %d"
          % (len(lines), lines[-2], want_total))

    per = [p[2:] for p in per_batch]
    want_per = (B1_PER_FORWARD, B2_PER_STEP, B3_PER_STEP)
    want_steps = list(range(1, TAIL_BATCHES + 1))
    bad = []
    if len(per_batch) != TAIL_BATCHES or any(p != want_per for p in per) \
            or launches[:3] != (0, 0, 0):
        bad.append("launches a batch %s, want %s" % (per, want_per))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        bad.append("loss did not fall: %s" % losses)
    if monitored != list(range(1, TAIL_BATCHES + 1, TAIL_MON_INTERVAL)) or \
            any(by_step[s] != want_names for s in monitored):
        bad.append("monitor rows at %s" % monitored)
    if len(checks) != 2 * len(monitored) or not stat_errs or \
            max(stat_errs) > TAIL_STAT_TOL:
        bad.append("monitor stats off torch's: %s" % stat_errs)
    n_fwd = cats.get("forward", []).count(sym.name)
    n_bwd = cats.get("backward", []).count(sym.name)
    n_fb = cats.get("forward_backward", []).count(sym.name)
    if (n_fwd, n_bwd, n_fb) != (TAIL_BATCHES,) * 3 or \
            not {"one_hot", "sgd_mom_update", "norm"} <= set(op_names):
        bad.append("trace forward/backward/forward_backward %d/%d/%d, "
                   "operators %s" % (n_fwd, n_bwd, n_fb, sorted(op_names)))
    if any([s for s, _v in scalars.get(t, [])] != want_steps
           for t in ("train-accuracy", "train-cross-entropy")):
        bad.append("event steps %s" % {t: [s for s, _v in v]
                                       for t, v in scalars.items()})
    if total != want_total or not 25.5e6 < total < 25.6e6:
        bad.append("print_summary total %d, want %d" % (total, want_total))
    if bad:
        raise RuntimeError("tail: " + "; ".join(bad))
    return launches


# Tensor parallelism of a symbol (mp_symbol_phase): MXNET_MP_RULES shard the
# fused ResNet-50's stage-3 and stage-4 conv weights on their output
# channels and fc1's rows over train_mesh(mp=2), 2 gloo ranks sharing the
# card as in mp_training_phase. Each rank holds half of those weights; every
# use but fc1's (a column-parallel product) gathers them whole, so B1-B3 see
# whole weights. (a) Module.fit(kvstore='tpu') in fp32 (TF32 off) under
# MXNET_MP_SIZE=2 against one device; (b) the bf16 AOTPredictor(mesh=) behind
# ModelServer against the unsharded predictor; (c) GenerateServer(spec_k=4)
# with a 1-layer self-draft over the sharded full-width transformer against
# the unsharded server; (d) a 2-member replica group of (b) behind
# FleetRouter, whose follower is SIGKILLed. (b) also binds
# resnet.init_params' weights (He-normal, logits of O(1-10), where a bf16
# ulp is large) sharded and unsharded, in bf16 and fp32: the fp32 binds
# agree within MP_GRAD_TOL of the largest logit, and the sharded bf16
# logits lie no farther from fp32 (RMS) than MP_RATIO x the unsharded
# bf16's; the gaps are printed in bf16 ulps. Rates of a shared card, with
# every collective staged through the host by gloo, are not scaling rates.
MPS_RULES = r"stage[34]_unit\d+_conv\d_weight:mp,*,*,*;fc1_weight:mp,*"
MPS_BATCH, MPS_BATCHES = 32, 4
MPS_SERVE_IMAGES, MPS_SERVE_REPS = 16, 6
MPS_LOGIT_TOL = 0.02
MPS_SPEC = dict(requests=6, new=32, k=4, draft=1)
MPS_GROUP_REQUESTS = 8
MPS_TIMEOUT = 600


def _mps_fit(torch, np, fb, mx, sym, args, auxs, batches):
    """Module.fit(kvstore='tpu') over ``batches`` (a list of (data, label)
    numpy pairs) from ``args``/``auxs`` (numpy), fp32; returns (whole params
    as numpy, seconds a batch, B1/B2/B3 launches, peak GiB, fused?)."""
    import logging

    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    it = mx.io.NDArrayIter(x, y, batch_size=MPS_BATCH)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    per = []

    def on_batch(param):
        torch.cuda.synchronize()
        per.append(time.perf_counter())

    logging.getLogger().setLevel(logging.WARNING)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_fb_counts(fb)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore="tpu", optimizer="sgd",
            optimizer_params=FIT_OPT,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in auxs.items()},
            batch_end_callback=on_batch)
    launches = _fb_counts(fb)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return (params, [b - a for a, b in zip([t0] + per[:-1], per)],
            launches, peak, mod._fused is not None)


def _mps_rel(np, got, ref):
    """Each tensor's relative L2 distance to ``ref`` (numpy dicts)."""
    return {k: float(np.linalg.norm((got[k] - r).astype(np.float64))
                     / max(np.linalg.norm(r.astype(np.float64)), 1e-30))
            for k, r in ref.items()}


def _mps_spec_run(torch, np, fa, srv, work):
    """Every prompt of ``work`` submitted at once; (results, wall s, B5
    launches, stats)."""
    from mxnet_tpu_torch import profiler

    torch.cuda.synchronize()
    profiler.generate_reset()
    _reset_counts(fa)
    t0 = time.perf_counter()
    futs = [srv.submit(np.asarray(w[1], np.int32),
                       max_new_tokens=MPS_SPEC["new"]) for w in work]
    results = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, fa.flash_attention.launches, \
        srv.stats()


def _mps_setup(torch, np):
    """The fused ResNet-50, its Xavier params and aux (numpy, seed 0) and
    the fit's batches, the same in every process."""
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel.spmd import TrainStep

    sym = resnet.get_symbol(fused=True, **RESNET)
    shapes = {"data": (MPS_BATCH,) + RESNET["image_shape"],
              "softmax_label": (MPS_BATCH,)}
    one_dev = TrainStep(sym, RESNET_OPT, device=CARD)
    init = one_dev.init_params(shapes, initializer=Xavier(), seed=0)
    args = {k: v.cpu().numpy() for k, v in init[0].items()}
    auxs = {k: v.cpu().numpy() for k, v in init[2].items()}
    batches = [tuple(_resnet_batch(np, s, MPS_BATCH).values())
               for s in range(MPS_BATCHES)]
    return sym, one_dev, args, auxs, batches


def _mps_grads(torch, step, args, auxs, batch):
    """The loss and the whole gradients (numpy) of ``step``'s first step
    on ``batch`` from ``args``/``auxs`` (a mesh step's blocks gathered)."""
    p = {k: torch.from_numpy(v.copy()).to(CARD) for k, v in args.items()}
    a = {k: torch.from_numpy(v.copy()).to(CARD) for k, v in auxs.items()}
    if step.mesh is not None:
        p, _o, a, _s = step.place(p, {}, a)
    loss, g, _ = step.value_and_grad(p, a, {"data": batch[0],
                                            "softmax_label": batch[1]})
    g = step.whole_params(g)
    return float(loss), {k: v.float().cpu().numpy() for k, v in g.items()}


def _mps_serve(torch, np, fb, pred, x):
    """``pred`` behind a ModelServer: the logits of ``x``, the B1 launches
    of one forward and images/s over MPS_SERVE_REPS more."""
    from mxnet_tpu_torch.serving import ModelServer

    srv = ModelServer(ladder=(MPS_SERVE_IMAGES,), dtype="bfloat16")
    try:
        srv.add_model("resnet50", predictor=pred)
        srv.predict("resnet50", x)                  # warm-up
        _reset_fb_counts(fb)
        out = srv.predict("resnet50", x)[0]
        b1 = fb.conv_fwd.launches
        t0 = time.perf_counter()
        for _ in range(MPS_SERVE_REPS):
            srv.predict("resnet50", x)
        wall = time.perf_counter() - t0
    finally:
        srv.close()
    return out, b1, MPS_SERVE_REPS * MPS_SERVE_IMAGES / wall


def _mps_serve_kw():
    return dict(data_shapes={"data": (1,) + RESNET["image_shape"]},
                ladder=(MPS_SERVE_IMAGES,), dtype="bfloat16",
                output_names=["fc1_output"])


def _mps_probe_kw(dtype):
    """The rounding probe's bind: (b)'s, in ``dtype``, serving the logits
    and the probabilities."""
    return dict(_mps_serve_kw(), dtype=dtype,
                output_names=["fc1_output", "softmax_output"])


def _mps_he(sym):
    """resnet.init_params' weights (seed 0) of the fused ResNet-50."""
    from mxnet_tpu_torch.models import resnet

    return resnet.init_params(sym, (1,) + RESNET["image_shape"], seed=0)


def _mps_probe(np, sharded, ref):
    """The rounding probe's numbers from the sharded binds' (logits,
    probabilities) by dtype and the unsharded ones (``ref``'s
    ``he_logits_<dtype>``, ``he_probs_<dtype>``); logit gaps in bf16 ulps
    at the largest |logit| of the fp32 bind."""
    l32 = ref["he_logits_float32"].astype(np.float64)
    lu = ref["he_logits_bfloat16"].astype(np.float64)
    ls, ps = (a.astype(np.float64) for a in sharded["bfloat16"])
    ls32 = sharded["float32"][0].astype(np.float64)
    pu = ref["he_probs_bfloat16"].astype(np.float64)
    top = float(np.abs(l32).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)

    def rms(d):
        return float(np.sqrt(np.mean(d * d)) / ulp)

    return dict(top=top, ulp=float(ulp),
                bf16_ulps=float(np.abs(ls - lu).max() / ulp),
                probs=float(np.abs(ps - pu).max() / pu.max()),
                u_ulps=float(np.abs(lu - l32).max() / ulp),
                u_rms=rms(lu - l32),
                s_ulps=float(np.abs(ls - l32).max() / ulp),
                s_rms=rms(ls - l32),
                fp32=float(np.abs(ls32 - l32).max()) / top,
                finite=bool(np.isfinite(ls).all() and np.isfinite(ls32).all()))


def _mps_spec_setup(np):
    from mxnet_tpu_torch.models import transformer as tfm

    t_ = SPEC_TRACE
    cfg = tfm.TransformerConfig(**FULL)
    params = _damp_upper_layers(tfm.init_params(cfg, seed=0), t_["damp"])
    work = _spec_workload(cfg.vocab)[:MPS_SPEC["requests"]]
    skw = dict(slots=t_["slots"], page_size=t_["page"],
               spec_k=MPS_SPEC["k"], draft=MPS_SPEC["draft"])
    return cfg, params, work, skw


def _mps_spec_summary(run):
    results, wall, b5, st = run
    n_tok = sum(len(r["tokens"]) for r in results)
    return dict(tokens=n_tok, wall=wall, tokens_s=n_tok / wall, b5=b5,
                lengths=[len(r["tokens"]) for r in results],
                reasons=sorted({r["finish_reason"] for r in results}),
                chains=[list(r["tokens"]) for r in results],
                **{k: st.get(k) for k in (
                    "prefills", "spec_rounds", "draft_proposed",
                    "draft_accepted", "acceptance_rate", "decode_steps")})


def _mps_reference(torch, np, fa, fb, path):
    """One device, in this process before the ranks start: (a)'s first-step
    gradients, the one-rounding yardstick (MP_NUDGES nudged inits) and the
    fits from the init and from a nudged init, saved to ``path`` (.npz) for
    rank 0 to compare; (b)'s unsharded predictor; (c)'s unsharded server."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import AOTPredictor, GenerateServer

    sym, one_dev, args, auxs, batches = _mps_setup(torch, np)
    loss, grads = _mps_grads(torch, one_dev, args, auxs, batches[0])
    yard = {}
    for i in range(MP_NUDGES):
        rng = np.random.RandomState(300 + i)
        _l, g = _mps_grads(torch, one_dev, {k: _zoo_nudged(np, v, rng)
                                            for k, v in args.items()},
                           auxs, batches[0])
        for k, v in _mps_rel(np, g, grads).items():
            yard[k] = max(yard.get(k, 0.0), v)
        del g
    fit = _mps_fit(torch, np, fb, mx, sym, args, auxs, batches)
    one_fit = dict(secs=fit[1], launches=fit[2], peak_gib=fit[3])
    rng = np.random.RandomState(400)
    nudged = _mps_fit(torch, np, fb, mx, sym, {k: _zoo_nudged(np, v, rng)
                                              for k, v in args.items()},
                      auxs, batches)
    out = {"loss": np.float64(loss)}
    out.update({"g/" + k: v for k, v in grads.items()})
    out.update({"y/" + k: np.float64(v) for k, v in yard.items()})
    out.update({"p/" + k: v for k, v in fit[0].items()})
    out.update({"n/" + k: v for k, v in nudged[0].items()})
    x = _resnet_images(np, 11, MPS_SERVE_IMAGES)
    served = _mps_serve(torch, np, fb, AOTPredictor(
        sym, args, auxs, device=CARD, **_mps_serve_kw()), x)
    out["serve_out"] = served[0]
    he = _mps_he(sym)
    for dt in ("bfloat16", "float32"):
        out["he_logits_" + dt], out["he_probs_" + dt] = AOTPredictor(
            sym, *he, device=CARD, **_mps_probe_kw(dt)).predict(x)
    np.savez(path, **out)
    del grads, fit, nudged, out
    _free(torch)
    cfg, params, work, skw = _mps_spec_setup(np)
    srv = GenerateServer(cfg, params, **skw)
    try:
        srv.generate(np.ones((8,), np.int32), max_new_tokens=4)
        spec = _mps_spec_summary(_mps_spec_run(torch, np, fa, srv, work))
    finally:
        srv.close()
    _free(torch)
    return dict(one_fit=one_fit, serve=dict(b1=served[1], rate=served[2]),
                spec=spec)


def _mp_symbol_work(torch, np, fa, rank):
    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.kernels import fused_block as fb
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.parallel.spmd import (TrainStep, param_shardings,
                                               parse_rules)
    from mxnet_tpu_torch.serving import AOTPredictor, GenerateServer
    from mxnet_tpu_torch.serving.generate import GenerativePredictor

    rules = parse_rules(MPS_RULES)
    sym, _one, args, auxs, batches = _mps_setup(torch, np)
    res = {"rank": rank}

    # -- (a) the first step's gradients, then Module.fit under the knobs ----
    mesh = train_mesh(mp=MP_RANKS)
    ts = TrainStep(sym, RESNET_OPT, mesh=mesh, param_rules=rules)
    tpl.reset_counts()
    loss, grads = _mps_grads(torch, ts, args, auxs, batches[0])
    res["grad_collectives"] = (tpl.counts(), tpl.wire_bytes())
    del ts
    _free(torch)
    os.environ["MXNET_MP_SIZE"] = str(MP_RANKS)
    os.environ["MXNET_MP_RULES"] = MPS_RULES
    profiler.mp_reset()
    tpl.reset_counts()
    fit = _mps_fit(torch, np, fb, mx, sym, args, auxs, batches)
    res["fit_collectives"] = (tpl.counts(), tpl.wire_bytes())
    del os.environ["MXNET_MP_SIZE"], os.environ["MXNET_MP_RULES"]
    res["mp_stats"] = profiler.mp_stats()
    res["fit"] = dict(secs=fit[1], launches=fit[2], peak_gib=fit[3],
                      fused=fit[4])
    whole = sum(v.nbytes for v in args.values())
    specs = param_shardings({k: v.shape for k, v in args.items()}, mesh,
                            rules)
    held = sum(v.nbytes // (MP_RANKS if any(specs[k].spec) else 1)
               for k, v in args.items())
    res.update(whole_bytes=whole, exact_bytes=held,
               sharded=sum(1 for s in specs.values() if any(s.spec)))
    if rank == 0:
        with np.load(os.environ["MPS_REF"]) as ref:
            rgrads = {k: ref["g/" + k] for k in grads}
            yard = {k: float(ref["y/" + k]) for k in grads}
            gaps = _mps_rel(np, grads, rgrads)
            over = sorted((g / max(MP_GRAD_TOL, MP_RATIO * yard[k]), k)
                          for k, g in gaps.items())
            one = {k: ref["p/" + k] for k in fit[0]}
            pgaps = _mps_rel(np, fit[0], one)
            pyard = _mps_rel(np, {k: ref["n/" + k] for k in fit[0]}, one)
            pover = sorted((g / max(MP_GRAD_TOL, MP_RATIO * pyard[k]), k)
                           for k, g in pgaps.items())
            res.update(loss=loss, ref_loss=float(ref["loss"]),
                       grad_over=over[-3:], param_over=pover[-3:],
                       n_tensors=len(gaps), worst_grad=max(gaps.values()),
                       worst_param=max(pgaps.values()))
            plain = ref["serve_out"]
            ref_he = {k: ref[k] for k in ref.files if k.startswith("he_")}
    del grads, fit
    _free(torch)

    # -- (b) the sharded bf16 predictor behind ModelServer ------------------
    pred = AOTPredictor(sym, args, auxs, mesh=mesh, param_rules=rules,
                        **_mps_serve_kw())
    if rank != 0:
        _reset_fb_counts(fb)
        res["serve_follow"] = dict(calls=pred.follow(),
                                   b1=fb.conv_fwd.launches)
    else:
        res["sharded_stats"] = pred.sharded_stats()
        out, b1, rate = _mps_serve(torch, np, fb, pred, _resnet_images(
            np, 11, MPS_SERVE_IMAGES))
        pred.close()
        scale = float(np.abs(plain).max())
        res["serve"] = dict(err=float(np.abs(out - plain).max()),
                            scale=scale, b1=b1, rate=rate,
                            finite=bool(np.isfinite(out).all()),
                            shape=list(out.shape))
    del pred
    _free(torch)

    # -- (b) the rounding probe on resnet.init_params' weights --------------
    he, probe = _mps_he(sym), {}
    for dt in ("bfloat16", "float32"):
        pred = AOTPredictor(sym, *he, mesh=mesh, param_rules=rules,
                            **_mps_probe_kw(dt))
        if rank != 0:
            pred.follow()
        else:
            probe[dt] = pred.predict(_resnet_images(np, 11,
                                                    MPS_SERVE_IMAGES))
            pred.close()
        del pred
        _free(torch)
    if rank == 0:
        res["probe"] = _mps_probe(np, probe, ref_he)
    del he, probe

    # -- (c) speculative decoding over the sharded transformer --------------
    cfg, params, work, skw = _mps_spec_setup(np)
    if rank != 0:
        pred = GenerativePredictor(cfg, params, mesh=mesh,
                                   slots=skw["slots"],
                                   page_size=skw["page_size"])
        _reset_counts(fa)
        calls = pred.follow()
        res["spec_follow"] = dict(calls=calls, b5=fa.flash_attention.launches)
        return res
    srv = GenerateServer(cfg, params, mesh=mesh, **skw)
    try:
        srv.generate(np.ones((8,), np.int32), max_new_tokens=4)
        res["spec"] = _mps_spec_summary(_mps_spec_run(torch, np, fa, srv,
                                                      work))
        res["shares"] = all(
            v.untyped_storage().data_ptr()
            == srv.predictor._params[k].untyped_storage().data_ptr()
            for k, v in srv.draft_predictor._params.items())
    finally:
        srv.close()
    return res


def _mps_group(torch, np, fb):
    """(d): (b)'s bf16 fused ResNet-50 (its Xavier weights, its logits)
    served by a 2-member replica group (AOTPredictor(mesh=train_mesh(mp=2))
    across 2 replica processes) behind FleetRouter; the follower is
    SIGKILLed and the group must drain with nothing sent. Returns the
    report and the leader's launches."""
    import shutil
    import socket
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.serving import AOTPredictor, FleetRouter
    from mxnet_tpu_torch.serving.fleet import NoLiveReplica
    from mxnet_tpu_torch.tracker import Tracker

    tmp = tempfile.mkdtemp(prefix="mps_group_")
    cpu = mx.cpu()
    sym, _one, args, auxs, _batches = _mps_setup(torch, np)
    del _one
    sym = sym.get_internals()["fc1_output"]
    shape = (1,) + RESNET["image_shape"]
    prefix = os.path.join(tmp, "resnet50")
    mx.model.save_checkpoint(
        prefix, 0, sym, {k: mx.nd.array(v, ctx=cpu) for k, v in args.items()},
        {k: mx.nd.array(v, ctx=cpu) for k, v in auxs.items()})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    procs = _FleetProcs(trk.addr, prefix, shape, tmp)
    router = None
    report = {}
    try:
        t0 = time.perf_counter()
        for r in range(MP_RANKS):
            procs.spawn(r, ("--group", "g", "--group-size", str(MP_RANKS),
                            "--group-rank", str(r), "--group-init",
                            "tcp://localhost:%d" % port),
                        knobs={"MXNET_MP_RULES": MPS_RULES})
        pred = AOTPredictor(sym, args, auxs, data_shapes={"data": shape},
                            ladder=FLEET_LADDER, dtype=FLEET_DTYPE,
                            device=CARD)
        router = FleetRouter(tracker_uri=trk.addr, view_interval=FLEET_VIEW_S,
                             timeout=60.0, retries=1)
        profiler.fleet_reset()

        def routable():
            router.refresh_view(force=True)
            return [h.addr for h in router._routable("model", set())]

        def members():
            router.refresh_view(force=True)
            return {h.group_rank: h for h in router._handles.values()
                    if h.group == "g" and h.alive}

        deadline = time.monotonic() + FLEET_BOOT_S
        while len(members()) < MP_RANKS or not routable():
            dead = [r for r, p in procs.procs.items()
                    if p.poll() is not None]
            if dead or time.monotonic() > deadline:
                raise RuntimeError("mp group: not serving (dead %s)\n%s"
                                   % (dead, procs.tails()))
            time.sleep(0.2)
        report["boot_s"] = time.perf_counter() - t0
        group = members()
        if routable() != [group[0].addr]:
            raise RuntimeError("mp group: routable %s, want the leader %s"
                               % (routable(), group[0].addr))
        pool = _fleet_images(np, shape, 9)
        err, scale, secs = 0.0, 0.0, []
        for i in range(MPS_GROUP_REQUESTS):
            x = pool[1 + i % FLEET_MAX_IMAGES]
            t1 = time.perf_counter()
            got = router.request("model", x)[0]
            secs.append(time.perf_counter() - t1)
            want = pred.predict(x)[0]
            if got.shape != want.shape or not np.isfinite(got).all():
                raise RuntimeError("mp group request %d: output %s, want %s"
                                   % (i, got.shape, want.shape))
            err = max(err, float(np.abs(got - want).max()))
            scale = max(scale, float(np.abs(want).max()))
        report.update(worst=err / scale, err=err, scale=scale,
                      request_ms=sorted(secs)[len(secs) // 2] * 1e3)
        procs.kill(1)
        t1 = time.perf_counter()
        while routable():
            if time.perf_counter() - t1 > 60:
                raise RuntimeError("mp group: not drained after the kill")
            time.sleep(0.05)
        report["drain_s"] = time.perf_counter() - t1
        try:
            router.request("model", pool[1], timeout=5.0)
            report["drained"] = "a request was served"
        except NoLiveReplica as e:
            report["drained"] = "NoLiveReplica: %s" % e
        stats = profiler.fleet_stats()
        report.update(failovers=stats.get("failovers", 0),
                      inflight_lost=stats.get("inflight_lost", 0))
        router.stop_fleet()
        procs.stop()
        report["launches"] = procs.launches()
    finally:
        if router is not None:
            router.close()
        for r, p in procs.procs.items():
            if p.poll() is None:
                p.kill()
        trk.shutdown()
        tails = procs.tails()
        shutil.rmtree(tmp, ignore_errors=True)
    report["tails"] = tails
    return report


def mp_symbol_phase(torch, np, fa, fb):
    """Tensor parallelism of a symbol over train_mesh(mp=2) (the comment
    above MPS_RULES); returns, for the kernels line, each rank's B1, B2, B3
    launches a fit batch, each rank's B1 launches of the sharded predictor,
    each rank's B5 launches of the sharded speculative run and the group
    leader's B1."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.models import transformer as tfm

    _free(torch)
    tmp = tempfile.mkdtemp(prefix="mps_")
    try:
        t0 = time.perf_counter()
        ref = _mps_reference(torch, np, fa, fb, os.path.join(tmp, "ref.npz"))
        print("mp symbol: one-device references in %.1f s"
              % (time.perf_counter() - t0))
        os.environ["MPS_REF"] = os.path.join(tmp, "ref.npz")
        try:
            ranks, wall = _run_ranks(_mp_gloo_rank, MP_RANKS, MPS_TIMEOUT,
                                     "mp symbol", "symbol")
        finally:
            os.environ.pop("MPS_REF", None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lead, follower = ranks
    gc_, gb = lead["grad_collectives"]
    fc_, fbytes = lead["fit_collectives"]
    ratio = lead["mp_stats"]["param_bytes_per_chip"] / lead["whole_bytes"]
    exact = lead["exact_bytes"] / lead["whole_bytes"]
    print("mp symbol: %d gloo ranks sharing one card, train_mesh(mp=%d), "
          "%.1f s with start-up; rules %r shard %d parameters; mp_stats %s; "
          "param bytes a rank %d of %d (%.6f, exact from the rules %.6f)"
          % (MP_RANKS, MP_RANKS, wall, MPS_RULES, lead["sharded"],
             lead["mp_stats"], lead["mp_stats"]["param_bytes_per_chip"],
             lead["whole_bytes"], ratio, exact))
    print("mp symbol (a) fp32 first step, batch %d: loss %.6f vs one device "
          "%.6f; gradients unsharded vs one device, relative L2 worst %.4g; "
          "worst of %d tensors over max(%g, %g x its one-rounding gap): %s; "
          "collectives of the step %s, bytes sent %s"
          % (MPS_BATCH, lead["loss"], lead["ref_loss"], lead["worst_grad"],
             lead["n_tensors"], MP_GRAD_TOL, MP_RATIO,
             ", ".join("%.3g at %s" % tuple(r) for r in lead["grad_over"]),
             gc_, gb))
    for label, fit in [("one device", ref["one_fit"])] + [
            ("mp rank %d" % r["rank"], r["fit"]) for r in ranks]:
        print("mp symbol (a) Module.fit %s: %d batches of %d, seconds %s "
              "(%.1f images/s after the first); launches B1 %d, B2 %d, B3 "
              "%d; peak memory %.2f GiB"
              % (label, MPS_BATCHES, MPS_BATCH,
                 " ".join("%.4f" % s for s in fit["secs"]),
                 MPS_BATCH * (len(fit["secs"]) - 1) / sum(fit["secs"][1:]),
                 *fit["launches"], fit["peak_gib"]))
    print("mp symbol (a) params after the fit vs one device, worst relative "
          "L2 %.4g; worst over max(%g, %g x the one-rounding fit's gap): %s; "
          "collectives of the fit %s, bytes sent %s"
          % (lead["worst_param"], MP_GRAD_TOL, MP_RATIO,
             ", ".join("%.3g at %s" % tuple(r) for r in lead["param_over"]),
             fc_,
             fbytes))
    sv = lead["serve"]
    print("mp symbol (b) bf16 AOTPredictor(mesh=) behind ModelServer, %d "
          "images: logits max |diff| vs the unsharded predictor %.4g, largest "
          "|logit| %.4g (tol %g of it); B1 a forward %d (unsharded %d), "
          "follower %s; %.1f images/s vs unsharded %.1f; sharded_stats %s"
          % (MPS_SERVE_IMAGES, sv["err"], sv["scale"], MPS_LOGIT_TOL,
             sv["b1"], ref["serve"]["b1"], follower["serve_follow"],
             sv["rate"], ref["serve"]["rate"], lead["sharded_stats"]))
    pr = lead["probe"]
    print("mp symbol (b) rounding probe, resnet.init_params' weights, %d "
          "images: largest |logit| %.4g (a bf16 ulp there %.4g); bf16 "
          "sharded vs unsharded: logits max %.2f ulps, probabilities max "
          "|diff| %.4g of the largest; from the fp32 bind, max / RMS in "
          "ulps: unsharded bf16 %.2f / %.4f, sharded bf16 %.2f / %.4f "
          "(RMS limit %g x the unsharded's); fp32 sharded vs unsharded "
          "logits %.3g of the largest (tol %g)"
          % (MPS_SERVE_IMAGES, pr["top"], pr["ulp"], pr["bf16_ulps"],
             pr["probs"], pr["u_ulps"], pr["u_rms"], pr["s_ulps"],
             pr["s_rms"], MP_RATIO, pr["fp32"], MP_GRAD_TOL))
    sp = dict(mp=lead["spec"], one=ref["spec"])
    cfg, params, work, _skw = _mps_spec_setup(np)
    parted = _near_tie_pairs(
        torch, np, tfm.make_forward_fn(cfg), _on_card(torch, params),
        [(w[1], a, b) for w, a, b in zip(work, sp["mp"]["chains"],
                                         sp["one"]["chains"])],
        "mp symbol spec vs one device")
    del params
    _free(torch)
    for label in ("mp", "one"):
        m = sp[label]
        print("mp symbol (c) spec_k=%d, %d-layer self-draft, %s: %d requests, "
              "%d tokens (each %s, %s) in %.3f s = %.1f tokens/s; prefills "
              "%d, spec_rounds %d, draft_proposed %d, accepted %d, "
              "acceptance_rate %s; B5 %d"
              % (MPS_SPEC["k"], MPS_SPEC["draft"],
                 "mp=2 leader" if label == "mp" else "one device",
                 len(m["lengths"]), m["tokens"], sorted(set(m["lengths"])),
                 m["reasons"], m["wall"], m["tokens_s"], m["prefills"],
                 m["spec_rounds"], m["draft_proposed"], m["draft_accepted"],
                 m["acceptance_rate"], m["b5"]))
    print("mp symbol (c) follower %s; chains parted at near-ties %d; the "
          "draft's tensors are the target's blocks: %s"
          % (follower["spec_follow"], len(parted), lead["shares"]))
    t0 = time.perf_counter()
    grp = _mps_group(torch, np, fb)
    print("mp symbol (d) replica group of %d processes: boot %.1f s, %d "
          "routed requests of 1..%d images, logits max |diff| vs the "
          "unsharded in-process predictor %.4g, largest %.4g (%.4g of it, "
          "tol %g), median request %.1f ms; after SIGKILL of the follower: "
          "drained in %.2f s, %s; failovers %d, inflight_lost %d; leader "
          "launches %s; %.1f s"
          % (MP_RANKS, grp["boot_s"], MPS_GROUP_REQUESTS, FLEET_MAX_IMAGES,
             grp["err"], grp["scale"], grp["worst"],
             MPS_LOGIT_TOL, grp["request_ms"], grp["drain_s"],
             grp["drained"], grp["failovers"], grp["inflight_lost"],
             grp["launches"], time.perf_counter() - t0))

    per_batch = [B1_PER_FORWARD, B1_PER_FORWARD, 3 * RESNET_UNITS]
    for r in ranks:
        want = [n * MPS_BATCHES for n in per_batch]
        if list(r["fit"]["launches"]) != want or not r["fit"]["fused"]:
            raise RuntimeError("mp symbol (a) rank %d: launches %s, want %s"
                               % (r["rank"], r["fit"]["launches"], want))
    if abs(ratio - exact) > 1e-12 or lead["sharded"] == 0:
        raise RuntimeError("mp symbol: param bytes ratio %.6f, exact %.6f"
                           % (ratio, exact))
    if lead["grad_over"][-1][0] > 1 or lead["param_over"][-1][0] > 1 or \
            not np.isfinite(lead["loss"]):
        raise RuntimeError("mp symbol (a): gradients %s, params %s"
                           % (lead["grad_over"], lead["param_over"]))
    if not sv["finite"] or sv["shape"] != [MPS_SERVE_IMAGES,
                                           RESNET["num_classes"]] \
            or sv["err"] > MPS_LOGIT_TOL * sv["scale"] or \
            sv["b1"] != B1_PER_FORWARD or \
            follower["serve_follow"]["b1"] != B1_PER_FORWARD * (
                MPS_SERVE_REPS + 2):
        raise RuntimeError("mp symbol (b): %s, follower %s"
                           % (sv, follower["serve_follow"]))
    if not pr["finite"] or pr["fp32"] > MP_GRAD_TOL or \
            pr["s_rms"] > MP_RATIO * pr["u_rms"]:
        raise RuntimeError("mp symbol (b) rounding probe: %s" % pr)
    n_req = MPS_SPEC["requests"]
    for label in ("mp", "one"):
        m = sp[label]
        if m["lengths"] != [MPS_SPEC["new"]] * n_req or \
                m["reasons"] != ["length"] or not m["spec_rounds"] or \
                m["b5"] != (FULL["n_layers"] + MPS_SPEC["draft"]) * n_req:
            raise RuntimeError("mp symbol (c) %s: %s" % (label, m))
    if follower["spec_follow"]["b5"] != (FULL["n_layers"] + MPS_SPEC[
            "draft"]) * (n_req + 1) or not lead["shares"]:
        raise RuntimeError("mp symbol (c): follower %s, shares %s"
                           % (follower["spec_follow"], lead["shares"]))
    leader = grp["launches"].get(0)
    if grp["worst"] > MPS_LOGIT_TOL or grp["failovers"] or \
            grp["inflight_lost"] or \
            not grp["drained"].startswith("NoLiveReplica") or \
            leader is None or leader[3] != B1_PER_FORWARD * (
                1 + MPS_GROUP_REQUESTS) or leader[6]:
        raise RuntimeError("mp symbol (d): %s\n%s"
                           % ({k: v for k, v in grp.items() if k != "tails"},
                              grp["tails"]))
    return dict(train=[list(r["fit"]["launches"]) for r in ranks],
                serve=[sv["b1"], follower["serve_follow"]["b1"]],
                spec=[sp["mp"]["b5"], follower["spec_follow"]["b5"]],
                group=leader[3])


# ---------------------------------------------------------------------------
# Sequence, expert and pipeline parallelism (ROADMAP.md Queue A item 8c), on
# MP_RANKS gloo ranks sharing the card, every leg in fp32 with TF32 off
# against one device, held by the mp phases' yardstick: each gradient
# tensor within max(MP_GRAD_TOL, MP_RATIO x its one-rounding gap), the
# whole within MP_RATIO x its own, the loss within MP_LOSS_TOL.
# (a) sp = 2 on FULL at MP_BATCH, attn ring and ulysses (the ring's chunk
#     step and Ulysses' default core are PyTorch ops, as the JAX package's
#     are lax: no flash launch); then bf16 train steps on the ring.
# (b) ep = 2 on MOE_MP (8 experts, 4 a rank).
# (c) pp = 2: FULL's 12 blocks as 2 stages of 6, SEP_MICRO microbatches of
#     SEP_MB sequences of 2048, against the serial stack.
# (d) ulysses_attention(attn_fn=flash_attention) at SEP_ULYSSES, bf16.
# ---------------------------------------------------------------------------
SEP_TRAIN_WARMUP, SEP_TRAIN_STEPS = 1, 3
SEP_MICRO, SEP_MB, SEP_STAGES = 8, 1, 2
SEP_ULYSSES = (8, 8, 2048, 64)
SEP_TIMEOUT = 420


def _sep_ref(torch, np, loss_grads, params, seed):
    """One device's loss, gradients and outputs (``loss_grads(params) ->
    (loss, grads, out)``) and their one-rounding yardstick: each tensor's
    (and the output's, key "out") largest relative L2 move over MP_NUDGES
    runs with every param element moved by one rounding."""
    loss, grads, out = loss_grads(params)
    yard = {}
    for i in range(MP_NUDGES):
        rng = np.random.RandomState(seed + i)
        _l, g, o = loss_grads({k: torch.from_numpy(_zoo_nudged(
            np, v.detach().cpu().numpy(), rng)) for k, v in params.items()})
        if o is not None:
            g = dict(g, out=o)
        for k, v in _rel_l2(torch, g, dict(grads, **(
                {"out": out} if out is not None else {}))).items():
            yard[k] = max(yard.get(k, 0.0), v)
        del g, o
    _free(torch)
    return loss, grads, out, yard


def _sep_held(torch, grads, ref, out=None):
    """(loss-free) gaps of ``grads`` (and ``out``) against a _sep_ref."""
    _loss, rgrads, rout, yard = ref
    got, want = dict(grads), dict(rgrads)
    if out is not None:
        got["out"], want["out"] = out, rout
    gaps = _rel_l2(torch, got, want)
    whole, whole_yard = gaps.pop(None), yard[None]
    over = sorted((g / max(MP_GRAD_TOL, MP_RATIO * yard[k]), k)
                  for k, g in gaps.items())
    return dict(whole=whole, whole_yard=whole_yard, worst=over[-3:],
                ok=whole <= MP_RATIO * whole_yard and over[-1][0] <= 1)


def _sep_launches(fa, fb):
    return list(_counts(fa)) + list(_fb_counts(fb))


def _sep_reset(fa, fb, tpl):
    _reset_counts(fa)
    _reset_fb_counts(fb)
    tpl.reset_counts()


def _sep_sp_leg(torch, np, fa, fb, rank):
    """(a): ring and Ulysses on {"sp": 2}, then bf16 train steps."""
    import dataclasses

    import torch.distributed as dist

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl
    from mxnet_tpu_torch.parallel.mesh import all_reduce_flat_

    cfg32 = tfm.TransformerConfig(**dict(FULL, dtype="float32"))
    params = tfm.init_params(cfg32, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg32.vocab, MP_BATCH)
    ref = None
    if rank == 0:
        loss_fn, _ = tfm.make_loss_fn(cfg32, device=CARD)

        def loss_grads(ps):
            p = {k: v.to(CARD, copy=True).requires_grad_()
                 for k, v in ps.items()}
            loss = loss_fn(p, tokens)
            return loss.item(), dict(zip(p, torch.autograd.grad(
                loss, list(p.values())))), None

        ref = _sep_ref(torch, np, loss_grads, params, 400)
    dist.barrier()
    mesh = make_mesh({"sp": MP_RANKS}, device=CARD)
    res = {}
    for mode in ("ring", "ulysses"):
        cfg = dataclasses.replace(cfg32, attn=mode)
        loss_fn, _ = tfm.make_loss_fn(cfg, mesh)
        p = {k: v.requires_grad_() for k, v in
             tfm.shard_params(params, cfg, mesh).items()}
        _sep_reset(fa, fb, tpl)
        loss = loss_fn(p, tokens)
        fwd = tpl.counts()
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        _sync(torch)
        run = dict(loss=loss.item(), forward=fwd,
                   launches=_sep_launches(fa, fb),
                   wire=tpl.wire_bytes())
        # the ranks' shares summed: the gradient of the global loss
        all_reduce_flat_(list(grads.values()), dist.group.WORLD)
        if ref is not None:
            run["held"] = _sep_held(torch, grads, ref)
            run["ref_loss"] = ref[0]
        res[mode] = run
        del loss, grads, p
        _free(torch)
    del ref
    _free(torch)
    cfg = tfm.TransformerConfig(**dict(FULL, attn="ring"))
    step, place = tfm.make_train_step(
        cfg, mesh, optimizer=dict(name="sgd", learning_rate=0.1,
                                  momentum=0.9))
    carry = place(params)
    losses, secs = [], []
    for _ in range(SEP_TRAIN_WARMUP):
        carry, loss = step(carry, tokens)
        losses.append(loss.item())
    _sync(torch)
    if CARD == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sep_reset(fa, fb, tpl)
    for _ in range(SEP_TRAIN_STEPS):
        t0 = time.perf_counter()
        carry, loss = step(carry, tokens)
        _sync(torch)
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    res["train"] = dict(
        losses=losses, secs=secs, launches=_sep_launches(fa, fb),
        collectives=tpl.counts(),
        tokens_s=MP_BATCH[0] * (MP_BATCH[1] - 1) * SEP_TRAIN_STEPS
        / sum(secs),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30
        if CARD == "cuda" else 0.0)
    del carry
    _free(torch)
    return res


def _sep_ep_leg(torch, np, fa, fb, rank):
    """(b): the MoE on {"ep": 2}."""
    import torch.distributed as dist

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl

    cfg = tfm.TransformerConfig(**MOE_MP)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, MOE_MP_BATCH)
    ref = None
    if rank == 0:
        loss_fn, _ = tfm.make_loss_fn(cfg, device=CARD)

        def loss_grads(ps):
            p = {k: v.to(CARD, copy=True).requires_grad_()
                 for k, v in ps.items()}
            loss = loss_fn(p, tokens)
            return loss.item(), dict(zip(p, torch.autograd.grad(
                loss, list(p.values())))), None

        ref = _sep_ref(torch, np, loss_grads, params, 500)
    dist.barrier()
    mesh = make_mesh({"ep": MP_RANKS}, device=CARD)
    counts = tfm.block_collective_counts(cfg, mesh)
    loss_fn, _ = tfm.make_loss_fn(cfg, mesh)
    shards = {k: v.requires_grad_() for k, v in
              tfm.shard_params(params, cfg, mesh).items()}
    _sep_reset(fa, fb, tpl)
    loss = loss_fn(shards, tokens)
    fwd = tpl.counts()
    grads = dict(zip(shards, torch.autograd.grad(loss,
                                                 list(shards.values()))))
    _sync(torch)
    res = dict(loss=loss.item(), forward=fwd, counts=counts,
               launches=_sep_launches(fa, fb),
               experts=tuple(shards["ffn_up_weight"].shape),
               gate_digest=_param_digest(
                   {"moe_gate_weight": grads["moe_gate_weight"]}))
    grads = tfm.unshard(grads, cfg, mesh)
    if ref is not None:
        res["held"] = _sep_held(torch, grads, ref)
        res["ref_loss"] = ref[0]
    del ref, grads, shards, loss
    _free(torch)
    return res


def _sep_stacked(layers, n_stages):
    """Stacked layer params (L, ...) as (n_stages, L / n_stages, ...)."""
    return {k: v.reshape(n_stages, v.shape[0] // n_stages, *v.shape[1:])
            for k, v in layers.items()}


def _sep_pp_leg(torch, np, fa, fb, rank):
    """(c): FULL's blocks as a GPipe pipeline over {"pp": 2}."""
    import torch.distributed as dist

    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel import make_mesh, pipeline
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl
    from mxnet_tpu_torch.parallel.mesh import all_reduce_flat_

    cfg = tfm.TransformerConfig(**dict(FULL, dtype="float32"))
    layers = {k: v for k, v in tfm.init_params(cfg, seed=0).items()
              if k not in ("embed_weight", "pos_embed_weight",
                           "final_ln_gamma", "final_ln_beta")}
    x = torch.from_numpy(np.random.RandomState(6).randn(
        SEP_MICRO, SEP_MB, FULL["max_len"], FULL["d_model"]).astype(
            np.float32)).to(CARD)
    per_stage = FULL["n_layers"] // SEP_STAGES

    def stage_fn(p, a):
        for i in range(per_stage):
            a = tfm._block(a, {k: v[i] for k, v in p.items()},
                           torch.float32)
        return a

    ref = None
    if rank == 0:
        def loss_grads(ps):
            p = {k: v.to(CARD, copy=True).requires_grad_()
                 for k, v in ps.items()}
            h = x.reshape(SEP_MICRO * SEP_MB, *x.shape[2:])
            for i in range(FULL["n_layers"]):
                h = tfm._block(h, {k: v[i] for k, v in p.items()},
                               torch.float32)
            out = h.reshape(x.shape)
            loss = out.square().mean()
            return loss.item(), dict(zip(p, torch.autograd.grad(
                loss, list(p.values())))), out.detach()

        ref = _sep_ref(torch, np, loss_grads, layers, 600)
    dist.barrier()
    mesh = make_mesh({"pp": SEP_STAGES}, device=CARD)
    stacked = {k: v.to(CARD).requires_grad_() for k, v in
               _sep_stacked(layers, SEP_STAGES).items()}
    _sep_reset(fa, fb, tpl)
    out = pipeline(stage_fn, stacked, x, mesh)
    loss = out.square().mean()
    grads = dict(zip(stacked, torch.autograd.grad(loss,
                                                  list(stacked.values()))))
    _sync(torch)
    res = dict(loss=loss.item(), launches=_sep_launches(fa, fb),
               collectives=tpl.counts(), wire=tpl.wire_bytes())
    # each rank's share lies in its stage's rows: the sum is the gradient
    all_reduce_flat_(list(grads.values()), dist.group.WORLD)
    if ref is not None:
        whole = {k: g.reshape(layers[k].shape) for k, g in grads.items()}
        res["held"] = _sep_held(torch, whole, ref, out=out.detach())
        res["ref_loss"] = ref[0]
    del ref, grads, out, loss
    _free(torch)
    return res


def _sep_ulysses_leg(torch, np, fa, fb, rank):
    """(d): the standalone Ulysses attention through the flash kernels."""
    import torch.distributed as dist

    from mxnet_tpu_torch.parallel import (full_attention, make_mesh,
                                          ulysses_attention)
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl
    from mxnet_tpu_torch.parallel.mesh import all_reduce_flat_

    gen = torch.Generator(device="cpu").manual_seed(7)
    q, k, v, g = (torch.randn(SEP_ULYSSES, generator=gen).to(
        CARD, torch.bfloat16) for _ in range(4))
    mesh = make_mesh({"sp": MP_RANKS}, device=CARD)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    _sep_reset(fa, fb, tpl)
    out = ulysses_attention(*qkv, mesh, causal=True,
                            attn_fn=fa.flash_attention)
    chunk = SEP_ULYSSES[2] // MP_RANKS
    grads = torch.autograd.grad(
        (out.float() * g.narrow(2, rank * chunk, chunk).float()).sum(), qkv)
    _sync(torch)
    res = dict(launches=_sep_launches(fa, fb), collectives=tpl.counts(),
               finite=bool(all(torch.isfinite(t).all() for t in
                               (out, *grads))))
    # the shares summed: each lies in the rank's own chunk, so the sum is
    # exact; B5-B7 run each (b, h) alone, so one device's flash call on
    # the whole tensors gives the same bits
    grads = list(grads)
    all_reduce_flat_(grads, dist.group.WORLD)
    one_in = [t.clone().requires_grad_() for t in (q, k, v)]
    one = fa.flash_attention(*one_in, causal=True)
    one_grads = torch.autograd.grad((one.float() * g.float()).sum(), one_in)
    res["same_bits"] = [bool(torch.equal(out, one.narrow(2, rank * chunk,
                                                         chunk)))] + [
        bool(torch.equal(a, b)) for a, b in zip(grads, one_grads)]
    # and both against the plain fp32 attention of the same bf16 inputs
    ref_in = [t.float().requires_grad_() for t in (q, k, v)]
    ref = full_attention(*ref_in, causal=True)
    ref_grads = torch.autograd.grad((ref * g.float()).sum(), ref_in)
    res["out_err"] = _row_err(torch, out, ref.narrow(2, rank * chunk, chunk))
    res["grad_errs"] = [_row_err(torch, a, b, 0.01)
                        for a, b in zip(grads, ref_grads)]
    res["one_grad_errs"] = [_row_err(torch, a, b, 0.01)
                            for a, b in zip(one_grads, ref_grads)]
    del out, grads, ref, ref_grads, ref_in, qkv, one, one_grads, one_in
    _free(torch)
    return res


def _mp_sep_work(torch, np, fa, rank):
    """One rank of seq_expert_pipe_phase: the four legs in turn, each with
    its one-device reference run by rank 0 first while rank 1 waits."""
    from mxnet_tpu_torch.kernels import fused_block as fb

    res = {"rank": rank}
    for leg in ("sp", "ep", "pp", "ulysses"):
        t0 = time.perf_counter()
        res[leg] = globals()["_sep_%s_leg" % leg](torch, np, fa, fb, rank)
        res[leg]["secs"] = time.perf_counter() - t0
    return res


def _sep_check(label, held, loss=None, ref_loss=None):
    """Raise unless a leg's gradients (and loss) are held."""
    gap = None if loss is None else abs(loss - ref_loss) / abs(ref_loss)
    if not held["ok"] or (gap is not None and gap > MP_LOSS_TOL):
        raise RuntimeError("seq_expert_pipe %s: loss gap %s, whole %g "
                           "against %g, worst %s"
                           % (label, gap, held["whole"], held["whole_yard"],
                              held["worst"]))
    return gap


def _sep_print_held(label, run, gap):
    h = run["held"]
    print("seq_expert_pipe %s: fp32 (TF32 off) loss %.7f vs one device %.7f "
          "(relative gap %.3g, tol %g); relative L2 whole %.4g against %.4g "
          "under %d one-rounding moves (limit x%g); worst over max(%g, %g x "
          "one-rounding gap) %s"
          % (label, run["loss"], run["ref_loss"], gap, MP_LOSS_TOL,
             h["whole"], h["whole_yard"], MP_NUDGES, MP_RATIO, MP_GRAD_TOL,
             MP_RATIO, ", ".join("%.3g at %s" % (r, k)
                                 for r, k in h["worst"])))


def seq_expert_pipe_phase(torch, np, fa, fb):
    """Sequence, expert and pipeline parallelism on MP_RANKS gloo ranks
    sharing the card (the comment above SEP_TRAIN_STEPS): each leg's loss,
    gradients (and the pipeline's outputs) against one device, its exact
    collective and kernel counts, the ring's bf16 train steps. Returns the
    B5, B6, B7, B1, B2, B3 launches of each leg on each rank."""
    _free(torch)
    ranks, wall = _run_ranks(_mp_gloo_rank, MP_RANKS, SEP_TIMEOUT,
                             "seq_expert_pipe", "sep")
    r0 = ranks[0]
    n_layers = FULL["n_layers"]
    print("seq_expert_pipe: %d gloo ranks sharing one card, %.1f s with "
          "start-up; legs on rank 0: %s"
          % (MP_RANKS, wall, ", ".join("%s %.1f s" % (k, r0[k]["secs"])
                                       for k in ("sp", "ep", "pp",
                                                 "ulysses"))))
    for mode in ("ring", "ulysses"):
        run = r0["sp"][mode]
        gap = _sep_check("sp " + mode, run["held"], run["loss"],
                         run["ref_loss"])
        _sep_print_held("(a) sp=%d attn=%s, FULL at %s" % (
            MP_RANKS, mode, MP_BATCH), run, gap)
    for r in ranks:
        for mode, (name, want) in (("ring", ("ppermute",
                                             2 * MP_RANKS * n_layers)),
                                   ("ulysses", ("all_to_all",
                                                4 * n_layers))):
            run = r["sp"][mode]
            print("seq_expert_pipe (a) rank %d %s: forward collectives %s; "
                  "bytes sent (forward and backward) %s; launches B5-B7, "
                  "B1-B3 %s" % (r["rank"], mode, run["forward"], run["wire"],
                                run["launches"]))
            if run["forward"][name] != want or any(run["launches"]):
                raise RuntimeError("seq_expert_pipe (a) rank %d %s: %s %d "
                                   "(want %d), launches %s"
                                   % (r["rank"], mode, name,
                                      run["forward"][name], want,
                                      run["launches"]))
        tr = r["sp"]["train"]
        print("seq_expert_pipe (a) rank %d ring bf16 train, sgd momentum: "
              "losses %s; step times %s s; %.1f tokens/s (the pair's "
              "global batch); peak memory %.2f GiB; launches %s; "
              "collective calls %s"
              % (r["rank"], " ".join("%.5f" % x for x in tr["losses"]),
                 " ".join("%.4f" % x for x in tr["secs"]), tr["tokens_s"],
                 tr["peak_gib"], tr["launches"], tr["collectives"]))
        if not all(np.isfinite(tr["losses"])) or \
                not tr["losses"][-1] < tr["losses"][0] or any(tr["launches"]):
            raise RuntimeError("seq_expert_pipe (a) train rank %d: %s"
                               % (r["rank"], tr))
    ep = r0["ep"]
    gap = _sep_check("ep", ep["held"], ep["loss"], ep["ref_loss"])
    _sep_print_held("(b) ep=%d MOE_MP (%d layers x %d experts, %s a rank) "
                    "at %s" % (MP_RANKS, MOE_MP["n_layers"],
                               MOE_MP["n_experts"], ep["experts"][1],
                               MOE_MP_BATCH), ep, gap)
    n_moe = MOE_MP["n_layers"]
    for r in ranks:
        e, c = r["ep"], r["ep"]["counts"]
        psums = e["forward"]["reduce_from_mp"] + \
            e["forward"]["reduce_from_data"]
        print("seq_expert_pipe (b) rank %d: forward collectives %s against "
              "block_collective_counts %s; launches B5-B7, B1-B3 %s"
              % (r["rank"], e["forward"], c, e["launches"]))
        if psums != c["psum_per_block"] * n_moe + c["psum_outside"] or \
                c["psum_per_block"] != 1 or \
                e["forward"]["gather_from_mp"] != c["all_gather"] or \
                e["launches"] != [n_moe] * 3 + [0] * 3 or \
                e["experts"][1] != MOE_MP["n_experts"] // MP_RANKS:
            raise RuntimeError("seq_expert_pipe (b) rank %d: %s" % (
                r["rank"], e))
    if len({r["ep"]["gate_digest"] for r in ranks}) != 1:
        raise RuntimeError("seq_expert_pipe (b): the gate's gradient "
                           "differs on the ranks")
    print("seq_expert_pipe (b): the gate's gradient bit for bit on the "
          "ranks True")
    pp = r0["pp"]
    gap = _sep_check("pp", pp["held"])
    print("seq_expert_pipe (c) pp=%d: FULL's %d blocks as %d stages of %d, "
          "%d microbatches of (%d, %d, %d) fp32: outputs and gradients vs "
          "the serial stack, relative L2 whole %.4g against %.4g (limit "
          "x%g); worst %s"
          % (SEP_STAGES, n_layers, SEP_STAGES, n_layers // SEP_STAGES,
             SEP_MICRO, SEP_MB, FULL["max_len"], FULL["d_model"],
             pp["held"]["whole"], pp["held"]["whole_yard"], MP_RATIO,
             ", ".join("%.3g at %s" % (r, k)
                       for r, k in pp["held"]["worst"])))
    ticks = SEP_MICRO + SEP_STAGES - 1
    want_pp = [n_layers // SEP_STAGES * ticks] * 3 + [0] * 3
    for r in ranks:
        p = r["pp"]
        print("seq_expert_pipe (c) rank %d: launches B5-B7, B1-B3 %s (want "
              "%s: every stage computes at each of %d ticks, and each "
              "tick's output reaches the loss); collectives %s; bytes %s"
              % (r["rank"], p["launches"], want_pp, ticks, p["collectives"],
                 p["wire"]))
        if p["launches"] != want_pp or p["collectives"]["ppermute"] != ticks:
            raise RuntimeError("seq_expert_pipe (c) rank %d: %s"
                               % (r["rank"], p))
    for r in ranks:
        u = r["ulysses"]
        print("seq_expert_pipe (d) rank %d ulysses_attention(attn_fn="
              "flash_attention) at %s bf16 causal: output and dq, dk, dv "
              "(shares summed) bit for bit one device's flash_attention %s; "
              "output vs fp32 full_attention row-relative %.3g (tol %g); "
              "gradients row-relative %s (one device's flash %s); launches "
              "B5-B7, B1-B3 %s; collectives %s"
              % (r["rank"], SEP_ULYSSES, u["same_bits"], u["out_err"],
                 KERNEL_TOL["bfloat16"][0],
                 " ".join("%.3g" % e for e in u["grad_errs"]),
                 " ".join("%.3g" % e for e in u["one_grad_errs"]),
                 u["launches"], u["collectives"]))
        if u["out_err"] > KERNEL_TOL["bfloat16"][0] or not u["finite"] or \
                not all(u["same_bits"]) or \
                u["launches"] != [1, 1, 1, 0, 0, 0]:
            raise RuntimeError("seq_expert_pipe (d) rank %d: %s"
                               % (r["rank"], u))
    return {leg: [r[leg]["launches"] if leg != "sp" else
                  r[leg]["ring"]["launches"] for r in ranks]
            for leg in ("sp", "ep", "pp", "ulysses")}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_block as fb

    t_start = time.perf_counter()
    # the phases before tune_phase run the hand tiles: an empty table of
    # this run's own, not whatever the user's default table holds
    import tempfile

    os.environ["MXNET_TPU_TUNE_TABLE"] = os.path.join(
        tempfile.mkdtemp(prefix="chip_smoke_"), "schedule_table.json")
    card = _card_line()
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    logs = _build.build_all()
    print("build: %d kernel source(s) in %.1f s" % (len(logs),
                                                    time.perf_counter() - t0))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "cached" in line \
                    or "Compiling entry" in line:
                print("  %s: %s" % (name, line.strip()))

    phase_s = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        print("phase %s: %.1f s" % (name, phase_s[name]))
        return out

    if "--grad-repeat" in sys.argv[1:]:
        grad_repeat(torch, np, fa, fb,
                    int(sys.argv[sys.argv.index("--grad-repeat") + 1]))
        print(card)
        return 0
    phase("sass", sass_phase, _build)
    fwd = phase("kernel", kernel_phase, torch, fa)
    served = phase("serving", serving_phase, torch, np, fa)
    fwd["prefix_launches"] = phase("prefix_serving", prefix_serving_phase,
                                   torch, np, fa)
    fwd["spec_launches"] = phase("spec_serving", spec_serving_phase, torch,
                                 np, fa)
    conv = phase("conv_kernel", conv_kernel_phase, torch, fb)
    conv["launches"] = phase("resnet_serving", resnet_serving_phase, torch,
                             np, fb)
    bwd = phase("backward", backward_phase, torch, fa)
    phase("grad", grad_phase, torch, np)
    launches = phase("training", training_phase, torch, np, fa)
    for entry, n in zip([fwd, *bwd], launches):
        entry["launches"] = n
    grads = phase("conv_grad_kernel", conv_grad_kernel_phase, torch, fb)
    phase("resnet_train_grad", resnet_train_grad_phase, torch, np, fb)
    resnet_launches = phase("resnet_training", resnet_training_phase, torch,
                            np, fb)
    for entry, n in zip(grads, resnet_launches[1:]):
        entry["launches"] = n
    conv["train_launches"] = resnet_launches[0]
    options_launches = phase("trainstep_options", trainstep_options_phase,
                             torch, np, fb)
    for entry, n in zip([conv, *grads], options_launches):
        entry["trainstep_options_launches"] = n
    fit_launches = phase("module_fit", module_fit_phase, torch, np, fb)
    for entry, n in zip([conv, *grads], fit_launches):
        entry["module_fit_launches"] = n
    dp_nccl, dp_gloo = phase("dp_training", dp_training_phase, torch, np, fb)
    for i, entry in enumerate([conv, *grads]):
        entry["dp_launches"] = dp_nccl[i]
        entry["dp_gloo_launches"] = [r[i] for r in dp_gloo]
    mp_train = phase("mp_training", mp_training_phase, torch, np, fa)
    for i, entry in enumerate([fwd, *bwd]):
        entry["mp_train_launches"] = [r[i] for r in mp_train]
    fwd["mp_serve_launches"] = phase("mp_serving", mp_serving_phase, torch,
                                     np, fa)
    zoo = phase("model_zoo_fit", model_zoo_fit_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], zoo):
        entry["model_zoo_launches"] = n
    trained, _lm_row, lm_fit = phase("lm_fit", lm_fit_phase, torch, np, fa,
                                     fb)
    _lm_served, lm_serve = phase("lm_serving", lm_serving_phase, torch, np,
                                 fa, fb, trained)
    lm_sweep = phase("tensor_sweep", tensor_sweep_phase, torch, np, fa, fb)
    lm = tuple(a + b + s for a, b, s in zip(lm_fit, lm_serve, lm_sweep))
    for entry, n in zip([fwd, *bwd, conv, *grads], lm):
        entry["lm_launches"] = n
    trained, _ssd_row, ssd_fit = phase("ssd_fit", ssd_fit_phase, torch, np,
                                       fa, fb)
    _ssd_served, ssd_detect = phase("ssd_detect", ssd_detect_phase, torch,
                                    np, fa, fb, trained)
    del trained
    ssd_sweep = phase("contrib_sweep", contrib_sweep_phase, torch, np, fa,
                      fb)
    ssd_path = tuple(a + b + s for a, b, s in zip(ssd_fit, ssd_detect,
                                                  ssd_sweep))
    for entry, n in zip([fwd, *bwd, conv, *grads], ssd_path):
        entry["ssd_launches"] = n
    quant = phase("quant_serving", quant_serving_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], quant):
        entry["quant_launches"] = n
    phase("tune", tune_phase, torch, np, fa, fb)
    data_plane = phase("data_plane", data_plane_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], data_plane):
        entry["data_plane_launches"] = n
    sparse = phase("sparse", sparse_phase, torch, np, fa, fb)
    embed = phase("embed", embed_phase, torch, np, fa, fb)
    for entry, n, m in zip([fwd, *bwd, conv, *grads], sparse, embed):
        entry["sparse_launches"] = n
        entry["embed_launches"] = m
    moe_train = phase("moe_training", moe_training_phase, torch, np, fa)
    moe_serve = phase("moe_serving", moe_serving_phase, torch, np, fa)
    moe_mp = phase("moe_mp", moe_mp_phase, torch, np, fa)
    for i, entry in enumerate([fwd, *bwd]):
        entry["moe_train_launches"] = moe_train[i]
        entry["moe_mp_launches"] = [r[i] for r in moe_mp]
    fwd["moe_serve_launches"] = moe_serve
    gluon_launches = phase("gluon", gluon_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], gluon_launches):
        entry["gluon_launches"] = n
    rnn_launches = phase("rnn", rnn_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], rnn_launches):
        entry["rnn_launches"] = n
    fleet_launches = phase("fleet", fleet_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], fleet_launches):
        entry["fleet_launches"] = n
    tail_launches = phase("tail", tail_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], tail_launches):
        entry["tail_launches"] = n
    mps = phase("mp_symbol", mp_symbol_phase, torch, np, fa, fb)
    conv["mp_symbol_launches"] = dict(train=[r[0] for r in mps["train"]],
                                      serve=mps["serve"], group=mps["group"])
    for i, entry in enumerate(grads, 1):
        entry["mp_symbol_launches"] = dict(train=[r[i] for r in
                                                  mps["train"]])
    fwd["mp_symbol_launches"] = dict(spec=mps["spec"])
    sep = phase("seq_expert_pipe", seq_expert_pipe_phase, torch, np, fa, fb)
    for i, entry in enumerate([fwd, *bwd, conv, *grads]):
        entry["seq_expert_pipe_launches"] = {
            leg: [r[i] for r in runs] for leg, runs in sep.items()}
    print("launches on the main paths: training %d steps B5 %d, B6 %d, B7 "
          "%d; generative serving B5 %d; shared-prefix serving (cache on) "
          "B5 %d; speculative serving (k=%d) B5 %d; image serving B1 %d; "
          "ResNet-50 "
          "training %d steps B1 %d, B2 %d, B3 %d; TrainStep options %d "
          "steps B1 %d, B2 %d, B3 %d; Module.fit %d batches B1 %d, B2 %d, "
          "B3 %d; data parallel, one rank over NCCL, %d steps B1 %d, B2 %d, "
          "B3 %d, each of %d gloo ranks %s; mp=2 training %d steps B5, "
          "B6, B7 on each rank %s; mp=2 serving B5 (leader's burst, "
          "follower's run) %s; model zoo B5-B7 and B1-B3 %s; "
          "LM path (fit, serving, op sweep) B5-B7 and B1-B3 %s; SSD path "
          "(fit, detection, contrib sweep) B5-B7 and B1-B3 %s; int8 "
          "serving path B5-B7 and B1-B3 %s; data plane (unfused fit, "
          "fused leg) B5-B7 and B1-B3 %s; sparse paths B5-B7 and B1-B3 %s; "
          "server tier and embed B5-B7 and B1-B3 %s; MoE training %d "
          "steps B5 %d, B6 %d, B7 %d; MoE serving B5 %d; MoE mp=2 loss and "
          "gradient B5, B6, B7 on each rank %s; Gluon ResNet-50 and zoo "
          "B5-B7 and B1-B3 %s; recurrent paths (bucketed LM, Gluon LSTM "
          "LM, ConvLSTM) B5-B7 and B1-B3 %s; serving fleet (replicas that "
          "stopped gracefully) B5-B7 and B1-B3 %s; Custom-headed Module.fit "
          "(%d batches) B5-B7 and B1-B3 %s; mp symbol path: Module.fit %d "
          "batches B1, B2, B3 on each rank %s, sharded predictor B1 (leader's "
          "forward, follower's run) %s, sharded speculation B5 (leader, "
          "follower) %s, group leader B1 %d; sequence, expert and pipeline "
          "legs B5-B7 and B1-B3 on each rank %s"
          % (TRAIN_STEPS, *launches, served, fwd["prefix_launches"],
             SPEC_TRACE["k"], fwd["spec_launches"], conv["launches"],
             RESNET_TRAIN_STEPS, *resnet_launches,
             OPTIONS_STEPS * (len(REMAT_MODES) + 1), *options_launches,
             FIT_EPOCHS * FIT_COPIES, *fit_launches, DP_STEPS, *dp_nccl,
             DP_RANKS, " / ".join("%d, %d, %d" % r for r in dp_gloo),
             MP_STEPS, " / ".join("%d, %d, %d" % tuple(r) for r in mp_train),
             fwd["mp_serve_launches"], ", ".join("%d" % n for n in zoo),
             ", ".join("%d" % n for n in lm),
             ", ".join("%d" % n for n in ssd_path),
             ", ".join("%d" % n for n in quant),
             ", ".join("%d" % n for n in data_plane),
             ", ".join("%d" % n for n in sparse),
             ", ".join("%d" % n for n in embed), MOE_STEPS, *moe_train,
             moe_serve, " / ".join("%d, %d, %d" % tuple(r) for r in moe_mp),
             ", ".join("%d" % n for n in gluon_launches),
             ", ".join("%d" % n for n in rnn_launches),
             ", ".join("%d" % n for n in fleet_launches), TAIL_BATCHES,
             ", ".join("%d" % n for n in tail_launches), MPS_BATCHES,
             " / ".join("%d, %d, %d" % tuple(r) for r in mps["train"]),
             mps["serve"], mps["spec"], mps["group"],
             "; ".join("%s %s" % (leg, " / ".join(
                 ", ".join("%d" % n for n in r) for r in runs))
                 for leg, runs in sep.items())))
    print("phases: %s; total %.1f s" % (
        ", ".join("%s %.1f s" % kv for kv in phase_s.items()),
        time.perf_counter() - t_start))
    print(json.dumps({"kernels": [fwd, *bwd, conv, *grads]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
