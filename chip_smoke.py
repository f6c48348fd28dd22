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
   instructions and spills nothing;
3. holds the flash-attention forward (B5) against its plain PyTorch
   version on the card, at the shapes the serving and training paths give
   it and a few more (causal and not, a ``kv_len`` mask, D = 128, float32
   and bfloat16), and times the kernel, the plain version and one library
   call (SDPA, a yardstick only: the port never calls it) at the training
   shape and the prefill buckets 256, 1024 and 2048;
4. drives the serving path at full width — the 12-layer, d_model 512
   transformer (random weights from seed 0) behind
   ``GenerateServer(slots=8, page_size=16)`` — with 16 concurrent requests
   of 8..1500 prompt tokens and 32 new tokens each, checks every request,
   the page accounting and that every prefill went through B5 (12
   launches per prefill), and holds the served logits of two requests
   against the one-shot forward on the card;
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
   plain backward in the same way, with the SDPA backward as the
   yardstick;
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
16. runs ``Module.fit`` on the image-classification builders at
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
17. prints one JSON line describing each kernel, then the result line
   ``{"ok": true, "device": {...}}`` last.

Every time of a kernel, of its plain version and of its library call is
taken on two timers (``_time_ms``): CUDA events around each call, which
also hold the wrapper's host time whenever the card waits for it, and the
same events behind a spin kernel queued first, which hide it (device
time only).

Any failed phase exits non-zero before the result line. Without a CUDA
device, or without the package beside it, it exits non-zero at once.
"""
import gc
import json
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


def _res_usage(tool, lib):
    """{mangled kernel name: (registers, local-memory bytes)} from
    ``cuobjdump -res-usage``; spilled registers live in local memory, so a
    kernel with 0 bytes of it spills nothing."""
    out = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
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


def sass_phase(build):
    """Counts the wgmma (HGMMA) and TMA load (UTMALDG) instructions in the
    SASS of the bf16 tensor-core kernels (``cuobjdump -sass``) and prints
    their registers and stack/local bytes (``cuobjdump -res-usage``, which
    reads the built library, so a cached build is checked too); fails if
    either count is 0 or an instantiation uses local memory (spills)."""
    tool = _cuobjdump(build._nvcc())
    for lib, kernel in TC_KERNELS:
        sass = subprocess.run([tool, "-sass", str(build.lib_path(lib))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts, name = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1) if kernel in m.group(1) else None
                if name:
                    counts[name] = [0, 0]
            elif name:
                counts[name][0] += "HGMMA" in line
                counts[name][1] += "UTMALDG" in line
        if not counts:
            raise RuntimeError("sass: no %s in %s" % (kernel, lib))
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
            if local:
                raise RuntimeError("sass: %s spills (%d bytes of stack and "
                                   "local memory)" % (name, local))


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
    b, h, s, d = TRAIN_ATTN
    cases.append(("bfloat16", b, h, s, s, d, True, s))
    main_err = 0.0
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
    b, h, s, d = TRAIN_ATTN
    q, k, v = inputs(b, h, s, s, d, torch.bfloat16)
    ms = _time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = _time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, causal=True), reps=10)
    lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by = _attention_bound("flash_attention_fwd", b, h, s, s,
                                          d, True, s, "bfloat16")
    flops = _attention_flops("flash_attention_fwd", b, h, s, s, d, True, s)
    print("time flash_attention_fwd bf16 (%d,%d,%d,%d) causal (event / "
          "device): kernel %s ms (%.1f TFLOP/s device, %.2fx bound, %.2fx / "
          "%.2fx SDPA), plain %s ms, SDPA %s ms, bound %.6f ms (%s)"
          % (b, h, s, d, _both(ms), flops / ms[1] / 1e9, ms[1] / bound_ms,
             ms[0] / lib_ms[0], ms[1] / lib_ms[1], _both(plain_ms),
             _both(lib_ms), bound_ms, bound_by))
    return dict({"name": "flash_attention_fwd", "route": "cuda",
                 "source": "mxnet_tpu_torch/kernels/csrc/flash_attention_fwd"
                           ".cu",
                 "replaces": "mxnet_tpu/kernels/flash_attention.py:65",
                 "design": TC_DESIGN, "max_abs_err": main_err,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "shape": list(TRAIN_ATTN), "library": "SDPA forward"},
                **_timed(ms, plain_ms, lib_ms))


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
    b, h, s, d = TRAIN_ATTN
    cases.append(("bfloat16", b, h, s, s, d, True, s))
    main_err = {"dq": 0.0, "dkv": 0.0}
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
        if case == cases[-1]:
            main_err = {"dq": errs["dq"], "dkv": max(errs["dk"], errs["dv"])}

    # times at the training shape; the plain backward and the SDPA
    # backward compute dq, dk and dv together, so B6 and B7 share them
    b, h, s, d = TRAIN_ATTN
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
    entries = []
    for name, ms, line, err in (
            ("flash_attention_bwd_dq", dq_ms, 103, main_err["dq"]),
            ("flash_attention_bwd_dkv", dkv_ms, 131, main_err["dkv"])):
        bound_ms, bound_by = _attention_bound(name, b, h, s, s, d, True, s,
                                              "bfloat16")
        flops = _attention_flops(name, b, h, s, s, d, True, s)
        print("time %s bf16 (%d,%d,%d,%d) causal (event / device): kernel "
              "%s ms (%.1f TFLOP/s device, %.2fx bound, %.2fx / %.2fx SDPA "
              "backward), plain backward %s ms, SDPA backward %s ms (both "
              "shared by B6 and B7), bound %.6f ms (%s)"
              % (name, b, h, s, d, _both(ms), flops / ms[1] / 1e9,
                 ms[1] / bound_ms, ms[0] / lib_ms[0], ms[1] / lib_ms[1],
                 _both(plain_ms), _both(lib_ms), bound_ms, bound_by))
        entries.append(dict({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "mxnet_tpu/kernels/flash_attention.py:%d" % line,
            "design": TC_DESIGN, "max_abs_err": err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": list(TRAIN_ATTN),
            "plain": "flash_attention_bwd_reference: dq, dk and dv "
                     "together, shared by B6 and B7",
            "library": "SDPA backward: dq, dk and dv together, shared by B6 "
                       "and B7"}, **_timed(ms, plain_ms, lib_ms)))
    return entries


def _counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


def _reset_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkv.launches = 0


def grad_phase(torch, np):
    """Loss and every parameter gradient of a 2-layer fp32 model, on the
    card (B5, B6, B7) against the CPU (the plain versions), from the same
    params and tokens. TF32 is off (set in kernel_phase): fp32 products
    in full precision on both sides."""
    from mxnet_tpu_torch.models import transformer as tfm

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("grad: TF32 must be off for an fp32 reference")
    cfg = tfm.TransformerConfig(**GRAD_CFG)
    params = tfm.init_params(cfg, seed=0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, GRAD_BATCH)
    got = {}
    for dev in ("cuda", "cpu"):
        loss_fn, _ = tfm.make_loss_fn(cfg, device=dev)
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        loss = loss_fn(p, tokens)
        grads = torch.autograd.grad(loss, list(p.values()))
        got[dev] = (loss.item(), {k: g.cpu() for k, g in zip(p, grads)})
    worst = 0.0
    for k, g_cpu in got["cpu"][1].items():
        g_card = got["cuda"][1][k]
        rel = ((g_card - g_cpu).abs().max() /
               g_cpu.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        print("grad %-18s max|card - cpu| / max|cpu| = %.3g" % (k, rel))
    print("grad: loss card %.7f cpu %.7f; worst gradient %.3g (tol %g), "
          "2 layers, fp32, tokens %s" % (got["cuda"][0], got["cpu"][0], worst,
                                         GRAD_TOL, GRAD_BATCH))
    if worst > GRAD_TOL or abs(got["cuda"][0] - got["cpu"][0]) > \
            GRAD_TOL * abs(got["cpu"][0]):
        raise RuntimeError("card gradients differ from the CPU's")


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


def serving_phase(torch, np, fa):
    """The serving path at full width; returns the flash launch count."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.serving import GenerateServer

    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in rng.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                    N_REQUESTS)]
    if len({p.tobytes() for p in prompts}) != N_REQUESTS:
        raise RuntimeError("seeded prompts are not distinct")
    watched = {prompts[0].tobytes(): {}, prompts[1].tobytes(): {}}

    srv = GenerateServer(cfg, params, slots=8, page_size=16)
    try:
        pred = srv.predictor
        # warm-up, one short request per prefill bucket the prompts use, so
        # the timed run pays no first-call costs (lazy CUDA module loading,
        # cuBLAS heuristics); counters are reset after it
        for b in sorted({pred.pick_bucket(len(p)) for p in prompts}):
            srv.generate(rng.randint(0, cfg.vocab, (min(b, pred.max_ctx - 1),)),
                         max_new_tokens=2)
        prefill, decode = pred.prefill, pred.decode
        call_s = {"prefill": [], "decode": []}

        # time every call and record the served logits of the watched
        # requests by position
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
                r = srv._slot_req[s]
                key = r.tokens.tobytes()
                if key in watched:
                    watched[key][int(positions[s])] = logits[s].copy()
            return logits

        pred.prefill, pred.decode = rec_prefill, rec_decode
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
        pred.prefill, pred.decode = prefill, decode
        # where the device time goes: the first 8 prompts again, 8 new
        # tokens each, under torch.profiler (after the counts were read)
        _device_profile(torch, lambda: [
            f.result(timeout=600) for f in
            [srv.submit(p, max_new_tokens=8) for p in prompts[:8]]])
    finally:
        srv.close()

    for i, r in enumerate(results):
        if len(r["tokens"]) != NEW_TOKENS or r["finish_reason"] != "length":
            raise RuntimeError("request %d: %d tokens, reason %r"
                               % (i, len(r["tokens"]), r["finish_reason"]))
    if stats["pages_in_use"] != 0 or pool["in_use"] != 0:
        raise RuntimeError("KV pages leaked: %r" % pool)
    if stats["prefills"] != N_REQUESTS or \
            launches != cfg.n_layers * stats["prefills"]:
        raise RuntimeError("flash launches %d != %d layers x %d prefills"
                           % (launches, cfg.n_layers, stats["prefills"]))
    n_tok = sum(len(r["tokens"]) for r in results)
    print("serve: %d requests, prompts %d..%d tokens, %d new tokens each; "
          "%d generated in %.3f s wall = %.1f tokens/s; busy tokens/s %s; "
          "TTFT p50 %.1f ms p99 %.1f ms; decode steps %d, slot occupancy "
          "%s; pages high water %d of %d; flash launches %d (%d layers x %d "
          "prefills)" % (N_REQUESTS, min(map(len, prompts)),
                         max(map(len, prompts)), NEW_TOKENS, n_tok, wall,
                         n_tok / wall, stats.get("tokens_s"),
                         stats["ttft_p50_ms"], stats["ttft_p99_ms"],
                         stats["decode_steps"], stats.get("slot_occupancy"),
                         pool["high_water"], pool["num_pages"], launches,
                         cfg.n_layers, stats["prefills"]))
    for kind, secs in call_s.items():
        secs = sorted(secs)
        print("serve %s calls: %d, total %.3f s, median %.2f ms, max %.2f ms "
              "(host clock, each call ends in a device sync)"
              % (kind, len(secs), sum(secs), secs[len(secs) // 2] * 1e3,
                 secs[-1] * 1e3))

    # served logits against the one-shot forward on the card
    fwd = tfm.make_forward_fn(cfg)
    worst = 0.0
    for i in (0, 1):
        p, gen = prompts[i], results[i]["tokens"]
        served = watched[p.tobytes()]
        want = range(len(p) - 1, len(p) + NEW_TOKENS - 1)
        if sorted(served) != list(want):
            raise RuntimeError("request %d: served logits recorded at %d "
                               "positions, want %d" % (i, len(served),
                                                       len(want)))
        chain = np.concatenate([p, np.asarray(gen[:-1], np.int32)])[None]
        ref = fwd(pred._params, chain)[0].cpu().numpy()
        got = np.stack([served[j] for j in want])
        if not np.isfinite(got).all() or got.shape != (NEW_TOKENS, cfg.vocab):
            raise RuntimeError("served logits not finite / wrong shape")
        err = float(np.abs(got - ref[list(want)]).max())
        agree = float(np.mean(got.argmax(-1) == ref[list(want)].argmax(-1)))
        print("parity request %d (prompt %d): max|served - forward| = %.4g "
              "(tol %g), greedy agreement %.3f"
              % (i, len(p), err, LOGIT_TOL, agree))
        worst = max(worst, err)
    if worst > LOGIT_TOL:
        raise RuntimeError("served logits differ from the forward by %.4g"
                           % worst)
    return launches



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


def resnet_serving_phase(torch, np, fb):
    """Fused ResNet-50 behind ModelServer on the card; returns the B1
    launch count of the served traffic."""
    import threading

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

    rng = np.random.RandomState(0)
    sizes = [int(v) for v in rng.randint(1, RESNET_MAX_IMAGES + 1,
                                         RESNET_REQUESTS)]
    images = [_resnet_images(np, 100 + i, n) for i, n in enumerate(sizes)]
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
        futures = [None] * len(sizes)

        def client(k):
            for i in range(k, len(sizes), RESNET_THREADS):
                futures[i] = srv.submit("resnet50", images[i])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(RESNET_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=600)[0] for f in futures]
        wall = time.perf_counter() - t0
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

        _device_profile(torch, one_batch, top=10)
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
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as tmp_mp

    gc.collect()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nccl = _dp_one_rank_nccl(torch, np, fb)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="dp_ranks_")
    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        ctx = tmp_mp.start_processes(_dp_gloo_rank,
                                     args=(DP_RANKS, port, out_dir),
                                     nprocs=DP_RANKS, join=False,
                                     start_method="spawn")
        deadline = time.monotonic() + DP_TIMEOUT
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise RuntimeError("dp gloo: the ranks did not finish "
                                       "within %d s" % DP_TIMEOUT)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

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

    phase("sass", sass_phase, _build)
    fwd = phase("kernel", kernel_phase, torch, fa)
    served = phase("serving", serving_phase, torch, np, fa)
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
    zoo = phase("model_zoo_fit", model_zoo_fit_phase, torch, np, fa, fb)
    for entry, n in zip([fwd, *bwd, conv, *grads], zoo):
        entry["model_zoo_launches"] = n
    print("launches on the main paths: training %d steps B5 %d, B6 %d, B7 "
          "%d; generative serving B5 %d; image serving B1 %d; ResNet-50 "
          "training %d steps B1 %d, B2 %d, B3 %d; TrainStep options %d "
          "steps B1 %d, B2 %d, B3 %d; Module.fit %d batches B1 %d, B2 %d, "
          "B3 %d; data parallel, one rank over NCCL, %d steps B1 %d, B2 %d, "
          "B3 %d, each of %d gloo ranks %s; model zoo B5-B7 and B1-B3 %s"
          % (TRAIN_STEPS, *launches, served, conv["launches"],
             RESNET_TRAIN_STEPS, *resnet_launches,
             OPTIONS_STEPS * (len(REMAT_MODES) + 1), *options_launches,
             FIT_EPOCHS * FIT_COPIES, *fit_launches, DP_STEPS, *dp_nccl,
             DP_RANKS, " / ".join("%d, %d, %d" % r for r in dp_gloo),
             ", ".join("%d" % n for n in zoo)))
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
