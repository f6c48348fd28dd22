"""The ``MXNET_*`` knobs the port reads.

A copy of the entries of ``mxnet_tpu/config.py`` that this package uses,
with the same defaults and the same strict accessors: a malformed value
raises :class:`~.base.MXNetError` naming the knob, never a silently
substituted default.
"""
from __future__ import annotations

import os

from .base import MXNetError

# name -> (default, description)
KNOBS = {
    "MXNET_SERVE_QUEUE_DEPTH": (
        "256", "per-model bounded request queue; a full queue backpressures "
        "submit() (serving/broker.py)"),
    "MXNET_SERVE_SUBMIT_TIMEOUT": (
        "60", "seconds submit() may block on backpressure before raising "
        "(serving/broker.py)"),
    "MXNET_GENERATE_MAX_STEPS": (
        "256", "decode-step cap per generate request (also the default "
        "max_new_tokens); integer >= 1 (serving/broker.py)"),
    "MXNET_GENERATE_SLOTS": (
        "8", "batch-slot count of the continuous-batching decode step; "
        "integer >= 1 (serving/generate.py)"),
    "MXNET_GENERATE_PAGE_SIZE": (
        "16", "tokens per KV-cache page; integer >= 1 (serving/generate.py)"),
    "MXNET_GENERATE_POOL_BYTES": (
        "0", "KV page-pool budget in bytes; 0 auto-sizes to slots x "
        "max-context pages; integer >= 0 (serving/generate.py)"),
    "MXNET_GENERATE_STREAM_FLUSH": (
        "8", "decode steps between stream_fn token flushes; integer >= 1 "
        "(serving/broker.py)"),
    "MXNET_GENERATE_PREFIX_CACHE": (
        "0", "shared-prefix KV cache; not ported yet, so only 0/false is "
        "accepted by GenerateServer (serving/broker.py)"),
    "MXNET_GENERATE_PREFIX_EVICT": (
        "0", "max KV pages the prefix index may pin; integer >= 0 "
        "(serving/broker.py)"),
    "MXNET_GENERATE_SPEC_K": (
        "0", "speculative-decoding depth; not ported yet, so only 0 is "
        "accepted by GenerateServer (serving/broker.py)"),
    "MXNET_GENERATE_DRAFT": (
        "0", "self-draft layer count for speculative decoding; integer "
        ">= 0 (serving/broker.py)"),
    "MXNET_SERVE_BATCH_LADDER": (
        "1,4,16,64", "comma-separated batch-size buckets the AOT predictor "
        "binds; requests pad up to the nearest bucket (serving/predictor.py; "
        "malformed or non-increasing ladders raise)"),
    "MXNET_TPU_ZERO": (
        "0", "shard the weight update over the data axes (ZeRO): "
        "reduce-scatter the gradients, update a 1/N optimizer-state shard, "
        "all-gather the params (parallel/spmd.py, module/spmd_group.py)"),
    "MXNET_TPU_ZERO_WIRE": (
        "raw", "gradient-shard wire treatment of the ZeRO step; the two-bit "
        "wire is not ported, so TrainStep accepts only raw "
        "(parallel/spmd.py)"),
    "MXNET_TPU_ZERO_MIN_SIZE": (
        "1024", "parameters with fewer elements keep replicated optimizer "
        "state under ZeRO; integer >= 0 (parallel/spmd.py)"),
    "MXNET_TPU_MAX_INFLIGHT": (
        "2", "steps of the fused Module group queued on the card before the "
        "host waits for the oldest; integer >= 1 (module/spmd_group.py)"),
    "MXNET_TPU_DEVICE_METRICS": (
        "1", "keep Module.fit's metric sums on the card (TrainStep "
        "metric_stats), read at Speedometer/epoch boundaries; 0|1 "
        "(module/spmd_group.py, metric.py)"),
    "MXNET_MP_SIZE": (
        "1", "tensor-parallel mesh axis size; tensor parallelism is not "
        "ported, so only 1 is accepted (parallel/mesh.py)"),
    "MXNET_MP_RULES": (
        "", "parameter-sharding rules 'regex:spec;regex:spec'; sharding a "
        "parameter is not ported, so a rule that shards raises "
        "(parallel/spmd.py)"),
    "MXNET_TPU_SENTINEL": (
        "off", "anomaly sentinel of the train step: off|record|skip|halt "
        "(parallel/spmd.py)"),
    "MXNET_TPU_REMAT": (
        "0", "rematerialization mode of the train step: 0/off, 1 (full "
        "recompute), conv (keep conv/matmul outputs), pass (the ir/remat.py "
        "plan) (parallel/spmd.py)"),
    "MXNET_IR_TRAIN_PASSES": (
        "", "comma-separated pass pipeline rewriting the training graph "
        "before TrainStep reads it, e.g. layout (parallel/spmd.py)"),
    "MXNET_IR_LAYOUT": (
        "1", "kill switch of the layout pass: 0 runs it with no rules "
        "(ir/passes.py); 0|1, anything else raises"),
    "MXNET_TPU_GUARD": (
        "1", "arms the JAX package's HealthGuard in Module.fit when "
        "MXNET_CHECKPOINT_DIR is set; not ported, so fit raises when both "
        "are set (module/base_module.py)"),
    "MXNET_TUNE_BACKGROUND": (
        "0", "background kernel tuning in Module.fit; not ported, so fit "
        "accepts only 0 (module/base_module.py)"),
    "MXNET_IR_FUSE": (
        "1", "kill switch for rule-based fusion in the model builders: "
        "resnet(fused=True) applies the IR fusion pass when 1, returns the "
        "unfused graph when 0 (models/resnet.py); 0|1, anything else raises"),
}


def get(name):
    """Raw string value of a knob: the environment wins, then the default."""
    if name in os.environ:
        return os.environ[name]
    if name in KNOBS:
        return KNOBS[name][0]
    return None


def get_strict_bool(name):
    """0/1/true/false/yes/no/on/off; anything else raises MXNetError."""
    v = str(get(name)).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise MXNetError("%s=%r must be a boolean (0|1)" % (name, get(name)))


def get_choice(name, choices):
    """The knob lower-cased, which must be one of ``choices``."""
    v = str(get(name)).strip().lower()
    if v not in choices:
        raise MXNetError("%s=%r must be one of %s"
                         % (name, get(name), "|".join(choices)))
    return v


def get_nonneg_int(name):
    raw = get(name)
    try:
        v = int(str(raw).strip())
    except (TypeError, ValueError):
        v = -1
    if v < 0:
        raise MXNetError("%s=%r must be an integer >= 0" % (name, raw))
    return v


def get_positive_int(name):
    raw = get(name)
    try:
        v = int(str(raw).strip())
    except (TypeError, ValueError):
        v = 0
    if v < 1:
        raise MXNetError("%s=%r must be an integer >= 1" % (name, raw))
    return v
