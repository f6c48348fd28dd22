"""The profiler (counterpart of ``mxnet_tpu/profiler.py``): host trace
events in MXNet's Chrome ``trace.json`` format, and the serving, training
and pass counters.

- The trace API: ``set_config``/``profiler_set_config`` (``mode``
  ``symbolic`` or ``all``, ``filename``), ``set_state``/
  ``profiler_set_state`` (``run`` clears and starts collecting, ``stop``
  ends it), ``pause``/``resume``/``is_running``, ``record_event``,
  ``scope`` and ``maybe_scope``. The executor records its ``forward``,
  ``backward`` and ``forward_backward`` calls; in mode ``all`` every
  imperative op dispatch is an ``operator`` event. Events time the host
  (``time.perf_counter_ns``), as the JAX package's do: no scope
  synchronizes the card. ``MXNET_PROFILER_AUTOSTART=1`` starts it at
  import in ``MXNET_PROFILER_MODE`` and dumps at exit.
  ``MXNET_TPU_JAX_TRACE_DIR`` names JAX device traces and has no
  counterpart here.

- ``generate_record`` / ``generate_stats`` / ``generate_reset``:
  request/prefill/decode-step/token counts, finish reasons, requests shed
  at dequeue, slot occupancy (active-slot-steps / slot-steps), a
  time-to-first-token reservoir, the page-pool gauge
  (``pages_in_use == 0`` after a drained run is the exact-accounting
  check), the shared-prefix counters (``prefix_hits``, ``shared_pages``,
  ``prefill_tokens_saved``, ``prefix_evictions``; gauges
  ``page_ref_high_water`` and ``prefix_pages``) and the speculative ones
  (``draft_proposed``, ``draft_accepted``, ``spec_rounds``; derived
  ``acceptance_rate``).
- ``serving_record`` / ``serving_stats`` / ``serving_reset``: per-model
  counters of the dynamic-batching ``ModelServer`` (requests, batches,
  rows against bucket capacity, shed, errors, queue depth, request
  latency p50/p99).
- ``pass_record`` / ``pass_calibration`` / ``pass_stats`` /
  ``pass_reset``: per IR pass, rule hits, nodes rewritten, the remat
  plan's saved and recomputed node counts, the layout pass's cancelled
  transposes and the quantize pass's quantized ops; and a gauge per
  int8-calibrated tensor group (absmax and scale, the newest calibration
  wins).
- ``health_record`` / ``health_sentinel`` / ``health_stats`` /
  ``health_reset``: reaction-side event counters and the newest drained
  snapshot of ``TrainStep``'s sentinel counters.
- ``h2d_record`` / ``pipeline_stats`` / ``pipeline_reset``: the host
  syncs a training loop made (``host_syncs``), the batch arrays placed on
  a mesh (``puts``, ``nbytes``, ``put_seconds``, ``preplaced``), the fused
  Module group's steps, its waits for the card and steps in flight; the
  JAX package's background-feed counters have no writer in the port.
- ``memory_record`` / ``memory_stats`` / ``memory_reset``: the gauge of
  ``TrainStep.memory_stats`` (bytes of the carry on this rank).
- ``mp_record`` / ``mp_stats`` / ``mp_reset``: the tensor-parallel gauge,
  the newest snapshot of the mesh split (``mp_size``, ``dp_size``,
  ``group_size``), this rank's measured parameter and live bytes and the
  collectives of a loss forward (``block_collective_counts``); partial
  updates merge.
- ``tuning_record`` / ``tuning_stats`` / ``tuning_reset``: the schedule
  autotuner's counters (table hits, misses, fallbacks, ranked and skipped
  candidates, ranker abstentions, model refits, background slots and
  commits), each kernel key's chosen schedule and its source, and the cost
  model's validation rank correlation per group.
- ``comm_record`` / ``comm_stats`` / ``comm_reset``: per op family of the
  parameter-server tier (``push``, ``pull``, ``row_pull``, ...), the RPC
  count, raw (before compression) and wire bytes, seconds (derived
  ``avg_ms``, ``wire_reduction``) and the sender's largest in-flight
  depth.
- ``embedding_record`` / ``embedding_stats`` / ``embedding_reset``: the
  sharded embedding table's pull and push rounds, rows moved, requested
  and unique ids (derived ``dedup_ratio``), out-of-vocabulary refusals,
  wire bytes a shard (``shard_bytes``) and pull/push latency reservoirs
  (p50/p99).
- ``fleet_record`` / ``fleet_stats`` / ``fleet_reset``: the serving
  fleet's router-side counters (requests routed and completed, retries by
  cause: never-sent failover, in-flight loss, draining and overload
  rejections; terminal failures, rolling swaps), the live-replica gauge
  and a router-observed latency reservoir (p50/p99).
- ``autoscale_record`` / ``autoscale_stats`` / ``autoscale_reset``: the
  fleet autoscaler's control-loop counters (ticks, decisions, scale-ups
  and -downs, hysteresis and cooldown holds, retires and retire races,
  errors) and its ``replicas``/``desired`` gauges.
- ``qos_record`` / ``qos_stats`` / ``qos_reset``: per-tenant admission
  counters (requests, admitted, quota rejections, shed at dequeue, rows,
  completed) and a completion-latency reservoir (p50/p99).
- ``dump_profile()``: the trace events and every non-empty snapshot above
  in one JSON file, the one ``set_config`` named, under the JAX package's
  section names.

Unknown counter names raise.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

# ---------------------------------------------------------------------------
# the trace API
# ---------------------------------------------------------------------------
_STATE = {"mode": "symbolic", "filename": "profile.json", "running": False,
          "events": []}
_LOCK = threading.Lock()


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Set the mode (``symbolic``, or ``all`` to stamp every imperative op)
    and the file ``dump_profile`` writes."""
    _STATE["mode"] = mode
    _STATE["filename"] = filename


def profiler_set_state(state="stop"):
    """``run`` clears the events and starts collecting; ``stop`` ends it."""
    if state == "run" and not _STATE["running"]:
        _STATE["running"] = True
        _STATE["events"] = []
    elif state == "stop" and _STATE["running"]:
        _STATE["running"] = False


set_config = profiler_set_config
set_state = profiler_set_state


def record_event(name, category, start_us, dur_us, tid=0):
    """One complete (``ph`` X) event, kept while the profiler runs."""
    if not _STATE["running"]:
        return
    with _LOCK:
        _STATE["events"].append(
            {"name": name, "cat": category, "ph": "X", "ts": start_us,
             "dur": dur_us, "pid": os.getpid(), "tid": tid})


class scope:
    """A context manager recording one host-side trace event."""

    def __init__(self, name, category="operator"):
        self.name = name
        self.category = category

    def __enter__(self):
        self.start = time.perf_counter_ns() // 1000
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns() // 1000
        record_event(self.name, self.category, self.start, end - self.start)
        return False


def pause():
    _STATE["running"] = False


def resume():
    _STATE["running"] = True


def is_running():
    return _STATE["running"]


def maybe_scope(name, category="operator", mode=None):
    """A trace scope while the profiler runs (in ``mode``, if given), else
    a no-op context."""
    if _STATE["running"] and (mode is None or _STATE["mode"] == mode):
        return scope(name, category)
    return contextlib.nullcontext()


_GEN_LOCK = threading.Lock()
_GEN_ZERO = {
    "requests": 0, "prefills": 0, "prefill_tokens": 0,
    "decode_steps": 0, "tokens": 0, "finished": 0, "eos": 0, "length": 0,
    "deadline": 0, "exhausted": 0, "errors": 0, "shed": 0,
    "slot_steps": 0, "active_slot_steps": 0, "max_queue_depth": 0,
    "busy_seconds": 0.0,   # prefill + decode compute time (floats)
    # shared-prefix KV cache: admissions that matched a cached prefix,
    # pages borrowed copy-on-write, prompt tokens whose prefill was
    # skipped, and least-recently-matched evictions
    "prefix_hits": 0, "shared_pages": 0, "prefill_tokens_saved": 0,
    "prefix_evictions": 0,
    # speculative decoding: draft-proposed vs verify-accepted tokens
    # (their ratio is generate_stats' acceptance_rate) and verify rounds
    "draft_proposed": 0, "draft_accepted": 0, "spec_rounds": 0,
}
_GEN_FLOATS = ("busy_seconds",)
_GEN_GAUGES = ("pages_in_use", "pages_high_water", "pool_pages",
               "page_ref_high_water", "prefix_pages")
_GEN = dict(_GEN_ZERO)
_GEN_PAGES = {}
_GEN_TTFT_CAP = 8192
_GEN_TTFT = None  # deque, created lazily


def _percentile_ms(sorted_secs, q):
    idx = int(round(q * (len(sorted_secs) - 1)))
    return round(sorted_secs[idx] * 1e3, 3)


def generate_record(queue_depth=None, ttfts=None, **adds):
    """Accumulate generative-serving counters (thread-safe). The
    ``pages_*``/``pool_pages`` names are gauges (latest pool snapshot);
    everything else accumulates. Unknown names raise."""
    global _GEN_TTFT
    with _GEN_LOCK:
        for k, v in adds.items():
            if k in _GEN_GAUGES:
                _GEN_PAGES[k] = int(v)
            elif k in _GEN_FLOATS:
                _GEN[k] += float(v)
            elif k in _GEN_ZERO:
                _GEN[k] += int(v)
            else:
                raise ValueError("generate_record: unknown counter %r" % k)
        if queue_depth is not None and queue_depth > _GEN["max_queue_depth"]:
            _GEN["max_queue_depth"] = int(queue_depth)
        if ttfts:
            if _GEN_TTFT is None:
                _GEN_TTFT = deque(maxlen=_GEN_TTFT_CAP)
            _GEN_TTFT.extend(ttfts)


def generate_stats(reset=False):
    """Snapshot with derived slot occupancy, tokens/s and TTFT p50/p99
    (ms); empty dict when the generative tier never ran."""
    global _GEN_TTFT
    with _GEN_LOCK:
        snap = dict(_GEN)
        pages = dict(_GEN_PAGES)
        ttft = sorted(_GEN_TTFT) if _GEN_TTFT else []
        if reset:
            _GEN.update(_GEN_ZERO)
            _GEN_PAGES.clear()
            _GEN_TTFT = None
    if not (any(snap.values()) or pages):
        return {}
    snap.update(pages)
    if snap["slot_steps"]:
        snap["slot_occupancy"] = round(
            snap["active_slot_steps"] / snap["slot_steps"], 3)
    if snap["busy_seconds"] > 0:
        # generated tokens over prefill+decode compute time
        snap["tokens_s"] = round(snap["tokens"] / snap["busy_seconds"], 1)
        snap["busy_seconds"] = round(snap["busy_seconds"], 4)
    if snap["draft_proposed"]:
        # the share of draft proposals the target's verify accepted
        snap["acceptance_rate"] = round(
            snap["draft_accepted"] / snap["draft_proposed"], 3)
    if ttft:
        snap["ttft_p50_ms"] = _percentile_ms(ttft, 0.50)
        snap["ttft_p99_ms"] = _percentile_ms(ttft, 0.99)
    return snap


def generate_reset():
    global _GEN_TTFT
    with _GEN_LOCK:
        _GEN.update(_GEN_ZERO)
        _GEN_PAGES.clear()
        _GEN_TTFT = None


# ---------------------------------------------------------------------------
# ModelServer counters
# ---------------------------------------------------------------------------
_SERVE_LOCK = threading.Lock()
_SERVE = {}
_SERVE_LAT_CAP = 8192  # newest-N latency reservoir per model


def serving_record(model, requests=0, batches=0, rows=0, capacity=0,
                   errors=0, shed=0, queue_depth=None, latencies=None):
    """Accumulate serving counters for one model (thread-safe). ``shed``
    counts deadline-expired requests dropped at dequeue."""
    with _SERVE_LOCK:
        s = _SERVE.get(model)
        if s is None:
            s = _SERVE[model] = {
                "requests": 0, "batches": 0, "rows": 0, "capacity": 0,
                "errors": 0, "shed": 0, "max_queue_depth": 0,
                "lat": deque(maxlen=_SERVE_LAT_CAP)}
        s["requests"] += requests
        s["batches"] += batches
        s["rows"] += rows
        s["capacity"] += capacity
        s["errors"] += errors
        s["shed"] += shed
        if queue_depth is not None and queue_depth > s["max_queue_depth"]:
            s["max_queue_depth"] = queue_depth
        if latencies:
            s["lat"].extend(latencies)


def serving_stats(reset=False):
    """Per-model snapshot with the batch-fill ratio (rows / bucket
    capacity), mean batch rows and request latency p50/p99 (ms); empty
    dict when no ModelServer ran."""
    with _SERVE_LOCK:
        snap = {m: dict(s, lat=list(s["lat"])) for m, s in _SERVE.items()}
        if reset:
            _SERVE.clear()
    out = {}
    for model, s in snap.items():
        lat = sorted(s.pop("lat"))
        if s["batches"]:
            s["avg_batch_rows"] = round(s["rows"] / s["batches"], 2)
        if s["capacity"]:
            s["batch_fill"] = round(s["rows"] / s["capacity"], 3)
        if lat:
            s["p50_ms"] = _percentile_ms(lat, 0.50)
            s["p99_ms"] = _percentile_ms(lat, 0.99)
        out[model] = s
    return out


def serving_reset():
    with _SERVE_LOCK:
        _SERVE.clear()



# ---------------------------------------------------------------------------
# IR pass counters
# ---------------------------------------------------------------------------
_PASS_LOCK = threading.Lock()
_PASS_COUNTERS = ("hits", "rewritten", "quantized", "remat_saved",
                  "remat_recomputed", "transposes_cancelled")
_PASS = {}
_PASS_CALIB = {}


def pass_record(pass_name, rule=None, **adds):
    """Accumulate IR-pass counters (thread-safe). ``rule`` attributes
    ``hits`` to that rule under the pass. Unknown counter names raise."""
    with _PASS_LOCK:
        s = _PASS.get(pass_name)
        if s is None:
            s = _PASS[pass_name] = {k: 0 for k in _PASS_COUNTERS}
            s["rules"] = {}
        for k, v in adds.items():
            if k not in _PASS_COUNTERS:
                raise ValueError("pass_record: unknown counter %r" % k)
            s[k] += int(v)
        if rule is not None and adds.get("hits"):
            s["rules"][rule] = s["rules"].get(rule, 0) + int(adds["hits"])


def pass_calibration(group, **fields):
    """Replace one tensor group's calibration gauge (absmax, scale)."""
    with _PASS_LOCK:
        _PASS_CALIB[group] = dict(fields)


def pass_stats(reset=False):
    """``{"passes": {name: {hits, nodes_rewritten, quantized_ops,
    remat_saved, remat_recomputed, transposes_cancelled, rules}},
    "calibration": {group: gauge}}`` (``calibration`` only once a group was
    calibrated); empty dict when no pass ran."""
    with _PASS_LOCK:
        snap = {name: dict(s, rules=dict(s["rules"]))
                for name, s in _PASS.items()}
        calib = {g: dict(v) for g, v in _PASS_CALIB.items()}
        if reset:
            _PASS.clear()
            _PASS_CALIB.clear()
    if not (snap or calib):
        return {}
    out = {"passes": {
        name: {"hits": s["hits"], "nodes_rewritten": s["rewritten"],
               "quantized_ops": s["quantized"],
               "remat_saved": s["remat_saved"],
               "remat_recomputed": s["remat_recomputed"],
               "transposes_cancelled": s["transposes_cancelled"],
               "rules": s["rules"]}
        for name, s in snap.items()}}
    if calib:
        out["calibration"] = calib
    return out


def pass_reset():
    with _PASS_LOCK:
        _PASS.clear()
        _PASS_CALIB.clear()


# ---------------------------------------------------------------------------
# training health: event counters plus the newest sentinel snapshot (a
# gauge: the sentinel's counters accumulate on the device, so the newest
# drain is the cumulative value)
# ---------------------------------------------------------------------------
_HEALTH_LOCK = threading.Lock()
_HEALTH_EVENTS = {}
_HEALTH_SENTINEL = {}


def health_record(**adds):
    """Accumulate integer reaction-side counters (rollbacks=1, ...)."""
    with _HEALTH_LOCK:
        for k, v in adds.items():
            _HEALTH_EVENTS[k] = _HEALTH_EVENTS.get(k, 0) + int(v)


def health_sentinel(snapshot):
    """Replace the sentinel gauge with the newest drained counters
    (``TrainStep.health_stats``)."""
    with _HEALTH_LOCK:
        _HEALTH_SENTINEL.clear()
        _HEALTH_SENTINEL.update(snapshot or {})


def health_stats(reset=False):
    """``{event counters..., "sentinel": newest snapshot}``; empty dict
    when nothing was recorded."""
    with _HEALTH_LOCK:
        snap = dict(_HEALTH_EVENTS)
        sent = dict(_HEALTH_SENTINEL)
        if reset:
            _HEALTH_EVENTS.clear()
            _HEALTH_SENTINEL.clear()
    if sent:
        snap["sentinel"] = sent
    return snap


def health_reset():
    with _HEALTH_LOCK:
        _HEALTH_EVENTS.clear()
        _HEALTH_SENTINEL.clear()


# ---------------------------------------------------------------------------
# the training loop's input pipeline and host syncs
# ---------------------------------------------------------------------------
_PIPE_LOCK = threading.Lock()
_PIPE_ZERO = {"host_syncs": 0, "puts": 0, "preplaced": 0, "batches": 0,
              "steps": 0, "nbytes": 0, "put_seconds": 0.0,
              "stall_feed_seconds": 0.0, "stall_compute_seconds": 0.0,
              "max_queue_depth": 0, "max_inflight": 0}
_PIPE = dict(_PIPE_ZERO)


def h2d_record(host_syncs=0, puts=0, preplaced=0, batches=0, steps=0,
               nbytes=0, seconds=0.0, stall_feed=0.0, stall_compute=0.0,
               queue_depth=None, inflight=None):
    """Count what a training loop did: host syncs (``TrainStep``'s ``halt``
    sentinel, a metric read), batch arrays placed on a mesh and their bytes
    and seconds, arrays found placed already, batches a ``DeviceQueueIter``
    staged and the seconds its consumer waited for them, fused steps, the
    seconds the host waited for the card, the deepest feed queue and the
    most steps in flight."""
    with _PIPE_LOCK:
        s = _PIPE
        s["host_syncs"] += int(host_syncs)
        s["puts"] += int(puts)
        s["preplaced"] += int(preplaced)
        s["batches"] += int(batches)
        s["steps"] += int(steps)
        s["nbytes"] += int(nbytes)
        s["put_seconds"] += float(seconds)
        s["stall_feed_seconds"] += float(stall_feed)
        s["stall_compute_seconds"] += float(stall_compute)
        if queue_depth is not None and queue_depth > s["max_queue_depth"]:
            s["max_queue_depth"] = int(queue_depth)
        if inflight is not None and inflight > s["max_inflight"]:
            s["max_inflight"] = int(inflight)


def pipeline_stats(reset=False):
    """The counters that were recorded (nonzero ones only), with the JAX
    package's derived averages (``avg_put_ms``, ``put_MBps``,
    ``avg_stall_feed_ms``, ``avg_stall_compute_ms``) where their counts
    are nonzero; an empty dict when nothing was recorded."""
    with _PIPE_LOCK:
        snap = {k: v for k, v in _PIPE.items() if v}
        if reset:
            _PIPE.update(_PIPE_ZERO)
    if snap.get("puts"):
        snap["avg_put_ms"] = round(
            snap.get("put_seconds", 0.0) / snap["puts"] * 1e3, 3)
        if snap.get("put_seconds"):
            snap["put_MBps"] = round(
                snap.get("nbytes", 0) / snap["put_seconds"] / 1e6, 1)
    if snap.get("batches"):
        snap["avg_stall_feed_ms"] = round(
            snap.get("stall_feed_seconds", 0.0) / snap["batches"] * 1e3, 3)
    if snap.get("steps"):
        snap["avg_stall_compute_ms"] = round(
            snap.get("stall_compute_seconds", 0.0) / snap["steps"] * 1e3, 3)
    return snap


def pipeline_reset():
    with _PIPE_LOCK:
        _PIPE.update(_PIPE_ZERO)


# ---------------------------------------------------------------------------
# the resident carry's memory: a gauge, the newest snapshot
# ---------------------------------------------------------------------------
_MEM_LOCK = threading.Lock()
_MEM = {}


def memory_record(**fields):
    """Replace the memory gauge with ``TrainStep.memory_stats``' fields."""
    with _MEM_LOCK:
        _MEM.clear()
        _MEM.update(fields)


def memory_stats(reset=False):
    """The newest memory snapshot ({} when no carry was placed)."""
    with _MEM_LOCK:
        snap = dict(_MEM)
        if reset:
            _MEM.clear()
    return snap


def memory_reset():
    with _MEM_LOCK:
        _MEM.clear()


# ---------------------------------------------------------------------------
# tensor parallelism: a gauge, the newest snapshot (partial updates merge)
# ---------------------------------------------------------------------------
_MP_LOCK = threading.Lock()
_MP_KEYS = frozenset((
    "mp_size", "dp_size", "group_size",
    "param_bytes_per_chip", "live_bytes_per_chip",
    "psum_per_block", "psum_outside", "all_gather_per_step",
    "collectives_per_step",
))
_MP = {}


def mp_record(**fields):
    """Merge ``fields`` into the tensor-parallel gauge. Unknown counter
    names raise."""
    with _MP_LOCK:
        for k, v in fields.items():
            if k not in _MP_KEYS:
                raise ValueError("mp_record: unknown counter %r" % k)
            _MP[k] = int(v)


def mp_stats(reset=False):
    """The newest tensor-parallel snapshot ({} when mp never ran)."""
    with _MP_LOCK:
        snap = dict(_MP)
        if reset:
            _MP.clear()
    return snap


def mp_reset():
    with _MP_LOCK:
        _MP.clear()


# ---------------------------------------------------------------------------
# schedule autotuner (tune/): table hits/misses/fallbacks, ranked sweeps,
# model refits and background slots, the chosen schedule per kernel key
# and the cost model's rank correlation per group
# ---------------------------------------------------------------------------
_TUNE_LOCK = threading.Lock()
_TUNE_ZERO = {"hits": 0, "misses": 0, "fallbacks": 0,
              "candidates_ranked": 0, "timings_skipped": 0,
              "ranker_abstains": 0, "model_refits": 0,
              "bg_slots": 0, "bg_commits": 0}
_TUNE = dict(_TUNE_ZERO)
_TUNE_KERNELS = {}
_TUNE_CORR = {}


def tuning_record(kernel=None, schedule=None, source=None, corr=None,
                  **counts):
    """Accumulate autotuner counters (``hits=1``, ``timings_skipped=4``,
    ...; unknown names raise). ``kernel`` (a table key) also records that
    kernel's chosen schedule and its source; ``corr`` merges a {model
    group: validation rank correlation} gauge."""
    for name in counts:
        if name not in _TUNE_ZERO:
            raise ValueError("unknown tuning counter %r (known: %s)"
                             % (name, ", ".join(sorted(_TUNE_ZERO))))
    with _TUNE_LOCK:
        for name, v in counts.items():
            _TUNE[name] += v
        if kernel is not None:
            _TUNE_KERNELS[kernel] = {"schedule": schedule, "source": source}
        if corr:
            for gk, v in dict(corr).items():
                _TUNE_CORR[gk] = round(float(v), 4)


def tuning_stats(reset=False):
    """Snapshot {hits, misses, fallbacks, candidates_ranked,
    timings_skipped, ranker_abstains, model_refits, bg_slots, bg_commits,
    kernels: {key: {schedule, source}}, rank_correlation: {group: r}};
    empty dict when the tuning path never ran."""
    with _TUNE_LOCK:
        snap = dict(_TUNE)
        kernels = {k: dict(v) for k, v in _TUNE_KERNELS.items()}
        corr = dict(_TUNE_CORR)
        if reset:
            _TUNE.update(_TUNE_ZERO)
            _TUNE_KERNELS.clear()
            _TUNE_CORR.clear()
    if not (any(snap.values()) or kernels or corr):
        return {}
    if kernels:
        snap["kernels"] = kernels
    if corr:
        snap["rank_correlation"] = corr
    return snap


def tuning_reset():
    with _TUNE_LOCK:
        _TUNE.update(_TUNE_ZERO)
        _TUNE_KERNELS.clear()
        _TUNE_CORR.clear()


# ---------------------------------------------------------------------------
# sharded dataset service (``data/``): records, bytes, leases, rebalances,
# resumes, prefetch hits, decode time and a per-batch input-wait reservoir
# for p50/p99. Rides dump_profile as ioStats. Unknown counter names raise.
# ---------------------------------------------------------------------------
_IO_LOCK = threading.Lock()
_IO_ZERO = {
    "records": 0, "bytes": 0, "batches": 0, "decode_tasks": 0,
    "prefetch_hits": 0, "prefetch_misses": 0,
    "leases": 0, "lease_lost": 0, "rebalanced_leases": 0,
    "shards_done": 0, "epochs": 0, "resumes": 0,
    "read_seconds": 0.0, "decode_seconds": 0.0, "wait_seconds": 0.0,
}
_IO_FLOATS = ("read_seconds", "decode_seconds", "wait_seconds")
_IO = dict(_IO_ZERO)
_IO_CURSORS = {}            # shard index -> last resume cursor seen
_IO_QUEUE_DEPTH_MAX = 0
_IO_LAT_CAP = 8192
_IO_WAIT_LAT = None         # deque of wait seconds, created lazily


def io_record(resume_cursors=None, wait_latencies=None,
              queue_depth=None, **adds):
    """Accumulate dataset-service counters (thread-safe).
    ``resume_cursors`` is a ``{shard_index: cursor}`` last-seen map,
    ``wait_latencies`` a list of per-batch input-wait seconds for the
    reservoir, ``queue_depth`` an instantaneous prefetch-queue depth
    (the max is kept). Unknown counter names raise."""
    global _IO_WAIT_LAT, _IO_QUEUE_DEPTH_MAX
    with _IO_LOCK:
        for k, v in adds.items():
            if k in _IO_FLOATS:
                _IO[k] += float(v)
            elif k in _IO_ZERO:
                _IO[k] += int(v)
            else:
                raise ValueError("io_record: unknown counter %r" % k)
        if resume_cursors:
            for s, c in resume_cursors.items():
                _IO_CURSORS[int(s)] = int(c)
        if queue_depth is not None and queue_depth > _IO_QUEUE_DEPTH_MAX:
            _IO_QUEUE_DEPTH_MAX = int(queue_depth)
        if wait_latencies:
            if _IO_WAIT_LAT is None:
                from collections import deque

                _IO_WAIT_LAT = deque(maxlen=_IO_LAT_CAP)
            _IO_WAIT_LAT.extend(wait_latencies)


def io_stats(reset=False):
    """Snapshot with the prefetch hit rate, the last resume cursor per
    shard and input-wait p50/p99 (ms); an empty dict when the data
    service never ran."""
    global _IO_WAIT_LAT, _IO_QUEUE_DEPTH_MAX
    with _IO_LOCK:
        snap = dict(_IO)
        cursors = {str(s): c for s, c in sorted(_IO_CURSORS.items())}
        depth = _IO_QUEUE_DEPTH_MAX
        wait_lat = sorted(_IO_WAIT_LAT) if _IO_WAIT_LAT else []
        if reset:
            _IO.update(_IO_ZERO)
            _IO_CURSORS.clear()
            _IO_QUEUE_DEPTH_MAX = 0
            _IO_WAIT_LAT = None
    if not (any(snap.values()) or cursors):
        return {}
    probes = snap["prefetch_hits"] + snap["prefetch_misses"]
    if probes:
        snap["prefetch_hit_rate"] = round(
            snap["prefetch_hits"] / probes, 4)
    for key in _IO_FLOATS:
        snap[key] = round(snap[key], 4)
    if cursors:
        snap["resume_cursors"] = cursors
    if depth:
        snap["queue_depth_max"] = depth
    if wait_lat:
        snap["input_wait_p50_ms"] = _percentile_ms(wait_lat, 0.50)
        snap["input_wait_p99_ms"] = _percentile_ms(wait_lat, 0.99)
    return snap


def io_reset():
    global _IO_WAIT_LAT, _IO_QUEUE_DEPTH_MAX
    with _IO_LOCK:
        _IO.update(_IO_ZERO)
        _IO_CURSORS.clear()
        _IO_QUEUE_DEPTH_MAX = 0
        _IO_WAIT_LAT = None


# ---------------------------------------------------------------------------
# the parameter-server tier's comms counters (always on)
# ---------------------------------------------------------------------------
_COMM_LOCK = threading.Lock()
_COMM = {}


def comm_record(op, raw_bytes=0, wire_bytes=0, seconds=0.0, count=0,
                inflight=0):
    """Accumulate comms counters for one kvstore op family."""
    with _COMM_LOCK:
        s = _COMM.get(op)
        if s is None:
            s = _COMM[op] = {"count": 0, "raw_bytes": 0, "wire_bytes": 0,
                             "seconds": 0.0, "max_inflight": 0}
        s["count"] += count
        s["raw_bytes"] += raw_bytes
        s["wire_bytes"] += wire_bytes
        s["seconds"] += seconds
        if inflight > s["max_inflight"]:
            s["max_inflight"] = inflight


def comm_stats(reset=False):
    """Snapshot of the per-op comms counters, with derived ``avg_ms`` (and,
    where raw bytes were recorded, ``wire_reduction``)."""
    with _COMM_LOCK:
        snap = {op: dict(s) for op, s in _COMM.items()}
        if reset:
            _COMM.clear()
    for s in snap.values():
        if s["count"]:
            s["avg_ms"] = round(s["seconds"] / s["count"] * 1e3, 3)
        if s["raw_bytes"] and s["wire_bytes"]:
            s["wire_reduction"] = round(s["raw_bytes"] / s["wire_bytes"], 2)
    return snap


def comm_reset():
    with _COMM_LOCK:
        _COMM.clear()


# ---------------------------------------------------------------------------
# the sharded embedding table's counters (always on)
# ---------------------------------------------------------------------------
_EMBED_LOCK = threading.Lock()
_EMBED_ZERO = {
    "pulls": 0, "pushes": 0, "ids_requested": 0, "unique_ids": 0,
    "rows_pulled": 0, "rows_pushed": 0, "oov_errors": 0,
    "pull_seconds": 0.0, "push_seconds": 0.0,
}
_EMBED_FLOATS = ("pull_seconds", "push_seconds")
_EMBED = dict(_EMBED_ZERO)
_EMBED_SHARD_BYTES = {}     # shard index -> accumulated wire bytes
_EMBED_LAT_CAP = 8192
_EMBED_LAT = {"pull": None, "push": None}


def embedding_record(shard_bytes=None, pull_latencies=None,
                     push_latencies=None, **adds):
    """Accumulate embedding-table counters (thread-safe). ``shard_bytes``
    is a ``{shard: bytes}`` increment; the latency lists feed bounded
    reservoirs. Unknown counter names raise."""
    with _EMBED_LOCK:
        for k, v in adds.items():
            if k in _EMBED_FLOATS:
                _EMBED[k] += float(v)
            elif k in _EMBED_ZERO:
                _EMBED[k] += int(v)
            else:
                raise ValueError("embedding_record: unknown counter %r" % k)
        for s, b in (shard_bytes or {}).items():
            _EMBED_SHARD_BYTES[int(s)] = \
                _EMBED_SHARD_BYTES.get(int(s), 0) + int(b)
        for kind, lat in (("pull", pull_latencies), ("push", push_latencies)):
            if lat:
                if _EMBED_LAT[kind] is None:
                    _EMBED_LAT[kind] = deque(maxlen=_EMBED_LAT_CAP)
                _EMBED_LAT[kind].extend(lat)


def embedding_stats(reset=False):
    """Snapshot with the derived ``dedup_ratio`` (unique / requested ids)
    and pull/push p50/p99 (ms); empty when the table never ran."""
    with _EMBED_LOCK:
        snap = dict(_EMBED)
        shards = {str(s): b for s, b in sorted(_EMBED_SHARD_BYTES.items())}
        lats = {k: sorted(v) if v else [] for k, v in _EMBED_LAT.items()}
        if reset:
            _embedding_clear()
    if not (any(snap.values()) or shards):
        return {}
    if snap["ids_requested"]:
        snap["dedup_ratio"] = round(
            snap["unique_ids"] / snap["ids_requested"], 4)
    for key in _EMBED_FLOATS:
        snap[key] = round(snap[key], 4)
    if shards:
        snap["shard_bytes"] = shards
    for kind in ("pull", "push"):
        if lats[kind]:
            snap["%s_p50_ms" % kind] = _percentile_ms(lats[kind], 0.50)
            snap["%s_p99_ms" % kind] = _percentile_ms(lats[kind], 0.99)
    return snap


def _embedding_clear():
    _EMBED.update(_EMBED_ZERO)
    _EMBED_SHARD_BYTES.clear()
    _EMBED_LAT.update(pull=None, push=None)


def embedding_reset():
    with _EMBED_LOCK:
        _embedding_clear()


# ---------------------------------------------------------------------------
# serving fleet: router-side counters, retries by cause, a latency reservoir
# ---------------------------------------------------------------------------
_FLEET_LOCK = threading.Lock()
_FLEET_ZERO = {
    "requests": 0, "completed": 0, "failed": 0, "retries": 0,
    "failovers": 0, "inflight_lost": 0, "draining_rejections": 0,
    "overload_rejections": 0, "overloaded": 0, "swaps": 0,
    "replicas_alive": 0,
}
_FLEET = dict(_FLEET_ZERO)
_FLEET_LAT_CAP = 8192
_FLEET_LAT = None  # deque, created lazily


def fleet_record(latencies=None, replicas_alive=None, **adds):
    """Accumulate router-side fleet counters (thread-safe).
    ``replicas_alive`` is a gauge (the latest view's size); everything
    else accumulates. Unknown counter names raise."""
    global _FLEET_LAT
    with _FLEET_LOCK:
        for k, v in adds.items():
            if k not in _FLEET_ZERO:
                raise ValueError("fleet_record: unknown counter %r" % k)
            _FLEET[k] += int(v)
        if replicas_alive is not None:
            _FLEET["replicas_alive"] = int(replicas_alive)
        if latencies:
            if _FLEET_LAT is None:
                _FLEET_LAT = deque(maxlen=_FLEET_LAT_CAP)
            _FLEET_LAT.extend(latencies)


def fleet_stats(reset=False):
    """Snapshot of the router-side fleet counters with derived p50/p99
    (ms); an empty dict when no router ever ran."""
    global _FLEET_LAT
    with _FLEET_LOCK:
        snap = dict(_FLEET)
        lat = sorted(_FLEET_LAT) if _FLEET_LAT else []
        if reset:
            _FLEET.update(_FLEET_ZERO)
            _FLEET_LAT = None
    if not any(snap.values()):
        return {}
    if lat:
        snap["p50_ms"] = _percentile_ms(lat, 0.50)
        snap["p99_ms"] = _percentile_ms(lat, 0.99)
    return snap


def fleet_reset():
    global _FLEET_LAT
    with _FLEET_LOCK:
        _FLEET.update(_FLEET_ZERO)
        _FLEET_LAT = None


# ---------------------------------------------------------------------------
# fleet autoscaler: control-loop counters and the replicas/desired gauges
# ---------------------------------------------------------------------------
_AUTOSCALE_LOCK = threading.Lock()
_AUTOSCALE_ZERO = {
    "ticks": 0, "decisions": 0, "scale_ups": 0, "scale_downs": 0,
    "holds_hysteresis": 0, "holds_cooldown": 0, "retires": 0,
    "retire_races": 0, "errors": 0,
}
_AUTOSCALE = dict(_AUTOSCALE_ZERO)
_AUTOSCALE_GAUGES = {"replicas": 0, "desired": 0}
_AUTOSCALE_SEEN = False


def autoscale_record(replicas=None, desired=None, **adds):
    """Accumulate autoscaler counters (``replicas``/``desired`` are
    gauges: assigned, not added). Unknown counter names raise."""
    global _AUTOSCALE_SEEN
    with _AUTOSCALE_LOCK:
        for k, v in adds.items():
            if k not in _AUTOSCALE_ZERO:
                raise ValueError(
                    "autoscale_record: unknown counter %r" % (k,))
            _AUTOSCALE[k] += int(v)
        if replicas is not None:
            _AUTOSCALE_GAUGES["replicas"] = int(replicas)
        if desired is not None:
            _AUTOSCALE_GAUGES["desired"] = int(desired)
        _AUTOSCALE_SEEN = True


def autoscale_stats(reset=False):
    """Snapshot (counters and gauges); an empty dict when no controller
    ever ran."""
    global _AUTOSCALE_SEEN
    with _AUTOSCALE_LOCK:
        seen = _AUTOSCALE_SEEN
        snap = dict(_AUTOSCALE)
        snap.update(_AUTOSCALE_GAUGES)
        if reset:
            _AUTOSCALE.update(_AUTOSCALE_ZERO)
            _AUTOSCALE_GAUGES.update(replicas=0, desired=0)
            _AUTOSCALE_SEEN = False
    return snap if seen else {}


def autoscale_reset():
    autoscale_stats(reset=True)


# ---------------------------------------------------------------------------
# multi-tenant QoS: per-tenant admission counters and latency reservoirs
# ---------------------------------------------------------------------------
_QOS_LOCK = threading.Lock()
_QOS_ZERO = {"requests": 0, "admitted": 0, "quota_rejections": 0,
             "shed": 0, "rows": 0, "completed": 0}
_QOS_LAT_CAP = 8192
_QOS = {}


def qos_record(tenant, latencies=None, **adds):
    """Accumulate per-tenant QoS counters; ``latencies`` (seconds) extend
    the tenant's reservoir. Unknown counter names raise."""
    tenant = str(tenant)
    with _QOS_LOCK:
        s = _QOS.get(tenant)
        if s is None:
            s = _QOS[tenant] = dict(_QOS_ZERO,
                                    lat=deque(maxlen=_QOS_LAT_CAP))
        for k, v in adds.items():
            if k not in _QOS_ZERO:
                raise ValueError("qos_record: unknown counter %r" % (k,))
            s[k] += int(v)
        if latencies:
            s["lat"].extend(latencies)


def qos_stats(reset=False):
    """Per-tenant snapshot with p50/p99 (ms); an empty dict when no
    tenant-labelled traffic was seen."""
    with _QOS_LOCK:
        out = {}
        for tenant, s in sorted(_QOS.items()):
            snap = {k: s[k] for k in _QOS_ZERO}
            lat = sorted(s["lat"])
            if lat:
                snap["p50_ms"] = _percentile_ms(lat, 0.50)
                snap["p99_ms"] = _percentile_ms(lat, 0.99)
            out[tenant] = snap
        if reset:
            _QOS.clear()
    return out


def qos_reset():
    with _QOS_LOCK:
        _QOS.clear()


def dump_profile():
    """Write the trace events and every non-empty counter snapshot, as one
    Chrome trace JSON object, to the file ``set_config`` named."""
    with _LOCK:
        payload = {"traceEvents": list(_STATE["events"]),
                   "displayTimeUnit": "ms"}
    for key, stats in (("commStats", comm_stats),
                       ("pipelineStats", pipeline_stats),
                       ("servingStats", serving_stats),
                       ("memoryStats", memory_stats),
                       ("healthStats", health_stats),
                       ("tuningStats", tuning_stats),
                       ("fleetStats", fleet_stats),
                       ("generateStats", generate_stats),
                       ("passStats", pass_stats),
                       ("embeddingStats", embedding_stats),
                       ("ioStats", io_stats),
                       ("autoscaleStats", autoscale_stats),
                       ("qosStats", qos_stats),
                       ("mpStats", mp_stats)):
        snap = stats()
        if snap:
            payload[key] = snap
    with open(_STATE["filename"], "w") as f:
        json.dump(payload, f)


# MXNET_PROFILER_AUTOSTART: collect from import on, in MXNET_PROFILER_MODE,
# and dump at interpreter exit (read once, at import, as in the JAX package)
if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    import atexit

    profiler_set_config(mode=os.environ.get("MXNET_PROFILER_MODE",
                                            "symbolic"))
    profiler_set_state("run")
    atexit.register(lambda: (profiler_set_state("stop"), dump_profile()))
