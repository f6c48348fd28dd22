"""Serving, training and pass counters (counterpart of the matching parts
of ``mxnet_tpu/profiler.py``).

- ``generate_record`` / ``generate_stats`` / ``generate_reset``:
  request/prefill/decode-step/token counts, finish reasons, requests shed
  at dequeue, slot occupancy (active-slot-steps / slot-steps), a
  time-to-first-token reservoir and the page-pool gauge
  (``pages_in_use == 0`` after a drained run is the exact-accounting
  check).
- ``serving_record`` / ``serving_stats`` / ``serving_reset``: per-model
  counters of the dynamic-batching ``ModelServer`` (requests, batches,
  rows against bucket capacity, shed, errors, queue depth, request
  latency p50/p99).
- ``pass_record`` / ``pass_stats`` / ``pass_reset``: per IR pass, rule
  hits, nodes rewritten, the remat plan's saved and recomputed node
  counts and the layout pass's cancelled transposes.
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

Unknown counter names raise.
"""
from __future__ import annotations

import threading
from collections import deque

_GEN_LOCK = threading.Lock()
_GEN_ZERO = {
    "requests": 0, "prefills": 0, "prefill_tokens": 0,
    "decode_steps": 0, "tokens": 0, "finished": 0, "eos": 0, "length": 0,
    "deadline": 0, "exhausted": 0, "errors": 0, "shed": 0,
    "slot_steps": 0, "active_slot_steps": 0, "max_queue_depth": 0,
    "busy_seconds": 0.0,   # prefill + decode compute time (floats)
}
_GEN_FLOATS = ("busy_seconds",)
_GEN_GAUGES = ("pages_in_use", "pages_high_water", "pool_pages")
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
_PASS_COUNTERS = ("hits", "rewritten", "remat_saved", "remat_recomputed",
                  "transposes_cancelled")
_PASS = {}


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


def pass_stats(reset=False):
    """``{"passes": {name: {hits, nodes_rewritten, remat_saved,
    remat_recomputed, transposes_cancelled, rules}}}``; empty dict when no
    pass ran."""
    with _PASS_LOCK:
        snap = {name: dict(s, rules=dict(s["rules"]))
                for name, s in _PASS.items()}
        if reset:
            _PASS.clear()
    if not snap:
        return {}
    return {"passes": {
        name: {"hits": s["hits"], "nodes_rewritten": s["rewritten"],
               "remat_saved": s["remat_saved"],
               "remat_recomputed": s["remat_recomputed"],
               "transposes_cancelled": s["transposes_cancelled"],
               "rules": s["rules"]}
        for name, s in snap.items()}}


def pass_reset():
    with _PASS_LOCK:
        _PASS.clear()


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
_PIPE_ZERO = {"host_syncs": 0, "puts": 0, "preplaced": 0, "steps": 0,
              "nbytes": 0, "put_seconds": 0.0, "stall_compute_seconds": 0.0,
              "max_inflight": 0}
_PIPE = dict(_PIPE_ZERO)


def h2d_record(host_syncs=0, puts=0, preplaced=0, steps=0, nbytes=0,
               seconds=0.0, stall_compute=0.0, inflight=None):
    """Count what a training loop did: host syncs (``TrainStep``'s ``halt``
    sentinel, a metric read), batch arrays placed on a mesh and their bytes
    and seconds, arrays found placed already, fused steps, the seconds the
    host waited for the card and the most steps in flight."""
    with _PIPE_LOCK:
        s = _PIPE
        s["host_syncs"] += int(host_syncs)
        s["puts"] += int(puts)
        s["preplaced"] += int(preplaced)
        s["steps"] += int(steps)
        s["nbytes"] += int(nbytes)
        s["put_seconds"] += float(seconds)
        s["stall_compute_seconds"] += float(stall_compute)
        if inflight is not None and inflight > s["max_inflight"]:
            s["max_inflight"] = int(inflight)


def pipeline_stats(reset=False):
    """The counters that were recorded (nonzero ones only); an empty dict
    when nothing was."""
    with _PIPE_LOCK:
        snap = {k: v for k, v in _PIPE.items() if v}
        if reset:
            _PIPE.update(_PIPE_ZERO)
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
