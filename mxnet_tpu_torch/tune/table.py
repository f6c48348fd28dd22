"""On-disk schedule table: searched kernel tiles keyed by ``(kernel, shape,
dtype, backend)`` (counterpart of ``mxnet_tpu/tune/table.py``, the same
JSON format).

- **The consult is a dict hit.** Kernel entry points call
  :func:`schedule_for` when they are called; after the first lookup of a
  key the answer (a miss too) sits in a process-local memo.
- **Versioned, atomic, corruption-proof.** One JSON file, ``{"version": 1,
  "entries": {key: record}}``, written through :func:`atomic_write_bytes`
  (tmp + fsync + rename: a crash mid-commit leaves the old table). A
  truncated, garbage or version-mismatched file logs a warning, behaves as
  empty (hand defaults), and is rewritten whole by the next commit.
- **Backend-keyed.** ``backend`` is ``"cuda"`` for a tile timed on the
  card and ``"cpu"`` for one timed on the plain versions, so a CPU table
  never leaks into a card run. The JAX package's records (``"tpu"``,
  ``"cpu"``) and the port's load in either package: the knob names and
  their types are the same (``_KNOWN_KNOBS``), their meaning is each
  backend's own kernel's (``search.py``).

Location: ``MXNET_TPU_TUNE_TABLE`` when set, else
``~/.cache/mxnet_tpu/schedule_table.json``, the JAX package's path.
``MXNET_TPU_TUNE=0`` disables the consult (hand defaults, no reads).
"""
from __future__ import annotations

import json
import logging
import os
import threading

from .. import config

log = logging.getLogger("mxnet_tpu_torch.tune")

TABLE_VERSION = 1

# schedule knobs a record may carry (the JAX package's list); anything else
# in a loaded schedule makes the table corrupt (hand defaults)
_KNOWN_KNOBS = frozenset(
    ("row_tile", "chan_block", "batch_fold", "block_q", "block_k",
     # training-pipeline choices (pipeline.py): small positive codes
     "remat", "layout"))


def default_backend():
    """``"cuda"`` where a card is visible, else ``"cpu"``."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_of(t):
    """The table backend of a tensor (or a ``torch.device``): ``"cuda"`` or
    ``"cpu"``."""
    return "cuda" if getattr(t, "device", t).type == "cuda" else "cpu"


def dtype_name(dtype):
    """A torch dtype as the table spells it (``"bfloat16"``, ``"float32"``:
    the JAX package's ``str(dtype)``)."""
    return str(dtype).replace("torch.", "")


def default_table_path():
    override = config.get("MXNET_TPU_TUNE_TABLE")
    if override:
        return override
    return os.path.join(os.path.expanduser("~"), ".cache", "mxnet_tpu",
                        "schedule_table.json")


def make_key(kernel, shape, dtype, backend):
    """The table/report key: ``kernel|d0xd1x...|dtype|backend``."""
    dims = "x".join(str(int(d)) for d in shape)
    return "%s|%s|%s|%s" % (kernel, dims, dtype, backend)


def atomic_write_bytes(fname, data):
    """Write ``data`` to ``fname`` through tmp + fsync + rename: a crash
    mid-write leaves the old file, never a torn one (the JAX package's
    ``checkpoint.atomic_write_bytes``)."""
    fname = os.fspath(fname)
    tmp = "%s.tmp%d" % (fname, os.getpid())
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.replace(tmp, fname)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    try:
        fd = os.open(os.path.dirname(os.path.abspath(fname)), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# miss registry: every consult that found no entry records what was missing
# (kernel, shape, dtype, backend), enough to rebuild a sweep, so the
# background tuner can time candidates for exactly the shapes a job ran.
# Process-local, bounded, cleared when a commit satisfies the key.
# ---------------------------------------------------------------------------
_MISS_LOCK = threading.Lock()
_MISSES = {}          # key -> {key, kernel, shape, dtype, backend, count}
_MISS_CAP = 512


def _record_miss(key, kernel, shape, dtype, backend):
    with _MISS_LOCK:
        m = _MISSES.get(key)
        if m is not None:
            m["count"] += 1
            return
        if len(_MISSES) >= _MISS_CAP:
            return
        _MISSES[key] = {"key": key, "kernel": str(kernel),
                        "shape": tuple(int(d) for d in shape),
                        "dtype": str(dtype), "backend": str(backend),
                        "count": 1}


def recorded_misses():
    """Snapshot of the misses this process's consults recorded, in
    insertion order: the background tuner's work queue."""
    with _MISS_LOCK:
        return [dict(m) for m in _MISSES.values()]


def clear_miss(key):
    with _MISS_LOCK:
        _MISSES.pop(key, None)


def clear_misses():
    with _MISS_LOCK:
        _MISSES.clear()


def _valid_schedule(schedule):
    if not isinstance(schedule, dict) or not schedule:
        return False
    for k, v in schedule.items():
        if k not in _KNOWN_KNOBS:
            return False
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            return False
    return True


class ScheduleTable:
    """One JSON schedule table and its process-local memo."""

    def __init__(self, path=None):
        self.path = path or default_table_path()
        self._lock = threading.Lock()
        self._memo = {}        # key -> schedule dict | None (a miss)
        self._entries = None   # key -> full record; None until loaded
        self.load_error = None

    # -- load / persist ----------------------------------------------------
    def _load_locked(self):
        if self._entries is not None:
            return
        self._entries = {}
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        except OSError as e:
            self.load_error = "unreadable: %s" % e
            log.warning("schedule table %s unreadable (%s); using default "
                        "schedules", self.path, e)
            return
        try:
            data = json.loads(raw)
            if not isinstance(data, dict):
                raise ValueError("top level is %s, not an object"
                                 % type(data).__name__)
            version = data.get("version")
            if version != TABLE_VERSION:
                raise ValueError("version %r != %d" % (version,
                                                       TABLE_VERSION))
            entries = data["entries"]
            if not isinstance(entries, dict):
                raise ValueError("entries is %s, not an object"
                                 % type(entries).__name__)
            loaded = {}
            for key, rec in entries.items():
                if not (isinstance(rec, dict)
                        and _valid_schedule(rec.get("schedule"))):
                    raise ValueError("malformed record for key %r" % key)
                loaded[key] = rec
        except (ValueError, KeyError, TypeError) as e:
            # corrupt or stale: behave as empty (the hand defaults run) and
            # let the next commit rewrite the whole file
            self.load_error = str(e)
            log.warning(
                "schedule table %s is corrupt or from another version "
                "(%s); falling back to default schedules; the next "
                "python -m mxnet_tpu_torch.tune run rewrites it",
                self.path, e)
            return
        self._entries = loaded

    def _persist_locked(self):
        payload = {"version": TABLE_VERSION, "entries": self._entries}
        data = json.dumps(payload, indent=1, sort_keys=True).encode("utf-8")
        d = os.path.dirname(os.path.abspath(self.path))
        if d:
            os.makedirs(d, exist_ok=True)
        atomic_write_bytes(self.path, data)
        self.load_error = None

    # -- API ---------------------------------------------------------------
    def lookup(self, kernel, shape, dtype, backend, record_stats=True):
        """Schedule dict for the key, or None. Counts a hit or a miss in
        ``profiler.tuning_stats`` (``record_stats=False`` for
        introspection that must not move the counters) and records a miss
        in the miss registry."""
        key = make_key(kernel, shape, dtype, backend)
        if key in self._memo:
            sched = self._memo[key]
        else:
            with self._lock:
                self._load_locked()
                rec = self._entries.get(key)
                sched = dict(rec["schedule"]) if rec else None
                self._memo[key] = sched
        if record_stats:
            from .. import profiler

            if sched is not None:
                profiler.tuning_record(hits=1, kernel=key,
                                       schedule=dict(sched), source="table")
            else:
                profiler.tuning_record(misses=1)
                _record_miss(key, kernel, shape, dtype, backend)
        return dict(sched) if sched else None

    def reload(self):
        """Drop the loaded entries and the memo, so the next read re-reads
        the file: how a long-lived process sees another's commits."""
        with self._lock:
            self._entries = None
            self.load_error = None
            self._memo = {}

    def entry(self, kernel, shape, dtype, backend):
        """The full stored record (schedule and timings), or None."""
        with self._lock:
            self._load_locked()
            rec = self._entries.get(make_key(kernel, shape, dtype, backend))
            return dict(rec) if rec else None

    def entries(self):
        """Every stored record by key: the cost model's training rows."""
        with self._lock:
            self._load_locked()
            return {k: dict(v) for k, v in self._entries.items()}

    def record(self, kernel, shape, dtype, backend, record):
        """Commit one winner record (an atomic rewrite of the whole file).

        The file is re-read at commit time, so two processes sharing one
        table do not drop each other's winners. Banked ``timings`` rows
        merge with the stored ones (a fresh measurement of a schedule
        wins); a commit without timings keeps the stored bank."""
        if not _valid_schedule(record.get("schedule")):
            raise ValueError("record.schedule must be a non-empty dict of "
                             "known integer knobs >= 1, got %r"
                             % (record.get("schedule"),))
        key = make_key(kernel, shape, dtype, backend)
        with self._lock:
            self._entries = None
            self.load_error = None
            self._load_locked()
            prev = self._entries.get(key)
            if prev and prev.get("timings"):
                if record.get("timings"):
                    merged = {}
                    for t in list(prev["timings"]) + list(record["timings"]):
                        try:
                            merged[frozenset(t["schedule"].items())] = t
                        except (AttributeError, KeyError, TypeError):
                            continue   # a row the merge cannot key: dropped
                    record = dict(record, timings=list(merged.values()))
                else:
                    record = dict(record, timings=prev["timings"])
            self._entries[key] = dict(record, kernel=kernel,
                                      shape=[int(d) for d in shape],
                                      dtype=str(dtype), backend=backend)
            self._persist_locked()
            self._memo[key] = dict(record["schedule"])
        clear_miss(key)   # a commit satisfies the recorded miss
        return key

    def __len__(self):
        with self._lock:
            self._load_locked()
            return len(self._entries)


# ---------------------------------------------------------------------------
# the process-global table and the consult
# ---------------------------------------------------------------------------
_GLOBAL_LOCK = threading.Lock()
_GLOBAL = None  # (path, ScheduleTable)


def get_table(path=None):
    """The process-global table for ``path`` (default: knob-resolved); a
    changed ``MXNET_TPU_TUNE_TABLE`` gets a fresh table."""
    global _GLOBAL
    resolved = path or default_table_path()
    with _GLOBAL_LOCK:
        if _GLOBAL is None or _GLOBAL[0] != resolved:
            _GLOBAL = (resolved, ScheduleTable(resolved))
        return _GLOBAL[1]


def reset():
    """Drop the process-global table (memo included) and the miss
    registry."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
    clear_misses()


def schedule_for(kernel, shape, dtype, backend=None):
    """The consult of the kernel entry points: the searched schedule dict
    for ``(kernel, shape, dtype, backend)``, or None (the caller runs its
    hand default). ``MXNET_TPU_TUNE=0`` returns None without reading the
    table or moving the counters."""
    if not config.get_bool("MXNET_TPU_TUNE", True):
        return None
    if backend is None:
        backend = default_backend()
    return get_table().lookup(kernel, tuple(shape), str(dtype), backend)
