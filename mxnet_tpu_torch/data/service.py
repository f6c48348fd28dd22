"""Sharded dataset service: exactly-once record streams (counterpart of
``mxnet_tpu/data/service.py``).

The read path (:class:`ShardedRecordStream`) leases record-file shards
from an authority — a :class:`~.lease.LocalLeaseAuthority` here, or any
object with its ``data_*`` methods passed as ``lease_client`` — and
streams decoded records with a per-record consumption ledger. The JAX
stream built without ``lease_client`` leases from the job tracker
(``tracker.worker_client()``) when the environment names a launch.py
topology, taking its rank and incarnation from that client, and from an
in-process :class:`~.lease.LocalLeaseAuthority` otherwise.

The ledger line is flushed **before** the cursor commit, and every lease
acquisition reconciles its resume cursor against ``max(authority
cursor, ledger max + 1)`` over *all* ledger files in the shared ledger
directory, so neither crash ordering nor steal-by-survivor can double-
or under-consume a record.

Decode runs off the training thread when ``MXNET_DATA_WORKERS`` > 0
(bounded process pool) and record seeds derive from
``(epoch, shard, record-index)`` in deterministic mode — never from
worker identity — so a rebalanced shard decodes to the exact bytes its
original owner would have produced.

:class:`ShardedBatchIter` adapts the stream to the ``io.DataIter``
batch contract so it drops into ``parallel/feed.py``'s DeviceQueueIter
unchanged. Batches stay on the host (numpy), as the JAX package's
iterators stage on the host. Telemetry rides the profiler's ``ioStats``
family (``profiler.io_record``) and dumps with ``dump_profile``.
"""
from __future__ import annotations

import glob
import logging
import os
import queue
import struct
import threading
import time

import numpy as np

from .. import recordio
from ..base import MXNetError
from ..tracker import tracker_env_spec  # noqa: F401 (the env contract)
from .errors import (CursorCorruptError, LeaseLostError,
                     ManifestCorruptError, ShardCorruptError)  # noqa: F401
from .lease import LeaseError, LocalLeaseAuthority
from .writer import load_manifest

log = logging.getLogger("mxnet_tpu_torch.data")

_ACQUIRE_RETRY = 0.05       # poll interval while peers hold all shards
_CHUNK_RECORDS = 64         # records per read/decode/ledger unit


# ---------------------------------------------------------------------------
# deterministic per-record seeding
# ---------------------------------------------------------------------------
def record_seed(epoch, shard, index, salt=0):
    """64-bit decode/augment seed from the record's *position*
    (epoch, shard, record index) — never the worker consuming it — so
    a shard rebalanced to a survivor mid-epoch decodes byte-identically
    to what its first owner would have produced (splitmix64 mix)."""
    x = ((epoch & 0xFFFF) << 48) ^ ((shard & 0xFFFF) << 32) \
        ^ (index & 0xFFFFFFFF) ^ ((salt & 0xFFFFFFFF) << 16)
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


# ---------------------------------------------------------------------------
# decode functions (module-level: process-pool workers must import them)
# ---------------------------------------------------------------------------
def decode_raw(raw, seed):
    """Identity decode: the record's bytes, untouched."""
    return raw


def decode_image_f32(raw, seed, shape=(3, 32, 32)):
    """Bench/ResNet decode: ``<f label><uint8 pixels>`` record to a
    float32 CHW array in [0, 1] plus its label, with a seed-driven
    horizontal-flip augmentation (the determinism probe: flip choice
    must follow the record seed, not the decoding worker)."""
    n = int(np.prod(shape))
    if len(raw) != 4 + n:
        raise ValueError("image record is %d bytes, expected %d"
                         % (len(raw), 4 + n))
    (label,) = struct.unpack_from("<f", raw, 0)
    img = np.frombuffer(raw, dtype=np.uint8, count=n, offset=4)
    img = img.reshape(shape).astype(np.float32) / 255.0
    if seed & 1:
        img = img[..., ::-1].copy()
    return img, np.float32(label)


def _decode_chunk(decode, jobs):
    """Pool task: decode a chunk of (raw, seed) pairs in order."""
    return [decode(raw, seed) for raw, seed in jobs]


# ---------------------------------------------------------------------------
# lease-free direct read (eval passes, replay baselines)
# ---------------------------------------------------------------------------
def iter_manifest_records(manifest_path):
    """Yield every ``(shard, index, raw_bytes)`` of a dataset in shard
    order, without leases — for full-dataset eval and replay baselines
    where every worker intentionally reads everything."""
    manifest = load_manifest(manifest_path)
    root = os.path.dirname(os.fspath(manifest_path))
    for sid, entry in enumerate(manifest["shards"]):
        reader = _open_shard(manifest_path, root, entry)
        try:
            for idx in range(entry["records"]):
                raw = _read_next(reader, root, entry, idx)
                yield sid, idx, raw
        finally:
            reader.close()


def merge_ledgers(ledger_dir):
    """Consumption counts ``{(epoch, shard, index): n}`` merged over
    every ``*.ledger`` file in ``ledger_dir`` — the exactly-once
    evidence the chaos matrix asserts on (every n must be 1)."""
    counts = {}
    for path in sorted(glob.glob(os.path.join(os.fspath(ledger_dir),
                                              "*.ledger"))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                epoch, shard, index = (int(x) for x in line.split("\t"))
                key = (epoch, shard, index)
                counts[key] = counts.get(key, 0) + 1
    return counts


def _ledger_resume_cursor(ledger_dir, epoch, shard):
    """Highest ledgered record index + 1 for (epoch, shard) across all
    ledger files, or 0 — the crash-safe floor for a resume cursor."""
    if not ledger_dir:
        return 0
    top = -1
    for path in glob.glob(os.path.join(os.fspath(ledger_dir), "*.ledger")):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    e, s, i = (int(x) for x in line.split("\t"))
                    if e == epoch and s == shard and i > top:
                        top = i
        except (OSError, ValueError) as exc:
            raise CursorCorruptError(
                "ledger %s is unreadable/garbled (%s) — refusing to "
                "guess a resume cursor" % (path, exc))
    return top + 1


def _open_shard(manifest_path, root, entry):
    path = os.path.join(root, entry["file"])
    try:
        reader = recordio.MXIndexedRecordIO(path + ".idx", path, "r")
    except (OSError, MXNetError) as exc:
        raise ShardCorruptError("record shard %s: cannot open (%s)"
                                % (path, exc))
    if len(reader.keys) != entry["records"]:
        reader.close()
        log.warning("record shard %s: index has %d entries, manifest "
                    "promises %d", path, len(reader.keys),
                    entry["records"])
        raise ShardCorruptError(
            "record shard %s: index has %d entries, manifest promises "
            "%d (truncated or stale .idx)"
            % (path, len(reader.keys), entry["records"]))
    return reader


def _read_next(reader, root, entry, index):
    """Read the record at ``index`` (reader already positioned there).
    The python recordio reader returns None at a short header — a
    truncated file looks like a clean EOF — so running out before the
    manifest's count is the truncation signal, and a garbage magic
    raises from the reader itself; both become ShardCorruptError."""
    path = os.path.join(root, entry["file"])
    try:
        raw = reader.read()
    except MXNetError as exc:
        log.warning("record shard %s: garbage at record %d (%s)",
                    path, index, exc)
        raise ShardCorruptError("record shard %s: garbage at record %d "
                                "(%s)" % (path, index, exc))
    if raw is None:
        log.warning("record shard %s: EOF at record %d of %d",
                    path, index, entry["records"])
        raise ShardCorruptError(
            "record shard %s: EOF at record %d but manifest promises "
            "%d records (truncated file)"
            % (path, index, entry["records"]))
    return raw


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------
class ShardedRecordStream:
    """Exactly-once record stream over one dataset's shards.

    ``epoch_records()`` yields ``(shard, index, decoded_record)`` for
    one full *pass* of this worker's share of the current epoch;
    ``self.epoch`` then points at the next epoch. ``rank`` identifies
    the consumer to the lease authority (defaults to the DMLC rank).
    """

    def __init__(self, manifest_path, lease_client=None, rank=None,
                 decode=None, ledger_dir=None, deterministic=None,
                 workers=None, prefetch=None, chunk=_CHUNK_RECORDS):
        from .. import config

        self._manifest_path = os.fspath(manifest_path)
        self._root = os.path.dirname(self._manifest_path)
        self._manifest = load_manifest(self._manifest_path)
        self.name = self._manifest["dataset"]
        self._decode = decode or decode_raw
        self._chunk = max(1, int(chunk))
        self._deterministic = config.get_strict_bool(
            "MXNET_DATA_DETERMINISTIC") if deterministic is None \
            else bool(deterministic)
        self._workers = config.get_nonneg_int("MXNET_DATA_WORKERS") \
            if workers is None else int(workers)
        self._prefetch = config.get_nonneg_int("MXNET_DATA_PREFETCH") \
            if prefetch is None else int(prefetch)
        self._pool = None
        self._thread = None
        self._stop = threading.Event()
        self._gen = None
        self._ledger_dir = os.fspath(ledger_dir) if ledger_dir else None
        self._ledger_file = None
        self._closed = False

        restart = 0
        if lease_client is not None:
            self._auth = lease_client
        else:
            from .. import tracker

            client = tracker.worker_client()
            if client is not None:
                self._auth = client
                if rank is None:
                    rank = client.rank
                restart = client.restart_count
            else:
                self._auth = LocalLeaseAuthority()
        self.rank = int(rank) if rank is not None else \
            int(os.environ.get("DMLC_WORKER_ID", "0") or 0)
        # the decode-seed salt outside deterministic mode: worker
        # identity, exactly what deterministic mode must NOT depend on
        self._salt = 0 if self._deterministic \
            else (self.rank << 8) ^ (restart + 1)

        counts = [s["records"] for s in self._manifest["shards"]]
        init = self._auth.data_init(self.name, counts)
        self.epoch = int(init.get("epoch", 0))
        if self._ledger_dir:
            os.makedirs(self._ledger_dir, exist_ok=True)

    # -- ledger ------------------------------------------------------------
    def _ledger(self):
        if self._ledger_file is None:
            path = os.path.join(
                self._ledger_dir,
                "rank%d-pid%d.ledger" % (self.rank, os.getpid()))
            self._ledger_file = open(path, "a")
        return self._ledger_file

    def _ledger_chunk(self, epoch, shard, start, count):
        if not self._ledger_dir:
            return
        f = self._ledger()
        for i in range(start, start + count):
            f.write("%d\t%d\t%d\n" % (epoch, shard, i))
        f.flush()

    # -- decode ------------------------------------------------------------
    def _decode_jobs(self, epoch, shard, start, raws):
        return [(raw, record_seed(epoch, shard, start + i,
                                  salt=self._salt))
                for i, raw in enumerate(raws)]

    def _decode_chunk(self, jobs):
        from .. import profiler

        t0 = time.monotonic()
        if self._workers > 0:
            if self._pool is None:
                import multiprocessing

                self._pool = multiprocessing.get_context("spawn").Pool(
                    self._workers)
            n = max(1, len(jobs) // self._workers)
            parts = [jobs[i:i + n] for i in range(0, len(jobs), n)]
            out = self._pool.starmap(
                _decode_chunk, [(self._decode, p) for p in parts])
            decoded = [rec for part in out for rec in part]
        else:
            decoded = _decode_chunk(self._decode, jobs)
        profiler.io_record(decode_tasks=len(jobs),
                           decode_seconds=time.monotonic() - t0)
        return decoded

    # -- lease RPC adapters (tracker client and local authority share
    # the explicit-rank signature) --------------------------------------
    def _acquire(self, epoch):
        return self._auth.data_acquire(self.name, self.rank, epoch)

    def _renew(self, epoch, shard, cursor):
        return self._auth.data_renew(self.name, self.rank, epoch,
                                     shard, cursor)

    def _complete(self, epoch, shard, cursor):
        return self._auth.data_complete(self.name, self.rank, epoch,
                                        shard, cursor)

    # -- producer ----------------------------------------------------------
    def _produce_epoch(self, epoch):
        """Yield markers for one epoch pass: ``("chunk", shard, start,
        decoded, nbytes)``, ``("eof", shard, records)``, a final
        ``("roll", next_epoch)``. Runs on the prefetch thread when
        prefetch > 0, inline otherwise."""
        from .. import profiler

        while not self._stop.is_set():
            try:
                got = self._acquire(epoch)
            except LeaseError as exc:
                raise CursorCorruptError(str(exc))
            status = got["status"]
            if status == "epoch_done":
                yield ("roll", epoch + 1)
                return
            if status == "behind":
                yield ("roll", got["epoch"])
                return
            if status == "wait":
                time.sleep(_ACQUIRE_RETRY)
                continue
            shard, records = got["shard"], got["records"]
            cursor = got["cursor"]
            profiler.io_record(
                leases=1,
                rebalanced_leases=1 if got.get("rebalanced") else 0)
            # crash-safe resume floor: anything any incarnation
            # ledgered for this (epoch, shard) is already consumed
            floor = _ledger_resume_cursor(self._ledger_dir, epoch, shard)
            if max(cursor, floor) > records:
                raise CursorCorruptError(
                    "dataset %s shard %d: resume cursor %d beyond %d "
                    "records" % (self.name, shard, max(cursor, floor),
                                 records))
            if floor > cursor:
                renewed = self._renew(epoch, shard, floor)
                if not renewed.get("ok"):
                    profiler.io_record(lease_lost=1)
                    raise LeaseLostError(
                        "dataset %s shard %d: %s"
                        % (self.name, shard, renewed.get("lost")))
                cursor = floor
            if got.get("resumed") or floor > 0:
                profiler.io_record(resumes=1,
                                   resume_cursors={shard: cursor})
            entry = self._manifest["shards"][shard]
            if cursor >= records:
                yield ("eof", shard, records)
                continue
            reader = _open_shard(self._manifest_path, self._root, entry)
            try:
                try:
                    reader.seek(reader.idx[cursor])
                except KeyError:
                    raise ShardCorruptError(
                        "record shard %s: no index entry for cursor %d"
                        % (entry["file"], cursor))
                while cursor < records and not self._stop.is_set():
                    count = min(self._chunk, records - cursor)
                    t0 = time.monotonic()
                    raws = [_read_next(reader, self._root, entry,
                                       cursor + i)
                            for i in range(count)]
                    nbytes = sum(len(r) for r in raws)
                    profiler.io_record(
                        records=count, bytes=nbytes,
                        read_seconds=time.monotonic() - t0)
                    decoded = self._decode_chunk(
                        self._decode_jobs(epoch, shard, cursor, raws))
                    yield ("chunk", shard, cursor, decoded, nbytes)
                    cursor += count
            finally:
                reader.close()
            if cursor >= records:
                yield ("eof", shard, records)

    # -- consumer ----------------------------------------------------------
    def _source(self, epoch):
        """The marker source for one pass: the producer drained through
        a bounded queue when prefetch > 0 (read/decode overlap the
        training step), the raw generator otherwise (honest sync)."""
        from .. import profiler

        gen = self._produce_epoch(epoch)
        if self._prefetch <= 0:
            self._gen = gen
            return gen

        q = queue.Queue(maxsize=self._prefetch)
        DONE, ERROR = object(), object()

        def put_until_stop(item):
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            try:
                q.put_nowait(item)   # best-effort after stop
            except queue.Full:
                pass
            return False

        def drain():
            try:
                for marker in gen:
                    if not put_until_stop(marker):
                        gen.close()
                        return
                put_until_stop(DONE)
            except BaseException as exc:  # surfaced on the consumer
                put_until_stop((ERROR, exc))

        self._thread = threading.Thread(target=drain, daemon=True,
                                        name="mxnet-data-prefetch")
        self._thread.start()

        def consume():
            while True:
                depth = q.qsize()
                profiler.io_record(
                    queue_depth=depth,
                    prefetch_hits=1 if depth > 0 else 0,
                    prefetch_misses=0 if depth > 0 else 1)
                marker = q.get()
                if marker is DONE:
                    return
                if isinstance(marker, tuple) and marker[0] is ERROR:
                    raise marker[1]
                yield marker

        return consume()

    def epoch_records(self):
        """One pass over this worker's share of epoch ``self.epoch``:
        yields ``(shard, index, decoded_record)``, ledgering and
        committing each chunk before handing it out. On return,
        ``self.epoch`` is the next epoch to consume."""
        from .. import profiler

        if self._closed:
            raise RuntimeError("stream %s is closed" % self.name)
        epoch = self.epoch
        source = self._source(epoch)
        try:
            for marker in source:
                kind = marker[0]
                if kind == "chunk":
                    _, shard, start, decoded, _nbytes = marker
                    self._ledger_chunk(epoch, shard, start,
                                       len(decoded))
                    renewed = self._renew(epoch, shard,
                                          start + len(decoded))
                    if not renewed.get("ok"):
                        profiler.io_record(lease_lost=1)
                        raise LeaseLostError(
                            "dataset %s shard %d: %s"
                            % (self.name, shard, renewed.get("lost")))
                    for i, rec in enumerate(decoded):
                        yield shard, start + i, rec
                elif kind == "eof":
                    _, shard, records = marker
                    done = self._complete(epoch, shard, records)
                    if done.get("ok"):
                        profiler.io_record(shards_done=1)
                elif kind == "roll":
                    # possibly PAST epoch+1: a pass that joined an
                    # already-finished epoch ("behind") yields nothing
                    # and leaves self.epoch at the fleet's epoch — the
                    # caller's `while stream.epoch < N` loop decides
                    # whether another pass happens (never a phantom
                    # epoch past the caller's horizon)
                    self.epoch = marker[1]
                    profiler.io_record(epochs=1)
        finally:
            self._join_producer()

    def _join_producer(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None
            self._stop = threading.Event()
        if self._gen is not None:
            self._gen.close()
            self._gen = None

    def state(self):
        return self._auth.data_state(self.name)

    def close(self):
        """Release leases back to the pool (cursors intact) and tear
        down the prefetch thread / decode pool / ledger handle."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._join_producer()
        try:
            self._auth.data_release(self.name, self.rank)
        except (MXNetError, LeaseError, OSError):
            pass  # tracker gone at teardown must not mask the exit
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if self._ledger_file is not None:
            self._ledger_file.close()
            self._ledger_file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# DataIter adapter
# ---------------------------------------------------------------------------
class ShardedBatchIter:
    """Batch iterator over a :class:`ShardedRecordStream` speaking the
    ``io.DataIter`` contract (next/reset/provide_data/provide_label/
    batch_size), so it feeds ``parallel/feed.py``'s DeviceQueueIter
    directly. Decoded records must be ``(data, label)`` pairs; batches
    span shard boundaries and the epoch's remainder (< batch_size) is
    dropped. Per-batch input wait (time blocked assembling the batch)
    feeds the ioStats p50/p99 reservoir.

    Once an epoch ends, next() keeps raising StopIteration until
    reset() (the DataIter contract); after reset() the next call opens
    the NEXT lease-book epoch. A read-ahead consumer (DeviceQueueIter)
    that resets after its final epoch may therefore lease a chunk of an
    epoch nobody trains — those records stay resumable at the
    committed cursor because that epoch never completes."""

    def __init__(self, stream, batch_size, data_shape, label_shape=(),
                 data_name="data", label_name="softmax_label",
                 dtype=np.float32, label_dtype=np.float32):
        from ..io import DataDesc

        self.stream = stream
        self.batch_size = int(batch_size)
        self.provide_data = [DataDesc(data_name,
                                      (self.batch_size,) + tuple(data_shape),
                                      dtype)]
        self.provide_label = [DataDesc(label_name,
                                       (self.batch_size,) + tuple(label_shape),
                                       label_dtype)]
        self._records = None
        self._exhausted = False

    def __iter__(self):
        return self

    def reset(self):
        self._records = None
        self._exhausted = False

    def next(self):
        from .. import profiler
        from ..io import DataBatch

        # DataIter contract: once an epoch ends, keep raising until
        # reset() — otherwise a read-ahead consumer (DeviceQueueIter)
        # would silently lease+ledger records of an epoch nobody runs
        if self._exhausted:
            raise StopIteration
        if self._records is None:
            self._records = self.stream.epoch_records()
        t0 = time.monotonic()
        data, label = [], []
        try:
            for _shard, _idx, rec in self._records:
                d, l = rec
                data.append(d)
                label.append(l)
                if len(data) == self.batch_size:
                    break
        except BaseException:
            self._records = None
            raise
        wait = time.monotonic() - t0
        if len(data) < self.batch_size:
            self._records = None
            self._exhausted = True
            raise StopIteration
        profiler.io_record(batches=1, wait_seconds=wait,
                           wait_latencies=[wait])
        return DataBatch(data=[np.stack(data)],
                         label=[np.asarray(label)],
                         pad=0,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __next__(self):
        return self.next()

    def close(self):
        self.stream.close()
