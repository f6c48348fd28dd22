"""Sharding record writer + manifest loader for the dataset service
(counterpart of ``mxnet_tpu/data/writer.py``: byte-identical shards and
manifests).

``write_record_shards`` splits a record list into ``num_shards``
contiguous record files (``recordio.py`` packs with ``.idx`` sidecars
so a resume cursor seeks in O(1)) and publishes an atomic JSON
manifest next to them. ``load_manifest`` is the read side, with the
schedule-table 5-way corruption matrix: missing file, garbage JSON,
top level not an object, version mismatch, malformed shard entry —
each is logged and raised as :class:`ManifestCorruptError`, never
silently skipped.

Shard files are written to a tmp name and ``os.replace``d into place,
so concurrent *deterministic* writers (every worker of a launch.py
job producing the identical dataset, the recommender example does
this) race benignly: last rename wins with byte-identical content.
"""
from __future__ import annotations

import json
import logging
import os

from .. import recordio
from ..tune.table import atomic_write_bytes
from .errors import ManifestCorruptError

log = logging.getLogger("mxnet_tpu_torch.data")

MANIFEST_VERSION = 1


def manifest_path(out_dir, name):
    return os.path.join(os.fspath(out_dir), "%s.manifest.json" % name)


def write_record_shards(out_dir, name, records, num_shards=None):
    """Write ``records`` (a list of ``bytes``) as ``name-%05d-of-%05d.rec``
    shard files under ``out_dir`` plus the dataset manifest. Records are
    split into contiguous blocks so shard ``i`` holds a stable,
    reproducible slice; ``num_shards`` defaults to the
    ``MXNET_DATA_SHARDS`` knob, capped at ``len(records)`` so no shard
    is empty. Returns the manifest path."""
    from .. import config

    if num_shards is None:
        num_shards = config.get_positive_int("MXNET_DATA_SHARDS")
    if not records:
        raise ValueError("write_record_shards: dataset %r has no records"
                         % name)
    for i, rec in enumerate(records):
        if not isinstance(rec, (bytes, bytearray)):
            raise TypeError(
                "write_record_shards: record %d of dataset %r is %s, "
                "expected bytes" % (i, name, type(rec).__name__))
    num_shards = max(1, min(int(num_shards), len(records)))
    out_dir = os.fspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)

    base, extra = divmod(len(records), num_shards)
    shards = []
    start = 0
    for i in range(num_shards):
        count = base + (1 if i < extra else 0)
        block = records[start:start + count]
        start += count
        fname = "%s-%05d-of-%05d.rec" % (name, i, num_shards)
        path = os.path.join(out_dir, fname)
        tmp_rec = path + ".tmp"
        tmp_idx = path + ".idx.tmp"
        writer = recordio.MXIndexedRecordIO(tmp_idx, tmp_rec, "w")
        try:
            for j, rec in enumerate(block):
                writer.write_idx(j, bytes(rec))
        finally:
            writer.close()
        os.replace(tmp_rec, path)
        os.replace(tmp_idx, path + ".idx")
        shards.append({"file": fname, "records": len(block),
                       "bytes": sum(len(r) for r in block)})

    manifest = {"version": MANIFEST_VERSION, "dataset": str(name),
                "shards": shards,
                "total_records": len(records)}
    mpath = manifest_path(out_dir, name)
    atomic_write_bytes(mpath, json.dumps(manifest, indent=1).encode("utf-8"))
    return mpath


def _corrupt(path, why):
    log.warning("data manifest %s: %s", path, why)
    raise ManifestCorruptError("data manifest %s: %s" % (path, why))


def load_manifest(path):
    """Read and validate a dataset manifest (the 5-way matrix)."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        _corrupt(path, "unreadable (%s)" % e)
    try:
        manifest = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        _corrupt(path, "not valid JSON (%s)" % e)
    if not isinstance(manifest, dict):
        _corrupt(path, "top level is %s, expected an object"
                 % type(manifest).__name__)
    if manifest.get("version") != MANIFEST_VERSION:
        _corrupt(path, "version %r != %d"
                 % (manifest.get("version"), MANIFEST_VERSION))
    shards = manifest.get("shards")
    if not isinstance(shards, list) or not shards:
        _corrupt(path, "shards is %r, expected a non-empty list" % (shards,))
    for i, s in enumerate(shards):
        if not isinstance(s, dict) \
                or not isinstance(s.get("file"), str) \
                or isinstance(s.get("records"), bool) \
                or not isinstance(s.get("records"), int) \
                or s["records"] < 0:
            _corrupt(path, "malformed shard entry %d: %r" % (i, s))
    if not isinstance(manifest.get("dataset"), str):
        _corrupt(path, "dataset name is %r, expected a string"
                 % (manifest.get("dataset"),))
    return manifest
