"""The port's sharded dataset service (``mxnet_tpu_torch.data``) against
the JAX package's (``mxnet_tpu.data``), scenario by scenario from
tests/test_data_plane.py: lease-book transcripts, shard files and
manifests, the corruption matrix, exactly-once epochs, mid-epoch handoff,
deterministic decode under rebalance, the batch iterator, ioStats and the
knobs. Every comparison is exact. With a tracker topology in the
environment the stream leases through the port's tracker (the lease ops
against the JAX tracker's are in tests/test_torch_tracker.py)."""
import hashlib
import json
import os
import struct
from functools import partial

import numpy as np
import pytest

import mxnet_tpu.data as jdata
import mxnet_tpu_torch.data as tdata
from mxnet_tpu import profiler as jprof
from mxnet_tpu.data import service as jservice
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import service as tservice

PKG = {"jax": (jdata, jservice, jprof), "torch": (tdata, tservice, tprof)}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _records(n=48, payload=8, seed=0):
    rng = np.random.RandomState(seed)
    return [struct.pack("<i", i) + rng.bytes(payload) for i in range(n)]


def _dataset(pkg, root, n=48, num_shards=4, name="ds"):
    os.makedirs(root, exist_ok=True)
    return PKG[pkg][0].write_record_shards(str(root), name, _records(n),
                                           num_shards=num_shards)


def decode_index(raw, seed):
    """The record's global index (its first 4 bytes)."""
    return struct.unpack_from("<i", raw, 0)[0]


def _stream(pkg, mpath, auth, rank=0, **kw):
    kw.setdefault("decode", decode_index)
    kw.setdefault("workers", 0)
    kw.setdefault("prefetch", 0)
    kw.setdefault("chunk", 4)
    return PKG[pkg][0].ShardedRecordStream(mpath, lease_client=auth,
                                           rank=rank, **kw)


def _outcome(fn):
    """``("ok", value)`` or ``("raise", class name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the transcript records it
        return ("raise", type(e).__name__, str(e))


def _both(fn):
    """``fn(pkg)`` for both packages; asserts the results are equal and
    returns the port's."""
    out = {pkg: fn(pkg) for pkg in PKG}
    assert out["torch"] == out["jax"]
    return out["torch"]


# ---------------------------------------------------------------------------
# lease book
# ---------------------------------------------------------------------------
def _book_script(pkg):
    """A scripted sequence of every book op, errors included: the return
    value (or exception) and the snapshot after each step."""
    book = PKG[pkg][0].ShardLeaseBook("ds", [10, 10, 4], 5.0)
    steps = [
        lambda: book.acquire(0, 0, now=0.0),
        lambda: book.acquire(1, 0, now=0.0),
        lambda: book.renew(1, 0, 1, 7, now=1.0),
        lambda: book.renew(1, 0, 1, 3, now=1.0),          # backwards
        lambda: book.renew(1, 0, 1, 11, now=1.0),         # out of range
        lambda: book.renew(0, 0, 1, 8, now=1.0),          # not the owner
        lambda: book.release_owner(1, now=1.0),
        lambda: book.acquire(1, 0, now=1.0),              # its own back
        lambda: book.renew(0, 0, 0, 4, now=2.0),
        lambda: book.acquire(2, 0, now=100.0),            # expires, steals
        lambda: book.renew(0, 0, 0, 5, now=101.0),        # lost
        lambda: book.expire(now=200.0),
        lambda: book.acquire(2, 0, now=200.0),
        lambda: book.complete(2, 0, 2, 2, now=200.0),     # partial
        lambda: book.renew(2, 0, 2, 4, now=200.0),
        lambda: book.complete(2, 0, 2, 4, now=200.0),
        lambda: book.complete(2, 0, 2, 4, now=200.0),     # idempotent
        lambda: book.acquire(3, 1, now=200.0),            # future epoch
        lambda: book.acquire(3, -1, now=200.0),
        lambda: book.renew(3, 0, 9, 0, now=200.0),        # bad shard id
    ]
    out = []
    for step in steps:
        out.append(_outcome(step))
        out.append(book.snapshot())
    # finish the epoch and roll it
    for shard in (0, 1):
        snap = book.snapshot()["shards"][shard]
        owner = snap["owner"]
        if owner is None:
            lease = book.acquire(5, 0, now=300.0)
            owner, shard = 5, lease["shard"]
        book.renew(owner, 0, shard, 10, now=300.0)
        out.append(_outcome(lambda: book.complete(owner, 0, shard, 10,
                                                  now=300.0)))
    out += [_outcome(lambda: book.acquire(0, 0, now=300.0)),
            _outcome(lambda: book.acquire(0, 1, now=300.0)),
            _outcome(lambda: book.acquire(1, 0, now=300.0)),
            book.snapshot(), book.rebalances, book.record_counts()]
    return out


def test_lease_book_transcript_matches_jax():
    out = _both(_book_script)
    assert ("raise", "LeaseError") == out[6][:2]      # moved backwards
    assert any(o[0] == "ok" and isinstance(o[1], dict)
               and o[1].get("rebalanced") for o in out[::2][:20])


@pytest.mark.parametrize("counts,ttl", [([], 5.0), ([10, -1], 5.0),
                                        ([10, True], 5.0), ([10], 0.0)])
def test_book_registration_errors_match_jax(counts, ttl):
    got = _both(lambda pkg: _outcome(
        lambda: PKG[pkg][0].ShardLeaseBook("ds", counts, ttl)))
    assert got[0] == "raise" and got[1] == "LeaseError"


def test_local_authority_transcript_matches_jax():
    def script(pkg):
        auth = PKG[pkg][0].LocalLeaseAuthority(ttl=30.0)
        out = [auth.data_init("ds", [3, 2]), auth.data_init("ds", [3, 2]),
               _outcome(lambda: auth.data_init("ds", [3, 3])),
               _outcome(lambda: auth.data_acquire("nope", 0, 0))]
        a = auth.data_acquire("ds", 0, 0)
        out += [a, auth.data_renew("ds", 0, 0, a["shard"], 2),
                auth.data_release("ds", 0),
                auth.data_acquire("ds", 1, 0)]
        state = auth.data_state("ds")
        for s in state["shards"]:
            s.pop("deadline")                 # wall clock
        return out + [state]

    _both(script)


# ---------------------------------------------------------------------------
# writer, manifests and the corruption matrix
# ---------------------------------------------------------------------------
def test_shards_and_manifest_byte_identical(tmp_path):
    recs = _records(23)
    paths = {pkg: PKG[pkg][0].write_record_shards(
        str(tmp_path / pkg), "rt", recs, num_shards=3) for pkg in PKG}
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch"))
    assert len(files) == 7               # 3 shards, 3 indexes, 1 manifest
    for name in files:
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "torch" / name, "rb") as b:
            assert a.read() == b.read(), name
    # each package reads the other's dataset
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        got = [raw for _s, _i, raw in
               PKG[reader][0].iter_manifest_records(paths[writer])]
        assert got == recs
        assert PKG[reader][0].load_manifest(paths[writer]) == \
            PKG[writer][0].load_manifest(paths[writer])
    assert tdata.manifest_path("a", "b") == jdata.manifest_path("a", "b")


def _manifest_case(case, mpath, root):
    with open(mpath) as f:
        good = json.load(f)
    text = {"not_json": "{not json",
            "not_object": json.dumps([1, 2]),
            "version": json.dumps(dict(good, version=99)),
            "shard_entry": json.dumps(dict(good, shards=[{"file": "x"}])),
            "dataset_name": json.dumps(dict(good, dataset=7))}.get(case)
    if case == "missing":
        return os.path.join(root, "nope.manifest.json")
    with open(mpath, "w") as f:
        f.write(text)
    return mpath


def _shard_file(mpath, root, i=0):
    with open(mpath) as f:
        return os.path.join(root, json.load(f)["shards"][i]["file"])


def _corrupt_truncate(mpath, root):
    rec = _shard_file(mpath, root)
    with open(rec, "r+b") as f:
        f.truncate(os.path.getsize(rec) // 2)


def _corrupt_magic(mpath, root):
    rec = _shard_file(mpath, root)
    with open(rec + ".idx") as f:
        offsets = [int(line.split("\t")[1]) for line in f if line.strip()]
    with open(rec, "r+b") as f:
        f.seek(offsets[1])
        f.write(b"\xde\xad\xbe\xef")


def _corrupt_index(mpath, root):
    idx = _shard_file(mpath, root) + ".idx"
    with open(idx) as f:
        lines = f.readlines()
    with open(idx, "w") as f:
        f.writelines(lines[:-1])


@pytest.mark.parametrize("case", ["missing", "not_json", "not_object",
                                  "version", "shard_entry", "dataset_name"])
def test_manifest_corruption_raises_same_class(tmp_path, case):
    def run(pkg):
        root = str(tmp_path / pkg)
        mpath = _manifest_case(case, _dataset(pkg, root), root)
        got = _outcome(lambda: _stream(
            pkg, mpath, PKG[pkg][0].LocalLeaseAuthority(ttl=5.0)))
        return got[:2], got[2].replace(root, "<root>")

    (kind, cls), _msg = _both(run)
    assert (kind, cls) == ("raise", "ManifestCorruptError")
    assert issubclass(tdata.ManifestCorruptError, tdata.DataPlaneError)
    assert issubclass(tdata.DataPlaneError, MXNetError)


@pytest.mark.parametrize("corrupt,match", [
    (_corrupt_truncate, "truncated|EOF|index"),
    (_corrupt_magic, "garbage"),
    (_corrupt_index, "promises")], ids=["truncated", "magic", "stale_idx"])
def test_shard_corruption_raises_same_class(tmp_path, corrupt, match):
    def run(pkg):
        root = str(tmp_path / pkg)
        mpath = _dataset(pkg, root, n=24, num_shards=2)
        corrupt(mpath, root)
        got = _outcome(lambda: list(PKG[pkg][0].iter_manifest_records(
            mpath)))
        return got[:2], got

    # the JAX package may read through its native runtime, whose reader
    # words the garbage-magic cause differently: the classes must agree
    out = {pkg: run(pkg) for pkg in PKG}
    assert out["torch"][0] == out["jax"][0] == ("raise", "ShardCorruptError")
    with pytest.raises(tdata.ShardCorruptError, match=match):
        raise tdata.ShardCorruptError(out["torch"][1][2])


@pytest.mark.parametrize("ledger,want", [
    ("0\tnot-an-int\tx\n", "CursorCorruptError"),
    ("0\t0\t999\n", "CursorCorruptError")], ids=["garbled", "beyond"])
def test_ledger_faults_raise_same_class(tmp_path, ledger, want):
    def run(pkg):
        root = str(tmp_path / pkg)
        mpath = _dataset(pkg, root, n=16, num_shards=2)
        ldir = os.path.join(root, "ledger")
        os.makedirs(ldir)
        with open(os.path.join(ldir, "old.ledger"), "w") as f:
            f.write(ledger)
        stream = _stream(pkg, mpath,
                         PKG[pkg][0].LocalLeaseAuthority(ttl=5.0),
                         ledger_dir=ldir)
        try:
            got = _outcome(lambda: list(stream.epoch_records()))
        finally:
            stream.close()
        return got[:2]

    assert _both(run) == ("raise", want)


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------
def test_epoch_exactly_once_matches_jax(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        mpath = _dataset(pkg, root)
        ldir = os.path.join(root, "ledger")
        stream = _stream(pkg, mpath,
                         PKG[pkg][0].LocalLeaseAuthority(ttl=30.0),
                         ledger_dir=ldir)
        try:
            got = list(stream.epoch_records())
            epoch = stream.epoch
        finally:
            stream.close()
        return got, epoch, PKG[pkg][0].merge_ledgers(ldir)

    got, epoch, counts = _both(run)
    assert sorted(r for _s, _i, r in got) == list(range(48))
    assert epoch == 1 and len(counts) == 48 and set(counts.values()) == {1}


def test_mid_epoch_handoff_resumes_at_cursor(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        mpath = _dataset(pkg, root)
        ldir = os.path.join(root, "ledger")
        auth = PKG[pkg][0].LocalLeaseAuthority(ttl=30.0)
        a = _stream(pkg, mpath, auth, rank=0, ledger_dir=ldir)
        it = a.epoch_records()
        first = [next(it) for _ in range(20)]
        it.close()
        a.close()
        b = _stream(pkg, mpath, auth, rank=1, ledger_dir=ldir)
        try:
            rest = list(b.epoch_records())
            epoch = b.epoch
        finally:
            b.close()
        return first, rest, epoch, PKG[pkg][0].merge_ledgers(ldir)

    first, rest, epoch, counts = _both(run)
    assert epoch == 1 and len(counts) == 48 and set(counts.values()) == {1}
    assert sorted(r for _s, _i, r in first + rest) == list(range(48))


def test_caller_epoch_loop_never_runs_phantom_epochs(tmp_path):
    def run(pkg):
        mpath = _dataset(pkg, str(tmp_path / pkg), n=16, num_shards=2)
        stream = _stream(pkg, mpath,
                         PKG[pkg][0].LocalLeaseAuthority(ttl=30.0))
        seen = []
        try:
            while stream.epoch < 3:
                seen.append(list(stream.epoch_records()))
        finally:
            stream.close()
        return seen, stream.epoch

    seen, epoch = _both(run)
    assert epoch == 3 and sum(len(s) for s in seen) == 48


def test_record_seed_matches_jax():
    pos = [(e, s, i, salt) for e in (0, 1, 70000) for s in (0, 5, 65537)
           for i in (0, 17, 2 ** 32 + 3) for salt in (0, 0x0101)]
    assert [tdata.record_seed(*p) for p in pos] == \
        [jdata.record_seed(*p) for p in pos]


def _image_dataset(pkg, root, n=32, shape=(3, 8, 8), num_shards=4):
    rng = np.random.RandomState(3)
    px = int(np.prod(shape))
    recs = [struct.pack("<f", float(i))
            + rng.randint(0, 256, px, dtype=np.uint8).tobytes()
            for i in range(n)]
    os.makedirs(root, exist_ok=True)
    return PKG[pkg][0].write_record_shards(root, "imgs", recs,
                                           num_shards=num_shards)


def _digest(shard, idx, rec):
    img, label = rec
    return (shard, idx), hashlib.sha1(
        img.tobytes() + np.float32(label).tobytes()).hexdigest()


def test_deterministic_decode_matches_jax_under_rebalance(tmp_path):
    """A full single-owner pass and a pass split across a mid-epoch handoff
    decode to the same bytes in both packages (the seed-driven flip of
    ``decode_image_f32`` is the probe)."""
    def run(pkg):
        mpath = _image_dataset(pkg, str(tmp_path / pkg))
        decode = partial(PKG[pkg][1].decode_image_f32, shape=(3, 8, 8))
        full = _stream(pkg, mpath, PKG[pkg][0].LocalLeaseAuthority(ttl=30.0),
                       decode=decode, deterministic=True)
        try:
            want = dict(_digest(*r) for r in full.epoch_records())
        finally:
            full.close()
        auth = PKG[pkg][0].LocalLeaseAuthority(ttl=30.0)
        a = _stream(pkg, mpath, auth, rank=0, decode=decode,
                    deterministic=True)
        it = a.epoch_records()
        got = dict(_digest(*next(it)) for _ in range(16))
        it.close()
        a.close()
        b = _stream(pkg, mpath, auth, rank=1, decode=decode,
                    deterministic=True)
        try:
            got.update(_digest(*r) for r in b.epoch_records())
        finally:
            b.close()
        assert got == want
        return want

    assert len(_both(run)) == 32


def test_nondeterministic_mode_salts_by_worker(tmp_path):
    def run(pkg):
        mpath = _image_dataset(pkg, str(tmp_path / pkg))
        decode = partial(PKG[pkg][1].decode_image_f32, shape=(3, 8, 8))

        def hashes(rank, deterministic):
            s = _stream(pkg, mpath,
                        PKG[pkg][0].LocalLeaseAuthority(ttl=30.0),
                        rank=rank, decode=decode,
                        deterministic=deterministic)
            try:
                return dict(_digest(*r) for r in s.epoch_records())
            finally:
                s.close()

        return [hashes(r, d) for r in (0, 1) for d in (True, False)]

    det0, nondet0, det1, nondet1 = _both(run)
    assert det0 == det1 and nondet0 != nondet1


def test_decode_pool_and_prefetch_match_sync_read(tmp_path):
    """``workers=2`` (a spawn process pool) and ``prefetch=3`` give the
    bytes of the synchronous read, and the JAX stream's."""
    def run(pkg, workers, prefetch):
        mpath = _image_dataset(pkg, str(tmp_path / pkg))
        decode = partial(PKG[pkg][1].decode_image_f32, shape=(3, 8, 8))
        s = _stream(pkg, mpath, PKG[pkg][0].LocalLeaseAuthority(ttl=30.0),
                    decode=decode, workers=workers, prefetch=prefetch,
                    chunk=8)
        try:
            return [_digest(*r) for r in s.epoch_records()]
        finally:
            s.close()

    want = run("jax", 0, 0)
    assert run("torch", 0, 0) == want
    assert run("torch", 2, 3) == want


def test_batch_iter_contract_matches_jax(tmp_path):
    def decode_pair(raw, seed):
        return (np.full((3,), float(decode_index(raw, seed)),
                        dtype=np.float32), 1.0)

    def run(pkg):
        mpath = _dataset(pkg, str(tmp_path / pkg), n=22, num_shards=2)
        stream = _stream(pkg, mpath,
                         PKG[pkg][0].LocalLeaseAuthority(ttl=30.0),
                         decode=decode_pair)
        it = PKG[pkg][0].ShardedBatchIter(stream, 8, (3,))
        out = [tuple(d.shape for d in it.provide_data + it.provide_label)]
        try:
            for _epoch in range(2):
                out.append([(b.data[0].tobytes(), b.label[0].tobytes(),
                             b.data[0].dtype.str, b.label[0].dtype.str,
                             b.pad) for b in it])
                out.append(_outcome(lambda: next(it))[:2])
                out.append(stream.epoch)
                it.reset()
        finally:
            it.close()
        return out

    out = _both(run)
    assert out[0] == ((8, 3), (8,))
    assert len(out[1]) == 2 and out[3] == 1 and out[6] == 2


# ---------------------------------------------------------------------------
# ioStats
# ---------------------------------------------------------------------------
_IO_EXACT = ("records", "bytes", "batches", "decode_tasks", "leases",
             "lease_lost", "rebalanced_leases", "shards_done", "epochs",
             "resumes")


def test_io_stats_keys_match_jax(tmp_path):
    def run(pkg):
        prof = PKG[pkg][2]
        mpath = _dataset(pkg, str(tmp_path / pkg))
        prof.io_reset()
        stream = _stream(pkg, mpath,
                         PKG[pkg][0].LocalLeaseAuthority(ttl=30.0),
                         prefetch=2, decode=lambda raw, seed: (
                             np.zeros(2, np.float32), 0.0))
        it = PKG[pkg][0].ShardedBatchIter(stream, 8, (2,))
        try:
            n = sum(1 for _ in it)
            st = prof.io_stats()
        finally:
            it.close()
            prof.io_reset()
        return n, sorted(st), {k: st[k] for k in _IO_EXACT if k in st}

    n, keys, exact = _both(run)
    assert n == 6 and exact["records"] == 48 and exact["epochs"] == 1
    assert "input_wait_p99_ms" in keys and "prefetch_hit_rate" in keys


def test_io_record_strict_and_derivations_match_jax(tmp_path):
    def run(pkg):
        prof = PKG[pkg][2]
        prof.io_reset()
        try:
            prof.io_record(records=10, bytes=100, prefetch_hits=3,
                           prefetch_misses=1, wait_seconds=0.25,
                           wait_latencies=[0.1, 0.15, 0.3],
                           queue_depth=5, resume_cursors={2: 64})
            bad = _outcome(lambda: prof.io_record(recrods=1))
            st = prof.io_stats()
        finally:
            prof.io_reset()
        return bad, st, prof.io_stats()

    bad, st, empty = _both(run)
    assert bad[:2] == ("raise", "ValueError") and empty == {}
    assert st["prefetch_hit_rate"] == 0.75
    assert st["resume_cursors"] == {"2": 64}
    path = str(tmp_path / "profile.json")
    tprof.io_reset()
    try:
        tprof.io_record(records=4, leases=1, epochs=1)
        tprof.set_config(filename=path)
        tprof.dump_profile()
        want = tprof.io_stats()
    finally:
        tprof.set_config()
        tprof.io_reset()
    with open(path) as f:
        payload = json.load(f)
    assert payload["ioStats"] == want
    assert payload["ioStats"]["records"] == 4


# ---------------------------------------------------------------------------
# knobs and the configured tracker
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knob,bad", [
    ("MXNET_DATA_WORKERS", "nope"),
    ("MXNET_DATA_PREFETCH", "-3"),
    ("MXNET_DATA_DETERMINISTIC", "maybe")])
def test_malformed_data_knobs_raise_as_jax(tmp_path, monkeypatch, knob, bad):
    monkeypatch.setenv(knob, bad)

    def run(pkg):
        mpath = _dataset(pkg, str(tmp_path / pkg))
        return _outcome(lambda: PKG[pkg][0].ShardedRecordStream(
            mpath, lease_client=PKG[pkg][0].LocalLeaseAuthority(ttl=5.0),
            rank=0, decode=decode_index))

    got = _both(run)
    assert got[:2] == ("raise", "MXNetError") and knob in got[2]


@pytest.mark.parametrize("knob,bad,call", [
    ("MXNET_DATA_LEASE_TTL", "0", "ttl"),
    ("MXNET_DATA_LEASE_TTL", "nan", "ttl"),
    ("MXNET_DATA_SHARDS", "0", "shards")])
def test_malformed_ttl_and_shards_raise_as_jax(tmp_path, monkeypatch, knob,
                                               bad, call):
    monkeypatch.setenv(knob, bad)

    def run(pkg):
        data = PKG[pkg][0]
        if call == "ttl":
            return _outcome(lambda: data.LocalLeaseAuthority().data_init(
                "ds", [4, 4]))
        return _outcome(lambda: data.write_record_shards(
            str(tmp_path / pkg), "k", _records(8)))

    got = _both(run)
    assert got[:2] == ("raise", "MXNetError") and knob in got[2]


def test_knob_defaults_match_jax():
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config as tconfig

    for name in ("MXNET_DATA_SHARDS", "MXNET_DATA_WORKERS",
                 "MXNET_DATA_PREFETCH", "MXNET_DATA_DETERMINISTIC",
                 "MXNET_DATA_LEASE_TTL", "MXNET_TPU_FEED_DEPTH"):
        assert tconfig.get(name) == jconfig.get(name) == \
            jconfig.KNOBS[name][0]


def test_configured_tracker_raises_by_name(tmp_path, monkeypatch):
    """With a tracker topology in the environment and no ``lease_client``
    the stream leases through ``tracker.worker_client()`` (as the JAX
    package does) and reads every record once; the tracker refuses, by
    name, the same dataset registered with other shard counts. Without a
    topology the stream uses a local book."""
    from mxnet_tpu import tracker as jtracker
    from mxnet_tpu_torch import tracker

    mpath = _dataset("torch", str(tmp_path))
    trk = tracker.Tracker(num_workers=1, num_servers=1)
    trk.serve_in_background()
    host, port = trk.addr.rsplit(":", 1)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", host)
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", port)
    monkeypatch.setenv("DMLC_NUM_SERVER", "1")
    monkeypatch.setattr(tracker, "_WORKER_CLIENT", None)
    assert tservice.tracker_env_spec() == jtracker.tracker_env_spec()
    try:
        s = tdata.ShardedRecordStream(mpath, decode=decode_index,
                                      workers=0, prefetch=0)
        try:
            assert isinstance(s._auth, tracker.TrackerClient)
            assert s.rank == s._auth.rank == 0
            assert sorted(r for _s, _i, r in s.epoch_records()) == \
                list(range(48))
            with pytest.raises(tracker.TrackerError,
                               match="different shard counts"):
                s._auth.data_init(s.name, [1, 2, 3])
        finally:
            s.close()
            s._auth.close()
    finally:
        trk.shutdown()
    monkeypatch.setenv("DMLC_NUM_SERVER", "0")
    monkeypatch.setattr(tracker, "_WORKER_CLIENT", None)
    s = tdata.ShardedRecordStream(mpath, decode=decode_index, workers=0,
                                  prefetch=0)
    try:
        assert isinstance(s._auth, tdata.LocalLeaseAuthority)
        assert sorted(r for _s, _i, r in s.epoch_records()) == \
            list(range(48))
    finally:
        s.close()
