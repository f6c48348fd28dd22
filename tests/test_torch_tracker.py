"""The port's scheduler (``mxnet_tpu_torch/tracker.py``) against the JAX
package's, on the CPU.

- The 24 scenarios of ``tests/test_tracker.py`` against the port's
  ``Tracker`` and ``TrackerClient``: ranks per role and the slot-free
  ``replica`` role, publish/members, the server-URI rendezvous, bounded
  connect backoff, dead nodes by dropped connection and by heartbeat
  loss, barriers (completing, aborted by a dead peer, timing out), the
  ``done`` fan-out to the servers, the env contract, the validated
  ``MXNET_TRACKER_*`` knobs, elastic respawn (takeover, the rendezvous
  waiting for it, the elastic barrier, the deferred fan-out, the restart
  budget, a done node's takeover) and the lifecycle log.
- The wire both ways: a JAX ``TrackerClient`` registers, publishes,
  heartbeats and reaches a barrier with a port ``Tracker``, and a port
  client does the same with a JAX ``Tracker``.
- The data-lease ops: one scripted sequence of ``data_*`` calls gives the
  same leases, cursors and book snapshots through either package's
  tracker; the port's tracker rebalances a dead worker's shard at its
  committed cursor; ``ShardedRecordStream`` under a tracker topology
  reads every record once an epoch, over two ranks, through the port's
  tracker.

Every tracker is in-process on ``127.0.0.1:0``, every wait bounded.
Lease results, cursors and snapshots are compared exactly (the lease
deadlines, clock readings, excepted).
"""
import os
import socket
import threading
import time

import pytest

from mxnet_tpu import tracker as jtracker
from mxnet_tpu_torch import tracker as ttracker
from mxnet_tpu_torch.tracker import (Tracker, TrackerClient, TrackerError,
                                     connect_with_backoff, tracker_env_spec)


@pytest.fixture
def tracker():
    trk = Tracker(num_workers=2, num_servers=1, heartbeat_timeout=10.0)
    trk.serve_in_background()
    yield trk
    trk.shutdown()


def _wait_until(pred, deadline=5.0):
    end = time.monotonic() + deadline
    while not pred() and time.monotonic() < end:
        time.sleep(0.05)
    assert pred()


def _free_addr():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = "%s:%d" % sock.getsockname()[:2]
    sock.close()
    return addr


# ---------------------------------------------------------------------------
# the scenarios of tests/test_tracker.py
# ---------------------------------------------------------------------------
def test_register_assigns_ranks_per_role(tracker):
    w0 = TrackerClient(tracker.addr, "worker")
    w1 = TrackerClient(tracker.addr, "worker")
    s0 = TrackerClient(tracker.addr, "server", addr="127.0.0.1:7777")
    assert (w0.rank, w1.rank) == (0, 1)
    assert s0.rank == 0
    assert w0.num_workers == 2 and w0.num_servers == 1
    with pytest.raises(TrackerError, match="already assigned"):
        TrackerClient(tracker.addr, "worker")
    for c in (w0, w1, s0):
        c.close()


def test_replica_role_is_slot_free(tracker):
    reps = [TrackerClient(tracker.addr, "replica",
                          addr="127.0.0.1:%d" % (9000 + i))
            for i in range(3)]  # more replicas than worker slots (2)
    assert [r.rank for r in reps] == [0, 1, 2]
    w0 = TrackerClient(tracker.addr, "worker")
    w1 = TrackerClient(tracker.addr, "worker")
    assert (w0.rank, w1.rank) == (0, 1)
    with pytest.raises(TrackerError, match="already assigned"):
        TrackerClient(tracker.addr, "worker")
    reps[2].close()  # conn drop => dead
    _wait_until(lambda: any(not m["alive"]
                            for m in w0.members("replica")), 10.0)
    assert w0.num_dead_node() == 0  # replica deaths excluded
    for c in (reps[0], reps[1], w0, w1):
        c.close()


def test_replica_publish_and_members_roundtrip(tracker):
    r = TrackerClient(tracker.addr, "replica", addr="127.0.0.1:9100",
                      info={"state": "serving", "queued": 0})
    w = TrackerClient(tracker.addr, "worker")
    (m,) = w.members("replica")
    assert m["addr"] == "127.0.0.1:9100"
    assert m["info"] == {"state": "serving", "queued": 0}
    r.publish({"state": "draining", "queued": 7})
    (m,) = w.members("replica")
    assert m["info"] == {"state": "draining", "queued": 7}
    assert w.members("worker")[0]["info"] == {}
    with pytest.raises(TrackerError, match="info must be a dict"):
        r._rpc("publish", {"node_id": r.node_id, "info": [1, 2]})
    with pytest.raises(TrackerError, match="bad role"):
        TrackerClient(tracker.addr, "scheduler")
    for c in (r, w):
        c.close()


def test_server_uri_publication_blocks_until_rendezvous(tracker):
    w = TrackerClient(tracker.addr, "worker")
    got = {}

    def fetch():
        got["uris"] = w.get_server_uris(timeout=10.0)

    t = threading.Thread(target=fetch)
    t.start()
    time.sleep(0.3)  # the worker is already waiting...
    s = TrackerClient(tracker.addr, "server", addr="10.0.0.5:9000")
    t.join(timeout=10)
    assert not t.is_alive()
    assert got["uris"] == ["10.0.0.5:9000"]
    w.close()
    s.close()


def test_connect_backoff_tolerates_late_scheduler():
    addr = _free_addr()   # nothing listening yet
    box = {}

    def late_start():
        time.sleep(0.5)
        host, port = addr.rsplit(":", 1)
        box["trk"] = Tracker(host=host, port=int(port), num_workers=1,
                             num_servers=0)
        box["trk"].serve_in_background()

    t = threading.Thread(target=late_start)
    t.start()
    try:
        c = TrackerClient(addr, "worker", connect_deadline=10.0)
        assert c.rank == 0
        c.close()
    finally:
        t.join(timeout=10)
        box["trk"].shutdown()


def test_connect_backoff_is_bounded():
    addr = _free_addr()
    t0 = time.monotonic()
    with pytest.raises(TrackerError, match="could not connect"):
        connect_with_backoff(addr, deadline=0.6)
    assert time.monotonic() - t0 < 10


def test_dead_node_detection_on_connection_drop(tracker):
    w0 = TrackerClient(tracker.addr, "worker")
    w1 = TrackerClient(tracker.addr, "worker")
    assert w0.num_dead_node() == 0
    w1.close()  # both connections drop, no "done" sent
    _wait_until(lambda: w0.num_dead_node() == 1)
    w0.close()


def test_dead_node_detection_on_heartbeat_loss():
    trk = Tracker(num_workers=2, num_servers=0, heartbeat_timeout=1.0)
    trk.serve_in_background()
    try:
        w0 = TrackerClient(trk.addr, "worker", heartbeat_interval=0.2)
        w1 = TrackerClient(trk.addr, "worker", heartbeat_interval=30.0)
        _wait_until(lambda: w0.num_dead_node() == 1, 6.0)
        w0.close()
        w1.close()
    finally:
        trk.shutdown()


def test_barrier_completes_across_workers(tracker):
    w0 = TrackerClient(tracker.addr, "worker")
    w1 = TrackerClient(tracker.addr, "worker")
    done = []

    def arrive(c):
        c.barrier("b1", timeout=10.0)
        done.append(c.rank)

    ts = [threading.Thread(target=arrive, args=(c,)) for c in (w0, w1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert sorted(done) == [0, 1]
    w0.close()
    w1.close()


def test_barrier_recovers_when_peer_dies(tracker):
    w0 = TrackerClient(tracker.addr, "worker")
    w1 = TrackerClient(tracker.addr, "worker")
    err = {}

    def arrive():
        try:
            w0.barrier("doomed", timeout=30.0)
        except TrackerError as e:
            err["e"] = str(e)

    t = threading.Thread(target=arrive)
    t.start()
    time.sleep(0.4)      # w0 waits inside the barrier...
    w1.close()           # ...when its peer is killed
    t.join(timeout=10)
    assert not t.is_alive(), "survivor still spinning after peer death"
    assert "died" in err["e"], err
    w0.close()


def test_barrier_overall_timeout_raises(tracker):
    w0 = TrackerClient(tracker.addr, "worker")
    t0 = time.monotonic()
    with pytest.raises(TrackerError, match="timed out"):
        w0.barrier("alone", timeout=1.0)
    assert time.monotonic() - t0 < 8
    w0.close()


def test_done_fans_out_server_shutdown():
    """When every worker reports done, the scheduler sends the server
    tier's ``stop`` to each registered server (a port KVStoreServer) and
    exits."""
    from mxnet_tpu_torch.kvstore_server import KVStoreServer

    trk = Tracker(num_workers=1, num_servers=1)
    serve_thread = trk.serve_in_background()
    srv = KVStoreServer(device="cpu")
    srv_thread = threading.Thread(target=srv.serve_forever)
    srv_thread.start()
    s = TrackerClient(trk.addr, "server", addr=srv.addr)
    w = TrackerClient(trk.addr, "worker")
    try:
        assert w.get_server_uris(timeout=10.0) == [srv.addr]
        w.done()
        srv_thread.join(timeout=10)
        assert not srv_thread.is_alive(), "fan-out never stopped the server"
        serve_thread.join(timeout=10)
        assert not serve_thread.is_alive(), "tracker kept running"
    finally:
        w.close()
        s.close()
        if srv_thread.is_alive():
            srv.shutdown()
        trk.shutdown()


def test_tracker_env_spec_contract(monkeypatch):
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    monkeypatch.delenv("DMLC_NUM_SERVER", raising=False)
    assert tracker_env_spec() is None
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "10.1.1.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9091")
    assert tracker_env_spec() is None, "no servers => no scheduler topology"
    monkeypatch.setenv("DMLC_NUM_SERVER", "2")
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    assert tracker_env_spec() == ("10.1.1.1:9091", 4, 2) == \
        jtracker.tracker_env_spec()


def test_env_knob_validation_fails_loudly(monkeypatch):
    """A malformed MXNET_TRACKER_* or MXNET_MAX_RESTARTS raises (the
    port reads them through config.py's getters, defaults from its
    registry), and both packages refuse and accept the same values."""
    from mxnet_tpu_torch.tracker import env_nonneg_int, env_positive_float

    name = "MXNET_TRACKER_HEARTBEAT_INTERVAL"
    for bad in ("abc", "0", "-3", "nan", "inf"):
        monkeypatch.setenv(name, bad)
        with pytest.raises(TrackerError, match="MXNET_TRACKER_HEARTBEAT"):
            env_positive_float(name)
        with pytest.raises(jtracker.TrackerError):
            jtracker.env_positive_float(name, 2.0)
    monkeypatch.setenv(name, "1.5")
    assert env_positive_float(name) == 1.5
    monkeypatch.delenv(name)
    assert env_positive_float(name) == 2.0 == \
        jtracker.env_positive_float(name, 2.0)
    for bad in ("x", "-1", "2.5"):
        monkeypatch.setenv("MXNET_MAX_RESTARTS", bad)
        with pytest.raises(TrackerError, match="MXNET_MAX_RESTARTS"):
            env_nonneg_int("MXNET_MAX_RESTARTS")
        with pytest.raises(jtracker.TrackerError):
            jtracker.env_nonneg_int("MXNET_MAX_RESTARTS", 0)
    monkeypatch.setenv("MXNET_MAX_RESTARTS", "0")
    assert env_nonneg_int("MXNET_MAX_RESTARTS") == 0


def test_client_rejects_bad_heartbeat_env_before_connecting(monkeypatch,
                                                            tracker):
    monkeypatch.setenv("MXNET_TRACKER_HEARTBEAT_INTERVAL", "-1")
    with pytest.raises(TrackerError, match="MXNET_TRACKER_HEARTBEAT"):
        TrackerClient(tracker.addr, "worker")
    monkeypatch.delenv("MXNET_TRACKER_HEARTBEAT_INTERVAL")
    assert not tracker._nodes, "a half-registered node was left behind"


def test_barrier_rejects_bad_timeout_env(monkeypatch, tracker):
    w = TrackerClient(tracker.addr, "worker")
    monkeypatch.setenv("MXNET_TRACKER_BARRIER_TIMEOUT", "bogus")
    with pytest.raises(TrackerError, match="MXNET_TRACKER_BARRIER"):
        w.barrier("b")
    w.close()


def test_respawn_takes_over_dead_rank_and_updates_uri():
    trk = Tracker(num_workers=1, num_servers=1, max_restarts=1)
    trk.serve_in_background()
    try:
        s0 = TrackerClient(trk.addr, "server", addr="127.0.0.1:1111",
                           rank=0)
        w = TrackerClient(trk.addr, "worker", rank=0)
        assert w.get_server_uris(timeout=5.0) == ["127.0.0.1:1111"]
        s0.close()
        _wait_until(lambda: w.num_dead_node() == 1)
        s1 = TrackerClient(trk.addr, "server", addr="127.0.0.1:2222",
                           rank=0, restart_count=1)
        assert s1.rank == 0
        assert w.num_dead_node() == 0, "replaced node still counted dead"
        assert w.get_server_uris(timeout=5.0) == ["127.0.0.1:2222"]
        w.close()
        s1.close()
    finally:
        trk.shutdown()


def test_register_alive_rank_conflict_raises(tracker):
    w0 = TrackerClient(tracker.addr, "worker", rank=0)
    with pytest.raises(TrackerError, match="already registered and alive"):
        TrackerClient(tracker.addr, "worker", rank=0)
    w0.close()


def test_get_servers_waits_for_respawn_instead_of_raising():
    trk = Tracker(num_workers=1, num_servers=1, max_restarts=1)
    trk.serve_in_background()
    try:
        s0 = TrackerClient(trk.addr, "server", addr="127.0.0.1:1111",
                           rank=0)
        w = TrackerClient(trk.addr, "worker")
        s0.close()
        _wait_until(lambda: w.num_dead_node() == 1)
        got = {}

        def fetch():
            got["uris"] = w.get_server_uris(timeout=15.0)

        t = threading.Thread(target=fetch)
        t.start()
        time.sleep(0.5)
        assert t.is_alive(), "must wait for the respawn, not raise"
        s1 = TrackerClient(trk.addr, "server", addr="127.0.0.1:2222",
                           rank=0, restart_count=1)
        t.join(timeout=10)
        assert not t.is_alive()
        assert got["uris"] == ["127.0.0.1:2222"]
        w.close()
        s1.close()
    finally:
        trk.shutdown()


def test_elastic_barrier_waits_for_respawned_peer():
    trk = Tracker(num_workers=2, num_servers=0, max_restarts=1)
    trk.serve_in_background()
    try:
        w0 = TrackerClient(trk.addr, "worker", rank=0)
        w1 = TrackerClient(trk.addr, "worker", rank=1)
        outcome = {}

        def arrive():
            try:
                w0.barrier("elastic", timeout=20.0)
                outcome["ok"] = True
            except TrackerError as e:
                outcome["err"] = str(e)

        t = threading.Thread(target=arrive)
        t.start()
        time.sleep(0.4)          # w0 waits inside the barrier...
        w1.close()               # ...its peer dies (no done sent)
        time.sleep(1.0)          # dead detection + would-be abort window
        assert t.is_alive(), "elastic barrier must keep waiting"
        w1b = TrackerClient(trk.addr, "worker", rank=1, restart_count=1)
        w1b.barrier("elastic", timeout=20.0)   # the respawn re-arrives
        t.join(timeout=10)
        assert outcome == {"ok": True}, outcome
        w0.close()
        w1b.close()
    finally:
        trk.shutdown()


def test_elastic_defers_shutdown_fanout_until_respawn_done():
    trk = Tracker(num_workers=2, num_servers=0, max_restarts=1)
    trk.serve_in_background()
    try:
        w0 = TrackerClient(trk.addr, "worker", rank=0)
        w1 = TrackerClient(trk.addr, "worker", rank=1)
        w0.done()
        w1.close()  # crash, respawn pending
        _wait_until(lambda: w0.num_dead_node() == 1)
        time.sleep(0.3)
        assert not trk._fanned_out, "fan-out fired during respawn window"
        w1b = TrackerClient(trk.addr, "worker", rank=1, restart_count=1)
        w1b.done()
        _wait_until(lambda: trk._fanned_out)
        w0.close()
        w1b.close()
    finally:
        trk.shutdown()


def test_exhausted_restart_budget_restores_fail_fast():
    trk = Tracker(num_workers=2, num_servers=0, max_restarts=1)
    trk.serve_in_background()
    try:
        w0 = TrackerClient(trk.addr, "worker", rank=0)
        w1 = TrackerClient(trk.addr, "worker", rank=1)
        w1.close()
        _wait_until(lambda: w0.num_dead_node() == 1)
        w1b = TrackerClient(trk.addr, "worker", rank=1, restart_count=1)
        err = {}

        def arrive():
            try:
                w0.barrier("post-budget", timeout=20.0)
            except TrackerError as e:
                err["e"] = str(e)

        t = threading.Thread(target=arrive)
        t.start()
        time.sleep(0.4)
        w1b.close()  # second death: budget (1) exhausted
        t.join(timeout=10)
        assert not t.is_alive()
        assert "died" in err.get("e", ""), err
        w0.close()
    finally:
        trk.shutdown()


def test_lifecycle_timeline_logged(capsys):
    trk = Tracker(num_workers=1, num_servers=1, max_restarts=1)
    trk.serve_in_background()
    try:
        chunks = []

        def drain():
            chunks.append(capsys.readouterr().out)
            return "".join(chunks)

        s0 = TrackerClient(trk.addr, "server", addr="127.0.0.1:1111",
                           rank=0)
        s0.close()
        _wait_until(lambda: "event=dead" in drain())
        s1 = TrackerClient(trk.addr, "server", addr="127.0.0.1:2222",
                           rank=0, restart_count=1)
        s1.log_event("restored-from", ckpt="/ck/ckpt-00000003", rank=0)
        w = TrackerClient(trk.addr, "worker")
        w.done()
        time.sleep(0.3)
        out = drain()
        assert "event=registered role=server rank=0" in out
        assert "event=respawned role=server rank=0" in out
        assert "restarts_used=1/1" in out
        assert "event=restored-from" in out and "ckpt-00000003" in out
        assert "event=done role=worker" in out
        w.close()
        s1.close()
    finally:
        trk.shutdown()


def test_respawn_takes_over_done_node():
    trk = Tracker(num_workers=2, num_servers=0, max_restarts=1)
    trk.serve_in_background()
    try:
        w0 = TrackerClient(trk.addr, "worker", rank=0)
        w1 = TrackerClient(trk.addr, "worker", rank=1)
        w1.done()          # atexit ran...
        w1.close()         # ...then the process exited nonzero
        t0 = time.monotonic()
        w1b = TrackerClient(trk.addr, "worker", rank=1, restart_count=1)
        assert w1b.rank == 1
        assert time.monotonic() - t0 < 5, \
            "takeover of a done node must not sit in TAKEOVER_WAIT"
        w0.close()
        w1b.close()
    finally:
        trk.shutdown()


# ---------------------------------------------------------------------------
# the wire both ways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_clients_of_either_package_share_a_tracker(server_pkg):
    """One JAX client and one port client register with one tracker of
    either package, publish, beat past the heartbeat timeout without
    being marked dead, meet at a barrier and see each other's
    metadata."""
    mod = ttracker if server_pkg == "port" else jtracker
    trk = mod.Tracker(num_workers=2, num_servers=0, heartbeat_timeout=2.0)
    trk.serve_in_background()
    clients = []
    try:
        jc = jtracker.TrackerClient(trk.addr, "worker",
                                    heartbeat_interval=0.2)
        tc = ttracker.TrackerClient(trk.addr, "worker",
                                    heartbeat_interval=0.2)
        rep = ttracker.TrackerClient(trk.addr, "replica",
                                     addr="127.0.0.1:9300",
                                     heartbeat_interval=0.2,
                                     info={"state": "serving"})
        clients = [jc, tc, rep]
        assert sorted((jc.rank, tc.rank)) == [0, 1] and rep.rank == 0
        rep.publish({"state": "draining", "queued": 3})
        (m,) = jc.members("replica")
        assert m["info"] == {"state": "draining", "queued": 3}
        time.sleep(2.6)   # beats keep everyone alive past the timeout
        assert jc.num_dead_node() == tc.num_dead_node() == 0
        assert all(n["alive"] for n in tc.nodes())
        done = []
        ts = [threading.Thread(target=lambda c=c: (
            c.barrier("mixed", timeout=10.0), done.append(c.rank)))
            for c in (jc, tc)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=15)
        assert sorted(done) == [0, 1]
        d = tc.scale_set(desired=2, retired=[1])
        assert jc.scale_get() == d == {"role": "replica", "desired": 2,
                                       "retired": [1], "seq": 1}
    finally:
        for c in clients:
            c.close()
        trk.shutdown()


# ---------------------------------------------------------------------------
# the data-lease ops
# ---------------------------------------------------------------------------
def _lease_script(client):
    """One scripted sequence of data_* ops; every reply, the lease
    deadlines taken out of the snapshots."""
    out = []

    def call(op, *args):
        try:
            got = getattr(client, op)(*args)
        except Exception as e:   # the error text is part of the contract
            got = ("error", str(e).split(": ", 1)[-1])
        if isinstance(got, dict) and "shards" in got and \
                isinstance(got["shards"], list):
            got = dict(got, shards=[{k: v for k, v in s.items()
                                     if k != "deadline"}
                                    for s in got["shards"]])
        out.append((op, args, got))
        return got

    call("data_init", "ds", [3, 2, 4])
    call("data_init", "ds", [3, 2, 4])
    call("data_init", "ds", [3, 2, 5])
    a = call("data_acquire", "ds", 0, 0)
    b = call("data_acquire", "ds", 1, 0)
    call("data_renew", "ds", 0, 0, a["shard"], 2)
    call("data_renew", "ds", 0, 0, a["shard"], 1)          # backwards
    call("data_renew", "ds", 1, 0, b["shard"], 9)          # out of range
    call("data_release", "ds", 0)
    c = call("data_acquire", "ds", 1, 0)
    call("data_complete", "ds", 1, 0, b["shard"], 2)
    call("data_complete", "ds", 1, 0, c["shard"], 1)       # not at the end
    call("data_complete", "ds", 1, 0, c["shard"], 3)
    d = call("data_acquire", "ds", 0, 0)
    call("data_acquire", "ds", 1, 0)
    call("data_complete", "ds", 0, 0, d["shard"], 4)
    call("data_acquire", "ds", 0, 0)
    call("data_acquire", "ds", 0, 1)
    call("data_state", "ds")
    call("data_state", "nope")
    return out


def test_lease_ops_match_through_either_packages_tracker():
    got = {}
    for name, mod in (("port", ttracker), ("jax", jtracker)):
        trk = mod.Tracker(num_workers=2, num_servers=0)
        trk.serve_in_background()
        c = mod.TrackerClient(trk.addr, "worker")
        try:
            got[name] = _lease_script(c)
        finally:
            c.close()
            trk.shutdown()
    for mine, theirs in zip(got["port"], got["jax"]):
        assert mine == theirs
    assert len(got["port"]) == len(got["jax"]) == 20
    # a port client against the JAX tracker replays the same transcript
    trk = jtracker.Tracker(num_workers=2, num_servers=0)
    trk.serve_in_background()
    c = ttracker.TrackerClient(trk.addr, "worker")
    try:
        assert _lease_script(c) == got["jax"]
    finally:
        c.close()
        trk.shutdown()


def test_tracker_serves_leases_and_rebalances_on_death():
    trk = Tracker(num_workers=2, num_servers=0, heartbeat_timeout=10.0,
                  max_restarts=1)
    trk.serve_in_background()
    w0 = w1 = None
    try:
        w0 = TrackerClient(trk.addr, "worker")
        w1 = TrackerClient(trk.addr, "worker")
        assert w0.data_init("ds", [6, 6]) == {"epoch": 0, "shards": 2}
        w1.data_init("ds", [6, 6])
        with pytest.raises(TrackerError, match="different"):
            w1.data_init("ds", [6, 7])
        a = w0.data_acquire("ds", w0.rank, 0)
        b = w1.data_acquire("ds", w1.rank, 0)
        assert {a["shard"], b["shard"]} == {0, 1}
        assert w0.data_renew("ds", w0.rank, 0, a["shard"], 3)["ok"]
        w0.close()   # rank 0 dies: its shard returns at cursor 3
        w0 = None
        deadline = time.monotonic() + 10
        got = {"status": "wait"}
        while got["status"] != "lease":
            assert time.monotonic() < deadline, got
            got = w1.data_acquire("ds", w1.rank, 0)
            time.sleep(0.05)
        assert got["shard"] == a["shard"] and got["cursor"] == 3
        assert got["rebalanced"] and got["resumed"]
        assert w1.data_state("ds")["rebalances"] >= 1
    finally:
        for c in (w0, w1):
            if c is not None:
                c.close()
        trk.shutdown()


def _decode_index(raw, seed):
    return int.from_bytes(raw[:4], "little")


def test_sharded_stream_reads_each_record_once_through_the_tracker(
        tmp_path):
    """Two ranks, each a ShardedRecordStream leasing through a port
    TrackerClient, read two epochs concurrently: every record exactly
    once an epoch, by the ledger and by the records returned."""
    from mxnet_tpu_torch.data import (ShardedRecordStream, merge_ledgers,
                                      write_record_shards)

    n = 60
    mpath = write_record_shards(
        str(tmp_path / "data"), "ds",
        [i.to_bytes(4, "little") * 3 for i in range(n)], num_shards=5)
    trk = Tracker(num_workers=2, num_servers=0)
    trk.serve_in_background()
    clients = [TrackerClient(trk.addr, "worker") for _ in range(2)]
    streams = [ShardedRecordStream(mpath, lease_client=c, rank=c.rank,
                                   decode=_decode_index, workers=0,
                                   prefetch=0, chunk=4,
                                   ledger_dir=str(tmp_path / "ledger"))
               for c in clients]
    seen = {0: [], 1: []}
    errors = []

    def run(s):
        try:
            for epoch in (0, 1):
                seen[epoch] += [r for _s, _i, r in s.epoch_records()]
        except Exception as e:
            errors.append(e)

    try:
        ts = [threading.Thread(target=run, args=(s,)) for s in streams]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not errors, errors
        for epoch in (0, 1):
            assert sorted(seen[epoch]) == list(range(n)), epoch
        counts = merge_ledgers(str(tmp_path / "ledger"))
        assert len(counts) == 2 * n and set(counts.values()) == {1}
        assert [s.epoch for s in streams] == [2, 2]
    finally:
        for s in streams:
            s.close()
        for c in clients:
            c.close()
        trk.shutdown()


def test_main_serves_as_the_scheduler_process(tmp_path):
    """``python -m mxnet_tpu_torch.tracker`` from the DMLC environment:
    it listens where the environment says, a worker registers, and its
    ``done`` ends the process (the fan-out with no servers)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    host, port = _free_addr().rsplit(":", 1)
    env = dict(os.environ, DMLC_PS_ROOT_URI=host, DMLC_PS_ROOT_PORT=port,
               DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="0",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen([sys.executable, "-m", "mxnet_tpu_torch.tracker"],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        w = TrackerClient("%s:%s" % (host, port), "worker",
                          connect_deadline=60.0)
        assert w.rank == 0
        w.done()
        w.close()
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0, out
    assert "tracker listening on %s:%s" % (host, port) in out
    assert "event=done role=worker rank=0" in out
