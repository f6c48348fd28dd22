"""The port's serving fleet (``mxnet_tpu_torch/serving/fleet.py``) against
the JAX package's, on the CPU.

- The scenarios of ``tests/test_fleet.py`` (all but the chaos_check case,
  which drives the JAX package through ``tools/chaos_check.py``): knob
  validation, the typed errors, the router's retry classes over scripted
  views (drained rejections retried elsewhere, genuine failures not,
  never-sent failures retried even when not idempotent, in-flight losses
  only when idempotent, typed overload, no live replica), least-loaded
  selection with the model filter, backoff under one budget; and over
  real in-process replicas behind an in-process tracker: routing, the
  drain state machine over the wire, the in-flight-loss classification of
  a wedged replica, a rolling ``fleet_swap`` under load with zero drops,
  ``fleetStats`` in ``dump_profile`` and the static replica list. The
  SIGKILL e2e and the 1-to-3 scaling run replica processes and stay
  ``slow``, as the JAX ones are.
- Parity with the JAX package: a JAX-written checkpoint served by a
  replica process of the port (``python -m mxnet_tpu_torch.serving.fleet
  replica --device cpu``) answers as a JAX ModelServer on the same
  checkpoint; a JAX FleetRouter routes to a port ReplicaServer and a port
  router to a JAX replica with the same outputs; the router's decisions
  on scripted views (selection, the model and group filters, attempt
  deadlines and the backoff schedule under a budget on one clock, the
  retry classification and the counters) equal the JAX router's exactly.
- Chaos: ``replica:R:crash@req=N``, ``replica:R:stall@req=N``,
  ``router:drop@...`` and ``heartbeat:stall@after=N`` fire at the exact
  point the JAX engine fires them, and drive their reaction paths here.

Replicas serve a small fp32 model on the CPU (``device="cpu"``).
Tolerance fp32: rtol 1e-4, atol 1e-5 against the JAX package; decisions,
counters and schedules exact.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import serving as jserving
from mxnet_tpu import tracker as jtracker
from mxnet_tpu.serving import fleet as jfleet
from mxnet_tpu_torch import chaos, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.model import save_checkpoint
from mxnet_tpu_torch.serving import (
    DeadlineExceeded,
    FleetError,
    FleetOverloaded,
    FleetRemoteError,
    FleetRouter,
    ModelServer,
    NoLiveReplica,
    ReplicaConnectionLost,
    ReplicaDraining,
    ReplicaServer,
    ServerClosed,
    ServerOverloaded,
    ServingError,
)
from mxnet_tpu_torch.serving import fleet as tfleet
from mxnet_tpu_torch.serving.fleet import _NeverSent
from mxnet_tpu_torch.tracker import Tracker, TrackerClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.RandomState(0)
DIM = 5
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _reset_fleet_stats():
    for prof in (profiler, jprofiler):
        prof.fleet_reset()
        prof.serving_reset()
    yield
    for prof in (profiler, jprofiler):
        prof.fleet_reset()
        prof.serving_reset()


def _linear(seed=1, pkg=mx):
    rng = np.random.RandomState(seed)
    out = pkg.sym.FullyConnected(data=pkg.sym.var("data"), num_hidden=4,
                                 name="fc")
    args = {"fc_weight": rng.randn(4, DIM).astype(np.float32),
            "fc_bias": rng.randn(4).astype(np.float32)}
    return out, args


def _nd(args):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()}


def _expected(x, a):
    return x @ a["fc_weight"].T + a["fc_bias"]


def _server(sym, args, ladder=(1, 4)):
    srv = ModelServer(ladder=ladder, device="cpu")
    srv.add_model("m", symbol=sym, arg_params=args,
                  data_shapes={"data": (1, DIM)})
    srv.predict("m", np.zeros((1, DIM), np.float32))  # warm-up
    return srv


def _make_replica(tracker, sym, args, rank=None, publish_interval=0.2):
    rep = ReplicaServer(_server(sym, args), tracker_uri=tracker.addr,
                        rank=rank, publish_interval=publish_interval)
    rep.serve_in_background()
    return rep


@pytest.fixture
def fleet():
    """In-process tracker + 2 replicas serving the seed-1 linear model,
    and a fast-refresh router."""
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    sym, args = _linear(seed=1)
    reps = [_make_replica(trk, sym, args) for _ in range(2)]
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.2,
                         timeout=15.0)
    yield {"tracker": trk, "replicas": reps, "router": router,
           "sym": sym, "args": args}
    router.close()
    for rep in reps:
        rep.shutdown()
    trk.shutdown()


@pytest.fixture
def fault_spec(monkeypatch):
    def set_spec(text, **env):
        monkeypatch.setenv("MXNET_FAULT_SPEC", text)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        chaos.reset_engine()
        jchaos.reset_engine()

    yield set_spec
    monkeypatch.delenv("MXNET_FAULT_SPEC", raising=False)
    chaos.reset_engine()
    jchaos.reset_engine()


# ---------------------------------------------------------------------------
# knob validation
# ---------------------------------------------------------------------------
def test_fleet_knob_validation(monkeypatch):
    view = lambda: []  # noqa: E731
    for name, bad in [("MXNET_FLEET_RETRIES", "-1"),
                      ("MXNET_FLEET_RETRIES", "two"),
                      ("MXNET_FLEET_TIMEOUT", "0"),
                      ("MXNET_FLEET_TIMEOUT", "nan"),
                      ("MXNET_FLEET_BACKOFF", "-0.5"),
                      ("MXNET_FLEET_VIEW_INTERVAL", "0"),
                      ("MXNET_FLEET_CONNECT_DEADLINE", "abc")]:
        monkeypatch.setenv(name, bad)
        with pytest.raises(MXNetError, match=name):
            FleetRouter(view_fn=view)
        with pytest.raises(jmx.base.MXNetError, match=name):
            jfleet.FleetRouter(view_fn=view)
        monkeypatch.delenv(name)
    monkeypatch.setenv("MXNET_SERVE_DRAIN_TIMEOUT", "-3")
    srv = ModelServer(ladder=(1,), device="cpu")
    try:
        with pytest.raises(MXNetError, match="MXNET_SERVE_DRAIN_TIMEOUT"):
            ReplicaServer(srv)
    finally:
        srv.close()
    monkeypatch.delenv("MXNET_SERVE_DRAIN_TIMEOUT")
    with pytest.raises(FleetError, match="exactly one"):
        FleetRouter()
    with pytest.raises(FleetError, match="exactly one"):
        FleetRouter(view_fn=view, replicas=["127.0.0.1:1"])
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config as tconfig

    for name in ("MXNET_FLEET_RETRIES", "MXNET_FLEET_TIMEOUT",
                 "MXNET_FLEET_BACKOFF", "MXNET_FLEET_VIEW_INTERVAL",
                 "MXNET_FLEET_CONNECT_DEADLINE", "MXNET_SERVE_DRAIN_TIMEOUT"):
        assert tconfig.KNOBS[name][0] == jconfig.KNOBS[name][0], name


def test_sharded_group_raises_by_name():
    sym, args = _linear()
    srv = _server(sym, args)
    try:
        with pytest.raises(FleetError, match="item 8b"):
            ReplicaServer(srv, group="g", group_size=2, group_rank=0)
        with pytest.raises(FleetError, match="item 8b"):
            tfleet._replica_main(["--prefix", "x", "--data-shape",
                                  "data:1,5", "--group", "g",
                                  "--group-size", "2"])
        rep = ReplicaServer(srv, group="solo", group_size=1)
        assert rep._info()["group"] == "solo"
        rep.shutdown(close_server=False)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------
def test_close_fails_queued_futures_with_typed_server_closed():
    sym, args = _linear()
    srv = _server(sym, args)
    worker = srv._workers["m"]
    x = np.zeros((1, DIM), np.float32)
    with worker._exec_lock:  # wedge the worker mid-batch
        f0 = srv.submit("m", x)
        deadline = time.monotonic() + 10
        while not worker._busy and time.monotonic() < deadline:
            time.sleep(0.005)
        queued = srv.submit("m", x)  # stays queued behind the wedge
        assert srv.pending() == 2
        srv.close(timeout=0.2)
    with pytest.raises(ServerClosed):
        queued.result(timeout=30)
    with pytest.raises(ServerClosed):
        srv.submit("m", x)
    del f0
    assert issubclass(ReplicaDraining, ServerClosed)
    assert not issubclass(DeadlineExceeded, ServerClosed)
    assert not issubclass(ServerClosed, DeadlineExceeded)
    assert issubclass(ServerOverloaded, ServingError)


def _stub_router(view, forward, mod=tfleet):
    """Router over a faked view with a stubbed wire forward."""
    router = mod.FleetRouter(view_fn=lambda: view, retries=2, timeout=10.0,
                             backoff=0.0, view_interval=0.05)
    router._forward = forward
    return router


def _entry(addr, rank, state="serving", alive=True, queued=0,
           models=("m",), **group):
    info = {"state": state, "queued": queued, "models": list(models)}
    info.update(group)
    return {"addr": addr, "rank": rank, "alive": alive, "done": False,
            "node_id": rank, "info": info}


def test_drained_rejection_is_retried_but_genuine_failure_is_not():
    view = [_entry("a:1", 0), _entry("b:2", 1)]
    calls = []

    def forward(h, model, wire, attempt_timeout, remaining,
                tenant=None, priority=None):
        calls.append(h.addr)
        if h.addr == "a:1":
            raise ReplicaDraining("a:1 draining")
        return ["ok"]

    router = _stub_router(view, forward)
    assert router.request("m", np.zeros((1, DIM), np.float32)) == ["ok"]
    assert calls == ["a:1", "b:2"], "retry must pick the OTHER replica"
    assert profiler.fleet_stats()["draining_rejections"] == 1

    calls.clear()

    def forward_fail(h, model, wire, attempt_timeout, remaining,
                     tenant=None, priority=None):
        calls.append(h.addr)
        raise FleetRemoteError("bad_request", "unknown input")

    router2 = _stub_router(view, forward_fail)
    with pytest.raises(FleetRemoteError):
        router2.request("m", np.zeros((1, DIM), np.float32))
    assert len(calls) == 1, "genuine failures must never be retried"


def test_never_sent_retries_even_non_idempotent():
    view = [_entry("a:1", 0), _entry("b:2", 1)]
    calls = []

    def forward(h, model, wire, attempt_timeout, remaining,
                tenant=None, priority=None):
        calls.append(h.addr)
        if len(calls) == 1:
            raise _NeverSent("connect refused")
        return ["ok"]

    router = _stub_router(view, forward)
    out = router.request("m", np.zeros((1, DIM), np.float32),
                         idempotent=False)
    assert out == ["ok"] and len(calls) == 2
    stats = profiler.fleet_stats()
    assert stats["failovers"] == 1 and stats["failed"] == 0


def test_inflight_loss_retries_only_idempotent():
    view = [_entry("a:1", 0), _entry("b:2", 1)]
    calls = []

    def forward(h, model, wire, attempt_timeout, remaining,
                tenant=None, priority=None):
        calls.append(h.addr)
        if len(calls) == 1:
            raise ReplicaConnectionLost("sent, no reply")
        return ["ok"]

    router = _stub_router(view, forward)
    with pytest.raises(ReplicaConnectionLost):
        router.request("m", np.zeros((1, DIM), np.float32),
                       idempotent=False)
    assert len(calls) == 1, "non-idempotent in-flight loss: no retry"
    assert profiler.fleet_stats()["inflight_lost"] == 1

    calls.clear()
    router2 = _stub_router(view, forward)
    assert router2.request("m", np.zeros((1, DIM), np.float32)) == ["ok"]
    assert calls == ["a:1", "b:2"], "idempotent loss retries elsewhere"


def test_overload_raises_typed_fleet_overloaded():
    view = [_entry("a:1", 0), _entry("b:2", 1)]
    calls = []

    def forward(h, model, wire, attempt_timeout, remaining,
                tenant=None, priority=None):
        calls.append(h.addr)
        raise ServerOverloaded("queue full")

    router = _stub_router(view, forward)
    with pytest.raises(FleetOverloaded, match="retry budget"):
        router.request("m", np.zeros((1, DIM), np.float32))
    assert len(calls) == 3  # first attempt + 2 retries
    stats = profiler.fleet_stats()
    assert stats["overload_rejections"] == 3 and stats["failed"] == 1
    router2 = _stub_router(view, lambda *a, **kw: (_ for _ in ()).throw(
        DeadlineExceeded("shed at dequeue")))
    with pytest.raises(FleetOverloaded):
        router2.request("m", np.zeros((1, DIM), np.float32))


def test_no_live_replica_is_typed():
    router = _stub_router([_entry("a:1", 0, state="draining"),
                           _entry("b:2", 1, alive=False)],
                          lambda *a, **kw: ["never"])
    with pytest.raises(NoLiveReplica):
        router.request("m", np.zeros((1, DIM), np.float32))
    with pytest.raises(NoLiveReplica):
        _stub_router([], lambda *a, **kw: ["never"]).request(
            "m", np.zeros((1, DIM), np.float32))


def test_least_loaded_selection_and_model_filter():
    view = [_entry("a:1", 0, queued=5), _entry("b:2", 1, queued=1),
            _entry("c:3", 2, queued=0, state="draining"),
            _entry("d:4", 3, queued=0, alive=False),
            _entry("e:5", 4, queued=0, models=("other",))]
    calls = []

    def forward(h, model, wire, attempt_timeout, remaining,
                tenant=None, priority=None):
        calls.append(h.addr)
        return ["ok"]

    router = _stub_router(view, forward)
    router.request("m", np.zeros((1, DIM), np.float32))
    assert calls == ["b:2"]
    with router._handles["b:2"]._lock:
        router._handles["b:2"].inflight += 10
    calls.clear()
    router.request("m", np.zeros((1, DIM), np.float32))
    assert calls == ["a:1"]


def test_backoff_grows_and_respects_budget():
    view = [_entry("a:1", 0)]
    t0 = time.perf_counter()
    router = FleetRouter(view_fn=lambda: view, retries=2, timeout=10.0,
                         backoff=0.05, view_interval=0.05)
    router._forward = lambda *a, **kw: (_ for _ in ()).throw(
        ServerOverloaded("full"))
    with pytest.raises(FleetOverloaded):
        router.request("m", np.zeros((1, DIM), np.float32))
    assert time.perf_counter() - t0 >= 0.05 + 0.10
    router2 = FleetRouter(view_fn=lambda: view, retries=50, timeout=0.3,
                          backoff=0.05, view_interval=0.05)
    router2._forward = lambda *a, **kw: (_ for _ in ()).throw(
        ServerOverloaded("full"))
    t0 = time.perf_counter()
    with pytest.raises(FleetOverloaded, match="budget"):
        router2.request("m", np.zeros((1, DIM), np.float32))
    assert time.perf_counter() - t0 < 5.0


# ---------------------------------------------------------------------------
# the router's decisions against the JAX router's, on one scripted clock
# ---------------------------------------------------------------------------
class _Clock:
    """A deterministic stand-in for the fleet module's ``time``: sleeps
    advance it, and are recorded."""

    def __init__(self):
        self.t = 1000.0
        self.sleeps = []

    def monotonic(self):
        return self.t

    perf_counter = monotonic

    def sleep(self, s):
        self.sleeps.append(round(s, 9))
        self.t += s


def _decisions(mod, prof, monkeypatch, view, script, retries=2,
               timeout=10.0, backoff=0.05, idempotent=True, bump=None):
    """Run one request through ``mod``'s router over ``view`` with the
    forward's outcomes taken from ``script`` (one per attempt: "ok", or
    the name of the error to raise, each attempt taking 0.25 s of the
    clock). Returns every decision the router made."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    classes = {"never": mod._NeverSent, "lost": mod.ReplicaConnectionLost,
               "draining": mod.ReplicaDraining, "closed": mod.ServerClosed,
               "overloaded": mod.ServerOverloaded,
               "deadline": mod.DeadlineExceeded,
               "quota": mod.TenantQuotaExceeded}
    attempts = []
    outcomes = iter(script)

    def forward(h, model, wire, attempt_timeout, remaining, tenant=None,
                priority=None):
        attempts.append((h.addr, round(attempt_timeout, 9),
                         round(remaining, 9)))
        clock.t += 0.25
        what = next(outcomes)
        if what == "ok":
            return ["ok:%s" % h.addr]
        if what == "remote":
            raise mod.FleetRemoteError("bad_request", "%s: bad" % h.addr)
        raise classes[what]("%s: %s" % (h.addr, what))

    prof.fleet_reset()
    router = mod.FleetRouter(view_fn=lambda: view, retries=retries,
                             timeout=timeout, backoff=backoff,
                             view_interval=0.05, qos=None)
    router._forward = forward
    if bump:
        for addr, n in bump.items():
            router._handles[addr].inflight += n
    try:
        out = ("ok", router.request("m", np.zeros((1, DIM), np.float32),
                                    idempotent=idempotent))
    except Exception as e:
        out = ("raise", type(e).__name__, str(e))
    stats = prof.fleet_stats()
    stats.pop("p50_ms", None)
    stats.pop("p99_ms", None)
    cooled = sorted(h.addr for h in router._handles.values()
                    if h.cooldown_until > clock.t)
    states = sorted((h.addr, h.state) for h in router._handles.values())
    router.close()
    return {"out": out, "attempts": attempts, "sleeps": clock.sleeps,
            "stats": stats, "cooled": cooled, "states": states}


_VIEW = [_entry("a:1", 0, queued=3), _entry("b:2", 1, queued=1),
         _entry("c:3", 2, queued=1), _entry("d:4", 3, state="draining"),
         _entry("e:5", 4, alive=False), _entry("f:6", 5, models=("x",)),
         _entry("g:7", 6, group="G", group_size=2, group_rank=0),
         _entry("h:8", 7, group="G", group_size=2, group_rank=1),
         _entry("i:9", 8, group="H", group_size=2, group_rank=0),
         _entry("j:10", 9, group="H", group_size=2, group_rank=1,
                state="draining")]

SCRIPTS = [
    ("least_loaded", dict(script=["ok"])),
    ("bumped", dict(script=["ok"], bump={"b:2": 5, "c:3": 5, "g:7": 5})),
    ("never_sent", dict(script=["never", "ok"], idempotent=False)),
    ("lost_idempotent", dict(script=["lost", "ok"])),
    ("lost_not_idempotent", dict(script=["lost"], idempotent=False)),
    ("draining_closed", dict(script=["draining", "closed", "ok"])),
    ("overload_exhausted", dict(script=["overloaded", "deadline",
                                        "overloaded"])),
    ("remote_error", dict(script=["remote"])),
    ("quota", dict(script=["quota"])),
    ("never_exhausted", dict(script=["never", "never", "never"])),
    ("lost_exhausted", dict(script=["lost", "lost", "lost"])),
    ("backoff_budget", dict(script=["overloaded"] * 20, retries=19,
                            timeout=2.0, backoff=0.1)),
    ("backoff_cap", dict(script=["overloaded"] * 8, retries=7,
                         timeout=30.0, backoff=0.2)),
]


@pytest.mark.parametrize("name,case", SCRIPTS, ids=[s[0] for s in SCRIPTS])
def test_router_decisions_equal_the_jax_router(monkeypatch, name, case):
    got = {}
    for pkg, mod, prof in (("port", tfleet, profiler),
                           ("jax", jfleet, jprofiler)):
        got[pkg] = _decisions(mod, prof, monkeypatch, _VIEW, **case)
    assert got["port"] == got["jax"]
    assert got["port"]["attempts"]   # the case made a decision


# ---------------------------------------------------------------------------
# the real thing: in-process replicas behind an in-process tracker
# ---------------------------------------------------------------------------
def test_fleet_routes_and_matches_reference(fleet):
    router, args = fleet["router"], fleet["args"]
    for rows in (1, 3):
        x = RNG.randn(rows, DIM).astype(np.float32)
        out = router.request("m", x)
        np.testing.assert_allclose(out[0], _expected(x, args), **TOL)
    stats = profiler.fleet_stats()
    assert stats["completed"] == 2 and stats["failed"] == 0
    assert stats["replicas_alive"] == 2


def test_drain_state_machine_over_the_wire(fleet):
    router, reps = fleet["router"], fleet["replicas"]
    rep0 = reps[0]
    worker = rep0._server._workers["m"]
    x = RNG.randn(1, DIM).astype(np.float32)
    drain_done = []
    with worker._exec_lock:  # holds rep0's batch mid-execution
        fut = rep0._server.submit("m", x)
        deadline = time.monotonic() + 10
        while not worker._busy and time.monotonic() < deadline:
            time.sleep(0.005)
        t = threading.Thread(
            target=lambda: drain_done.append(router.drain(rep0.addr)))
        t.start()
        deadline = time.monotonic() + 10
        while rep0._state != "draining" and time.monotonic() < deadline:
            time.sleep(0.005)
        assert rep0._state == "draining"
        assert not drain_done, "drain must wait for in-flight work"
        with pytest.raises(ReplicaDraining):
            router._admin_rpc(rep0.addr, "predict", {
                "model": "m",
                "inputs": {"__single__":
                           ("float32", (1, DIM), x.tobytes())}})
    t.join(timeout=30)
    assert drain_done == [{"state": "drained"}]
    fut.result(timeout=30)  # in-flight work finished, not dropped
    for _ in range(4):
        router.request("m", x)
    assert profiler.fleet_stats()["failed"] == 0
    router.resume(rep0.addr)
    assert rep0._state == "serving"
    assert router.replica_stats(rep0.addr)["info"]["state"] == "serving"


def test_wire_inflight_loss_classification(fleet):
    router, reps = fleet["router"], fleet["replicas"]
    locks = [rep._server._workers["m"]._exec_lock for rep in reps]
    x = RNG.randn(1, DIM).astype(np.float32)
    for lk in locks:
        lk.acquire()
    try:
        with pytest.raises(ReplicaConnectionLost):
            router.request("m", x, timeout=1.5, idempotent=False)
    finally:
        for lk in locks:
            lk.release()
    assert profiler.fleet_stats()["inflight_lost"] >= 1
    router.request("m", x)


def test_rolling_fleet_swap_zero_drop(fleet, tmp_path):
    router, sym = fleet["router"], fleet["sym"]
    args1 = fleet["args"]
    _, args2 = _linear(seed=7)
    prefix = str(tmp_path / "v2")
    save_checkpoint(prefix, 3, sym, _nd(args2), {})
    collected, errors = [], []

    def client(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(25):
                x = rng.randn(rng.randint(1, 4), DIM).astype(np.float32)
                collected.append((x, router.request("m", x)))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(40 + i,))
               for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while len(collected) < 10 and time.monotonic() < deadline:
        time.sleep(0.005)
    swapped = router.fleet_swap(prefix=prefix, epoch=3)
    for t in threads:
        t.join(timeout=60)
    assert swapped == 2
    assert not errors, errors
    assert len(collected) == 100  # zero dropped
    n_new = 0
    for x, res in collected:
        if not np.allclose(res[0], _expected(x, args1), atol=1e-4):
            np.testing.assert_allclose(res[0], _expected(x, args2),
                                       rtol=1e-4, atol=1e-4)
            n_new += 1
    assert n_new > 0, "the swap landed while traffic flowed"
    x = RNG.randn(2, DIM).astype(np.float32)
    np.testing.assert_allclose(router.request("m", x)[0],
                               _expected(x, args2), rtol=1e-4, atol=1e-4)
    stats = profiler.fleet_stats()
    assert stats["swaps"] == 2 and stats["failed"] == 0
    router.refresh_view(force=True)
    with router._view_lock:
        gens = [h.info.get("swap_gen") for h in router._handles.values()]
    assert gens == [1, 1]


def test_fleet_stats_ride_dump_profile(fleet, tmp_path):
    router = fleet["router"]
    router.request("m", RNG.randn(1, DIM).astype(np.float32))
    fname = str(tmp_path / "trace.json")
    profiler.set_config(filename=fname)
    try:
        profiler.dump_profile()
    finally:
        profiler.set_config()
    with open(fname) as f:
        stats = json.load(f)["fleetStats"]
    assert stats["requests"] == 1 and stats["completed"] == 1
    assert "p50_ms" in stats and stats["replicas_alive"] == 2


def test_static_replica_list_discovery(fleet):
    reps = fleet["replicas"]
    router = FleetRouter(replicas=[r.addr for r in reps],
                         view_interval=0.1, timeout=10.0)
    try:
        x = RNG.randn(2, DIM).astype(np.float32)
        np.testing.assert_allclose(router.request("m", x)[0],
                                   _expected(x, fleet["args"]), **TOL)
        reps[0].drain()
        time.sleep(0.15)
        router.refresh_view(force=True)
        states = dict((a, s) for a, s, _al, _l in router.replicas())
        assert states[reps[0].addr] == "drained"
        router.request("m", x)  # still routable via replica 1
        reps[0].resume()
    finally:
        router.close()


# ---------------------------------------------------------------------------
# parity with the JAX package over the shared wire
# ---------------------------------------------------------------------------
def _jax_replica(trk, seed=1):
    sym, args = _linear(seed=seed, pkg=jmx)
    srv = jserving.ModelServer(ladder=(1, 4))
    srv.add_model("m", symbol=sym, arg_params=args,
                  data_shapes={"data": (1, DIM)})
    srv.predict("m", np.zeros((1, DIM), np.float32))
    rep = jserving.ReplicaServer(srv, tracker_uri=trk.addr,
                                 publish_interval=0.2)
    rep.serve_in_background()
    return rep, args


def test_routers_and_replicas_of_both_packages_interoperate():
    """A port tracker holds one port and one JAX replica of the same
    weights; a port router and a JAX router each route to both (drain
    one, then the other) with the same outputs, and each package's
    router drives the other's admin ops."""
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    sym, args = _linear(seed=1)
    port_rep = _make_replica(trk, sym, args)
    jax_rep, jargs = _jax_replica(trk, seed=1)
    routers = {"port": FleetRouter(tracker_uri=trk.addr, view_interval=0.2,
                                   timeout=15.0),
               "jax": jfleet.FleetRouter(tracker_uri=trk.addr,
                                         view_interval=0.2, timeout=15.0)}
    try:
        x = RNG.randn(3, DIM).astype(np.float32)
        ref = _expected(x, args)
        for name, router in routers.items():
            other = routers["jax" if name == "port" else "port"]
            for drained in (jax_rep, port_rep):   # route to the other one
                other.drain(drained.addr)
                router.refresh_view(force=True)
                out = router.request("m", x)
                np.testing.assert_allclose(out[0], ref, **TOL)
                other.resume(drained.addr)
            stats = router.replica_stats(jax_rep.addr)
            assert stats["info"]["state"] == "serving"
        assert profiler.fleet_stats()["completed"] == 2
        assert jprofiler.fleet_stats()["completed"] == 2
    finally:
        for r in routers.values():
            r.close()
        port_rep.shutdown()
        jax_rep.shutdown()
        trk.shutdown()


def _bench_mlp(pkg, dim=16, hidden=32, layers=2, classes=4, seed=0):
    """``tools/bench_serve.py``'s build_model in either package."""
    net = pkg.sym.var("data")
    for i in range(layers):
        net = pkg.sym.Activation(
            pkg.sym.FullyConnected(data=net, num_hidden=hidden,
                                   name="fc%d" % i), act_type="relu")
    net = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(data=net, num_hidden=classes, name="head"),
        name="softmax")
    arg_shapes, _, _ = net.infer_shape(data=(1, dim))
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * 0.05).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    return net, args


def _spawn_port_replica(coord, prefix, dim, rank, extra_env=None,
                        extra_args=()):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    host, port = coord.rsplit(":", 1)
    env.update({"DMLC_ROLE": "replica", "DMLC_REPLICA_ID": str(rank),
                "DMLC_PS_ROOT_URI": host, "DMLC_PS_ROOT_PORT": port,
                "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")})
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving.fleet", "replica",
         "--prefix", prefix, "--epoch", "0", "--data-shape",
         "data:1,%d" % dim, "--ladder", "1,4", "--device", "cpu",
         *extra_args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_serving(router, n, seconds=90):
    deadline = time.monotonic() + seconds
    while True:
        router.refresh_view(force=True)
        if sum(1 for _a, s, alive, _l in router.replicas()
               if alive and s == "serving") >= n:
            return
        assert time.monotonic() < deadline, router.replicas()
        time.sleep(0.2)


def test_port_replica_process_serves_a_jax_checkpoint(tmp_path):
    """The JAX package writes the checkpoint; ``python -m
    mxnet_tpu_torch.serving.fleet replica --device cpu`` serves it behind
    a port tracker; routed answers equal a JAX ModelServer's on the same
    checkpoint, and ``stop_fleet`` ends the process with status 0."""
    from mxnet_tpu.model import load_checkpoint as jload
    from mxnet_tpu.model import save_checkpoint as jsave

    sym, args = _bench_mlp(jmx)
    prefix = str(tmp_path / "jax_mlp")
    jsave(prefix, 0, sym, {k: jmx.nd.array(v) for k, v in args.items()}, {})
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=5.0)
    trk.serve_in_background()
    proc = _spawn_port_replica(trk.addr, prefix, 16, 0)
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.2,
                         timeout=20.0)
    try:
        _wait_serving(router, 1)
        jsym, jargs, jauxs = jload(prefix, 0)
        jsrv = jserving.ModelServer(ladder=(1, 4))
        jsrv.add_model("model", symbol=jsym, arg_params=jargs,
                       aux_params=jauxs, data_shapes={"data": (1, 16)})
        try:
            for rows in (1, 3, 4):
                x = RNG.randn(rows, 16).astype(np.float32)
                got = router.request("model", x)[0]
                want = jsrv.predict("model", x)[0]
                np.testing.assert_allclose(got, np.asarray(want), **TOL)
        finally:
            jsrv.close()
        info = router.replica_stats(router.replicas()[0][0])["info"]
        assert info["models"] == ["model"] and info["ladder"] == [1, 4]
        assert router.stop_fleet() == 1
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "replica rank=0 listening on" in out
    finally:
        router.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        trk.shutdown()


# ---------------------------------------------------------------------------
# chaos: each fleet hook fires where the JAX engine fires it
# ---------------------------------------------------------------------------
def _engine_trace(mod, spec, role, rank, restart, calls):
    """Drive ``mod``'s ChaosEngine through ``calls`` (hook names) and
    record each return and each injected exit."""
    eng = mod.ChaosEngine(spec, role=role, rank=rank, restart=restart)
    exits = []
    eng._exit = exits.append
    out = []
    for call in calls:
        if call == "replica":
            out.append(("replica", eng.replica_request(), len(exits)))
        elif call in ("send", "reply"):
            out.append((call, eng.router_drop(phase=call), len(exits)))
        elif call == "beat":
            out.append(("beat", eng.heartbeat(), len(exits)))
        elif call == "tick":
            eng.autoscaler_tick()
            out.append(("tick", None, len(exits)))
    return out, exits, [r.fired for r in eng.rules]


ENGINE_CASES = [
    ("replica:1:crash@req=3", "replica", 1, 0, ["replica"] * 6),
    ("replica:1:crash@req=3", "replica", 0, 0, ["replica"] * 4),
    ("replica:1:crash@req=2", "replica", 1, 1, ["replica"] * 4),
    ("replica:1:crash@req=2,restart=1", "replica", 1, 1, ["replica"] * 4),
    ("replica:0:stall@req=3", "replica", 0, 2, ["replica"] * 6),
    ("replica:0:stall@req=1", "worker", 0, 0, ["replica"] * 2),
    ("router:drop@n=2", "worker", 0, 0, ["send", "reply", "send", "send"]),
    ("router:drop@n=1,phase=reply", "worker", 0, 0,
     ["send", "reply", "reply"]),
    ("router:drop@p=0.5,seed=7", "worker", 0, 0, ["send"] * 12),
    ("heartbeat:stall@after=3", "worker", 0, 0, ["beat"] * 6),
    ("autoscaler:crash@tick=3", "worker", 0, 5, ["tick"] * 5),
    ("replica:0:stall@req=2;router:drop@n=1;heartbeat:stall@after=1",
     "replica", 0, 0, ["replica", "send", "beat", "replica", "beat",
                       "send"]),
]


@pytest.mark.parametrize("spec,role,rank,restart,calls", ENGINE_CASES,
                         ids=["%s-%s%d-r%d" % c[:4] for c in ENGINE_CASES])
def test_fleet_hooks_fire_where_the_jax_engine_fires(spec, role, rank,
                                                     restart, calls):
    assert [(r.target, r.rank, r.action, r.params)
            for r in chaos.parse_spec(spec)] == \
        [(r.target, r.rank, r.action, r.params)
         for r in jchaos.parse_spec(spec)]
    port = _engine_trace(chaos, spec, role, rank, restart, calls)
    assert port == _engine_trace(jchaos, spec, role, rank, restart, calls)


def test_router_drop_chaos_drives_failover_and_inflight_loss(fleet,
                                                             fault_spec):
    router = fleet["router"]
    x = RNG.randn(2, DIM).astype(np.float32)
    fault_spec("router:drop@n=1")             # send phase: never sent
    np.testing.assert_allclose(router.request("m", x, idempotent=False)[0],
                               _expected(x, fleet["args"]), **TOL)
    assert profiler.fleet_stats()["failovers"] == 1
    fault_spec("router:drop@n=1,phase=reply")  # delivered, reply lost
    with pytest.raises(ReplicaConnectionLost):
        router.request("m", x, idempotent=False)
    fault_spec("router:drop@n=1,phase=reply")
    np.testing.assert_allclose(router.request("m", x)[0],
                               _expected(x, fleet["args"]), **TOL)
    stats = profiler.fleet_stats()
    assert stats["inflight_lost"] == 2 and stats["failed"] == 1
    assert stats["retries"] == 2


def test_replica_stall_chaos_wedges_and_the_router_fails_over(
        fault_spec, monkeypatch):
    """replica:0:stall@req=2 on a port replica of rank 0 beside a JAX
    replica (whose engine has no spec): its second admitted request
    wedges (no reply, the replica still publishes serving), the router's
    attempt deadline classifies it as an in-flight loss and the
    idempotent request is served by the JAX replica."""
    fault_spec("replica:0:stall@req=2", DMLC_ROLE="replica",
               DMLC_REPLICA_ID="0")
    monkeypatch.setattr(jchaos, "_ENGINE", None)
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    sym, args = _linear(seed=1)
    port_rep = _make_replica(trk, sym, args)          # rank 0
    jax_rep, _ = _jax_replica(trk, seed=1)            # rank 1
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.2,
                         timeout=3.0)
    try:
        x = RNG.randn(1, DIM).astype(np.float32)
        router.request("m", x)             # rank 0 wins the tie
        assert port_rep._admitted == 1
        out = router.request("m", x)       # wedged on rank 0, then rank 1
        np.testing.assert_allclose(out[0], _expected(x, args), **TOL)
        stats = profiler.fleet_stats()
        assert stats["inflight_lost"] == 1 and stats["failed"] == 0
        assert port_rep._admitted == 2
        assert port_rep._info()["state"] == "serving"
    finally:
        router.close()
        port_rep.shutdown()
        jax_rep.shutdown()
        trk.shutdown()


def test_replica_crash_chaos_exits_at_the_admitted_request(fault_spec):
    fault_spec("replica:0:crash@req=2", DMLC_ROLE="replica",
               DMLC_REPLICA_ID="0")
    exits = []

    def exit_(code):
        exits.append(code)
        raise ServerClosed("chaos exit %d" % code)

    chaos.engine()._exit = exit_
    sym, args = _linear()
    rep = ReplicaServer(_server(sym, args), publish_interval=0.2)
    rep.serve_in_background()
    router = FleetRouter(replicas=[rep.addr], view_interval=0.1,
                         timeout=5.0, retries=0)
    try:
        x = RNG.randn(1, DIM).astype(np.float32)
        router.request("m", x)
        assert exits == []
        with pytest.raises(FleetError, match="chaos exit 137"):
            router.request("m", x)
        assert exits == [137]
        router.refresh_view(force=True)
        router.request("m", x)             # fires once an incarnation
        assert exits == [137]
    finally:
        router.close()
        rep.shutdown()


def test_heartbeat_stall_chaos_is_caught_by_the_tracker(fault_spec,
                                                        monkeypatch):
    fault_spec("heartbeat:stall@after=2")
    monkeypatch.setattr(jchaos, "_ENGINE", None)
    trk = Tracker(num_workers=2, num_servers=0, heartbeat_timeout=2.0)
    trk.serve_in_background()
    try:
        w0 = TrackerClient(trk.addr, "worker", heartbeat_interval=0.1)
        w1 = jtracker.TrackerClient(trk.addr, "worker",
                                    heartbeat_interval=0.1)
        deadline = time.monotonic() + 8
        while w1.num_dead_node() != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        # the port client (whose beats stalled) is dead; the JAX client,
        # with no fault spec in its engine, beats on
        assert w1.num_dead_node() == 1
        dead = [n for n in w1.nodes() if not n["alive"]]
        assert [n["rank"] for n in dead] == [w0.rank]
        w0.close()
        w1.close()
    finally:
        trk.shutdown()


# ---------------------------------------------------------------------------
# slow tier: replica processes
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_fleet_e2e_sigkill_and_rolling_swap(tmp_path):
    """1 router / 3 port replica processes (``--device cpu``) under
    threaded load: a replica SIGKILL costs nothing beyond retried
    in-flight requests, and a rolling fleet_swap under load completes
    with zero drops."""
    import signal

    sym, args1 = _linear(seed=1)
    _, args2 = _linear(seed=7)
    prefix1, prefix2 = str(tmp_path / "v1"), str(tmp_path / "v2")
    save_checkpoint(prefix1, 0, sym, _nd(args1), {})
    save_checkpoint(prefix2, 0, sym, _nd(args2), {})
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    procs = [_spawn_port_replica(trk.addr, prefix1, DIM, r)
             for r in range(3)]
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.3,
                         timeout=20.0)
    try:
        _wait_serving(router, 3, 120)
        stop = threading.Event()
        collected, errors = [], []

        def client(seed):
            rng = np.random.RandomState(seed)
            while not stop.is_set():
                x = rng.randn(rng.randint(1, 4), DIM).astype(np.float32)
                try:
                    collected.append((x, router.request("model", x)))
                except Exception as e:
                    errors.append("%s: %s" % (type(e).__name__, e))

        threads = [threading.Thread(target=client, args=(60 + i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while len(collected) < 50 and time.monotonic() < deadline:
            time.sleep(0.01)
        procs[2].send_signal(signal.SIGKILL)
        n_at_kill = len(collected)
        deadline = time.monotonic() + 30
        while len(collected) < n_at_kill + 100 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not errors, errors[:3]
        assert router.fleet_swap(prefix=prefix2, epoch=0) == 2
        n_at_swap = len(collected)
        deadline = time.monotonic() + 30
        while len(collected) < n_at_swap + 30 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:3]
        n_old = n_new = 0
        for x, res in collected:
            if np.allclose(res[0], _expected(x, args1), atol=1e-4):
                n_old += 1
            else:
                np.testing.assert_allclose(res[0], _expected(x, args2),
                                           rtol=1e-4, atol=1e-4)
                n_new += 1
        assert n_old > 0 and n_new > 0
        stats = profiler.fleet_stats()
        assert stats["failed"] == 0
        assert stats["failovers"] + stats["inflight_lost"] >= 1
    finally:
        try:
            router.stop_fleet()
        except Exception:
            pass
        router.close()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        trk.shutdown()


@pytest.mark.slow
def test_fleet_scaling_1_to_3(tmp_path):
    """Closed-loop throughput at 1 and 3 port replica processes on the
    CPU (one core and one intra-op thread each): zero failures, and more
    requests/s at 3 than at 1 where the host has the cores for it. The
    JAX test's 2.5x bar is not held here: 16 client threads in one router
    process measured ~1.9-2.5x on a shared 8-core host (the router's
    host, not the replicas, bounds it); the card's numbers, with no
    target, come from chip_smoke.py's fleet phase."""
    cores = len(os.sched_getaffinity(0)) \
        if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
    if cores < 4:
        pytest.skip("1->3 replica-process scaling needs >= 4 cores, host "
                    "has %d" % cores)
    sym, args = _bench_mlp(mx, dim=64, hidden=1024, layers=4, classes=16)
    prefix = str(tmp_path / "mlp")
    save_checkpoint(prefix, 0, sym, _nd(args), {})
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=5.0)
    trk.serve_in_background()
    procs = []
    rates = {}
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.2,
                         timeout=20.0)
    try:
        for n in (1, 3):
            while len(procs) < n:
                # one core and one intra-op thread a replica: the
                # replicas, not one replica's thread pool, spread over
                # the cores
                procs.append(_spawn_port_replica(
                    trk.addr, prefix, 64, len(procs),
                    extra_env={"OMP_NUM_THREADS": "1"},
                    extra_args=("--pin-core", str(len(procs) + 1))))
            _wait_serving(router, n, 120)
            done, errors = [0], []
            stop_at = time.monotonic() + 5.0

            def client(seed):
                x = np.random.RandomState(seed).randn(4, 64) \
                    .astype(np.float32)
                while time.monotonic() < stop_at:
                    try:
                        router.request("model", x)
                        done[0] += 1
                    except Exception as e:
                        errors.append(e)

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not errors, errors[:3]
            rates[n] = done[0] / 5.0
        print("fleet scaling on %d cores: %s requests/s" % (cores, rates))
        assert rates[3] > rates[1], rates
    finally:
        router.stop_fleet()
        router.close()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        trk.shutdown()
