"""The port's fleet autoscaler and multi-tenant QoS
(``mxnet_tpu_torch/serving/autoscale.py``, ``serving/qos.py``) against the
JAX package's, on the CPU.

- The scenarios of ``tests/test_autoscale.py``: knob validation and
  cross-validation, the token bucket and the tenant grammar, admission,
  the router and replica quota boundaries, the broker's priority dequeue
  and per-tenant sheds, the autoscaler's decide loop (stepped load 1 ->
  3 -> 1, hysteresis and dead band, cooldown, SLO and occupancy triggers,
  the retire race, fail-static on a members failure, adoption), the
  ``autoscaler:crash@tick=N`` hook, the tracker's scale-directive mailbox
  and the profiler families. Left out: the three launcher-fold tests
  (``tools/launch.py`` belongs to neither package) and
  ``test_clean_dist_env_strips_the_new_families`` (``test_utils.py`` is
  ROADMAP.md item 13): these tests scrub the new families from the
  environment themselves (``_scrubbed_env``).
- Exact against the JAX functions on the same inputs and the same
  ``now``: ``TokenBucket`` refills, ``parse_tenants`` (its rejections'
  messages too), ``QosPolicy.admit`` (priorities, rejections and
  ``qos_stats``), the broker's dequeue order, and ``FleetAutoscaler.tick``
  over one scripted members trace (every action, directive, admin call,
  event and counter).
- The e2e cases stay ``slow``, as in the JAX package: stepped load scales
  a fleet of port replica processes 1 -> 3 -> 1 under a controller
  process, the controller's chaos crash leaves the fleet serving, and a
  replica killed mid-drain is retired once.
"""
import os
import signal
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
from mxnet_tpu.serving import autoscale as jautoscale
from mxnet_tpu.serving import qos as jqos
from mxnet_tpu_torch import chaos, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.chaos import ChaosEngine, FaultSpecError, parse_spec
from mxnet_tpu_torch.serving import (
    AutoscaleError,
    DeadlineExceeded,
    FleetAutoscaler,
    FleetRouter,
    ModelServer,
    QosPolicy,
    ReplicaServer,
    TenantQuotaExceeded,
    TokenBucket,
)
from mxnet_tpu_torch.serving import autoscale as tautoscale
from mxnet_tpu_torch.serving import qos as tqos
from mxnet_tpu_torch.serving.qos import (DEFAULT_PRIORITY, PRIORITIES,
                                         parse_tenants)
from mxnet_tpu_torch.tracker import Tracker, TrackerClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 5


@pytest.fixture(autouse=True)
def _reset_stats():
    for prof in (profiler, jprofiler):
        prof.fleet_reset()
        prof.serving_reset()
        prof.autoscale_reset()
        prof.qos_reset()
    yield
    for prof in (profiler, jprofiler):
        prof.fleet_reset()
        prof.serving_reset()
        prof.autoscale_reset()
        prof.qos_reset()


def _scrubbed_env(**extra):
    """The environment of a spawned process with the job-topology and
    knob families stripped (the JAX package's test_utils.clean_dist_env
    is item 13), the repo on its path."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_scrubbed_env_strips_the_new_families(monkeypatch):
    monkeypatch.setenv("MXNET_FLEET_AUTOSCALE_MIN", "2")
    monkeypatch.setenv("MXNET_QOS_TENANTS", "bulk:prio=bulk")
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    env = _scrubbed_env()
    assert not any(k.startswith(("MXNET_FLEET_AUTOSCALE_", "MXNET_QOS_",
                                 "DMLC_")) for k in env)


# ---------------------------------------------------------------------------
# knob registration + strict accessors
# ---------------------------------------------------------------------------
def test_autoscale_knob_validation(monkeypatch):
    fns = dict(members_fn=lambda: [], actuate_fn=lambda d: None)
    for name, bad in [("MXNET_FLEET_AUTOSCALE_INTERVAL", "0"),
                      ("MXNET_FLEET_AUTOSCALE_MIN", "0"),
                      ("MXNET_FLEET_AUTOSCALE_MAX", "-1"),
                      ("MXNET_FLEET_AUTOSCALE_UP_LOAD", "nan"),
                      ("MXNET_FLEET_AUTOSCALE_DOWN_LOAD", "-2"),
                      ("MXNET_FLEET_AUTOSCALE_HYSTERESIS", "1.5"),
                      ("MXNET_FLEET_AUTOSCALE_COOLDOWN", "abc"),
                      ("MXNET_FLEET_AUTOSCALE_SLO_MS", "-1")]:
        monkeypatch.setenv(name, bad)
        with pytest.raises(MXNetError, match=name):
            FleetAutoscaler(**fns)
        with pytest.raises(jmx.base.MXNetError, match=name):
            jautoscale.FleetAutoscaler(**fns)
        monkeypatch.delenv(name)
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config as tconfig

    for name in jconfig.KNOBS:
        if name.startswith(("MXNET_FLEET_AUTOSCALE_", "MXNET_QOS_")):
            assert tconfig.KNOBS[name][0] == jconfig.KNOBS[name][0], name


def test_autoscale_knob_cross_validation(monkeypatch):
    fns = dict(members_fn=lambda: [], actuate_fn=lambda d: None)
    monkeypatch.setenv("MXNET_FLEET_AUTOSCALE_MIN", "5")
    monkeypatch.setenv("MXNET_FLEET_AUTOSCALE_MAX", "2")
    with pytest.raises(MXNetError, match="MXNET_FLEET_AUTOSCALE_MIN"):
        FleetAutoscaler(**fns)
    monkeypatch.delenv("MXNET_FLEET_AUTOSCALE_MIN")
    monkeypatch.delenv("MXNET_FLEET_AUTOSCALE_MAX")
    monkeypatch.setenv("MXNET_FLEET_AUTOSCALE_DOWN_LOAD", "4.0")
    monkeypatch.setenv("MXNET_FLEET_AUTOSCALE_UP_LOAD", "4.0")
    with pytest.raises(MXNetError, match="DOWN_LOAD"):
        FleetAutoscaler(**fns)
    monkeypatch.delenv("MXNET_FLEET_AUTOSCALE_DOWN_LOAD")
    monkeypatch.delenv("MXNET_FLEET_AUTOSCALE_UP_LOAD")
    with pytest.raises(AutoscaleError):
        FleetAutoscaler(min_replicas=3, max_replicas=1, **fns)
    with pytest.raises(AutoscaleError):
        FleetAutoscaler()  # neither tracker_uri nor test seams


def test_qos_knob_validation(monkeypatch):
    monkeypatch.setenv("MXNET_QOS_BURST_SECONDS", "0")
    with pytest.raises(MXNetError, match="MXNET_QOS_BURST_SECONDS"):
        QosPolicy(tenants={})
    monkeypatch.delenv("MXNET_QOS_BURST_SECONDS")
    monkeypatch.setenv("MXNET_QOS_DEFAULT_PRIORITY", "vip")
    with pytest.raises(MXNetError, match="MXNET_QOS_DEFAULT_PRIORITY"):
        QosPolicy(tenants={})


# ---------------------------------------------------------------------------
# token bucket + tenant grammar
# ---------------------------------------------------------------------------
def test_token_bucket_continuous_refill():
    b = TokenBucket(rate=2.0, burst_seconds=1.0)  # capacity 2
    assert b.try_take(1, now=0.0) and b.try_take(1, now=0.0)
    assert not b.try_take(1, now=0.0), "burst exhausted"
    assert not b.try_take(1, now=0.4), "0.8 tokens refilled, need 1"
    assert b.try_take(1, now=0.6)
    assert b.try_take(2, now=100.0)
    assert not b.try_take(1, now=100.0)


def test_token_bucket_capacity_floor():
    b = TokenBucket(rate=0.5, burst_seconds=1.0)
    assert b.capacity == 1.0
    assert b.try_take(1, now=0.0)
    assert not b.try_take(1, now=1.0)
    assert b.try_take(1, now=2.0)


@pytest.mark.parametrize("rate,burst", [(2.0, 1.0), (0.5, 1.0), (7.5, 0.4),
                                        (100.0, 2.5)])
def test_token_bucket_equals_jax(rate, burst):
    rng = np.random.RandomState(int(rate * 10))
    script = [(int(rng.randint(1, 4)), float(t))
              for t in np.cumsum(rng.exponential(0.3, 60))]
    script.insert(10, (1, script[9][1] - 0.5))   # a clock that steps back
    ours, theirs = TokenBucket(rate, burst), jqos.TokenBucket(rate, burst)
    for n, now in script:
        assert ours.try_take(n, now) == theirs.try_take(n, now), (n, now)
        assert (ours.level, ours.t_last, ours.capacity) == \
            (theirs.level, theirs.t_last, theirs.capacity)


def test_tenant_grammar_parses():
    t = parse_tenants("latency:prio=latency;"
                      "bulk:priority=bulk,req_rate=10,tok_rate=500;"
                      "plain")
    assert set(t) == {"latency", "bulk", "plain"}
    assert t["latency"]["priority"] == PRIORITIES["latency"]
    assert t["bulk"] == {"priority": PRIORITIES["bulk"],
                         "req_rate": 10.0, "tok_rate": 500.0}
    assert t["plain"] == {"priority": None, "req_rate": None,
                          "tok_rate": None}
    assert parse_tenants("") == {}
    assert parse_tenants(None) == {}


BAD_TENANTS = [
    ":prio=bulk",                 # empty tenant name
    "a:prio=bulk;a:prio=latency",  # duplicate tenant
    "a:prio",                     # k without =v
    "a:speed=fast",               # unknown key
    "a:prio=vip",                 # unknown priority class
    "a:req_rate=0",               # rate must be > 0
    "a:req_rate=-3",
    "a:tok_rate=many",
    "a:req_rate=nan",
]
GOOD_TENANTS = [
    "", None, " ; ", "solo", "a:prio=latency;b:priority=bulk",
    "bulk:prio=bulk,req_rate=50,tok_rate=2000;interactive:prio=latency",
    " spaced : prio = normal , req_rate = 2.5 ;x:tok_rate=1e3",
]


@pytest.mark.parametrize("bad", BAD_TENANTS)
def test_tenant_grammar_rejects(bad):
    with pytest.raises(MXNetError, match="MXNET_QOS_TENANTS"):
        parse_tenants(bad)


@pytest.mark.parametrize("text", GOOD_TENANTS + BAD_TENANTS)
def test_tenant_grammar_equals_jax(text):
    def run(mod, err):
        try:
            return mod.parse_tenants(text)
        except err as e:
            return ("error", str(e))

    assert run(tqos, MXNetError) == run(jqos, jmx.base.MXNetError)


def test_qos_policy_from_env(monkeypatch):
    monkeypatch.delenv("MXNET_QOS_TENANTS", raising=False)
    assert QosPolicy.from_env() is None
    monkeypatch.setenv("MXNET_QOS_TENANTS", "bulk:prio=bulk,req_rate=2")
    pol = QosPolicy.from_env()
    assert pol is not None and pol.tenants() == ["bulk"]
    assert pol.priority_of("bulk") == PRIORITIES["bulk"]
    assert pol.priority_of("stranger") == DEFAULT_PRIORITY
    assert pol.priority_of(None) == DEFAULT_PRIORITY


def test_qos_admit_quota_and_priorities():
    pol = QosPolicy(tenants={"bulk": {"priority": "bulk", "req_rate": 2.0},
                             "fat": {"tok_rate": 4.0}},
                    burst_seconds=1.0)
    assert pol.admit("bulk", now=0.0) == PRIORITIES["bulk"]
    assert pol.admit("bulk", now=0.0) == PRIORITIES["bulk"]
    with pytest.raises(TenantQuotaExceeded) as exc:
        pol.admit("bulk", now=0.0)
    assert exc.value.tenant == "bulk"
    assert "never queued" in str(exc.value)
    pol.admit("bulk", now=1.0)
    assert pol.admit("fat", rows=4, now=0.0) == DEFAULT_PRIORITY
    with pytest.raises(TenantQuotaExceeded, match="token-rate"):
        pol.admit("fat", rows=1, now=0.0)
    for _ in range(10):
        assert pol.admit(None, now=0.0) == DEFAULT_PRIORITY
        assert pol.admit("anon", now=0.0) == DEFAULT_PRIORITY
    stats = profiler.qos_stats()
    assert stats["bulk"]["quota_rejections"] == 1
    assert stats["bulk"]["admitted"] == 3
    assert stats["fat"]["rows"] == 4


def test_qos_admit_equals_jax():
    tenants = {"bulk": {"priority": "bulk", "req_rate": 3.0,
                        "tok_rate": 20.0},
               "lat": {"priority": 0},
               "fat": {"tok_rate": 6.0}}
    rng = np.random.RandomState(3)
    names = ["bulk", "lat", "fat", None, "anon"]
    script = [(names[int(rng.randint(len(names)))], int(rng.randint(1, 6)),
               float(t)) for t in np.cumsum(rng.exponential(0.08, 200))]

    def run(mod, prof):
        pol = mod.QosPolicy(tenants=tenants, burst_seconds=0.5)
        out = []
        for tenant, rows, now in script:
            try:
                out.append(pol.admit(tenant, rows=rows, now=now))
            except mod.TenantQuotaExceeded as e:
                out.append(("quota", e.tenant, str(e)))
        return out, prof.qos_stats(), pol.tenants(), \
            [pol.priority_of(n) for n in names]

    ours, theirs = run(tqos, profiler), run(jqos, jprofiler)
    assert ours == theirs
    assert sum(isinstance(o, tuple) for o in ours[0]) > 10


# ---------------------------------------------------------------------------
# router boundary: over-quota is typed, never queued, never retried
# ---------------------------------------------------------------------------
def _fake_view():
    return [{"rank": 0, "addr": "127.0.0.1:1", "alive": True,
             "done": False,
             "info": {"state": "serving", "models": ["m"],
                      "ladder": [1, 4], "queued": 0, "inflight": 0,
                      "p50_ms": 1.0, "p99_ms": 2.0}}]


def test_router_quota_rejects_before_any_forward(monkeypatch):
    pol = QosPolicy(tenants={"bulk": {"priority": "bulk", "req_rate": 1.0},
                             "free": {"priority": "bulk"}},
                    burst_seconds=1.0)
    router = FleetRouter(view_fn=_fake_view, qos=pol)
    forwards = []
    monkeypatch.setattr(
        FleetRouter, "_forward",
        lambda self, h, model, wire, t, r, tenant=None, priority=None:
        forwards.append((tenant, priority)) or {"outputs": []})
    x = np.zeros((1, DIM), np.float32)
    router.request("m", x, tenant="bulk")
    assert forwards == [("bulk", PRIORITIES["bulk"])]
    with pytest.raises(TenantQuotaExceeded):
        router.request("m", x, tenant="bulk")
    assert len(forwards) == 1
    stats = profiler.fleet_stats()
    assert stats["requests"] == 1 and stats["retries"] == 0
    assert profiler.qos_stats()["bulk"]["quota_rejections"] == 1
    router.request("m", x, tenant="free", priority=0, timeout=5.0)
    assert forwards[-1] == ("free", 0)
    router.close()


def test_router_success_records_tenant_latency(monkeypatch):
    router = FleetRouter(
        view_fn=_fake_view,
        qos=QosPolicy(tenants={"lat": {"priority": "latency"}},
                      burst_seconds=1.0))
    monkeypatch.setattr(
        FleetRouter, "_forward",
        lambda self, h, model, wire, t, r, tenant=None, priority=None:
        {"outputs": []})
    router.request("m", np.zeros((1, DIM), np.float32), tenant="lat")
    stats = profiler.qos_stats()
    assert stats["lat"]["completed"] == 1
    assert stats["lat"]["p99_ms"] is not None
    router.close()


# ---------------------------------------------------------------------------
# replica boundary: the quota rides the wire as the terminal "quota" kind
# ---------------------------------------------------------------------------
def _linear(seed=1, pkg=mx):
    rng = np.random.RandomState(seed)
    out = pkg.sym.FullyConnected(data=pkg.sym.var("data"), num_hidden=4,
                                 name="fc")
    args = {"fc_weight": rng.randn(4, DIM).astype(np.float32),
            "fc_bias": rng.randn(4).astype(np.float32)}
    return out, args


def _server(ladder=(1, 4)):
    sym, args = _linear()
    srv = ModelServer(ladder=ladder, device="cpu")
    srv.add_model("m", symbol=sym, arg_params=args,
                  data_shapes={"data": (1, DIM)})
    srv.predict("m", np.zeros((1, DIM), np.float32))
    return srv


@pytest.mark.parametrize("router_pkg", ["port", "jax"])
def test_replica_side_quota_is_terminal_over_the_wire(router_pkg):
    """A port replica's quota is terminal for a router of either
    package: the wire kind ``quota`` maps to each package's typed
    error, with no retry."""
    from mxnet_tpu.serving import fleet as jfleet

    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    rep = ReplicaServer(
        _server(), tracker_uri=trk.addr, publish_interval=0.2,
        qos=QosPolicy(tenants={"bulk": {"req_rate": 1.0,
                                        "priority": "bulk"}},
                      burst_seconds=1.0))
    rep.serve_in_background()
    mod, prof = (FleetRouter, profiler) if router_pkg == "port" else \
        (jfleet.FleetRouter, jprofiler)
    quota = TenantQuotaExceeded if router_pkg == "port" else \
        jqos.TenantQuotaExceeded
    router = mod(tracker_uri=trk.addr, view_interval=0.2, timeout=10.0,
                 qos=None)
    try:
        x = np.zeros((1, DIM), np.float32)
        router.request("m", x, tenant="bulk")
        with pytest.raises(quota, match="bulk"):
            router.request("m", x, tenant="bulk")
        assert prof.fleet_stats()["retries"] == 0
        router.request("m", x)   # unlabelled traffic is untouched
    finally:
        router.close()
        rep.shutdown()
        trk.shutdown()


# ---------------------------------------------------------------------------
# broker: priority classes order the dequeue; sheds are per-tenant
# ---------------------------------------------------------------------------
def _dequeue_order(pkg):
    if pkg == "port":
        srv = _server(ladder=(1,))
    else:
        sym, args = _linear(pkg=jmx)
        srv = jserving.ModelServer(ladder=(1,))
        srv.add_model("m", symbol=sym, arg_params=args,
                      data_shapes={"data": (1, DIM)})
        srv.predict("m", np.zeros((1, DIM), np.float32))
    gate = threading.Event()
    order = []

    def hook(reqs):
        order.extend((r.tenant, r.priority) for r in reqs)
        gate.wait(10)

    srv._workers["m"]._batch_hook = hook
    x = np.zeros((1, DIM), np.float32)
    try:
        first = srv.submit("m", x)          # occupies the batch loop
        deadline = time.monotonic() + 10
        while not order and time.monotonic() < deadline:
            time.sleep(0.01)
        plan = [("bulk", 2), ("lat", 0), (None, None), ("bulk", 2),
                ("lat", 0), ("norm", 1), (None, 2), ("lat", 0)]
        futs = [srv.submit("m", x, tenant=t, priority=p) for t, p in plan]
        assert srv.pending() == len(plan) + 1
        gate.set()
        first.result(timeout=10)
        for f in futs:
            f.result(timeout=10)
    finally:
        gate.set()
        srv.close()
    return order


def test_broker_dequeues_by_priority_class():
    order = _dequeue_order("port")
    assert [t for t, _p in order] == \
        [None, "lat", "lat", "lat", None, "norm", "bulk", "bulk", None]


def test_broker_dequeue_order_equals_jax():
    assert _dequeue_order("port") == _dequeue_order("jax")


def test_broker_shed_at_dequeue_counts_per_tenant():
    srv = _server(ladder=(1,))
    gate = threading.Event()
    srv._workers["m"]._batch_hook = lambda reqs: gate.wait(10)
    x = np.zeros((1, DIM), np.float32)
    try:
        first = srv.submit("m", x)
        time.sleep(0.05)
        doomed = srv.submit("m", x, deadline=0.01, tenant="bulk",
                            priority=PRIORITIES["bulk"])
        time.sleep(0.05)                    # expires while queued
        gate.set()
        first.result(timeout=10)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=10)
    finally:
        gate.set()
        srv.close()
    assert profiler.qos_stats()["bulk"]["shed"] == 1


# ---------------------------------------------------------------------------
# autoscaler decide loop (all seams injected; no sockets, no sleeps)
# ---------------------------------------------------------------------------
class _Fleet:
    """Fake fleet: members view + recorded actuations/admin calls."""

    def __init__(self, mod=tautoscale, ranks=(0,), load=0.0, p99=1.0,
                 occ=0.0):
        self.mod = mod
        self.ranks = list(ranks)
        self.load = load
        self.p99 = p99
        self.occ = occ
        self.directives = []
        self.admin_calls = []
        self.events = []
        self.admin_raises = False

    def members(self):
        return [{"rank": r, "addr": "127.0.0.1:%d" % (1000 + r),
                 "alive": True, "done": False,
                 "info": {"state": "serving",
                          "queued": int(self.load), "inflight": 0,
                          "p99_ms": self.p99,
                          "gen_occupancy": self.occ}}
                for r in self.ranks]

    def actuate(self, directive):
        self.directives.append(dict(directive))

    def admin(self, addr, op, payload=None, **kw):
        self.admin_calls.append((addr, op))
        if self.admin_raises:
            raise ConnectionError("replica died mid-%s" % op)
        if op == "stop":
            self.ranks.remove(int(addr.rsplit(":", 1)[1]) - 1000)
        return {}

    def scaler(self, **kw):
        kw.setdefault("min_replicas", 1)
        kw.setdefault("max_replicas", 3)
        kw.setdefault("up_load", 4.0)
        kw.setdefault("down_load", 0.5)
        kw.setdefault("hysteresis", 2)
        kw.setdefault("cooldown", 10.0)
        kw.setdefault("interval", 1.0)
        return self.mod.FleetAutoscaler(
            members_fn=self.members, actuate_fn=self.actuate,
            admin_fn=self.admin,
            event_fn=lambda ev, **f: self.events.append((ev, f)), **kw)


def test_autoscaler_stepped_load_one_three_one():
    f = _Fleet(ranks=[0], load=0.0)
    s = f.scaler(hysteresis=2, cooldown=5.0)
    t = [0.0]

    def tick():
        t[0] += 1.0
        return s.tick(now=t[0])

    assert tick() is None and s.desired == 1   # adopt
    f.load = 8.0
    assert tick() is None, "one over tick is not a trend"
    assert tick() == "up" and s.desired == 2
    f.ranks = [0, 1]
    assert tick() is None
    assert tick() is None, "cooldown holds even with the streak ripe"
    t[0] += 5.0
    assert tick() == "up" and s.desired == 3
    f.ranks = [0, 1, 2]
    t[0] += 5.0
    assert tick() is None, "over at max: nowhere to go"
    f.load = 0.0
    assert tick() is None, "under-streak builds"
    assert tick() == "down"
    assert s.desired == 2 and s.retired == {2}
    assert f.admin_calls[-2:] == [("127.0.0.1:1002", "drain"),
                                  ("127.0.0.1:1002", "stop")]
    assert tick() is None and tick() is None
    t[0] += 10.0
    assert tick() == "down"
    assert s.desired == 1 and s.retired == {1, 2}
    t[0] += 10.0
    for _ in range(5):
        assert tick() is None, "at min: scale-down stops"
    assert [d["desired"] for d in f.directives] == [2, 3, 2, 1]
    assert f.directives[-1]["retired"] == [1, 2]
    stats = profiler.autoscale_stats()
    assert stats["scale_ups"] == 2 and stats["scale_downs"] == 2
    assert stats["retires"] == 2 and stats["retire_races"] == 0


def test_autoscaler_hysteresis_and_dead_band_stop_flapping():
    f = _Fleet(ranks=[0], load=0.0)
    s = f.scaler(up_load=4.0, down_load=0.5, hysteresis=3, cooldown=0.0)
    now = [0.0]

    def tick(load):
        f.load = load
        now[0] += 1.0
        return s.tick(now=now[0])

    tick(0.0)
    for load in (8.0, 8.0, 2.0, 8.0, 8.0, 2.0, 8.0, 8.0, 2.0):
        assert tick(load) is None
    assert f.directives == []
    assert profiler.autoscale_stats()["holds_hysteresis"] >= 4
    assert tick(8.0) is None and tick(8.0) is None
    assert tick(8.0) == "up"


def test_autoscaler_cooldown_holds_after_an_action():
    f = _Fleet(ranks=[0], load=9.0)
    s = f.scaler(hysteresis=1, cooldown=30.0, max_replicas=5)
    assert s.tick(now=1.0) == "up" and s.desired == 2
    for now in (3.0, 10.0, 30.9):
        assert s.tick(now=now) is None, "cooldown"
    assert profiler.autoscale_stats()["holds_cooldown"] == 3
    assert s.tick(now=31.5) == "up"


def test_autoscaler_slo_and_occupancy_also_trigger():
    f = _Fleet(ranks=[0], load=0.0, p99=120.0)
    s = f.scaler(hysteresis=1, cooldown=0.0, slo_ms=100.0)
    assert s.tick(now=1.0) == "up", "p99 over the SLO is overload"
    f2 = _Fleet(ranks=[0], load=0.0, occ=0.95)
    s2 = f2.scaler(hysteresis=1, cooldown=0.0)
    assert s2.tick(now=1.0) == "up"


def test_autoscaler_retire_race_is_terminal_and_single():
    f = _Fleet(ranks=[0, 1], load=0.0)
    f.admin_raises = True
    s = f.scaler(hysteresis=1, cooldown=0.0)
    assert s.tick(now=1.0) == "down"
    assert s.retired == {1} and s.desired == 1
    assert f.directives[-1] == {"role": "replica", "desired": 1,
                                "retired": [1]}
    stats = profiler.autoscale_stats()
    assert stats["retire_races"] == 1 and stats["retires"] == 0
    f.ranks = [0]
    for now in (3.0, 4.0, 5.0):
        assert s.tick(now=now) is None
    assert profiler.autoscale_stats()["retire_races"] == 1
    assert "scale-retire-race" in [e for e, _f in f.events]


def test_autoscaler_members_failure_is_fail_static():
    calls = []
    s = FleetAutoscaler(
        members_fn=lambda: (_ for _ in ()).throw(OSError("tracker gone")),
        actuate_fn=calls.append, min_replicas=1, max_replicas=3,
        up_load=4.0, down_load=0.5)
    for now in (1.0, 2.0, 3.0):
        assert s.tick(now=now) is None
    assert calls == [], "a blind controller must not steer"
    assert profiler.autoscale_stats()["errors"] == 3


def test_autoscaler_adopts_the_fleet_it_finds():
    f = _Fleet(ranks=[0, 1, 2, 3, 4], load=2.0)
    s = f.scaler(min_replicas=1, max_replicas=3)
    s.tick(now=1.0)
    assert s.desired == 3, "adoption clamps into [min, max]"


def _tick_trace(mod, prof):
    """One scripted members trace through ``mod``'s autoscaler: loads,
    p99s, occupancies and fleet changes over 40 ticks, a members failure
    and a retire race on the way. Returns everything it did."""
    f = _Fleet(mod=mod, ranks=[0], load=0.0)
    s = f.scaler(hysteresis=2, cooldown=3.0, max_replicas=4, slo_ms=50.0)
    loads = [0, 8, 8, 8, 9, 9, 2, 9, 9, 9, 9, 9, 0, 0, 0, 0, 0, 0, 3, 0,
             0, 0, 0, 0, 9, 9, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    out = []
    fail_at, race_at = {15}, {20, 21}
    members = f.members
    for i, load in enumerate(loads):
        f.load = float(load)
        f.p99 = 60.0 if i in (24, 25) else 1.0
        f.occ = 0.95 if i == 26 else 0.0
        f.admin_raises = i in race_at
        if i in fail_at:
            s._members = lambda: (_ for _ in ()).throw(OSError("gone"))
        else:
            s._members = members
        # the supervisor brings directives' fresh ranks up a tick later
        want = s.desired or 1
        alive = [r for r in f.ranks if r not in s.retired]
        while len(alive) < want:
            fresh = max(f.ranks + sorted(s.retired) + [-1]) + 1
            f.ranks.append(fresh)
            alive.append(fresh)
        out.append((i, s.tick(now=float(i)), s.desired,
                    sorted(s.retired)))
    return (out, f.directives, f.admin_calls, f.events,
            prof.autoscale_stats())


def test_autoscaler_tick_trace_equals_jax():
    ours = _tick_trace(tautoscale, profiler)
    theirs = _tick_trace(jautoscale, jprofiler)
    assert ours == theirs
    actions = [a for _i, a, _d, _r in ours[0] if a]
    assert "up" in actions and "down" in actions


def test_controller_death_by_chaos_is_fail_static(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_SPEC", "autoscaler:crash@tick=3")
    chaos.reset_engine()
    exits = []
    chaos.engine()._exit = exits.append
    try:
        f = _Fleet(ranks=[0], load=0.0)
        s = f.scaler()
        s.tick(now=1.0)
        s.tick(now=2.0)
        assert exits == [], "fired early"
        before = list(f.directives)
        s.tick(now=3.0)
        assert exits == [137], "hard-exit at the third control tick"
        assert f.directives == before
    finally:
        monkeypatch.delenv("MXNET_FAULT_SPEC")
        chaos.reset_engine()


# ---------------------------------------------------------------------------
# chaos grammar: the autoscaler target
# ---------------------------------------------------------------------------
def test_chaos_autoscaler_grammar():
    (rule,) = parse_spec("autoscaler:crash@tick=3")
    assert (rule.target, rule.action, rule.rank) == \
        ("autoscaler", "crash", None)
    for bad in ("autoscaler:crash@step=3", "autoscaler:crash@req=3",
                "autoscaler:stall@tick=3", "autoscaler:crash@tick=x"):
        with pytest.raises(FaultSpecError) as ours:
            parse_spec(bad)
        with pytest.raises(jchaos.FaultSpecError) as theirs:
            jchaos.parse_spec(bad)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("restart", [0, 1, 3])
def test_chaos_autoscaler_fires_once_at_exact_tick(restart):
    traces = []
    for mod in (chaos, jchaos):
        eng = mod.ChaosEngine("autoscaler:crash@tick=2", role="worker",
                              rank=0, restart=restart)
        exits = []
        eng._exit = exits.append
        trace = []
        for _ in range(5):
            eng.autoscaler_tick()
            trace.append(list(exits))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[0][1] == [137] and traces[0][-1] == [137]
    assert isinstance(ChaosEngine("", role="worker"), ChaosEngine)


# ---------------------------------------------------------------------------
# the tracker's scale mailbox
# ---------------------------------------------------------------------------
def test_tracker_scale_directive_roundtrip():
    trk = Tracker(num_workers=0, num_servers=0)
    trk.serve_in_background()
    c = TrackerClient(trk.addr, role="replica", rank=0)
    try:
        assert c.scale_get() is None
        d1 = c.scale_set(desired=2, retired=())
        d2 = c.scale_set(desired=1, retired=[2, 1])
        assert (d1["seq"], d2["seq"]) == (1, 2)
        got = c.scale_get()
        assert got["desired"] == 1 and got["retired"] == [1, 2]
        assert c.scale_get(role="worker") is None
        with pytest.raises(Exception):
            c.scale_set(desired=-1)
        # the controller's registration-free link reads the same mailbox
        link = tautoscale._TrackerLink(trk.addr)
        assert link.rpc("scale_get", {"role": "replica"}) == got
        link.close()
    finally:
        c.close()
        trk.shutdown()


# ---------------------------------------------------------------------------
# profiler families
# ---------------------------------------------------------------------------
def test_profiler_autoscale_family_contract():
    assert profiler.autoscale_stats() == {}
    profiler.autoscale_record(ticks=1, scale_ups=1, replicas=2, desired=3)
    s = profiler.autoscale_stats()
    assert s["ticks"] == 1 and s["scale_ups"] == 1
    assert (s["replicas"], s["desired"]) == (2, 3)
    profiler.autoscale_record(replicas=1)
    assert profiler.autoscale_stats()["replicas"] == 1
    with pytest.raises(ValueError, match="unknown counter"):
        profiler.autoscale_record(scale_upz=1)
    assert profiler.autoscale_stats(reset=True)["ticks"] == 1
    assert profiler.autoscale_stats() == {}


def test_profiler_qos_family_contract():
    assert profiler.qos_stats() == {}
    for prof in (profiler, jprofiler):
        prof.qos_record("bulk", requests=2, admitted=1, rows=8,
                        latencies=[0.01, 0.02, 0.05])
        with pytest.raises(ValueError, match="unknown counter"):
            prof.qos_record("bulk", sheds=1)
    s = profiler.qos_stats()
    assert s["bulk"]["requests"] == 2 and s["bulk"]["rows"] == 8
    assert s == jprofiler.qos_stats()


def test_dump_profile_carries_both_families(tmp_path):
    import json

    fname = str(tmp_path / "trace.json")
    profiler.autoscale_record(ticks=3, replicas=1, desired=1)
    profiler.qos_record("bulk", shed=2)
    profiler.fleet_record(requests=1, completed=1, latencies=[0.002])
    profiler.set_config(filename=fname)
    try:
        profiler.dump_profile()
    finally:
        profiler.set_config()
    with open(fname) as f:
        payload = json.load(f)
    assert payload["autoscaleStats"]["ticks"] == 3
    assert payload["qosStats"]["bulk"]["shed"] == 2
    assert payload["fleetStats"]["completed"] == 1


# ---------------------------------------------------------------------------
# slow tier: replica and controller processes
# ---------------------------------------------------------------------------
def _mlp_checkpoint(tmp_path, dim=16):
    net = mx.sym.var("data")
    for i in range(2):
        net = mx.sym.Activation(mx.sym.FullyConnected(
            data=net, num_hidden=32, name="fc%d" % i), act_type="relu")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data=net, num_hidden=4, name="head"), name="softmax")
    arg_shapes, _, _ = net.infer_shape(data=(1, dim))
    rng = np.random.RandomState(0)
    args = {n: mx.nd.array((rng.randn(*s) * 0.05).astype(np.float32),
                           ctx=mx.cpu())
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    prefix = str(tmp_path / "model")
    mx.model.save_checkpoint(prefix, 0, net, args, {})
    return prefix


class _Supervisor:
    """A launcher stand-in: keeps one replica process per rank the scale
    directive wants, never respawning a retired rank."""

    def __init__(self, coord, prefix, dim=16):
        self.coord, self.prefix, self.dim = coord, prefix, dim
        self.procs = {}
        self.retired = set()
        self.seq = 0
        self.spawned = 0

    def spawn(self, rank):
        host, port = self.coord.rsplit(":", 1)
        env = _scrubbed_env(DMLC_ROLE="replica", DMLC_REPLICA_ID=str(rank),
                            DMLC_PS_ROOT_URI=host, DMLC_PS_ROOT_PORT=port,
                            OMP_NUM_THREADS="1")
        self.procs[rank] = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.serving.fleet",
             "replica", "--prefix", self.prefix, "--epoch", "0",
             "--data-shape", "data:1,%d" % self.dim, "--ladder", "1,4",
             "--device", "cpu", "--port", "0"], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        self.spawned += 1

    def poll(self, link):
        d = link.rpc("scale_get", {"role": "replica"})
        if not d or d["seq"] == self.seq:
            return
        self.seq = d["seq"]
        self.retired |= set(d["retired"])
        live = [r for r, p in self.procs.items()
                if p.poll() is None and r not in self.retired]
        fresh = max(list(self.procs) + [-1]) + 1
        while len(live) < d["desired"]:
            self.spawn(fresh)
            live.append(fresh)
            fresh += 1

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)


def _serving(router):
    router.refresh_view(force=True)
    return sum(1 for _a, st, alive, _l in router.replicas()
               if alive and st == "serving")


@pytest.mark.slow
def test_e2e_stepped_load_scales_one_three_one(tmp_path):
    """A fleet of one port replica process, a controller process
    (``python -m mxnet_tpu_torch.serving.autoscale``) and stepped load:
    the fleet grows to 3 under load and shrinks back to 1 when it fades,
    with every request served."""
    prefix = _mlp_checkpoint(tmp_path)
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=5.0)
    trk.serve_in_background()
    sup = _Supervisor(trk.addr, prefix)
    sup.spawn(0)
    scaler = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving.autoscale",
         "--tracker", trk.addr, "--min", "1", "--max", "3",
         "--interval", "0.25", "--up-load", "1.5", "--down-load", "0.25",
         "--hysteresis", "2", "--cooldown", "1.0"],
        env=_scrubbed_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    link = tautoscale._TrackerLink(trk.addr)
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.25,
                         timeout=20.0)
    stop = threading.Event()
    errors = []
    try:
        deadline = time.monotonic() + 90
        while _serving(router) < 1:
            assert time.monotonic() < deadline, "fleet never came up"
            time.sleep(0.25)
        x = np.zeros((1, 16), np.float32)

        def client():
            while not stop.is_set():
                try:
                    router.request("model", x, timeout=20.0)
                except Exception as e:
                    errors.append("%s: %s" % (type(e).__name__, e))

        threads = [threading.Thread(target=client) for _ in range(12)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while _serving(router) < 3:
            sup.poll(link)
            assert time.monotonic() < deadline, "never scaled to 3"
            time.sleep(0.25)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        deadline = time.monotonic() + 120
        while _serving(router) > 1:
            sup.poll(link)
            assert time.monotonic() < deadline, "never scaled back to 1"
            time.sleep(0.25)
        for _ in range(5):
            router.request("model", x, timeout=20.0)
        assert errors == [], errors[:3]
        directive = link.rpc("scale_get", {"role": "replica"})
        assert directive["desired"] == 1 and len(directive["retired"]) == 2
        assert sup.spawned == 3
    finally:
        stop.set()
        scaler.terminate()
        try:
            out, _ = scaler.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            scaler.kill()
            out, _ = scaler.communicate(timeout=10)
        link.close()
        router.close()
        sup.close()
        trk.shutdown()
    assert "scale-up -> desired=3" in out and "retired rank=" in out, out


@pytest.mark.slow
def test_e2e_chaos_controller_crash_fail_static(tmp_path):
    """``autoscaler:crash@tick=3``: the controller process exits 137 at its
    third tick and the fleet keeps serving at its size."""
    prefix = _mlp_checkpoint(tmp_path)
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=5.0)
    trk.serve_in_background()
    sup = _Supervisor(trk.addr, prefix)
    sup.spawn(0)
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.25,
                         timeout=20.0)
    try:
        deadline = time.monotonic() + 90
        while _serving(router) < 1:
            assert time.monotonic() < deadline, "fleet never came up"
            time.sleep(0.25)
        proc = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.serving.autoscale",
             "--tracker", trk.addr, "--interval", "0.2"],
            env=_scrubbed_env(MXNET_FAULT_SPEC="autoscaler:crash@tick=3"),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 137, proc.stdout + proc.stderr
        assert "injecting crash" in proc.stderr
        x = np.zeros((2, 16), np.float32)
        for _ in range(5):
            assert router.request("model", x)[0].shape == (2, 4)
        assert _serving(router) == 1
    finally:
        router.stop_fleet()
        router.close()
        sup.close()
        trk.shutdown()


@pytest.mark.slow
def test_e2e_chaos_scale_down_race(tmp_path):
    """The victim of a scale-down is SIGKILLed as its drain starts: the
    controller counts one retire race, the supervisor does not respawn
    the retired rank, and the survivor serves."""
    prefix = _mlp_checkpoint(tmp_path)
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    sup = _Supervisor(trk.addr, prefix)
    sup.spawn(0)
    sup.spawn(1)
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.25,
                         timeout=20.0)
    link = tautoscale._TrackerLink(trk.addr)

    def admin(addr, op, payload=None):
        if op == "drain":
            sup.procs[1].send_signal(signal.SIGKILL)
            sup.procs[1].wait(timeout=10)
        return tautoscale._replica_admin(addr, op, payload,
                                         connect_deadline=1.0)

    scaler = FleetAutoscaler(tracker_uri=trk.addr, admin_fn=admin,
                             min_replicas=1, max_replicas=2, hysteresis=1,
                             cooldown=0.0, up_load=4.0, down_load=0.5)
    try:
        deadline = time.monotonic() + 90
        while _serving(router) < 2:
            assert time.monotonic() < deadline, "fleet never came up"
            time.sleep(0.25)
        assert scaler.tick() == "down"
        sup.poll(link)
        stats = profiler.autoscale_stats()
        assert stats["retire_races"] == 1 and stats["retires"] == 0
        assert sup.spawned == 2, "the retired rank was respawned"
        x = np.zeros((1, 16), np.float32)
        for _ in range(5):
            router.request("model", x)
        assert profiler.fleet_stats()["failed"] == 0
    finally:
        scaler.close()
        link.close()
        router.stop_fleet()
        router.close()
        sup.close()
        trk.shutdown()
