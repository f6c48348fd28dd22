"""Fault-tolerant serving fleet (counterpart of
``mxnet_tpu/serving/fleet.py``: the same wire ops, retry classes, errors
and knobs): tracker-discovered replicas, a retrying router with
health-driven draining, and zero-drop rolling checkpoint swap.

- **Discovery is the tracker.** Each :class:`ReplicaServer` wraps a
  :class:`~mxnet_tpu_torch.serving.ModelServer` behind a TCP endpoint
  speaking the tracker's frame format (``tracker._send_msg``: byte for
  byte the JAX package's, so either package's router drives either
  package's replicas) and registers with the scheduler under the
  slot-free ``replica`` role: model names, bucket ladder and a load gauge
  (queue depth, in-flight, ``profiler.serving_stats`` p50/p99) that it
  re-publishes every ``MXNET_FLEET_VIEW_INTERVAL`` seconds and on every
  state change. Heartbeats and dead-node detection are the tracker's.
- **Routing is least-loaded with bounded retry.** :class:`FleetRouter`
  reads the tracker view and sends each request to the live ``serving``
  replica with the least (router-local in-flight + published queue
  depth). Failures are classified: a request that was *never sent*
  (connect refused, send-phase drop) retries on another replica whatever
  its idempotency; a request sent without a reply fails as
  :class:`ReplicaConnectionLost` and retries only when ``idempotent``
  (the inference default); typed admission rejections
  (:class:`~.broker.ReplicaDraining`, :class:`~.broker.ServerClosed`)
  always retry elsewhere; genuine request failures surface at once.
  Retries are bounded by ``MXNET_FLEET_RETRIES`` with exponential backoff
  (``MXNET_FLEET_BACKOFF``) under one end-to-end budget
  (``MXNET_FLEET_TIMEOUT``), which also rides to the replica as its
  shed-at-dequeue deadline: under fleet-wide overload the router raises
  the typed :class:`FleetOverloaded` instead of queueing without bound.
- **Draining and rolling swap.** The ``drain`` op moves a replica to
  ``draining``: it admits nothing (typed rejection), finishes queued and
  in-flight work, and optionally deregisters. :meth:`FleetRouter.
  fleet_swap` rolls a checkpoint across the fleet one replica at a time
  (drain, quiesced ``ModelServer.swap_from_checkpoint``, resume) while
  the other replicas absorb the retried traffic: zero dropped requests.
- **Determinism is chaos.py.** ``replica:R:crash@req=N``,
  ``replica:R:stall@req=N`` and ``router:drop@...`` drive each reaction
  path above at exact points.

A sharded replica group (``group=`` with ``group_size`` > 1, one mesh
across processes) is not ported and raises by name (ROADMAP.md Queue A
item 8b); the router still gates the groups a JAX package's replicas
publish.

Entry points::

    python -m mxnet_tpu_torch.serving.fleet replica --prefix ckpt \\
        --epoch 0 --data-shape data:1,128 [--device cuda|cpu]
    python -m mxnet_tpu_torch.serving.fleet router status|drain|swap|stop
    python -m mxnet_tpu_torch.serving.fleet autoscaler --tracker host:port

A replica runs on ``cuda`` unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import struct
import sys
import threading
import time

import numpy as np

from .. import chaos, config, profiler
from ..tracker import (
    TrackerClient,
    TrackerError,
    _recv_msg,
    _send_msg,
    connect_with_backoff,
)
from .broker import (
    DeadlineExceeded,
    ModelServer,
    ReplicaDraining,
    ServerClosed,
    ServerOverloaded,
)
from .predictor import ServingError
from .qos import QosPolicy, TenantQuotaExceeded

#: the resumable exit status of a SIGTERMed replica (the JAX package's
#: health.EXIT_PREEMPTED): a launch.py supervisor respawns it for free
EXIT_PREEMPTED = 75

_TRANSPORT_ERRORS = (OSError, ConnectionError, EOFError, struct.error)


class FleetError(ServingError):
    """Fleet-layer failure (no discovery plane, exhausted retries on a
    non-overload error, malformed admin op)."""


class FleetOverloaded(FleetError):
    """The request could not be served inside its deadline/retry
    budget because the FLEET is saturated (every attempt was shed,
    backpressured, or found no admitting replica). The router raises
    this typed error instead of queueing unboundedly — callers decide
    whether to back off or degrade."""


class NoLiveReplica(FleetError):
    """The view holds no live ``serving`` replica for the model —
    a discovery gap, not an overload."""


class ReplicaConnectionLost(FleetError):
    """The request WAS sent but the connection died before a reply:
    the forward may or may not have executed. Distinct from never-sent
    failures (always retried) — the router retries this one only for
    ``idempotent=True`` requests."""


class FleetRemoteError(FleetError):
    """A replica saw the request and failed it for a non-retryable
    reason (bad input, model error). Carries the remote ``kind``."""

    def __init__(self, kind, msg):
        super().__init__(msg)
        self.kind = kind


# ---------------------------------------------------------------------------
# knobs: config.py's strict accessors (a malformed value raises by name)
# ---------------------------------------------------------------------------
def _knob_retries():
    return config.get_nonneg_int("MXNET_FLEET_RETRIES")


def _knob_timeout():
    return config.get_positive_float("MXNET_FLEET_TIMEOUT")


def _knob_backoff():
    return config.get_nonneg_float("MXNET_FLEET_BACKOFF")


def _knob_view_interval():
    return config.get_positive_float("MXNET_FLEET_VIEW_INTERVAL")


def _knob_connect_deadline():
    return config.get_positive_float("MXNET_FLEET_CONNECT_DEADLINE")


def _knob_drain_timeout():
    return config.get_positive_float("MXNET_SERVE_DRAIN_TIMEOUT")


# ---------------------------------------------------------------------------
# wire helpers: arrays ride the out-of-band framing in the server tier's
# (dtype, shape, buffer) encoding (kvstore_server)
# ---------------------------------------------------------------------------
def _np_to_wire(a):
    from ..kvstore_server import _arr_to_wire

    return _arr_to_wire(np.asarray(a), zero_copy=True)


def _np_from_wire(w):
    from ..kvstore_server import _arr_from_wire

    return _arr_from_wire(w)


def _error_kind(exc):
    """Replica-side exception -> wire error kind. The kind is the
    router's retry contract: draining/closed never executed (retry
    anywhere), deadline/overloaded are load shedding (retry elsewhere
    or surface FleetOverloaded), bad_request/error are genuine
    failures (never retried)."""
    if isinstance(exc, ReplicaDraining):
        return "draining"
    if isinstance(exc, ServerClosed):
        return "closed"
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, ServerOverloaded):
        return "overloaded"
    if isinstance(exc, TenantQuotaExceeded):
        # terminal, never retried: the quota is the tenant's contract
        # fleet-wide, not this replica's state
        return "quota"
    if isinstance(exc, ServingError):
        return "bad_request"
    return "error"


_KIND_TO_ERROR = {
    "draining": ReplicaDraining,
    "closed": ServerClosed,
    "deadline": DeadlineExceeded,
    "overloaded": ServerOverloaded,
    "quota": TenantQuotaExceeded,
    "bad_request": ServingError,
}


# ---------------------------------------------------------------------------
# replica
# ---------------------------------------------------------------------------
class ReplicaServer:
    """One serving replica: a TCP front end over a
    :class:`ModelServer`, registered with the tracker under the
    slot-free ``replica`` role.

    State machine: ``serving`` → (drain RPC / ``fleet_swap``) →
    ``draining`` (admits nothing, finishes queued + in-flight) →
    ``drained`` → (resume RPC) → ``serving``; ``stop`` from any state
    shuts the endpoint down. The state plus the load gauge is published
    to the tracker every ``publish_interval`` seconds and on every
    transition, so routers route around a draining replica before ever
    hitting its typed rejection."""

    def __init__(self, server, tracker_uri=None, host="127.0.0.1", port=0,
                 advertise_host=None, rank=None, restart=0,
                 publish_interval=None, drain_timeout=None, qos=None,
                 group=None, group_size=1, group_rank=0):
        if not isinstance(server, ModelServer):
            raise FleetError("ReplicaServer wraps a ModelServer, got %r"
                             % type(server).__name__)
        self._server = server
        # a sharded replica group: ``group`` names the mesh-sharing
        # member set, which the router routes to through its leader
        # (group_rank 0) only while all group_size members publish alive
        # and serving. A group of more than one member shares one mesh
        # across processes, which the port does not have yet.
        if group is not None:
            group_size = int(group_size)
            group_rank = int(group_rank)
            if group_size < 1:
                raise FleetError("ReplicaServer: group_size must be "
                                 ">= 1, got %d" % group_size)
            if not 0 <= group_rank < group_size:
                raise FleetError(
                    "ReplicaServer: group_rank %d outside the group "
                    "of %d member(s)" % (group_rank, group_size))
            if group_size > 1:
                raise FleetError(
                    "ReplicaServer: a sharded replica group (group_size "
                    "%d) is not ported yet (ROADMAP.md Queue A item 8b)"
                    % group_size)
        self._group = group
        self._group_size = int(group_size)
        self._group_rank = int(group_rank)
        # QoS boundary: quotas enforced here too, so a
        # deployment with several routers (or none) still caps tenants.
        # None with an empty MXNET_QOS_TENANTS — zero per-request cost.
        self._qos = QosPolicy.from_env() if qos is None else qos
        self._publish_interval = _knob_view_interval() \
            if publish_interval is None else float(publish_interval)
        self._drain_timeout = _knob_drain_timeout() \
            if drain_timeout is None else float(drain_timeout)
        self._cv = threading.Condition()
        self._state = "serving"
        self._inflight = 0
        self._admitted = 0
        self._swap_gen = 0
        self._stop = threading.Event()
        self._conns = set()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        bound_host, bound_port = self._sock.getsockname()[:2]
        self.addr = "%s:%d" % (advertise_host or bound_host or "127.0.0.1",
                               bound_port)
        self.rank = rank
        self._client = None
        self._publisher = None
        if tracker_uri:
            self._client = TrackerClient(
                tracker_uri, "replica", addr=self.addr, rank=rank,
                restart_count=restart, info=self._info())
            self.rank = self._client.rank
            self._publisher = threading.Thread(
                target=self._publish_loop, daemon=True,
                name="replica-publish")
            self._publisher.start()

    # -- published view -------------------------------------------------------
    def _info(self):
        """The load gauge the router routes on: state, models, bucket
        ladder, queued + in-flight depth, and the serving-tier
        p50/p99."""
        with self._cv:
            state, inflight = self._state, self._inflight
            swap_gen, admitted = self._swap_gen, self._admitted
        stats = profiler.serving_stats()
        p50 = max((s.get("p50_ms") or 0.0 for s in stats.values()),
                  default=0.0)
        p99 = max((s.get("p99_ms") or 0.0 for s in stats.values()),
                  default=0.0)
        gen = profiler.generate_stats()
        out = {"state": state, "models": self._server.models(),
               "ladder": list(self._server._ladder),
               "queued": self._server.pending(), "inflight": inflight,
               "admitted": admitted, "p50_ms": p50, "p99_ms": p99,
               "gen_occupancy": gen.get("slot_occupancy", 0.0),
               "swap_gen": swap_gen, "pid": os.getpid()}
        if self._group is not None:
            out["group"] = self._group
            out["group_size"] = self._group_size
            out["group_rank"] = self._group_rank
        return out

    def _publish(self):
        if self._client is None:
            return
        try:
            self._client.publish(self._info())
        except (TrackerError, OSError, ConnectionError):
            pass  # tracker gone: heartbeat loss handles liveness

    def _publish_loop(self):
        while not self._stop.wait(self._publish_interval):
            self._publish()

    # -- request handling -----------------------------------------------------
    def _op_predict(self, p):
        with self._cv:
            if self._state != "serving":
                raise ReplicaDraining(
                    "replica %s is %s: request not admitted (retry on "
                    "another replica)" % (self.addr, self._state))
            self._inflight += 1
            self._admitted += 1
        try:
            # chaos hook fires INSIDE admission: a crash here is a
            # replica dying with this request genuinely in flight
            fault = chaos.replica_request_fault()
            if fault == "stall":
                self._stop.wait()  # wedge: no reply ever leaves
                raise ServerClosed("replica stopped while wedged")
            model = p.get("model")
            wire = p.get("inputs")
            if not isinstance(wire, dict) or not wire:
                raise ServingError("predict: inputs must be a non-empty "
                                   "{name: array} dict")
            if set(wire) == {"__single__"}:
                # positional form: the model's single data input
                inputs = _np_from_wire(wire["__single__"])
            else:
                inputs = {str(k): _np_from_wire(v)
                          for k, v in wire.items()}
            deadline = p.get("deadline")
            tenant = p.get("tenant")
            priority = p.get("priority")
            if self._qos is not None:
                sample = inputs if not isinstance(inputs, dict) \
                    else next(iter(inputs.values()))
                rows = int(np.asarray(sample).shape[0]) \
                    if np.asarray(sample).ndim else 1
                # raises the typed TenantQuotaExceeded (wire kind
                # "quota") — never queued, never retried elsewhere
                priority = self._qos.admit(tenant, rows=rows)
            fut = self._server.submit(
                model, inputs,
                deadline=float(deadline) if deadline else None,
                tenant=tenant, priority=priority)
            outs = fut.result(
                timeout=(float(deadline) if deadline else 60.0) + 60.0)
            return {"outputs": [_np_to_wire(o) for o in outs]}
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    # -- admin ops ------------------------------------------------------------
    def drain(self, deregister=False, timeout=None):
        """Stop admitting (typed :class:`ReplicaDraining` rejections),
        publish the state, and block until queued + in-flight requests
        finished. With ``deregister`` the replica also reports ``done``
        to the tracker — it leaves the fleet (decommission) instead of
        pausing for a swap."""
        timeout = self._drain_timeout if timeout is None else float(timeout)
        with self._cv:
            if self._state == "stopped":
                raise ServerClosed("replica %s is stopped" % self.addr)
            self._state = "draining"
        self._publish()
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0 or self._server.pending() > 0:
                if self._stop.is_set():
                    raise ServerClosed("replica stopped mid-drain")
                if time.monotonic() >= deadline:
                    raise FleetError(
                        "drain of %s did not finish in %.1fs "
                        "(MXNET_SERVE_DRAIN_TIMEOUT): %d in flight, %d "
                        "queued" % (self.addr, timeout, self._inflight,
                                    self._server.pending()))
                self._cv.wait(timeout=0.05)
            self._state = "drained"
        self._publish()
        if deregister and self._client is not None:
            self._client.done()
        return {"state": "drained"}

    def resume(self):
        """Re-admit traffic after a drain/swap and re-publish."""
        with self._cv:
            if self._state == "stopped":
                raise ServerClosed("replica %s is stopped" % self.addr)
            self._state = "serving"
        self._publish()
        return {"state": "serving"}

    def swap(self, p):
        """Quiesced checkpoint hot-swap of one (or every) resident
        model, then re-publish with a bumped ``swap_gen`` so routers
        can see the new weights generation land."""
        directory = p.get("directory")
        prefix = p.get("prefix")
        models = [p["model"]] if p.get("model") else self._server.models()
        swapped = 0
        for name in models:
            swapped += self._server.swap_from_checkpoint(
                name, prefix=prefix,
                epoch=p.get("epoch") if prefix is not None else None,
                directory=directory)
        with self._cv:
            self._swap_gen += 1
            gen = self._swap_gen
        self._publish()
        return {"swapped": swapped, "swap_gen": gen}

    def _op_stats(self):
        return {"info": self._info(),
                "serving": profiler.serving_stats()}

    # -- protocol loop --------------------------------------------------------
    def _dispatch(self, op, p):
        if op == "predict":
            return self._op_predict(p)
        if op == "ping":
            return {"state": self._state, "addr": self.addr,
                    "info": self._info()}
        if op == "stats":
            return self._op_stats()
        if op == "drain":
            return self.drain(deregister=bool(p.get("deregister")),
                              timeout=p.get("timeout"))
        if op == "resume":
            return self.resume()
        if op == "swap":
            return self.swap(p)
        raise FleetError("replica: unknown op %r" % (op,))

    def _handle(self, conn):
        try:
            while not self._stop.is_set():
                op, p = _recv_msg(conn)
                if op == "stop":
                    _send_msg(conn, ("ok", None))
                    self.shutdown()
                    return
                try:
                    payload = self._dispatch(op, p or {})
                except Exception as e:
                    try:
                        _send_msg(conn, ("err", {
                            "kind": _error_kind(e),
                            "msg": "%s: %s" % (type(e).__name__, e)}))
                    except OSError:
                        raise ConnectionError("reply failed")
                    continue
                _send_msg(conn, ("ok", payload))
        except _TRANSPORT_ERRORS:
            pass
        finally:
            self._conns.discard(conn)
            conn.close()

    def serve_forever(self):
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conns.add(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def serve_in_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self, close_server=True):
        with self._cv:
            self._state = "stopped"
            self._stop.set()
            self._cv.notify_all()
        if self._client is not None:
            self._client.done()
            self._client.close()
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if close_server:
            self._server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
class _NeverSent(Exception):
    """Internal: the attempt failed before the request left the router
    — retry-safe on any replica regardless of idempotency."""


class _Handle:
    """Router-side view of one replica: published gauge + router-local
    in-flight + a small connection pool (one in-flight request per
    pooled socket)."""

    __slots__ = ("addr", "rank", "node_id", "alive", "state", "models",
                 "queued", "info", "inflight", "cooldown_until", "_pool",
                 "_lock", "group", "group_size", "group_rank", "group_ok")

    def __init__(self, addr, rank=0, node_id=None):
        self.addr = addr
        self.rank = rank
        self.node_id = node_id
        self.alive = True
        self.state = "serving"
        self.models = None          # None = unknown: route anything
        self.queued = 0
        self.info = {}
        self.group = None           # sharded replica group:
        self.group_size = 1         # only the leader (group_rank 0) is
        self.group_rank = 0         # routable, and only while ALL
        self.group_ok = True        # members are alive + serving
        self.inflight = 0           # router-local, atomic under _lock
        self.cooldown_until = 0.0   # transport-failure penalty box: a
        # WEDGED replica still heartbeats and publishes healthy, so
        # only the router's own failed attempts can steer load off it
        self._pool = []
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            return self.inflight + self.queued

    def acquire(self, connect_deadline):
        while True:
            with self._lock:
                if not self._pool:
                    break
                sock = self._pool.pop()
            # staleness probe: a pooled socket to a replica that died
            # since shows EOF/RST here — sending into it would succeed
            # locally and misclassify a NEVER-DELIVERED request as an
            # in-flight loss, breaking the idempotency retry contract.
            # setblocking(False), NOT MSG_DONTWAIT: Python's timeout
            # layer waits for readability before recv, so a leftover
            # per-attempt timeout would stall the probe and then
            # discard the LIVE socket as dead
            try:
                sock.setblocking(False)
                try:
                    if sock.recv(1, socket.MSG_PEEK):
                        raise OSError(
                            "unexpected bytes on idle connection")
                    # 0 bytes without raising = orderly EOF: dead
                    raise OSError("peer closed idle connection")
                finally:
                    sock.setblocking(True)
            except (BlockingIOError, InterruptedError):
                return sock  # no pending data: the connection is live
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
        return connect_with_backoff(self.addr, deadline=connect_deadline)

    def release(self, sock):
        with self._lock:
            if len(self._pool) < 64:
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self):
        with self._lock:
            pool, self._pool = self._pool, []
        for s in pool:
            try:
                s.close()
            except OSError:
                pass


class FleetRouter:
    """Routes requests to the least-loaded live replica with bounded,
    failure-classified retry (module docstring has the full story).

    Exactly one discovery source:

    - ``tracker_uri`` — coalesce the scheduler's ``members`` view
      (production mode; refreshed every ``MXNET_FLEET_VIEW_INTERVAL``);
    - ``replicas`` — a static ``["host:port", ...]`` list, refreshed by
      pinging each replica (tracker-less deployments);
    - ``view_fn`` — a callable returning the member-dict list (the
      subprocess-free unit-test seam).
    """

    def __init__(self, tracker_uri=None, replicas=None, view_fn=None,
                 retries=None, timeout=None, backoff=None,
                 view_interval=None, connect_deadline=None, qos=None):
        sources = sum(x is not None for x in (tracker_uri, replicas,
                                              view_fn))
        if sources != 1:
            raise FleetError("FleetRouter: pass exactly one of "
                             "tracker_uri=, replicas=, view_fn=")
        self._tracker_uri = tracker_uri
        # QoS admission boundary: quotas charged BEFORE the
        # retry loop — a rejected request never queues, never retries
        self._qos = QosPolicy.from_env() if qos is None else qos
        self._static = list(replicas) if replicas is not None else None
        self._view_fn = view_fn
        self._retries = _knob_retries() if retries is None \
            else int(retries)
        self._timeout = _knob_timeout() if timeout is None \
            else float(timeout)
        self._backoff = _knob_backoff() if backoff is None \
            else float(backoff)
        self._view_interval = _knob_view_interval() \
            if view_interval is None else float(view_interval)
        self._connect_deadline = _knob_connect_deadline() \
            if connect_deadline is None else float(connect_deadline)
        if self._retries < 0:
            raise FleetError("FleetRouter: retries must be >= 0, got %d"
                             % self._retries)
        self._handles = {}          # addr -> _Handle
        self._view_lock = threading.Lock()
        self._last_refresh = 0.0
        self._tracker_sock = None
        self._tracker_lock = threading.Lock()
        self._closed = False
        self.refresh_view(force=True)

    # -- discovery ------------------------------------------------------------
    def _tracker_rpc(self, op, payload=None, timeout=15.0):
        with self._tracker_lock:
            if self._tracker_sock is None:
                self._tracker_sock = connect_with_backoff(
                    self._tracker_uri, deadline=self._connect_deadline)
            sock = self._tracker_sock
            try:
                sock.settimeout(timeout)
                _send_msg(sock, (op, payload or {}))
                status, reply = _recv_msg(sock)
            except _TRANSPORT_ERRORS as e:
                self._tracker_sock = None
                try:
                    sock.close()
                except OSError:
                    pass
                raise TrackerError("fleet view rpc %r failed: %s"
                                   % (op, e))
        if status != "ok":
            raise TrackerError("fleet view: %s" % (reply,))
        return reply

    def _view_entries(self):
        if self._view_fn is not None:
            return list(self._view_fn())
        if self._tracker_uri is not None:
            return self._tracker_rpc("members", {"role": "replica"})
        # static mode: ping every address in PARALLEL with a short
        # connect bound — a sequential full-deadline connect loop on
        # one dead replica would stall the request thread that
        # triggered the refresh for seconds per refresh
        entries = [{"addr": addr, "alive": False, "done": False,
                    "rank": i, "node_id": None, "info": {}}
                   for i, addr in enumerate(self._static)]

        def ping(entry):
            try:
                reply = self._admin_rpc(
                    entry["addr"], "ping", timeout=2.0,
                    connect_deadline=min(1.0, self._connect_deadline))
                entry["alive"] = True
                entry["info"] = reply.get("info") or {}
            except FleetError:
                pass

        threads = [threading.Thread(target=ping, args=(e,), daemon=True)
                   for e in entries]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5.0)
        return entries

    def refresh_view(self, force=False):
        """Re-read the discovery plane (throttled to the view
        interval unless ``force``)."""
        now = time.monotonic()
        with self._view_lock:
            if not force and now - self._last_refresh < self._view_interval:
                return
            self._last_refresh = now
        try:
            entries = self._view_entries()
        except TrackerError:
            if not force:
                return  # keep routing on the stale view
            raise
        with self._view_lock:
            seen = set()
            for e in entries:
                addr = e.get("addr")
                if not addr:
                    continue
                seen.add(addr)
                h = self._handles.get(addr)
                if h is None:
                    h = self._handles[addr] = _Handle(
                        addr, rank=int(e.get("rank") or 0),
                        node_id=e.get("node_id"))
                info = e.get("info") or {}
                h.alive = bool(e.get("alive", True)) \
                    and not e.get("done", False)
                h.state = info.get("state", "serving")
                h.models = info.get("models")
                h.queued = int(info.get("queued") or 0)
                h.info = info
                h.rank = int(e.get("rank") or h.rank)
                h.group = info.get("group")
                h.group_size = int(info.get("group_size") or 1)
                h.group_rank = int(info.get("group_rank") or 0)
            for addr in list(self._handles):
                if addr not in seen:
                    self._handles.pop(addr).close()
            # sharded-group gate: a group is one routable
            # replica — its leader — and only while EVERY member is
            # alive and serving. One dead/draining member drains the
            # whole group (a partial group would hang or corrupt the
            # collective), so no request is ever routed to a torn group.
            members = {}
            for h in self._handles.values():
                if h.group is not None:
                    members.setdefault(h.group, []).append(h)
            for h in self._handles.values():
                if h.group is None:
                    h.group_ok = True
                    continue
                grp = members[h.group]
                h.group_ok = (
                    len(grp) >= h.group_size
                    and all(m.alive and m.state == "serving"
                            for m in grp))
            alive = sum(1 for h in self._handles.values()
                        if h.alive and h.state == "serving")
        profiler.fleet_record(replicas_alive=alive)

    def _routable(self, model, exclude, honor_cooldown=True):
        now = time.monotonic()
        with self._view_lock:
            handles = list(self._handles.values())
        return [h for h in handles
                if h.alive and h.state == "serving"
                and (h.group is None
                     or (h.group_rank == 0 and h.group_ok))
                and (h.models is None or model in h.models)
                and h.addr not in exclude
                and (not honor_cooldown or h.cooldown_until <= now)]

    def _pick(self, model, exclude):
        """Least-loaded live ``serving`` replica (router-local
        in-flight + published queue depth; rank breaks ties).
        Preference order degrades gracefully: skip replicas in the
        transport-failure penalty box, then skip only the ones this
        request already tried, then anything serving — after backoff a
        retried overload may well succeed on the same replica."""
        for ex, cool in ((exclude, True), (exclude, False),
                         (set(), False)):
            cands = self._routable(model, ex, honor_cooldown=cool)
            if cands:
                return min(cands,
                           key=lambda h: (h.load(), h.rank, h.addr))
        return None

    def replicas(self):
        """[(addr, state, alive, load)] snapshot of the current view."""
        with self._view_lock:
            return sorted(
                (h.addr, h.state, h.alive, h.load())
                for h in self._handles.values())

    # -- request path ---------------------------------------------------------
    def request(self, model, inputs, timeout=None, idempotent=True,
                tenant=None, priority=None):
        """Route one request; returns the list of output arrays.

        ``timeout`` overrides ``MXNET_FLEET_TIMEOUT`` as this request's
        end-to-end budget (attempts + backoff + replica queueing: the
        remaining budget rides to the replica as its shed deadline).
        ``idempotent=False`` disables the in-flight-loss retry: a
        request whose connection died after the send then raises
        :class:`ReplicaConnectionLost` instead of re-executing.
        ``tenant`` labels the request for QoS: the router
        charges the tenant's quota HERE, before any replica is picked —
        an over-quota request raises the typed
        :class:`TenantQuotaExceeded` without queueing or retrying —
        and the label rides the wire so the broker sheds by priority
        class at dequeue. ``priority`` overrides the tenant's class
        (an int from qos.PRIORITIES)."""
        self._check_open()
        budget = self._timeout if timeout is None else float(timeout)
        if not budget > 0:
            raise FleetError("request: timeout must be > 0, got %r"
                             % timeout)
        deadline = time.monotonic() + budget
        if not isinstance(inputs, dict):
            inputs = {"__single__": inputs}
        if self._qos is not None:
            sample = np.asarray(next(iter(inputs.values())))
            rows = int(sample.shape[0]) if sample.ndim else 1
            admitted_priority = self._qos.admit(tenant, rows=rows)
            if priority is None:
                priority = admitted_priority
        wire = {k: _np_to_wire(v) for k, v in inputs.items()}
        profiler.fleet_record(requests=1)
        t0 = time.perf_counter()
        self.refresh_view()
        exclude = set()
        attempts_left = self._retries
        overloaded_path = False
        last_err = None
        while True:
            h = self._pick(model, exclude)
            if h is None:
                try:
                    self.refresh_view(force=True)
                except TrackerError as e:
                    # a dead discovery plane must surface as the TYPED
                    # error (and count), not leak a raw TrackerError
                    profiler.fleet_record(failed=1)
                    raise NoLiveReplica(
                        "no routable replica for %r and the discovery "
                        "plane is unreachable (%s)" % (model, e))
                h = self._pick(model, exclude)
            if h is None:
                profiler.fleet_record(failed=1)
                if overloaded_path:
                    raise FleetOverloaded(
                        "no admitting replica for %r within the "
                        "budget (last: %s)" % (model, last_err))
                raise NoLiveReplica(
                    "no live serving replica for model %r (view: %s)"
                    % (model, self.replicas()))
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                profiler.fleet_record(failed=1)
                raise FleetOverloaded(
                    "request budget %.1fs exhausted after retries "
                    "(MXNET_FLEET_TIMEOUT; last: %s)"
                    % (budget, last_err))
            attempt_timeout = max(
                remaining / (attempts_left + 1.0), 0.05)
            try:
                outs = self._forward(h, model, wire, attempt_timeout,
                                     remaining, tenant=tenant,
                                     priority=priority)
                profiler.fleet_record(
                    completed=1,
                    latencies=[time.perf_counter() - t0])
                if tenant is not None:
                    profiler.qos_record(
                        str(tenant), completed=1,
                        latencies=[time.perf_counter() - t0])
                return outs
            except TenantQuotaExceeded:
                # replica-enforced quota: terminal by contract — the
                # budget is fleet-wide per tenant, retrying elsewhere
                # would just spend capacity circumventing it
                profiler.fleet_record(failed=1)
                raise
            except _NeverSent as e:
                profiler.fleet_record(failovers=1)
                h.cooldown_until = time.monotonic() + self._view_interval
                last_err = e
            except ReplicaConnectionLost as e:
                profiler.fleet_record(inflight_lost=1)
                # penalty box: a wedged replica looks healthy on the
                # tracker (it still beats + publishes) — only these
                # failed attempts can steer traffic off it
                h.cooldown_until = time.monotonic() \
                    + 2.0 * self._view_interval
                if not idempotent:
                    profiler.fleet_record(failed=1)
                    raise
                last_err = e
            except ReplicaDraining as e:
                # typed admission rejection: never executed, the
                # health-driven drain path — always retry elsewhere
                profiler.fleet_record(draining_rejections=1)
                self._mark_draining(h)
                last_err = e
            except ServerClosed as e:
                profiler.fleet_record(draining_rejections=1)
                self._mark_draining(h, state="closed")
                last_err = e
            except (DeadlineExceeded, ServerOverloaded) as e:
                profiler.fleet_record(overload_rejections=1)
                overloaded_path = True
                last_err = e
            # every other exception (FleetRemoteError, ServingError
            # validation) is a genuine failure: surface it unretried
            except FleetRemoteError:
                profiler.fleet_record(failed=1)
                raise
            exclude.add(h.addr)
            if attempts_left <= 0:
                profiler.fleet_record(failed=1)
                if overloaded_path or isinstance(
                        last_err, (DeadlineExceeded, ServerOverloaded)):
                    raise FleetOverloaded(
                        "retry budget %d exhausted under overload "
                        "(MXNET_FLEET_RETRIES; last: %s)"
                        % (self._retries, last_err))
                if isinstance(last_err, ReplicaConnectionLost):
                    raise last_err
                raise FleetError(
                    "retry budget %d exhausted (MXNET_FLEET_RETRIES; "
                    "last: %s)" % (self._retries, last_err))
            attempts_left -= 1
            profiler.fleet_record(retries=1)
            pause = min(
                self._backoff * (2 ** (self._retries - attempts_left - 1)),
                1.0, max(deadline - time.monotonic(), 0.0))
            if pause > 0:
                time.sleep(pause)

    predict = request

    def _mark_draining(self, handle, state="draining"):
        handle.state = state  # routed around until the next view says
        # otherwise (the replica re-publishes on resume)

    def _forward(self, h, model, wire, attempt_timeout, remaining,
                 tenant=None, priority=None):
        if chaos.router_fault("send"):
            raise _NeverSent("chaos: router drop (send)")
        try:
            sock = h.acquire(min(self._connect_deadline, attempt_timeout))
        except (TrackerError, OSError) as e:
            raise _NeverSent("connect to %s failed: %s" % (h.addr, e))
        with h._lock:
            h.inflight += 1
        sent = False
        try:
            try:
                sock.settimeout(attempt_timeout)
                _send_msg(sock, ("predict", {
                    "model": model, "inputs": wire,
                    "deadline": remaining, "tenant": tenant,
                    "priority": priority}))
                sent = True
                if chaos.router_fault("reply"):
                    raise ConnectionError("chaos: router drop (reply)")
                status, reply = _recv_msg(sock)
            except _TRANSPORT_ERRORS as e:
                try:
                    sock.close()
                except OSError:
                    pass
                if not sent:
                    raise _NeverSent(
                        "send to %s failed before the request left: %s"
                        % (h.addr, e))
                raise ReplicaConnectionLost(
                    "request to %s was sent but the connection died "
                    "before a reply (%s: %s) — the forward may have "
                    "executed" % (h.addr, type(e).__name__, e))
            h.release(sock)
        finally:
            with h._lock:
                h.inflight -= 1
        if status == "ok":
            return [_np_from_wire(w) for w in reply["outputs"]]
        kind = (reply or {}).get("kind", "error")
        msg = (reply or {}).get("msg", "replica error")
        err_cls = _KIND_TO_ERROR.get(kind)
        if err_cls is not None and kind in ("draining", "closed",
                                            "deadline", "overloaded",
                                            "quota"):
            raise err_cls("%s: %s" % (h.addr, msg))
        raise FleetRemoteError(kind, "%s: %s" % (h.addr, msg))

    # -- admin ----------------------------------------------------------------
    def _admin_rpc(self, addr, op, payload=None, timeout=None,
                   connect_deadline=None):
        timeout = (_knob_drain_timeout() + 15.0) if timeout is None \
            else float(timeout)
        try:
            sock = connect_with_backoff(
                addr, deadline=self._connect_deadline
                if connect_deadline is None else connect_deadline)
        except TrackerError as e:
            raise FleetError("admin %r: cannot reach %s (%s)"
                             % (op, addr, e))
        try:
            sock.settimeout(timeout)
            _send_msg(sock, (op, payload or {}))
            status, reply = _recv_msg(sock)
        except _TRANSPORT_ERRORS as e:
            raise FleetError("admin %r to %s failed: %s" % (op, addr, e))
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if status != "ok":
            kind = (reply or {}).get("kind", "error") \
                if isinstance(reply, dict) else "error"
            msg = (reply or {}).get("msg", reply) \
                if isinstance(reply, dict) else reply
            err_cls = _KIND_TO_ERROR.get(kind, FleetRemoteError)
            if err_cls is FleetRemoteError:
                raise FleetRemoteError(kind, "%s: %s" % (addr, msg))
            raise err_cls("%s: %s" % (addr, msg))
        return reply

    def drain(self, addr, deregister=False, timeout=None):
        """Explicit drain RPC: blocks until the replica finished its
        queued + in-flight work. The local view is marked immediately
        so this router routes around the drain before the replica's
        next publish lands."""
        with self._view_lock:
            h = self._handles.get(addr)
        if h is not None:
            self._mark_draining(h)
        return self._admin_rpc(addr, "drain",
                               {"deregister": bool(deregister),
                                "timeout": timeout})

    def resume(self, addr):
        return self._admin_rpc(addr, "resume")

    def replica_stats(self, addr):
        return self._admin_rpc(addr, "stats", timeout=15.0)

    def fleet_swap(self, directory=None, prefix=None, epoch=None,
                   model=None):
        """Roll a checkpoint across the fleet ONE replica at a time
        with zero dropped requests: drain (typed rejections route the
        traffic to the other replicas) → quiesced swap → resume +
        re-publish. Returns the number of replicas swapped."""
        if (prefix is None) == (directory is None):
            raise FleetError("fleet_swap: pass exactly one of prefix= "
                             "or directory=")
        self.refresh_view(force=True)
        with self._view_lock:
            targets = sorted(
                (h for h in self._handles.values() if h.alive),
                key=lambda h: (h.rank, h.addr))
        if not any(h.state == "serving" for h in targets):
            raise NoLiveReplica("fleet_swap: no live serving replica")
        payload = {"directory": directory, "prefix": prefix,
                   "epoch": epoch, "model": model}
        swapped = 0
        for h in targets:
            if h.state == "serving":
                self._mark_draining(h)
                self.drain(h.addr)
                self._admin_rpc(h.addr, "swap", payload)
                self.resume(h.addr)
                h.state = "serving"
            else:
                # an operator-drained replica gets the NEW weights too
                # (a later resume must not serve a stale generation)
                # but stays paused — draining was someone's decision
                self._admin_rpc(h.addr, "swap", payload)
            swapped += 1
            profiler.fleet_record(swaps=1)
        self.refresh_view(force=True)
        return swapped

    def stop_fleet(self):
        """Best-effort ``stop`` to every known replica (graceful fleet
        teardown — each replica entrypoint exits 0)."""
        self.refresh_view(force=True)
        with self._view_lock:
            addrs = [h.addr for h in self._handles.values() if h.alive]
        stopped = 0
        for addr in addrs:
            try:
                self._admin_rpc(addr, "stop", timeout=10.0)
                stopped += 1
            except FleetError:
                continue
        return stopped

    def stats(self, reset=False):
        """Router-side fleet counters (profiler.fleet_stats)."""
        return profiler.fleet_stats(reset=reset)

    # -- lifecycle ------------------------------------------------------------
    def _check_open(self):
        if self._closed:
            raise FleetError("FleetRouter is closed")

    def close(self):
        if self._closed:
            return
        self._closed = True
        with self._view_lock:
            handles = list(self._handles.values())
        for h in handles:
            h.close()
        with self._tracker_lock:
            if self._tracker_sock is not None:
                try:
                    self._tracker_sock.close()
                except OSError:
                    pass
                self._tracker_sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# entry points (a launch.py --serve supervisor spawns the replica one)
# ---------------------------------------------------------------------------
def _env_tracker_uri(explicit=None):
    if explicit:
        return explicit
    host = os.environ.get("DMLC_PS_ROOT_URI")
    port = os.environ.get("DMLC_PS_ROOT_PORT")
    return "%s:%s" % (host, port) if host and port else None


def _parse_data_shapes(specs):
    shapes = {}
    for spec in specs:
        name, sep, dims = spec.partition(":")
        if not sep or not name:
            raise FleetError(
                "--data-shape %r: expected name:d0,d1,..." % spec)
        try:
            shapes[name] = tuple(int(d) for d in dims.split(","))
        except ValueError:
            raise FleetError(
                "--data-shape %r: dims must be integers" % spec)
    return shapes


def _replica_main(argv):
    ap = argparse.ArgumentParser(
        prog="mxnet_tpu_torch.serving.fleet replica",
        description="Serving-fleet replica: ModelServer behind the "
                    "tracker-discovered wire endpoint")
    ap.add_argument("--model", default="model",
                    help="resident model name (default: model)")
    ap.add_argument("--prefix", required=True,
                    help="two-artifact checkpoint prefix to serve")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--data-shape", action="append", required=True,
                    help="input spec name:d0,d1,... (repeatable); the "
                         "leading dim is the batch axis")
    ap.add_argument("--ladder", default=None,
                    help="batch ladder override, e.g. 1,4,16")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on: cuda (the default; "
                         "raises without a card) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--tracker", default=None,
                    help="scheduler URI (default: DMLC_PS_ROOT_URI/"
                         "PORT from the launch.py env)")
    ap.add_argument("--pin-core", type=int, default=None,
                    help="pin this process to one CPU core (bench "
                         "determinism on shared hosts)")
    ap.add_argument("--group", default=None,
                    help="sharded replica group name: all members of one "
                         "mesh publish the same group; the router routes "
                         "only to its rank-0 leader while every member is "
                         "alive (a group of more than one member raises: "
                         "not ported)")
    ap.add_argument("--group-size", type=int, default=1)
    ap.add_argument("--group-rank", type=int, default=0)
    args = ap.parse_args(argv)
    if args.group is not None and args.group_size > 1:
        raise FleetError("--group-size %d: a sharded replica group is not "
                         "ported yet (ROADMAP.md Queue A item 8b)"
                         % args.group_size)

    if args.pin_core is not None and hasattr(os, "sched_setaffinity"):
        try:
            os.sched_setaffinity(0, {args.pin_core})
        except OSError:
            pass

    from ..model import load_checkpoint

    symbol, arg_params, aux_params = load_checkpoint(args.prefix,
                                                     args.epoch)
    ladder = tuple(int(b) for b in args.ladder.split(",")) \
        if args.ladder else None
    server = ModelServer(ladder=ladder, dtype=args.dtype, device=args.device)
    server.add_model(args.model, symbol=symbol, arg_params=arg_params,
                     aux_params=aux_params,
                     data_shapes=_parse_data_shapes(args.data_shape))
    # run the smallest bucket once before admitting traffic, so the first
    # routed request does not pay for lazy module loading
    shapes = _parse_data_shapes(args.data_shape)
    warm = {n: np.zeros((1,) + tuple(s[1:]), np.float32)
            for n, s in shapes.items()}
    server.predict(args.model, warm)

    rank = os.environ.get("DMLC_REPLICA_ID")
    restart = int(os.environ.get("DMLC_RESTART_COUNT", "0") or 0)
    replica = ReplicaServer(
        server, tracker_uri=_env_tracker_uri(args.tracker),
        host=args.host, port=args.port,
        rank=int(rank) if rank is not None else None, restart=restart,
        group=args.group, group_size=args.group_size,
        group_rank=args.group_rank)

    exit_code = [0]

    def _sigterm(signum, frame):
        # preemption contract: exit with the resumable status so a
        # launch.py --serve supervisor respawns this replica for free
        exit_code[0] = EXIT_PREEMPTED
        replica.shutdown()

    signal.signal(signal.SIGTERM, _sigterm)
    print("replica rank=%s listening on %s (model=%r pid=%d)"
          % (replica.rank, replica.addr, args.model, os.getpid()),
          flush=True)
    replica.serve_forever()
    replica.shutdown()
    return exit_code[0]


def _router_main(argv):
    ap = argparse.ArgumentParser(
        prog="mxnet_tpu_torch.serving.fleet router",
        description="Fleet admin client: inspect/drain/swap/stop the "
                    "tracker-discovered replica fleet")
    ap.add_argument("command",
                    choices=("status", "drain", "resume", "swap",
                             "stop"))
    ap.add_argument("--tracker", default=None,
                    help="scheduler URI (default: DMLC_PS_ROOT_URI/"
                         "PORT)")
    ap.add_argument("--addr", default=None,
                    help="target replica for drain/resume")
    ap.add_argument("--deregister", action="store_true")
    ap.add_argument("--directory", default=None)
    ap.add_argument("--prefix", default=None)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--model", default=None)
    args = ap.parse_args(argv)
    uri = _env_tracker_uri(args.tracker)
    if uri is None:
        ap.error("no tracker: pass --tracker or set "
                 "DMLC_PS_ROOT_URI/PORT")
    with FleetRouter(tracker_uri=uri) as router:
        if args.command == "status":
            out = {"replicas": [
                {"addr": a, "state": s, "alive": al, "load": ld}
                for a, s, al, ld in router.replicas()]}
        elif args.command in ("drain", "resume"):
            if not args.addr:
                ap.error("%s needs --addr" % args.command)
            fn = router.drain if args.command == "drain" else \
                router.resume
            out = fn(args.addr) if args.command == "resume" else \
                router.drain(args.addr, deregister=args.deregister)
        elif args.command == "swap":
            out = {"swapped": router.fleet_swap(
                directory=args.directory, prefix=args.prefix,
                epoch=args.epoch, model=args.model)}
        else:
            out = {"stopped": router.stop_fleet()}
        print(json.dumps(out))
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("replica", "router", "autoscaler"):
        print("usage: python -m mxnet_tpu_torch.serving.fleet "
              "{replica|router|autoscaler} ...", file=sys.stderr)
        return 2
    if argv[0] == "replica":
        return _replica_main(argv[1:])
    if argv[0] == "autoscaler":
        from .autoscale import main as autoscale_main

        return autoscale_main(argv[1:])
    return _router_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
