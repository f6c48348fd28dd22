"""Multi-tenant admission QoS for the serving fleet (counterpart of
``mxnet_tpu/serving/qos.py``: the same grammar, buckets, classes and
errors).

- **Admission quotas.** Each tenant may carry a request-rate and a
  token-rate budget (tokens are rows: the leading batch dimension a
  request occupies in the bucket ladder). Budgets are token buckets
  refilled continuously and enforced at admission, the router or replica
  boundary, with the typed :class:`TenantQuotaExceeded`. A rejected
  request never queues and is never retried: the quota is the tenant's
  contract, not replica state.
- **Priority classes.** ``latency`` < ``normal`` < ``bulk`` (lower sorts
  first). The class rides the wire with the request and decides the
  dequeue order in the broker (``serving/broker.py``): a latency request
  jumps queued bulk work, so under overload the bulk tenant's requests
  wait, expire and are shed at dequeue before the latency tenant's p99
  moves. Nothing is preempted mid-batch.

Tenants are configured through ``MXNET_QOS_TENANTS`` (or the equivalent
``tenants=`` dict)::

    MXNET_QOS_TENANTS="bulk:prio=bulk,req_rate=50,tok_rate=2000;\
interactive:prio=latency"

Grammar: ``tenant (';' tenant)*`` where ``tenant`` is
``name[:key=value(,key=value)*]`` and keys are ``prio``/``priority``
(latency|normal|bulk), ``req_rate`` (requests/s, float > 0) and
``tok_rate`` (rows/s, float > 0). An omitted budget is unlimited; an
unknown tenant gets the default priority and no quota. A malformed spec
raises :class:`~mxnet_tpu_torch.base.MXNetError` naming the knob.

Per-tenant counters (requests, admitted, quota_rejections, shed, rows and
a latency reservoir) ride ``profiler.qos_stats`` into ``dump_profile`` as
``qosStats``.
"""
from __future__ import annotations

import threading
import time

from .. import config, profiler
from ..base import MXNetError
from .predictor import ServingError

#: priority classes, lower = served first. The broker sorts its queue
#: by this value at dequeue (stable — FIFO within a class).
PRIORITIES = {"latency": 0, "normal": 1, "bulk": 2}
DEFAULT_PRIORITY = PRIORITIES["normal"]


class TenantQuotaExceeded(ServingError):
    """A tenant's admission budget (request-rate or token-rate) is
    exhausted. Typed and TERMINAL: the request was never queued, and
    the router must not retry it on another replica — the quota is
    fleet-wide per tenant, not a property of the replica that said
    no. Wire kind: ``quota``."""

    def __init__(self, msg, tenant=None):
        super().__init__(msg)
        self.tenant = tenant


def _knob_burst():
    return config.get_positive_float("MXNET_QOS_BURST_SECONDS")


def _knob_default_priority():
    return PRIORITIES[config.get_choice("MXNET_QOS_DEFAULT_PRIORITY",
                                        tuple(PRIORITIES))]


class TokenBucket:
    """Continuous-refill token bucket: ``rate`` units/second with a
    burst capacity of ``rate * burst_seconds`` (>= 1 so a rate below
    1/burst still admits single requests eventually)."""

    __slots__ = ("rate", "capacity", "level", "t_last")

    def __init__(self, rate, burst_seconds=1.0):
        self.rate = float(rate)
        self.capacity = max(self.rate * float(burst_seconds), 1.0)
        self.level = self.capacity
        self.t_last = None

    def try_take(self, n, now):
        """Refill to ``now`` and take ``n`` units; False when the
        bucket cannot cover them (nothing is taken)."""
        if self.t_last is not None and now > self.t_last:
            self.level = min(self.capacity,
                             self.level + (now - self.t_last) * self.rate)
        self.t_last = now
        if n <= self.level + 1e-9:
            self.level -= n
            return True
        return False


class _Tenant:
    __slots__ = ("name", "priority", "req_bucket", "tok_bucket")

    def __init__(self, name, priority, req_rate, tok_rate, burst):
        self.name = name
        self.priority = priority
        self.req_bucket = TokenBucket(req_rate, burst) \
            if req_rate is not None else None
        self.tok_bucket = TokenBucket(tok_rate, burst) \
            if tok_rate is not None else None


def _spec_error(detail):
    raise MXNetError("MXNET_QOS_TENANTS: %s" % detail)


def parse_tenants(text):
    """``MXNET_QOS_TENANTS`` grammar -> {name: {"priority", "req_rate",
    "tok_rate"}}. Raises MXNetError naming the knob on any malformed
    piece — a fleet that silently dropped a tenant's quota would
    certify isolation that does not exist."""
    tenants = {}
    for chunk in (text or "").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, _, tail = chunk.partition(":")
        name = name.strip()
        if not name:
            _spec_error("empty tenant name in %r" % chunk)
        if name in tenants:
            _spec_error("tenant %r configured twice" % name)
        spec = {"priority": None, "req_rate": None, "tok_rate": None}
        for kv in filter(None, (s.strip() for s in tail.split(","))):
            k, sep, v = kv.partition("=")
            if not sep or not k.strip() or not v.strip():
                _spec_error("bad parameter %r for tenant %r "
                            "(expected key=value)" % (kv, name))
            k, v = k.strip(), v.strip()
            if k in ("prio", "priority"):
                if v not in PRIORITIES:
                    _spec_error("tenant %r: priority %r not one of %s"
                                % (name, v, "|".join(PRIORITIES)))
                spec["priority"] = PRIORITIES[v]
            elif k in ("req_rate", "tok_rate"):
                try:
                    rate = float(v)
                except ValueError:
                    rate = float("nan")
                if not rate > 0:
                    _spec_error("tenant %r: %s=%r must be a float > 0"
                                % (name, k, v))
                spec[k] = rate
            else:
                _spec_error("tenant %r: unknown key %r (expected "
                            "prio|req_rate|tok_rate)" % (name, k))
        tenants[name] = spec
    return tenants


class QosPolicy:
    """Per-tenant admission policy: quotas + priority classes.

    Thread-safe; one instance guards one admission boundary (a
    FleetRouter, or a ReplicaServer for deployments with several
    routers). ``tenants`` maps name -> dict with optional ``priority``
    (int or class name), ``req_rate``, ``tok_rate``; when None the
    ``MXNET_QOS_TENANTS`` knob is parsed instead."""

    def __init__(self, tenants=None, default_priority=None,
                 burst_seconds=None):
        burst = _knob_burst() if burst_seconds is None \
            else float(burst_seconds)
        if not burst > 0:
            _spec_error("burst_seconds must be > 0, got %r" % burst_seconds)
        self._default_priority = _knob_default_priority() \
            if default_priority is None else self._as_priority(
                default_priority)
        if tenants is None:
            tenants = parse_tenants(config.get("MXNET_QOS_TENANTS"))
        self._lock = threading.Lock()
        self._tenants = {}
        for name, spec in tenants.items():
            prio = spec.get("priority")
            self._tenants[str(name)] = _Tenant(
                str(name),
                self._default_priority if prio is None
                else self._as_priority(prio),
                spec.get("req_rate"), spec.get("tok_rate"), burst)

    @staticmethod
    def _as_priority(value):
        if isinstance(value, str):
            if value not in PRIORITIES:
                _spec_error("priority %r not one of %s"
                            % (value, "|".join(PRIORITIES)))
            return PRIORITIES[value]
        v = int(value)
        if v not in PRIORITIES.values():
            _spec_error("priority %r not one of %r"
                        % (value, sorted(PRIORITIES.values())))
        return v

    @classmethod
    def from_env(cls):
        """Policy from ``MXNET_QOS_TENANTS``, or None when the knob is
        empty (no QoS boundary configured — zero per-request cost)."""
        tenants = parse_tenants(config.get("MXNET_QOS_TENANTS"))
        return cls(tenants=tenants) if tenants else None

    def tenants(self):
        with self._lock:
            return sorted(self._tenants)

    def priority_of(self, tenant):
        """The tenant's dequeue class (unknown tenants: the default)."""
        if tenant is None:
            return self._default_priority
        with self._lock:
            t = self._tenants.get(str(tenant))
        return self._default_priority if t is None else t.priority

    def admit(self, tenant, rows=1, now=None):
        """Charge one request of ``rows`` tokens against the tenant's
        budgets; returns the tenant's priority class. Raises the typed
        :class:`TenantQuotaExceeded` when either budget is exhausted —
        the caller must surface it, never queue or retry. Counted per
        tenant in ``qosStats``."""
        label = None if tenant is None else str(tenant)
        if label is not None:
            profiler.qos_record(label, requests=1)
        with self._lock:
            t = None if label is None else self._tenants.get(label)
            if t is None:
                if label is not None:
                    profiler.qos_record(label, admitted=1,
                                        rows=int(rows))
                return self._default_priority
            now = time.monotonic() if now is None else float(now)
            exhausted = None
            if t.req_bucket is not None and \
                    not t.req_bucket.try_take(1, now):
                exhausted = "request-rate (req_rate=%g/s)" \
                    % t.req_bucket.rate
            elif t.tok_bucket is not None and \
                    not t.tok_bucket.try_take(int(rows), now):
                exhausted = "token-rate (tok_rate=%g rows/s)" \
                    % t.tok_bucket.rate
            priority = t.priority
        if exhausted is not None:
            profiler.qos_record(label, quota_rejections=1)
            raise TenantQuotaExceeded(
                "tenant %r over its %s budget: request rejected at "
                "admission (never queued; do not retry elsewhere)"
                % (label, exhausted), tenant=label)
        profiler.qos_record(label, admitted=1, rows=int(rows))
        return priority
