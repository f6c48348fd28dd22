"""Deterministic fault injection (counterpart of ``mxnet_tpu/chaos.py``).

``MXNET_FAULT_SPEC`` describes exactly which process fails, where and
how, and a hook fires the fault at the same point on every run. The
grammar is the JAX package's, whole, so every spec parses (or fails to
parse) alike in both packages::

    spec   := rule (';' rule)*
    rule   := target '@' params
    target := ('worker'|'server'|'replica') ':' rank ':' action
            | ('rpc'|'router') ':' 'drop'
            | 'heartbeat' ':' 'stall'
            | 'generate' ':' 'stall'
            | 'autoscaler' ':' 'crash'
    params := key '=' value (',' key '=' value)*

with the JAX package's actions and required parameters: ``worker`` crash,
nan or preempt and ``server`` crash or preempt at ``step=N``; ``replica``
crash or stall at ``req=N``; ``rpc``/``router`` drop with ``p``/``seed``,
``n``, ``phase`` (and ``op``, ``side`` for rpc only); ``heartbeat`` stall
``after=N``; ``autoscaler`` crash at ``tick=N``; ``restart=K|any``.

Every target has its hook in the port, where the JAX package has it:

``worker:R:crash@step=N``  /  ``server:R:crash@step=N``
    The matching process hard-exits (``os._exit(137)``, the SIGKILL
    status: no atexit hook, no ``done`` report) at its N-th step. A worker
    step is one optimizer round (``model._update_params*``, or one fused
    step of ``Module``); a server step is one applied push. Crash rules
    fire only in the first incarnation (``restart`` defaults to 0).

``worker:R:nan@step=N``
    The worker's N-th optimizer round runs with a poisoned gradient: the
    per-executor tiers overwrite one gradient array with NaN before the
    update or push, the fused tier multiplies the step's first data input
    by NaN, so every gradient of the step goes non-finite: the silent
    fault the sentinel and ``health.HealthGuard`` exist to catch. Fires
    once a incarnation.

``worker:R:preempt@step=N``  /  ``server:R:preempt@step=N``
    The process sends SIGTERM to itself at its N-th step: with the
    preemption handler installed (``health.py``) it drains, checkpoints
    inside ``MXNET_PREEMPT_GRACE`` and exits with ``EXIT_PREEMPTED`` (75);
    without it the default disposition kills it like a crash.

``rpc:drop@op=OP[,p=P,seed=S][,n=N][,phase=send|reply][,side=client|server]``
    A connection drop on a matching kvstore RPC: ``send`` before the
    request leaves the client, ``reply`` after it was applied but before
    the reply is read (the retry exercises the seqno dedupe),
    ``side=server`` before the server applies it.

``replica:R:crash@req=N``  /  ``replica:R:stall@req=N``
    Serving-fleet faults, counted in ADMITTED requests of the replica
    whose rank is R (``DMLC_REPLICA_ID``; ``role`` is ``DMLC_ROLE``).
    ``crash`` hard-exits (``os._exit(137)``, the SIGKILL status: no atexit
    hook, no ``done``) at the N-th admitted request, once per incarnation
    (``restart`` gating defaults to 0). ``stall`` wedges request serving
    from the N-th request on (sockets and heartbeats stay open), the
    wedged-but-alive replica only the router's per-attempt deadline
    catches; it defaults to ``restart=any``.

``router:drop@[p=P,seed=S|n=N][,phase=send|reply]``
    Connection drop on a router-to-replica forward: ``send`` before the
    request leaves (never sent: retried anywhere), ``reply`` after it was
    delivered (an in-flight loss: retried only when idempotent).

``autoscaler:crash@tick=N``
    The autoscale controller hard-exits at its N-th control tick (the
    fail-static contract: the fleet keeps serving at its current size).

``heartbeat:stall@after=N``
    The tracker client stops beating after its N-th beat while its
    sockets stay open (the wedged process the heartbeat timeout catches).

``generate:stall@req=N``
    The N-th ADMITTED generate request never emits EOS — the
    wedged-generation simulation: the request's EOS check is suppressed
    so only the ``MXNET_GENERATE_MAX_STEPS`` cap (or its deadline) can
    finish it. The cap fires, the request finishes with reason
    ``length``, and its batch slot and KV pages are reclaimed for the
    requests queued behind it. Fires once (``restart`` gating defaults
    to ``any``: the serving loop has no incarnations).

A malformed spec raises :class:`FaultSpecError` at parse time: a chaos
harness that silently does nothing would certify recovery paths that were
never exercised.
"""
from __future__ import annotations

import os
import random
import signal
import sys

from . import config

_TARGETS = ("worker", "server", "replica", "rpc", "router", "heartbeat",
            "generate", "autoscaler")
_ACTIONS = {"worker": ("crash", "nan", "preempt"),
            "server": ("crash", "preempt"),
            "replica": ("crash", "stall"),
            "rpc": ("drop",), "router": ("drop",),
            "heartbeat": ("stall",),
            "generate": ("stall",),
            "autoscaler": ("crash",)}
_EXIT_CODE = 137  # SIGKILL'd processes report 128+9; crash mimics that


class FaultSpecError(ValueError):
    """MXNET_FAULT_SPEC could not be parsed (or is inconsistent)."""


def _parse_int(rule_text, key, value):
    try:
        return int(value)
    except ValueError:
        raise FaultSpecError(
            "fault rule %r: %s=%r is not an integer" % (rule_text, key, value))


class _Rule:
    __slots__ = ("text", "target", "rank", "action", "params", "rng",
                 "fired", "matched")

    def __init__(self, text):
        self.text = text
        self.fired = 0
        self.matched = 0
        head, sep, tail = text.partition("@")
        if not sep or not tail:
            raise FaultSpecError(
                "fault rule %r: expected '<target>@<k=v,...>'" % text)
        parts = head.split(":")
        if parts[0] not in _TARGETS:
            raise FaultSpecError(
                "fault rule %r: unknown target %r (expected one of %s)"
                % (text, parts[0], "/".join(_TARGETS)))
        self.target = parts[0]
        if self.target in ("worker", "server", "replica"):
            if len(parts) != 3:
                raise FaultSpecError(
                    "fault rule %r: expected '%s:<rank>:<action>@...'"
                    % (text, self.target))
            self.rank = _parse_int(text, "rank", parts[1])
            self.action = parts[2]
        else:
            if len(parts) != 2:
                raise FaultSpecError(
                    "fault rule %r: expected '%s:<action>@...'"
                    % (text, self.target))
            self.rank = None
            self.action = parts[1]
        if self.action not in _ACTIONS[self.target]:
            raise FaultSpecError(
                "fault rule %r: target %r supports actions %s, got %r"
                % (text, self.target, "/".join(_ACTIONS[self.target]),
                   self.action))
        self.params = {}
        for kv in tail.split(","):
            k, sep, v = kv.partition("=")
            if not sep or not k:
                raise FaultSpecError(
                    "fault rule %r: bad parameter %r (expected k=v)"
                    % (text, kv))
            self.params[k.strip()] = v.strip()
        self._validate()
        p = self.params.get("p")
        self.rng = random.Random(_parse_int(text, "seed",
                                            self.params.get("seed", "0"))) \
            if p is not None else None

    def _validate(self):
        p = self.params
        if self.target in ("replica", "generate"):
            # replica/generate faults count admitted requests, not
            # train steps
            if "req" not in p:
                raise FaultSpecError(
                    "fault rule %r: %s %s requires req=N"
                    % (self.text, self.target, self.action))
        elif self.target == "autoscaler":
            # autoscaler faults count control ticks — the controller
            # has neither train steps nor admitted requests
            if "tick" not in p:
                raise FaultSpecError(
                    "fault rule %r: autoscaler crash requires tick=N"
                    % self.text)
        elif self.action in ("crash", "nan", "preempt") and "step" not in p:
            raise FaultSpecError(
                "fault rule %r: %s requires step=N"
                % (self.text, self.action))
        if self.target == "heartbeat" and "after" not in p:
            raise FaultSpecError(
                "fault rule %r: stall requires after=N" % self.text)
        if self.target == "router":
            for bad in ("op", "side"):
                if bad in p:
                    raise FaultSpecError(
                        "fault rule %r: %s only applies to rpc rules "
                        "(the router drop always targets the "
                        "router→replica forward)" % (self.text, bad))
        for key in ("step", "after", "req", "n", "seed", "tick"):
            if key in p:
                _parse_int(self.text, key, p[key])
        if "p" in p:
            try:
                prob = float(p["p"])
            except ValueError:
                raise FaultSpecError(
                    "fault rule %r: p=%r is not a float"
                    % (self.text, p["p"]))
            if not 0.0 <= prob <= 1.0:
                raise FaultSpecError(
                    "fault rule %r: p=%s out of [0, 1]" % (self.text, prob))
        if p.get("phase", "send") not in ("send", "reply"):
            raise FaultSpecError(
                "fault rule %r: phase must be send|reply" % self.text)
        if p.get("side", "client") not in ("client", "server"):
            raise FaultSpecError(
                "fault rule %r: side must be client|server" % self.text)
        if p.get("side") == "server" and "phase" in p:
            # the server hook fires before the op is applied — there is
            # no reply phase there; silently ignoring the param would
            # certify a recovery path that was never exercised
            raise FaultSpecError(
                "fault rule %r: phase only applies to side=client "
                "(the server-side drop always happens before the op "
                "is applied)" % self.text)
        restart = p.get("restart")
        if restart is not None and restart != "any":
            _parse_int(self.text, "restart", restart)

    # -- matching ------------------------------------------------------------
    def restart_matches(self, restart, default="0"):
        want = self.params.get("restart", default)
        if want == "any":
            return True
        return int(want) == restart

    def should_fire(self):
        """Count/probability gate shared by rpc/heartbeat rules; call
        only after the structural match succeeded."""
        self.matched += 1
        if "n" in self.params:
            return self.matched <= int(self.params["n"])
        if self.rng is not None:
            return self.rng.random() < float(self.params["p"])
        return True


def parse_spec(text):
    """MXNET_FAULT_SPEC text -> [_Rule]. Raises FaultSpecError."""
    rules = []
    for chunk in (text or "").split(";"):
        chunk = chunk.strip()
        if chunk:
            rules.append(_Rule(chunk))
    return rules


class ChaosEngine:
    """One process's view of the fault spec: its role, rank and
    incarnation (restart count), its counts of steps, admitted requests,
    beats and control ticks; fires the matching rules."""

    def __init__(self, spec, role=None, rank=None, restart=None):
        self.rules = parse_spec(spec)
        self.role = role if role is not None else \
            os.environ.get("DMLC_ROLE", "worker").lower()
        if rank is None:
            if self.role == "server":
                rank = os.environ.get("DMLC_SERVER_ID", "0")
            elif self.role == "replica":
                rank = os.environ.get("DMLC_REPLICA_ID", "0")
            else:
                rank = (os.environ.get("DMLC_WORKER_ID")
                        or os.environ.get("DMLC_RANK")
                        or os.environ.get("MXNET_TPU_WORKER_ID") or "0")
        self.rank = int(rank or 0)
        if restart is None:
            restart = os.environ.get("DMLC_RESTART_COUNT", "0")
        self.restart = int(restart or 0)
        self._step = 0
        self._beats = 0
        self._reqs = 0
        self._gen_reqs = 0
        self._as_ticks = 0
        self._exit = os._exit  # injectable for tests
        self._kill = lambda: os.kill(os.getpid(), signal.SIGTERM)  # ditto

    def _crash(self, rule):
        print("[chaos] injecting crash: rule %r fired at %s %d step %d "
              "(restart %d)" % (rule.text, self.role, self.rank,
                                self._step, self.restart),
              file=sys.stderr, flush=True)
        sys.stderr.flush()
        self._exit(_EXIT_CODE)

    def _preempt(self, rule):
        print("[chaos] injecting preemption (SIGTERM to self): rule %r "
              "fired at %s %d step %d (restart %d)"
              % (rule.text, self.role, self.rank, self._step,
                 self.restart), file=sys.stderr, flush=True)
        sys.stderr.flush()
        self._kill()

    def _match_step_rule(self, rule, action, step):
        return (rule.action == action and rule.target == self.role
                and rule.rank == self.rank
                and rule.restart_matches(self.restart)
                and step == int(rule.params["step"])
                and not rule.fired)

    def step(self):
        """One unit of progress (worker: an optimizer round; server: an
        applied push); fires the crash and preempt rules of this step."""
        self._step += 1
        for rule in self.rules:
            if self._match_step_rule(rule, "crash", self._step):
                rule.fired += 1
                self._crash(rule)
            elif self._match_step_rule(rule, "preempt", self._step):
                rule.fired += 1
                self._preempt(rule)

    def nan(self):
        """True when the round about to run matches a nan rule. Callers ask
        before their ``tick_step()`` of the round (the gradient is poisoned
        before the update consumes it), so this matches ``step + 1``."""
        nxt = self._step + 1
        for rule in self.rules:
            if self._match_step_rule(rule, "nan", nxt):
                rule.fired += 1
                print("[chaos] poisoning gradient with NaN: rule %r "
                      "fired at %s %d step %d (restart %d)"
                      % (rule.text, self.role, self.rank, nxt,
                         self.restart), file=sys.stderr, flush=True)
                return True
        return False

    def replica_request(self):
        """Count one admitted serving request; fire matching replica
        rules. Returns ``"stall"`` when the handler must wedge (serve
        nothing, keep the socket open), None otherwise; a matching crash
        rule never returns."""
        self._reqs += 1
        for rule in self.rules:
            if (rule.target != "replica" or rule.rank != self.rank
                    or self.role != "replica"):
                continue
            if rule.action == "crash" \
                    and rule.restart_matches(self.restart) \
                    and self._reqs == int(rule.params["req"]) \
                    and not rule.fired:
                rule.fired += 1
                self._step = self._reqs  # the crash log names a "step"
                self._crash(rule)
            elif rule.action == "stall" \
                    and rule.restart_matches(self.restart, default="any") \
                    and self._reqs >= int(rule.params["req"]):
                if not rule.fired:
                    rule.fired += 1
                    print("[chaos] wedging replica (stall): rule %r "
                          "fired at replica %d request %d (restart %d)"
                          % (rule.text, self.rank, self._reqs,
                             self.restart), file=sys.stderr, flush=True)
                return "stall"
        return None

    def generate_request(self):
        """Count one admitted generate request; returns ``"stall"``
        when this request must never emit EOS (generate:stall@req=N —
        only the max-decode-steps cap or its deadline can finish it),
        None otherwise."""
        self._gen_reqs += 1
        for rule in self.rules:
            if rule.target != "generate" or rule.action != "stall":
                continue
            if not rule.restart_matches(self.restart, default="any"):
                continue
            if self._gen_reqs == int(rule.params["req"]) \
                    and not rule.fired:
                rule.fired += 1
                print("[chaos] suppressing EOS (generate stall): rule "
                      "%r fired at generate request %d"
                      % (rule.text, self._gen_reqs),
                      file=sys.stderr, flush=True)
                return "stall"
        return None

    def autoscaler_tick(self):
        """Count one autoscaler control tick; a matching
        ``autoscaler:crash@tick=N`` rule hard-exits the controller.
        Role and rank free (``restart`` gating defaults to ``any``)."""
        self._as_ticks += 1
        for rule in self.rules:
            if rule.target != "autoscaler" or rule.action != "crash":
                continue
            if not rule.restart_matches(self.restart, default="any"):
                continue
            if self._as_ticks == int(rule.params["tick"]) \
                    and not rule.fired:
                rule.fired += 1
                self._step = self._as_ticks  # the crash log's "step"
                self._crash(rule)

    def router_drop(self, phase="send"):
        """True when a matching router:drop rule fires for this
        router-to-replica forward attempt."""
        for rule in self.rules:
            if rule.target != "router" or rule.action != "drop":
                continue
            if not rule.restart_matches(self.restart, default="any"):
                continue
            if rule.params.get("phase", "send") != phase:
                continue
            if rule.should_fire():
                print("[chaos] dropping router forward (%s) per rule %r"
                      % (phase, rule.text), file=sys.stderr, flush=True)
                return True
        return False

    def rpc(self, op, phase="send", side="client"):
        """True when a matching rpc:drop rule fires for this op."""
        for rule in self.rules:
            if rule.target != "rpc" or rule.action != "drop":
                continue
            if not rule.restart_matches(self.restart, default="any"):
                continue
            want_op = rule.params.get("op")
            if want_op is not None and want_op != op:
                continue
            if rule.params.get("side", "client") != side:
                continue
            if side == "client" and rule.params.get("phase", "send") != phase:
                continue
            if rule.should_fire():
                print("[chaos] dropping rpc %r (%s/%s) per rule %r"
                      % (op, side, phase, rule.text),
                      file=sys.stderr, flush=True)
                return True
        return False

    def heartbeat(self):
        """True when the heartbeat should be suppressed (stall rule)."""
        self._beats += 1
        for rule in self.rules:
            if (rule.target == "heartbeat" and rule.action == "stall"
                    and rule.restart_matches(self.restart, default="any")
                    and self._beats > int(rule.params["after"])):
                return True
        return False


# ---------------------------------------------------------------------------
# process-wide engine (env-driven), with cheap no-op fast path
# ---------------------------------------------------------------------------
_UNSET = object()
_ENGINE = _UNSET


def engine():
    """The process's ChaosEngine, parsed once from MXNET_FAULT_SPEC;
    None when the env var is unset/empty (the common case — every hook
    is then a single attribute check)."""
    global _ENGINE
    if _ENGINE is _UNSET:
        spec = (config.get("MXNET_FAULT_SPEC") or "").strip()
        _ENGINE = ChaosEngine(spec) if spec else None
    return _ENGINE


def reset_engine():
    """Forget the cached engine (tests that monkeypatch the env)."""
    global _ENGINE
    _ENGINE = _UNSET


def tick_step():
    """One worker optimizer round or one applied server push: fires the
    crash and preempt rules of the step."""
    e = engine()
    if e is not None:
        e.step()


def nan_fault():
    """True when the upcoming optimizer round runs with a poisoned
    gradient (``worker:R:nan@step=N``). Call BEFORE ``tick_step()``."""
    e = engine()
    return e is not None and e.nan()


def rpc_fault(op, phase="send", side="client"):
    """True when a kvstore RPC must drop its connection (``rpc:drop``)."""
    e = engine()
    return e is not None and e.rpc(op, phase=phase, side=side)


def generate_fault():
    """Per-admitted-generate-request hook (serving/broker.py
    GenerateServer): returns ``"stall"`` when the request must never
    emit EOS, None otherwise."""
    e = engine()
    return e.generate_request() if e is not None else None


def replica_request_fault():
    """Per-admitted-request replica hook (serving/fleet.py): returns
    ``"stall"`` to wedge the handler, None otherwise; a matching crash
    rule hard-exits the process."""
    e = engine()
    return e.replica_request() if e is not None else None


def autoscaler_fault():
    """Per-control-tick autoscaler hook (serving/autoscale.py): a
    matching ``autoscaler:crash@tick=N`` rule hard-exits the controller
    process and never returns."""
    e = engine()
    if e is not None:
        e.autoscaler_tick()


def router_fault(phase="send"):
    """True when the router must drop this forward attempt (router:drop
    rule; phase=send before the request leaves, reply after it was
    delivered)."""
    e = engine()
    return e is not None and e.router_drop(phase=phase)


def heartbeat_fault():
    """True when the tracker client must skip this heartbeat
    (heartbeat:stall@after=N)."""
    e = engine()
    return e is not None and e.heartbeat()
