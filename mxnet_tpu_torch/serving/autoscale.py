"""Elastic autoscaling for the serving fleet (counterpart of
``mxnet_tpu/serving/autoscale.py``: the same decisions on the same
signals).

A :class:`FleetAutoscaler` polls the signals replicas already publish
through the tracker on every heartbeat interval (queue depth + in-flight,
the router's load gauge; the serving p99; generate-slot occupancy) and
writes a *scale directive* (desired size + retired ranks) to the
tracker's mailbox (``scale_set``/``scale_get``), which a launch.py
supervisor polls, or hands it to an ``actuate_fn`` of its caller's:

- **scale-up**: bump ``desired``; the supervisor spawns a fresh replica
  rank.
- **scale-down**: pick the highest-rank serving replica, publish it as
  *retired* first (so it is never respawned, whatever its exit looks
  like), then drain it (queued and in-flight work finish, typed
  rejections route new traffic away, ``deregister`` removes it from
  discovery) and ``stop`` it. A replica killed mid-drain is already
  retired: the race resolves to one clean retire, counted as
  ``retire_races``.

Robustness contract, **fail-static**: nothing in the serving path depends
on this controller. A crashed or wedged controller leaves the last
directive (or none) in the tracker and the fleet keeps serving at its
current size (``autoscaler:crash@tick=N`` in ``chaos.py`` tests it).
Flapping is prevented by hysteresis (``MXNET_FLEET_AUTOSCALE_HYSTERESIS``
consecutive agreeing ticks) and a post-action cooldown. Every decision is
logged on stdout (``[autoscale]``), as a tracker lifecycle event, and in
``profiler.autoscale_stats``.

The controller talks to the tracker over a registration-free link, so
its death leaves no tracker state behind.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from .. import chaos, config, profiler
from ..base import MXNetError
from ..tracker import (TrackerError, _recv_msg, _send_msg,
                       connect_with_backoff)

_TRANSPORT_ERRORS = (OSError, ConnectionError, EOFError)


class AutoscaleError(RuntimeError):
    """Controller-local failure (bad config, unreachable peer)."""


def _knobs():
    """All MXNET_FLEET_AUTOSCALE_* knobs through the strict accessors
    (malformed raises MXNetError naming the knob)."""
    k = {
        "interval": config.get_positive_float(
            "MXNET_FLEET_AUTOSCALE_INTERVAL"),
        "min_replicas": config.get_positive_int(
            "MXNET_FLEET_AUTOSCALE_MIN"),
        "max_replicas": config.get_positive_int(
            "MXNET_FLEET_AUTOSCALE_MAX"),
        "up_load": config.get_positive_float(
            "MXNET_FLEET_AUTOSCALE_UP_LOAD"),
        "down_load": config.get_nonneg_float(
            "MXNET_FLEET_AUTOSCALE_DOWN_LOAD"),
        "hysteresis": config.get_positive_int(
            "MXNET_FLEET_AUTOSCALE_HYSTERESIS"),
        "cooldown": config.get_nonneg_float(
            "MXNET_FLEET_AUTOSCALE_COOLDOWN"),
        "slo_ms": config.get_nonneg_float(
            "MXNET_FLEET_AUTOSCALE_SLO_MS"),
    }
    if k["min_replicas"] > k["max_replicas"]:
        raise MXNetError(
            "MXNET_FLEET_AUTOSCALE_MIN=%d > MXNET_FLEET_AUTOSCALE_MAX=%d"
            % (k["min_replicas"], k["max_replicas"]))
    if k["down_load"] >= k["up_load"]:
        raise MXNetError(
            "MXNET_FLEET_AUTOSCALE_DOWN_LOAD=%g must be below "
            "MXNET_FLEET_AUTOSCALE_UP_LOAD=%g (the dead band between "
            "them is the flap guard)" % (k["down_load"], k["up_load"]))
    return k


class _TrackerLink:
    """Registration-free raw-socket tracker client (one persistent
    connection, reconnect on error). The autoscaler must not *join*
    the job — its crash has to be invisible to the tracker's liveness
    machinery for the fail-static contract to hold."""

    def __init__(self, uri, connect_deadline=15.0, timeout=10.0):
        self.uri = uri
        self._deadline = float(connect_deadline)
        self._timeout = float(timeout)
        self._sock = None
        self._lock = threading.Lock()

    def rpc(self, op, payload=None):
        with self._lock:
            for attempt in (0, 1):
                if self._sock is None:
                    self._sock = connect_with_backoff(
                        self.uri, deadline=self._deadline)
                    self._sock.settimeout(self._timeout)
                try:
                    _send_msg(self._sock, (op, payload or {}))
                    status, reply = _recv_msg(self._sock)
                    break
                except _TRANSPORT_ERRORS:
                    self.close(locked=True)
                    if attempt:
                        raise
        if status == "err":
            raise TrackerError("tracker %s: %s" % (op, reply))
        return reply

    def close(self, locked=False):
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def _replica_admin(addr, op, payload=None, timeout=None,
                   connect_deadline=5.0):
    """One admin RPC straight at a replica (drain / stop). Unlike the
    router's version this maps nothing to typed serving errors — the
    autoscaler only cares about ok vs failed."""
    timeout = 60.0 if timeout is None else float(timeout)
    sock = connect_with_backoff(addr, deadline=connect_deadline)
    try:
        sock.settimeout(timeout)
        _send_msg(sock, (op, payload or {}))
        status, reply = _recv_msg(sock)
    finally:
        try:
            sock.close()
        except OSError:
            pass
    if status != "ok":
        raise AutoscaleError("replica %s %s: %s" % (addr, op, reply))
    return reply


class FleetAutoscaler:
    """The fleet's scale controller.

    All effectful edges are injectable for subprocess-free tests:
    ``members_fn()`` -> tracker members view, ``actuate_fn(directive)``
    publishes a scale directive, ``admin_fn(addr, op, payload)`` talks
    to a replica, ``event_fn(event, **fields)`` logs to the tracker
    timeline. With only ``tracker_uri`` given, all four ride the real
    tracker link. ``tick()`` is one control step; ``run_forever()``
    loops it. Ticks swallow their own errors (counted as ``errors``) —
    a flaky tracker degrades the *controller*, never the fleet."""

    #: generate-tier slot occupancy above which the fleet counts as
    #: saturated even if the dense queue looks calm (a slot is held for
    #: a whole decode, so occupancy is the capacity signal)
    GEN_OCCUPANCY_HIGH = 0.9

    def __init__(self, tracker_uri=None, members_fn=None, actuate_fn=None,
                 admin_fn=None, event_fn=None, min_replicas=None,
                 max_replicas=None, interval=None, up_load=None,
                 down_load=None, hysteresis=None, cooldown=None,
                 slo_ms=None, now_fn=time.monotonic):
        if tracker_uri is None and (members_fn is None
                                    or actuate_fn is None):
            raise AutoscaleError(
                "FleetAutoscaler needs tracker_uri= (production) or "
                "members_fn= + actuate_fn= (tests)")
        k = _knobs()
        self.interval = k["interval"] if interval is None \
            else float(interval)
        self.min_replicas = k["min_replicas"] if min_replicas is None \
            else int(min_replicas)
        self.max_replicas = k["max_replicas"] if max_replicas is None \
            else int(max_replicas)
        self.up_load = k["up_load"] if up_load is None else float(up_load)
        self.down_load = k["down_load"] if down_load is None \
            else float(down_load)
        self.hysteresis = k["hysteresis"] if hysteresis is None \
            else int(hysteresis)
        self.cooldown = k["cooldown"] if cooldown is None \
            else float(cooldown)
        self.slo_ms = k["slo_ms"] if slo_ms is None else float(slo_ms)
        if self.min_replicas > self.max_replicas:
            raise AutoscaleError("min_replicas %d > max_replicas %d"
                                 % (self.min_replicas, self.max_replicas))
        self._link = _TrackerLink(tracker_uri) if tracker_uri else None
        self._members = members_fn or \
            (lambda: self._link.rpc("members", {"role": "replica"}))
        self._actuate = actuate_fn or \
            (lambda d: self._link.rpc("scale_set", d))
        self._admin = admin_fn or _replica_admin
        self._event = event_fn or self._tracker_event
        self._now = now_fn
        self.desired = None         # learned from the fleet on first tick
        self.retired = set()        # ranks never to respawn
        self._up_streak = 0
        self._down_streak = 0
        self._last_action = None    # monotonic time of last scale action
        self._stop = threading.Event()

    # -- logging ------------------------------------------------------------
    def _say(self, msg):
        print("[autoscale] %s" % msg, flush=True)

    def _tracker_event(self, event, **fields):
        if self._link is None:
            return
        try:
            self._link.rpc("event", {
                "event": str(event),
                "fields": {str(k): str(v) for k, v in fields.items()}})
        except (TrackerError,) + _TRANSPORT_ERRORS:
            pass                    # timeline is telemetry, not control

    # -- one control step ----------------------------------------------------
    def _observe(self, members):
        """Fold the members view into (serving list, load, p99, occ).
        ``load`` is mean queued+in-flight per serving replica — the
        same gauge the router balances on."""
        serving, q = [], 0
        p99 = 0.0
        occ = 0.0
        for m in members:
            if not m.get("alive") or m.get("done"):
                continue
            if int(m.get("rank", -1)) in self.retired:
                continue
            info = m.get("info") or {}
            if info.get("state") != "serving":
                continue
            serving.append(m)
            q += int(info.get("queued", 0)) + int(info.get("inflight", 0))
            p99 = max(p99, float(info.get("p99_ms") or 0.0))
            occ = max(occ, float(info.get("gen_occupancy") or 0.0))
        load = (q / float(len(serving))) if serving else 0.0
        return serving, load, p99, occ

    def tick(self, now=None):
        """One control step. Returns "up"/"down" when a scale action
        was taken, else None."""
        chaos.autoscaler_fault()    # chaos: may hard-exit the controller
        now = self._now() if now is None else float(now)
        try:
            members = self._members()
        except Exception as e:      # noqa: BLE001 — fleet must outlive us
            profiler.autoscale_record(ticks=1, errors=1)
            self._say("members poll failed (%s: %s); fleet stays at "
                      "current size" % (type(e).__name__, e))
            return None
        serving, load, p99, occ = self._observe(members)
        if self.desired is None:
            self.desired = min(
                max(len(serving), self.min_replicas), self.max_replicas)
            self._say("adopted fleet: %d serving, desired=%d"
                      % (len(serving), self.desired))
        profiler.autoscale_record(ticks=1, replicas=len(serving),
                                  desired=self.desired)
        if not serving:
            return None             # nothing to read; launcher recovers
        slo_breach = self.slo_ms > 0 and p99 >= self.slo_ms
        over = (load >= self.up_load or slo_breach
                or occ >= self.GEN_OCCUPANCY_HIGH)
        under = not over and load <= self.down_load and not slo_breach
        if over:
            self._up_streak += 1
            self._down_streak = 0
        elif under:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # dead band between the thresholds: reset both streaks so
            # a load oscillating around one threshold never acts
            self._up_streak = self._down_streak = 0
        if over and self.desired < self.max_replicas:
            return self._maybe(now, self._up_streak, self._scale_up,
                               load, p99)
        if under and self.desired > self.min_replicas \
                and len(serving) > self.min_replicas:
            return self._maybe(now, self._down_streak,
                               lambda n, l, p: self._scale_down(
                                   n, serving, l, p), load, p99)
        return None

    def _maybe(self, now, streak, action, load, p99):
        if streak < self.hysteresis:
            profiler.autoscale_record(holds_hysteresis=1)
            return None
        if self._last_action is not None \
                and now - self._last_action < self.cooldown:
            profiler.autoscale_record(holds_cooldown=1)
            return None
        return action(now, load, p99)

    def _push(self):
        self._actuate({"role": "replica", "desired": int(self.desired),
                       "retired": sorted(self.retired)})

    def _scale_up(self, now, load, p99):
        self.desired += 1
        self._push()
        self._last_action = now
        self._up_streak = self._down_streak = 0
        profiler.autoscale_record(decisions=1, scale_ups=1,
                                  desired=self.desired)
        self._say("scale-up -> desired=%d (load=%.2f p99=%.1fms)"
                  % (self.desired, load, p99))
        self._event("scale-up", desired=self.desired,
                    load="%.2f" % load, p99_ms="%.1f" % p99)
        return "up"

    def _scale_down(self, now, serving, load, p99):
        victim = max(serving, key=lambda m: int(m.get("rank", -1)))
        rank = int(victim["rank"])
        addr = victim.get("addr")
        # retire BEFORE touching the replica: once the launcher has
        # seen the rank in the directive it will never respawn it, so
        # any exit — clean stop or a SIGKILL mid-drain — is final
        self.retired.add(rank)
        self.desired -= 1
        self._push()
        self._last_action = now
        self._up_streak = self._down_streak = 0
        profiler.autoscale_record(decisions=1, scale_downs=1,
                                  desired=self.desired)
        self._say("scale-down -> desired=%d retiring rank=%d addr=%s "
                  "(load=%.2f p99=%.1fms)"
                  % (self.desired, rank, addr, load, p99))
        self._event("scale-down", desired=self.desired, rank=rank,
                    load="%.2f" % load, p99_ms="%.1f" % p99)
        try:
            self._admin(addr, "drain", {"deregister": True})
            self._admin(addr, "stop", {})
            profiler.autoscale_record(retires=1)
            self._say("retired rank=%d (drained, zero dropped)" % rank)
            self._event("scale-retired", rank=rank)
        except Exception as e:      # noqa: BLE001
            # the replica died under us (e.g. SIGKILL mid-drain). It is
            # already in the retired directive, so the launcher lets it
            # go — one retire, no respawn, no double-retire.
            profiler.autoscale_record(retire_races=1)
            self._say("retire race: rank=%d died mid-drain (%s: %s); "
                      "already retired, no respawn"
                      % (rank, type(e).__name__, e))
            self._event("scale-retire-race", rank=rank)
        return "down"

    # -- loop ---------------------------------------------------------------
    def run_forever(self):
        self._say("controller up: min=%d max=%d interval=%.2fs "
                  "up_load=%.2f down_load=%.2f hysteresis=%d "
                  "cooldown=%.1fs slo_ms=%.1f"
                  % (self.min_replicas, self.max_replicas, self.interval,
                     self.up_load, self.down_load, self.hysteresis,
                     self.cooldown, self.slo_ms))
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — keep ticking
                profiler.autoscale_record(errors=1)
                self._say("tick failed (%s: %s); continuing"
                          % (type(e).__name__, e))
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()

    def close(self):
        self.stop()
        if self._link is not None:
            self._link.close()


# ---------------------------------------------------------------------------
# entry point: `fleet.main(["autoscaler", ...])` / python -m ... autoscale
# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxnet_tpu_torch.serving.autoscale",
        description="Fleet autoscale controller (fail-static: killing "
                    "it leaves the fleet serving at its current size)")
    ap.add_argument("--tracker", required=True,
                    help="tracker URI host:port (the job's scheduler)")
    ap.add_argument("--min", type=int, default=None, dest="min_replicas")
    ap.add_argument("--max", type=int, default=None, dest="max_replicas")
    ap.add_argument("--interval", type=float, default=None)
    ap.add_argument("--up-load", type=float, default=None)
    ap.add_argument("--down-load", type=float, default=None)
    ap.add_argument("--hysteresis", type=int, default=None)
    ap.add_argument("--cooldown", type=float, default=None)
    ap.add_argument("--slo-ms", type=float, default=None)
    args = ap.parse_args(argv)
    scaler = FleetAutoscaler(
        tracker_uri=args.tracker, min_replicas=args.min_replicas,
        max_replicas=args.max_replicas, interval=args.interval,
        up_load=args.up_load, down_load=args.down_load,
        hysteresis=args.hysteresis, cooldown=args.cooldown,
        slo_ms=args.slo_ms)

    def _term(signum, frame):
        scaler.stop()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        scaler.run_forever()
    finally:
        scaler.close()
    print("[autoscale] controller stopped (fleet keeps serving)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
