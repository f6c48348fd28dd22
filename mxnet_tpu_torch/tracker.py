"""The tracker's wire (counterpart of the wire half of
``mxnet_tpu/tracker.py``): the frame format, the restricted unpickler,
bounded-backoff connect and the validated env readers that the
parameter-server tier (``kvstore_server.py``) shares with it.

Frames are byte for byte the JAX package's: a 4-byte big-endian length
and a protocol-5 pickle of plain data, decoded by an unpickler that
refuses every global lookup; a length with the top bit set is an extended
frame whose large arrays follow as out-of-band buffers. So each package's
client talks to the other's server.

The scheduler (the dmlc tracker behind ``tools/launch.py`` plus the
ps-lite scheduler node): :class:`Tracker` accepts registrations from
``DMLC_ROLE``-tagged nodes, assigns ranks per role (the fixed
``worker``/``server`` slots, and the slot-free roles such as the serving
fleet's ``replica``), publishes server URIs and replica metadata
(``publish``/``members``), detects dead nodes by heartbeat loss and by
dropped connections, aborts a barrier whose peer died (or, with
``MXNET_MAX_RESTARTS`` > 0, waits for its respawn to take the rank over),
logs every transition as a ``[lifecycle]`` line, fans ``stop`` out to the
servers when every worker is done, keeps the autoscaler's scale
directives (``scale_set``/``scale_get``) and the data plane's shard
leases (``data_*``, on ``data/lease.py``'s :class:`ShardLeaseBook`).
:class:`TrackerClient` is one node's connection (heartbeats on a second
connection), :func:`worker_client` this process's worker client from the
DMLC environment, :func:`discover_server_uris` the worker-side
rendezvous, and ``python -m mxnet_tpu_torch.tracker`` the scheduler
process. ``MXNET_TRACKER_HEARTBEAT_INTERVAL``, ``_HEARTBEAT_TIMEOUT`` and
``_BARRIER_TIMEOUT`` are read through ``config.py``'s validating getters.

In-cluster protocol, no auth: do not expose the port beyond the job.
"""
from __future__ import annotations

import io
import os
import pickle
import socket
import struct
import sys
import threading
import time

from . import config
from .base import MXNetError


DEFAULT_HEARTBEAT_TIMEOUT = 30.0   # seconds without a beat => dead
DEFAULT_HEARTBEAT_INTERVAL = 2.0   # client beat period
DEFAULT_BARRIER_TIMEOUT = 120.0    # overall tracker-barrier bound


class TrackerError(RuntimeError):
    """Tracker-layer failure (connect exhausted, barrier broken, ...)."""


# ---------------------------------------------------------------------------
# validated env knobs: the registry's getters (config.py), so a typo'd
# value fails loudly at read time; the error is TrackerError, the JAX
# package's type for a bad server-tier knob
# ---------------------------------------------------------------------------
def _knob(getter, name):
    try:
        return getter(name)
    except MXNetError as e:
        raise TrackerError(str(e)) from None


def env_positive_float(name):
    """``config.get_positive_float(name)``: a finite float > 0."""
    return _knob(config.get_positive_float, name)


def env_nonneg_int(name):
    """``config.get_nonneg_int(name)``: an integer >= 0."""
    return _knob(config.get_nonneg_int, name)


def _env_count(name):
    """An integer >= 0 from an identity variable the launcher sets (not a
    registered knob): unset is 0, anything else malformed raises."""
    raw = os.environ.get(name, "") or "0"
    try:
        value = int(raw)
    except ValueError:
        value = -1
    if value < 0:
        raise TrackerError("%s=%r must be an integer >= 0" % (name, raw))
    return value


def prune_barrier_names(barriers, errors, current, quiescent,
                        limit=64, min_idle=5.0):
    """Bound per-name barrier state (shared by Tracker and
    KVStoreServer — one definition, or the two would drift): evict
    quiescent names oldest-first once ``limit`` is exceeded, together
    with their abort records. Only entries idle for ``min_idle``
    seconds are touched: a just-aborted round's sleeping waiters (wait
    tick 0.2 s) must still find their abort record when they wake —
    evicting it would turn an aborted barrier into a silent success.
    Callers must hold their state lock and stamp ``s["ts"]`` on every
    touch."""
    if len(barriers) <= limit:
        return
    now = time.monotonic()
    stale = [n for n, s in barriers.items()
             if n != current and quiescent(s)
             and now - s.get("ts", now) >= min_idle]
    for name in stale[:len(barriers) - limit]:
        barriers.pop(name)
        for key in [k for k in errors if k[0] == name]:
            errors.pop(key)


# ---------------------------------------------------------------------------
# wire helpers (restricted pickle: plain data only)
# ---------------------------------------------------------------------------
class _SafeUnpickler(pickle.Unpickler):
    """Shared by the tracker AND kvstore_server protocols (one framing,
    one hardening surface): refuse every global lookup."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            "this protocol carries data only (%s.%s refused)"
            % (module, name))


#: frames whose 4-byte length prefix carries this bit are EXTENDED: the
#: pickled metadata is followed by out-of-band tensor buffers (pickle
#: protocol 5), so large arrays cross the wire as raw memoryviews with
#: no pickle-time copy on either side
_OOB_FLAG = 0x80000000
#: bounds on the extended frame a peer may ask us to allocate — this is
#: an in-cluster protocol, but a corrupt length must not OOM the server
_OOB_MAX_BUFS = 4096
_OOB_MAX_BYTES = 1 << 33


def _pack(obj, buffer_callback=None):
    return pickle.dumps(obj, protocol=5, buffer_callback=buffer_callback)


def _unpack(raw, buffers=None):
    return _SafeUnpickler(io.BytesIO(raw), buffers=buffers).load()


def _send_msg(sock, obj):
    """Send one frame; returns the total bytes written (comms
    accounting). Objects containing ``pickle.PickleBuffer``-wrapped
    arrays are framed extended: metadata pickles WITHOUT the tensor
    bytes, then each buffer is written straight from the array's own
    memory (``sendall`` on a memoryview — no concatenation copy)."""
    bufs = []
    raw = _pack(obj, buffer_callback=bufs.append)
    if len(raw) >= _OOB_FLAG:
        # the flag bit halves the old 4 GiB inline ceiling: a frame
        # that large must fail loudly, not masquerade as extended
        raise ValueError(
            "wire frame metadata too large (%d bytes; limit %d)"
            % (len(raw), _OOB_FLAG - 1))
    if not bufs:
        payload = struct.pack(">I", len(raw)) + raw
        sock.sendall(payload)
        return len(payload)
    views = [pb.raw() for pb in bufs]
    header = struct.pack(">II", _OOB_FLAG | len(raw), len(views))
    header += b"".join(struct.pack(">Q", v.nbytes) for v in views)
    sock.sendall(header)
    sock.sendall(raw)
    for v in views:
        sock.sendall(v)
    return len(header) + len(raw) + sum(v.nbytes for v in views)


def _recv_exact(sock, n):
    """Exactly ``n`` bytes, read into one preallocated buffer (linear in
    ``n``: growing a bytes object chunk by chunk is quadratic, minutes
    for a frame of hundreds of MB)."""
    buf = bytearray(n)
    _recv_into_exact(sock, buf)
    return buf


def _recv_into_exact(sock, buf):
    view = memoryview(buf)
    got = 0
    while got < len(buf):
        n = sock.recv_into(view[got:])
        if not n:
            raise ConnectionError("tracker: peer closed")
        got += n


def _recv_msg(sock, with_size=False):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if not n & _OOB_FLAG:
        obj = _unpack(_recv_exact(sock, n))
        return (obj, 4 + n) if with_size else obj
    raw_len = n & ~_OOB_FLAG
    (nbufs,) = struct.unpack(">I", _recv_exact(sock, 4))
    if nbufs > _OOB_MAX_BUFS:
        raise ConnectionError("bad frame: %d out-of-band buffers" % nbufs)
    lens = struct.unpack(">%dQ" % nbufs, _recv_exact(sock, 8 * nbufs))
    if sum(lens) > _OOB_MAX_BYTES:
        raise ConnectionError("bad frame: %d buffer bytes" % sum(lens))
    raw = _recv_exact(sock, raw_len)
    # buffers land in writable bytearrays the deserialized arrays view
    # directly — one kernel->user copy, nothing else
    bufs = []
    for ln in lens:
        buf = bytearray(ln)
        _recv_into_exact(sock, buf)
        bufs.append(buf)
    obj = _unpack(raw, buffers=bufs)
    if with_size:
        return obj, 4 + 4 + 8 * nbufs + raw_len + sum(lens)
    return obj


def connect_with_backoff(uri, deadline=30.0, base_delay=0.05, max_delay=2.0):
    """TCP connect with bounded exponential backoff (the topology's
    answer to arbitrary process start order: a worker may come up before
    its scheduler or server is listening). Raises TrackerError once the
    deadline is exhausted."""
    host, port = uri.rsplit(":", 1)
    stop_at = time.monotonic() + float(deadline)
    delay = base_delay
    last_err = None
    while True:
        remaining = stop_at - time.monotonic()
        if remaining <= 0:
            raise TrackerError(
                "could not connect to %s within %.0fs (last error: %s)"
                % (uri, deadline, last_err))
        try:
            return socket.create_connection(
                (host, int(port)), timeout=min(max(remaining, 0.1), 10.0))
        except OSError as e:
            last_err = e
            time.sleep(min(delay, max(stop_at - time.monotonic(), 0)))
            delay = min(delay * 2, max_delay)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------
#: roles whose ranks come from the fixed worker/server slot pools sized
#: by DMLC_NUM_WORKER/DMLC_NUM_SERVER. Every OTHER role (the serving
#: fleet's ``replica``, a routing/admin client, ...) registers slot-free:
#: ranks are assigned from an unbounded per-role counter, the node never
#: consumes a worker/server slot, and its death never counts toward the
#: training job's ``num_dead_node`` parity.
SLOTTED_ROLES = ("worker", "server")


class _Node:
    __slots__ = ("node_id", "role", "rank", "addr", "last_beat", "alive",
                 "done", "replaced", "restart", "info")

    def __init__(self, node_id, role, rank, addr, restart=0):
        self.node_id = node_id
        self.role = role
        self.rank = rank
        self.addr = addr
        self.last_beat = time.monotonic()
        self.alive = True
        self.done = False
        self.replaced = False   # a respawn took over this node's rank
        self.restart = restart  # incarnation number (DMLC_RESTART_COUNT)
        self.info = {}          # published metadata (serving load gauge)


class Tracker:
    """The scheduler process: registration, rank assignment, server-URI
    publication, heartbeats, barriers with dead-peer recovery, elastic
    respawn bookkeeping, shutdown fan-out."""

    #: how long a respawning registration waits for the previous
    #: incarnation to be marked dead (its sockets close at process
    #: death, so conn-drop detection is near-immediate; this bound only
    #: matters for wedged-but-alive predecessors)
    TAKEOVER_WAIT = 10.0

    def __init__(self, host="127.0.0.1", port=0, num_workers=1,
                 num_servers=0, heartbeat_timeout=DEFAULT_HEARTBEAT_TIMEOUT,
                 barrier_timeout=DEFAULT_BARRIER_TIMEOUT,
                 max_restarts=None):
        self._num_workers = int(num_workers)
        self._num_servers = int(num_servers)
        self._heartbeat_timeout = float(heartbeat_timeout)
        self._barrier_timeout = float(barrier_timeout)
        if max_restarts is None:
            max_restarts = env_nonneg_int("MXNET_MAX_RESTARTS")
        self._max_restarts = int(max_restarts)
        self._restarts = {}         # (role, rank) -> takeovers so far
        self._t0 = time.monotonic()
        self._cv = threading.Condition()
        self._nodes = {}            # node_id -> _Node
        self._next_id = 0
        self._barriers = {}         # name -> {"gen": int, "arrived": set}
        self._barrier_errors = {}   # (name, gen) -> message
        self._stop = threading.Event()
        self._fanned_out = False
        self._conns = set()         # live client connections
        # data-plane shard leases: dataset name -> lease book
        self._datasets = {}
        # elastic scale directives: role -> latest directive
        self._scale = {}
        self._data_ttl = env_positive_float("MXNET_DATA_LEASE_TTL")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.addr = "%s:%d" % self._sock.getsockname()[:2]

    # -- lifecycle log -------------------------------------------------------
    def _lifecycle(self, event, **fields):
        """One structured timeline line on the scheduler's stdout (the
        launcher inherits it), e.g.
        ``[lifecycle] t=+12.3s event=dead role=worker rank=1 ...``."""
        parts = ["[lifecycle]", "t=+%.1fs" % (time.monotonic() - self._t0),
                 "event=%s" % event]
        parts += ["%s=%s" % (k, v) for k, v in fields.items()]
        print(" ".join(parts), flush=True)

    # -- state helpers (lock held) -------------------------------------------
    def _num_dead_locked(self):
        # only worker/server deaths count: num_dead_node is the TRAINING
        # job's parity signal (ref ps-lite get_num_dead_node) — a dead
        # serving replica is the router's problem, not the optimizer's
        return sum(1 for n in self._nodes.values()
                   if n.role in SLOTTED_ROLES
                   and not n.alive and not n.done and not n.replaced)

    def _servers_locked(self):
        return sorted((n for n in self._nodes.values()
                       if n.role == "server" and not n.replaced),
                      key=lambda n: n.rank)

    def _respawnable_locked(self, node):
        """Can this dead node still be replaced by a respawn? True only
        in elastic mode while the (role, rank) restart budget lasts."""
        if node.done or node.replaced or self._max_restarts <= 0:
            return False
        used = self._restarts.get((node.role, node.rank), 0)
        return used < self._max_restarts

    def _abort_barrier_locked(self, name, msg):
        b = self._barriers.get(name)
        if b is None or not b["arrived"]:
            return
        b["ts"] = time.monotonic()  # abort = activity: waiters still
        # need this round's error record (see prune_barrier_names)
        self._barrier_errors[(name, b["gen"])] = msg
        # prune: keep only the newest few abort records
        while len(self._barrier_errors) > 32:
            self._barrier_errors.pop(next(iter(self._barrier_errors)))
        b["gen"] += 1
        b["arrived"] = set()
        self._cv.notify_all()

    def _mark_dead_locked(self, node_id, why):
        node = self._nodes.get(node_id)
        if node is None or node.done or not node.alive or node.replaced:
            return
        node.alive = False
        respawnable = self._respawnable_locked(node)
        self._lifecycle("dead", role=node.role, rank=node.rank,
                        node=node_id, cause="\"%s\"" % why,
                        respawn="pending" if respawnable else "none")
        if respawnable:
            # elastic mode: the round survives — the dead node's pending
            # arrivals are retracted so its respawn must re-arrive, and
            # every waiter keeps waiting (bounded by its own timeout)
            for b in self._barriers.values():
                b["arrived"].discard(node_id)
        else:
            for name in list(self._barriers):
                self._abort_barrier_locked(
                    name, "barrier %r broken: %s %d (rank %d) died (%s)"
                    % (name, node.role, node_id, node.rank, why))
        if node.role == "worker":
            self._data_release_rank_locked(node.rank, "death")
        self._cv.notify_all()
        self._maybe_finish_locked()

    def _data_release_rank_locked(self, rank, cause):
        """Return a dead/leaving worker's shard leases to the pool with
        their committed cursors — the rebalance that lets a survivor or
        the rank's own respawn resume mid-shard."""
        now = time.monotonic()
        for book in self._datasets.values():
            released = book.release_owner(rank, now)
            if released:
                self._lifecycle(
                    "data-rebalance", dataset=book.name, rank=rank,
                    cause=cause,
                    shards=",".join(str(r["shard"]) for r in released),
                    cursors=",".join(str(r["cursor"]) for r in released))

    def _maybe_finish_locked(self):
        """All expected workers done (or dead beyond recovery) =>
        shutdown fan-out. A dead worker whose rank can still be
        respawned holds the job open — tearing the servers down while
        the launcher is mid-respawn would turn a recoverable crash into
        a job failure."""
        if self._num_workers <= 0:
            # a serving-fleet tracker (launch.py --serve): no training
            # workers exist, so "all workers done" is vacuously true on
            # the FIRST done/dead event — the fleet is torn down
            # explicitly (stop op / launcher), never by worker count
            return
        workers = [n for n in self._nodes.values()
                   if n.role == "worker" and not n.replaced]
        if len(workers) < self._num_workers or self._fanned_out:
            return
        if all(n.done or (not n.alive and not self._respawnable_locked(n))
               for n in workers):
            self._fanned_out = True
            servers = [(n.node_id, n.addr)
                       for n in self._servers_locked() if n.addr]
            threading.Thread(target=self._fan_out_stop, args=(servers,),
                             daemon=True).start()

    def _fan_out_stop(self, servers):
        """Send the kvstore_server protocol 'stop' to every server, then
        stop the tracker itself (graceful job teardown). A stop-acked
        server is marked done here — its own 'done' report would race
        the tracker shutdown and the timeline would log a spurious
        'dead' for a gracefully stopped server."""
        for node_id, addr in servers:
            try:
                s = connect_with_backoff(addr, deadline=5.0)
                try:
                    # kvstore_server wire: (op, key, meta, wire) 4-tuple
                    _send_msg(s, ("stop", None, None, None))
                    s.settimeout(5.0)
                    _recv_msg(s)
                finally:
                    s.close()
            except (TrackerError, OSError, ConnectionError):
                continue  # server already gone
            self._op_done({"node_id": node_id})
        self.shutdown()

    # -- op handlers ---------------------------------------------------------
    def _role_nodes_locked(self, role):
        return [n for n in self._nodes.values()
                if n.role == role and not n.replaced]

    def _takeover_locked(self, old, restart, addr):
        """Replace a dead node with its respawned incarnation: same
        rank, fresh node_id (and, for servers, a fresh published
        addr)."""
        old.replaced = True
        key = (old.role, old.rank)
        self._restarts[key] = self._restarts.get(key, 0) + 1
        nid = self._next_id
        self._next_id += 1
        node = _Node(nid, old.role, old.rank, addr, restart=restart)
        self._nodes[nid] = node
        self._lifecycle("respawned", role=node.role, rank=node.rank,
                        node=nid, restart=restart,
                        replaces=old.node_id,
                        restarts_used="%d/%d" % (self._restarts[key],
                                                 self._max_restarts))
        return node

    def _op_register(self, conn_nodes, p):
        role = p.get("role")
        if not isinstance(role, str) or not role or role == "scheduler":
            raise ValueError("register: bad role %r" % (role,))
        want = p.get("rank")
        restart = int(p.get("restart") or 0)
        addr = p.get("addr")
        info = p.get("info")
        if info is not None and not isinstance(info, dict):
            raise ValueError("register: info must be a dict")
        # slotted roles draw ranks from the fixed worker/server pools;
        # every other role (replica, ...) is slot-free: unbounded
        # per-role ranks, no effect on the training topology's counts
        limit = None
        if role in SLOTTED_ROLES:
            limit = (self._num_workers if role == "worker"
                     else self._num_servers)
        with self._cv:
            node = None
            if want is not None:
                want = int(want)
                if want < 0 or (limit is not None and want >= limit):
                    raise ValueError(
                        "register: rank %d out of range for %d %ss"
                        % (want, limit, role))
                existing = next((n for n in self._role_nodes_locked(role)
                                 if n.rank == want), None)
                if existing is not None and existing.alive \
                        and not existing.done and restart > 0:
                    # respawn raced ahead of dead-detection of its
                    # predecessor: wait for the conn-drop/heartbeat scan
                    deadline = time.monotonic() + self.TAKEOVER_WAIT
                    while existing.alive and time.monotonic() < deadline \
                            and not self._stop.is_set():
                        self._cv.wait(timeout=0.1)
                if existing is not None:
                    # a DONE node stays alive=True forever (it is never
                    # marked dead), but its work is over: a respawn for
                    # its rank — e.g. the process exited nonzero AFTER
                    # its atexit done() — takes over instead of burning
                    # the restart budget on 'already alive' errors. A
                    # DEAD node's takeover is gated on the same elastic
                    # budget as every other respawn decision: in
                    # non-elastic mode (or past the budget) the job is
                    # already tearing itself down around this rank, and
                    # accepting the registration would report a healthy
                    # topology over a dying job.
                    can_take = restart > 0 and (
                        existing.done
                        or (not existing.alive
                            and self._respawnable_locked(existing)))
                    if can_take:
                        node = self._takeover_locked(existing, restart,
                                                     addr)
                    elif existing.alive and not existing.done:
                        raise ValueError(
                            "register: %s rank %d is already registered "
                            "and alive (node %d)"
                            % (role, want, existing.node_id))
                    else:
                        used = self._restarts.get((role, want), 0)
                        raise ValueError(
                            "register: %s rank %d cannot be taken over "
                            "(restart=%d, respawn budget %d/%d)"
                            % (role, want, restart, used,
                               self._max_restarts))
                else:
                    node = self._new_node_locked(role, want, addr, restart)
            elif restart > 0:
                # respawn that does not know its env rank: take over
                # the lowest dead-but-respawnable rank of this role
                # (budget-checked — the tracker may already have
                # aborted barriers for an over-budget rank, and a
                # takeover past MXNET_MAX_RESTARTS would register into
                # a job that is tearing itself down)
                deadline = time.monotonic() + self.TAKEOVER_WAIT
                while not self._stop.is_set():
                    dead = sorted((n for n in self._role_nodes_locked(role)
                                   if not n.alive
                                   and self._respawnable_locked(n)),
                                  key=lambda n: n.rank)
                    if dead:
                        node = self._takeover_locked(dead[0], restart, addr)
                        break
                    if time.monotonic() >= deadline:
                        raise ValueError(
                            "register: restart=%d but no dead %s rank to "
                            "take over" % (restart, role))
                    self._cv.wait(timeout=0.1)
            if node is None:
                taken = {n.rank for n in self._role_nodes_locked(role)}
                if limit is None:
                    rank = next(r for r in range(len(taken) + 1)
                                if r not in taken)
                else:
                    rank = next((r for r in range(limit)
                                 if r not in taken), None)
                    if rank is None:
                        raise ValueError(
                            "register: all %d %s ranks already assigned"
                            % (limit, role))
                node = self._new_node_locked(role, rank, addr, restart)
            if info:
                node.info = dict(info)
            conn_nodes.add(node.node_id)
            self._cv.notify_all()
        return {"node_id": node.node_id, "rank": node.rank,
                "num_workers": self._num_workers,
                "num_servers": self._num_servers}

    def _new_node_locked(self, role, rank, addr, restart):
        nid = self._next_id
        self._next_id += 1
        node = _Node(nid, role, rank, addr, restart=restart)
        self._nodes[nid] = node
        self._lifecycle("registered", role=role, rank=rank, node=nid,
                        addr=addr or "-", restart=restart)
        return node

    def _op_get_servers(self, p):
        """Block until every expected server is registered AND alive;
        return their URIs in rank order. A dead server aborts the wait
        — unless its rank can still be respawned (elastic mode), in
        which case the caller keeps waiting and receives the
        REPLACEMENT's URI once it re-registers (this is how a worker's
        RPC-retry loop re-discovers a respawned server's new port)."""
        timeout = float(p.get("timeout", 60.0))
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._stop.is_set():
                servers = self._servers_locked()
                alive = [n for n in servers if n.alive]
                if len(alive) >= self._num_servers:
                    return [n.addr for n in alive]
                dead = [n for n in servers
                        if not n.alive and not self._respawnable_locked(n)]
                if dead:
                    raise TrackerError(
                        "get_servers: server rank %d died during "
                        "rendezvous" % dead[0].rank)
                if time.monotonic() >= deadline:
                    raise TrackerError(
                        "get_servers: %d of %d servers alive within "
                        "%.0fs" % (len(alive), self._num_servers, timeout))
                self._cv.wait(timeout=0.2)
            raise TrackerError("get_servers: tracker stopped")

    def _op_heartbeat(self, conn_nodes, p):
        nid = p.get("node_id")
        with self._cv:
            node = self._nodes.get(nid)
            if node is None:
                raise ValueError("heartbeat: unknown node %r" % (nid,))
            conn_nodes.add(nid)
            node.last_beat = time.monotonic()
            return {"num_dead": self._num_dead_locked()}

    def _op_barrier(self, p):
        """All expected workers must arrive; a dead peer aborts the
        round with an error to every waiter (instead of the reference's
        infinite spin), and an overall timeout bounds the wait."""
        nid = p.get("node_id")
        name = p.get("name", "")
        timeout = float(p.get("timeout") or self._barrier_timeout)
        deadline = time.monotonic() + timeout
        with self._cv:
            b = self._barriers.setdefault(name, {"gen": 0, "arrived": set()})
            b["ts"] = time.monotonic()
            prune_barrier_names(self._barriers, self._barrier_errors, name,
                                quiescent=lambda s: not s["arrived"])
            gen = b["gen"]
            b["arrived"].add(nid)
            if len(b["arrived"]) >= self._num_workers:
                b["gen"] += 1
                b["arrived"] = set()
                self._cv.notify_all()
                return None
            while b["gen"] == gen and not self._stop.is_set():
                if time.monotonic() >= deadline:
                    msg = ("barrier %r timed out after %.0fs (%d of %d "
                           "workers arrived)"
                           % (name, timeout, len(b["arrived"]),
                              self._num_workers))
                    self._abort_barrier_locked(name, msg)
                    raise TrackerError(msg)
                self._cv.wait(timeout=0.2)
            err = self._barrier_errors.get((name, gen))
            if err is not None:
                raise TrackerError(err)
            if self._stop.is_set() and b["gen"] == gen:
                raise TrackerError("barrier %r: tracker stopped" % (name,))
            return None

    def _op_done(self, p):
        nid = p.get("node_id")
        with self._cv:
            node = self._nodes.get(nid)
            if node is not None and not node.done:
                node.done = True
                self._lifecycle("done", role=node.role, rank=node.rank,
                                node=nid)
            self._maybe_finish_locked()
        return None

    def _op_num_dead(self):
        with self._cv:
            return self._num_dead_locked()

    def _op_event(self, p):
        """Client-reported lifecycle event (e.g. a respawned server's
        ``restored-from=<ckpt>``): folded into the scheduler's timeline
        log so one stream reconstructs the whole job."""
        event = str(p.get("event", "client-event"))
        fields = p.get("fields") or {}
        if not isinstance(fields, dict):
            raise ValueError("event: fields must be a dict")
        clean = {str(k): str(v) for k, v in sorted(fields.items())}
        self._lifecycle(event, **clean)
        return None

    def _op_publish(self, p):
        """Replace a node's published metadata (the serving fleet's
        load gauge / draining state): replicas re-publish on every
        heartbeat interval and on hot-swap, routers read it through
        ``members``."""
        nid = p.get("node_id")
        info = p.get("info")
        if not isinstance(info, dict):
            raise ValueError("publish: info must be a dict")
        with self._cv:
            node = self._nodes.get(nid)
            if node is None:
                raise ValueError("publish: unknown node %r" % (nid,))
            node.info = dict(info)
            self._cv.notify_all()
        return None

    def _op_members(self, p):
        """Live view of one role's nodes (default ``replica``) with
        their published info — the FleetRouter's discovery surface.
        Sharded serving groups ride the published info
        verbatim (``group``/``group_size``/``group_rank``); passing
        ``group`` narrows the view to that group's members so a tool
        can watch one mesh's health without filtering client-side."""
        role = p.get("role", "replica")
        group = p.get("group")
        with self._cv:
            return [{"node_id": n.node_id, "rank": n.rank, "addr": n.addr,
                     "alive": n.alive, "done": n.done,
                     "restart": n.restart, "info": dict(n.info)}
                    for n in self._nodes.values()
                    if n.role == role and not n.replaced
                    and (group is None or n.info.get("group") == group)]

    def _op_nodes(self):
        """Topology snapshot (debugging / tests)."""
        with self._cv:
            return [{"node_id": n.node_id, "role": n.role, "rank": n.rank,
                     "addr": n.addr, "alive": n.alive, "done": n.done,
                     "replaced": n.replaced, "restart": n.restart,
                     "info": dict(n.info)}
                    for n in self._nodes.values()]

    # -- data-plane shard leases ----------------------------------
    def _data_book_locked(self, name):
        book = self._datasets.get(name)
        if book is None:
            raise ValueError("dataset %r was never data_init'd" % (name,))
        return book

    def _op_data_init(self, p):
        from .data.lease import ShardLeaseBook

        name = str(p["name"])
        shards = [int(n) for n in p["shards"]]
        with self._cv:
            book = self._datasets.get(name)
            if book is None:
                book = ShardLeaseBook(name, shards, self._data_ttl)
                self._datasets[name] = book
                self._lifecycle("data-init", dataset=name,
                                shards=len(shards),
                                records=sum(shards))
            elif book.record_counts() != shards:
                raise ValueError(
                    "dataset %r already registered with different shard "
                    "counts (%r != %r)"
                    % (name, book.record_counts(), shards))
            return {"epoch": book.epoch, "shards": len(book.shards)}

    def _op_data_acquire(self, p):
        with self._cv:
            book = self._data_book_locked(p["name"])
            got = book.acquire(int(p["rank"]), int(p["epoch"]),
                               time.monotonic())
            if got["status"] == "lease":
                self._lifecycle(
                    "data-lease", dataset=book.name, epoch=got["epoch"],
                    shard=got["shard"], rank=int(p["rank"]),
                    cursor=got["cursor"],
                    resumed=int(bool(got["resumed"])),
                    rebalanced=int(bool(got["rebalanced"])))
            return got

    def _op_data_renew(self, p):
        with self._cv:
            book = self._data_book_locked(p["name"])
            return book.renew(int(p["rank"]), int(p["epoch"]),
                              int(p["shard"]), int(p["cursor"]),
                              time.monotonic())

    def _op_data_complete(self, p):
        with self._cv:
            book = self._data_book_locked(p["name"])
            done = book.complete(int(p["rank"]), int(p["epoch"]),
                                 int(p["shard"]), int(p["cursor"]),
                                 time.monotonic())
            if done.get("epoch_done"):
                self._lifecycle("data-epoch-done", dataset=book.name,
                                epoch=int(p["epoch"]))
            return done

    def _op_data_release(self, p):
        with self._cv:
            self._data_book_locked(p["name"])  # typed unknown-name error
            self._data_release_rank_locked(int(p["rank"]), "release")
            return None

    def _op_data_state(self, p):
        with self._cv:
            return self._data_book_locked(p["name"]).snapshot()

    # -- elastic scale directives ---------------------------------
    # The tracker is a mailbox, not a policymaker: the autoscaler writes
    # the latest desired fleet size + retired ranks here, the launch.py
    # supervisor polls it. Plain data only (the launcher reads it with a
    # stdlib unpickler), monotonically sequenced so a poller applies each
    # directive exactly once, and fail-static by construction: when no
    # directive was ever set (or the autoscaler dies) scale_get returns
    # the last word — or None — and the fleet keeps its current shape.
    def _op_scale_set(self, p):
        role = str(p.get("role", "replica"))
        desired = int(p["desired"])
        if desired < 0:
            raise ValueError("scale_set: desired must be >= 0, got %d"
                             % desired)
        retired = sorted({int(r) for r in (p.get("retired") or ())})
        with self._cv:
            prev = self._scale.get(role)
            directive = {"role": role, "desired": desired,
                         "retired": retired,
                         "seq": (prev["seq"] + 1) if prev else 1}
            self._scale[role] = directive
            self._lifecycle("scale-directive", role=role, desired=desired,
                            retired=",".join(map(str, retired)) or "-",
                            seq=directive["seq"])
            self._cv.notify_all()
            return dict(directive)

    def _op_scale_get(self, p):
        with self._cv:
            d = self._scale.get(str(p.get("role", "replica")))
            return dict(d) if d else None

    def _dispatch(self, conn_nodes, op, p):
        if op == "register":
            return self._op_register(conn_nodes, p)
        if op == "get_servers":
            return self._op_get_servers(p)
        if op == "heartbeat":
            return self._op_heartbeat(conn_nodes, p)
        if op == "barrier":
            return self._op_barrier(p)
        if op == "done":
            return self._op_done(p)
        if op == "num_dead":
            return self._op_num_dead()
        if op == "event":
            return self._op_event(p)
        if op == "publish":
            return self._op_publish(p)
        if op == "members":
            return self._op_members(p)
        if op == "nodes":
            return self._op_nodes()
        if op == "data_init":
            return self._op_data_init(p)
        if op == "data_acquire":
            return self._op_data_acquire(p)
        if op == "data_renew":
            return self._op_data_renew(p)
        if op == "data_complete":
            return self._op_data_complete(p)
        if op == "data_release":
            return self._op_data_release(p)
        if op == "data_state":
            return self._op_data_state(p)
        if op == "scale_set":
            return self._op_scale_set(p)
        if op == "scale_get":
            return self._op_scale_get(p)
        raise ValueError("unknown op %r" % (op,))

    # -- connection loop -----------------------------------------------------
    def _handle(self, conn):
        conn_nodes = set()  # node_ids bound to this connection
        try:
            while not self._stop.is_set():
                op, p = _recv_msg(conn)
                if op == "stop":
                    _send_msg(conn, ("ok", None))
                    self.shutdown()
                    return
                try:
                    payload = self._dispatch(conn_nodes, op, p or {})
                except Exception as e:
                    try:
                        _send_msg(conn, ("err", "%s: %s"
                                         % (type(e).__name__, e)))
                    except OSError:
                        raise ConnectionError("reply failed")
                    continue
                _send_msg(conn, ("ok", payload))
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            self._conns.discard(conn)
            conn.close()
            # a dropped connection kills every node bound to it (fast
            # dead detection for SIGKILLed processes; graceful exits
            # sent "done" first, which _mark_dead respects)
            with self._cv:
                for nid in conn_nodes:
                    self._mark_dead_locked(nid, "connection dropped")

    def _monitor(self):
        """Heartbeat scan: nodes whose beats stopped are dead."""
        tick = max(self._heartbeat_timeout / 4.0, 0.2)
        while not self._stop.wait(tick):
            now = time.monotonic()
            with self._cv:
                for n in list(self._nodes.values()):
                    if (n.alive and not n.done
                            and now - n.last_beat > self._heartbeat_timeout):
                        self._mark_dead_locked(n.node_id, "heartbeat lost")
                # shard leases whose holder stopped committing: back to
                # the pool (cursor intact) so survivors pick them up
                for book in self._datasets.values():
                    for r in book.expire(now):
                        self._lifecycle(
                            "data-lease-expired", dataset=book.name,
                            shard=r["shard"], rank=r["rank"],
                            cursor=r["cursor"])

    def serve_forever(self):
        try:
            self._sock.settimeout(0.5)
        except OSError:
            return          # shut down before the loop started
        threading.Thread(target=self._monitor, daemon=True).start()
        threads = []
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conns.add(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=2)

    def serve_in_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        # closing live conns unblocks handler threads parked in recv so
        # serve_forever's joins return immediately instead of timing out
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


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class TrackerClient:
    """One node's connection to the scheduler: registers on construction
    (rank assignment), beats on a dedicated second connection so long
    barrier waits never starve the heartbeat, and exposes the
    rendezvous/barrier/failure-count surface."""

    def __init__(self, uri, role, addr=None,
                 connect_deadline=30.0,
                 heartbeat_interval=None, rank=None, restart_count=0,
                 info=None):
        self._uri = uri
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._done_sent = False
        # validate BEFORE connecting: a bad env knob must not leave a
        # half-registered node behind
        if heartbeat_interval is None:
            heartbeat_interval = env_positive_float(
                "MXNET_TRACKER_HEARTBEAT_INTERVAL")
        self._sock = connect_with_backoff(uri, deadline=connect_deadline)
        payload = {"role": role, "addr": addr}
        if rank is not None:
            payload["rank"] = int(rank)
        if restart_count:
            payload["restart"] = int(restart_count)
        if info is not None:
            payload["info"] = dict(info)
        # a respawning registration may wait TAKEOVER_WAIT server-side
        # for its dead predecessor; give the rpc room beyond that
        info = self._rpc("register", payload,
                         timeout=Tracker.TAKEOVER_WAIT + 20.0)
        self.node_id = info["node_id"]
        self.rank = info["rank"]
        self.num_workers = info["num_workers"]
        self.num_servers = info["num_servers"]
        self.role = role
        self.restart_count = int(restart_count)
        # heartbeats: dedicated connection + thread
        self._hb_sock = connect_with_backoff(uri, deadline=connect_deadline)
        self._hb_thread = threading.Thread(
            target=self._beat, args=(float(heartbeat_interval),),
            daemon=True)
        self._hb_thread.start()

    def _rpc(self, op, payload=None, timeout=60.0, sock=None, lock=None):
        sock = sock or self._sock
        try:
            with (lock or self._lock):
                sock.settimeout(timeout)
                _send_msg(sock, (op, payload or {}))
                status, reply = _recv_msg(sock)
        except (socket.timeout, OSError, ConnectionError) as e:
            # a timed-out request's late reply would otherwise be read
            # as the NEXT op's reply — invalidate the connection and
            # raise the domain error kvstore.create() knows to catch
            try:
                sock.close()
            except OSError:
                pass
            raise TrackerError(
                "tracker rpc %r to %s failed (%s: %s); connection closed"
                % (op, self._uri, type(e).__name__, e))
        if status != "ok":
            raise TrackerError("tracker: %s" % (reply,))
        return reply

    def _beat(self, interval):
        from . import chaos

        hb_lock = threading.Lock()
        while not self._closed.wait(interval):
            if chaos.heartbeat_fault():
                continue  # injected wedge: socket stays open, beat lost
            try:
                self._rpc("heartbeat", {"node_id": self.node_id},
                          timeout=10.0, sock=self._hb_sock, lock=hb_lock)
            except (TrackerError, OSError, ConnectionError):
                return  # tracker gone; stop beating

    # -- surface -------------------------------------------------------------
    def get_server_uris(self, timeout=60.0):
        """Block until every server registered; URIs in rank order."""
        return self._rpc("get_servers", {"timeout": timeout},
                         timeout=timeout + 10.0)

    def barrier(self, name="", timeout=None):
        """Tracker barrier across all workers. Raises TrackerError on a
        dead peer or on the overall timeout — never spins forever. In
        elastic mode a dead-but-respawnable peer keeps the round open
        (its respawn re-arrives) instead of aborting it."""
        if timeout is None:
            timeout = env_positive_float("MXNET_TRACKER_BARRIER_TIMEOUT")
        timeout = float(timeout)
        self._rpc("barrier",
                  {"node_id": self.node_id, "name": name, "timeout": timeout},
                  timeout=timeout + 15.0)

    def num_dead_node(self):
        return int(self._rpc("num_dead"))

    def nodes(self):
        return self._rpc("nodes")

    def publish(self, info):
        """Replace this node's published metadata on the scheduler (the
        replica load gauge / draining state; see ``members``)."""
        self._rpc("publish", {"node_id": self.node_id,
                              "info": dict(info)}, timeout=10.0)

    def members(self, role="replica"):
        """One role's nodes with their published info — the router's
        discovery view."""
        return self._rpc("members", {"role": role})

    def log_event(self, event, **fields):
        """Report a lifecycle event into the scheduler's timeline log
        (e.g. ``restored-from``). Best-effort: a dead tracker must not
        fail the caller's recovery path."""
        try:
            self._rpc("event", {"event": str(event),
                                "fields": {str(k): str(v)
                                           for k, v in fields.items()}},
                      timeout=10.0)
        except (TrackerError, OSError, ConnectionError):
            pass

    # -- data-plane shard leases ---------------------------------
    # explicit-rank signatures, identical to LocalLeaseAuthority's, so
    # ShardedRecordStream speaks one surface to either authority
    def data_init(self, name, shards):
        return self._rpc("data_init",
                         {"name": str(name),
                          "shards": [int(n) for n in shards]})

    def data_acquire(self, name, rank, epoch):
        return self._rpc("data_acquire",
                         {"name": str(name), "rank": int(rank),
                          "epoch": int(epoch)})

    def data_renew(self, name, rank, epoch, shard, cursor):
        return self._rpc("data_renew",
                         {"name": str(name), "rank": int(rank),
                          "epoch": int(epoch), "shard": int(shard),
                          "cursor": int(cursor)})

    def data_complete(self, name, rank, epoch, shard, cursor):
        return self._rpc("data_complete",
                         {"name": str(name), "rank": int(rank),
                          "epoch": int(epoch), "shard": int(shard),
                          "cursor": int(cursor)})

    def data_release(self, name, rank):
        return self._rpc("data_release",
                         {"name": str(name), "rank": int(rank)})

    def data_state(self, name):
        return self._rpc("data_state", {"name": str(name)})

    # -- elastic scale directives ---------------------------------
    def scale_set(self, desired, retired=(), role="replica"):
        """Publish the autoscaler's directive (desired size + retired
        ranks) for the launch.py supervisor to poll via ``scale_get``."""
        return self._rpc("scale_set",
                         {"role": str(role), "desired": int(desired),
                          "retired": [int(r) for r in retired]},
                         timeout=10.0)

    def scale_get(self, role="replica"):
        """Latest scale directive for ``role``, or None if none was
        ever set (the fail-static default)."""
        return self._rpc("scale_get", {"role": str(role)}, timeout=10.0)

    def done(self):
        """Report graceful completion (idempotent; swallows a dead
        tracker — at-exit teardown must never raise)."""
        if self._done_sent:
            return
        self._done_sent = True
        try:
            self._rpc("done", {"node_id": self.node_id}, timeout=10.0)
        except (TrackerError, OSError, ConnectionError):
            pass

    def close(self):
        self._closed.set()
        for s in (self._sock, self._hb_sock):
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# env contract + worker-side discovery singleton
# ---------------------------------------------------------------------------
def tracker_env_spec():
    """(scheduler_uri, num_workers, num_servers) from the DMLC env, or
    None when no scheduler topology is configured. The topology exists
    exactly when DMLC_PS_ROOT_URI/PORT name the scheduler AND
    DMLC_NUM_SERVER asks for parameter servers."""
    host = os.environ.get("DMLC_PS_ROOT_URI")
    port = os.environ.get("DMLC_PS_ROOT_PORT")
    try:
        num_servers = int(os.environ.get("DMLC_NUM_SERVER", "0") or 0)
    except ValueError:
        return None
    if not host or not port or num_servers <= 0:
        return None
    num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1") or 1)
    return ("%s:%s" % (host, port), num_workers, num_servers)


_WORKER_CLIENT = None
_WORKER_CLIENT_LOCK = threading.Lock()


def worker_client():
    """This process's TrackerClient (role=worker), created on first use
    from the env contract; None when no scheduler topology is
    configured. Registers an atexit hook that reports ``done`` so the
    scheduler can fan out shutdown to the servers.

    Under ``tools/launch.py`` the env names this worker's rank
    (``DMLC_WORKER_ID``) and incarnation (``DMLC_RESTART_COUNT``); a
    respawned worker therefore takes over exactly its predecessor's
    rank — the rank whose progress the checkpoint recorded."""
    global _WORKER_CLIENT
    with _WORKER_CLIENT_LOCK:
        if _WORKER_CLIENT is not None:
            return _WORKER_CLIENT
        spec = tracker_env_spec()
        if spec is None:
            return None
        uri, _nw, _ns = spec
        rank = os.environ.get("DMLC_WORKER_ID",
                              os.environ.get("DMLC_RANK"))
        restart = _env_count("DMLC_RESTART_COUNT")
        client = TrackerClient(uri, "worker",
                               rank=int(rank) if rank is not None else None,
                               restart_count=restart)
        import atexit

        atexit.register(lambda: (client.done(), client.close()))
        _WORKER_CLIENT = client
        return client


def discover_server_uris(timeout=60.0):
    """Worker-side rendezvous: register with the scheduler and block
    until every parameter server has published its URI. None when no
    scheduler topology is configured in the env."""
    client = worker_client()
    if client is None:
        return None
    return client.get_server_uris(timeout=timeout)


# ---------------------------------------------------------------------------
# scheduler entry point (DMLC_ROLE=scheduler)
# ---------------------------------------------------------------------------
def main():
    host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    port = int(os.environ.get("DMLC_PS_ROOT_PORT", "0"))
    num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1") or 1)
    num_servers = int(os.environ.get("DMLC_NUM_SERVER", "0") or 0)
    hb_timeout = env_positive_float("MXNET_TRACKER_HEARTBEAT_TIMEOUT")
    max_restarts = env_nonneg_int("MXNET_MAX_RESTARTS")
    # bind-anywhere: the advertised host may be this host's external
    # name; bind the wildcard so both loopback and external connects work
    bind_host = "" if host not in ("127.0.0.1", "localhost") else host
    tracker = Tracker(host=bind_host, port=port, num_workers=num_workers,
                      num_servers=num_servers,
                      heartbeat_timeout=hb_timeout,
                      max_restarts=max_restarts)
    print("tracker listening on %s (workers=%d servers=%d "
          "max_restarts=%d)"
          % (tracker.addr, num_workers, num_servers, max_restarts),
          flush=True)
    tracker.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
