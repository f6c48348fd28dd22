#!/usr/bin/env python
"""The job launcher of the port (counterpart of ``tools/launch.py``, with
the same flags and the same environment contract):
``python -m mxnet_tpu_torch.launch``. Standard library only at import.

**Serverless collectives** (``-s 0``, the default): only workers exist,
each running your command; they join one ``torch.distributed`` job at the
coordinator (``mxnet_tpu_torch.dist``) and ``--kv-store dist_sync`` sums
their gradients by collectives. ``tools/launch.py -s 0`` starts the same
workers.

**Scheduler topology** (``-s S`` with S > 0): one scheduler
(``mxnet_tpu_torch.tracker``) first, then S parameter servers (``python -m
mxnet_tpu_torch.kvstore_server``) that register with it and publish their
URIs, then N workers running your command;
``kvstore.create('dist_async')`` in a worker discovers the servers through
the scheduler. When every worker reports done, the scheduler stops the
servers.

**Elastic recovery** (``--max-restarts K``, scheduler topology only): a
worker or server that exits nonzero is respawned with its old rank and
``DMLC_RESTART_COUNT`` incremented, up to K times a node; a respawned
server restores its key shard from the newest checkpoint
(``MXNET_CHECKPOINT_DIR``, made when unset). Exit 75 (a preempted worker
that checkpointed) respawns without using the budget. An exhausted budget
fails the job with a per-node exit summary.

**Serving fleet** (``--serve``): the N primary processes are inference
replicas (``DMLC_ROLE=replica``, ``DMLC_REPLICA_ID=rank``) registered
slot-free with the scheduler, supervised alike; the job ends when every
replica exits, then the launcher stops the scheduler.

Usage:
    python -m mxnet_tpu_torch.launch -n 2 python train.py --kv-store dist_sync
    python -m mxnet_tpu_torch.launch -n 2 -s 2 python train.py \\
        --kv-store dist_async
    python -m mxnet_tpu_torch.launch --serve -n 3 --max-restarts 2 \\
        python -m mxnet_tpu_torch.serving.fleet replica ...

Modes:
    --launcher local  (default) all processes on this host
    --launcher manual print the environment each role must export
                      (scheduler / server / worker blocks when -s > 0), to
                      start one process a host by hand or another
                      orchestrator
"""
import argparse
import io
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# mirrors mxnet_tpu_torch.health.EXIT_PREEMPTED (launch.py stays
# stdlib-only):
# a worker that caught SIGTERM, drained, and checkpointed inside its
# MXNET_PREEMPT_GRACE window exits with this status — supervision
# respawns it WITHOUT burning the restart budget (the budget guards
# against crash loops; a preempted node did nothing wrong). Note the
# tracker's own takeover counter still ticks per respawn — the
# launch-side budget is the user-facing one.
EXIT_PREEMPTED = 75
# Free respawns are still BOUNDED per node: a process that reports
# "preempted" on every incarnation (a re-preempting scheduler, or a
# program that happens to exit 75) must not spin the supervisor
# forever — past this many, exit 75 is treated like any other nonzero
# status and burns the normal restart budget.
MAX_FREE_RESTARTS = 16
# Ceiling on the replica count a scale directive can ask for: the
# autoscaler enforces MXNET_FLEET_AUTOSCALE_MAX itself, this bound only
# keeps a corrupt/hostile directive from forking the host to death.
FLEET_SIZE_CAP = 64
# How often the serve-mode supervisor polls the tracker's scale mailbox.
SCALE_POLL_INTERVAL = 1.0


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _base_env(args, coord):
    """The DMLC env contract shared by every role in both topologies
    (kvstore.h:267-311: DMLC_PS_ROOT_URI/PORT name the rendezvous
    endpoint; NUM_WORKER/NUM_SERVER size the job). ``--env`` overrides
    are applied by the per-role builders, last."""
    env = dict(os.environ)
    host, port = coord.rsplit(":", 1)
    env["DMLC_PS_ROOT_URI"] = host
    env["DMLC_PS_ROOT_PORT"] = port
    env["DMLC_NUM_WORKER"] = str(args.num_workers)
    env["DMLC_NUM_SERVER"] = str(args.num_servers)
    if getattr(args, "max_restarts", 0):
        # elastic contract: the tracker defers barrier aborts/shutdown
        # while a respawn is pending
        env["MXNET_MAX_RESTARTS"] = str(args.max_restarts)
    if getattr(args, "checkpoint_dir", None):
        # independent of --max-restarts: periodic snapshots alone (for
        # a later full-job restart) are a legitimate configuration
        env["MXNET_CHECKPOINT_DIR"] = args.checkpoint_dir
    # spawned helper processes (tracker/server modules) must import
    # mxnet_tpu_torch regardless of the caller's cwd
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _apply_env_overrides(env, args):
    for kv in args.env:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def _role_env(args, coord, role, rank=0):
    env = _base_env(args, coord)
    env["DMLC_ROLE"] = role
    if role == "server":
        env["MXNET_KVSTORE_SERVER"] = "1"
        env["DMLC_SERVER_ID"] = str(rank)
    if role == "worker":
        env["DMLC_WORKER_ID"] = str(rank)
        env["DMLC_RANK"] = str(rank)
        env["MXNET_TPU_NUM_WORKERS"] = str(args.num_workers)
        env["MXNET_TPU_WORKER_ID"] = str(rank)
    if role == "replica":
        env["DMLC_REPLICA_ID"] = str(rank)
    if getattr(args, "serve", False):
        # serving-fleet mode (--serve): replicas are slot-free tracker
        # members — DMLC_NUM_WORKER=0 (every role, incl. the scheduler)
        # keeps the tracker from fanning out shutdown on worker
        # bookkeeping that does not exist; the launcher stops it
        env["DMLC_NUM_WORKER"] = "0"
    return _apply_env_overrides(env, args)


def _serverless_worker_env(args, coord, rank):
    """Serverless contract (-s 0): the torch.distributed rendezvous of
    ``mxnet_tpu_torch.dist`` (the DMLC aliases from _base_env keep
    reference scripts working)."""
    env = _base_env(args, coord)
    env["DMLC_ROLE"] = "worker"
    env["DMLC_WORKER_ID"] = str(rank)
    env["MXNET_TPU_COORDINATOR"] = coord
    env["MXNET_TPU_NUM_WORKERS"] = str(args.num_workers)
    env["MXNET_TPU_WORKER_RANK"] = str(rank)
    return _apply_env_overrides(env, args)


def _print_env(env, keys_prefix=("MXNET_TPU_", "MXNET_KVSTORE_", "DMLC_",
                                 "MXNET_MAX_", "MXNET_CHECKPOINT_",
                                 "MXNET_FAULT_"),
               rank_keys=()):
    for k, v in sorted(env.items()):
        if k.startswith(keys_prefix):
            v = "<rank>" if k in rank_keys else v
            print("export %s=%s" % (k, v))


def _manual(args, coord):
    if getattr(args, "serve", False):
        print("# --- scheduler (run first, one process) ---")
        _print_env(_role_env(args, coord, "scheduler"))
        print("# run: %s -m mxnet_tpu_torch.tracker" % sys.executable)
        print("# --- replica i (i = 0..%d) ---" % (args.num_workers - 1))
        _print_env(_role_env(args, coord, "replica", 0),
                   rank_keys=("DMLC_REPLICA_ID",))
        print("# run: %s" % " ".join(args.command))
        return 0
    if args.num_servers <= 0:
        print("# export on host i (i = 0..%d):" % (args.num_workers - 1))
        _print_env(_serverless_worker_env(args, coord, 0),
                   rank_keys=("MXNET_TPU_WORKER_RANK", "DMLC_WORKER_ID"))
        print("# then run on every host: %s" % " ".join(args.command))
        return 0
    print("# --- scheduler (run first, one process) ---")
    _print_env(_role_env(args, coord, "scheduler"))
    print("# run: %s -m mxnet_tpu_torch.tracker" % sys.executable)
    print("# --- server i (i = 0..%d) ---" % (args.num_servers - 1))
    _print_env(_role_env(args, coord, "server", 0),
               rank_keys=("DMLC_SERVER_ID",))
    print("# run: %s -m mxnet_tpu_torch.kvstore_server" % sys.executable)
    print("# --- worker i (i = 0..%d) ---" % (args.num_workers - 1))
    _print_env(_role_env(args, coord, "worker", 0),
               rank_keys=("DMLC_WORKER_ID", "DMLC_RANK",
                          "MXNET_TPU_WORKER_ID"))
    print("# run: %s" % " ".join(args.command))
    return 0


def _wait_procs(procs, deadline):
    """Wait for every proc, honoring an absolute deadline (None = no
    limit). Returns (rc, timed_out) with rc = first nonzero status."""
    rc = 0
    pending = list(procs)
    while pending:
        if deadline is not None and time.monotonic() > deadline:
            return rc, True
        for p in list(pending):
            try:
                p.wait(timeout=0.25)
            except subprocess.TimeoutExpired:
                continue
            rc = p.returncode or rc
            pending.remove(p)
    return rc, False


class _Node:
    """One supervised process slot: role + rank + restart accounting
    (the slot survives respawns; the Popen inside it is replaced)."""

    def __init__(self, name, role, rank, cmd, env_fn):
        self.name = name
        self.role = role
        self.rank = rank
        self.cmd = cmd
        self.env_fn = env_fn     # restart_count -> env dict
        self.proc = None
        self.restarts = 0        # budget-burning respawns
        self.free_restarts = 0   # preemption respawns (budget untouched)
        self.exit_history = []   # every observed exit code, in order
        self.finished = False    # exited 0 (terminal success)
        self.failed = False      # budget exhausted (terminal failure)

    def spawn(self):
        # DMLC_RESTART_COUNT counts EVERY incarnation (chaos rules and
        # checkpoint resume key on it), free or not
        self.proc = subprocess.Popen(
            self.cmd, env=self.env_fn(self.restarts + self.free_restarts))

    def __str__(self):
        rcs = ",".join(str(rc) for rc in self.exit_history) or "-"
        return "%-10s rc=%s restarts=%d free=%d" % (
            self.name, rcs, self.restarts, self.free_restarts)


def _print_exit_summary(nodes, out=None):
    out = out or sys.stderr
    print("launch.py: exit summary (per node: every observed exit code, "
          "restarts used):", file=out)
    for node in nodes:
        print("launch.py:   %s" % node, file=out)


def _stop_tracker(args, coord):
    """Best-effort 'stop' to the scheduler over its own wire (serve
    mode: with DMLC_NUM_WORKER=0 no worker-done fan-out ever stops it)."""
    code = ("from mxnet_tpu_torch.tracker import connect_with_backoff, "
            "_send_msg, _recv_msg\n"
            "s = connect_with_backoff(%r, deadline=5.0)\n"
            "_send_msg(s, ('stop', None))\n"
            "_recv_msg(s)\n" % coord)
    try:
        subprocess.run([sys.executable, "-c", code],
                       env=_base_env(args, coord), timeout=15,
                       stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
    except (subprocess.TimeoutExpired, OSError):
        pass


class _PlainUnpickler(pickle.Unpickler):
    """Mirror of the tracker's _SafeUnpickler: scale directives are
    plain data; any global reference in a reply is refused."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            "scale directive must be plain data (refusing %s.%s)"
            % (module, name))


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("tracker connection closed")
        buf += chunk
    return buf


def _scale_poll(coord, timeout=2.0):
    """Ask the tracker for the latest replica scale directive
    over its own wire, stdlib-only — the supervisor must
    never import the framework in-process. Best-effort: any failure
    (tracker not up yet, mid-teardown, garbage frame) returns None and
    the fleet keeps its current shape — the launcher half of the
    autoscaler's fail-static contract."""
    try:
        host, port = coord.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=timeout)
        try:
            sock.settimeout(timeout)
            raw = pickle.dumps(("scale_get", {"role": "replica"}),
                               protocol=2)
            sock.sendall(struct.pack(">I", len(raw)) + raw)
            (n,) = struct.unpack(">I", _recv_exact(sock, 4))
            if n & 0x80000000:
                return None  # extended frame: not a plain directive
            payload = _recv_exact(sock, n)
        finally:
            sock.close()
        status, reply = _PlainUnpickler(io.BytesIO(payload)).load()
    except (OSError, EOFError, struct.error, pickle.UnpicklingError,
            ValueError):
        return None
    if status != "ok" or not isinstance(reply, dict):
        return None
    return reply


def _apply_scale_directive(directive, workers, retired_ranks,
                           last_seq, primary_role):
    """Pure half of the serve-mode scale poll: fold one directive into
    (new ranks to spawn, newly retired ranks, seq). A directive is
    applied at most once (monotonic seq); desired counts the NON-
    retired replica slots, so spawns fill the gap between the live
    non-retired population and desired with fresh ranks.

    Cleanly-finished non-retired replicas count AGAINST the gap, not
    as holes to refill: in serve mode a replica only exits 0 when
    something deliberately stopped it (the router's fleet ``stop``),
    and a directive published before that stop must not resurrect the
    capacity afterwards — the launcher would then supervise a replica
    nobody will ever stop and the job could never end."""
    seq = int(directive.get("seq", 0))
    if seq <= last_seq:
        return [], set(), last_seq
    newly_retired = {int(r) for r in (directive.get("retired") or ())}
    newly_retired -= retired_ranks
    all_retired = retired_ranks | newly_retired
    desired = min(max(int(directive.get("desired", 0)), 0),
                  FLEET_SIZE_CAP)
    active = [n for n in workers
              if n.rank not in all_retired
              and not n.failed and not n.finished]
    stopped = [n for n in workers
               if n.rank not in all_retired and n.finished]
    next_rank = max((n.rank for n in workers), default=-1) + 1
    spawn = list(range(
        next_rank,
        next_rank + max(desired - len(active) - len(stopped), 0)))
    return spawn, newly_retired, seq


def _spawn_topology(args, coord):
    """scheduler + S servers + W workers; workers' collective exit
    status is the job's. With --max-restarts K a worker/server that
    exits nonzero is respawned (same rank, DMLC_RESTART_COUNT bumped)
    up to K times per node; an exhausted budget fails the whole job
    with a per-node exit summary.

    With ``--serve`` the primary processes are serving-fleet REPLICAS
    instead of training workers (same supervision: restart budget,
    exit-75 free respawn) and the job ends when every replica exits —
    normally via the router's fleet ``stop`` — after which the
    launcher stops the tracker itself."""
    # -c, not -m: the package __init__ already imports .tracker, and
    # runpy warns when re-executing an imported submodule as __main__
    tracker_cmd = [sys.executable, "-c",
                   "import sys; from mxnet_tpu_torch import tracker; "
                   "sys.exit(tracker.main())"]
    server_cmd = [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"]
    serve = getattr(args, "serve", False)
    primary_role = "replica" if serve else "worker"

    def env_fn(role, rank):
        def build(restart_count):
            env = _role_env(args, coord, role, rank)
            env["DMLC_RESTART_COUNT"] = str(restart_count)
            return env
        return build

    nodes = [_Node("scheduler", "scheduler", 0, tracker_cmd,
                   env_fn("scheduler", 0))]
    nodes += [_Node("server%d" % i, "server", i, server_cmd,
                    env_fn("server", i)) for i in range(args.num_servers)]
    nodes += [_Node("%s%d" % (primary_role, r), primary_role, r,
                    list(args.command), env_fn(primary_role, r))
              for r in range(args.num_workers)]
    workers = [n for n in nodes if n.role == primary_role]
    deadline = (time.monotonic() + args.timeout) if args.timeout else None
    rc = 0
    # elastic-fleet state (serve mode only): ranks the
    # autoscaler retired (never respawned, any exit is terminal) and
    # the last applied directive seq
    retired_ranks = set()
    scale_seq = 0
    next_scale_poll = time.monotonic() + SCALE_POLL_INTERVAL

    def _poll_scale_now():
        """One serve-mode scale poll: fold the tracker's latest
        directive into the supervised set. Called on cadence AND
        before classifying a primary-role death — the autoscaler
        publishes retire directives BEFORE touching the replica, so a
        death that races the cadence poll must not be mistaken for a
        failure and respawned."""
        nonlocal scale_seq
        directive = _scale_poll(coord)
        if directive is None:
            return
        spawn, newly_retired, scale_seq = _apply_scale_directive(
            directive, workers, retired_ranks, scale_seq, primary_role)
        retired_ranks.update(newly_retired)
        for r in sorted(newly_retired):
            print("launch.py: scale-down directive: rank %d retired "
                  "(drain-then-exit; no respawn)" % r, file=sys.stderr)
        for r in spawn:
            new = _Node("%s%d" % (primary_role, r), primary_role, r,
                        list(args.command), env_fn(primary_role, r))
            print("launch.py: scale-up directive: spawning %s "
                  "(desired=%s)" % (new.name, directive.get("desired")),
                  file=sys.stderr)
            new.spawn()
            nodes.append(new)
            workers.append(new)

    try:
        for node in nodes:
            node.spawn()
        while True:
            if deadline is not None and time.monotonic() > deadline:
                print("launch.py: timeout after %ds, killing the job"
                      % args.timeout, file=sys.stderr)
                _print_exit_summary(nodes)
                return 124
            progressed = False
            for node in nodes:
                if node.finished or node.failed:
                    continue
                code = node.proc.poll()
                if code is None:
                    continue
                progressed = True
                node.exit_history.append(code)
                if serve and node.role == primary_role \
                        and node.rank not in retired_ranks \
                        and code != 0:
                    # a replica death can race the cadence poll: the
                    # retire directive lands at the tracker before the
                    # autoscaler's drain touches the process, so check
                    # for one more directive before classifying
                    _poll_scale_now()
                if serve and node.role == primary_role \
                        and node.rank in retired_ranks:
                    # the autoscaler retired this rank before touching
                    # the process, so ANY exit — the clean drain+stop,
                    # or a SIGKILL that raced the drain — is a terminal
                    # successful retire: exactly one, never respawned
                    node.finished = True
                    print("launch.py: %s retired by the autoscaler "
                          "(exit %s); not respawning"
                          % (node.name, code), file=sys.stderr)
                    continue
                if code == 0:
                    node.finished = True
                    continue
                if code == EXIT_PREEMPTED and args.max_restarts \
                        and node.role != "scheduler" \
                        and node.free_restarts < MAX_FREE_RESTARTS:
                    # preemption-aware exit: resumable status
                    # from the grace-window checkpoint path — respawn
                    # for free
                    node.free_restarts += 1
                    print("launch.py: %s preempted (exit %d); respawning"
                          " free (restart budget untouched: %d/%d used)"
                          % (node.name, code, node.restarts,
                             args.max_restarts), file=sys.stderr)
                    node.spawn()
                    continue
                if node.role != "scheduler" \
                        and node.restarts < args.max_restarts:
                    node.restarts += 1
                    print("launch.py: %s exited %d; respawning "
                          "(restart %d/%d)" % (node.name, code,
                                               node.restarts,
                                               args.max_restarts),
                          file=sys.stderr)
                    node.spawn()
                    continue
                if not args.max_restarts and node.role != primary_role:
                    # legacy (non-elastic) semantics: helper exit codes
                    # never drive the job's status — the workers' own
                    # failures surface the problem
                    node.finished = True
                    continue
                node.failed = True
                rc = rc or code
                if args.max_restarts and node.role != "scheduler":
                    print("launch.py: %s exited %d with restart budget "
                          "exhausted (%d/%d); failing the job"
                          % (node.name, code, node.restarts,
                             args.max_restarts), file=sys.stderr)
            if serve and time.monotonic() >= next_scale_poll:
                next_scale_poll = time.monotonic() + SCALE_POLL_INTERVAL
                _poll_scale_now()
            failed = [n for n in nodes if n.failed]
            if failed and args.max_restarts:
                # elastic mode promises CLEAN failure: tear everything
                # down now instead of letting survivors spin against a
                # hole in the topology until some timeout fires
                _print_exit_summary(nodes)
                return rc or 1
            if all(n.finished or n.failed for n in workers):
                break
            if not progressed:
                time.sleep(0.1)
        if rc:
            # a worker failed terminally (non-elastic path: its peers'
            # own exits were already waited for above). Fall through to
            # the helper grace window all the same — the tracker's
            # dead/done bookkeeping fans 'stop' out to the servers, and
            # killing them instead would truncate the lifecycle
            # timeline a post-mortem needs most on exactly this path.
            _print_exit_summary(nodes)
        # workers done: the tracker fans out server shutdown itself
        # (workers' done reports); give the helpers a grace window. In
        # serve mode nothing stops the tracker for us — stop it now.
        if serve:
            _stop_tracker(args, coord)
        helpers = [n for n in nodes if n.role != primary_role
                   and n.proc is not None and not n.finished]
        _rc, timed_out = _wait_procs([n.proc for n in helpers],
                                     time.monotonic() + 15)
        if timed_out:
            print("launch.py: scheduler/server did not exit after the "
                  "workers; killing them", file=sys.stderr)
            rc = rc or 1
        for node in helpers:
            if node.proc.poll() is not None:
                node.exit_history.append(node.proc.returncode)
                node.finished = node.proc.returncode == 0
        if args.max_restarts:
            _print_exit_summary(nodes, out=sys.stdout)
        return rc
    except KeyboardInterrupt:
        for node in nodes:
            if node.proc is not None:
                node.proc.send_signal(signal.SIGTERM)
        return 1
    finally:
        for node in nodes:
            if node.proc is not None and node.proc.poll() is None:
                node.proc.kill()


def _spawn_serverless(args, coord):
    procs = []
    deadline = (time.monotonic() + args.timeout) if args.timeout else None
    try:
        for rank in range(args.num_workers):
            procs.append(subprocess.Popen(
                args.command, env=_serverless_worker_env(args, coord, rank)))
        rc, timed_out = _wait_procs(procs, deadline)
        if timed_out:
            print("launch.py: timeout after %ds, killing the job"
                  % args.timeout, file=sys.stderr)
            return 124
        return rc
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        return 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="number of parameter-server processes; > 0 "
                         "spawns the full scheduler topology (1 tracker "
                         "+ S KVStoreServers + N workers) so "
                         "--kv-store dist_async runs server-side "
                         "optimization; 0 (default) runs the serverless "
                         "collective path")
    ap.add_argument("--serve", action="store_true",
                    help="serving-fleet mode: the -n "
                         "primary processes are serving REPLICAS "
                         "(DMLC_ROLE=replica, DMLC_REPLICA_ID=rank) "
                         "running your command — e.g. 'python -m "
                         "mxnet_tpu_torch.serving.fleet replica ...' — "
                         "registered slot-free with the spawned "
                         "tracker; --max-restarts supervision (incl. "
                         "the exit-75 free respawn) applies to them")
    ap.add_argument("--launcher", choices=("local", "manual"),
                    default="local")
    ap.add_argument("--coordinator", default=None,
                    help="host:port rendezvous — the process group's "
                         "(-s 0) or the scheduler/tracker (-s > 0) "
                         "(default: 127.0.0.1:random)")
    ap.add_argument("--timeout", type=int, default=0,
                    help="kill the whole job after this many seconds "
                         "(0 = no limit); exit code 124 on expiry")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="respawn a worker/server that exits nonzero up "
                         "to K times PER NODE, with its old rank and "
                         "DMLC_RESTART_COUNT incremented (scheduler "
                         "topology only); a respawned server restores "
                         "its shard from MXNET_CHECKPOINT_DIR. 0 "
                         "(default) disables elastic recovery")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="coordinated checkpoint directory exported as "
                         "MXNET_CHECKPOINT_DIR to every role (default: "
                         "inherit the env, or auto-create a temp dir "
                         "when --max-restarts > 0)")
    ap.add_argument("--env", action="append", default=[],
                    help="extra KEY=VALUE for all roles (repeatable)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if not args.command:
        ap.error("no command given")
    if args.max_restarts < 0:
        ap.error("--max-restarts must be >= 0")
    if args.serve and args.num_servers > 0:
        ap.error("--serve spawns a scheduler + replicas; parameter "
                 "servers (-s) belong to training jobs")
    if args.max_restarts and args.num_servers <= 0 and not args.serve:
        ap.error("--max-restarts requires the scheduler topology "
                 "(-s > 0 or --serve): the serverless collective path "
                 "has no server-held state to recover a worker against")

    coord = args.coordinator or ("127.0.0.1:%d" % _free_port())

    if args.launcher == "manual":
        # before the auto-checkpoint-dir block: a local temp dir is
        # meaningless on the remote hosts the printed env targets (and
        # would leak here)
        return _manual(args, coord)

    auto_ckpt = None
    if args.max_restarts and args.checkpoint_dir is None and not args.serve:
        args.checkpoint_dir = os.environ.get("MXNET_CHECKPOINT_DIR")
        if not args.checkpoint_dir:
            import tempfile

            auto_ckpt = tempfile.mkdtemp(prefix="mxnet-ckpt-")
            args.checkpoint_dir = auto_ckpt
            print("launch.py: checkpoints in %s (auto-created; kept on "
                  "failure for post-mortem)" % auto_ckpt, flush=True)
    if args.num_servers > 0 or args.serve:
        rc = _spawn_topology(args, coord)
    else:
        rc = _spawn_serverless(args, coord)
    if auto_ckpt is not None and rc == 0:
        import shutil

        shutil.rmtree(auto_ckpt, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
