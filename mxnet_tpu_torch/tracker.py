"""The tracker's wire (counterpart of the wire half of
``mxnet_tpu/tracker.py``): the frame format, the restricted unpickler,
bounded-backoff connect and the validated env readers that the
parameter-server tier (``kvstore_server.py``) shares with it.

Frames are byte for byte the JAX package's: a 4-byte big-endian length
and a protocol-5 pickle of plain data, decoded by an unpickler that
refuses every global lookup; a length with the top bit set is an extended
frame whose large arrays follow as out-of-band buffers. So each package's
client talks to the other's server.

``Tracker``, ``TrackerClient``, ``worker_client`` and
``discover_server_uris`` (the scheduler's rendezvous, heartbeats and
elastic respawn) are not ported: they raise by name (ROADMAP.md Queue A
item 10). ``tracker_env_spec`` reads whether the environment names a
scheduler, so that ``kvstore.create('dist_async')`` and the data
service can refuse it.

In-cluster protocol, no auth: do not expose the port beyond the job.
"""
from __future__ import annotations

import io
import os
import pickle
import socket
import struct
import time

from . import config
from .base import MXNetError


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


def _not_ported(name):
    def refuse(*args, **kwargs):
        raise TrackerError("tracker.%s: the scheduler's rendezvous is not "
                           "ported (ROADMAP.md Queue A item 10)" % name)

    refuse.__name__ = name
    return refuse


Tracker = _not_ported("Tracker")
TrackerClient = _not_ported("TrackerClient")
worker_client = _not_ported("worker_client")
discover_server_uris = _not_ported("discover_server_uris")
