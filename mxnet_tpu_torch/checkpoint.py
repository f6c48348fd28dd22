"""Coordinated checkpoint and restore for elastic training (counterpart of
``mxnet_tpu/checkpoint.py``).

Every ``period`` epochs the job writes one checkpoint directory
``ckpt-<epoch:08d>`` holding, as the JAX package lays it out byte for
byte (a checkpoint written by either package loads in the other):

- ``weights.pkl``: ``{"arg:<name>" | "aux:<name>": numpy}``, the pickle of
  a plain dict (protocol 4);
- ``optimizer.states``: the optimizer state, as ``save_optimizer_states``
  writes it (or per-rank ``optimizer-shard-<rank:05d>.states`` files of
  disjoint ``{key: state}`` maps, merged on read);
- ``optimizer.pkl``: the server optimizer's plain ``(name, kwargs,
  extras)``, so a respawned server rebuilds its updater;
- ``worker-<rank>.pkl``: each worker's progress (epoch, batch cursor,
  the numpy RNG state);
- ``meta.json``: ``{"epoch", "format", "num_workers"}``.

Atomicity: everything is staged in ``.tmp-ckpt-<epoch:08d>``, every file
and the directory are fsynced, and one rename publishes it; ``LATEST`` is
written the same way. A crash at any point leaves the previous checkpoint
or the new one, never a torn directory. Retention keeps the newest
``retain`` complete checkpoints.

Every pickle is read through :func:`loads_plain`, which admits numpy
arrays, numpy scalars and plain containers only: a checkpoint file cannot
name a callable.
"""
from __future__ import annotations

import errno
import io
import json
import os
import pickle
import shutil

from .base import MXNetError

FORMAT_VERSION = 1
_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-" + _PREFIX
_LATEST = "LATEST"

__all__ = ["atomic_write_bytes", "unwrap_states_map", "loads_plain",
           "Checkpoint", "CheckpointManager", "FORMAT_VERSION"]


# -- the restricted reader ----------------------------------------------------
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _PlainUnpickler(pickle.Unpickler):
    """Admits numpy array and scalar reconstruction only: plain containers
    (dict, list, tuple, set), strings and numbers need no global, and any
    other global (a callable a file could name) is refused."""

    def __init__(self, data, what):
        super().__init__(io.BytesIO(data))
        self._what = what

    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise MXNetError("%s: refusing to load %s.%s (only numpy arrays and "
                         "plain containers are allowed)"
                         % (self._what, module, name))


def loads_plain(data, what="checkpoint"):
    """The object pickled in ``data``, numpy arrays, numpy scalars and
    plain containers only; ``what`` names the file in the error."""
    return _PlainUnpickler(data, what).load()


def _read_plain(path, what):
    with open(path, "rb") as f:
        return loads_plain(f.read(), what)


# -- fsync: a checkpoint that only reached the page cache is not one ----------
def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError as e:   # some filesystems refuse O_RDONLY on directories
        if e.errno in (errno.EACCES, errno.EISDIR):
            return
        raise
    try:
        os.fsync(fd)
    except OSError:
        pass               # best effort off POSIX
    finally:
        os.close(fd)


def atomic_write_bytes(fname, data):
    """``data`` to ``fname`` through ``<fname>.tmp``, fsync and a rename,
    then the directory fsynced: a crash mid-write leaves the old file, never
    a torn one. Every optimizer-state and checkpoint file of the port is
    written through it."""
    fname = os.fspath(fname)
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.replace(tmp, fname)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(os.path.abspath(fname)))


def unwrap_states_map(data):
    """The ``{index: state}`` map of either optimizer-state dump shape: a
    bare map, or the reference's ``(states_map, optimizer)`` pair."""
    if isinstance(data, tuple) and len(data) == 2 \
            and isinstance(data[1], dict):
        return data[0]
    return data


# -- the read handle ----------------------------------------------------------
class Checkpoint:
    """Read handle on one committed checkpoint directory."""

    def __init__(self, path):
        self.path = os.fspath(path)
        with open(os.path.join(self.path, "meta.json"), "r") as f:
            self.meta = json.load(f)
        self.epoch = int(self.meta["epoch"])

    def _file(self, name):
        p = os.path.join(self.path, name)
        return p if os.path.exists(p) else None

    def weights(self):
        """``{prefixed name: numpy}``, or {} when no weights were saved."""
        p = self._file("weights.pkl")
        return _read_plain(p, "checkpoint weights") if p else {}

    def split_weights(self):
        """``(arg_params, aux_params)`` as plain ``{name: numpy}`` dicts.
        A resuming worker needs the aux half: BatchNorm's moving
        statistics never live on a server."""
        arg, aux = {}, {}
        for name, value in self.weights().items():
            kind, _, bare = name.partition(":")
            (arg if kind == "arg" else aux)[bare] = value
        return arg, aux

    def optimizer_states_path(self):
        return self._file("optimizer.states")

    def optimizer_state_shard_paths(self):
        """The per-rank optimizer-state shard files, by rank; [] when the
        checkpoint was written as one file."""
        try:
            names = sorted(n for n in os.listdir(self.path)
                           if n.startswith("optimizer-shard-")
                           and n.endswith(".states"))
        except OSError:
            return []
        return [os.path.join(self.path, n) for n in names]

    def optimizer_states(self):
        """The optimizer-state bytes: ``optimizer.states`` when present,
        else the shard files' disjoint maps merged into one pickled
        ``{key: state}`` map; None when neither exists."""
        p = self.optimizer_states_path()
        if p is not None:
            with open(p, "rb") as f:
                return f.read()
        shards = self.optimizer_state_shard_paths()
        if not shards:
            return None
        merged = {}
        for sp in shards:
            merged.update(unwrap_states_map(
                _read_plain(sp, "optimizer-state shard")))
        return pickle.dumps(merged, protocol=4)

    def optimizer_config(self):
        """The plain ``(name, kwargs, extras)`` tuple, or None."""
        p = self._file("optimizer.pkl")
        return _read_plain(p, "checkpoint optimizer config") if p else None

    def worker_state(self, rank):
        p = self._file("worker-%d.pkl" % int(rank))
        return _read_plain(p, "checkpoint worker state") if p else None


# -- the manager --------------------------------------------------------------
class CheckpointManager:
    """Atomic periodic checkpoints with retention.

    :meth:`save` stages and commits in one call. The coordinated form
    (``callback.elastic_checkpoint``): rank 0 calls :meth:`begin`, every
    worker writes its progress with :meth:`write_worker_state`, rank 0
    stages the weights and optimizer state and calls :meth:`commit`, with
    barriers between the phases so no push lands in the snapshot."""

    def __init__(self, directory, period=1, retain=2):
        self.directory = os.fspath(directory)
        period, retain = int(period), int(retain)
        if period < 1:
            raise MXNetError("CheckpointManager: period must be >= 1, "
                             "got %d" % period)
        if retain < 1:
            raise MXNetError("CheckpointManager: retain must be >= 1, "
                             "got %d" % retain)
        self.period = period
        self.retain = retain
        os.makedirs(self.directory, exist_ok=True)

    @classmethod
    def from_env(cls):
        """The manager of ``MXNET_CHECKPOINT_DIR`` (with
        ``MXNET_CHECKPOINT_PERIOD`` and ``MXNET_CHECKPOINT_RETAIN``), or
        None when no directory is set."""
        from . import config

        directory = config.get("MXNET_CHECKPOINT_DIR")
        if not directory:
            return None
        return cls(directory,
                   period=config.get_positive_int("MXNET_CHECKPOINT_PERIOD"),
                   retain=config.get_positive_int("MXNET_CHECKPOINT_RETAIN"))

    # -- naming ---------------------------------------------------------------
    def due(self, epoch):
        return int(epoch) % self.period == 0

    def _name(self, epoch):
        return "%s%08d" % (_PREFIX, int(epoch))

    def path_for(self, epoch):
        return os.path.join(self.directory, self._name(epoch))

    def tmp_path_for(self, epoch):
        return os.path.join(self.directory,
                            "%s%08d" % (_TMP_PREFIX, int(epoch)))

    def staged_optimizer_states_path(self, epoch):
        """Where rank 0 stages the optimizer state between begin and
        commit (``save_optimizer_states`` writes there)."""
        return os.path.join(self.tmp_path_for(epoch), "optimizer.states")

    def staged_optimizer_shard_path(self, epoch, rank):
        """Where rank ``rank`` stages its optimizer-state shard, a disjoint
        ``{key: state}`` map that :meth:`Checkpoint.optimizer_states`
        merges on read."""
        return os.path.join(self.tmp_path_for(epoch),
                            "optimizer-shard-%05d.states" % int(rank))

    # -- the staged write -----------------------------------------------------
    def begin(self, epoch):
        """A fresh staging directory for ``epoch`` (rank 0); a leftover of a
        crashed attempt is discarded."""
        tmp = self.tmp_path_for(epoch)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def write_worker_state(self, epoch, rank, state):
        """One worker's progress into the staging directory (every worker,
        after rank 0's :meth:`begin`; each writes only its own file)."""
        tmp = self.tmp_path_for(epoch)
        if not os.path.isdir(tmp):
            raise MXNetError(
                "checkpoint staging dir %s missing: begin(%d) must run "
                "(rank 0) before worker states are written" % (tmp, epoch))
        atomic_write_bytes(os.path.join(tmp, "worker-%d.pkl" % int(rank)),
                           pickle.dumps(state, protocol=4))

    def commit(self, epoch, weights=None, optimizer_config=None,
               num_workers=None):
        """Finish the staged checkpoint: weights, config and meta written,
        everything fsynced, one rename, ``LATEST`` updated, retention
        applied. Returns the committed path."""
        tmp = self.tmp_path_for(epoch)
        if not os.path.isdir(tmp):
            raise MXNetError("checkpoint commit(%d): begin() was never "
                             "called (no staging dir %s)" % (epoch, tmp))
        if weights is not None:
            atomic_write_bytes(os.path.join(tmp, "weights.pkl"),
                               pickle.dumps(dict(weights), protocol=4))
        if optimizer_config is not None:
            atomic_write_bytes(os.path.join(tmp, "optimizer.pkl"),
                               pickle.dumps(optimizer_config, protocol=4))
        meta = {"format": FORMAT_VERSION, "epoch": int(epoch)}
        if num_workers is not None:
            meta["num_workers"] = int(num_workers)
        atomic_write_bytes(os.path.join(tmp, "meta.json"),
                           json.dumps(meta, sort_keys=True).encode())
        for name in os.listdir(tmp):
            _fsync_file(os.path.join(tmp, name))
        _fsync_dir(tmp)
        final = self.path_for(epoch)
        if os.path.isdir(final):      # a re-checkpoint of the same epoch
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        atomic_write_bytes(os.path.join(self.directory, _LATEST),
                           self._name(epoch).encode())
        self._apply_retention()
        return final

    def save(self, epoch, weights=None, optimizer_states=None,
             optimizer_config=None, worker_states=None, num_workers=None):
        """Stage and commit in one call (no coordination)."""
        self.begin(epoch)
        for rank, state in (worker_states or {}).items():
            self.write_worker_state(epoch, rank, state)
        if optimizer_states is not None:
            atomic_write_bytes(self.staged_optimizer_states_path(epoch),
                               optimizer_states)
        return self.commit(epoch, weights=weights,
                           optimizer_config=optimizer_config,
                           num_workers=num_workers)

    # -- the read side --------------------------------------------------------
    def _complete(self):
        """Committed checkpoint names, oldest first."""
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        return [n for n in names if n.startswith(_PREFIX) and
                os.path.exists(os.path.join(self.directory, n, "meta.json"))]

    def latest(self):
        """The newest complete checkpoint, or None: found by scanning the
        committed directories, not through ``LATEST`` (a crash between the
        rename and the pointer's update must not hide a commit)."""
        names = self._complete()
        return Checkpoint(os.path.join(self.directory, names[-1])) \
            if names else None

    def _apply_retention(self):
        names = self._complete()
        for name in names[:-self.retain]:
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
        # staging directories of crashed writers are garbage once a newer
        # commit landed
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
