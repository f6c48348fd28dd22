"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``):
``module_checkpoint``, ``do_checkpoint``, ``elastic_checkpoint`` (the
coordinated multi-worker checkpoint of ``checkpoint.CheckpointManager``),
``log_train_metric``, ``Speedometer`` and ``ProgressBar``."""
from __future__ import annotations

import logging
import math
import sys
import time


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs."""
    from .model import save_checkpoint

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def elastic_checkpoint(manager, mod, kv, state_fn=None):
    """Epoch-end callback running the coordinated checkpoint every
    ``manager.period`` epochs, through three kvstore barriers (named
    ``ckpt-<epoch>-stage|progress|commit`` where the store takes names, so
    a respawned worker replaying one phase never pairs with a survivor in
    another):

    1. rank 0 creates the staging directory; barrier ``stage``;
    2. every worker writes its progress (``state_fn()``, by default the
       numpy RNG state, plus the epoch and batch cursor 0); barrier
       ``progress``;
    3. rank 0 snapshots the weights and optimizer state and commits while
       every other rank waits in barrier ``commit``, so no push lands in
       between. On a server kvstore the weights are pulled inside that
       window (the epoch-end ``get_params`` predates the first barrier); on
       a local one they are the module's own snapshot (``arg``/``aux`` of
       the callback) and ``mod.save_optimizer_states``.

    A respawned worker reads ``manager.latest()`` and passes
    ``begin_epoch=checkpoint.epoch`` to ``fit``."""
    import inspect

    rank = kv.rank

    def _default_state():
        import numpy as np

        return {"numpy_rng": np.random.get_state()}

    state_fn = state_fn or _default_state
    # probed once, outside the choreography: a TypeError caught around the
    # call would also hide unrelated ones
    try:
        named = "name" in inspect.signature(kv.barrier).parameters
    except (TypeError, ValueError):
        named = False

    def _callback(iter_no, sym=None, arg=None, aux=None):
        epoch = iter_no + 1
        if not manager.due(epoch):
            return

        def _sync(phase):
            if named:
                kv.barrier("ckpt-%d-%s" % (epoch, phase))
            else:
                kv.barrier()

        if rank == 0:
            manager.begin(epoch)
        _sync("stage")
        state = dict(state_fn())
        state.setdefault("epoch", epoch)
        state.setdefault("nbatch", 0)           # an epoch boundary
        manager.write_worker_state(epoch, rank, state)
        _sync("progress")
        if rank == 0:
            if getattr(kv, "server_side", False):
                import numpy as np

                weights = {}
                for k, v in (arg or {}).items():
                    buf = np.empty(v.shape, dtype=v.dtype)
                    kv.pull(k, out=buf)
                    weights["arg:%s" % k] = buf
                kv.save_optimizer_states(
                    manager.staged_optimizer_states_path(epoch))
                config = kv.get_optimizer_config()
            else:
                weights = {"arg:%s" % k: v.asnumpy()
                           for k, v in (arg or {}).items()}
                mod.save_optimizer_states(
                    manager.staged_optimizer_states_path(epoch))
                config = None
            # aux state is the worker's own (never on a server): rank 0's
            # copy is the one a respawn restores
            weights.update({"aux:%s" % k: v.asnumpy()
                            for k, v in (aux or {}).items()})
            manager.commit(epoch, weights=weights, optimizer_config=config,
                           num_workers=kv.num_workers)
        _sync("commit")

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f", param.epoch,
                             param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Logs samples/s (and the metric) every ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write("[%s] %s%s\r" % (prog_bar, percents, "%"))
