"""Self-healing training (counterpart of ``mxnet_tpu/health.py``): what
happens when training is sick or its node is being taken away.

- :class:`HealthGuard`, the ``Module.fit`` guardrail. At a bounded cadence
  it looks at the job's health (the fused tier: the sentinel's counters
  of ``parallel.TrainStep(sentinel=)``, drained in one copy; the
  per-executor and server tiers: a finite check of the batch's outputs
  and a batch cross-entropy), and on ``consec`` consecutive unhealthy
  steps or a loss spike rolls the job back to
  ``CheckpointManager.latest()`` with a learning-rate backoff and a
  bounded budget. On the parameter-server tier the ranks agree through
  named barrier rounds (``health-rb-<k>-enter`` and ``-restored``), and
  every server restores its own shard through the path a respawned
  server takes (``KVStoreServer.restore_from_checkpoint``).
- Preemption: a worker (``DMLC_ROLE=worker``) installs a SIGTERM/SIGINT
  handler that only sets a flag; at the next batch boundary the fit loop
  drains the queued steps, writes a resumable checkpoint inside the
  ``MXNET_PREEMPT_GRACE`` window and exits with :data:`EXIT_PREEMPTED`,
  which a supervisor respawns without spending its restart budget. A
  timer exits the process at the end of the window whatever happens.

The counters ride the profiler's ``healthStats``.
"""
from __future__ import annotations

import logging
import math
import os
import signal
import threading
import time

import numpy as np

from . import config, profiler
from .base import MXNetError

#: EX_TEMPFAIL: the resumable exit status of a preempted worker after its
#: grace-window checkpoint
EXIT_PREEMPTED = 75

__all__ = ["HealthGuard", "EXIT_PREEMPTED"]


class HealthGuard:
    """Detection, reaction and resumption for one ``fit()`` run.

    ``BaseModule.fit`` builds it through :meth:`from_env` when the job has
    a checkpoint directory (``MXNET_CHECKPOINT_DIR``) and
    ``MXNET_TPU_GUARD`` is on (the default). Every threshold is read
    strictly from its knob unless given: a malformed knob raises here,
    never trains with a substituted default."""

    _SPIKE_WARMUP = 5  # checks before the EMA is trusted

    def __init__(self, module, kv=None, manager=None, logger=None,
                 consec=None, spike=None, backoff=None, budget=None,
                 interval=None, grace=None):
        self.module = module
        self.kv = kv
        self.manager = manager
        self.logger = logger or logging.getLogger(__name__)
        self.consec = config.get_positive_int("MXNET_TPU_GUARD_CONSEC") \
            if consec is None else int(consec)
        self.spike = config.get_nonneg_float("MXNET_TPU_GUARD_SPIKE") \
            if spike is None else float(spike)
        self.backoff = config.get_positive_float("MXNET_TPU_GUARD_BACKOFF") \
            if backoff is None else float(backoff)
        if not 0.0 < self.backoff <= 1.0:
            raise MXNetError(
                "MXNET_TPU_GUARD_BACKOFF=%r must be in (0, 1] — a "
                "rollback that RAISES the learning rate re-diverges"
                % (self.backoff,))
        self.budget = config.get_nonneg_int("MXNET_TPU_GUARD_BUDGET") \
            if budget is None else int(budget)
        self.interval = config.get_positive_int("MXNET_TPU_GUARD_INTERVAL") \
            if interval is None else int(interval)
        self.grace = config.get_positive_float("MXNET_PREEMPT_GRACE") \
            if grace is None else float(grace)
        self.rollbacks = 0
        self._consec_host = 0
        self._ema = None
        self._warm = 0
        self._metric = None
        self._preempt = threading.Event()
        self._preempt_t = None
        self._handler_installed = False
        # a spike may only trigger where every rank reaches the same
        # verdict, or the rollback barrier never pairs: the sentinel's word
        # is the global batch's, but a server-tier rank's batch CE is its
        # own. Non-finite detection stays on everywhere (a poisoned server
        # weight poisons every rank's pulls).
        self._spike_coordinated = not (
            kv is not None and getattr(kv, "server_side", False)
            and int(getattr(kv, "num_workers", 1) or 1) > 1)

    @classmethod
    def from_env(cls, module, kv=None, logger=None):
        """The armed guard of this job, or None: it needs a checkpoint
        directory to roll back to and ``MXNET_TPU_GUARD`` on."""
        from .checkpoint import CheckpointManager

        if not config.get_strict_bool("MXNET_TPU_GUARD"):
            return None
        manager = CheckpointManager.from_env()
        if manager is None:
            return None
        return cls(module, kv=kv, manager=manager, logger=logger)

    # -- preemption -----------------------------------------------------------
    def install_preemption_handler(self):
        """SIGTERM/SIGINT to a drain-checkpoint-exit, for a supervised
        worker (``DMLC_ROLE=worker``) on the main thread only; idempotent.
        Other processes keep the default disposition."""
        if self._handler_installed:
            return
        if os.environ.get("DMLC_ROLE", "").lower() != "worker":
            return
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)
        except ValueError:
            return
        self._handler_installed = True

    def _on_signal(self, signum, frame):
        if not self._preempt.is_set():
            self._preempt_t = time.monotonic()
            self._preempt.set()
            # the scheduler kills the process at the end of the window:
            # exiting resumable beats a SIGKILL mid-checkpoint
            t = threading.Timer(self.grace, self._hard_exit)
            t.daemon = True
            t.start()
            os.write(2, (b"[health] preemption signal received: draining"
                         b" + checkpointing inside the grace window\n"))

    @staticmethod
    def _hard_exit():
        os.write(2, b"[health] preemption grace expired; exiting "
                    b"resumable without a fresh checkpoint\n")
        os._exit(EXIT_PREEMPTED)

    @property
    def preempt_requested(self):
        return self._preempt.is_set()

    def request_preemption(self):
        """Flag a preemption as if SIGTERM arrived, without the hard-exit
        timer (the caller owns the deadline)."""
        self._preempt_t = time.monotonic()
        self._preempt.set()

    # -- the batch-boundary hook ----------------------------------------------
    def on_batch(self, epoch, nbatch, eval_metric=None, labels=None):
        """Handles a pending preemption (raises
        ``SystemExit(EXIT_PREEMPTED)``), then checks health at its cadence
        and rolls back when training is sick."""
        self._metric = eval_metric
        if self._preempt.is_set():
            self._preempt_exit(epoch, nbatch)
        fused = getattr(self.module, "_fused", None)
        if fused is not None:
            if getattr(fused, "sentinel", "off") == "off":
                return  # no health word: checking would be a per-batch
                # sync, which the fused tier exists to avoid
            if (nbatch + 1) % self.interval:
                return
            self._check_sentinel(fused.health_stats())
        else:
            self._check_host(labels)

    # -- detection ------------------------------------------------------------
    def _check_sentinel(self, snap):
        if not snap:
            return
        if snap["consec"] >= self.consec:
            self.rollback("sentinel: %d consecutive unhealthy steps "
                          "(nonfinite loss=%d grad=%d param=%d)"
                          % (snap["consec"], snap["nonfinite_loss"],
                             snap["nonfinite_grad"],
                             snap["nonfinite_param"]))
        elif snap["last_healthy"] and self._spiked(snap["last_loss"]):
            self.rollback("loss spike: %.4g > %gx EMA %.4g"
                          % (snap["last_loss"], self.spike, self._ema))

    def _check_host(self, labels):
        """The per-executor and server tiers: the outputs come to the host
        for the metric at batch rate anyway."""
        try:
            out = self.module.get_outputs()[0].asnumpy()
        except Exception:
            return
        if not np.isfinite(out).all():
            self._consec_host += 1
            profiler.health_record(host_unhealthy=1)
            if self._consec_host >= self.consec:
                self.rollback("host check: %d consecutive batches with "
                              "non-finite outputs" % self._consec_host)
            return
        self._consec_host = 0
        if not self._spike_coordinated:
            return  # a rank-local CE must not strand the rollback barrier
        loss = self._batch_ce(out, labels)
        if loss is not None and self._spiked(loss):
            self.rollback("loss spike: %.4g > %gx EMA %.4g"
                          % (loss, self.spike, self._ema))

    @staticmethod
    def _batch_ce(out, labels):
        """The batch's mean cross-entropy from host probabilities, or None
        when the shapes are not (probs, int labels)."""
        if not labels:
            return None
        lbl = labels[0]
        lbl = lbl.asnumpy() if hasattr(lbl, "asnumpy") else np.asarray(lbl)
        lbl = lbl.reshape(-1)
        if out.ndim != 2 or out.shape[0] != lbl.shape[0]:
            return None
        idx = lbl.astype(np.int64)
        if idx.size == 0 or idx.min() < 0 or idx.max() >= out.shape[1]:
            return None
        picked = out[np.arange(idx.size), idx]
        return float(-np.mean(np.log(picked + 1e-12)))

    def _spiked(self, loss):
        if self.spike <= 0 or not math.isfinite(loss):
            return False
        if self._ema is None:
            self._ema = loss
            self._warm = 1
            return False
        spiked = (self._warm >= self._SPIKE_WARMUP
                  and loss > self.spike * max(self._ema, 1e-8))
        if not spiked:
            self._ema = 0.9 * self._ema + 0.1 * loss
            self._warm += 1
        return spiked

    # -- reaction: the rollback -----------------------------------------------
    def rollback(self, reason):
        """Back to the newest committed checkpoint with the lr backoff.
        Past ``MXNET_TPU_GUARD_BUDGET`` rollbacks the next trigger fails
        the job loudly instead of looping."""
        self.rollbacks += 1
        profiler.health_record(rollbacks=1)
        if self.rollbacks > self.budget:
            raise MXNetError(
                "health guard: %s, but the rollback budget (%d) is "
                "exhausted — failing the job (elastic supervision "
                "resumes from the last checkpoint)" % (reason, self.budget))
        ck = self.manager.latest() if self.manager is not None else None
        if ck is None:
            raise MXNetError(
                "health guard: %s, and no committed checkpoint exists "
                "to roll back to (%s)"
                % (reason, getattr(self.manager, "directory", None)))
        self.logger.warning(
            "[health] %s: rolling back to %s (epoch %d), lr backoff x%g "
            "(rollback %d/%d)", reason, ck.path, ck.epoch, self.backoff,
            self.rollbacks, self.budget)
        print("[health] event=rollback reason=%r ckpt=%s epoch=%d "
              "count=%d" % (reason, ck.path, ck.epoch, self.rollbacks),
              flush=True)
        if self.kv is not None and getattr(self.kv, "server_side", False):
            self._rollback_server(ck)
        else:
            self._rollback_local(ck)
        if self._metric is not None:
            self._metric.reset()  # drop the poisoned accumulations
        self._consec_host = 0
        self._ema = None
        self._warm = 0

    def _backoff_lr(self, opt):
        """Scale the optimizer's lr; a scheduler-driven lr cannot be backed
        off (``set_learning_rate`` raises): warn, and go on with the
        rollback that saves the job."""
        if opt is None:
            return
        try:
            opt.set_learning_rate(opt.lr * self.backoff)
        except MXNetError as e:
            self.logger.warning("[health] lr backoff skipped: %s", e)

    def _rollback_local(self, ck):
        """The fused tier and the local tiers: weights, aux and optimizer
        state restored module-side; on the fused tier the step is rebuilt
        around the backed-off optimizer (``reset_optimizer``)."""
        from .context import cpu
        from .ndarray import ndarray as nd

        mod = self.module
        arg_ck, aux_ck = ck.split_weights()
        if not arg_ck:
            raise MXNetError("health guard: checkpoint %s holds no "
                             "weights to roll back to" % ck.path)
        host = cpu()
        mod.set_params({k: nd.array(v, ctx=host) for k, v in arg_ck.items()},
                       {k: nd.array(v, ctx=host) for k, v in aux_ck.items()},
                       allow_missing=False, force_init=True,
                       allow_extra=True)
        states = ck.optimizer_states_path()
        if states is None:
            shards = ck.optimizer_state_shard_paths()
            states = shards[0] if len(shards) == 1 else None
        if states is not None and getattr(mod, "optimizer_initialized",
                                          False):
            try:
                mod.load_optimizer_states(states)
            except MXNetError as e:
                # a checkpoint of another tier's format: the weights are
                # back either way, the state restarts cold
                self.logger.warning(
                    "[health] optimizer state not restored (%s); "
                    "momentum restarts from zero", e)
        opt = getattr(mod, "_optimizer", None)
        self._backoff_lr(opt)
        fused = getattr(mod, "_fused", None)
        if fused is not None and opt is not None:
            fused.reset_optimizer(opt)

    def _rollback_server(self, ck):
        """The server tier: every rank meets at ``health-rb-<k>-enter`` (no
        push in flight after it), rank 0 has every server reload its shard
        from its own ``MXNET_CHECKPOINT_DIR`` with the lr backoff, every
        rank meets at ``health-rb-<k>-restored``, then pulls the restored
        weights into its executors before the next forward (a forward on
        the poisoned weights would push poisoned gradients back)."""
        from .context import cpu
        from .ndarray import ndarray as nd

        kv, mod = self.kv, self.module
        k = self.rollbacks
        kv.barrier("health-rb-%d-enter" % k)
        # every rank drops its 2-bit error-feedback residuals in the
        # quiesced window: a NaN residual would zero its pushes for good
        if hasattr(kv, "reset_gradient_residuals"):
            kv.reset_gradient_residuals()
        if kv.rank == 0:
            info = kv.rollback_servers(lr_scale=self.backoff, gen=k)
            self.logger.warning(
                "[health] servers restored %s keys from checkpoint "
                "epoch %s (lr now %s)", info.get("keys"),
                info.get("epoch"), info.get("lr"))
        kv.barrier("health-rb-%d-restored" % k)
        _arg_ck, aux_ck = ck.split_weights()
        for name, v in aux_ck.items():
            if name in mod._aux_params:
                nd.array(v, ctx=cpu()).copyto(mod._aux_params[name])
        names = sorted(mod._arg_params)
        if names:
            kv.pull(names, [mod._arg_params[n] for n in names], priority=0)
        mod._exec_group.set_params(mod._arg_params, mod._aux_params)
        mod._params_dirty = False
        # the local mirror of the server-side backoff
        self._backoff_lr(getattr(mod, "_optimizer", None))

    # -- reaction: the preemption ---------------------------------------------
    def _preempt_exit(self, epoch, nbatch):
        """Drain, checkpoint, exit resumable: at a batch boundary (the
        handler only sets a flag; the checkpoint cannot run mid-step)."""
        profiler.health_record(preemptions=1)
        fused = getattr(self.module, "_fused", None)
        if fused is not None:
            try:
                fused.drain()  # retire the queued steps
            except Exception:
                pass
        wrote = False
        if self.manager is not None:
            try:
                wrote = self._write_preemption_checkpoint(epoch, nbatch)
            except Exception as e:
                self.logger.warning(
                    "[health] preemption checkpoint failed (%s); exiting "
                    "resumable against the previous checkpoint", e)
        elapsed = 0.0 if self._preempt_t is None \
            else time.monotonic() - self._preempt_t
        print("[health] event=preempted epoch=%d nbatch=%d "
              "checkpoint=%s elapsed=%.1fs exit=%d"
              % (epoch, nbatch, wrote, elapsed, EXIT_PREEMPTED),
              flush=True)
        raise SystemExit(EXIT_PREEMPTED)

    def _write_preemption_checkpoint(self, epoch, nbatch):
        """One worker's own resumable snapshot, committed under the epoch
        it was preempted in (resume at epoch E, as the epoch-end
        checkpoints say). No barrier: the peers of one preempted worker
        are still training and would never arrive. The weights come
        through ``get_params``: the server pull on the server tier, the
        drained device copy on the fused tier."""
        mgr, mod, kv = self.manager, self.module, self.kv
        rank = int(getattr(kv, "rank", 0) or 0) if kv is not None else 0
        epoch = int(epoch)
        mgr.begin(epoch)
        mgr.write_worker_state(epoch, rank, {
            "epoch": epoch, "nbatch": int(nbatch), "preempted": True,
            "numpy_rng": np.random.get_state()})
        arg, aux = mod.get_params()
        weights = {"arg:%s" % k: v.asnumpy() for k, v in arg.items()}
        weights.update({"aux:%s" % k: v.asnumpy() for k, v in aux.items()})
        opt_config = None
        if kv is not None and getattr(kv, "server_side", False):
            kv.save_optimizer_states(
                mgr.staged_optimizer_states_path(epoch))
            opt_config = kv.get_optimizer_config()
        elif getattr(mod, "optimizer_initialized", False):
            mod.save_optimizer_states(
                mgr.staged_optimizer_states_path(epoch))
        num_workers = getattr(kv, "num_workers", 1) if kv is not None else 1
        mgr.commit(epoch, weights=weights, optimizer_config=opt_config,
                   num_workers=num_workers)
        return True
