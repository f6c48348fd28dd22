"""BaseModule — the training-loop contract (counterpart of
``mxnet_tpu/module/base_module.py``): ``fit`` (bind, init_params,
init_optimizer, then per batch forward_backward, update, update_metric
and the callbacks, per epoch get/set_params, the epoch-end callbacks and
``score``), ``score``, ``predict``, ``iter_predict`` and
``save_params``/``load_params``.

``MXNET_TUNE_BACKGROUND=1`` arms ``tune.BackgroundTuner``: one bounded
tuning slot per epoch at the drain boundary after ``get_params``.
``fit(sparse_row_id_fn=)`` hands each next batch to ``prepare``, which
pulls the rows it names (``Module.prepare``); ``score`` and ``predict``
accept it and ignore it, as the JAX package does. ``fit(monitor=)``
installs the monitor after ``bind`` and calls its ``tic`` before each
batch and ``toc_print`` after its metric update. With a checkpoint
directory (``MXNET_CHECKPOINT_DIR``) and ``MXNET_TPU_GUARD`` on (the
default), ``fit`` arms ``health.HealthGuard``: its preemption handler
before the loop, its ``on_batch`` at each batch boundary (a rollback to
the newest checkpoint, or the preemption's checkpoint and exit 75).
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from ..io import DataBatch
from ..model import BatchEndParam
from ..ndarray import ndarray as nd


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [a for a in args if not a.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). Did "
               "you mean one of:\n\t%s" % (typename, names, name,
                                           "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high level ----------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Run inference over ``eval_data`` and return the metric's
        ``(name, value)`` pairs."""
        assert self.binded and self.params_initialized
        del sparse_row_id_fn
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Outputs over ``eval_data`` (an iterator, or one array as one
        batch), the pad rows dropped, concatenated over the batches."""
        assert self.binded and self.params_initialized
        del sparse_row_id_fn
        if isinstance(eval_data, (nd.NDArray, np.ndarray)):
            if isinstance(eval_data, np.ndarray):
                eval_data = nd.array(eval_data, ctx=self._context[0])
            self.forward(DataBatch(data=[eval_data]), is_train=False)
            return self.get_outputs()[0]
        output_list = [[o.copy() for o in outs] for outs, _n, _b in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list:
            return output_list
        if merge_batches:
            merged = [nd.concatenate([out[i] for out in output_list])
                      for i in range(len(output_list[0]))]
            if len(merged) == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Train for ``num_epoch`` epochs: per batch forward_backward,
        update, update_metric and ``batch_end_callback``; per epoch the
        parameters come back from the card (``get_params``) for
        ``epoch_end_callback`` and ``eval_data`` is scored."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..health import HealthGuard
        from ..initializer import Uniform

        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        # the self-healing guardrail: watches health at a bounded cadence,
        # rolls back to the newest checkpoint with an lr backoff, and turns
        # a SIGTERM into a grace-window checkpoint and exit 75 (health.py)
        health_guard = HealthGuard.from_env(
            self, kv=getattr(self, "_kvstore", None), logger=self.logger)
        if health_guard is not None:
            health_guard.install_preemption_handler()
        # background tuning: one bounded slot per epoch at the drain
        # boundary below, for kernel shapes this job ran and the schedule
        # table missed; never inside the step loop (tune/background.py)
        from ..tune.background import BackgroundTuner

        bg_tuner = BackgroundTuner.from_env(logger=self.logger)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                try:
                    next_data_batch = next(data_iter)
                    self.prepare(next_data_batch,
                                 sparse_row_id_fn=sparse_row_id_fn)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                if health_guard is not None:
                    # may roll the module back, or checkpoint and raise
                    # SystemExit(EXIT_PREEMPTED)
                    health_guard.on_batch(epoch, nbatch, eval_metric,
                                          data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            if bg_tuner is not None:
                # get_params waited for the card: the slot cannot overlap
                # a step; a winner commits atomically and the next call of
                # that shape picks it up
                bg_tuner.on_drain()
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # -- abstract ------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        from ..ndarray.utils import save

        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        save(fname, save_dict)

    def load_params(self, fname):
        """Parameters from ``fname``, staged on the CPU and copied into the
        executors by ``set_params``."""
        from ..context import cpu
        from ..ndarray.utils import load

        arg_params, aux_params = {}, {}
        for k, value in load(fname, ctx=cpu()).items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Prepare for the next batch (a no-op here; ``Module`` pulls the
        rows ``sparse_row_id_fn`` names)."""

    def install_monitor(self, mon):
        raise NotImplementedError()
