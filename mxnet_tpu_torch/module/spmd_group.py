"""The fused data-parallel group of ``Module(kvstore='tpu')`` (counterpart
of ``mxnet_tpu/module/spmd_group.py``).

``Module`` routes ``forward_backward``/``update`` here when its kvstore is
``'tpu'``: each batch is one ``TrainStep`` over ``train_mesh()`` of the
process group (one process a device, each given the global batch, of which
it keeps its data rank's rows), forward, backward, the gradient sums and
the update in one call, with the metric sums kept on the card
(``metric_stats``) and read at ``EvalMetric.get``.

Knobs: ``MXNET_TPU_MAX_INFLIGHT`` (steps queued on the card before the host
waits for the oldest), ``MXNET_TPU_DEVICE_METRICS`` (the metric sums on the
card), ``MXNET_TPU_ZERO`` (ZeRO), ``MXNET_MP_SIZE`` and ``MXNET_MP_RULES``
(tensor parallelism: the ranks form a ``(dp = N // mp) x mp`` mesh and the
rules shard the parameters over ``mp``, handed to ``TrainStep``; the
placed carry's bytes go to ``profiler.mp_stats``; ``get_params`` and the
optimizer states come back whole; ``mp=1`` is the data-parallel path bit
for bit). Not ported: ``distributed=True``, the multi-host tier.
"""
from __future__ import annotations

import collections
import pickle
import time

import numpy as np
import torch

from .. import config, profiler
from ..base import MXNetError
from ..ndarray import ndarray as nd
from ..parallel.feed import place_batch_array
from ..parallel.spmd import (FusedStepUnsupported, TrainStep,
                             data_sharding, functional_from_optimizer,
                             parse_rules)


class _DeviceMetricSource:
    """A ``(sum, count)`` pair of one metric statistic on the card, folded
    in batch by batch (``add``, no host sync) and read once by ``drain``
    (``EvalMetric.get``)."""

    def __init__(self, kind):
        self.kind = kind  # stats key: "correct" | "sum_ce" | "sum_loss"
        self._sum = None
        self._n = None

    def add(self, stats):
        s, n = stats[self.kind], stats["n"]
        if self._sum is None:
            self._sum, self._n = s, n
        else:
            self._sum, self._n = self._sum + s, self._n + n

    def drain(self):
        if self._sum is None:
            return 0.0, 0
        s, n = float(self._sum), int(self._n)
        self._sum = self._n = None
        return s, n

    def clear(self):
        self._sum = self._n = None


def _host(tree):
    """A dict of tensors (or tuples of them) as numpy on the host."""
    def conv(x):
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return x.detach().cpu().numpy()

    return {k: conv(v) for k, v in tree.items()}


class FusedSPMDGroup:
    """One fused train step over ``train_mesh(mp=MXNET_MP_SIZE)`` of the
    process group, from ``Module``'s one context a process."""

    def __init__(self, symbol, contexts, optimizer, arg_params, aux_params,
                 data_names, label_names, fixed_param_names=None, logger=None,
                 batch_size=None, inputs_need_grad=False, distributed=False,
                 zero=None):
        from ..parallel.mesh import data_group, mesh_device, mp_size, \
            train_mesh

        if distributed:
            raise MXNetError("fused SPMD step: distributed=True (the "
                             "multi-host tier) is not ported")
        # what the step cannot mirror is refused before any mesh is built
        if fixed_param_names:
            raise FusedStepUnsupported("fused SPMD step: fixed_param_names "
                                       "not supported")
        if inputs_need_grad:
            raise FusedStepUnsupported("fused SPMD step: inputs_need_grad "
                                       "not supported")
        self._fopt = functional_from_optimizer(
            optimizer, [k for k in symbol.list_arguments()
                        if k not in data_names and k not in label_names])
        if len(contexts) != 1:
            raise MXNetError("fused SPMD step: %d contexts; more than one "
                             "context in one process is not ported"
                             % len(contexts))
        device = contexts[0].torch_device()
        mp = mp_size()
        self._param_rules = parse_rules(config.get("MXNET_MP_RULES"))
        self.mesh = train_mesh(mp=mp, device=device.type)
        if mesh_device(self.mesh) != device:
            raise MXNetError("fused SPMD step: context %s but this rank's "
                             "mesh device is %s" % (contexts[0],
                                                    mesh_device(self.mesh)))
        self._data_axes = ("dp",)
        _group, n, _index = data_group(self.mesh, self._data_axes)
        if batch_size is not None and batch_size % n != 0:
            if mp > 1:
                raise MXNetError(
                    "fused SPMD step: batch size %d not divisible by the dp "
                    "size %d (MXNET_MP_SIZE=%d over %d devices)"
                    % (batch_size, n, mp, n * mp))
            raise MXNetError("fused SPMD step: batch size %d not divisible "
                             "by %d devices" % (batch_size, n))
        self._max_inflight = config.get_positive_int("MXNET_TPU_MAX_INFLIGHT")
        self._inflight = collections.deque()
        self._device_metrics = config.get_strict_bool(
            "MXNET_TPU_DEVICE_METRICS")
        if zero is None:
            zero = config.get_strict_bool("MXNET_TPU_ZERO")
        self.zero = bool(zero)
        self._data_names = list(data_names)
        self._label_names = list(label_names)
        self._output_names = list(symbol.list_outputs())
        self._ts = self._train_step(symbol)
        self.param_names = list(self._ts.param_names)
        self.aux_names = list(self._ts.aux_names)
        params, aux = self._copies(arg_params, aux_params)
        self._carry = self._ts.place(params, self._fopt.init(params), aux)
        self._step_no = 0
        self._loss = None
        self._outputs = None
        self._raw_outputs = None
        self._batch_sharding = data_sharding(self.mesh, self._data_axes)
        self._stats = None
        # ids of the metrics that folded the current batch's stats already
        self._stats_consumers = set()

    def _train_step(self, symbol):
        # rescale_grad carries the 1/batch normalization Module set
        return TrainStep(
            symbol, self._fopt, mesh=self.mesh, data_axes=self._data_axes,
            param_rules=self._param_rules,
            data_names=tuple(self._data_names),
            label_names=tuple(self._label_names), compute_dtype=None,
            normalize_grads=False, return_outputs=True,
            metric_stats=self._device_metrics, zero=self.zero)

    def _copies(self, arg_params, aux_params):
        """Copies of the host params and aux for the carry, which the step
        updates in place (``place`` broadcasts rank 0's)."""
        return ({k: arg_params[k].tensor.detach().clone()
                 for k in self.param_names},
                {k: aux_params[k].tensor.detach().clone()
                 for k in self.aux_names})

    # -- the hot loop --------------------------------------------------------
    def forward_backward_update(self, data_batch):
        """One fused step on the global batch: each rank places its rows
        on its device, then forward, backward, the sums and the update.
        The host waits for the card only when more than
        ``MXNET_TPU_MAX_INFLIGHT`` steps are queued."""
        arrays = list(zip(self._data_names, data_batch.data))
        labels = getattr(data_batch, "label", None) or []
        arrays += list(zip(self._label_names, labels))
        batch = {
            name: place_batch_array(
                self.mesh, self._data_axes, False, name,
                arr.tensor if isinstance(arr, nd.NDArray) else arr,
                sharding=self._batch_sharding)
            for name, arr in arrays}
        if self._device_metrics:
            self._carry, (loss, outs, stats) = self._ts(self._carry, batch)
            self._stats = stats
            self._stats_consumers.clear()
        else:
            self._carry, (loss, outs) = self._ts(self._carry, batch)
        self._step_no += 1
        self._loss = loss
        self._raw_outputs = outs
        self._outputs = None
        self._throttle()

    def _throttle(self):
        """Queue this step's completion event; wait for the oldest only
        when more than ``MXNET_TPU_MAX_INFLIGHT`` are queued."""
        if self._ts.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._inflight.append(ev)
            while len(self._inflight) > self._max_inflight:
                t0 = time.perf_counter()
                self._inflight.popleft().synchronize()
                profiler.h2d_record(stall_compute=time.perf_counter() - t0)
        profiler.h2d_record(steps=1, inflight=len(self._inflight))

    def drain(self):
        """Wait until every queued step has finished (checkpoint, epoch and
        evaluation boundaries)."""
        while self._inflight:
            self._inflight.popleft().synchronize()

    def get_outputs(self):
        """The last step's outputs, the global batch's (a host sync,
        counted)."""
        if self._outputs is None:
            if self._raw_outputs is None:
                raise MXNetError("fused SPMD step: no batch has run yet")
            profiler.h2d_record(host_syncs=1)
            ctx = self._ts.device
            from ..context import Context

            self._outputs = [nd.NDArray(o, Context.from_device(ctx))
                             for o in self._raw_outputs]
        return list(self._outputs)

    def _device_metric_plan(self, eval_metric):
        """``[(leaf metric, stats key)]`` when every leaf of the metric can
        be computed from the step's statistics; None sends it to the host
        path (a mixed accumulation would count twice)."""
        from .. import metric as metric_mod

        if len(self._output_names) != 1 or len(self._label_names) != 1:
            return None
        stats = self._stats
        leaves, stack = [], [eval_metric]
        while stack:
            m = stack.pop()
            if isinstance(m, metric_mod.CompositeEvalMetric):
                stack.extend(m.metrics)
                continue
            leaves.append(m)
        plan = []
        for m in leaves:
            if m.output_names is not None or m.label_names is not None:
                return None
            if type(m) is metric_mod.Accuracy and m.axis == 1 \
                    and "correct" in stats:
                plan.append((m, "correct"))
            elif type(m) in (metric_mod.CrossEntropy,
                             metric_mod.NegativeLogLikelihood) \
                    and m.eps == 1e-12 and "sum_ce" in stats:
                plan.append((m, "sum_ce"))
            else:
                return None
        return plan

    def _attach_source(self, m, kind):
        by_kind = m.__dict__.setdefault("_fused_metric_srcs", {})
        src = by_kind.get((id(self), kind))
        if src is None:
            src = by_kind[(id(self), kind)] = _DeviceMetricSource(kind)
        m._attach_device_source(src)
        return src

    def update_metric(self, eval_metric, labels):
        """Fold the step's statistics into the metric's device sources (no
        host sync), or, for a metric they cannot give, update it on the
        host from the outputs and labels."""
        if self._device_metrics and self._stats is not None:
            plan = self._device_metric_plan(eval_metric)
            if plan is not None:
                if id(eval_metric) not in self._stats_consumers:
                    for m, kind in plan:
                        self._attach_source(m, kind).add(self._stats)
                    self._stats_consumers.add(id(eval_metric))
                return
        eval_metric.update_dict(dict(zip(self._label_names, labels)),
                                dict(zip(self._output_names,
                                         self.get_outputs())))

    # -- params --------------------------------------------------------------
    def copy_params_to(self, arg_params, aux_params):
        """The carry's params, whole (a sharded one gathered over the mp
        group: every rank calls it), and aux into the host arrays."""
        self.drain()
        params, _opt, aux, _step = self._carry
        params = self._ts.whole_params(params)
        for k in self.param_names:
            nd.NDArray(params[k]).copyto(arg_params[k])
        for k in self.aux_names:
            nd.NDArray(aux[k]).copyto(aux_params[k])

    def _replace(self, params=None, opt_state=None, aux=None, step=None):
        """Place the carry again, keeping the pieces not given."""
        self.drain()
        old_p, old_o, old_a, old_s = self._carry
        carry = self._ts.place(params if params is not None else old_p,
                               opt_state if opt_state is not None else old_o,
                               aux if aux is not None else old_a)
        s = old_s
        if step is not None:
            s = int(step)
            if isinstance(old_s, torch.Tensor):
                s = torch.full((), s, dtype=torch.int32,
                               device=old_s.device)
        self._carry = carry[:3] + (s,)

    def set_params(self, arg_params, aux_params):
        """Reset the params and aux from host values (rank 0's win)."""
        params, aux = self._copies(arg_params, aux_params)
        self._replace(params=params, aux=aux)

    # -- optimizer state -----------------------------------------------------
    _STATE_FORMAT = "fused-spmd-v1"

    def get_states(self):
        """The optimizer state as the JAX package pickles it: the logical
        layout (mesh-size independent) as numpy, the step count and the
        ZeRO flag. Under ZeRO a collective: every rank calls it."""
        self.drain()
        params, opt_state, _aux, step_no = self._carry
        logical = self._ts.logical_opt_state(opt_state, params)
        return pickle.dumps({"format": self._STATE_FORMAT,
                             "opt_state": _host(logical),
                             "step": int(step_no), "zero": self._ts.zero})

    def set_states(self, blob):
        from ..optimizer import loads_states

        try:
            data = loads_states(blob)
        except (pickle.UnpicklingError, EOFError, ValueError) as e:
            raise MXNetError("fused SPMD step: unreadable optimizer states "
                             "(%s)" % e)
        if data.get("format") != self._STATE_FORMAT:
            raise MXNetError(
                "fused SPMD step: optimizer-state file was not written by the "
                "fused (kvstore='tpu') path; resume with the same kvstore "
                "type it was saved under")
        opt_state = {k: (tuple(np.asarray(x) for x in v)
                         if isinstance(v, (tuple, list)) else np.asarray(v))
                     for k, v in data["opt_state"].items()}
        self._replace(opt_state=opt_state, step=data["step"])
        self._step_no = data["step"]

    # -- the sentinel --------------------------------------------------------
    @property
    def sentinel(self):
        return self._ts.sentinel

    def health_stats(self):
        """The sentinel's counters (None when it is off), published to the
        profiler."""
        snap = self._ts.health_stats(self._carry)
        if snap is not None:
            profiler.health_sentinel(snap)
        return snap

    def reset_optimizer(self, optimizer):
        """A new step around a re-tuned imperative optimizer: params and aux
        stay, the optimizer state goes through its logical layout, the
        sentinel's counters restart."""
        self.drain()
        params, opt_state, aux, step_no = self._carry
        logical = self._ts.logical_opt_state(opt_state, params)
        self._fopt = functional_from_optimizer(optimizer,
                                               list(self.param_names))
        self._ts = self._train_step(self._ts.symbol)
        carry = self._ts.place(params, logical, aux)
        self._carry = carry[:3] + (step_no,)
