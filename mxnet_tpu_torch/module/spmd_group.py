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
for bit).

``distributed=True`` (the ``dist_*`` kvstores, workers of a launcher's job
joined by :mod:`..dist`): the mesh is ``dist.global_mesh``, ``("dcn",
"dp")`` of shape ``(num_workers, 1)``, both of them data axes; each worker
feeds its own rows (the global batch is the local one times the workers),
placed as they are; ``TrainStep.place`` makes rank 0's params and aux win
bit for bit; every batch the workers' local row counts are held equal by
one collective (``_check_local_batch_agreement``), unless its arrays were
placed already (``DeviceQueueIter`` checks its first batch); the outputs
are this worker's rows; ``get_params`` and the optimizer states are the
same on every worker. ``MXNET_MP_SIZE > 1`` is refused there.

More than one context (``Module(context=[...], kvstore='tpu')``): the mesh is
``train_mesh(devices=contexts)``, a one-process mesh of one replica a
context (``parallel.mesh.LocalMesh``), and the step is ``TrainStep`` over it,
its replicas in lockstep on threads; the outputs, metric statistics,
parameters and optimizer states are replica 0's, the same on every replica.
A context may appear once (by device type and id, so ``cpu(0)``..``cpu(3)``
are four replicas), and the batch must divide by the count, as in the JAX
package. ``MXNET_MP_SIZE > 1`` over a context list raises by name (not
ported), and so does a list under ``distributed``.
"""
from __future__ import annotations

import collections
import pickle
import time

import numpy as np
import torch

from .. import chaos, config, profiler
from ..base import MXNetError
from ..ndarray import ndarray as nd
from ..parallel.feed import is_preplaced, place_batch_array
from ..parallel.spmd import (FusedStepUnsupported, TrainStep,
                             data_sharding, functional_from_optimizer,
                             parse_rules, with_step)


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
        local = len(contexts) > 1
        if local:
            keys = [(c.device_type, c.device_id) for c in contexts]
            if len(set(keys)) != len(keys):
                raise MXNetError("fused SPMD step: duplicate devices in "
                                 "context list")
            if distributed:
                raise MXNetError(
                    "fused dist step: %d contexts in one worker; a worker "
                    "of a launcher's job holds one device" % len(contexts))
        device = contexts[0].torch_device()
        mp = mp_size()
        self._param_rules = parse_rules(config.get("MXNET_MP_RULES"))
        self.distributed = bool(distributed)
        if self.distributed:
            from .. import dist

            if mp > 1:
                raise FusedStepUnsupported(
                    "fused dist step: MXNET_MP_SIZE=%d is single-process "
                    "only for now (the multi-host (dcn, dp, mp) mesh is "
                    "the scripted on-chip follow-up — see ROADMAP)" % mp)
            dist.init_from_env()
            self.mesh = dist.global_mesh({"dp": 1}, device=device.type)
            self._data_axes = tuple(self.mesh.mesh_dim_names)
        elif local:
            self.mesh = train_mesh(devices=contexts, mp=mp)
            self._data_axes = ("dp",)
        else:
            self.mesh = train_mesh(mp=mp, device=device.type)
            self._data_axes = ("dp",)
        if local:
            n, self._index = len(contexts), 0
        else:
            if mesh_device(self.mesh) != device:
                raise MXNetError(
                    "fused SPMD step: context %s but this rank's mesh device "
                    "is %s" % (contexts[0], mesh_device(self.mesh)))
            _group, n, self._index = data_group(self.mesh, self._data_axes)
        self._n = n
        # a dist worker's batch_size is its own rows: nothing to divide
        if not self.distributed and batch_size is not None \
                and batch_size % n != 0:
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
        ``MXNET_TPU_MAX_INFLIGHT`` steps are queued. A ``worker:R:nan``
        fault for this step multiplies the first data input by NaN: the
        gradients live only inside the step, so its input is where the
        fault goes in."""
        poison = chaos.nan_fault()
        arrays = list(zip(self._data_names, data_batch.data))
        labels = getattr(data_batch, "label", None) or []
        arrays += list(zip(self._label_names, labels))
        values, host_rows = [], []
        for name, arr in arrays:
            value = arr.tensor if isinstance(arr, nd.NDArray) else arr
            if poison and name == self._data_names[0]:
                placed = getattr(value, "_mx_sharding", None)
                value = value * np.float32("nan")
                if placed is not None:
                    value._mx_sharding = placed
            if not is_preplaced(value, self._batch_sharding):
                host_rows.append(int(value.shape[0]))
            values.append((name, value))
        if host_rows and self.distributed and self._n > 1:
            self._check_local_batch_agreement(host_rows)
        batch = {name: place_batch_array(
            self.mesh, self._data_axes, self.distributed, name, value,
            sharding=self._batch_sharding) for name, value in values}
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

    def _check_local_batch_agreement(self, n_rows_list):
        """Raise when the workers' local batches differ (their steps would
        not match): one gather of every worker's row counts."""
        from .. import dist

        arr = np.asarray(n_rows_list, np.int64)
        rows = dist.allgather(arr)
        if not (rows == arr[None, :]).all():
            raise MXNetError(
                "fused dist step: local batch sizes %s differ across "
                "workers (per-rank sizes %s); pad or drop the tail "
                "batch so every rank agrees"
                % (list(n_rows_list), rows.tolist()))

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
        """The last step's outputs (a host sync, counted): the global
        batch's, or under ``distributed`` this worker's rows."""
        if self._outputs is None:
            if self._raw_outputs is None:
                raise MXNetError("fused SPMD step: no batch has run yet")
            profiler.h2d_record(host_syncs=1)
            ctx = self._ts.device
            from ..context import Context
            from ..parallel.feed import rank_rows

            outs = self._raw_outputs
            if self.distributed:
                outs = [rank_rows(o, self._n, self._index, name,
                                  "fused dist step")
                        for name, o in zip(self._output_names, outs)]
            self._outputs = [nd.NDArray(o, Context.from_device(ctx))
                             for o in outs]
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
        old = self._carry
        old_p, old_o, old_a, _old_s = old
        carry = self._ts.place(params if params is not None else old_p,
                               opt_state if opt_state is not None else old_o,
                               aux if aux is not None else old_a)
        self._carry = with_step(carry, old if step is None else int(step))

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
        old = self._carry
        params, opt_state, aux, _step = old
        logical = self._ts.logical_opt_state(opt_state, params)
        self._fopt = functional_from_optimizer(optimizer,
                                               list(self.param_names))
        self._ts = self._train_step(self._ts.symbol)
        self._carry = with_step(self._ts.place(params, logical, aux), old)
