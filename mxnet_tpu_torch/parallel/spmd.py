"""Functional optimizers and the one-device symbolic train step
(counterpart of ``mxnet_tpu/parallel/spmd.py``'s ``FunctionalOptimizer``,
``functional_optimizer``, ``cross_entropy_loss`` and ``TrainStep``).

The optimizers have the same names, arguments and update arithmetic as the
JAX package, on dicts of tensors: ``init(params) -> state`` and
``apply(params, grads, state, step) -> (params, state)``. Unlike the JAX
functions, which return new arrays (the JAX train step donates its carry),
``apply`` updates the params and the state in place under
``torch.no_grad()`` and returns the same dicts, so a train step holds one
copy of each. ``step`` is the number of updates made before this one: an
int, or a 0-d tensor on the device (``TrainStep(sentinel="skip")``, whose
counter advances only on healthy steps); an optimizer that needs its value
(a learning-rate schedule, Adam's bias correction) then reads it on the
host, one sync counted in ``profiler.pipeline_stats()["host_syncs"]``.

Not ported yet: ``functional_from_optimizer``, and of ``TrainStep`` the
mesh (data and tensor parallelism) and ZeRO, which raise by name
(ROADMAP.md Queue A item 6).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from ..base import MXNetError
from ..ops.optimizer_ops import adam_update, sgd_mom_update, sgd_update

__all__ = ["FunctionalOptimizer", "functional_optimizer",
           "cross_entropy_loss", "TrainStep"]


def _host_step(step):
    """An optimizer's step count as an int; a device tensor is read on the
    host (one sync, counted)."""
    if isinstance(step, torch.Tensor):
        from .. import profiler

        profiler.h2d_record(host_syncs=1)
        return int(step)
    return step


class FunctionalOptimizer:
    """init(params)->state dict; apply(params, grads, state, step)->new."""

    def __init__(self, init, apply, hyper=None):
        self.init = init
        self.apply = apply
        self.hyper = dict(hyper or {})


def functional_optimizer(name="sgd", learning_rate=0.01, momentum=0.0, wd=0.0,
                         beta1=0.9, beta2=0.999, epsilon=1e-8,
                         rescale_grad=1.0, clip_gradient=None,
                         lr_scheduler=None, wd_pattern=r".*(weight|gamma)$",
                         lr_mult=None, wd_mult=None):
    """Build an optimizer (``sgd``, with or without momentum, or ``adam``).
    ``wd_pattern``: params whose name matches get weight decay, others
    (bias/beta/moving stats) get 0 — set_wd_mult parity
    (python/mxnet/optimizer.py set_wd_mult). Explicit per-name ``lr_mult``
    / ``wd_mult`` dicts (default multiplier 1.0) override the pattern,
    mirroring Optimizer.set_lr_mult/set_wd_mult exactly. Gradients are
    taken in fp32, times ``rescale_grad``, clipped to ``clip_gradient``
    when it is > 0; ``lr_scheduler(step)`` replaces ``learning_rate``. Each
    tensor's update is the ``sgd_update``/``sgd_mom_update``/``adam_update``
    op that ``optimizer.SGD``/``Adam`` invoke."""
    name = name.lower()
    wd_re = re.compile(wd_pattern)

    def lr_at(step):
        if lr_scheduler is not None:
            return lr_scheduler(_host_step(step))
        return learning_rate

    def mults(k):
        lm = 1.0 if lr_mult is None else float(lr_mult.get(k, 1.0))
        if wd_mult is not None:
            wm = wd * float(wd_mult.get(k, 1.0))
        else:
            wm = wd if wd_re.match(k) else 0.0
        return lm, wm

    # the update ops clip when clip_gradient >= 0; this optimizer, like the
    # JAX package's, only when it is > 0
    clip = (clip_gradient if clip_gradient is not None and clip_gradient > 0
            else -1.0)

    if name == "sgd":
        def init(params):
            if momentum == 0.0:
                return {}
            return {k: torch.zeros_like(v) for k, v in params.items()}

        def apply(params, grads, state, step):
            lr = lr_at(step)
            for k, w in params.items():
                lm, this_wd = mults(k)
                if momentum == 0.0:
                    sgd_update(w, grads[k].float(), lr=lr * lm, wd=this_wd,
                               rescale_grad=rescale_grad, clip_gradient=clip)
                else:
                    sgd_mom_update(w, grads[k].float(), state[k], lr=lr * lm,
                                   momentum=momentum, wd=this_wd,
                                   rescale_grad=rescale_grad,
                                   clip_gradient=clip)
            return params, state

        return FunctionalOptimizer(init, apply, dict(lr=learning_rate,
                                                     momentum=momentum, wd=wd))

    if name == "adam":
        def init(params):
            return {k: (torch.zeros_like(v), torch.zeros_like(v))
                    for k, v in params.items()}

        def apply(params, grads, state, step):
            lr = lr_at(step)
            t = float(_host_step(step)) + 1.0
            lr_t = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
            for k, w in params.items():
                lm, this_wd = mults(k)
                m, v = state[k]
                adam_update(w, grads[k].float(), m, v, lr=lr_t * lm,
                            beta1=beta1, beta2=beta2, epsilon=epsilon,
                            wd=this_wd, rescale_grad=rescale_grad,
                            clip_gradient=clip)
            return params, state

        return FunctionalOptimizer(init, apply, dict(lr=learning_rate, wd=wd))

    raise MXNetError("functional_optimizer: unknown optimizer %r" % name)


def cross_entropy_loss(probs, label, eps=1e-12):
    """Mean cross-entropy given probabilities (SoftmaxOutput's forward)."""
    lbl = label.long().reshape(-1)
    picked = probs.reshape(lbl.shape[0], -1).gather(1, lbl[:, None])
    return -torch.mean(torch.log(picked + eps))


def _unported(what):
    return MXNetError("TrainStep: %s is not ported (one device, mesh=None)"
                      % what)


_SENTINEL_MODES = ("off", "record", "skip", "halt")


class TrainStep:
    """Training step of a Symbol graph on one device.

    ``step(carry, batch) -> (carry, loss)`` with carry = (params,
    opt_state, aux, step_no): params the fp32 master weights, aux the
    moving statistics, both dicts of tensors on the step's device, updated
    in place (the JAX step donates its carry and returns new arrays).

    One step, as the JAX step takes it: the params are cast to
    ``compute_dtype`` and the gradients are taken with respect to the cast
    copies (so they come in that dtype), the data is cast likewise, and the
    reported loss is ``loss_fn(outputs[0] in f32, label)``. The gradients
    flow through the graph as MXNet's backward with ones head gradients: a
    fused loss head (SoftmaxOutput) substitutes its own gradient, so there
    ``loss_fn`` changes only the reported loss. ``normalize_grads`` divides
    them by the batch size in their own dtype (Module's rescale_grad =
    1/batch); the optimizer updates the params in place; each auxiliary
    state takes its update in its own dtype.

    Options (each an argument, or its ``MXNET_*`` knob when None):

    - ``train_passes`` (``MXNET_IR_TRAIN_PASSES``): IR passes applied to
      the symbol before anything else reads it (``fusion``, ``residual``,
      ``layout``).
    - ``remat`` (``MXNET_TPU_REMAT``): False; True recomputes the whole
      forward in the backward (one non-reentrant checkpoint around the loss
      closure); ``"pass"`` keeps exactly the outputs of
      ``ir.remat.plan_remat``'s save list (convolutions, matmuls, the fused
      units) and recomputes the rest; ``"conv"`` keeps the same nodes
      (the port saves whole nodes, not primitives). Every mode computes
      the same values as False: what changes is what the backward keeps
      (:meth:`residual_stats`) and what it recomputes.
    - ``return_outputs``: the step returns ``(carry, (loss, outputs))``;
      with ``metric_stats`` also a dict of batch statistics on the device,
      ``(carry, (loss, outputs, stats))``: ``n``, ``sum_loss`` and, for a
      2-D first output with a 1-D label, ``correct`` and ``sum_ce``
      (-log p[label] summed, eps 1e-12).
    - ``sentinel`` (``MXNET_TPU_SENTINEL``): ``record`` computes a health
      word each step on the device (finite loss, finite global gradient
      norm, finite updated params) and counts it into tensors under
      ``opt_state["__sentinel_state__"]``, with no host sync; ``skip``
      also makes an unhealthy step a no-op: params, optimizer state and aux
      come back bit for bit from a snapshot taken before the update (one
      copy of each, the memory cost) and the step counter, then a 0-d
      device tensor, does not advance; ``halt`` reads the word after every
      step (one host sync, counted) and raises on the first unhealthy
      step. :meth:`health_stats` drains the counters.

    Entry points run on ``cuda`` unless given ``device="cpu"``. ``mesh``,
    ``zero`` and a ``zero_wire`` other than raw raise :class:`MXNetError`
    naming the option, given as an argument or through its knob.
    """

    _SENT = "__sentinel_state__"

    def __init__(self, symbol, optimizer, mesh=None, *,
                 label_names=("softmax_label",), data_names=("data",),
                 compute_dtype=None, loss_fn=None, zero=None, remat=None,
                 normalize_grads=True, return_outputs=False,
                 metric_stats=False, zero_wire=None, sentinel=None,
                 train_passes=None, device=None):
        from .. import config
        from ..base import dtype_torch
        from ..context import resolve_device
        from ..executor import _graph_closure

        if mesh is not None:
            raise _unported("mesh=%r" % (mesh,))
        if zero is None:
            zero = config.get_strict_bool("MXNET_TPU_ZERO")
        if zero:
            raise _unported("zero=True (weight-update sharding)")
        if zero_wire is None:
            zero_wire = config.get_choice("MXNET_TPU_ZERO_WIRE",
                                          ("raw", "2bit"))
        if zero_wire != "raw":
            raise _unported("zero_wire=%r" % (zero_wire,))
        if train_passes is None:
            train_passes = config.get("MXNET_IR_TRAIN_PASSES")
        if isinstance(train_passes, str):
            train_passes = train_passes.split(",")
        self.train_passes = tuple(str(p).strip() for p in train_passes
                                  if str(p).strip())
        if self.train_passes:
            from ..ir import apply_passes

            symbol = apply_passes(symbol, self.train_passes)
        if sentinel is None:
            sentinel = config.get_choice("MXNET_TPU_SENTINEL",
                                         _SENTINEL_MODES)
        elif sentinel not in _SENTINEL_MODES:
            raise MXNetError("TrainStep: sentinel=%r must be "
                             "off|record|skip|halt" % (sentinel,))
        self.sentinel = sentinel
        if remat is None:
            raw = config.get_choice("MXNET_TPU_REMAT",
                                    ("0", "1", "off", "conv", "pass"))
            remat = {"0": False, "off": False, "1": True}.get(raw, raw)
        elif remat not in (False, True, "conv", "pass"):
            raise MXNetError(
                "TrainStep: remat=%r must be False|True|'conv'|'pass'"
                % (remat,))
        self.remat = remat if isinstance(remat, str) else bool(remat)
        if metric_stats and not return_outputs:
            raise MXNetError(
                "TrainStep: metric_stats=True requires return_outputs=True")
        self.return_outputs = bool(return_outputs)
        self.metric_stats = bool(metric_stats)
        self.device = resolve_device(device)
        self.symbol = symbol
        self.optimizer = (
            optimizer if isinstance(optimizer, FunctionalOptimizer)
            else functional_optimizer(**optimizer)
            if isinstance(optimizer, dict)
            else functional_optimizer(optimizer))
        self.label_names = tuple(label_names)
        self.data_names = tuple(data_names)
        self.compute_dtype = None if compute_dtype is None \
            else dtype_torch(compute_dtype)
        self.loss_fn = loss_fn or cross_entropy_loss
        self.normalize_grads = normalize_grads
        inputs = set(self.data_names + self.label_names)
        self.param_names = [n for n in symbol.list_arguments()
                            if n not in inputs]
        self.aux_names = symbol.list_auxiliary_states()
        self._remat_plan = None
        remat_names = None
        if self.remat in ("conv", "pass"):
            from ..ir.remat import plan_remat

            # The JAX package's "conv" keeps the outputs of convolution,
            # matmul and fused-unit primitives, "pass" those of the nodes
            # the plan saves. The port saves whole nodes; the nodes whose
            # ops hold those primitives are the plan's, so both keep them.
            plan = plan_remat(symbol, record=self.remat == "pass")
            remat_names = plan.save
            if self.remat == "pass":
                self._remat_plan = plan
        self._graph = _graph_closure(symbol, is_train=True,
                                     remat_names=remat_names)

    def init_params(self, data_shapes, initializer=None, dtype=np.float32,
                    seed=0):
        """Params and aux from the shapes the data shapes give: every
        argument drawn by ``initializer`` (default ``Uniform(0.01)``) in
        ``list_arguments()`` order from ``RandomState(seed & 0x7FFFFFFF)``,
        as the JAX package draws them; aux states ones for names holding
        ``var`` or ``gamma``, zeros otherwise. Returns ``(params,
        opt_state, aux)`` on the step's device."""
        from ..base import dtype_torch
        from ..initializer import InitDesc, Uniform, seeded

        arg_shapes, _, aux_shapes = self.symbol.infer_shape(
            **dict(data_shapes))
        init = initializer or Uniform(0.01)
        dt = dtype_torch(dtype)
        inputs = set(self.data_names + self.label_names)
        params, aux = {}, {}
        with seeded(seed):
            for name, shape in zip(self.symbol.list_arguments(), arg_shapes):
                if name in inputs:
                    continue
                arr = torch.zeros(shape, dtype=dt)
                init(InitDesc(name), arr)
                params[name] = arr.to(self.device)
        for name, shape in zip(self.aux_names, aux_shapes):
            fill = torch.ones if "var" in name or "gamma" in name \
                else torch.zeros
            aux[name] = fill(shape, dtype=dt, device=self.device)
        return params, self.optimizer.init(params), aux

    def _on_device(self, v):
        if isinstance(v, (tuple, list)):
            return type(v)(self._on_device(x) for x in v)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.to(self.device)

    def place(self, params, opt_state, aux):
        """The carry ``(params, opt_state, aux, 0)`` on the step's device
        (tensors already there are kept, not copied), with the sentinel's
        counters when it is armed; under ``skip`` the step counter is a 0-d
        device tensor."""
        params, opt_state, aux = (
            {k: self._on_device(v) for k, v in d.items()}
            for d in (params, opt_state, aux))
        step_no = 0
        if self.sentinel == "skip":
            step_no = torch.zeros((), dtype=torch.int32, device=self.device)
        return params, self._ensure_sentinel(opt_state), aux, step_no

    # -- the sentinel's counters ---------------------------------------------
    def _sentinel_init(self):
        def z(v=0, dtype=torch.int32):
            return torch.full((), v, dtype=dtype, device=self.device)

        return {"healthy": z(), "unhealthy": z(), "skipped": z(),
                "consec": z(), "nonfinite_loss": z(), "nonfinite_grad": z(),
                "nonfinite_param": z(), "last_healthy": z(1),
                "last_loss": z(0.0, torch.float32)}

    def _ensure_sentinel(self, opt_state):
        """The sentinel's key made to agree with the mode: created when
        armed and missing (live counters are kept), dropped when off."""
        if self.sentinel == "off":
            return {k: v for k, v in opt_state.items() if k != self._SENT}
        if self._SENT in opt_state:
            return opt_state
        out = dict(opt_state)
        out[self._SENT] = self._sentinel_init()
        return out

    def logical_opt_state(self, opt_state, params=None, param_rules=None):
        """The optimizer state a checkpoint stores: the sentinel's
        counters are transient and dropped (fresh zeros on restore)."""
        return {k: v for k, v in opt_state.items() if k != self._SENT}

    def health_stats(self, carry):
        """The sentinel's counters of a carry, read on the host in one
        copy; None when the sentinel is off."""
        sent = carry[1].get(self._SENT)
        if sent is None:
            return None
        vals = torch.stack([v.double() for v in sent.values()]).cpu()
        return {k: (float(v) if k == "last_loss" else int(v))
                for k, v in zip(sent, vals.tolist())}

    def _halt_check(self, carry):
        """``halt``: read the health word after the step (one host sync,
        counted) and raise on an unhealthy step."""
        from .. import profiler

        profiler.h2d_record(host_syncs=1)
        snap = self.health_stats(carry)
        if snap and not snap["last_healthy"]:
            profiler.health_sentinel(snap)
            raise MXNetError(
                "sentinel halt: unhealthy training step detected "
                "(nonfinite_loss=%d nonfinite_grad=%d nonfinite_param=%d "
                "unhealthy=%d of %d steps, last_loss=%r)"
                % (snap["nonfinite_loss"], snap["nonfinite_grad"],
                   snap["nonfinite_param"], snap["unhealthy"],
                   snap["healthy"] + snap["unhealthy"], snap["last_loss"]))

    # -- the loss closure ----------------------------------------------------
    def _inputs(self, batch):
        return {n: self._on_device(batch[n])
                for n in self.data_names + self.label_names}

    def _leaves(self, params):
        cdtype = self.compute_dtype
        return {k: (v.detach() if cdtype is None else v.detach().to(cdtype))
                .requires_grad_() for k, v in params.items()}

    def _loss_closure(self):
        """``loss_of(leaves, aux, inputs) -> (loss, outputs, aux_updates)``
        with the remat mode applied, shared by the step and
        :meth:`residual_stats`."""
        graph, loss_fn = self._graph, self.loss_fn
        data_names, label_names = self.data_names, self.label_names
        cdtype = self.compute_dtype

        def loss_of(leaves, aux, inputs):
            values = dict(leaves)
            values.update(aux)
            values.update(inputs)
            if cdtype is not None:
                for n in data_names:
                    values[n] = values[n].to(cdtype)
            outs, aux_updates = graph(values)
            label = inputs[label_names[0]] if label_names else None
            return loss_fn(outs[0].float(), label), outs, aux_updates

        if self.remat is not True:
            return loss_of

        def checkpointed(leaves, aux, inputs):
            from torch.utils.checkpoint import checkpoint

            # the tensors go in as arguments, so the checkpoint keeps them
            # (and residual_stats sees them) as the backward's inputs
            keys = [list(d) for d in (leaves, aux, inputs)]
            n1, n2 = len(keys[0]), len(keys[0]) + len(keys[1])

            def run(*ts):
                return loss_of(dict(zip(keys[0], ts[:n1])),
                               dict(zip(keys[1], ts[n1:n2])),
                               dict(zip(keys[2], ts[n2:])))

            return checkpoint(run, *leaves.values(), *aux.values(),
                              *inputs.values(), use_reentrant=False)

        return checkpointed

    def residual_stats(self, params, aux, batch):
        """What the backward of one step keeps under the remat mode:
        ``residual_bytes``, the bytes of the storages autograd holds for
        the backward (each storage once, params included), and
        ``n_residuals``, their count. Runs the forward only."""
        from ..executor import residual_probe

        with residual_probe() as probe:
            self._loss_closure()(self._leaves(params), aux,
                                 self._inputs(batch))
        return probe.stats()

    def value_and_grad(self, params, aux, batch):
        """``(loss, grads, aux_updates)`` of one step without the update:
        the gradients (summed over the batch, in ``compute_dtype``) with
        respect to the params cast to ``compute_dtype``."""
        loss, grads, aux_updates, _outs = self._value_and_grad(
            params, aux, self._inputs(batch))
        return loss, grads, aux_updates

    def _value_and_grad(self, params, aux, inputs):
        leaves = self._leaves(params)
        loss, outs, aux_updates = self._loss_closure()(leaves, aux, inputs)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        return loss.detach(), grads, aux_updates, outs

    def _metric_stats(self, loss, outs, inputs):
        """Batch statistics on the device: rows, loss times rows and, for a
        2-D first output with a 1-D label, argmax hits and summed
        cross-entropy."""
        out0 = outs[0].detach()
        n_rows = out0.shape[0]
        stats = {"n": torch.full((), n_rows, dtype=torch.int32,
                                 device=out0.device),
                 "sum_loss": loss.float() * n_rows}
        if self.label_names:
            label = inputs[self.label_names[0]]
            if out0.dim() == 2 and label.dim() == 1 \
                    and label.shape[0] == n_rows:
                lbl = label.to(torch.int32)
                probs = out0.float()
                pred = torch.argmax(probs, dim=-1).to(torch.int32)
                stats["correct"] = (pred == lbl).sum().to(torch.int32)
                picked = probs.gather(1, lbl.long()[:, None])[:, 0]
                stats["sum_ce"] = -torch.sum(torch.log(picked + 1e-12))
        return stats

    def _health_terms(self, loss, grads):
        """The health word's terms known before the update: finite loss,
        finite sum of squared gradients (f32)."""
        gsq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g in grads.values():
            gsq = gsq + torch.sum(torch.square(g.float()))
        return torch.isfinite(loss.float()), torch.isfinite(gsq)

    def _count_health(self, opt_state, loss, healthy, f_loss, f_grad, p_ok,
                      skipped):
        sent = opt_state[self._SENT]
        i32 = torch.int32
        h = healthy.to(i32)
        unh = 1 - h
        opt_state[self._SENT] = {
            "healthy": sent["healthy"] + h,
            "unhealthy": sent["unhealthy"] + unh,
            "skipped": sent["skipped"] + (unh if skipped else 0),
            # consecutive unhealthy steps: reset by a healthy one
            "consec": (sent["consec"] + unh) * unh,
            "nonfinite_loss": sent["nonfinite_loss"] + (1 - f_loss.to(i32)),
            "nonfinite_grad": sent["nonfinite_grad"] + (1 - f_grad.to(i32)),
            "nonfinite_param": sent["nonfinite_param"] + (1 - p_ok.to(i32)),
            "last_healthy": h,
            "last_loss": loss.float(),
        }

    def __call__(self, carry, batch):
        params, opt_state, aux, step_no = carry
        inputs = self._inputs(batch)
        armed = self.sentinel != "off"
        if armed:
            opt_state = self._ensure_sentinel(opt_state)
        core_opt = {k: v for k, v in opt_state.items() if k != self._SENT}
        loss, grads, aux_updates, outs = self._value_and_grad(params, aux,
                                                              inputs)
        if self.normalize_grads:
            bsz = int(inputs[self.data_names[0]].shape[0])
            grads = {k: g / bsz for k, g in grads.items()}
        before = None
        if self.sentinel == "skip":
            # the way back for an unhealthy step: the update is in place
            with torch.no_grad():
                before = [(v, v.clone()) for d in (params, core_opt, aux)
                          for v in _tensors(d)]
            if not isinstance(step_no, torch.Tensor):
                step_no = torch.full((), int(step_no), dtype=torch.int32,
                                     device=self.device)
        if armed:
            f_loss, f_grad = self._health_terms(loss, grads)
        self.optimizer.apply(params, grads, core_opt, step_no)
        with torch.no_grad():
            for k, v in aux_updates.items():
                if k in aux:
                    aux[k].copy_(v)
        next_step = step_no + 1
        if armed:
            with torch.no_grad():
                finite = [torch.isfinite(v).all() for v in params.values()
                          if v.is_floating_point()]
                p_ok = torch.stack(finite).all() if finite \
                    else f_loss.new_ones(())
                healthy = f_loss & f_grad & p_ok
                if before is not None:
                    for new, old in before:
                        new.copy_(torch.where(healthy, new, old))
                    next_step = step_no + healthy.to(torch.int32)
                self._count_health(opt_state, loss, healthy, f_loss, f_grad,
                                   p_ok, before is not None)
        new_carry = (params, opt_state, aux, next_step)
        if self.sentinel == "halt":
            self._halt_check(new_carry)
        if not self.return_outputs:
            return new_carry, loss
        outs = tuple(o.detach() for o in outs)
        if self.metric_stats:
            with torch.no_grad():
                stats = self._metric_stats(loss, outs, inputs)
            return new_carry, (loss, outs, stats)
        return new_carry, (loss, outs)


def _tensors(d):
    """The tensors of a dict of tensors or of tuples of them (Adam's
    state)."""
    for v in d.values():
        if isinstance(v, (tuple, list)):
            yield from v
        else:
            yield v
