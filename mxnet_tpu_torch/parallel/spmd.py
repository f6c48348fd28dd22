"""Functional optimizers and the one-device symbolic train step
(counterpart of ``mxnet_tpu/parallel/spmd.py``'s ``FunctionalOptimizer``,
``functional_optimizer``, ``cross_entropy_loss`` and ``TrainStep``).

The optimizers have the same names, arguments and update arithmetic as the
JAX package, on dicts of tensors: ``init(params) -> state`` and
``apply(params, grads, state, step) -> (params, state)``. Unlike the JAX
functions, which return new arrays (the JAX train step donates its carry),
``apply`` updates the params and the state in place under
``torch.no_grad()`` and returns the same dicts, so a train step holds one
copy of each. ``step`` is the number of updates made before this one (an
int).

Not ported yet: ``functional_from_optimizer``, and of ``TrainStep`` the
mesh (data and tensor parallelism), ZeRO, the sentinel, remat, the
training-graph passes, ``return_outputs`` and ``metric_stats``, which
raise by name (ROADMAP.md Queue A item 6).
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
            return lr_scheduler(step)
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
            t = float(step) + 1.0
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

    Entry points run on ``cuda`` unless given ``device="cpu"``. ``mesh``,
    ``zero``, a ``zero_wire`` other than raw, a ``sentinel`` other than
    off, ``remat``, ``train_passes``, ``return_outputs`` and
    ``metric_stats`` raise :class:`MXNetError` naming the option, given
    as an argument or through its ``MXNET_*`` knob.
    """

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
        if sentinel is None:
            sentinel = config.get_choice("MXNET_TPU_SENTINEL",
                                         ("off", "record", "skip", "halt"))
        if sentinel != "off":
            raise _unported("sentinel=%r" % (sentinel,))
        if remat is None:
            raw = config.get_choice("MXNET_TPU_REMAT",
                                    ("0", "1", "off", "conv", "pass"))
            remat = {"0": False, "off": False, "1": True}.get(raw, raw)
        if remat is not False:
            raise _unported("remat=%r" % (remat,))
        if train_passes is None:
            train_passes = config.get("MXNET_IR_TRAIN_PASSES")
        if isinstance(train_passes, str):
            train_passes = train_passes.split(",")
        train_passes = tuple(str(p).strip() for p in train_passes
                             if str(p).strip())
        if train_passes:
            raise _unported("train_passes=%r" % (train_passes,))
        if return_outputs:
            raise _unported("return_outputs=True")
        if metric_stats:
            raise _unported("metric_stats=True")
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
        self._graph = _graph_closure(symbol, is_train=True)

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
        (tensors already there are kept, not copied)."""
        return tuple({k: self._on_device(v) for k, v in d.items()}
                     for d in (params, opt_state, aux)) + (0,)

    def value_and_grad(self, params, aux, batch):
        """``(loss, grads, aux_updates)`` of one step without the update:
        the gradients (summed over the batch, in ``compute_dtype``) with
        respect to the params cast to ``compute_dtype``."""
        cdtype = self.compute_dtype
        leaves = {k: (v.detach() if cdtype is None else v.detach().to(cdtype))
                  .requires_grad_() for k, v in params.items()}
        values = dict(leaves)
        values.update(aux)
        for n in self.data_names + self.label_names:
            values[n] = self._on_device(batch[n])
        if cdtype is not None:
            for n in self.data_names:
                values[n] = values[n].to(cdtype)
        outs, aux_updates = self._graph(values)
        label = values[self.label_names[0]] if self.label_names else None
        loss = self.loss_fn(outs[0].float(), label)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        return loss.detach(), grads, aux_updates

    def __call__(self, carry, batch):
        params, opt_state, aux, step_no = carry
        loss, grads, aux_updates = self.value_and_grad(params, aux, batch)
        if self.normalize_grads:
            bsz = int(np.shape(batch[self.data_names[0]])[0])
            grads = {k: g / bsz for k, g in grads.items()}
        self.optimizer.apply(params, grads, opt_state, step_no)
        with torch.no_grad():
            for k, v in aux_updates.items():
                if k in aux:
                    aux[k].copy_(v)
        return (params, opt_state, aux, step_no + 1), loss
