"""Functional optimizers and the symbolic train step (counterpart of
``mxnet_tpu/parallel/spmd.py``): ``FunctionalOptimizer``,
``functional_optimizer``, ``functional_from_optimizer``,
``cross_entropy_loss``, ``TrainStep`` on one device or data parallel over a
mesh (with ZeRO), and the sharding helpers ``replicated``,
``data_sharding``, ``param_shardings``, ``parse_rules`` and
``ShardingRuleError``.

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

Data parallelism is one process a device (``parallel/mesh.py``). Tensor
parallelism of a symbol: ``param_rules`` shard parameters over the mesh's
``mp`` (or ``tp``) axis; each rank holds its block of each sharded
parameter, of its optimizer state and of its gradient, and the graph runs
under a ``symbol_mp.ShardPlan`` (the Megatron pair for a column- then
row-parallel ``FullyConnected``, every other use gathered). ZeRO's
two-bit wire (``zero_wire="2bit"``) sends each rank's summed gradient row
through the packed 2-bit codes with an error-feedback residual a row.
"""
from __future__ import annotations

import contextlib
import math
import re
from collections import namedtuple

import numpy as np
import torch

from ..base import MXNetError
from ..ops.optimizer_ops import adam_update, sgd_mom_update, sgd_update

__all__ = ["FunctionalOptimizer", "functional_optimizer",
           "functional_from_optimizer", "cross_entropy_loss", "TrainStep",
           "Sharding", "replicated", "data_sharding", "param_shardings",
           "parse_rules", "ShardingRuleError"]


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
class Sharding(namedtuple("Sharding", "mesh spec")):
    """The port's ``NamedSharding``: a mesh and a spec, one entry a
    dimension (None, an axis name or a tuple of them; ``()`` replicates):
    a batch sharded on its rows over the data axes, a parameter on one dim
    over the mp axis (:func:`param_shardings`)."""


def replicated(mesh):
    return Sharding(mesh, ())


def data_sharding(mesh, axes=("dp",), ndim=None):
    """The batch's rows sharded over the mesh's axes among ``axes``."""
    names = tuple(a for a in axes if a in mesh.mesh_dim_names)
    return Sharding(mesh, (names,) if names else ())


class ShardingRuleError(MXNetError):
    """A parameter-sharding rule matched but cannot apply: its spec names a
    mesh axis the mesh does not have, or a sharded dim is not divisible by
    the axis size. Raised instead of silently replicating."""


def param_shardings(params, mesh, rules=None):
    """Param name -> :class:`Sharding` by ordered ``(regex, spec)`` rules,
    the first match winning, replicated by default; ``params`` maps names
    to arrays or shapes (whole ones), or to None before the shapes are
    known (the specs alone, unchecked). A matched rule that cannot apply
    (an axis the mesh lacks, a dim the axis size does not divide) raises
    :class:`ShardingRuleError` naming the parameter and the rule."""
    out = {}
    for name, v in params.items():
        spec, rule_pat = (), None
        for pat, sp in rules or []:
            if re.match(pat, name):
                spec, rule_pat = tuple(sp), pat
                break
        sharded = any(ax is not None for ax in spec)
        if sharded and v is not None:
            shape = tuple(getattr(v, "shape", v))
            problem = _spec_misfit(spec, shape, mesh)
            if problem is not None:
                raise ShardingRuleError(
                    "param_shardings: rule (%r, %s) matched parameter %r "
                    "with shape %s but cannot apply: %s"
                    % (rule_pat, spec, name, shape, problem))
        out[name] = Sharding(mesh, spec) if sharded else replicated(mesh)
    return out


def _spec_misfit(spec, shape, mesh):
    """None when every axis of ``spec`` is on the mesh and divides its dim,
    else the reason."""
    from .mesh import mesh_shape

    sizes = mesh_shape(mesh)
    if len(spec) > len(shape):
        return "spec has %d entries for a %d-dim shape" % (len(spec),
                                                            len(shape))
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        n = 1
        for a in ((ax,) if isinstance(ax, str) else tuple(ax)):
            if a not in sizes:
                return ("mesh has no axis %r (mesh axes: %s)"
                        % (a, ", ".join(sizes) or "<none>"))
            n *= sizes[a]
        if dim % n != 0:
            return "dim %d is not divisible by the axis size %d" % (dim, n)
    return None


def parse_rules(text, knob="MXNET_MP_RULES"):
    """``'regex:spec;regex:spec'`` -> ``[(regex, spec tuple)]``, spec a
    comma list with one entry a dim, ``*`` replicating it. Malformed
    grammar raises :class:`MXNetError` naming the knob."""
    rules = []
    for part in (text or "").strip().split(";"):
        part = part.strip()
        if not part:
            continue
        pat, sep, spec_s = part.rpartition(":")
        pat = pat.strip()
        if not sep or not pat:
            raise MXNetError(
                "%s: rule %r must be 'regex:spec' with spec a comma list of "
                "'*' or mesh-axis names" % (knob, part))
        try:
            re.compile(pat)
        except re.error as e:
            raise MXNetError("%s: bad regex %r in rule %r: %s"
                             % (knob, pat, part, e))
        entries = []
        for ent in spec_s.split(","):
            ent = ent.strip()
            if not ent:
                raise MXNetError("%s: empty spec entry in rule %r (use '*' "
                                 "to replicate a dim)" % (knob, part))
            entries.append(None if ent == "*" else ent)
        rules.append((pat, tuple(entries)))
    return rules


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


class FusedStepUnsupported(MXNetError):
    """A feature of the imperative optimizer or of ``Module`` that the
    fused data-parallel step cannot mirror. ``Module(kvstore='tpu')``
    catches this error alone and trains on the per-executor path; every
    other error (a mesh, device or backend failure) raises."""


def functional_from_optimizer(opt, param_names):
    """The :class:`FunctionalOptimizer` of an imperative ``optimizer.SGD``
    or ``Adam`` (``Module(kvstore='tpu')``'s fused step). An
    ``lr_scheduler``, a ``param_dict`` or another optimizer raises
    :class:`FusedStepUnsupported`, and the caller keeps the per-executor
    update."""
    from .. import optimizer as opt_mod

    if opt.lr_scheduler is not None:
        raise FusedStepUnsupported(
            "fused SPMD step: lr_scheduler uses python control flow per "
            "update and cannot be traced; falling back")
    if getattr(opt, "param_dict", None):
        raise FusedStepUnsupported("fused SPMD step: param_dict mults not "
                                   "supported")
    common = dict(
        learning_rate=opt.lr, wd=opt.wd, rescale_grad=opt.rescale_grad,
        clip_gradient=opt.clip_gradient,
        lr_mult={n: opt.lr_mult.get(n, 1.0) for n in param_names},
        wd_mult={n: opt.wd_mult.get(n, 1.0) for n in param_names})
    if type(opt) is opt_mod.SGD:
        return functional_optimizer("sgd", momentum=opt.momentum, **common)
    if type(opt) is opt_mod.Adam:
        return functional_optimizer("adam", beta1=opt.beta1, beta2=opt.beta2,
                                    epsilon=opt.epsilon, **common)
    raise FusedStepUnsupported("fused SPMD step: optimizer %s has no "
                               "functional mirror" % type(opt).__name__)


def cross_entropy_loss(probs, label, eps=1e-12):
    """Mean cross-entropy given probabilities (SoftmaxOutput's forward)."""
    lbl = label.long().reshape(-1)
    picked = probs.reshape(lbl.shape[0], -1).gather(1, lbl[:, None])
    return -torch.mean(torch.log(picked + eps))


def _unported(what):
    return MXNetError("TrainStep: %s is not ported" % what)


def _fused_owned(symbol, param_names):
    """The params that only ``FusedBottleneckUnit`` nodes read: the unit's
    backward already sums their gradients over the data group, so the step
    must not sum them again. A param that a fused unit and another op both
    read raises (its gradient would be half summed)."""
    readers = {}
    for node in symbol._topo():
        for inp, _ in node.inputs or ():
            if inp.is_variable():
                readers.setdefault(inp.name, set()).add(node.op.name)
    owned = set()
    for k in param_names:
        ops = readers.get(k, set())
        if "FusedBottleneckUnit" in ops:
            if len(ops) > 1:
                raise MXNetError(
                    "TrainStep: parameter %r is read by a FusedBottleneckUnit "
                    "and by %s: not ported on a mesh"
                    % (k, sorted(ops - {"FusedBottleneckUnit"})))
            owned.add(k)
    return owned


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

    Data parallelism (``mesh``, a ``parallel.make_mesh`` mesh, with the
    batch sharded over ``data_axes``): one process a device, each given the
    same global batch, of which it keeps its rows (sliced on the host
    before the copy to the card; :func:`data_sharding`'s layout). Under
    ``fused_block.spmd_scope`` the fused units and the batch-reducing ops
    reduce over the data group; the step sums every other gradient over the
    group once (one all-reduce a dtype, in the gradient's dtype: the fused
    units have summed theirs, in f32, already) and divides by the global
    batch. The reported loss (the local ``loss_fn`` scaled by local/global
    rows and summed over the group: it must be a mean over rows), the
    ``metric_stats`` and the sentinel's word are the global batch's, the
    same on every rank, and ``return_outputs`` gives every rank the global
    batch's outputs. :meth:`place` broadcasts rank 0's params and aux, so
    the ranks start, and stay, bit for bit equal.

    ``zero=True`` (``MXNET_TPU_ZERO``) shards the weight update over the
    data axes (ZeRO): a param of at least ``zero_min_size``
    (``MXNET_TPU_ZERO_MIN_SIZE``) elements is flattened and zero-padded to
    ``(N, chunk)``; its gradient is reduce-scattered (a fused unit's,
    already summed, is sliced), the rank updates its ``(1, chunk)`` row,
    whose optimizer state lives only there, and the params are
    all-gathered. :meth:`logical_opt_state` gives the state back in the
    mesh-size independent layout checkpoints keep. With ``zero_wire="2bit"``
    (``MXNET_TPU_ZERO_WIRE``) each planned gradient row, once summed and
    scaled, round-trips through the packed 2-bit codes
    (``kvstore.two_bit_round_trip_core``, threshold
    ``MXNET_TPU_ZERO_WIRE_THRESHOLD``) with an error-feedback residual kept
    under ``__zero_wire_residual__``, a ``(1, chunk)`` f32 row a rank like
    the plan's; it is dropped when the wire is raw, from checkpoints, and
    starts at zeros on restore.

    Tensor parallelism (a mesh with an ``mp`` or ``tp`` axis and
    ``param_rules`` that shard over it): :meth:`place` takes whole params,
    broadcasts rank 0's and keeps this rank's block of each sharded one and
    of its optimizer state (gradients come in that layout too), so a
    rank's parameter bytes at rest are about 1/mp of the sharded ones. The
    graph runs under ``symbol_mp.ShardPlan`` (the Megatron pair, every
    other use gathered); replicated params stay bit for bit equal on the
    ranks. :meth:`whole_params` and :meth:`logical_opt_state` gather the
    blocks back (collectives over the mp group). ZeRO composes: its rows
    cover the replicated params over the data axes, the sharded ones keep
    their blocks. :meth:`record_memory_stats` also publishes the
    profiler's ``mp_stats`` gauge on such a mesh.

    Entry points run on ``cuda`` unless given ``device="cpu"`` (or a mesh on
    the CPU). A remat mode with sharded params raises :class:`MXNetError`
    naming the option.
    """

    _SENT = "__sentinel_state__"
    _ZERO_RES = "__zero_wire_residual__"

    def __new__(cls, symbol=None, optimizer=None, mesh=None, *args, **kw):
        from .mesh import is_local

        if cls is TrainStep and is_local(mesh):
            cls = _LocalTrainStep
        return super().__new__(cls)

    def __init__(self, symbol, optimizer, mesh=None, data_axes=("dp",),
                 param_rules=None, *, label_names=("softmax_label",),
                 data_names=("data",), compute_dtype=None, loss_fn=None,
                 zero=None, remat=None, normalize_grads=True,
                 return_outputs=False, metric_stats=False, zero_wire=None,
                 zero_min_size=None, sentinel=None, train_passes=None,
                 device=None):
        from .. import config
        from ..base import dtype_torch
        from ..context import resolve_device
        from ..executor import _graph_closure

        if zero is None:
            zero = config.get_strict_bool("MXNET_TPU_ZERO")
        self.zero = bool(zero)
        if zero_wire is None:
            zero_wire = config.get_choice("MXNET_TPU_ZERO_WIRE",
                                          ("raw", "2bit"))
        elif zero_wire not in ("raw", "2bit"):
            raise MXNetError("TrainStep: zero_wire=%r must be raw|2bit"
                             % (zero_wire,))
        self.zero_wire = zero_wire
        self.zero_threshold = config.get_positive_float(
            "MXNET_TPU_ZERO_WIRE_THRESHOLD")
        if zero_min_size is None:
            zero_min_size = config.get_nonneg_int("MXNET_TPU_ZERO_MIN_SIZE")
        self.zero_min_size = int(zero_min_size)
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.param_rules = list(param_rules or [])
        self._group, self._n, self._index = None, 1, 0
        if mesh is not None:
            from .mesh import data_group, mesh_device

            self._group, self._n, self._index = data_group(mesh,
                                                           self.data_axes)
            mdev = mesh_device(mesh)
            if device is not None and resolve_device(device) != mdev:
                raise MXNetError("TrainStep: device=%r but this rank's mesh "
                                 "device is %s" % (device, mdev))
            device = mdev
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
        from .symbol_mp import ShardPlan

        self._plan = None if mesh is None else ShardPlan.from_shardings(
            mesh, param_shardings(dict.fromkeys(self.param_names), mesh,
                                  self.param_rules))
        if self._plan is not None and self.remat is not False:
            raise MXNetError(
                "TrainStep: remat=%r with param_rules that shard parameters "
                "over the mp axis is not ported" % (self.remat,))
        self._whole_shapes = {}
        self._graph = _graph_closure(symbol, is_train=True,
                                     remat_names=remat_names,
                                     shard_plan=self._plan)
        self._step_seed = None   # a one-process mesh draws it for all
        self._owned = _fused_owned(symbol, self.param_names) \
            if mesh is not None else set()
        if mesh is not None:
            self._batch_sharding = data_sharding(mesh, self.data_axes)

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
        if isinstance(v, dict):   # the sentinel's counters
            return {k: self._on_device(x) for k, x in v.items()}
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.to(self.device)

    def place(self, params, opt_state, aux):
        """The carry ``(params, opt_state, aux, 0)`` on the step's device
        (tensors already there are kept, not copied), with the sentinel's
        counters when it is armed; under ``skip`` the step counter is a 0-d
        device tensor. On a mesh, rank 0's params and aux are broadcast to
        every rank (in place; the kvstore-init broadcast), and with ZeRO the
        optimizer state of each planned param becomes this rank's ``(1,
        chunk)`` row: from the logical layout (a fresh init, a checkpoint
        saved on any mesh size) or kept when it is in that layout already.
        With sharded params, each one's whole tensor (and each optimizer
        state leaf of its shape) becomes this rank's block; blocks placed
        already are kept. The first ``place`` takes whole params.
        Publishes :meth:`memory_stats` to the profiler."""
        params, opt_state, aux = (
            {k: self._on_device(v) for k, v in d.items()}
            for d in (params, opt_state, aux))
        if self.mesh is not None:
            from .mesh import broadcast_flat_

            if self._plan is None:
                broadcast_flat_(list(params.values()) + list(aux.values()),
                                self._group)
            else:
                params, opt_state = self._place_shards(params, opt_state,
                                                       aux)
            opt_state = self._opt_state_to_zero(opt_state,
                                                self.zero_plan(params))
        step_no = 0
        if self.sentinel == "skip":
            step_no = torch.zeros((), dtype=torch.int32, device=self.device)
        carry = (params, self._ensure_sentinel(opt_state), aux, step_no)
        self.record_memory_stats(carry)
        return carry

    # -- tensor parallelism --------------------------------------------------
    def _place_shards(self, params, opt_state, aux):
        """Rank 0's whole params and aux on every rank, then this rank's
        block of each sharded param and of each optimizer-state leaf of its
        whole shape; blocks already in place are kept (and broadcast over
        the data group, whose ranks hold the same blocks)."""
        import torch.distributed as dist

        from .mesh import broadcast_flat_

        plan = self._plan
        if not self._whole_shapes:
            param_shardings(params, self.mesh, self.param_rules)
            self._whole_shapes = {k: tuple(v.shape)
                                  for k, v in params.items()}
        held = set()
        for k in plan.dims:
            if k not in params:
                continue
            shape = tuple(params[k].shape)
            if shape == self._whole_shapes[k]:
                continue
            if shape != plan.shard_shape(k, self._whole_shapes[k]):
                raise MXNetError(
                    "TrainStep.place: %r has shape %s, neither whole %s nor "
                    "this rank's block %s" % (
                        k, shape, self._whole_shapes[k],
                        plan.shard_shape(k, self._whole_shapes[k])))
            held.add(k)
        world = dist.group.WORLD if dist.get_world_size() > 1 else None
        broadcast_flat_([v for k, v in params.items() if k not in held]
                        + list(aux.values()), world)
        broadcast_flat_([params[k] for k in sorted(held)], self._group)
        params = {k: v if k in held else plan.shard(k, v)
                  for k, v in params.items()}

        def block(k, x):
            if tuple(x.shape) == self._whole_shapes.get(k):
                return plan.shard(k, x)
            return x

        opt_state = {k: (type(v)(block(k, x) for x in v)
                         if isinstance(v, (tuple, list)) else block(k, v))
                     if k in plan.dims else v
                     for k, v in opt_state.items()}
        return params, opt_state

    def whole_params(self, params):
        """``params`` with each sharded one's whole tensor, gathered from
        the mp group's blocks (a collective: every rank calls it); ``params``
        itself without sharding."""
        if self._plan is None:
            return params
        return {k: self._plan.unshard(k, v) if k in self._plan.dims
                and tuple(v.shape) != self._whole_shapes.get(k) else v
                for k, v in params.items()}

    # -- weight-update sharding (ZeRO) ---------------------------------------
    def zero_plan(self, params, param_rules=None):
        """``{name: (shape, size, num_shards, chunk)}`` of every param whose
        update shards over the data axes: replicated by the rules, at least
        ``zero_min_size`` (and ``num_shards``) elements. Empty when zero is
        off or the data group has one rank. The params the rules shard over
        the mp axis keep their blocks."""
        if not self.zero or self.mesh is None or self._n <= 1:
            return {}
        rules = self.param_rules if param_rules is None else param_rules
        sharded = {k for k, sh in param_shardings(params, self.mesh,
                                                  rules).items()
                   if sh.spec}
        n, plan = self._n, {}
        for k, v in params.items():
            shape = tuple(v.shape)
            size = int(np.prod(shape)) if shape else 0
            if not shape or k in sharded or size < max(self.zero_min_size,
                                                          n):
                continue
            plan[k] = (shape, size, n, -(-size // n))
        return plan

    def _zrows(self, x, n, chunk):
        """``x`` flattened and zero-padded to its ``(n, chunk)`` view."""
        flat = x.reshape(-1)
        pad = n * chunk - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(n, chunk)

    def _zrow(self, x, n, chunk):
        """This rank's ``(1, chunk)`` row of ``x``'s zero layout (a copy)."""
        i = self._index
        return self._zrows(x, n, chunk)[i:i + 1].clone()

    def _opt_state_to_zero(self, opt_state, plan):
        """Every optimizer-state leaf of a planned param as this rank's row
        of its zero layout; leaves in that layout already are kept. Under
        the 2-bit wire the residual rows are kept where they fit the plan
        and made zeros where not; under the raw wire they are dropped."""
        if not plan:
            return opt_state
        out = {}
        for k, v in opt_state.items():
            if k == self._ZERO_RES:
                continue
            if k not in plan:
                out[k] = v
                continue
            _shape, _size, n, chunk = plan[k]

            def row(x):
                x = self._on_device(x)
                return x if tuple(x.shape) == (1, chunk) \
                    else self._zrow(x, n, chunk)

            out[k] = type(v)(row(x) for x in v) \
                if isinstance(v, (tuple, list)) else row(v)
        if self.zero_wire == "2bit":
            res = opt_state.get(self._ZERO_RES) or {}
            out[self._ZERO_RES] = {
                k: res[k] if k in res
                and tuple(res[k].shape) == (1, plan[k][3])
                else torch.zeros((1, plan[k][3]), dtype=torch.float32,
                                 device=self.device)
                for k in plan}
        return out

    def logical_opt_state(self, opt_state, params=None, param_rules=None):
        """The optimizer state a checkpoint stores, on the step's device:
        the sentinel's counters are transient and dropped (fresh zeros on
        restore), and under ZeRO each planned param's rows are all-gathered
        (a collective: every rank calls it), un-padded and reshaped to the
        param's shape, so a state saved under ``zero=True`` on N ranks
        restores bit for bit under ``zero=False`` or any mesh size. A
        sharded param's blocks are gathered whole (over the mp group)."""
        plan = self.zero_plan(params, param_rules) if params is not None \
            else {}
        out = {}
        for k, v in opt_state.items():
            if k in (self._SENT, self._ZERO_RES):
                continue
            if k not in plan:
                out[k] = v
                continue
            shape, size, _n, chunk = plan[k]

            def full(x):
                if tuple(x.shape) != (1, chunk):
                    return x
                from .mesh import all_gather_rows

                return all_gather_rows(x, self._group).reshape(-1)[:size] \
                    .reshape(shape)

            out[k] = type(v)(full(x) for x in v) \
                if isinstance(v, (tuple, list)) else full(v)
        if self._plan is not None:
            plan = self._plan

            def whole(k, x):
                want = self._whole_shapes.get(k)
                if want is None or tuple(x.shape) == want:
                    return x
                return plan.unshard(k, x)

            out = {k: (type(v)(whole(k, x) for x in v)
                       if isinstance(v, (tuple, list)) else whole(k, v))
                   if k in plan.dims else v
                   for k, v in out.items()}
        return out

    # -- memory ----------------------------------------------------------------
    def memory_stats(self, carry):
        """This rank's bytes of the resident carry (``param``, ``opt`` and
        ``aux_bytes_per_dev``, measured from its tensors) and the JAX
        package's per-step estimates: ``grad_bytes_per_dev_est`` (1/N rows
        for ZeRO-planned params) and ``collective_bytes_per_step_est``, the
        wire volume of the gradient sum (2 size (N-1)/N, ZeRO or not)."""
        params, opt_state, aux, _step = carry

        def nbytes(tree):
            return sum(t.numel() * t.element_size()
                       for v in tree.values()
                       for t in (v.values() if isinstance(v, dict) else
                                 v if isinstance(v, (tuple, list)) else (v,))
                       if isinstance(t, torch.Tensor))

        plan = self.zero_plan(params)
        n = self._n
        grad_est = coll_est = 0
        for k, v in params.items():
            size = v.numel() * v.element_size()
            grad_est += plan[k][3] * v.element_size() if k in plan else size
            if n > 1:
                coll_est += int(2 * size * (n - 1) / n)
        return {"param_bytes_per_dev": nbytes(params),
                "opt_bytes_per_dev": nbytes(opt_state),
                "aux_bytes_per_dev": nbytes(aux),
                "grad_bytes_per_dev_est": int(grad_est),
                "collective_bytes_per_step_est": coll_est,
                "zero": bool(plan), "zero_params": len(plan),
                "num_shards": n}

    def record_memory_stats(self, carry):
        """Publish :meth:`memory_stats` to the profiler's memory gauge; on a
        mesh with an mp axis of more than one rank also the ``mp_stats``
        gauge, as the JAX package's Module records it: the mesh's sizes and
        this rank's parameter bytes and live bytes (params, optimizer state
        and aux) at rest."""
        from .. import profiler
        from .mesh import _mp_axis, mesh_shape

        ms = self.memory_stats(carry)
        profiler.memory_record(**ms)
        if self.mesh is None:
            return
        sizes = mesh_shape(self.mesh)
        mp = sizes.get(_mp_axis(sizes), 1)
        if mp > 1:
            group = int(np.prod(list(sizes.values())))
            profiler.mp_record(
                mp_size=mp, dp_size=group // mp, group_size=group,
                param_bytes_per_chip=ms["param_bytes_per_dev"],
                live_bytes_per_chip=(ms["param_bytes_per_dev"]
                                     + ms["opt_bytes_per_dev"]
                                     + ms["aux_bytes_per_dev"]))

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
        """The batch's inputs on the step's device; on a mesh, this rank's
        rows of the global batch, sliced before the copy (an input that
        ``parallel.feed.place_batch_array`` placed already is taken as
        it is)."""
        if self.mesh is None:
            return {n: self._on_device(batch[n])
                    for n in self.data_names + self.label_names}
        from .feed import is_preplaced, rank_rows

        out = {}
        for n in self.data_names + self.label_names:
            v = batch[n]
            if not is_preplaced(v, self._batch_sharding):
                if not isinstance(v, torch.Tensor):
                    v = np.asarray(v)
                v = self._on_device(rank_rows(v, self._n, self._index, n,
                                              "TrainStep"))
            out[n] = v
        return out

    def _scope(self):
        """The data-parallel scope the fused units and BatchNorm read; the
        data and labels it shards by rows are its batch-leading inputs."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from ..kernels.fused_block import spmd_scope

        return spmd_scope(self.mesh, self.data_axes,
                          self.data_names + self.label_names)

    def _leaves(self, params):
        cdtype = self.compute_dtype
        return {k: (v.detach() if cdtype is None else v.detach().to(cdtype))
                .requires_grad_() for k, v in params.items()}

    def _loss_closure(self):
        """``loss_of(leaves, aux, inputs) -> (loss, outputs, aux_updates)``
        with the remat mode applied, shared by the step and
        :meth:`residual_stats`."""
        graph, loss_fn, step = self._graph, self.loss_fn, self
        data_names, label_names = self.data_names, self.label_names
        cdtype = self.compute_dtype

        def loss_of(leaves, aux, inputs):
            values = dict(leaves)
            values.update(aux)
            values.update(inputs)
            if cdtype is not None:
                for n in data_names:
                    values[n] = values[n].to(cdtype)
            outs, aux_updates = graph(values, step._step_seed)
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

        with residual_probe() as probe, self._scope():
            self._loss_closure()(self._leaves(params), aux,
                                 self._inputs(batch))
        return probe.stats()

    def value_and_grad(self, params, aux, batch):
        """``(loss, grads, aux_updates)`` of one step without the update:
        the gradients (summed over the batch, in ``compute_dtype``) with
        respect to the params cast to ``compute_dtype``. On a mesh, the
        global batch's loss and gradients, on every rank."""
        inputs = self._inputs(batch)
        loss, grads, aux_updates, _outs = self._value_and_grad(
            params, aux, inputs)
        self._reduce_grads(grads, {})
        return loss, grads, aux_updates

    def _value_and_grad(self, params, aux, inputs):
        """Loss, gradients, aux updates and outputs of the rank's rows. On
        a mesh the loss is the global batch's; the gradients are the rank's
        share (local rows, scaled by local/global rows where ``loss_fn``
        makes them), except the fused units' params', summed already."""
        leaves = self._leaves(params)
        with self._scope():
            loss, outs, aux_updates = self._loss_closure()(leaves, aux,
                                                           inputs)
            if self.mesh is not None:
                # the global mean is the sum over ranks of local means
                # times local/global rows (a mean over rows is assumed)
                loss = loss * (1.0 / self._n)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        loss = loss.detach()
        if self.mesh is not None:
            from .mesh import all_reduce_

            loss = all_reduce_(loss.clone(), self._group)
        return loss, grads, aux_updates, outs

    def _reduce_grads(self, grads, plan):
        """Sum the gradients over the data group, once: one all-reduce a
        dtype for every param but the fused units' (summed by their
        backward); a ZeRO-planned param's becomes this rank's ``(1, chunk)``
        row of the sum (reduce-scattered, or sliced when summed already)."""
        if self.mesh is None:
            return grads
        from . import mesh as mesh_mod

        mesh_mod.all_reduce_flat_(
            [g for k, g in grads.items()
             if k not in self._owned and k not in plan], self._group)
        for k, (_shape, _size, n, chunk) in plan.items():
            if k in self._owned:
                grads[k] = self._zrow(grads[k], n, chunk)
            else:
                grads[k] = mesh_mod.reduce_scatter_rows(
                    self._zrows(grads[k], n, chunk), self._group)
        return grads

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

    def _health_terms(self, loss, grads, plan):
        """The health word's terms known before the update: finite loss,
        finite sum of squared gradients (f32). A ZeRO row's squares are
        summed over the group, so the word is the same on every rank."""
        gsq = torch.zeros((), dtype=torch.float32, device=loss.device)
        sharded = self._plan.dims if self._plan is not None else ()
        for k, g in grads.items():
            if k not in plan and k not in sharded:
                gsq = gsq + torch.sum(torch.square(g.float()))
        if sharded:
            from .mesh import all_reduce_

            part = torch.zeros((), dtype=torch.float32, device=loss.device)
            for k in sharded:
                part = part + torch.sum(torch.square(grads[k].float()))
            gsq = gsq + all_reduce_(part, self._plan.tp[0])
        if plan:
            from .mesh import all_reduce_

            part = torch.zeros((), dtype=torch.float32, device=loss.device)
            for k in plan:
                part = part + torch.sum(torch.square(grads[k].float()))
            gsq = gsq + all_reduce_(part, self._group)
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
        core_opt = {k: v for k, v in opt_state.items()
                    if k not in (self._SENT, self._ZERO_RES)}
        wire = opt_state.get(self._ZERO_RES) \
            if self.zero_wire == "2bit" else None
        loss, grads, aux_updates, outs = self._value_and_grad(params, aux,
                                                              inputs)
        plan = self.zero_plan(params)
        grads = self._reduce_grads(grads, plan)
        if self.normalize_grads:
            bsz = int(inputs[self.data_names[0]].shape[0]) * self._n
            grads = {k: g / bsz for k, g in grads.items()}
        before = None
        if self.sentinel == "skip":
            # the way back for an unhealthy step: the update is in place
            with torch.no_grad():
                before = [(v, v.clone())
                          for d in (params, core_opt, aux, wire or {})
                          for v in _tensors(d)]
            if not isinstance(step_no, torch.Tensor):
                step_no = torch.full((), int(step_no), dtype=torch.int32,
                                     device=self.device)
        if armed:
            f_loss, f_grad = self._health_terms(loss, grads, plan)
        if plan:
            self._zero_update(params, grads, core_opt, step_no, plan, wire)
        else:
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
                if self._plan is not None:
                    # a rank checks only its blocks: the word must agree
                    from .mesh import all_reduce_

                    p_ok = all_reduce_((~p_ok).to(torch.int32),
                                       self._plan.tp[0]) == 0
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
        if self.mesh is not None:
            from .mesh import all_gather_rows

            outs = tuple(all_gather_rows(o, self._group) for o in outs)
            inputs = {n: all_gather_rows(inputs[n], self._group)
                      for n in self.label_names[:1]}
        if self.metric_stats:
            with torch.no_grad():
                stats = self._metric_stats(loss, outs, inputs)
            return new_carry, (loss, outs, stats)
        return new_carry, (loss, outs)

    def _zero_update(self, params, grads, core_opt, step_no, plan,
                     wire=None):
        """The update of a ZeRO plan: each planned param's ``(1, chunk)``
        row updated with its gradient row and its state row, then the rows
        all-gathered into the param (in place); every other param as the
        replicated update. The update is elementwise, so a row's values are
        those of the replicated update. ``wire`` (the 2-bit wire's residual
        rows) first sends each gradient row through the packed codes in
        f32, its residual updated in place."""
        from .mesh import all_gather_rows

        if wire is not None:
            from ..kvstore import two_bit_round_trip_core

            with torch.no_grad():
                for k in plan:
                    q, r = two_bit_round_trip_core(
                        grads[k].float(), wire[k], self.zero_threshold)
                    wire[k].copy_(r)
                    grads[k] = q

        rows = {k: (self._zrow(w.detach(), *plan[k][2:]) if k in plan
                    else w) for k, w in params.items()}
        self.optimizer.apply(rows, grads, core_opt, step_no)
        with torch.no_grad():
            for k, (shape, size, _n, _chunk) in plan.items():
                full = all_gather_rows(rows[k], self._group)
                params[k].copy_(full.reshape(-1)[:size].view(shape))


class LocalCarry(tuple):
    """The carry of a :class:`TrainStep` over a one-process mesh: replica
    0's ``(params, opt_state, aux, step)``, what rank 0 holds on a mesh of
    ranks, with every replica's carry, in replica order, in
    ``replicas``."""

    def __new__(cls, replicas):
        carry = super().__new__(cls, replicas[0])
        carry.replicas = list(replicas)
        return carry


def with_step(carry, step):
    """``carry`` with its step count from ``step``: another carry's (replica
    by replica), or an int, kept a 0-d device tensor where the carry's is
    one."""
    if isinstance(carry, LocalCarry):
        steps = step.replicas if isinstance(step, LocalCarry) \
            else [step] * len(carry.replicas)
        return LocalCarry([with_step(c, s)
                           for c, s in zip(carry.replicas, steps)])
    if isinstance(step, tuple):
        return tuple(carry[:3]) + (step[3],)
    if isinstance(carry[3], torch.Tensor):
        step = torch.full((), int(step), dtype=torch.int32,
                          device=carry[3].device)
    return tuple(carry[:3]) + (step,)


def _holds_tensor(x):
    """Whether a dict, tuple or list (nested) holds a tensor."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return any(_holds_tensor(v) for v in x)
    return isinstance(x, torch.Tensor)


def _clone_tree(x):
    """A copy of a dict, tuple or list of tensors and arrays."""
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone_tree(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


class _LocalTrainStep(TrainStep):
    """:class:`TrainStep` over a one-process mesh (``mesh.LocalMesh``): one
    ``TrainStep`` a replica on the replica's view of the mesh, its
    collectives over the replicas' local groups, run by
    ``LocalMesh.run``. The carry is a :class:`LocalCarry`; a piece of the
    newest carry this step made (replica 0's params, optimizer state or
    aux) stands for every replica's piece wherever a method takes it, and
    any other argument that holds tensors is refused, save the values
    :meth:`place` puts on every replica. The step seed of random ops is
    drawn once a call, on the caller's thread, and shared by the replicas,
    which fold in their index as ranks do."""

    def __init__(self, symbol, optimizer, mesh=None, data_axes=("dp",),
                 param_rules=None, **kw):
        from .. import config
        from ..executor import has_rng

        if kw.get("device") is not None:
            raise MXNetError("TrainStep: device=%r with a one-process mesh; "
                             "its replicas' devices are the mesh's"
                             % (kw["device"],))
        if kw.get("zero_wire") is None:
            # read once: every replica takes the same wire
            kw["zero_wire"] = config.get_choice("MXNET_TPU_ZERO_WIRE",
                                                ("raw", "2bit"))
        self._replicas = [
            TrainStep(symbol, optimizer, mesh.replica(i), data_axes,
                      param_rules, **kw) for i in range(mesh.size)]
        first = self._replicas[0]
        self.mesh = mesh
        self.symbol, self.device = symbol, first.device
        self.data_axes, self.zero = first.data_axes, first.zero
        self.sentinel = first.sentinel
        self.param_names = list(first.param_names)
        self.aux_names = list(first.aux_names)
        self._batch_sharding = data_sharding(mesh, self.data_axes)
        self._rng = has_rng(self.symbol)
        self._live = None

    def _pick(self, arg, i, given=False):
        """Replica ``i``'s value of a method argument: its own carry of a
        :class:`LocalCarry`, or its piece where ``arg`` is a piece of the
        newest carry. Other arguments pass as they are; one that holds
        tensors raises unless it is ``given`` (a value :meth:`place` puts
        on every replica), since it would hand replica 0's tensors to
        all."""
        if isinstance(arg, LocalCarry):
            return arg.replicas[i]
        live = self._live
        if live is not None:
            for j, piece in enumerate(live):
                if arg is piece:
                    return live.replicas[i][j]
        if not given and _holds_tensor(arg):
            raise MXNetError(
                "TrainStep over a one-process mesh: an argument holds "
                "tensors but is neither a carry this step made nor a piece "
                "of its newest carry; pass the carry or its piece, or "
                "place() the values first")
        return arg

    def _replica_input(self, value, i):
        """Replica ``i``'s rows of a batch array placed for this mesh
        (``feed.place_batch_array``); any other array as it is."""
        if getattr(value, "_mx_sharding", None) == self._batch_sharding:
            return value._mx_replicas[i]
        return value

    def _fan(self, name, *args, batch=None):
        """``name`` on every replica with its own arguments (a batch dict
        through :meth:`_replica_input`), under one step seed; the replicas'
        results."""
        from .. import random as _random

        seed = _random.next_seed(self.device) \
            if self._rng and batch is not None else None

        def one(i):
            rep = self._replicas[i]
            mine = [self._pick(a, i) for a in args]
            if batch is not None:
                mine.append({n: self._replica_input(v, i)
                             for n, v in batch.items()})
            rep._step_seed = seed
            try:
                return getattr(rep, name)(*mine)
            finally:
                rep._step_seed = None

        return self.mesh.run(one)

    def init_params(self, *args, **kw):
        return self._replicas[0].init_params(*args, **kw)

    def place(self, params, opt_state, aux):
        """Every replica's carry from the same values (rank 0's, i.e.
        replica 0's, win bit for bit), as a :class:`LocalCarry`."""
        given = (params, opt_state, aux)

        def one(i):
            mine = [self._pick(a, i, given=True) for a in given]
            if i:
                mine = [_clone_tree(m) if m is a else m
                        for m, a in zip(mine, given)]
            return self._replicas[i].place(*mine)

        self._live = LocalCarry(self.mesh.run(one))
        return self._live

    def __call__(self, carry, batch):
        out = self._fan("__call__", carry, batch=batch)
        self._live = LocalCarry([r[0] for r in out])
        return self._live, out[0][1]

    def value_and_grad(self, params, aux, batch):
        return self._fan("value_and_grad", params, aux, batch=batch)[0]

    def residual_stats(self, params, aux, batch):
        return self._fan("residual_stats", params, aux, batch=batch)[0]

    def logical_opt_state(self, opt_state, params=None, param_rules=None):
        return self._fan("logical_opt_state", opt_state, params,
                         param_rules)[0]

    def whole_params(self, params):
        return self._fan("whole_params", params)[0]

    def zero_plan(self, params, param_rules=None):
        return self._replicas[0].zero_plan(self._pick(params, 0),
                                           param_rules)

    def memory_stats(self, carry):
        return self._replicas[0].memory_stats(self._pick(carry, 0))

    def record_memory_stats(self, carry):
        self._replicas[0].record_memory_stats(self._pick(carry, 0))

    def health_stats(self, carry):
        return self._replicas[0].health_stats(self._pick(carry, 0))


def _tensors(d):
    """The tensors of a dict of tensors or of tuples of them (Adam's
    state)."""
    for v in d.values():
        if isinstance(v, (tuple, list)):
            yield from v
        else:
            yield v
