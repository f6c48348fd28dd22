"""Inference predictor and the ``MXNET_SERVE_*`` knob readers (counterpart
of ``mxnet_tpu/serving/predictor.py``).

:class:`AOTPredictor` binds a symbol and its parameters for inference at
a ladder of batch sizes:

- **Constant folding.** At bind time the graph is split on data
  dependence (``ir.FoldPlan``): nodes that are pure functions of the
  weights are evaluated once per parameter set; a request runs only the
  data-dependent suffix.
- **Frozen weights.** Parameters are converted once to tensors on the
  device in the serving dtype (float32 default, bfloat16 supported).
- **Batch-size ladder.** A request of n rows pads up to the smallest
  bucket >= n (``MXNET_SERVE_BATCH_LADDER``, default 1/4/16/64); the pad
  rows are sliced away after the forward.
- **Hot swap.** :meth:`AOTPredictor.swap_params` refreezes, refolds and
  publishes the new constant set in one assignment.
- **Int8 post-training quantization.** ``quant="int8"`` runs the quantize
  pass (``ir/quantize.py``) over ``calib_data`` before the fold split, so
  the weights' ``_quantize_rows_int8`` nodes fold once per parameter set
  (a swap requantizes them) and the activations quantize at the bound
  boundaries of each request.

The JAX package's ``ExecutableCache`` (and so ``MXNET_SERVE_MAX_EXECUTABLES``)
has no counterpart: PyTorch runs eagerly, so there is no compiled program
per bucket to keep, and no cache key to carry an int8 bind's calibration
fingerprint (the JAX ``_quant_fingerprint``): each predictor runs its own
graph, whose ``_quantize_int8`` nodes carry their scales.

**The sharded bind.** ``mesh=`` with ``param_rules`` shards the weights
over the mesh's ``mp`` axis, one process a rank: every rank makes the
predictor with the whole params and keeps its block of each sharded one
(the rest whole), and every request runs the graph under
``parallel.symbol_mp.ShardPlan`` (the Megatron pair, every other use of a
sharded weight gathered at use). The mesh's rank 0 serves; the other ranks
run :meth:`AOTPredictor.follow`, which receives each request batch through
a lockstep (``serving.lockstep.Lockstep``) and runs the same program, so
its collectives meet. Sharded weights are never folded.
Not ported yet: ``swap_params`` and ``quant="int8"`` on a sharded bind
(both raise).

**The exact-shape bind.** ``ladder=None`` binds the given ``data_shapes``
as they are: no padding, no bucket selection, a request of any other shape
raises. The C predict ABI binds so (``c_predict.py``).
"""
from __future__ import annotations

import os
import threading
import warnings

import numpy as np
import torch

from .. import config
from ..base import MXNetError, dtype_name, dtype_torch
from ..context import resolve_device
from ..executor import INFERENCE_SEED, eval_node

# the sharded bind's lockstep op (``lockstep.CLOSE`` is 0)
_RUN = 1
# the ladder that reads MXNET_SERVE_BATCH_LADDER (its default), as the JAX
# package's AOTPredictor takes it: ``ladder=None`` is the exact-shape bind
DEFAULT_LADDER = (1, 4, 16, 64)


class ServingError(MXNetError):
    """Serving-tier failure (bad knob, bad request, closed server)."""


def validate_ladder(ladder, source="batch ladder"):
    """A ladder is a non-empty, strictly increasing tuple of positive
    ints; anything else raises :class:`ServingError` naming the source."""
    try:
        entries = tuple(int(str(b).strip()) for b in ladder)
    except (TypeError, ValueError):
        raise ServingError("%s %r: every entry must be an integer batch size"
                           % (source, ladder))
    if not entries:
        raise ServingError("%s is empty: need at least one batch size"
                           % source)
    for b in entries:
        if b < 1:
            raise ServingError("%s %r: batch sizes must be >= 1 (got %d)"
                               % (source, ladder, b))
    if any(b >= c for b, c in zip(entries, entries[1:])):
        raise ServingError("%s %r must be strictly increasing"
                           % (source, entries))
    return entries


def env_batch_ladder():
    """``MXNET_SERVE_BATCH_LADDER`` as a validated ladder; set but empty
    reads as unset, as in the JAX package."""
    raw = config.get("MXNET_SERVE_BATCH_LADDER")
    if not raw.strip():
        raw = config.KNOBS["MXNET_SERVE_BATCH_LADDER"][0]
    return validate_ladder(raw.split(","),
                           source="MXNET_SERVE_BATCH_LADDER=%r" % raw)


def env_positive_int(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return int(default)
    try:
        value = int(raw)
    except ValueError:
        raise ServingError("%s=%r is not an integer" % (name, raw))
    if value < 1:
        raise ServingError("%s=%r must be >= 1" % (name, raw))
    return value


def env_positive_float(name, default):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return float(default)
    try:
        value = float(raw)
    except ValueError:
        raise ServingError("%s=%r is not a number" % (name, raw))
    if not 0 < value < float("inf"):  # also rejects NaN
        raise ServingError("%s=%r must be a finite value > 0"
                           % (name, raw))
    return value


def _resolve_quant(quant):
    """The serving quantization mode: the argument, else
    ``MXNET_SERVE_QUANT``; ``none`` or ``int8``, anything else raises
    naming its source."""
    if quant is None:
        return config.get_choice("MXNET_SERVE_QUANT", ("none", "int8"))
    mode = str(quant).strip().lower()
    if mode not in ("none", "int8"):
        raise ServingError("quant=%r: serving quantization must be 'none' "
                           "or 'int8'" % (quant,))
    return mode


def _pick_internals(sym, output_names):
    """Serve internal layers by name (``get_internals`` semantics)."""
    from .. import symbol as sym_mod

    internals = sym.get_internals()
    outs = internals.list_outputs()
    picked = []
    for name in output_names:
        want = name if name in outs else name + "_output"
        if want not in outs:
            raise ValueError("unknown output %r (have %s)" % (name, outs))
        picked.append(internals[outs.index(want)])
    return sym_mod.Group(picked) if len(picked) > 1 else picked[0]


class AOTPredictor:
    """One model bound for inference at a ladder of batch sizes.

    ``arg_params``/``aux_params``: ``{name: array}`` (numpy or tensors);
    arguments that are neither data inputs nor in the params are
    zero-filled with a warning (c_predict parity: loss labels).
    ``data_shapes``: ``{input name: shape}``, the leading dimension the
    batch axis, rebound per ladder bucket. ``ladder``: the batch buckets,
    by default ``MXNET_SERVE_BATCH_LADDER``; ``None`` binds the data shapes
    exactly (no padding, no buckets: the C ABI's mode). ``dtype``: the
    serving compute dtype; float params and inputs are cast to it, float
    outputs come back as float32 numpy.
    ``device`` defaults to ``cuda`` (raising when there is none); pass
    ``device="cpu"`` to serve on the CPU. ``output_names`` serves internal
    layers (``fc1_output``, ...). Random ops that draw in inference
    (``Dropout(mode="always")``) draw from ``executor.INFERENCE_SEED`` on
    every request. ``quant``: ``"none"`` or ``"int8"`` (None reads
    ``MXNET_SERVE_QUANT``); int8 calibrates on ``calib_data`` (a list of
    ``{input: array}`` batches; none raises ``ir.CalibrationError``) on the
    predictor's device and quantizes every FC and 2-D convolution but the
    nodes named in ``quant_exclude``; ``quant_report`` and
    ``bind_stats["quantized_ops"]`` say what it did.

    ``mesh`` (a ``parallel.make_mesh``/``train_mesh`` mesh) with
    ``param_rules`` (``[(regex, spec)]`` or the ``MXNET_MP_RULES`` string)
    binds the model sharded over the mesh's ``mp`` axis on this rank's mesh
    device: every rank makes the predictor with the whole params, rank 0
    calls it, the others run :meth:`follow` until rank 0's :meth:`close`.
    A matched rule that cannot apply raises ``ShardingRuleError``.
    :meth:`sharded_stats` gives the rank's parameter bytes. Mutually
    exclusive with ``device``.
    """

    def __init__(self, symbol, arg_params=None, aux_params=None,
                 data_shapes=None, ladder=DEFAULT_LADDER, dtype="float32",
                 device=None, output_names=None, quant=None, mesh=None,
                 calib_data=None, quant_exclude=(), param_rules=None):
        self._quant = _resolve_quant(quant)
        if mesh is not None and device is not None:
            raise ServingError(
                "AOTPredictor: pass mesh= OR device=, not both (the mesh "
                "decides placement for a sharded bind)")
        if mesh is not None and self._quant != "none":
            raise ServingError("AOTPredictor: quant=%r on a sharded bind "
                               "(mesh=) is not ported" % self._quant)
        if isinstance(param_rules, str):
            from ..parallel.spmd import parse_rules

            param_rules = parse_rules(param_rules,
                                      knob="AOTPredictor param_rules")
        self._mesh = mesh
        self._param_rules = list(param_rules or [])
        if not data_shapes:
            raise ServingError("AOTPredictor: data_shapes is required "
                               "({input_name: shape})")
        if output_names:
            symbol = _pick_internals(symbol, output_names)
        self._sym = symbol
        self._data_shapes = {k: tuple(v) for k, v in data_shapes.items()}
        self._data_names = sorted(self._data_shapes)
        if ladder is None:
            self._ladder = None
        elif ladder is DEFAULT_LADDER:
            self._ladder = env_batch_ladder()
        else:
            self._ladder = validate_ladder(ladder)
        self._dtype = dtype_torch(dtype)
        self._dtype_name = dtype_name(dtype)
        if mesh is not None:
            from ..parallel.mesh import mesh_device

            self.device = mesh_device(mesh)
        else:
            self.device = resolve_device(device)
        self._lock = threading.Lock()

        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        for name in self._data_names:
            if name not in arg_names:
                raise ServingError(
                    "AOTPredictor: data input %r is not an argument of the "
                    "symbol (arguments: %s)" % (name, arg_names))
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})
        self._weight_names = [n for n in arg_names
                              if n not in self._data_names
                              and n in arg_params]
        self._bound_aux = [n for n in aux_names if n in aux_params]
        self._extra_names = sorted(
            [n for n in arg_names if n not in self._data_names
             and n not in arg_params]
            + [n for n in aux_names if n not in aux_params])
        if self._extra_names:
            # ref parity: c_predict_api.cc warns and zero-fills args
            # absent from the params file (loss labels, eval-only args)
            warnings.warn(
                "AOTPredictor: zero-filling arguments absent from the "
                "params: %s" % self._extra_names, stacklevel=2)

        # int8: the quantize pass runs before the fold split, so each
        # weight's _quantize_rows_int8 node folds (once per parameter set,
        # again on a swap); argument and aux names are unchanged
        self.quant_report = None
        if self._quant == "int8":
            from .. import ir

            merged = {n: arg_params[n] for n in self._weight_names}
            merged.update({n: aux_params[n] for n in self._bound_aux})
            symbol, self.quant_report = ir.quantize_for_serving(
                symbol, merged, calib_data, self._data_names,
                exclude=quant_exclude, device=self.device)
            self._sym = symbol

        arg_shapes, _, aux_shapes = symbol.infer_shape(
            **self._bucket_shapes(self._ladder[0] if self._ladder else None))
        inferred = dict(zip(arg_names, arg_shapes))
        inferred.update(zip(aux_names, aux_shapes))
        self._shard_plan = self._lockstep = None
        self._whole_bytes = 0
        if mesh is not None:
            from ..parallel.spmd import param_shardings
            from ..parallel.symbol_mp import ShardPlan
            from .lockstep import Lockstep

            self._shard_plan = ShardPlan.from_shardings(
                mesh, param_shardings({n: inferred[n]
                                       for n in self._weight_names},
                                      mesh, self._param_rules))
            self._lockstep = Lockstep(ServingError)
        params, shards = {}, {}
        for name in self._weight_names + self._bound_aux:
            arr = self._freeze_one(name, arg_params.get(
                name, aux_params.get(name)))
            if tuple(arr.shape) != tuple(inferred[name]):
                raise ServingError(
                    "AOTPredictor: param %r has shape %s, the graph needs %s"
                    % (name, tuple(arr.shape), tuple(inferred[name])))
            self._whole_bytes += arr.numel() * arr.element_size()
            if self._shard_plan is not None \
                    and name in self._shard_plan.dims:
                shards[name] = self._shard_plan.shard(name, arr)
            else:
                params[name] = arr
        self._shards = shards

        from ..ir import FoldPlan

        # extras are zero-filled per bucket (their shapes may carry the
        # batch dim), so for folding they are dynamic, like real data; so
        # are the sharded weights, which no folded node may read whole
        self._plan = FoldPlan(symbol,
                              set(self._data_names) | set(self._extra_names)
                              | set(shards))
        self._fold_fn = self._plan.make_fold_fn()
        self._params = params
        with torch.inference_mode():
            self._consts = self._fold_fn(params)
        self._extra_shapes = {}   # bucket -> {extra name: shape}
        self.bind_stats = {
            "folded_nodes": self._plan.folded_nodes,
            "dynamic_nodes": self._plan.dynamic_nodes,
            "frozen_params": len(params) + len(shards),
            "zero_filled": list(self._extra_names),
            "ladder": self._ladder,
            "dtype": self._dtype_name,
            "quant": self._quant,
        }
        if self.quant_report is not None:
            self.bind_stats["quantized_ops"] = \
                self.quant_report["quantized_ops"]

    def _freeze_one(self, name, value):
        if hasattr(value, "asnumpy"):           # an NDArray
            value = value.asnumpy()
        t = value.detach() if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        if t.is_floating_point():
            t = t.to(self._dtype)
        return t.to(self.device).contiguous()

    def _bucket_shapes(self, bucket):
        """The data shapes at ``bucket`` rows (None: the exact bind's)."""
        if bucket is None:
            return dict(self._data_shapes)
        return {name: (bucket,) + shape[1:]
                for name, shape in self._data_shapes.items()}

    def _zero_shapes(self, bucket):
        """Shapes of the zero-filled extras at this bucket."""
        got = self._extra_shapes.get(bucket)
        if got is None:
            arg_shapes, _, aux_shapes = self._sym.infer_shape(
                **self._bucket_shapes(bucket))
            extras = set(self._extra_names)
            got = {n: tuple(s) for n, s in
                   list(zip(self._sym.list_arguments(), arg_shapes))
                   + list(zip(self._sym.list_auxiliary_states(), aux_shapes))
                   if n in extras}
            self._extra_shapes[bucket] = got
        return got

    def _run(self, data_vals, consts, bucket):
        plan, shard = self._plan, self._shard_plan
        nodes, node_ids, dyn = plan.nodes, plan.node_ids, plan.dyn
        const_index = plan.const_index
        zeros = {n: torch.zeros(s, dtype=torch.float32, device=self.device)
                 for n, s in self._zero_shapes(bucket).items()}
        results, layouts = {}, {}

        def val(entry):
            inp, idx = entry
            if inp.is_variable():
                name = inp.name
                if name in data_vals:
                    return data_vals[name]
                if name in self._shards:
                    return self._shards[name]
                if name in zeros:
                    return zeros[name]
                return consts[const_index[("var", name)]]
            nid = node_ids[id(inp)]
            if nid in dyn:
                return results[nid][idx]
            return consts[const_index[("node", nid, idx)]]

        def layout(entry):
            inp, idx = entry
            if inp.is_variable():
                return shard.var_layout(inp.name)
            nid = node_ids[id(inp)]
            return layouts[nid][idx] if nid in dyn else None

        for i, node in enumerate(nodes):
            if node.is_variable() or i not in dyn:
                continue
            ins = [val(e) for e in node.inputs]
            if shard is None:
                results[i] = eval_node(node, ins, False, INFERENCE_SEED, i,
                                       self.device)
                continue
            results[i], layouts[i] = shard.run_node(
                node, ins, [layout(e) for e in node.inputs],
                lambda xs, node=node, i=i: eval_node(
                    node, xs, False, INFERENCE_SEED, i, self.device))
        if shard is None:
            return [val(e) for e in plan.entries]
        return [shard.whole(val(e), layout(e)) for e in plan.entries]

    # -- request surface ----------------------------------------------------
    @property
    def ladder(self):
        return self._ladder

    @property
    def max_bucket(self):
        return self._ladder[-1] if self._ladder else None

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def output_names(self):
        return self._sym.list_outputs()

    @property
    def num_outputs(self):
        return len(self._plan.entries)

    def pick_bucket(self, rows):
        """Smallest ladder bucket >= rows."""
        if self._ladder is None:
            raise ServingError("predictor was bound at exact shapes "
                               "(ladder=None); no bucket ladder exists")
        rows = int(rows)
        if rows < 1:
            raise ServingError("request needs >= 1 row, got %d" % rows)
        for b in self._ladder:
            if b >= rows:
                return b
        raise ServingError(
            "request of %d rows exceeds the largest batch bucket %d "
            "(MXNET_SERVE_BATCH_LADDER)" % (rows, self._ladder[-1]))

    def _normalize(self, inputs):
        if not isinstance(inputs, dict):
            if len(self._data_names) != 1:
                raise ServingError("model has inputs %s: pass a {name: "
                                   "array} dict" % self._data_names)
            inputs = {self._data_names[0]: inputs}
        unknown = sorted(set(inputs) - set(self._data_names))
        missing = sorted(set(self._data_names) - set(inputs))
        if unknown or missing:
            raise ServingError(
                "bad request inputs: unknown %s, missing %s (model inputs: "
                "%s)" % (unknown, missing, self._data_names))
        out, rows = {}, None
        for name in self._data_names:
            v = np.asarray(inputs[name])
            want = self._data_shapes[name]
            if v.ndim != len(want) or tuple(v.shape[1:]) != tuple(want[1:]):
                raise ServingError(
                    "input %r has shape %s, expected (n,%s)"
                    % (name, tuple(v.shape),
                       ",".join(str(d) for d in want[1:])))
            if rows is None:
                rows = int(v.shape[0])
            elif int(v.shape[0]) != rows:
                raise ServingError("inputs disagree on the batch dim (%d vs "
                                   "%d rows)" % (rows, int(v.shape[0])))
            out[name] = v
        return out, rows

    def run_bucket(self, inputs, bucket):
        """Run one assembled batch of exactly ``bucket`` rows (None on an
        exact-shape bind: its bound shapes); returns the
        outputs as host numpy arrays, unsliced, float outputs as float32.
        On a sharded bind, rank 0 first sends the batch to the followers;
        a failed send breaks the lockstep (later calls raise)."""
        ls = self._lockstep
        if ls is None:
            return self._run_bucket(inputs, bucket)
        if set(inputs) != set(self._data_names):
            raise ServingError("AOTPredictor: a sharded call takes exactly "
                               "the inputs %s, got %s"
                               % (self._data_names, sorted(inputs)))
        arrays = [np.asarray(inputs[n]) for n in self._data_names]
        return ls.lead("AOTPredictor", _RUN,
                       arrays + [np.array([-1 if bucket is None else bucket],
                                          np.int64)],
                       lambda: self._run_bucket(inputs, bucket))

    def follow(self):
        """Run rank 0's requests on this rank until rank 0 closes the
        predictor; returns the number run. Every rank of a sharded bind but
        the mesh's rank 0 calls it once, after making the predictor."""
        if self._lockstep is None:
            raise ServingError("follow: only the ranks but 0 of a sharded "
                               "predictor follow")
        calls = [0]

        def handle(op, arrays):
            bucket = int(arrays[-1][0])
            self._run_bucket(dict(zip(self._data_names, arrays[:-1])),
                             None if bucket < 0 else bucket)
            calls[0] += 1

        self._lockstep.follow(handle)
        return calls[0]

    def close(self):
        """On rank 0 of a sharded bind, release the followers (their
        :meth:`follow` returns); later calls raise. A no-op otherwise, and
        once closed (or after a failed sharded call)."""
        if self._lockstep is not None:
            self._lockstep.close()

    def sharded_stats(self):
        """This rank's bytes of a sharded bind, measured from its frozen
        tensors: ``param_bytes_per_chip`` (its blocks of the sharded weights
        and the whole others) beside ``param_bytes_total`` (every weight
        whole), ``group_size`` (the mesh's ranks) and ``mp_size``; records
        them into the profiler's ``mp_stats`` gauge. Raises without a
        mesh."""
        from .. import profiler
        from ..parallel.mesh import _mp_axis, mesh_shape

        if self._mesh is None:
            raise ServingError("sharded_stats: predictor was not bound on a "
                               "mesh (pass mesh= to the constructor)")
        sizes = mesh_shape(self._mesh)
        group = int(np.prod(list(sizes.values())))
        mp = sizes.get(_mp_axis(sizes), 1)
        per_chip = sum(t.numel() * t.element_size() for d in
                       (self._params, self._shards) for t in d.values())
        profiler.mp_record(group_size=group, mp_size=mp,
                           param_bytes_per_chip=per_chip)
        return {"group_size": group, "mp_size": mp,
                "param_bytes_total": self._whole_bytes,
                "param_bytes_per_chip": per_chip}

    def _run_bucket(self, inputs, bucket):
        with self._lock:
            consts = self._consts
        with torch.inference_mode():
            data = {}
            for k, v in inputs.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if t.is_floating_point():
                    t = t.to(self._dtype)
                data[k] = t.to(self.device, non_blocking=True)
            outs = self._run(data, consts, bucket)
            return [(o.float() if o.is_floating_point() else o).cpu().numpy()
                    for o in outs]

    def predict(self, inputs):
        """Synchronous single-request forward: pads up to the nearest
        bucket, runs, slices the pad away. Returns a list of numpy outputs
        with the request's row count. An exact-shape bind (``ladder=None``)
        takes its bound shapes only."""
        inputs, rows = self._normalize(inputs)
        if self._ladder is None:
            for name, v in inputs.items():
                if tuple(v.shape) != self._data_shapes[name]:
                    raise ServingError(
                        "input %r has shape %s; exact-bound predictor "
                        "expects %s" % (name, tuple(v.shape),
                                        self._data_shapes[name]))
            return self.run_bucket(inputs, None)
        bucket = self.pick_bucket(rows)
        padded = {}
        for name, v in inputs.items():
            if rows == bucket:
                padded[name] = v
            else:
                buf = np.zeros((bucket,) + v.shape[1:], dtype=v.dtype)
                buf[:rows] = v
                padded[name] = buf
        outs = self.run_bucket(padded, bucket)
        return [o[:rows] if o.ndim and o.shape[0] == bucket else o
                for o in outs]

    # -- hot swap ------------------------------------------------------------
    def swap_params(self, arg_params=None, aux_params=None,
                    allow_extra=False):
        """Atomically replace (a subset of) the frozen weights: refreeze,
        refold, publish the new constant set in one assignment. Shapes must
        match the bound ones; requests racing the swap see the old or the
        new model, never a mix. A sharded bind raises (not ported)."""
        if self._mesh is not None:
            raise ServingError("swap_params on a sharded predictor (mesh=) "
                               "is not ported: bind a new predictor")
        known = set(self._weight_names) | set(self._bound_aux)
        updates = {}
        for d in (arg_params, aux_params):
            for name, value in (d or {}).items():
                if name not in known:
                    if allow_extra:
                        continue
                    raise ServingError(
                        "swap_params: %r is not a frozen parameter of this "
                        "predictor (use allow_extra=True to skip unknown "
                        "names)" % name)
                updates[name] = value
        if not updates:
            raise ServingError("swap_params: no parameters to swap")
        with self._lock:
            base = dict(self._params)
        for name, value in updates.items():
            arr = self._freeze_one(name, value)
            if tuple(arr.shape) != tuple(base[name].shape):
                raise ServingError(
                    "swap_params: %r has shape %s, bound shape is %s"
                    % (name, tuple(arr.shape), tuple(base[name].shape)))
            base[name] = arr
        with torch.inference_mode():
            consts = self._fold_fn(base)
        with self._lock:
            self._params = base
            self._consts = consts
        return len(updates)
