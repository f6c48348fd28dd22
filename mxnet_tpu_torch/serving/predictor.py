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

The JAX package's ``ExecutableCache`` (and so ``MXNET_SERVE_MAX_EXECUTABLES``)
has no counterpart: PyTorch runs eagerly, so there is no compiled program
per bucket to keep. Not ported yet: int8 serving (``quant=``), the
sharded bind (``mesh=``) and the exact-shape bind (the JAX package's
``ladder=None``; here ``ladder=None`` reads the knob).
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
    by default ``MXNET_SERVE_BATCH_LADDER``. ``dtype``: the serving compute
    dtype; float params and inputs are cast to it, float outputs come back
    as float32 numpy.
    ``device`` defaults to ``cuda`` (raising when there is none); pass
    ``device="cpu"`` to serve on the CPU. ``output_names`` serves internal
    layers (``fc1_output``, ...). Random ops that draw in inference
    (``Dropout(mode="always")``) draw from ``executor.INFERENCE_SEED`` on
    every request.
    """

    def __init__(self, symbol, arg_params=None, aux_params=None,
                 data_shapes=None, ladder=None, dtype="float32",
                 device=None, output_names=None, quant=None, mesh=None):
        if quant not in (None, "none"):
            raise ServingError("AOTPredictor: quant=%r is not ported yet "
                               "(int8 serving, ROADMAP.md Queue A item 12)"
                               % (quant,))
        if mesh is not None:
            raise ServingError("AOTPredictor: mesh= (a sharded bind) is not "
                               "ported yet")
        if not data_shapes:
            raise ServingError("AOTPredictor: data_shapes is required "
                               "({input_name: shape})")
        if output_names:
            symbol = _pick_internals(symbol, output_names)
        self._sym = symbol
        self._data_shapes = {k: tuple(v) for k, v in data_shapes.items()}
        self._data_names = sorted(self._data_shapes)
        self._ladder = env_batch_ladder() if ladder is None \
            else validate_ladder(ladder)
        self._dtype = dtype_torch(dtype)
        self._dtype_name = dtype_name(dtype)
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

        arg_shapes, _, aux_shapes = symbol.infer_shape(
            **self._bucket_shapes(self._ladder[0]))
        inferred = dict(zip(arg_names, arg_shapes))
        inferred.update(zip(aux_names, aux_shapes))
        params = {}
        for name in self._weight_names + self._bound_aux:
            arr = self._freeze_one(name, arg_params.get(
                name, aux_params.get(name)))
            if tuple(arr.shape) != tuple(inferred[name]):
                raise ServingError(
                    "AOTPredictor: param %r has shape %s, the graph needs %s"
                    % (name, tuple(arr.shape), tuple(inferred[name])))
            params[name] = arr

        from ..ir import FoldPlan

        # extras are zero-filled per bucket (their shapes may carry the
        # batch dim), so for folding they are dynamic, like real data
        self._plan = FoldPlan(symbol,
                              set(self._data_names) | set(self._extra_names))
        self._fold_fn = self._plan.make_fold_fn()
        self._params = params
        with torch.inference_mode():
            self._consts = self._fold_fn(params)
        self._extra_shapes = {}   # bucket -> {extra name: shape}
        self.bind_stats = {
            "folded_nodes": self._plan.folded_nodes,
            "dynamic_nodes": self._plan.dynamic_nodes,
            "frozen_params": len(params),
            "zero_filled": list(self._extra_names),
            "ladder": self._ladder,
            "dtype": self._dtype_name,
            "quant": "none",
        }

    def _freeze_one(self, name, value):
        t = value.detach() if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        if t.is_floating_point():
            t = t.to(self._dtype)
        return t.to(self.device).contiguous()

    def _bucket_shapes(self, bucket):
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
        plan = self._plan
        nodes, node_ids, dyn = plan.nodes, plan.node_ids, plan.dyn
        const_index = plan.const_index
        zeros = {n: torch.zeros(s, dtype=torch.float32, device=self.device)
                 for n, s in self._zero_shapes(bucket).items()}
        results = {}

        def val(entry):
            inp, idx = entry
            if inp.is_variable():
                name = inp.name
                if name in data_vals:
                    return data_vals[name]
                if name in zeros:
                    return zeros[name]
                return consts[const_index[("var", name)]]
            nid = node_ids[id(inp)]
            if nid in dyn:
                return results[nid][idx]
            return consts[const_index[("node", nid, idx)]]

        for i, node in enumerate(nodes):
            if node.is_variable() or i not in dyn:
                continue
            results[i] = eval_node(node, [val(e) for e in node.inputs], False,
                                   INFERENCE_SEED, i)
        return [val(e) for e in plan.entries]

    # -- request surface ----------------------------------------------------
    @property
    def ladder(self):
        return self._ladder

    @property
    def max_bucket(self):
        return self._ladder[-1]

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def output_names(self):
        return self._sym.list_outputs()

    def pick_bucket(self, rows):
        """Smallest ladder bucket >= rows."""
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
        """Run one assembled batch of exactly ``bucket`` rows; returns the
        outputs as host numpy arrays, unsliced, float outputs as float32."""
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
        with the request's row count."""
        inputs, rows = self._normalize(inputs)
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
        new model, never a mix."""
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
