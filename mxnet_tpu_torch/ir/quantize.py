"""Int8 post-training quantization of the serving path (counterpart of
``mxnet_tpu/ir/quantize.py``).

1. **Calibrate**: run the unmodified graph over a few representative
   batches (``MXNET_QUANT_CALIB_BATCHES`` caps how many are consumed) and
   record the absmax of every activation entering a quantizable op; one
   symmetric per-tensor scale ``max(absmax / 127, 1e-12)`` a boundary.
2. **Rewrite**: a :class:`~.passes.RulePass` turns ``FullyConnected`` and
   ``Convolution`` into ``_quantize_int8(data) -> _int8_*``, the weight
   routed through an in-graph ``_quantize_rows_int8`` node. That node is a
   pure function of the weight variable, so the bind-time fold
   (``ir/fold.py``) evaluates it once per parameter set, and a hot swap
   requantizes the weights. The activation scales are calibration-time
   constants: a swap to weights whose activations moved far should rebind
   with fresh calibration data.
3. **Bind**: the rewritten symbol has the same argument and aux names, so
   it binds through ``AOTPredictor`` unchanged.

Only FC and 2-D convolution MACs are rewritten; a computed weight or bias
and a 1-D or 3-D convolution stay float. Calibration ranges land in
``profiler.pass_stats``; quantizing with no or empty calibration data
raises :class:`CalibrationError`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..base import MXNetError
from ..symbol.symbol import Symbol
from .match import Pat, node_attr
from .passes import RulePass
from .rules import Rule, _sym

_SCALE_FLOOR = 1e-12

# the ops the pass may rewrite; everything else stays float on purpose
QUANTIZABLE_OPS = ("FullyConnected", "Convolution")


class CalibrationError(MXNetError):
    """Quantization was asked for without usable calibration data (none,
    empty, or batches missing a model input)."""


def _target_nodes(symbol, exclude=()):
    """Topo-ordered ``(node, data_entry)`` of every quantizable op whose
    data and weight wiring the rewrite understands."""
    out = []
    for node in symbol._topo():
        if node.is_variable() or node.op.name not in QUANTIZABLE_OPS:
            continue
        if node.name in exclude:
            continue
        if len(node.inputs) < 2 or not node.inputs[1][0].is_variable():
            continue  # a computed weight stays float
        if len(node.inputs) > 2 and not node.inputs[2][0].is_variable():
            continue  # a computed bias: the rewrite needs a variable
        if node.op.name == "Convolution" \
                and len(tuple(node_attr(node, "kernel") or ())) != 2:
            continue  # _int8_convolution is 2-D only
        out.append((node, node.inputs[0]))
    return out


def normalize_calib_batches(calib_data, data_names):
    """A list of ``{input: array}`` dicts, one dict, or, for a one-input
    model, a list of arrays or one array. Returns a non-empty list of
    dicts or raises :class:`CalibrationError`."""
    if calib_data is None:
        raise CalibrationError(
            "int8 quantization needs calibration data (a list of "
            "{input: array} batches); got None")
    if isinstance(calib_data, (dict, np.ndarray)):
        calib_data = [calib_data]
    batches = []
    for b in calib_data:
        if not isinstance(b, dict):
            if len(data_names) != 1:
                raise CalibrationError(
                    "model has inputs %s: calibration batches must be "
                    "{name: array} dicts" % list(data_names))
            b = {data_names[0]: b}
        missing = sorted(set(data_names) - set(b))
        if missing:
            raise CalibrationError(
                "calibration batch is missing model inputs %s" % missing)
        batches.append({k: np.asarray(b[k]) for k in data_names})
    if not batches:
        raise CalibrationError(
            "int8 quantization needs at least one calibration batch; got "
            "an empty list")
    return batches


def _tensor(value, device):
    t = value.detach() if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(
            value.asnumpy() if hasattr(value, "asnumpy") else value))
    return t.to(device)


def calibrate(symbol, params, calib_batches, exclude=(), device=None):
    """Per-boundary activation scales from representative batches, the
    graph evaluated on ``device`` (``cuda`` when None, as every entry
    point of the package; it raises when there is no card).

    Returns ``(scales, report)``: ``scales`` maps a quantizable node's name
    to its float scale; ``report`` holds the absmax and scale of each
    (also published as ``profiler.pass_calibration`` gauges)."""
    from .. import profiler
    from ..context import resolve_device
    from ..executor import _graph_closure

    device = resolve_device(device)
    targets = _target_nodes(symbol, exclude)
    if not targets:
        return {}, {}
    owners = [node.name for node, _ in targets]
    sub = Symbol([entry for _, entry in targets])
    closure = _graph_closure(sub, is_train=False)
    needed = set(sub.list_inputs())
    values = {k: _tensor(v, device) for k, v in params.items()
              if k in needed}
    absmax = {name: 0.0 for name in owners}
    with torch.inference_mode():
        for batch in calib_batches:
            vals = dict(values)
            vals.update({k: _tensor(v, device) for k, v in batch.items()
                         if k in needed})
            missing = sorted(needed - set(vals))
            if missing:
                raise CalibrationError(
                    "calibration cannot evaluate the graph: unbound "
                    "variables %s (not in params or the batch)" % missing)
            outs, _aux = closure(vals)
            for name, out in zip(owners, outs):
                m = out.float().abs().max().item()
                if m > absmax[name]:
                    absmax[name] = m
    scales, report = {}, {}
    for name in owners:
        scale = max(absmax[name] / 127.0, _SCALE_FLOOR)
        scales[name] = scale
        report[name] = {"absmax": round(absmax[name], 6), "scale": scale,
                        "bits": 8}
        profiler.pass_calibration(name, absmax=absmax[name], scale=scale)
    return scales, report


class _QuantizeRule(Rule):
    """FC/conv -> the int8 pipeline, the scale looked up by node name
    (names survive the splice, node identities do not)."""

    name = "int8_rewrite"

    def __init__(self, scales):
        self._scales = scales

        def op_pat(opname, with_bias):
            ins = [Pat(name="x"), Pat.var("w")]
            if with_bias:
                ins.append(Pat.var("b"))
            return Pat(opname, inputs=ins, name="op",
                       where=lambda n: n.name in scales)

        self._patterns = tuple(op_pat(opname, wb)
                               for opname in QUANTIZABLE_OPS
                               for wb in (False, True))

    @property
    def pattern(self):
        return self._patterns[0]

    @property
    def patterns(self):
        return self._patterns

    def rewrite(self, m):
        from .. import symbol as sym

        node = m.node("op")
        scale = self._scales[node.name]
        xq = sym._quantize_int8(_sym(m["x"]), scale=scale,
                                name=node.name + "_xq")
        wq = sym._quantize_rows_int8(_sym(m["w"]), name=node.name + "_wq")
        kwargs = dict(data=xq, weight=wq[0], wscale=wq[1], scale=scale,
                      name=node.name)
        if "b" in m:
            kwargs["bias"] = _sym(m["b"])
        if node.op.name == "FullyConnected":
            for k in ("num_hidden", "no_bias", "flatten"):
                kwargs[k] = node_attr(node, k)
            return sym._int8_fully_connected(**kwargs)
        for k in ("kernel", "stride", "dilate", "pad", "num_filter",
                  "num_group", "no_bias"):
            kwargs[k] = node_attr(node, k)
        return sym._int8_convolution(**kwargs)


class QuantizePass(RulePass):
    """The ``quantize`` pass over calibrated ``scales`` (node name ->
    activation scale); its provenance adds ``quantized_ops``."""

    def __init__(self, scales):
        super().__init__("quantize", [_QuantizeRule(scales)])

    def apply(self, symbol):
        from .. import profiler

        symbol, prov = super().apply(symbol)
        if prov["rewrites"]:
            profiler.pass_record("quantize", quantized=prov["rewrites"])
        prov["quantized_ops"] = prov["rewrites"]
        return symbol, prov


def quantize_for_serving(symbol, params, calib_data, data_names,
                         exclude=(), device=None):
    """Calibrate and rewrite: the serving entry point.

    ``params`` is the whole ``{name: array}`` weight and aux dict of the
    unquantized graph, ``calib_data`` a list of representative input
    batches (:func:`normalize_calib_batches`), ``device`` where the
    calibration forward runs (``cuda`` when None). Returns
    ``(quantized_symbol, report)``; the symbol has the same argument and
    aux names, so any binder takes it."""
    batches = normalize_calib_batches(calib_data, data_names)
    # read (and validated) even for a single batch, so a malformed knob
    # raises
    batches = batches[:config.get_positive_int("MXNET_QUANT_CALIB_BATCHES")]
    scales, calib_report = calibrate(symbol, params, batches,
                                     set(exclude or ()), device)
    if not scales:
        return symbol, {"quantized_ops": 0, "calibration": {},
                        "note": "no quantizable ops in the graph"}
    qsym, prov = QuantizePass(scales).apply(symbol)
    return qsym, {"quantized_ops": prov["quantized_ops"],
                  "calibration": calib_report,
                  "calib_batches": len(batches), "provenance": prov}
