"""Training-pipeline ranking: remat x layout choices for ``TrainStep``,
priced by the learned cost model (counterpart of
``mxnet_tpu/tune/pipeline.py``).

The kernel sweeps rank tiles of one kernel; the same machinery prices a
graph-level choice: should this training graph run with remat, with the
layout pass? The JAX package featurizes each candidate from XLA's own
analyses of the compiled step (``memory_analysis``, ``cost_analysis``).
The port has no XLA and nothing is compiled, so :func:`featurize` reads
what the port measures of one step of the candidate instead, mapped onto
the same ``plan_summary`` keys so that one :class:`~.model.CostModel`
learns both levels:

- ``m``: the bytes autograd keeps for the backward
  (``TrainStep.residual_stats``' ``residual_bytes``), ``k``: their count
  (``n_residuals``);
- ``n``: the hand-written kernels launched in one step (B1, B2, B3, B5,
  B6, B7 together: 0 on the CPU, where the plain versions run);
- ``work``: the bytes of the step's carry, params, optimizer state and
  aux (``TrainStep.memory_stats``);
- ``calls``: the graph's operator nodes; ``nb`` / ``th``: the remat
  plan's saved / recomputed nodes (``pass_stats``' ``remat`` counters,
  here from the plan) plus one; ``bco``: the layout pass's cancelled
  transposes (``pass_stats``' ``layout`` counter) plus one.

Discipline is the kernel sweeps':

- **abstain to the default**: no model, too few rows or a validation
  correlation below the floor makes the sweep time every candidate, and
  the consult (:func:`pipeline_for`) returns the hand default;
- **one table**: winners commit to the shared schedule table under the
  kernel name ``train_pipeline``, keyed by a structural graph fingerprint
  folded into the shape (node names excluded, the JAX package's md5, so a
  fingerprint is the same in both packages); banked timings embed their
  feature plans;
- **no miss registry**: a pipeline miss is a fallback, not background
  work.
"""
from __future__ import annotations

import hashlib
import time

from .. import config
from ..base import MXNetError
from .table import backend_of, dtype_name, get_table, make_key

PIPELINE_KERNEL = "train_pipeline"

# schedule codes (table schedules are ints >= 1)
REMAT_CODES = {"off": 1, "pass": 2, "conv": 3}
LAYOUT_CODES = {"off": 1, "on": 2}
_REMAT_NAMES = {v: k for k, v in REMAT_CODES.items()}
_LAYOUT_NAMES = {v: k for k, v in LAYOUT_CODES.items()}

# the abstain-mode choice: TrainStep's defaults
HAND_DEFAULT = {"remat": "off", "layout": "off"}


def candidate_pipelines():
    """The pipeline space: remat off|pass|conv x layout off|on."""
    return [{"remat": r, "layout": l}
            for r in ("off", "pass", "conv")
            for l in ("off", "on")]


def schedule_of(choice):
    """A pipeline choice as a table schedule (known int knobs)."""
    try:
        return {"remat": REMAT_CODES[choice["remat"]],
                "layout": LAYOUT_CODES[choice["layout"]]}
    except KeyError as e:
        raise MXNetError("unknown pipeline choice field/value: %s in %r"
                         % (e, choice))


def choice_of(schedule):
    """A table schedule back as a pipeline choice; unknown codes raise (a
    corrupt entry must not train differently)."""
    try:
        return {"remat": _REMAT_NAMES[int(schedule["remat"])],
                "layout": _LAYOUT_NAMES[int(schedule["layout"])]}
    except (KeyError, TypeError, ValueError):
        raise MXNetError("not a pipeline schedule: %r" % (schedule,))


def graph_fingerprint(symbol):
    """Structural md5 over the graph: op names, sorted attrs, arity and
    input topology indices; node names excluded, so two builds of the same
    architecture share a table entry."""
    h = hashlib.md5()
    nodes = symbol._topo()
    index = {id(n): i for i, n in enumerate(nodes)}
    for n in nodes:
        if n.is_variable():
            h.update(b"var;")
            continue
        h.update(n.op.name.encode())
        for k in sorted(n.attrs):
            h.update(("|%s=%s" % (k, n.attrs[k])).encode())
        for inp, idx in n.inputs:
            h.update(("|%d.%d" % (index[id(inp)], idx)).encode())
        h.update(b";")
    return h.hexdigest()


def pipeline_table_shape(symbol, batch_shape):
    """The table-key shape: the fingerprint's leading 32 bits as an int
    dim, then the data batch shape."""
    return (int(graph_fingerprint(symbol)[:8], 16),) + tuple(
        int(d) for d in batch_shape)


def featurize(stats, n_nodes, n_save=0, n_recompute=0,
              transposes_cancelled=0):
    """One candidate's measurements on the ``plan_summary`` keys (the
    module docstring maps them); values are floored to 1 inside
    ``features_from_plan``."""
    return {
        "m": int(stats.get("residual_bytes", 0)),
        "k": int(stats.get("n_residuals", 0)),
        "n": int(stats.get("launches", 0)),
        "work": int(stats.get("carry_bytes", 0)),
        "calls": int(n_nodes),
        "grid": (1, 1, 1),
        "nb": int(n_save) + 1,
        "th": int(n_recompute) + 1,
        "bco": int(transposes_cancelled) + 1,
    }


def _step_kwargs(choice):
    """TrainStep keyword arguments realizing a pipeline choice."""
    remat = choice["remat"]
    return {
        "remat": False if remat == "off" else remat,
        "train_passes": ("layout",) if choice["layout"] == "on" else (),
    }


def build_train_step(symbol, optimizer, choice, **kw):
    """A TrainStep realizing ``choice`` over ``symbol`` (also how a caller
    applies :func:`pipeline_for`'s decision)."""
    from ..parallel.spmd import TrainStep

    merged = dict(kw)
    merged.update(_step_kwargs(choice))
    return TrainStep(symbol, optimizer, **merged)


def _launches():
    from ..kernels import flash_attention as fa, fused_block as fb

    return (fb.conv_fwd.launches + fb.conv_wgrad.launches
            + fb.conv_dgrad.launches + fa.flash_attention.launches
            + fa.flash_attention_bwd_dq.launches
            + fa.flash_attention_bwd_dkv.launches)


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _build_candidate(symbol, optimizer, choice, batch, data_shapes, seed,
                     step_kw):
    """Build one candidate and run one step of it: ``(TrainStep, carry,
    stats, plan)``, the plan its featurization."""
    from .. import profiler

    before = profiler.pass_stats().get("passes", {}).get(
        "layout", {}).get("transposes_cancelled", 0)
    ts = build_train_step(symbol, optimizer, choice, **step_kw)
    cancelled = profiler.pass_stats().get("passes", {}).get(
        "layout", {}).get("transposes_cancelled", 0) - before
    params, opt_state, aux = ts.init_params(data_shapes, seed=seed)
    carry = ts.place(params, opt_state, aux)
    stats = dict(ts.residual_stats(carry[0], carry[2], batch))
    mem = ts.memory_stats(carry)
    stats["carry_bytes"] = (mem["param_bytes_per_dev"]
                            + mem["opt_bytes_per_dev"]
                            + mem["aux_bytes_per_dev"])
    n0 = _launches()
    carry, loss = ts(carry, batch)       # warm-up, and the launch count
    _sync(ts.device)
    stats["launches"] = _launches() - n0
    n_nodes = sum(1 for n in ts.symbol._topo() if not n.is_variable())
    plan = featurize(
        stats, n_nodes,
        n_save=ts._remat_plan.n_save if ts._remat_plan else 0,
        n_recompute=ts._remat_plan.n_recompute if ts._remat_plan else 0,
        transposes_cancelled=cancelled)
    return ts, carry, stats, plan


def _time_candidate(ts, carry, batch, steps):
    """Mean ms a step over ``steps`` steps after the warm one."""
    t0 = time.perf_counter()
    for _ in range(steps):
        carry, loss = ts(carry, batch)
    _sync(ts.device)
    return (time.perf_counter() - t0) * 1e3 / max(steps, 1)


def sweep_train_pipelines(symbol, optimizer, batch, *, table=None,
                          ranked=None, topk=None, steps=3, seed=0,
                          data_names=("data",), step_kw=None):
    """Build, featurize and run every candidate pipeline for ``symbol``,
    rank with the cost model (abstain: exhaustive), time the survivors
    end to end, commit the winner to the schedule table and refit the
    model: the graph-level mirror of ``search.sweep_fused``. ``batch`` is
    a dict of arrays for the data and label names; the device is
    ``step_kw``'s ``device`` (``cuda`` unless ``"cpu"``), and the backend
    follows it. Returns the sweep report."""
    import numpy as np

    from . import model as cost_model_mod
    from .. import profiler
    from ..context import resolve_device
    from .search import _resolve_ranker

    t_start = time.perf_counter()
    table = table if table is not None else get_table()
    ranked, topk = _resolve_ranker(ranked, topk)
    step_kw = dict(step_kw or {})
    step_kw.setdefault("data_names", tuple(data_names))
    backend = backend_of(resolve_device(step_kw.get("device")))
    data_shapes = {n: tuple(batch[n].shape) for n in step_kw["data_names"]}
    first = step_kw["data_names"][0]
    shape = pipeline_table_shape(symbol, data_shapes[first])
    dtype = dtype_name(getattr(batch[first], "dtype", "float32"))

    entries = []
    for choice in candidate_pipelines():
        status = "default" if choice == HAND_DEFAULT else "candidate"
        entries.append({"choice": dict(choice),
                        "schedule": schedule_of(choice), "status": status})

    built = {}
    for e in entries:
        ts, carry, stats, plan = _build_candidate(
            symbol, optimizer, e["choice"], batch, data_shapes, seed,
            step_kw)
        built[id(e)] = (ts, carry)
        e["plan"] = plan
        e["residual_bytes"] = stats.get("residual_bytes", 0)

    cands = [e for e in entries if e["status"] == "candidate"]
    rank_info = {"mode": "exhaustive", "abstained": False}
    if ranked:
        m = cost_model_mod.get_model(cost_model_mod.model_path_for(table))
        ok, why = m.usable(PIPELINE_KERNEL, backend)
        if not ok:
            profiler.tuning_record(ranker_abstains=1)
            rank_info = {"mode": "exhaustive", "abstained": True,
                         "reason": why}
        else:
            pred = m.predict(PIPELINE_KERNEL, backend,
                             [e["plan"] for e in cands])
            order = np.argsort(pred, kind="mergesort")
            keep = set(int(i) for i in order[:topk])
            skipped = 0
            for i, e in enumerate(cands):
                e["predicted_ms"] = round(float(pred[i]), 6)
                if i not in keep:
                    e["status"] = "skipped_ranked"
                    skipped += 1
            profiler.tuning_record(candidates_ranked=len(cands),
                                   timings_skipped=skipped)
            rank_info = {
                "mode": "ranked", "abstained": False, "topk": topk,
                "n_scored": len(cands), "n_skipped": skipped,
                "group": cost_model_mod.group_key(PIPELINE_KERNEL,
                                                  backend),
                "val_corr": (m.group(PIPELINE_KERNEL, backend)
                             or {}).get("val_corr")}

    timed = [e for e in entries if e["status"] in ("default", "candidate")]
    for e in timed:
        ts, carry = built[id(e)]
        e["ms_per_iter"] = round(_time_candidate(ts, carry, batch, steps), 5)

    default = next(e for e in timed if e["status"] == "default")
    winner = min(timed, key=lambda e: e["ms_per_iter"])
    rec = {
        "schedule": dict(winner["schedule"]),
        "ms_per_iter": winner["ms_per_iter"],
        "default_schedule": dict(default["schedule"]),
        "default_ms_per_iter": default["ms_per_iter"],
        "speedup_vs_default": round(
            default["ms_per_iter"] / winner["ms_per_iter"], 3)
        if winner["ms_per_iter"] else 1.0,
        "timings": [{"schedule": dict(e["schedule"]),
                     "ms_per_iter": e["ms_per_iter"],
                     "plan": dict(e["plan"])} for e in timed],
    }
    table.record(PIPELINE_KERNEL, shape, dtype, backend, rec)
    key = make_key(PIPELINE_KERNEL, shape, dtype, backend)
    profiler.tuning_record(kernel=key, schedule=dict(winner["schedule"]),
                           source="sweep")
    report = {
        "key": key, "kernel": PIPELINE_KERNEL, "shape": list(shape),
        "dtype": dtype, "backend": backend,
        "fingerprint": graph_fingerprint(symbol),
        "trajectory": [
            {k: v for k, v in e.items() if k != "plan"} for e in entries],
        "n_candidates": len(entries),
        "n_timed": len(timed),
        "n_skipped_ranked": sum(1 for e in entries
                                if e["status"] == "skipped_ranked"),
        "ranker": rank_info,
        "winner": {"choice": dict(winner["choice"]),
                   "schedule": dict(winner["schedule"]),
                   "ms_per_iter": winner["ms_per_iter"],
                   "speedup_vs_default": rec["speedup_vs_default"]},
    }
    try:
        fit_rep = cost_model_mod.fit_cost_model(table)
        report["model_refit"] = fit_rep["fit"]
    except cost_model_mod.CostModelError as e:
        report["model_refit_error"] = str(e)
    report["wall_s"] = round(time.perf_counter() - t_start, 4)
    return report


def pipeline_for(symbol, batch_shape, dtype="float32", backend=None,
                 table=None):
    """The consult: the committed pipeline choice for this graph
    fingerprint and batch shape, or the hand default. Returns ``(choice,
    source)``, source ``"table"`` or ``"default"``. Tuning disabled, no
    entry, or an undecodable schedule give :data:`HAND_DEFAULT` and count
    a fallback; a miss never becomes background work."""
    from .. import profiler
    from .table import default_backend

    if not config.get_bool("MXNET_TPU_TUNE", True):
        return dict(HAND_DEFAULT), "default"
    if backend is None:
        backend = default_backend()
    table = table if table is not None else get_table()
    shape = pipeline_table_shape(symbol, batch_shape)
    key = make_key(PIPELINE_KERNEL, shape, str(dtype), backend)
    sched = table.lookup(PIPELINE_KERNEL, shape, str(dtype), backend,
                         record_stats=False)
    if sched is None:
        profiler.tuning_record(misses=1, fallbacks=1)
        return dict(HAND_DEFAULT), "default"
    try:
        choice = choice_of(sched)
    except MXNetError:
        profiler.tuning_record(fallbacks=1)
        return dict(HAND_DEFAULT), "default"
    profiler.tuning_record(hits=1, kernel=key, schedule=dict(sched),
                           source="table")
    return choice, "table"
