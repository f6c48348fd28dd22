"""Schedule search: candidate generation, pre-timing pruning, timing and
commits (counterpart of ``mxnet_tpu/tune/search.py``).

The knob space is the hand-written kernels' own, each tile a launch
parameter, under the JAX package's knob names (so a table holding
``"cuda"`` records loads in the JAX package with every record kept). On
``"cuda"`` (and ``"cpu"``, the plain versions of the same kernels) a knob
means what the CUDA kernel does with it:

- ``fused_fwd`` (B1) and ``fused_dgrad`` (B3): ``chan_block``, the output
  (B1) or input (B3) channels a CTA, 64 or 128 on the tensor cores; the
  CUDA-core route (float32, or channels not multiples of 8) takes 64 only.
- ``fused_wgrad`` (B2): ``row_tile``, the 64-pixel boxes a chunk of B2's
  pixel split on the tensor cores (candidates a factor of 2 and 4 either
  side of the hand default, and one chunk, within 65535 chunks and 256 MB
  of f32 partials); the CUDA-core route's split is fixed (``chan_block``
  64, its hand default, is its only schedule).
- ``flash_attention`` (B5, B6, B7): ``block_q`` x ``block_k``, one tile
  for the forward and both backward kernels, of
  ``kernels.flash_attention.FLASH_TC_TILES`` in bfloat16; float32 keeps
  (64, 64). ``batch_fold`` has no meaning here and is never generated.

Illegal candidates (a tile the kernels are not built for, one past the
sequence or the channels, a split out of range) are pruned **before**
timing, with the reason in the trajectory; the JAX package's
``MXU_WORK_FLOOR`` pruning has no counterpart. Timing is the round-robin
harness (:mod:`.harness`): on the card the winner is the least device
time, with the event time beside it; on the CPU the least wall time. A
re-run of a sweep whose key is in the table is a pure table hit.

**Ranked sweeps.** With ``MXNET_TUNE_RANKER=1`` (default) and a usable
cost model (:mod:`.model`), a sweep predicts every legal candidate's ms
and times only the top ``MXNET_TUNE_TOPK`` (the hand default always); the
rest are ``skipped_ranked``. The ranker abstains (an exhaustive sweep)
when the model is missing or corrupt, has fewer than
``model.MIN_FIT_ROWS`` rows for the (kernel, backend) group, or its
validation rank correlation is below ``model.CORR_FLOOR``. Every commit
banks all its timings in the table record and, in ranked mode, refits
the model.
"""
from __future__ import annotations

import time

import numpy as np

from ..kernels.flash_attention import FLASH_BLOCKS
from ..kernels.fused_block import CHAN_BLOCKS
from .table import backend_of, get_table, make_key

FUSED_KINDS = ("fused_fwd", "fused_wgrad", "fused_dgrad")

# every kernel family sweep_for_key can dispatch
SWEEPABLE_KERNELS = FUSED_KINDS + ("flash_attention",)
# B2's row_tile candidates: the hand default times these, and one chunk
ROW_TILE_FACTORS = (0.25, 0.5, 1, 2, 4)

SPREAD_BAR_PCT = 10.0


def _dtype(name):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(name)]


def _device(device):
    import torch

    return torch.device("cuda" if device is None else device)


def _kind(kernel):
    if kernel not in FUSED_KINDS:
        raise ValueError("kernel must be one of %s, got %r"
                         % (FUSED_KINDS, kernel))
    return kernel[len("fused_"):]


def _cdiv(a, b):
    return -(-a // b)


def plan_summary(plan):
    """JSON-ready summary of a plan: the keys the cost model featurizes
    (``grid/nb/th/bco/m/k/n/work/calls``, the JAX package's)."""
    return {"grid": [int(g) for g in plan["grid"]], "nb": int(plan["nb"]),
            "th": int(plan["th"]), "bco": int(plan["bco"]),
            "m": int(plan["m"]), "k": int(plan["k"]), "n": int(plan["n"]),
            "work": int(plan["work"]), "calls": int(plan["calls"])}


def fused_plan(kernel, x_shape, w_shape, stride, schedule,
               dtype="bfloat16"):
    """The CUDA kernel's grid and tile for one fused-conv schedule, as a
    plan summary: ``grid`` the CTAs, ``m x k x n`` one CTA's product per
    tap (``calls`` of them), ``th`` its pixel rows (B2: the boxes a
    chunk), ``bco`` its channel block, ``nb`` B2's chunks."""
    from ..kernels import fused_block as fb

    kind = _kind(kernel)
    n, h, wd, ci = (int(v) for v in x_shape)
    k, co = int(w_shape[0]), int(w_shape[3])
    tc = fb._route_tc(kind, _dtype(dtype), ci, co)
    ho, wo = h // stride, wd // stride
    bn = int(schedule.get("chan_block", 64))
    if kind == "fwd":
        tiles = fb.pixel_boxes(n, ho, wo) if tc else _cdiv(n * ho * wo, 64)
        plan = dict(grid=(tiles, _cdiv(co, bn), 1), nb=1, th=64, bco=bn,
                    m=64, k=ci, n=bn, calls=k * k)
    elif kind == "dgrad":
        cs = 2 if stride == 2 else 1
        hq, wq = h // cs, wd // cs
        tiles = cs * cs * (fb.pixel_boxes(n, hq, wq) if tc
                           else _cdiv(n * hq * wq, 64))
        plan = dict(grid=(tiles, _cdiv(ci, bn), 1), nb=1, th=64, bco=bn,
                    m=64, k=co, n=bn, calls=k * k)
    elif tc:
        split = fb.wgrad_split(n, h, wd, ci, co, k, stride,
                               int(schedule.get("row_tile", 0)))
        if split is None:
            raise ValueError("row_tile %r out of range" % (schedule,))
        _boxes, rt, chunks = split
        plan = dict(grid=(_cdiv(ci, 64) * k * _cdiv(co, 64), chunks, 1),
                    nb=chunks, th=rt, bco=64, m=64, k=64 * rt, n=64,
                    calls=k)
    else:
        plan = dict(grid=(1, k * k * _cdiv(ci, 64), _cdiv(co, 64)), nb=1,
                    th=1, bco=64, m=64, k=n * ho * wo, n=64, calls=1)
    plan["work"] = plan["m"] * plan["k"] * plan["n"]
    return plan_summary(plan)


def fused_candidates(kernel, x_shape, w_shape, stride=1, grid=None,
                     dtype="bfloat16"):
    """Search trajectory for one fused-conv kernel at one shape.

    Returns entries ``{"schedule", "status", ...}``: ``default`` (the
    hand tile, always timed), ``candidate``, ``pruned_illegal`` (with the
    reason) or ``pruned_duplicate`` (the default's or an earlier
    candidate's schedule). Nothing here is timed."""
    from ..kernels import fused_block as fb

    kind = _kind(kernel)
    dt = _dtype(dtype)
    n, h, wd, ci = (int(v) for v in x_shape)
    k, co = int(w_shape[0]), int(w_shape[3])
    default = fb.default_schedule(kind, x_shape, w_shape, stride, dt)
    if grid is None:
        if "row_tile" in default:
            r0 = default["row_tile"]
            boxes = fb.wgrad_split(n, h, wd, ci, co, k, stride)[0]
            values = {max(1, int(r0 * f)) for f in ROW_TILE_FACTORS}
            grid = [{"row_tile": r} for r in sorted(values | {boxes})]
        elif kind == "wgrad":
            grid = [{"chan_block": 64}]
        else:
            grid = [{"chan_block": c} for c in CHAN_BLOCKS]

    def plan(sched):
        return fused_plan(kernel, x_shape, w_shape, stride, sched, dtype)

    dplan = plan(default)
    seen = {tuple(sorted(default.items()))}
    entries = [{"schedule": dict(default), "status": "default",
                "work": dplan["work"], "plan": dplan}]
    for cand in grid:
        ok, reason = fb.schedule_legal(kind, x_shape, w_shape, stride, cand,
                                       dt)
        if not ok:
            entries.append({"schedule": dict(cand),
                            "status": "pruned_illegal", "reason": reason})
            continue
        p = plan(cand)
        entry = {"schedule": dict(cand), "work": p["work"], "plan": p}
        sig = tuple(sorted(cand.items()))
        entry["status"] = "pruned_duplicate" if sig in seen else "candidate"
        seen.add(sig)
        entries.append(entry)
    return entries


def flash_candidates(seq_q, seq_k, blocks=None, *, d=64,
                     dtype="bfloat16"):
    """Search trajectory for flash attention's ``(block_q, block_k)`` at
    one shape (``d`` the head dim, ``dtype`` the kernels' route): the hand
    default (64, 64) first, then :data:`FLASH_BLOCKS` squared. A tile the
    kernels are not built for, or a block past the sequence rounded up to
    64 (it would only pad: the decode shape, seq_q 1, keeps block_q 64),
    is pruned as illegal."""
    from ..kernels import flash_attention as fa

    dt = _dtype(dtype)
    if blocks is None:
        blocks = [dict(block_q=bq, block_k=bk)
                  for bq in FLASH_BLOCKS for bk in FLASH_BLOCKS]
    default = (fa.DEFAULT_BLOCK, fa.DEFAULT_BLOCK)
    seen = {default}
    entries = [{"schedule": dict(block_q=default[0], block_k=default[1]),
                "status": "default"}]
    for cand in blocks:
        bq, bk = int(cand["block_q"]), int(cand["block_k"])
        entry = {"schedule": dict(cand)}
        ok, reason = fa.tile_legal(d, dt, bq, bk, seq_q, seq_k)
        if ok and (bq > 64 * _cdiv(seq_q, 64) or bk > 64 * _cdiv(seq_k, 64)):
            ok, reason = False, ("blocks (%d, %d) pass the sequence (%d, %d) "
                                 "rounded up to 64" % (bq, bk, seq_q, seq_k))
        if not ok:
            entry["status"] = "pruned_illegal"
            entry["reason"] = reason
        elif (bq, bk) in seen:
            entry["status"] = "pruned_duplicate"
        else:
            seen.add((bq, bk))
            entry["status"] = "candidate"
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# ranked mode
# ---------------------------------------------------------------------------
def _resolve_ranker(ranked, topk):
    """Explicit args beat ``MXNET_TUNE_RANKER`` / ``MXNET_TUNE_TOPK`` (strict
    accessors: a malformed value raises naming the knob)."""
    from .. import config

    if ranked is None:
        ranked = config.get_strict_bool("MXNET_TUNE_RANKER")
    if topk is None:
        topk = config.get_positive_int("MXNET_TUNE_TOPK")
    return bool(ranked), int(topk)


def _apply_ranking(kernel, shape, dtype, backend, entries, topk, table,
                   cost_model=None):
    """Rank the legal candidates with the cost model and mark everything
    below the top ``topk`` ``skipped_ranked`` (predicted ms on every
    scored entry). Returns the ranker report: ``mode`` ``ranked``, or
    ``exhaustive`` with ``abstained`` and the reason."""
    from . import model as cost_model_mod
    from .. import profiler

    m = cost_model or cost_model_mod.get_model(
        cost_model_mod.model_path_for(table))
    cands = [e for e in entries if e["status"] == "candidate"]
    if not cands:
        return {"mode": "ranked", "abstained": False, "topk": topk,
                "n_scored": 0, "n_skipped": 0,
                "group": cost_model_mod.group_key(kernel, backend),
                "val_corr": None}
    ok, why = m.usable(kernel, backend)
    if not ok:
        profiler.tuning_record(ranker_abstains=1)
        return {"mode": "exhaustive", "abstained": True, "reason": why}
    plans = [e.get("plan") or cost_model_mod.plan_for(kernel, shape,
                                                      e["schedule"])
             for e in cands]
    pred = m.predict(kernel, backend, plans)
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
    return {"mode": "ranked", "abstained": False, "topk": topk,
            "n_scored": len(cands), "n_skipped": skipped,
            "group": cost_model_mod.group_key(kernel, backend),
            "val_corr": (m.group(kernel, backend) or {}).get("val_corr")}


def sweep_for_key(kernel, shape, dtype, *, backend=None, **kw):
    """Dispatch a sweep from a table key ``(kernel, shape, dtype)``: the
    background tuner's entry point (a recorded miss carries exactly
    these). ``backend`` picks the device: ``"cpu"`` times the plain
    versions, anything else the card."""
    shape = tuple(int(d) for d in shape)
    kw.setdefault("device", "cpu" if backend == "cpu" else "cuda")
    if kernel in FUSED_KINDS:
        n, h, wd, ci, co, k, stride = shape
        return sweep_fused(kernel, (n, h, wd, ci), (k, k, ci, co),
                           stride=stride, dtype=dtype, **kw)
    if kernel == "flash_attention":
        b, h, sq, sk, d, causal = shape
        return sweep_flash(b, h, sq, sk, d, causal=bool(causal),
                           dtype=dtype, **kw)
    raise ValueError("no sweep recipe for kernel %r" % (kernel,))


# ---------------------------------------------------------------------------
# timing + commit
# ---------------------------------------------------------------------------
def _rand(rng, shape, dtype, device, scale=1.0):
    import torch

    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device=device, dtype=_dtype(dtype) if isinstance(dtype, str)
            else dtype)


def _time_entries(entries, build_fn, budget, repeats, iters, target_sec,
                  min_iters, on_card):
    """Prepare and round-robin time the default entry and up to ``budget -
    1`` candidates; annotates the entries in place (``ms_per_iter``: device
    ms on the card, wall ms on the CPU; ``event_ms_per_iter`` on the card)
    and returns the timed ones. Budget truncation keeps the best predicted
    candidates when every one has a prediction, else the largest per-CTA
    work first (flash: block area)."""
    from . import harness

    searched = [e for e in entries if e["status"] == "candidate"]
    if searched and all("predicted_ms" in e for e in searched):
        searched.sort(key=lambda e: e["predicted_ms"])
    else:
        searched.sort(key=lambda e: -(e.get("work")
                                      or e["schedule"].get("block_q", 1)
                                      * e["schedule"].get("block_k", 1)))
    keep = max(0, budget - 1)
    for e in searched[keep:]:
        e["status"] = "skipped_budget"
    timed = [e for e in entries if e["status"] == "default"] \
        + searched[:keep]

    prepared = [(idx, harness.prepare_run(build_fn(e["schedule"]), iters,
                                          target_sec, min_iters, on_card))
                for idx, e in enumerate(timed)]
    runs = harness.time_round_robin(prepared, repeats)
    for idx, e in enumerate(timed):
        r = runs[idx]
        primary = r["device_ms"] if r["device_ms"] is not None else r["ms"]
        mean, spread = harness.summarize(primary)
        e["ms_per_iter"] = round(mean, 5)
        e["spread_pct"] = round(spread * 100, 2)
        e["spread_ok"] = spread * 100 <= SPREAD_BAR_PCT
        e["runs_ms"] = [round(v, 5) for v in primary]
        if r["device_ms"] is not None:
            e["event_ms_per_iter"] = round(harness.summarize(r["ms"])[0], 5)
        e["status"] = "timed" if e["status"] != "default" else "default"
    return timed


def _finish_sweep(kernel, shape, dtype, backend, entries, timed, table,
                  t_start=None, rank_info=None, refit=False):
    from . import model as cost_model_mod

    default = next(e for e in timed if e["status"] == "default")
    winner = min(timed, key=lambda e: e["ms_per_iter"])
    rec = {
        "schedule": dict(winner["schedule"]),
        "ms_per_iter": winner["ms_per_iter"],
        "spread_pct": winner["spread_pct"],
        "default_schedule": dict(default["schedule"]),
        "default_ms_per_iter": default["ms_per_iter"],
        "speedup_vs_default": round(
            default["ms_per_iter"] / winner["ms_per_iter"], 3)
        if winner["ms_per_iter"] else 1.0,
        # every timing is a cost-model training row, with the plan it is
        # featurized from
        "timings": [
            {"schedule": dict(e["schedule"]),
             "ms_per_iter": e["ms_per_iter"],
             "plan": e.get("plan") or cost_model_mod.plan_for(
                 kernel, shape, e["schedule"])}
            for e in timed],
    }
    if "event_ms_per_iter" in winner:
        rec["clock"] = "device"
        rec["event_ms_per_iter"] = winner["event_ms_per_iter"]
        rec["default_event_ms_per_iter"] = default["event_ms_per_iter"]
    else:
        rec["clock"] = "wall"
    table.record(kernel, shape, dtype, backend, rec)
    rec = table.entry(kernel, shape, dtype, backend) or rec
    report = {
        "key": make_key(kernel, shape, dtype, backend),
        "kernel": kernel, "shape": list(shape), "dtype": dtype,
        "backend": backend, "cache_hit": False,
        "trajectory": entries,
        "n_candidates": len(entries),
        "n_pruned": sum(1 for e in entries
                        if e["status"].startswith("pruned")),
        "n_timed": len(timed),
        "n_skipped_ranked": sum(1 for e in entries
                                if e["status"] == "skipped_ranked"),
        "ranker": rank_info or {"mode": "exhaustive", "abstained": False},
        "winner": rec,
    }
    if refit:
        try:
            fit_rep = cost_model_mod.get_model(
                cost_model_mod.model_path_for(table)).fit_from_table(table)
            report["model_refit"] = fit_rep["fit"]
        except cost_model_mod.CostModelError as e:
            report["model_refit_error"] = str(e)
    if t_start is not None:
        # after the refit: a ranked sweep's wall time carries its cost
        report["wall_s"] = round(time.perf_counter() - t_start, 4)
    return report


def _cache_hit_report(kernel, shape, dtype, backend, table, cached):
    return {"key": make_key(kernel, shape, dtype, backend),
            "kernel": kernel, "shape": list(shape), "dtype": dtype,
            "backend": backend, "cache_hit": True, "n_timed": 0,
            "winner": dict(cached)}


def _sweep(kernel, shape, dtype, backend, table, force, ranked, topk,
           cost_model, entries_fn, build_fn, budget, repeats, iters,
           target_sec, min_iters):
    if not force:
        cached = table.lookup(kernel, shape, dtype, backend)
        if cached is not None:
            return _cache_hit_report(kernel, shape, dtype, backend, table,
                                     table.entry(kernel, shape, dtype,
                                                 backend))
    t_start = time.perf_counter()
    ranked, topk = _resolve_ranker(ranked, topk)
    entries = entries_fn()
    rank_info = None
    if ranked:
        rank_info = _apply_ranking(kernel, shape, dtype, backend, entries,
                                   topk, table, cost_model)
    timed = _time_entries(entries, build_fn, budget, repeats, iters,
                          target_sec, min_iters, backend != "cpu")
    return _finish_sweep(kernel, shape, dtype, backend, entries, timed,
                         table, t_start=t_start, rank_info=rank_info,
                         refit=ranked)


def sweep_fused(kernel, x_shape, w_shape, stride=1, dtype="bfloat16", *,
                budget=8, repeats=5, iters=None, target_sec=0.3,
                min_iters=10, device=None, grid=None, table=None,
                force=False, ranked=None, topk=None, cost_model=None):
    """Search one fused-conv kernel at one shape on ``device`` (``cuda``
    unless given ``"cpu"``, which times the plain versions under backend
    ``"cpu"``); commit the winner. A key already in the table is a pure
    table hit unless ``force``. ``ranked``/``topk`` default to the
    ``MXNET_TUNE_RANKER`` / ``MXNET_TUNE_TOPK`` knobs."""
    from ..kernels import fused_block as fb

    dev = _device(device)
    backend = backend_of(dev)
    table = table if table is not None else get_table()  # empty is falsy
    n, h, wd, ci = (int(v) for v in x_shape)
    k, co = int(w_shape[0]), int(w_shape[3])
    shape = (n, h, wd, ci, co, k, stride)
    ho, wo = h // stride, wd // stride
    rng = np.random.RandomState(0)
    x = _rand(rng, (n, h, wd, ci), dtype, dev)
    w = _rand(rng, (k, k, ci, co), dtype, dev, 0.05)
    scale = _rand(rng, (ci,), "float32", dev, 0.1) + 1.0
    bias = _rand(rng, (ci,), "float32", dev, 0.1)
    g = _rand(rng, (n, ho, wo, co), dtype, dev)

    def build_fn(sched):
        if kernel == "fused_fwd":
            return lambda: fb.conv_fwd(x, w, stride=stride,
                                       prologue=(scale, bias, True),
                                       emit_stats=True, schedule=sched)
        if kernel == "fused_wgrad":
            return lambda: fb.conv_wgrad(x, g, (k, k, ci, co), stride=stride,
                                         x_prologue=(scale, bias, True),
                                         schedule=sched)
        return lambda: fb.conv_dgrad(g, w, (n, h, wd, ci), stride=stride,
                                     schedule=sched)

    return _sweep(kernel, shape, dtype, backend, table, force, ranked, topk,
                  cost_model,
                  lambda: fused_candidates(kernel, x_shape, w_shape, stride,
                                           grid=grid, dtype=dtype),
                  build_fn, budget, repeats, iters, target_sec, min_iters)


def sweep_flash(b, h, seq_q, seq_k, d, causal=False, dtype="float32", *,
                budget=8, repeats=5, iters=None, target_sec=0.3,
                min_iters=10, device=None, blocks=None, table=None,
                force=False, ranked=None, topk=None, cost_model=None):
    """Search flash attention's ``(block_q, block_k)`` at one shape on
    ``device`` and commit the winner. Times the forward kernel B5 (the
    backward kernels take the same tile), as the JAX package does.
    ``ranked``/``topk`` as in :func:`sweep_fused`."""
    from ..kernels.flash_attention import flash_attention

    dev = _device(device)
    backend = backend_of(dev)
    table = table if table is not None else get_table()  # empty is falsy
    shape = (b, h, seq_q, seq_k, d, int(bool(causal)))
    rng = np.random.RandomState(0)
    q = _rand(rng, (b, h, seq_q, d), dtype, dev)
    k = _rand(rng, (b, h, seq_k, d), dtype, dev)
    v = _rand(rng, (b, h, seq_k, d), dtype, dev)

    def build_fn(sched):
        return lambda: flash_attention(q, k, v, causal=bool(causal),
                                       block_q=sched["block_q"],
                                       block_k=sched["block_k"])

    return _sweep("flash_attention", shape, dtype, backend, table, force,
                  ranked, topk, cost_model,
                  lambda: flash_candidates(seq_q, seq_k, blocks=blocks, d=d,
                                           dtype=dtype),
                  build_fn, budget, repeats, iters, target_sec, min_iters)
