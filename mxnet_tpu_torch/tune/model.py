"""Learned cost model of the schedule autotuner (counterpart of
``mxnet_tpu/tune/model.py``; the same math, pure numpy).

A ridge regression on log plan-summary features ranks sweep candidates so
that only the top few are timed, and keeps learning from every timing the
table banks:

- **Featurization joins on ``search.plan_summary``.** A candidate's
  feature vector comes from the same ``grid/nb/th/bco/m/k/n/work/calls``
  summary the schedule table banks with each timing. For ``"cuda"`` (and
  ``"cpu"``) rows of the fused kinds the summary describes the CUDA
  kernel's grid and tile (``search.fused_plan``); flash attention maps
  ``(block_q, block_k)`` onto the same keys with the JAX package's block
  arithmetic, unchanged (:func:`plan_for`).
- **Grouped per (kernel, backend)** and cross-validated per group
  (k-fold, pooled Spearman rank correlation).
- **Abstains instead of guessing.** :meth:`CostModel.usable` is the
  ranked sweep's gate: a missing group, fewer than ``MIN_FIT_ROWS`` rows,
  or a validation rank correlation below ``CORR_FLOOR`` fall back to the
  exhaustive sweep.
- **Corruption-proof like the schedule table.** One versioned JSON file
  written atomically; a truncated, garbage or version-mismatched file
  logs, behaves as absent and is rewritten whole by the next fit;
  ``load(strict=True)`` raises :class:`CostModelError`.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading

import numpy as np

from .. import config
from ..base import MXNetError
from .search import FUSED_KINDS, fused_plan
from .table import atomic_write_bytes

log = logging.getLogger("mxnet_tpu_torch.tune")

MODEL_VERSION = 1

# the featurization contract: log-space values derived from the
# plan_summary keys (plus the per-axis grid dims, the grid product,
# and the whole-kernel MAC total — the dominant cross-shape
# predictor; the axis split matters because loop overhead scales with
# the contraction-axis block count, not just the product). Changing
# this list is a model-file version change — loads reject files whose
# feature list differs.
FEATURE_NAMES = ("m", "k", "n", "work", "calls", "grid", "g0", "g1",
                 "g2", "nb", "th", "bco", "total_work")

MIN_FIT_ROWS = 8      # fewer banked rows than this: the group abstains
CORR_FLOOR = 0.5      # validation Spearman below this: abstain
RIDGE_LAMBDA = 1e-1   # heavy-ish: training sets are small and noisy


class CostModelError(MXNetError):
    """Typed error for corrupt/version-mismatched cost-model files and
    insufficient-data refits (the loud paths; the ranked sweep itself
    always degrades to exhaustive instead of raising)."""


def default_model_path():
    """``MXNET_TUNE_MODEL`` when set, else next to the schedule table
    it learns from (``<table>.model.json``) — a test/tool that scopes
    the table to a tmp dir scopes the model with it."""
    override = config.get("MXNET_TUNE_MODEL")
    if override:
        return override
    from .table import default_table_path

    return default_table_path() + ".model.json"


def model_path_for(table):
    """Model path scoped to one :class:`ScheduleTable` instance:
    ``MXNET_TUNE_MODEL`` still wins, else the model lives next to THE
    table being swept — a sweep over a custom ``table=`` must not read
    or rewrite the default table's model file."""
    override = config.get("MXNET_TUNE_MODEL")
    if override:
        return override
    return table.path + ".model.json"


def group_key(kernel, backend):
    """The model's group key: prediction quality is cross-validated
    per (kernel, backend); a fit on CPU timings never ranks a card
    sweep."""
    return "%s|%s" % (kernel, backend)


# ---------------------------------------------------------------------------
# featurization (shared with search.plan_summary — the join contract)
# ---------------------------------------------------------------------------
def plan_for(kernel, shape, schedule):
    """A ``plan_summary``-shaped dict for any sweepable kernel at a
    table-key ``shape`` under ``schedule``: the one featurization entry
    point. Fused kernels go through ``search.fused_plan`` (the CUDA
    kernel's grid and tile, bfloat16's route); flash attention maps
    (block_q, block_k) onto the same keys: the per-block product is
    (block_q x d) @ (d x block_k) and the grid (batch*heads, q-blocks,
    k-blocks), the JAX package's arithmetic."""
    if kernel in FUSED_KINDS:
        n, h, wd, ci, co, k, stride = (int(d) for d in shape)
        return fused_plan(kernel, (n, h, wd, ci), (k, k, ci, co), stride,
                          schedule)
    if kernel == "flash_attention":
        b, h, sq, sk, d, causal = (int(v) for v in shape)
        bq = int(schedule["block_q"])
        bk = int(schedule["block_k"])
        qb = -(-sq // bq)
        kb = -(-sk // bk)
        if causal:
            # the kernel truncates the k-loop per q-block (causal costs
            # about half the FLOPs), so the feature is the visited k-block
            # count
            kb = max(1, (kb + 1) // 2)
        return {"grid": [b * h, qb, kb], "nb": 1, "th": bq, "bco": bk,
                "m": bq, "k": d, "n": bk, "work": bq * d * bk,
                "calls": 1}
    raise CostModelError("no featurization for kernel %r" % (kernel,))


def features_from_plan(plan):
    """Log-space feature vector (len == len(FEATURE_NAMES)) from a
    ``plan_summary`` dict — the shared representation table timings,
    bench_kernel records, and model inputs all reduce to."""
    dims = [max(int(d), 1) for d in plan.get("grid") or (1,)][:3]
    dims += [1] * (3 - len(dims))
    grid = 1
    for d in dims:
        grid *= d
    vals = (plan["m"], plan["k"], plan["n"], plan["work"], plan["calls"],
            grid, dims[0], dims[1], dims[2], plan.get("nb", 1),
            plan.get("th", 1), plan.get("bco", 1),
            float(plan["work"]) * float(plan["calls"]) * grid)
    return np.array([math.log(max(float(v), 1.0)) for v in vals],
                    np.float64)


# ---------------------------------------------------------------------------
# ridge + rank correlation (pure numpy)
# ---------------------------------------------------------------------------
def _ranks(v):
    v = np.asarray(v, np.float64)
    order = np.argsort(v, kind="mergesort")
    r = np.empty(len(v), np.float64)
    i = 0
    while i < len(v):
        j = i
        while j + 1 < len(v) and v[order[j + 1]] == v[order[i]]:
            j += 1
        r[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return r


def spearman(a, b):
    """Spearman rank correlation — the validation score: the ranker's
    job is ordering candidates, not predicting absolute ms."""
    ra, rb = _ranks(a), _ranks(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0 or sb == 0:
        return 0.0
    return float(((ra - ra.mean()) * (rb - rb.mean())).mean() / (sa * sb))


def _ridge_fit(X, y, lam=RIDGE_LAMBDA):
    mu = X.mean(0)
    sd = X.std(0)
    sd = np.where(sd == 0, 1.0, sd)
    Z = (X - mu) / sd
    ym = float(y.mean())
    A = Z.T @ Z + lam * max(len(y), 1) * np.eye(Z.shape[1])
    w = np.linalg.solve(A, Z.T @ (y - ym))
    return w, mu, sd, ym


def _ridge_predict(X, w, mu, sd, intercept):
    return ((X - mu) / sd) @ w + intercept


def _cv_corr(X, y, lam=RIDGE_LAMBDA):
    """k-fold cross-validation rank correlation: strided folds, pooled
    held-out predictions, one Spearman over the pool."""
    n = len(y)
    k = min(5, n)
    preds = np.empty(n, np.float64)
    idx = np.arange(n)
    for f in range(k):
        test = idx[f::k]
        train = np.setdiff1d(idx, test)
        w, mu, sd, b = _ridge_fit(X[train], y[train], lam)
        preds[test] = _ridge_predict(X[test], w, mu, sd, b)
    return spearman(preds, y)


def _valid_group(g):
    if not isinstance(g, dict):
        return False
    try:
        rows = g["rows"]
        corr = float(g["val_corr"])
        intercept = float(g["intercept"])
        w = np.asarray(g["weights"], np.float64)
        mu = np.asarray(g["mu"], np.float64)
        sd = np.asarray(g["sd"], np.float64)
    except (KeyError, TypeError, ValueError):
        return False
    if not (isinstance(rows, int) and not isinstance(rows, bool)
            and rows >= 1):
        return False
    nfeat = len(FEATURE_NAMES)
    if w.shape != (nfeat,) or mu.shape != (nfeat,) or sd.shape != (nfeat,):
        return False
    return bool(np.isfinite(w).all() and np.isfinite(mu).all()
                and np.isfinite(sd).all() and np.isfinite(corr)
                and np.isfinite(intercept))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class CostModel:
    """One on-disk cost-model file + its per-(kernel, backend) ridge
    groups. Mirrors :class:`ScheduleTable`'s load discipline: lazy,
    memo'd, corruption logs + behaves as absent."""

    def __init__(self, path=None):
        self.path = path or default_model_path()
        self._lock = threading.Lock()
        self._groups = None   # group_key -> group dict; None until loaded
        self.load_error = None

    # -- load / persist ----------------------------------------------------
    def _load_locked(self):
        if self._groups is not None:
            return
        self._groups = {}
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        except OSError as e:
            self.load_error = "unreadable: %s" % e
            log.warning("cost model %s unreadable (%s); ranker abstains "
                        "(exhaustive sweeps)", self.path, e)
            return
        try:
            data = json.loads(raw)
            if not isinstance(data, dict):
                raise ValueError("top level is %s, not an object"
                                 % type(data).__name__)
            version = data.get("version")
            if version != MODEL_VERSION:
                raise ValueError("version %r != %d" % (version,
                                                       MODEL_VERSION))
            if tuple(data.get("features") or ()) != FEATURE_NAMES:
                raise ValueError("feature list %r does not match this "
                                 "build's featurization"
                                 % (data.get("features"),))
            groups = data["groups"]
            if not isinstance(groups, dict):
                raise ValueError("groups is %s, not an object"
                                 % type(groups).__name__)
            loaded = {}
            for gk, g in groups.items():
                if not _valid_group(g):
                    raise ValueError("malformed group record for %r" % gk)
                loaded[gk] = dict(g)
        except (ValueError, KeyError, TypeError) as e:
            # corrupt/stale model: behave as ABSENT — ranked sweeps
            # abstain into the exhaustive path and the next fit
            # rewrites the whole file. Never crash a job.
            self.load_error = str(e)
            log.warning(
                "cost model %s is corrupt or from another version (%s); "
                "ranker abstains (exhaustive sweeps) — the next model "
                "fit rewrites it", self.path, e)
            return
        self._groups = loaded

    def reload(self):
        """Drop the memoized load so the next read re-reads the file —
        a long-lived process picking up an external refit (mirrors
        :meth:`ScheduleTable.reload`; the background tuner calls both
        once per drain slot)."""
        with self._lock:
            self._groups = None
            self.load_error = None

    def load(self, strict=False):
        """Force the lazy load; ``strict=True`` raises typed
        :class:`CostModelError` on a corrupt/mismatched file instead of
        the silent absent-fallback."""
        with self._lock:
            self._load_locked()
            if strict and self.load_error is not None:
                raise CostModelError("cost model %s: %s"
                                     % (self.path, self.load_error))
            return {gk: dict(g) for gk, g in self._groups.items()}

    def _persist_locked(self):
        payload = {"version": MODEL_VERSION,
                   "features": list(FEATURE_NAMES),
                   "groups": self._groups}
        data = json.dumps(payload, indent=1, sort_keys=True).encode("utf-8")
        d = os.path.dirname(os.path.abspath(self.path))
        if d:
            os.makedirs(d, exist_ok=True)
        atomic_write_bytes(self.path, data)
        self.load_error = None

    # -- prediction --------------------------------------------------------
    def usable(self, kernel, backend):
        """(ok, reason) — the ranked sweep's abstain gate for one
        (kernel, backend) group."""
        with self._lock:
            self._load_locked()
            g = self._groups.get(group_key(kernel, backend))
        if g is None:
            return False, ("no model for %s" % group_key(kernel, backend)
                           if not self.load_error
                           else "model unusable: %s" % self.load_error)
        if g["rows"] < MIN_FIT_ROWS:
            return False, ("%d rows < %d minimum"
                           % (g["rows"], MIN_FIT_ROWS))
        if g["val_corr"] < CORR_FLOOR:
            return False, ("validation rank correlation %.3f < %.2f floor"
                           % (g["val_corr"], CORR_FLOOR))
        return True, ""

    def predict(self, kernel, backend, plans):
        """Predicted ms-per-iter array for ``plans`` (plan_summary
        dicts), or None when the group is missing — callers that want
        the abstain semantics should gate on :meth:`usable` first."""
        with self._lock:
            self._load_locked()
            g = self._groups.get(group_key(kernel, backend))
        if g is None:
            return None
        if not plans:
            return np.zeros(0)
        X = np.stack([features_from_plan(p) for p in plans])
        logms = _ridge_predict(X, np.asarray(g["weights"], np.float64),
                               np.asarray(g["mu"], np.float64),
                               np.asarray(g["sd"], np.float64),
                               float(g["intercept"]))
        return np.exp(logms)

    def group(self, kernel, backend):
        with self._lock:
            self._load_locked()
            g = self._groups.get(group_key(kernel, backend))
            return dict(g) if g else None

    # -- fitting -----------------------------------------------------------
    def fit_rows(self, kernel, backend, plans, ms):
        """Fit one group from (plan_summary, measured ms) rows; raises
        typed :class:`CostModelError` below ``MIN_FIT_ROWS`` — the
        insufficient-data refit is a caller error when requested
        explicitly (the table-driven :meth:`fit_from_table` catches it
        per group and abstains instead)."""
        if len(plans) != len(ms):
            raise CostModelError("plans/ms length mismatch (%d vs %d)"
                                 % (len(plans), len(ms)))
        if len(plans) < MIN_FIT_ROWS:
            raise CostModelError(
                "cost model fit for %s needs >= %d rows, got %d"
                % (group_key(kernel, backend), MIN_FIT_ROWS, len(plans)))
        X = np.stack([features_from_plan(p) for p in plans])
        y = np.log(np.maximum(np.asarray(ms, np.float64), 1e-9))
        corr = _cv_corr(X, y)
        w, mu, sd, intercept = _ridge_fit(X, y)
        return {"rows": int(len(plans)), "val_corr": round(corr, 4),
                "weights": [float(v) for v in w],
                "mu": [float(v) for v in mu],
                "sd": [float(v) for v in sd],
                "intercept": float(intercept)}

    def fit_from_table(self, table=None):
        """Refit every (kernel, backend) group from the schedule
        table's banked timings and rewrite the model file whole
        (atomic). Groups with too few rows are skipped (they abstain
        at sweep time); per-group validation rank correlation rides
        ``profiler.tuning_stats`` as the predicted-vs-measured gauge.
        Returns ``{"fit": {group: val_corr}, "skipped": {group:
        reason}, "path": ...}``."""
        from .table import get_table

        table = table if table is not None else get_table()
        rows = {}     # group_key -> ([plans], [ms], kernel, backend)
        for rec in table.entries().values():
            kernel = rec.get("kernel")
            backend = rec.get("backend")
            if not kernel or not backend:
                continue
            gk = group_key(kernel, backend)
            bucket = rows.setdefault(gk, ([], [], kernel, backend))
            for plan, ms in _record_rows(rec):
                bucket[0].append(plan)
                bucket[1].append(ms)
        fit, skipped = {}, {}
        for gk, (plans, ms, kernel, backend) in sorted(rows.items()):
            try:
                fit[gk] = self.fit_rows(kernel, backend, plans, ms)
            except CostModelError as e:
                skipped[gk] = str(e)
        report = {"fit": {gk: g["val_corr"] for gk, g in fit.items()},
                  "skipped": skipped, "path": self.path}
        if fit:
            with self._lock:
                # merge-forward: refit groups overwrite, but groups
                # learned from OTHER tables survive — several tables
                # may share one model file via MXNET_TUNE_MODEL, and a
                # refit over table B must not erase table A's
                # validated groups (a corrupt file still loads as
                # empty, so it is still rewritten whole)
                self._load_locked()
                groups = dict(self._groups)
                groups.update(fit)
                self._groups = groups
                self._persist_locked()
            from .. import profiler

            profiler.tuning_record(model_refits=1, corr=report["fit"])
        return report


def _record_rows(rec):
    """(plan_summary, ms) training rows banked in one table record:
    every entry of its ``timings`` list, or, for a record without one,
    the winner and default measurements it carries. Rows the
    featurization cannot digest (a hand-edited or foreign-build plan
    dict, a non-numeric ms) are SKIPPED, per the module's corrupt-data-
    behaves-as-absent discipline — table loading validates only each
    record's top-level schedule, so bad banked rows must not escape as
    untyped errors from every refit over that table."""
    kernel = rec.get("kernel")
    shape = tuple(rec.get("shape") or ())
    out = []

    def _row(sched, ms, plan=None):
        try:
            ms = float(ms) if ms else 0.0
        except (TypeError, ValueError):
            return
        if not sched or not ms:
            return
        if plan is None and shape:
            try:
                plan = plan_for(kernel, shape, sched)
            except (CostModelError, ValueError, KeyError, TypeError):
                return
        if not isinstance(plan, dict):
            return
        try:
            features_from_plan(plan)
        except (KeyError, TypeError, ValueError):
            return
        out.append((plan, ms))

    timings = rec.get("timings")
    if timings:
        for t in timings:
            if isinstance(t, dict):
                _row(t.get("schedule"), t.get("ms_per_iter"),
                     t.get("plan"))
    else:
        _row(rec.get("schedule"), rec.get("ms_per_iter"))
        _row(rec.get("default_schedule"), rec.get("default_ms_per_iter"))
    return out


# ---------------------------------------------------------------------------
# process-global model (mirrors table.get_table)
# ---------------------------------------------------------------------------
_GLOBAL_LOCK = threading.Lock()
_GLOBAL = None  # (path, CostModel)


def get_model(path=None):
    """The process-global cost model for ``path`` (default:
    knob-resolved next to the schedule table)."""
    global _GLOBAL
    resolved = path or default_model_path()
    with _GLOBAL_LOCK:
        if _GLOBAL is None or _GLOBAL[0] != resolved:
            _GLOBAL = (resolved, CostModel(resolved))
        return _GLOBAL[1]


def reset():
    """Drop the process-global model — tests, and processes that want
    to pick up an externally refit model file."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None


def fit_cost_model(table=None, path=None):
    """Convenience: refit the (process-global) cost model from a
    schedule table's banked timings — the offline half of the learning
    loop (``python -m mxnet_tpu_torch.tune --compare`` calls this between
    its exhaustive and ranked passes). An explicit ``table`` scopes the
    model next to it (unless ``path``/``MXNET_TUNE_MODEL`` says
    otherwise)."""
    if path is None and table is not None:
        path = model_path_for(table)
    return get_model(path).fit_from_table(table)
