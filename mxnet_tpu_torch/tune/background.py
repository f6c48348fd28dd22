"""Background tuning inside training jobs (counterpart of
``mxnet_tpu/tune/background.py``).

A :class:`BackgroundTuner`, armed by ``MXNET_TUNE_BACKGROUND=1``, takes
**bounded slots at drain boundaries**: ``Module.fit`` calls
:meth:`on_drain` right after the epoch-end ``get_params``, which waited
for the card, so a slot never overlaps a step. A slot times one ranked
candidate set for a shape the job ran.

- **Bounded.** One missed key a slot, at most ``MXNET_TUNE_BG_BUDGET``
  timed programs (the hand default included), short calibration targets.
- **Nothing to do costs nothing.** The work queue is the schedule table's
  miss registry (``table.recorded_misses``, filled by the kernels'
  consults), so a job whose shapes are all tuned, or that runs no tuned
  kernel, pays nothing. ``MXNET_TPU_TUNE=0`` disables the consult and
  therefore the tuner.
- **Never crashes training.** A failed sweep logs, drops the miss, and
  the job goes on; commits go through the table's atomic, re-reading
  write, so two jobs sharing one table keep each other's winners.

A winner commits atomically, so the next call of that shape (and any later
job) runs it.
"""
from __future__ import annotations

import logging
import os

from .. import config, profiler
from . import search
from .table import clear_miss, get_table, recorded_misses

log = logging.getLogger("mxnet_tpu_torch.tune")


def _rank():
    """This process's rank: the launcher's ``DMLC_WORKER_ID`` /
    ``DMLC_RANK``, else ``torch.distributed``'s when it is initialized."""
    raw = os.environ.get("DMLC_WORKER_ID") or os.environ.get("DMLC_RANK")
    if raw is not None:
        try:
            return int(raw)
        except ValueError:
            return 0
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class BackgroundTuner:
    """Takes bounded tuning slots at a training job's drain boundaries;
    see the module docstring for the safety contract. ``sweep_kw``
    overrides the slot's timing (repeats, target_sec, min_iters); a
    miss's backend picks its device (``"cpu"`` times the plain
    versions)."""

    def __init__(self, budget=2, table=None, logger=None, sweep_kw=None):
        self.budget = int(budget)
        self._table = table if table is not None else get_table()
        self._log = logger or log
        self._sweep_kw = dict(sweep_kw or {})

    @staticmethod
    def _slot_kw(backend):
        """A slot's timing: short targets and two repeats (a sliver of an
        epoch, not a bench run)."""
        on_card = backend != "cpu"
        return dict(repeats=2, target_sec=0.2 if on_card else 0.02,
                    min_iters=10 if on_card else 2)

    @classmethod
    def from_env(cls, logger=None):
        """The arming gate ``Module.fit`` consults: a tuner when
        ``MXNET_TUNE_BACKGROUND=1`` (strict bool: a malformed value raises
        naming the knob), else None. ``MXNET_TPU_TUNE=0`` also disarms (no
        consult, no misses). Only rank 0 of a multi-process job arms: the
        ranks run the same shapes, and one winner serves them all."""
        if not config.get_strict_bool("MXNET_TUNE_BACKGROUND"):
            return None
        if not config.get_bool("MXNET_TPU_TUNE", True):
            return None
        if _rank() != 0:
            return None
        return cls(budget=config.get_positive_int("MXNET_TUNE_BG_BUDGET"),
                   logger=logger)

    def pending(self):
        """Misses with a sweep recipe that the table has not satisfied
        yet, oldest first. Re-reads the table file (one bounded read), so
        another job's commits clear their misses; misses without a recipe
        are dropped."""
        from . import model as cost_model_mod

        self._table.reload()
        cost_model_mod.get_model(
            cost_model_mod.model_path_for(self._table)).reload()
        out = []
        for miss in recorded_misses():
            if miss["kernel"] not in search.SWEEPABLE_KERNELS:
                clear_miss(miss["key"])
                continue
            if self._table.lookup(miss["kernel"], miss["shape"],
                                  miss["dtype"], miss["backend"],
                                  record_stats=False) is not None:
                clear_miss(miss["key"])
                continue
            out.append(miss)
        return out

    def on_drain(self):
        """One bounded slot: sweep the oldest pending miss (ranked when
        the model is usable) and commit the winner. Returns the sweep
        report, or None when nothing was pending or the sweep failed (an
        exception never reaches the training job)."""
        for miss in self.pending():
            profiler.tuning_record(bg_slots=1)
            kw = dict(self._slot_kw(miss["backend"]), **self._sweep_kw)
            try:
                rep = search.sweep_for_key(
                    miss["kernel"], miss["shape"], miss["dtype"],
                    backend=miss["backend"], table=self._table,
                    budget=self.budget, **kw)
            except Exception as e:   # noqa: BLE001 - never crash training
                clear_miss(miss["key"])
                self._log.warning("background tune of %s failed: %s",
                                  miss["key"], e)
                return None
            clear_miss(miss["key"])
            profiler.tuning_record(bg_commits=1)
            self._log.info(
                "background tune committed %s -> %s (%d timed, %.2fs)",
                miss["key"], rep["winner"]["schedule"], rep["n_timed"],
                rep.get("wall_s") or 0.0)
            return rep
        return None
