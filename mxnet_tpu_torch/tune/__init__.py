"""Schedule autotuner for the hand-written kernels (counterpart of
``mxnet_tpu/tune/``), keyed by backend ``"cuda"`` on the card and
``"cpu"`` for the plain versions.

Every tuned kernel takes its tile as a launch parameter: B1 and B3 their
channel block (``chan_block``), B2 its pixel split (``row_tile``), B5, B6
and B7 one ``(block_q, block_k)``. The kernel entry points
(``fused_block.conv_fwd`` / ``conv_wgrad`` / ``conv_dgrad``,
``flash_attention``) consult :func:`schedule_for` when they are called,
with the hand defaults as fallback, so an empty table runs the hand
defaults; ``MXNET_TPU_TUNE=0`` pins them.

- :mod:`.table`: the on-disk schedule table, the JAX package's JSON
  format: versioned records keyed ``(kernel, shape, dtype, backend)``,
  atomic writes, a process-local memo, the miss registry, and corrupt
  tables that log and behave as empty.
- :mod:`.harness`: round-robin timing with CUDA events, event and device
  time (wall time on the CPU).
- :mod:`.search`: candidates over the CUDA knob space, pruning before
  timing, timing, commits; ranked sweeps.
- :mod:`.model`: the learned cost model (ridge on log plan features,
  pure numpy), cross-validated per (kernel, backend), abstaining when
  under-trained.
- :mod:`.background`: :class:`BackgroundTuner`, bounded slots at
  ``Module.fit``'s drain boundaries (``MXNET_TUNE_BACKGROUND=1``).
- :mod:`.pipeline`: the remat x layout choice for ``TrainStep``, priced
  by the same model.

``python -m mxnet_tpu_torch.tune`` runs the sweep (``--compare``: the
exhaustive sweep, a model refit, then the ranked sweep);
``profiler.tuning_stats`` counts table hits, misses and fallbacks and
records each kernel's chosen schedule.
"""
from .table import (ScheduleTable, TABLE_VERSION, clear_misses,
                    default_backend, default_table_path, get_table,
                    make_key, recorded_misses, schedule_for)
from .table import reset as _reset_table
from .search import (CHAN_BLOCKS, FLASH_BLOCKS, FUSED_KINDS,
                     SWEEPABLE_KERNELS, flash_candidates, fused_candidates,
                     sweep_flash, sweep_for_key, sweep_fused)
from .model import (CostModel, CostModelError, MODEL_VERSION,
                    default_model_path, features_from_plan,
                    fit_cost_model, get_model, plan_for)
from .model import reset as _reset_model
from .background import BackgroundTuner
from .pipeline import (HAND_DEFAULT, LAYOUT_CODES, PIPELINE_KERNEL,
                       REMAT_CODES, build_train_step, candidate_pipelines,
                       choice_of, graph_fingerprint, pipeline_for,
                       pipeline_table_shape, schedule_of,
                       sweep_train_pipelines)


def reset():
    """Drop the process-global table, miss registry and cost model (tests,
    and long-lived processes that want to re-read the files)."""
    _reset_table()
    _reset_model()


def rule_kernels():
    """{IR rule name: kernel names it lands on}, from the IR rule
    registry: a fusion rule names the kernel family its rewrite consults,
    and the sweep takes those names in."""
    from ..ir.rules import registered_kernels

    return registered_kernels()


def sweepable_kernels():
    """Kernel names the default sweep covers: the built-in families plus
    every kernel a registered IR rule names (the CLI reports a rule-named
    kernel without a sweep recipe as unsweepable)."""
    names = list(SWEEPABLE_KERNELS)
    for kernels in rule_kernels().values():
        for k in kernels:
            if k not in names:
                names.append(k)
    return tuple(names)


__all__ = [
    "ScheduleTable", "TABLE_VERSION", "default_backend",
    "default_table_path", "get_table", "make_key", "reset", "schedule_for",
    "recorded_misses", "clear_misses",
    "CHAN_BLOCKS", "FLASH_BLOCKS", "FUSED_KINDS", "SWEEPABLE_KERNELS",
    "flash_candidates", "fused_candidates", "rule_kernels",
    "sweepable_kernels", "sweep_flash", "sweep_fused", "sweep_for_key",
    "BackgroundTuner", "CostModel", "CostModelError", "MODEL_VERSION",
    "default_model_path", "features_from_plan", "fit_cost_model",
    "get_model", "plan_for",
    "PIPELINE_KERNEL", "HAND_DEFAULT", "REMAT_CODES", "LAYOUT_CODES",
    "candidate_pipelines", "schedule_of", "choice_of",
    "graph_fingerprint", "pipeline_table_shape", "build_train_step",
    "sweep_train_pipelines", "pipeline_for",
]
