"""Graph-level IR passes of the PyTorch port (counterpart of
``mxnet_tpu/ir``): the pattern matcher (:mod:`.match`), the ``fusion``
pass and its pipeline (:mod:`.passes`), its rules (:mod:`.rules`) and the
bind-time fold split (:mod:`.fold`). The ``residual``, ``layout`` and
``quantize`` passes and ``remat`` are not ported yet."""
from .fold import FoldPlan  # noqa: F401
from .match import Match, Pat, match, node_attr  # noqa: F401
from .passes import (  # noqa: F401
    PASSES,
    PassError,
    RulePass,
    apply_passes,
    splice,
)
from .rules import Rule, fusion_rules  # noqa: F401
