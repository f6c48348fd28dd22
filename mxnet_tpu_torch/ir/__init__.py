"""Graph-level IR passes of the PyTorch port (counterpart of
``mxnet_tpu/ir``): the pattern matcher (:mod:`.match`), the passes and
their pipeline (:mod:`.passes`: ``fusion``, ``residual``, ``layout``,
``quantize``), the rule registry (:mod:`.rules`), the layout rules
(:mod:`.layout`), the selective-remat plan of a training graph
(:mod:`.remat`), the bind-time fold split (:mod:`.fold`) and int8
post-training quantization for serving (:mod:`.quantize`:
``quantize_for_serving``, ``CalibrationError``)."""
from .fold import FoldPlan  # noqa: F401
from .match import Match, Pat, match, node_attr  # noqa: F401
from .passes import (  # noqa: F401
    PASSES,
    LayoutPass,
    Pass,
    PassError,
    PassManager,
    RulePass,
    apply_passes,
    splice,
)
from .rules import (  # noqa: F401
    Rule,
    fusion_rules,
    get_rule,
    list_rules,
    register_rule,
    residual_rules,
)
from .layout import layout_rules  # noqa: F401
from .remat import SAVE_OPS, RematPlan, plan_remat  # noqa: F401
from .quantize import (  # noqa: F401
    QUANTIZABLE_OPS,
    CalibrationError,
    QuantizePass,
    calibrate,
    quantize_for_serving,
)
