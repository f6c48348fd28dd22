"""``mx.mod``: the Module front end on one context a process (counterpart
of ``mxnet_tpu/module``): ``Module``, ``BucketingModule`` (one graph a
bucket key over one shared set of parameters), ``SequentialModule``,
``PythonModule`` and ``PythonLossModule``, and the executor groups."""
from .base_module import BaseModule  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .executor_group import DataParallelExecutorGroup  # noqa: F401
from .module import Module  # noqa: F401
from .python_module import PythonLossModule, PythonModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401
