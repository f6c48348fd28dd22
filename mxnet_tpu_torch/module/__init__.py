"""``mx.mod``: Module on one context (counterpart of
``mxnet_tpu/module``). Not ported yet: ``BucketingModule``,
``SequentialModule``, ``PythonModule`` and the fused SPMD group."""
from .base_module import BaseModule  # noqa: F401
from .executor_group import DataParallelExecutorGroup  # noqa: F401
from .module import Module  # noqa: F401
