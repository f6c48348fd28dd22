"""Serving on PyTorch (counterpart of ``mxnet_tpu/serving``): the
bound-symbol :class:`AOTPredictor` behind the dynamic-batching
:class:`ModelServer`, generative serving (paged KV cache, prefill +
decode, the continuous-batching :class:`GenerateServer` with its
shared-prefix KV cache and speculative decoding), and the fleet on one
host: tracker-discovered :class:`ReplicaServer` endpoints behind a
retrying :class:`FleetRouter` with zero-drop rolling swap, the
:class:`FleetAutoscaler` and the :class:`QosPolicy` of per-tenant quotas
and priority classes."""
from .broker import (
    DeadlineExceeded,
    GenerateServer,
    ModelServer,
    ReplicaDraining,
    ServerClosed,
    ServerOverloaded,
)
from .generate import (
    GenerateError,
    GenerativePredictor,
    PagePool,
    PagePoolExhausted,
    PrefixIndex,
)
from .predictor import (DEFAULT_LADDER, AOTPredictor,  # noqa: F401
                        ServingError, env_batch_ladder, validate_ladder)
from .fleet import (
    FleetError,
    FleetOverloaded,
    FleetRemoteError,
    FleetRouter,
    NoLiveReplica,
    ReplicaConnectionLost,
    ReplicaServer,
)
from .qos import QosPolicy, TenantQuotaExceeded, TokenBucket
from .autoscale import AutoscaleError, FleetAutoscaler

__all__ = ["AOTPredictor", "AutoscaleError", "DeadlineExceeded",
           "FleetAutoscaler", "FleetError", "FleetOverloaded",
           "FleetRemoteError", "FleetRouter", "GenerateError",
           "GenerateServer", "GenerativePredictor", "ModelServer",
           "NoLiveReplica", "PagePool", "PagePoolExhausted", "PrefixIndex",
           "QosPolicy", "ReplicaConnectionLost", "ReplicaDraining",
           "ReplicaServer", "ServerClosed", "ServerOverloaded",
           "ServingError", "TenantQuotaExceeded", "TokenBucket",
           "env_batch_ladder", "validate_ladder"]
