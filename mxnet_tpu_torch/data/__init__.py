"""Sharded dataset service: exactly-once record IO (counterpart of
``mxnet_tpu/data``, exporting the same names).

Submodules: ``lease`` (stdlib-only shard-lease arithmetic), ``writer``
(sharding record writer + manifest), ``service`` (lease-driven streams,
decode pool, batch iterator), ``errors`` (typed DataPlaneError
hierarchy). Exports resolve lazily (PEP 562).
"""
from __future__ import annotations

_EXPORTS = {
    "ShardLeaseBook": "lease",
    "LocalLeaseAuthority": "lease",
    "LeaseError": "lease",
    "DataPlaneError": "errors",
    "LeaseLostError": "errors",
    "CursorCorruptError": "errors",
    "ShardCorruptError": "errors",
    "ManifestCorruptError": "errors",
    "write_record_shards": "writer",
    "load_manifest": "writer",
    "manifest_path": "writer",
    "ShardedRecordStream": "service",
    "ShardedBatchIter": "service",
    "record_seed": "service",
    "decode_raw": "service",
    "decode_image_f32": "service",
    "iter_manifest_records": "service",
    "merge_ledgers": "service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module("." + _EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
