"""Sharded embedding tables (counterpart of ``mxnet_tpu/embedding``):
tables too large for one server, row-sharded across the parameter
servers of ``kvstore_server``.

- :class:`ShardedEmbeddingTable`: the client data plane (stable-hash row
  sharding, ``sharding.RowSharding``; deduplicated ``row_pull`` reads;
  row-scatter pushes on the client's sender pipeline; an optional 2-bit
  wire), per-server memory about 1/num_servers.
- :class:`EmbeddingShardError`: out-of-vocabulary ids and sharding
  misconfiguration, raised at the client.
- :class:`SparseEmbedding`: the Gluon block over a table, pulling a
  batch's rows and pushing their gradients back.
- :class:`EmbeddingLookupServer` / :class:`EmbeddingTowerPredictor`: the
  serving half, sharded lookup + dense tower through AOTPredictor, a
  fleet ``replica`` (``serving/fleet.py``).
- :func:`elastic_table_checkpoint`: the coordinated checkpoint over
  sharded tables; a respawned server restores its suffix-routed sub-keys
  through ``KVStoreServer.restore_from_checkpoint``.
"""
from .block import SparseEmbedding  # noqa: F401
from .lookup import (  # noqa: F401
    EmbeddingLookupServer,
    EmbeddingTowerPredictor,
)
from .sharding import (  # noqa: F401
    RowSharding,
    embedding_shard_rank,
    embedding_sub_key,
)
from .table import (  # noqa: F401
    EmbeddingShardError,
    ShardedEmbeddingTable,
)

from .checkpoint import elastic_table_checkpoint  # noqa: F401

__all__ = ["RowSharding", "embedding_sub_key", "embedding_shard_rank",
           "ShardedEmbeddingTable", "EmbeddingShardError",
           "SparseEmbedding", "EmbeddingLookupServer",
           "EmbeddingTowerPredictor", "elastic_table_checkpoint"]
