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

Not ported, raising by name: ``elastic_table_checkpoint`` (ROADMAP.md
Queue A item 10, second part).
"""
from ..base import MXNetError
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


def _not_ported(name, item, what):
    def refuse(*args, **kwargs):
        raise MXNetError("embedding.%s: %s is not ported (ROADMAP.md Queue "
                         "A item %d, second part)" % (name, what, item))

    refuse.__name__ = name
    return refuse


elastic_table_checkpoint = _not_ported("elastic_table_checkpoint", 10,
                                       "the table checkpoint")

__all__ = ["RowSharding", "embedding_sub_key", "embedding_shard_rank",
           "ShardedEmbeddingTable", "EmbeddingShardError",
           "SparseEmbedding", "EmbeddingLookupServer",
           "EmbeddingTowerPredictor", "elastic_table_checkpoint"]
