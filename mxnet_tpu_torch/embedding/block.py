"""``SparseEmbedding``, the Gluon block over a server-sharded table
(counterpart of ``mxnet_tpu/embedding/block.py``).

The table is not a Parameter: it lives row-sharded on the parameter
servers (``ShardedEmbeddingTable``), and only the rows a batch touches
reach this process. Each ``forward``:

1. pulls the batch's distinct ids' rows once each
   (``ShardedEmbeddingTable.pull``);
2. makes the pulled ``(n_unique, dim)`` block an autograd variable while
   recording, so that ``backward`` sums the batch's row gradients into a
   buffer of the block (the gather's backward adds repeated ids);
3. gathers the per-id rows with the ``Embedding`` op on the remapped ids.

After ``loss.backward()``, :meth:`step` pushes the summed row gradients
back as asynchronous row-scatter pushes, and the servers' optimizer
applies them as they arrive.

::

    kv.set_optimizer("sgd", learning_rate=0.05,
                     rescale_grad=1.0 / batch_size)
    emb = SparseEmbedding(64, input_dim=1 << 20, kvstore=kv, key="user")
    emb.initialize_table()
    with autograd.record():
        loss = ...(emb(user_ids))...
    loss.backward()
    emb.step()
"""
from __future__ import annotations

import numpy as np

from .. import autograd
from ..base import MXNetError
from ..gluon.block import Block
from ..ndarray import ndarray as nd
from .table import EmbeddingShardError, ShardedEmbeddingTable

__all__ = ["SparseEmbedding"]


class SparseEmbedding(Block):
    """A Gluon block whose embedding table is server-sharded.

    ``kvstore`` is given here or later to :meth:`bind_kvstore` (the table
    binds on first use). ``key`` names the table on the servers and
    defaults to the block's name; every worker must use the same, so pass
    it in multi-worker jobs (block names count per process)."""

    def __init__(self, output_dim, input_dim, kvstore=None, key=None,
                 dtype="float32", table_kwargs=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = int(input_dim)
        self._output_dim = int(output_dim)
        self._dtype = dtype
        self._table_kwargs = dict(table_kwargs or {})
        self._key = key
        self._kv = None
        self._table = None
        # [(unique ids, gradient buffer, pulled rows), ...]: the rows are
        # kept, as autograd fills the buffers of live variables only
        self._pending = []
        if kvstore is not None:
            self.bind_kvstore(kvstore)

    def bind_kvstore(self, kvstore):
        """Attach the server kvstore the table lives on; binding another
        store afterwards raises."""
        if self._kv is not None and self._kv is not kvstore:
            raise MXNetError("SparseEmbedding %r is already bound to a "
                             "kvstore" % self.name)
        self._kv = kvstore
        if self._table is None:
            self._table = ShardedEmbeddingTable(
                self._key or self.name, kvstore, rows=self._input_dim,
                dim=self._output_dim, dtype=self._dtype,
                **self._table_kwargs)
        return self

    @property
    def table(self):
        if self._table is None:
            raise MXNetError("SparseEmbedding %r has no kvstore bound: pass "
                             "kvstore= or call bind_kvstore() first"
                             % self.name)
        return self._table

    def initialize_table(self, init_array=None, scale=None, seed=0):
        """Install the table on the servers (the first writer wins, so
        every worker may call it)."""
        self.table.init(init_array=init_array, scale=scale, seed=seed)
        return self

    def forward(self, x):
        table = self.table
        ids = x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)
        uniq, inverse, rows = table.pull(ids)
        if uniq.size == 0:
            raise EmbeddingShardError("SparseEmbedding %r: empty id batch"
                                      % self.name)
        weight = nd.array(rows)
        if autograd.is_recording():
            grad = nd.zeros(weight.shape, ctx=weight.context,
                            dtype=rows.dtype)
            autograd.mark_variables([weight], [grad])
            self._pending.append((uniq, grad, weight))
        inv = nd.array(inverse.reshape(np.asarray(ids).shape)
                       .astype(np.int32), ctx=weight.context)
        return nd.invoke("Embedding", [inv, weight],
                         {"input_dim": int(uniq.size),
                          "output_dim": self._output_dim})

    def step(self, priority=0):
        """Push every recorded forward's summed row gradients to the
        servers (asynchronous: the next pull of those rows waits for
        them); returns the number of blocks pushed. The servers'
        optimizer's ``rescale_grad`` scales them."""
        pending, self._pending = self._pending, []
        for uniq, grad, _rows in pending:
            self.table.push(uniq, grad.asnumpy(), priority=priority)
        return len(pending)

    def discard_grads(self):
        """Drop the recorded forwards without pushing."""
        self._pending = []

    def __repr__(self):
        return ("SparseEmbedding(%d -> %d, key=%r, shards=%s)"
                % (self._input_dim, self._output_dim, self._key or self.name,
                   self._table.num_shards if self._table else "?"))
