"""Row sharding of server-sharded embedding tables (counterpart of
``mxnet_tpu/embedding/sharding.py``).

A table of ``rows`` rows splits into ``num_shards`` dense sub-tables, sub-key
``<key>@embshard<s>`` on server ``s % num_servers``
(``kvstore_server.embedding_shard_rank``). A row goes to its shard by a
stable multiplicative-hash permutation, then a contiguous range split:

    perm(r)  = (r * A) mod rows        # A coprime with rows: a bijection
    shard(r) = the range of ``zero_slice_sizes(rows, num_shards)``
               that perm(r) falls in
    local(r) = perm(r) - range_start(shard(r))

The local index follows from the global id alone (no rows-sized table on a
client), the permutation is the same in every process, and it stripes
consecutive ids over the shards, so the hot head of a frequency-sorted
vocabulary lands on every server. The first ``rows % num_shards`` shards
get one extra row. Ids are int32 on the wire: more than 2**31 - 1 rows
raise.
"""
from __future__ import annotations

import math

import numpy as np

from ..base import MXNetError
from ..kvstore_server import (embedding_shard_rank, embedding_sub_key,
                              zero_slice_sizes)

__all__ = ["RowSharding", "embedding_shard_rank", "embedding_sub_key"]

#: Knuth's multiplicative-hash constant (2^32 / golden ratio); the
#: actual multiplier is derived from it per table size so it is always
#: coprime with ``rows`` (a non-coprime multiplier would collapse the
#: permutation)
_KNUTH = 2654435761


def _multiplier(rows):
    """The smallest A >= (Knuth mod rows) with gcd(A, rows) == 1 —
    deterministic per table size, so every client and every restored
    server computes the identical permutation."""
    a = _KNUTH % rows
    if a < 2:
        a = min(2, rows)  # rows 1/2: identity-ish, still coprime
    while math.gcd(a, rows) != 1:
        a += 1
    return a % rows if rows > 1 else 1


class RowSharding:
    """The one row->shard/local mapping, shared by the client's
    routing, checkpoint reassembly, and tests."""

    def __init__(self, rows, num_shards):
        rows = int(rows)
        num_shards = int(num_shards)
        if rows < 1:
            raise MXNetError("RowSharding: rows must be >= 1, got %d"
                             % rows)
        if rows > np.iinfo(np.int32).max:
            raise MXNetError(
                "RowSharding: %d rows exceeds the int32 id wire format "
                "(2^31-1 rows)" % rows)
        if not 1 <= num_shards <= rows:
            raise MXNetError(
                "RowSharding: num_shards must be in [1, rows=%d], got "
                "%d" % (rows, num_shards))
        self.rows = rows
        self.num_shards = num_shards
        self.multiplier = _multiplier(rows)
        self.sizes = zero_slice_sizes(rows, num_shards)
        self._bounds = np.cumsum([0] + self.sizes).astype(np.int64)

    def perm(self, ids):
        """The stable hash permutation of global row ids (int64 in,
        int64 out; rows < 2^31 keeps the product inside int64)."""
        ids = np.asarray(ids, np.int64)
        return (ids * self.multiplier) % self.rows

    def shard_and_local(self, ids):
        """Vectorized (shard index, local row index) for global ids.
        Callers validate the id range FIRST (the table raises the
        typed EmbeddingShardError); this is pure math."""
        p = self.perm(ids)
        shards = np.searchsorted(self._bounds, p, side="right") - 1
        return shards.astype(np.int64), p - self._bounds[shards]

    def shard_rows(self, shard):
        """Row count of one shard's dense sub-table."""
        return self.sizes[int(shard)]

    def group(self, ids):
        """Group global ids by shard: ``[(shard, sel, local_ids)]``
        for every NON-EMPTY shard, where ``sel`` indexes back into
        ``ids`` and ``local_ids[i]`` is the sub-table row of
        ``ids[sel[i]]``. THE one grouping routine shared by the pull
        and push paths (they must slice identically or reads and
        writes silently diverge)."""
        shards, locals_ = self.shard_and_local(ids)
        order = np.argsort(shards, kind="stable")
        bounds = np.searchsorted(shards[order],
                                 np.arange(self.num_shards + 1))
        out = []
        for s in range(self.num_shards):
            sel = order[bounds[s]:bounds[s + 1]]
            if sel.size:
                out.append((s, sel, locals_[sel]))
        return out

    def sub_keys(self, key):
        """All sub-table keys of ``key``, in shard order."""
        return [embedding_sub_key(key, s) for s in range(self.num_shards)]

    def global_ids(self, shard):
        """The global row ids stored in ``shard``, in LOCAL order —
        the inverse mapping (O(rows/num_shards) memory; used by
        checkpoint reassembly and tests, never the hot path). Solves
        perm(r) = p for each local slot p via the modular inverse of
        the multiplier."""
        shard = int(shard)
        lo = int(self._bounds[shard])
        hi = int(self._bounds[shard + 1])
        p = np.arange(lo, hi, dtype=np.int64)
        inv = pow(self.multiplier, -1, self.rows) if self.rows > 1 else 1
        return (p * inv) % self.rows
