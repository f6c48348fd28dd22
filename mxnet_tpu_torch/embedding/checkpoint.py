"""Coordinated checkpoints of sharded embedding tables (counterpart of
``mxnet_tpu/embedding/checkpoint.py``).

The three named barriers of ``callback.elastic_checkpoint`` over sharded
tables: each sub-table is read in the quiesced window and committed as an
ordinary ``arg:<key>@embshard<s>`` weight, and the servers' optimizer
state (the sub-keys are plain keys of each server's updater) rides
``save_optimizer_states``. A respawned server restores exactly its
suffix-routed sub-keys through ``KVStoreServer.restore_from_checkpoint``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["elastic_table_checkpoint"]


def elastic_table_checkpoint(manager, tables, kv, state_fn=None,
                             extra_weights_fn=None):
    """``fn(epoch)`` running the coordinated checkpoint of ``tables``
    (:class:`ShardedEmbeddingTable` or :class:`SparseEmbedding`, whose
    table is taken) on the server kvstore ``kv``. Every worker calls it at
    every epoch end (``manager.due`` gates the period); it returns the
    epoch when it checkpointed, else None. ``extra_weights_fn() ->
    {prefixed name: numpy}`` folds dense params into the same commit."""
    rank = kv.rank

    def _default_state():
        return {"numpy_rng": np.random.get_state()}

    state_fn = state_fn or _default_state
    resolved = [getattr(t, "table", t) for t in tables]

    def _sync(epoch, phase):
        kv.barrier("embed-ckpt-%d-%s" % (epoch, phase))

    def _checkpoint(epoch):
        if not manager.due(epoch):
            return None
        if rank == 0:
            manager.begin(epoch)
        _sync(epoch, "stage")                 # the staging dir exists
        state = dict(state_fn())
        state.setdefault("epoch", epoch)
        manager.write_worker_state(epoch, rank, state)
        _sync(epoch, "progress")              # every progress staged
        if rank == 0:
            # the quiesced window: every other worker waits in the commit
            # barrier, and snapshot()/save_optimizer_states drain this
            # client's own pipeline
            weights = {}
            for t in resolved:
                for sub_key, arr in t.snapshot().items():
                    weights["arg:%s" % sub_key] = arr
            if extra_weights_fn is not None:
                weights.update(extra_weights_fn())
            kv.save_optimizer_states(
                manager.staged_optimizer_states_path(epoch))
            manager.commit(epoch, weights=weights,
                           optimizer_config=kv.get_optimizer_config(),
                           num_workers=kv.num_workers)
        _sync(epoch, "commit")                # the commit is visible
        return epoch

    return _checkpoint
