"""Gluon's ``DataLoader`` (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``): batches of a dataset's samples in
the batch sampler's order, stacked by ``batchify_fn`` into NDArrays on the
current context.

``num_workers > 0`` batchifies on that many threads, as the JAX package
does, with at most ``prefetch`` batches in flight ahead of the consumer
(default twice the workers), each made on the consumer's context;
batches still come out in order, and a worker's exception is raised to
the consumer at its batch.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...context import current_context
from ...ndarray import ndarray as nd
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into batch arrays (a tuple sample into one array of
    each field)."""
    if isinstance(data[0], NDArray):
        return nd.array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype if data.dtype != np.float64
                    else np.float32)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is "
                                 "specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None \
                or last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(1, prefetch or 2 * max(self._num_workers, 1))

    def _load(self, batch, ctx=None):
        if ctx is None:
            return self._batchify_fn([self._dataset[idx] for idx in batch])
        with ctx:
            return self._load(batch)

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._load(batch)
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        # the workers make their arrays on the consumer's context (a
        # thread's default context is its own)
        ctx = current_context()
        batches = iter(self._batch_sampler)
        with ThreadPoolExecutor(self._num_workers) as pool:
            pending = []
            for batch in batches:
                pending.append(pool.submit(self._load, batch, ctx))
                if len(pending) >= self._prefetch:
                    break
            while pending:
                res = pending.pop(0).result()
                nxt = next(batches, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt, ctx))
                yield res

    def __len__(self):
        return len(self._batch_sampler)
