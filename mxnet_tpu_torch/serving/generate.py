"""Paged KV-cache machinery for generative serving (counterpart of
``mxnet_tpu/serving/generate.py``).

- :class:`PagePool` — an exact-accounting fixed-size-block allocator for
  KV-cache memory: a finished request's pages are recycled the moment it
  completes. Exhaustion raises the typed :class:`PagePoolExhausted`.
- :class:`PrefixIndex` — a radix tree over full KV pages keyed by
  token-id page runs: admission matches the longest cached prefix and
  shares those pages copy-on-write (pure Python, a copy of the JAX
  package's).
- :class:`GenerativePredictor` — one transformer bound for incremental
  decode: prompts are padded up a ladder of page-aligned power-of-two
  buckets for prefill, ONE decode step runs ``slots`` queries, one
  token each, against the pages named by each slot's block table, and
  ``extend`` runs T tokens a slot (a prefix-matched prompt's tail, or a
  speculative verify).

Page 0 of the cache is the scratch page: never handed out, it absorbs
writes from inactive slots and padded prompt tails, so every step keeps a
static shape without corrupting live pages.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .. import config
from ..base import MXNetError
from ..context import resolve_device
from ..models import transformer as tfm
from .predictor import ServingError


class GenerateError(ServingError):
    """Generative-serving failure (bad knob, bad request, dead loop)."""


class PagePoolExhausted(GenerateError):
    """The KV page pool has no free page for this allocation. Typed
    backpressure: at admission the request simply waits in the queue
    for completions to recycle pages; a request that could NEVER fit
    (or a mid-decode growth the pool cannot serve) fails fast with
    this error instead of stalling silently or running out of memory."""


def _env_positive_int(name):
    if config.get(name) is None:
        raise GenerateError("unknown knob %s" % name)
    try:
        return config.get_positive_int(name)
    except MXNetError as e:
        raise GenerateError(str(e))


def _env_nonneg_int(name):
    try:
        return config.get_nonneg_int(name)
    except MXNetError as e:
        raise GenerateError(str(e))


def _env_strict_bool(name):
    try:
        return config.get_strict_bool(name)
    except MXNetError as e:
        raise GenerateError(str(e))


class PagePool:
    """Fixed-size-block allocator with exact accounting and per-page
    refcounts (copy-on-write prefix sharing takes extra references).

    Page ids run 1..num_pages (0 is the cache's scratch page). ``alloc``
    raises :class:`PagePoolExhausted` when the request cannot be
    satisfied — it never partially allocates — and hands each page out
    at refcount 1. ``ref`` takes an extra reference on a live page (a
    second request sharing a cached prefix page, or the prefix index
    pinning one); ``unref`` drops one reference and only returns the
    page to the free list when the count reaches zero. ``free`` is the
    historical alias for ``unref``. Both reject double-drops and
    foreign ids loudly: a page leak (or double recycle) silently
    corrupts another request's KV state, so the accounting must be
    exact by construction — after every holder drops its reference,
    ``in_use == 0`` and ``allocs == frees`` (pages handed out == pages
    returned), asserted by the torture test."""

    def __init__(self, num_pages):
        num_pages = int(num_pages)
        if num_pages < 1:
            raise GenerateError("PagePool: need >= 1 page, got %d"
                                % num_pages)
        self.num_pages = num_pages
        self._free = list(range(num_pages, 0, -1))  # pop() hands out 1 first
        self._refcount = {}                         # page id -> live refs
        self._lock = threading.Lock()
        self.high_water = 0
        self.allocs = 0
        self.frees = 0
        self.refs = 0              # extra references taken (sharing events)
        self.ref_high_water = 0    # max refcount any single page reached

    def alloc(self, n):
        """n pages as a list of ids, or PagePoolExhausted (all-or-nothing).
        Each page comes out at refcount 1, owned by the caller."""
        n = int(n)
        if n < 0:
            raise GenerateError("PagePool.alloc: n must be >= 0, got %d" % n)
        with self._lock:
            if n > len(self._free):
                raise PagePoolExhausted(
                    "page pool exhausted: need %d page(s), %d free of %d "
                    "(MXNET_GENERATE_POOL_BYTES)"
                    % (n, len(self._free), self.num_pages))
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refcount[p] = 1
            self.allocs += n
            if len(self._refcount) > self.high_water:
                self.high_water = len(self._refcount)
            if n and self.ref_high_water < 1:
                self.ref_high_water = 1
            return pages

    def ref(self, pages):
        """Take one extra reference on each (live) page — sharing, not
        allocation: no free page is consumed. Foreign ids raise."""
        with self._lock:
            for p in pages:
                if p not in self._refcount:
                    raise GenerateError(
                        "PagePool.ref: page %r is not allocated "
                        "(cannot share a free or foreign page)" % (p,))
            for p in pages:
                rc = self._refcount[p] + 1
                self._refcount[p] = rc
                self.refs += 1
                if rc > self.ref_high_water:
                    self.ref_high_water = rc

    def unref(self, pages):
        """Drop one reference per page; a page whose count reaches zero
        returns to the free list. Double-drops and foreign ids raise."""
        with self._lock:
            for p in pages:
                if p not in self._refcount:
                    raise GenerateError(
                        "PagePool.free: page %r is not allocated "
                        "(double free or foreign id)" % (p,))
            for p in pages:
                rc = self._refcount[p] - 1
                if rc:
                    self._refcount[p] = rc
                else:
                    del self._refcount[p]
                    self._free.append(p)
                    self.frees += 1

    def free(self, pages):
        """Alias of :meth:`unref` (the pre-sharing name every holder —
        broker slot vacate, tests — already uses)."""
        self.unref(pages)

    def refcount(self, page):
        """Current reference count of ``page`` (0 when free)."""
        with self._lock:
            return self._refcount.get(page, 0)

    @property
    def in_use(self):
        with self._lock:
            return len(self._refcount)

    @property
    def free_pages(self):
        with self._lock:
            return len(self._free)

    def stats(self):
        with self._lock:
            shared = sum(1 for rc in self._refcount.values() if rc > 1)
            return {"num_pages": self.num_pages,
                    "in_use": len(self._refcount),
                    "free": len(self._free),
                    "high_water": self.high_water,
                    "allocs": self.allocs, "frees": self.frees,
                    "refs": self.refs, "shared": shared,
                    "ref_high_water": self.ref_high_water}


class _PrefixNode:
    __slots__ = ("page", "children", "last_used")

    def __init__(self, page, clock):
        self.page = page
        self.children = {}
        self.last_used = clock


class PrefixIndex:
    """Radix-tree index over full KV pages keyed by token-id page runs
    (shared-prefix KV cache).

    Each node maps one ``page_size``-token run to the pool page holding
    that run's K/V; a path from the root spells out a prompt prefix in
    whole pages. The index itself holds ONE pool reference per indexed
    page (taken at :meth:`insert`, dropped at eviction), so an indexed
    page stays alive after the request that prefilled it finishes —
    that reference is what turns a private page into a shareable one.

    - :meth:`match` walks the longest indexed prefix of a prompt,
      capped at ``(prompt_len - 1) // page_size`` pages so the tail
      prefill always has >= 1 token — the structural form of the
      copy-on-write rule: a partial (or final) page is always
      re-prefilled privately, never shared, hence shared pages are
      never written. Matched pages are ref'd on the caller's behalf
      (the caller unrefs them exactly once, same as its private pages).
    - :meth:`insert` indexes a just-prefilled prompt's full pages,
      taking an extra reference on each newly indexed page; runs
      already indexed are only LRU-touched (the request keeps its
      private duplicate — dedup happens for FUTURE requests via match).
    - :meth:`evict_lru` drops the least-recently-matched leaf —
      called under pool pressure so sharing never causes a
      :class:`PagePoolExhausted` a no-sharing run would avoid, and to
      keep the index under ``max_pages`` when one is set.
    """

    def __init__(self, page_size, max_pages=0):
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise GenerateError("PrefixIndex: page_size must be >= 1, "
                                "got %d" % self.page_size)
        self.max_pages = int(max_pages or 0)
        self._root = {}
        self._clock = 0
        self._pages = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    def _runs(self, tokens, n):
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n)]

    def match(self, tokens, pool):
        """Longest indexed full-page prefix of ``tokens`` — at most
        ``(len(tokens) - 1) // page_size`` pages (see class docstring).
        Returns the page-id list with one reference per page taken on
        ``pool`` for the caller; the whole path is LRU-touched."""
        limit = max(0, (len(tokens) - 1) // self.page_size)
        pages = []
        with self._lock:
            self._clock += 1
            node_map, touched = self._root, []
            for run in self._runs(tokens, limit):
                node = node_map.get(run)
                if node is None:
                    break
                touched.append(node)
                pages.append(node.page)
                node_map = node.children
            for node in touched:
                node.last_used = self._clock
            if pages:
                pool.ref(pages)
                self.hits += 1
            else:
                self.misses += 1
        return pages

    def insert(self, tokens, pages, pool):
        """Index the full pages of a just-prefilled prompt: run i →
        ``pages[i]``. Only runs fully covered by the prompt are indexed
        (``len(tokens) // page_size`` of them — a final page that the
        decode loop will keep writing is still mutable and stays
        private). Newly indexed pages cost one extra pool reference;
        existing runs keep their already-indexed page. Returns the
        number of pages newly indexed."""
        n = min(len(tokens) // self.page_size, len(pages))
        added = 0
        with self._lock:
            self._clock += 1
            node_map = self._root
            for i, run in enumerate(self._runs(tokens, n)):
                node = node_map.get(run)
                if node is None:
                    pool.ref([pages[i]])
                    node = _PrefixNode(pages[i], self._clock)
                    node_map[run] = node
                    self._pages += 1
                    self.insertions += 1
                    added += 1
                else:
                    node.last_used = self._clock
                node_map = node.children
        if self.max_pages:
            while self.pages > self.max_pages:
                if not self.evict_lru(pool):
                    break
        return added

    def evict_lru(self, pool):
        """Drop the least-recently-matched LEAF node (leaves first so a
        prefix chain stays contiguous) and release the index's
        reference on its page — the page only becomes free once no
        live request shares it. Returns True when a node was evicted,
        False on an empty index."""
        with self._lock:
            victim = None          # (last_used, parent_map, run, node)
            stack = [(self._root, run, node)
                     for run, node in self._root.items()]
            while stack:
                parent, run, node = stack.pop()
                if node.children:
                    stack.extend((node.children, r, ch)
                                 for r, ch in node.children.items())
                elif victim is None or node.last_used < victim[0]:
                    victim = (node.last_used, parent, run, node)
            if victim is None:
                return False
            _, parent, run, node = victim
            del parent[run]
            self._pages -= 1
            self.evictions += 1
            page = node.page
        pool.unref([page])
        return True

    def clear(self, pool):
        """Evict everything (release every index reference)."""
        while self.evict_lru(pool):
            pass

    @property
    def pages(self):
        with self._lock:
            return self._pages

    def stats(self):
        with self._lock:
            return {"pages": self._pages, "hits": self.hits,
                    "misses": self.misses, "insertions": self.insertions,
                    "evictions": self.evictions,
                    "max_pages": self.max_pages}


class GenerativePredictor:
    """One transformer bound for prefill, single-token decode and the
    multi-token extend (a prefix-matched tail, a speculative verify).

    Parameters
    ----------
    config_ : models.transformer.TransformerConfig
        The model architecture (``dtype`` is the cache/compute dtype).
    params : dict
        ``init_params``-layout arrays (numpy or torch); copied onto the
        device once, in fp32.
    slots : int, optional
        Batch-slot count of the decode step (``MXNET_GENERATE_SLOTS``).
    page_size : int, optional
        Tokens per KV page (``MXNET_GENERATE_PAGE_SIZE``).
    pool_bytes : int, optional
        KV page-pool budget in bytes (``MXNET_GENERATE_POOL_BYTES``);
        0/None auto-sizes to ``slots * max_pages_per_slot`` pages —
        every slot can hold a full-context request, so decode-time
        exhaustion is impossible and paging only buys recycling speed.
        A smaller explicit budget oversubscribes: admission
        backpressures on :class:`PagePoolExhausted`.
    max_ctx : int, optional
        Per-slot context bound (prompt + generated), default
        ``config.max_len``; rounded down to a whole page count.
    device : str or torch.device, optional
        Where the weights, the cache and every step live; default
        ``cuda``, which raises when there is no CUDA device.
    """

    def __init__(self, config_, params, *, slots=None, page_size=None,
                 pool_bytes=None, max_ctx=None, device=None):
        self.config = config_
        self.device = resolve_device(device)
        self.slots = _env_positive_int("MXNET_GENERATE_SLOTS") \
            if slots is None else int(slots)
        if self.slots < 1:
            raise GenerateError("GenerativePredictor: slots must be >= 1, "
                                "got %d" % self.slots)
        self.page_size = _env_positive_int("MXNET_GENERATE_PAGE_SIZE") \
            if page_size is None else int(page_size)
        if self.page_size < 1:
            raise GenerateError("GenerativePredictor: page_size must be "
                                ">= 1, got %d" % self.page_size)
        ctx_bound = config_.max_len if max_ctx is None \
            else min(int(max_ctx), config_.max_len)
        self.max_pages_per_slot = ctx_bound // self.page_size
        if self.max_pages_per_slot < 1:
            raise GenerateError(
                "GenerativePredictor: page_size %d exceeds the context "
                "bound %d" % (self.page_size, ctx_bound))
        self.max_ctx = self.max_pages_per_slot * self.page_size

        c = config_
        dh = c.d_model // c.n_heads
        cdt = tfm.torch_dtype(c.dtype)
        self.page_bytes = (c.n_layers * 2 * self.page_size * c.n_heads * dh
                           * cdt.itemsize)
        if pool_bytes is None:
            pool_bytes = _env_nonneg_int("MXNET_GENERATE_POOL_BYTES")
        pool_bytes = int(pool_bytes or 0)
        if pool_bytes > 0:
            num_pages = pool_bytes // self.page_bytes
            if num_pages < self.max_pages_per_slot:
                raise GenerateError(
                    "MXNET_GENERATE_POOL_BYTES=%d holds %d page(s) of %d "
                    "bytes — smaller than one full-context request "
                    "(%d pages); raise the budget or shrink max_ctx/"
                    "page_size" % (pool_bytes, num_pages, self.page_bytes,
                                   self.max_pages_per_slot))
        else:
            num_pages = self.slots * self.max_pages_per_slot
        self.pool = PagePool(num_pages)

        self._params = {
            k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.asarray(v))).to(device=self.device, dtype=torch.float32)
            for k, v in params.items()}
        self._kv = tfm.init_kv_cache(c, num_pages, self.page_size,
                                     device=self.device)
        self._prefill = tfm.make_prefill_fn(c, self.page_size, self.device)
        self._decode = tfm.make_decode_fn(c, self.slots,
                                          self.max_pages_per_slot,
                                          self.page_size, self.device)
        self._extends = {}         # (slots, steps) -> extend function

        # prefill bucket ladder: page-aligned powers of two up to the
        # context bound
        buckets, b = [], self.page_size
        while b < self.max_ctx:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_ctx)
        self.prefill_buckets = tuple(buckets)
        self._lock = threading.Lock()

    # -- request surface -----------------------------------------------------
    def pages_needed(self, prompt_len):
        return -(-int(prompt_len) // self.page_size)

    def pick_bucket(self, prompt_len):
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise GenerateError(
            "prompt of %d tokens exceeds the per-slot context bound %d"
            % (prompt_len, self.max_ctx))

    def prefill(self, tokens, pages):
        """Run one prompt (1-D int array) through prefill, writing its K/V
        into ``pages`` (ids from :attr:`pool`); returns the last
        position's logits as numpy (V,)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        length = int(tokens.shape[0])
        if length < 1:
            raise GenerateError("prefill: empty prompt")
        if self.pages_needed(length) != len(pages):
            raise GenerateError(
                "prefill: %d-token prompt needs %d page(s), got %d"
                % (length, self.pages_needed(length), len(pages)))
        bucket = self.pick_bucket(length)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :length] = tokens
        page_arr = np.zeros((bucket // self.page_size,), np.int32)
        page_arr[:len(pages)] = pages   # tail pages hit scratch (0)
        with self._lock:
            _, logits = self._prefill(self._params, self._kv, padded, length,
                                      page_arr)
            return logits.cpu().numpy()

    def decode(self, tokens, positions, block_tables, active):
        """One decode step over all ``slots``; returns numpy logits
        (slots, V). ``tokens[b]`` is written at ``positions[b]`` into
        the page its slot's ``block_tables`` row names; inactive slots
        write to scratch and return zero logits."""
        with self._lock:
            _, logits = self._decode(
                self._params, self._kv,
                np.asarray(tokens, np.int32),
                np.asarray(positions, np.int32),
                np.asarray(block_tables, np.int32),
                np.asarray(active, bool))
            return logits.cpu().numpy()

    def extend(self, tokens, positions, block_tables, valid):
        """Multi-token append: run ``tokens`` (S, T) at ``positions``
        (S, T) against each slot's cached pages in one call; returns numpy
        logits (S, T, V). Invalid entries write to scratch and return zero
        logits. Serves both the shared-prefix tail prefill (S = 1, T = a
        prefill bucket) and the speculative verify step (S = slots,
        T = k + 1); one extend function is made per (S, T)."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2:
            raise GenerateError("extend: tokens must be (batch, steps), "
                                "got shape %r" % (tokens.shape,))
        S, T = tokens.shape
        fn = self._extends.get((S, T))
        if fn is None:
            fn = self._extends[(S, T)] = tfm.make_extend_fn(
                self.config, S, T, self.max_pages_per_slot, self.page_size,
                self.device)
        with self._lock:
            _, logits = fn(self._params, self._kv, tokens,
                           np.asarray(positions, np.int32),
                           np.asarray(block_tables, np.int32),
                           np.asarray(valid, bool))
            return logits.cpu().numpy()

    def extend_tail(self, tokens, start_pos, pages):
        """Prefill the uncovered TAIL of a prefix-matched prompt:
        ``tokens`` (the tail, 1-D) start at absolute position
        ``start_pos`` and attend the full block table ``pages`` (shared
        prefix pages + the request's private tail pages). The tail is
        padded up the prefill bucket ladder. Returns the last tail
        position's logits as numpy (V,), the request's first generated
        token, as :meth:`prefill` does. Every tail position lies at or
        past ``start_pos``, past the shared region, so shared pages are
        never written (copy-on-write by construction)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = int(tokens.shape[0])
        if n < 1:
            raise GenerateError("extend_tail: empty tail")
        if start_pos % self.page_size != 0:
            raise GenerateError(
                "extend_tail: start_pos %d is not page-aligned (the "
                "shared prefix covers whole pages)" % start_pos)
        if start_pos + n > self.max_ctx:
            raise GenerateError(
                "extend_tail: tail of %d token(s) at position %d exceeds "
                "the per-slot context bound %d" % (n, start_pos,
                                                  self.max_ctx))
        bucket = self.pick_bucket(n)
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :n] = tokens
        pos = np.arange(start_pos, start_pos + bucket,
                        dtype=np.int32)[None, :]
        valid = np.zeros((1, bucket), bool)
        valid[0, :n] = True
        bt = np.zeros((1, self.max_pages_per_slot), np.int32)
        bt[0, :len(pages)] = pages
        logits = self.extend(tok, pos, bt, valid)
        return logits[0, n - 1]

    def pool_stats(self):
        return self.pool.stats()
