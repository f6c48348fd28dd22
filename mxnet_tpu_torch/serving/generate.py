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
  speculative verify). With ``mesh=`` the model is sharded Megatron's way
  over the mesh's ``mp`` axis and every rank runs each call in lockstep
  with the leader (:class:`_Lockstep`).

Page 0 of the cache is the scratch page: never handed out, it absorbs
writes from inactive slots and padded prompt tails, so every step keeps a
static shape without corrupting live pages.
"""
from __future__ import annotations

import datetime
import threading

import numpy as np
import torch
import torch.distributed as dist

from .. import config, profiler
from ..base import MXNetError
from ..context import resolve_device
from ..models import transformer as tfm
from ..parallel.mesh import _mp_axis, mesh_device, mesh_shape
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


# the lockstep's ops on the wire
_CLOSE, _PREFILL, _DECODE, _EXTEND = range(4)
_OP_NAMES = {_PREFILL: "prefill", _DECODE: "decode", _EXTEND: "extend"}
_HEADER = 2 + 2 * 4          # op, array count, then (rows, cols) of each
# the leader's sends give up after this long (a follower that died closes
# its connections, which fails a send at once); a follower waits for the
# next call as long as the leader lives
_SEND_TIMEOUT = datetime.timedelta(seconds=60)
_WAIT_TIMEOUT = datetime.timedelta(days=30)


class _Lockstep:
    """The control plane of a predictor sharded over a mesh, one process a
    rank: the mesh's global rank 0 (the leader) serves, and before each
    call broadcasts an op header and the call's integer arrays over a gloo
    group of its own (CPU tensors, whatever backend the mesh's collectives
    run on); every other rank receives them in
    :meth:`GenerativePredictor.follow` and runs the same call, so the
    collectives inside it meet. With dp > 1 every mp group computes the
    same call."""

    def __init__(self):
        self.leader = dist.get_rank() == 0
        self.group = dist.new_group(backend="gloo", timeout=_SEND_TIMEOUT)
        self.closed = False
        self.broken = None          # the error that broke the lockstep

    def _bcast(self, t, timeout):
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor, opts.timeout = 0, 0, timeout
        self.group.broadcast([t], opts).wait()

    def send(self, op, arrays):
        """Broadcast ``op`` and ``arrays`` (2-D int arrays) to the mesh."""
        header = np.zeros(_HEADER, np.int64)
        header[:2] = op, len(arrays)
        for i, a in enumerate(arrays):
            header[2 + 2 * i:4 + 2 * i] = a.shape
        self._bcast(torch.from_numpy(header), _SEND_TIMEOUT)
        if arrays:
            self._bcast(torch.from_numpy(np.concatenate(
                [np.asarray(a, np.int64).reshape(-1) for a in arrays])),
                _SEND_TIMEOUT)

    def recv(self):
        """``(op, arrays)`` of the leader's next call."""
        header = torch.zeros(_HEADER, dtype=torch.int64)
        self._bcast(header, _WAIT_TIMEOUT)
        op, n = (int(x) for x in header[:2])
        shapes = header[2:2 + 2 * n].view(n, 2).tolist()
        arrays = []
        if n:
            flat = torch.zeros(sum(r * c for r, c in shapes),
                               dtype=torch.int64)
            self._bcast(flat, _SEND_TIMEOUT)
            off = 0
            for r, c in shapes:
                arrays.append(flat[off:off + r * c].view(r, c).numpy())
                off += r * c
        return op, arrays


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
    mesh : DeviceMesh, optional
        Bind the model sharded over the mesh's ``mp`` (or ``tp``) axis:
        every rank of the mesh makes the predictor with the whole
        ``params`` and keeps its shards (``models.transformer.
        shard_params``) and its ``n_heads / mp`` heads of every KV page,
        on its mesh device. The mesh's global rank 0, the leader, makes
        every call (``prefill``, ``decode``, ``extend``, ``extend_tail``:
        each returns the whole vocabulary's logits) and closes the
        predictor (:meth:`close`); every other rank runs :meth:`follow`
        until then. Mutually exclusive with ``device``.
    """

    def __init__(self, config_, params, *, slots=None, page_size=None,
                 pool_bytes=None, max_ctx=None, device=None, mesh=None):
        if mesh is not None and device is not None:
            raise GenerateError(
                "GenerativePredictor: pass mesh= OR device=, not both (a "
                "sharded bind runs on each rank's mesh device)")
        self.config = config_
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh_device(mesh)
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

        if mesh is None:
            self._params = {
                k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    np.asarray(v))).to(device=self.device,
                                       dtype=torch.float32)
                for k, v in params.items()}
            dev = self.device
        else:
            self._params = tfm.shard_params(params, c, mesh)
            dev = None
        self._kv = tfm.init_kv_cache(c, num_pages, self.page_size,
                                     device=dev, mesh=mesh)
        self._prefill = tfm.make_prefill_fn(c, self.page_size, dev, mesh)
        self._decode = tfm.make_decode_fn(c, self.slots,
                                          self.max_pages_per_slot,
                                          self.page_size, dev, mesh)
        self._extends = {}         # (slots, steps) -> extend function
        self._lockstep = None if mesh is None else _Lockstep()

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
        page_arr = np.zeros((1, bucket // self.page_size), np.int32)
        page_arr[0, :len(pages)] = pages   # tail pages hit scratch (0)
        return self._call(_PREFILL, padded, np.array([[length]]), page_arr)

    def decode(self, tokens, positions, block_tables, active):
        """One decode step over all ``slots``; returns numpy logits
        (slots, V). ``tokens[b]`` is written at ``positions[b]`` into
        the page its slot's ``block_tables`` row names; inactive slots
        write to scratch and return zero logits."""
        return self._call(_DECODE, *(np.asarray(a).reshape(1, -1) for a in
                                     (tokens, positions, active)),
                          np.asarray(block_tables))

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
        return self._call(_EXTEND, tokens, np.asarray(positions),
                          np.asarray(block_tables), np.asarray(valid))

    def _extend_fn(self, S, T):
        fn = self._extends.get((S, T))
        if fn is None:
            fn = self._extends[(S, T)] = tfm.make_extend_fn(
                self.config, S, T, self.max_pages_per_slot, self.page_size,
                None if self.mesh is not None else self.device, self.mesh)
        return fn

    def _run(self, op, arrays):
        """One call's logits (a tensor) on this rank's shard."""
        p, kv = self._params, self._kv
        if op == _PREFILL:
            tokens, length, pages = arrays
            return self._prefill(p, kv, tokens, int(length[0, 0]),
                                 pages[0])[1]
        if op == _DECODE:
            tokens, positions, active, tables = arrays
            return self._decode(p, kv, tokens[0], positions[0], tables,
                                active[0].astype(bool))[1]
        tokens, positions, tables, valid = arrays
        return self._extend_fn(*tokens.shape)(p, kv, tokens, positions,
                                              tables, valid.astype(bool))[1]

    def _call(self, op, *arrays):
        """Run one call here (after broadcasting it to the followers on a
        mesh); numpy logits. Any failure of a sharded call breaks the
        lockstep: later calls raise."""
        ls = self._lockstep
        with self._lock:
            if ls is None:
                return self._run(op, arrays).cpu().numpy()
            if not ls.leader:
                raise GenerateError(
                    "%s: only the mesh's rank 0 calls a sharded predictor; "
                    "the other ranks run follow()" % _OP_NAMES[op])
            if ls.closed or ls.broken is not None:
                raise GenerateError("%s: the sharded predictor is %s"
                                    % (_OP_NAMES[op], "closed" if ls.closed
                                       else "broken: %s" % ls.broken))
            arrays = tuple(np.asarray(a, np.int64) for a in arrays)
            try:
                ls.send(op, arrays)
                return self._run(op, arrays).cpu().numpy()
            except Exception as e:
                ls.broken = e
                raise GenerateError("%s: a sharded call failed (the lockstep "
                                    "is broken): %s" % (_OP_NAMES[op], e)) \
                    from e

    def follow(self):
        """Run the leader's calls on this rank until the leader closes the
        predictor; returns ``{op: calls}``. Every rank but the mesh's rank
        0 calls it once, after making the predictor."""
        ls = self._lockstep
        if ls is None or ls.leader:
            raise GenerateError("follow: only the ranks but 0 of a sharded "
                                "predictor follow")
        calls = dict.fromkeys(_OP_NAMES.values(), 0)
        while True:
            op, arrays = ls.recv()
            if op == _CLOSE:
                ls.closed = True
                return calls
            with self._lock:
                self._run(op, arrays)
            calls[_OP_NAMES[op]] += 1

    def close(self):
        """On the leader of a sharded predictor, release the followers
        (their :meth:`follow` returns); later calls raise. A no-op
        otherwise, and once closed (or after a failed sharded call)."""
        ls = self._lockstep
        with self._lock:
            if ls is None or not ls.leader or ls.closed:
                return
            ls.closed = True
            if ls.broken is None:
                ls.send(_CLOSE, ())

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

    def sharded_stats(self):
        """This rank's bytes of a sharded bind, measured from its own
        tensors: the params' shards and the KV cache's heads (1/mp of every
        page), beside the whole cache's bytes; records into the profiler's
        ``mp_stats`` gauge. Raises without a mesh."""
        if self.mesh is None:
            raise GenerateError("sharded_stats: the predictor was not bound "
                                "on a mesh (pass mesh= to the constructor)")
        shape = mesh_shape(self.mesh)
        group = int(np.prod(list(shape.values())))
        mp = shape.get(_mp_axis(shape), 1)
        param_chip = sum(v.numel() * v.element_size()
                         for v in self._params.values())
        kv_chip = self._kv.numel() * self._kv.element_size()
        profiler.mp_record(group_size=group, mp_size=mp,
                           param_bytes_per_chip=param_chip,
                           live_bytes_per_chip=param_chip + kv_chip)
        return {"group_size": group, "mp_size": mp,
                "param_bytes_per_chip": param_chip,
                "kv_bytes_per_chip": kv_chip,
                "kv_bytes_total": self.page_bytes * (self.pool.num_pages + 1)}
