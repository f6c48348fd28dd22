"""Shard-lease bookkeeping for the sharded dataset service (counterpart of
``mxnet_tpu/data/lease.py``: the same state machine, return values and
errors).

One :class:`ShardLeaseBook` tracks one dataset's epoch state: which
worker rank holds which record-file shard, the within-shard resume
cursor (record index) each holder last committed, and which shards are
finished for the current epoch. The book is **pure state** — no
sockets, no threads, no clock of its own (callers pass ``now`` from
``time.monotonic()``) — so the exact same arithmetic runs embedded in
the job tracker (``tracker.Tracker``'s ``data_*`` ops, under the
tracker's condition lock; the JAX package's tracker runs the same state
machine) and in-process behind :class:`LocalLeaseAuthority` for
single-worker jobs, benches and tests.

Exactly-once-per-epoch contract:

- a shard is leased to at most one rank at a time; the lease carries
  the shard id and the resume cursor, and must be renewed (cursor
  commit) before ``ttl`` elapses or it returns to the pool;
- a dead/closed rank's unfinished shards return to the pool with
  their cursors intact (``release_owner``) — the next acquirer, the
  rank's own respawn or a survivor, resumes at the committed cursor;
- the epoch advances only when every shard was completed at exactly
  its record count, and rolling resets every cursor to zero.

This module is stdlib-only.
"""
from __future__ import annotations


class LeaseError(ValueError):
    """A lease op was structurally invalid (bad shard id, cursor out
    of range, cursor moving backwards, mismatched re-registration).
    The data-plane client wraps this into the typed
    ``DataPlaneError`` hierarchy at the reader."""


class ShardLeaseBook:
    """Per-dataset lease state machine. Not thread-safe: the embedding
    context (tracker / LocalLeaseAuthority) provides the lock."""

    def __init__(self, name, shard_records, ttl):
        if not isinstance(shard_records, (list, tuple)) or not shard_records:
            raise LeaseError(
                "dataset %r: shard_records must be a non-empty list of "
                "record counts, got %r" % (name, shard_records))
        counts = []
        for i, n in enumerate(shard_records):
            if isinstance(n, bool) or not isinstance(n, int) or n < 0:
                raise LeaseError(
                    "dataset %r: shard %d record count %r is not an "
                    "integer >= 0" % (name, i, n))
            counts.append(int(n))
        self.name = str(name)
        self.ttl = float(ttl)
        if not self.ttl > 0:
            raise LeaseError("dataset %r: lease ttl must be > 0, got %r"
                             % (name, ttl))
        self.epoch = 0
        self.rebalances = 0          # leases returned by death/close/TTL
        self.shards = [
            {"shard": i, "records": n, "cursor": 0, "owner": None,
             "deadline": 0.0, "done": False, "last_owner": None}
            for i, n in enumerate(counts)]

    # -- helpers -----------------------------------------------------------
    def record_counts(self):
        return [s["records"] for s in self.shards]

    def _shard(self, shard):
        if not isinstance(shard, int) or isinstance(shard, bool) \
                or not 0 <= shard < len(self.shards):
            raise LeaseError(
                "dataset %r: shard id %r out of range [0, %d)"
                % (self.name, shard, len(self.shards)))
        return self.shards[shard]

    def _check_cursor(self, s, cursor, op):
        if isinstance(cursor, bool) or not isinstance(cursor, int) \
                or cursor < 0 or cursor > s["records"]:
            raise LeaseError(
                "dataset %r shard %d: %s cursor %r out of range "
                "[0, %d]" % (self.name, s["shard"], op, cursor,
                             s["records"]))
        if cursor < s["cursor"]:
            raise LeaseError(
                "dataset %r shard %d: %s cursor %d moved backwards "
                "(committed %d) — a rewound cursor would re-consume "
                "records" % (self.name, s["shard"], op, cursor,
                             s["cursor"]))

    # -- ops ---------------------------------------------------------------
    def expire(self, now):
        """Return TTL-expired leases to the pool (cursors kept).
        Returns the released ``[{"shard", "rank", "cursor"}]``."""
        released = []
        for s in self.shards:
            if s["owner"] is not None and now > s["deadline"]:
                released.append({"shard": s["shard"], "rank": s["owner"],
                                 "cursor": s["cursor"]})
                s["last_owner"] = s["owner"]
                s["owner"] = None
                self.rebalances += 1
        return released

    def release_owner(self, rank, now):
        """A rank died / closed its stream: every shard it holds
        returns to the pool with its committed cursor — the rebalance
        the elastic-respawn story depends on. Returns the released
        ``[{"shard", "cursor"}]``."""
        released = []
        for s in self.shards:
            if s["owner"] == rank:
                released.append({"shard": s["shard"],
                                 "cursor": s["cursor"]})
                s["last_owner"] = rank
                s["owner"] = None
                self.rebalances += 1
        return released

    def acquire(self, rank, epoch, now):
        """One rank asks for work in ``epoch``. Replies (plain dict,
        wire-safe) with ``status`` one of:

        - ``lease``: shard id + resume cursor + record count; prefers
          the rank's own previous shards (a respawn resumes exactly
          where its predecessor committed), then the lowest free id;
        - ``epoch_done``: every shard completed for ``epoch`` — the
          caller moves to ``epoch + 1``;
        - ``wait``: free shards exhausted but peers still hold leases
          (retry shortly);
        - ``behind``: the book already rolled past ``epoch`` (the
          caller fast-forwards to the returned ``epoch``).
        """
        if isinstance(epoch, bool) or not isinstance(epoch, int) \
                or epoch < 0:
            raise LeaseError("dataset %r: epoch %r is not an integer >= 0"
                             % (self.name, epoch))
        self.expire(now)
        if epoch == self.epoch + 1 \
                and all(s["done"] for s in self.shards):
            self.epoch += 1
            for s in self.shards:
                s["cursor"] = 0
                s["owner"] = None
                s["deadline"] = 0.0
                s["done"] = False
        if epoch < self.epoch:
            return {"status": "behind", "epoch": self.epoch}
        if epoch > self.epoch:
            # asking for a future epoch while this one still runs
            return {"status": "wait", "epoch": self.epoch}
        free = [s for s in self.shards
                if not s["done"] and s["owner"] is None]
        if not free:
            if all(s["done"] for s in self.shards):
                return {"status": "epoch_done", "epoch": self.epoch}
            return {"status": "wait", "epoch": self.epoch}
        mine = [s for s in free if s["last_owner"] == rank]
        s = min(mine or free, key=lambda s: s["shard"])
        rebalanced = s["last_owner"] is not None \
            and s["last_owner"] != rank
        s["owner"] = rank
        s["deadline"] = now + self.ttl
        return {"status": "lease", "epoch": self.epoch,
                "shard": s["shard"], "cursor": s["cursor"],
                "records": s["records"], "rebalanced": rebalanced,
                "resumed": s["cursor"] > 0}

    def renew(self, rank, epoch, shard, cursor, now):
        """Commit a cursor and refresh the lease deadline. Returns
        ``{"ok": True, "cursor": c}`` or — when the lease was
        rebalanced away / the epoch rolled — ``{"ok": False, "lost":
        reason}`` so the holder can raise the typed lease-lost error
        (no string-matching on transport errors)."""
        s = self._shard(shard)
        if epoch != self.epoch:
            return {"ok": False,
                    "lost": "epoch rolled to %d (lease was for %d)"
                            % (self.epoch, epoch)}
        if s["owner"] != rank:
            return {"ok": False,
                    "lost": "shard %d is %s (lease holder is now %r)"
                            % (shard,
                               "done" if s["done"] else "rebalanced",
                               s["owner"])}
        self._check_cursor(s, cursor, "renew")
        s["cursor"] = cursor
        s["deadline"] = now + self.ttl
        return {"ok": True, "cursor": cursor}

    def complete(self, rank, epoch, shard, cursor, now):
        """Mark a shard finished for the epoch. The cursor must equal
        the shard's record count — completing early would silently
        skip the tail, the exact failure the exactly-once contract
        exists to prevent. Idempotent for the completing rank."""
        s = self._shard(shard)
        if epoch != self.epoch:
            return {"ok": False,
                    "lost": "epoch rolled to %d (completion was for %d)"
                            % (self.epoch, epoch)}
        if s["done"]:
            return {"ok": True, "epoch_done":
                    all(x["done"] for x in self.shards)}
        if s["owner"] != rank:
            return {"ok": False,
                    "lost": "shard %d rebalanced (holder is now %r)"
                            % (shard, s["owner"])}
        if cursor != s["records"]:
            raise LeaseError(
                "dataset %r shard %d: completed at cursor %d but the "
                "shard has %d records — refusing to mark a partially "
                "read shard done" % (self.name, shard, cursor,
                                     s["records"]))
        s["cursor"] = cursor
        s["done"] = True
        s["owner"] = None
        s["last_owner"] = rank
        return {"ok": True,
                "epoch_done": all(x["done"] for x in self.shards)}

    def snapshot(self):
        """Plain-data view (tests / the tracker's data_state op)."""
        return {"name": self.name, "epoch": self.epoch,
                "ttl": self.ttl, "rebalances": self.rebalances,
                "shards": [dict(s) for s in self.shards]}


class LocalLeaseAuthority:
    """In-process lease authority for jobs with no tracker topology
    (single worker, benches, unit tests): the same ShardLeaseBook
    arithmetic behind a thread lock and a real clock. Several streams
    may share one authority to exercise rebalance/handoff locally."""

    def __init__(self, ttl=None):
        import threading
        import time

        self._lock = threading.Lock()
        self._books = {}
        self._ttl = ttl
        self._clock = time.monotonic

    def _resolve_ttl(self):
        if self._ttl is not None:
            return float(self._ttl)
        from .. import config

        return config.get_positive_float("MXNET_DATA_LEASE_TTL")

    def data_init(self, name, shards):
        with self._lock:
            book = self._books.get(name)
            if book is None:
                book = ShardLeaseBook(name, list(shards),
                                      self._resolve_ttl())
                self._books[name] = book
            elif book.record_counts() != [int(n) for n in shards]:
                raise LeaseError(
                    "dataset %r already registered with different "
                    "shards (%r != %r)" % (name, book.record_counts(),
                                           list(shards)))
            return {"epoch": book.epoch, "shards": len(book.shards)}

    def _book(self, name):
        book = self._books.get(name)
        if book is None:
            raise LeaseError("dataset %r was never data_init'd" % name)
        return book

    def data_acquire(self, name, rank, epoch):
        with self._lock:
            return self._book(name).acquire(rank, epoch, self._clock())

    def data_renew(self, name, rank, epoch, shard, cursor):
        with self._lock:
            return self._book(name).renew(rank, epoch, shard, cursor,
                                          self._clock())

    def data_complete(self, name, rank, epoch, shard, cursor):
        with self._lock:
            return self._book(name).complete(rank, epoch, shard, cursor,
                                             self._clock())

    def data_release(self, name, rank):
        with self._lock:
            return self._book(name).release_owner(rank, self._clock())

    def data_state(self, name):
        with self._lock:
            return self._book(name).snapshot()
