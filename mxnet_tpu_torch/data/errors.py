"""Typed failure hierarchy for the sharded dataset service (counterpart
of ``mxnet_tpu/data/errors.py``: the same classes and bases).

Every data-plane failure the reader can hit mid-epoch maps to exactly
one of these classes, mirroring the schedule-table treatment in
``tune/table.py``: the reader logs what it saw and raises the typed
error — never a silent record skip (which would break the
exactly-once ledger) and never an untyped crash (which the elastic
supervisor could not tell apart from a training bug).

- :class:`LeaseLostError` — the tracker rebalanced this worker's
  shard lease away (TTL expiry or epoch roll). Honest and
  recoverable: a respawned worker re-acquires and resumes at the
  committed cursor.
- :class:`CursorCorruptError` — a resume cursor is out of range or
  moved backwards; reading from it would double- or under-consume.
- :class:`ShardCorruptError` — a record-shard file is truncated,
  has a garbage magic, or yields fewer records than its manifest
  entry promises.
- :class:`ManifestCorruptError` — the dataset manifest is missing,
  not JSON, the wrong shape, the wrong version, or has a malformed
  shard entry (the 5-way matrix).
"""
from __future__ import annotations

from ..base import MXNetError


class DataPlaneError(MXNetError):
    """Base class for all sharded-data-service failures."""


class LeaseLostError(DataPlaneError):
    """The shard lease was rebalanced away while this worker held it."""


class CursorCorruptError(DataPlaneError):
    """A within-shard resume cursor is out of range or went backwards."""


class ShardCorruptError(DataPlaneError):
    """A record-shard file is truncated or contains garbage records."""


class ManifestCorruptError(DataPlaneError):
    """The dataset manifest is unreadable, malformed, or mismatched."""
