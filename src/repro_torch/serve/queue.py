"""Flush policy of the serve queue (copied from ``repro/serve/queue.py``).

Only :class:`FlushPolicy` so far: the tuner takes its default buckets
from it.  ``ServeQueue``, ``ServeFuture`` and backpressure wait for the
port of the serving layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """When to coalesce-and-dispatch, and how much may wait."""

    max_batch_rows: int = 1024        # flush a key at this many pending rows
    max_delay_s: Optional[float] = None   # deadline flush (None: no deadline)
    min_bucket: int = 8               # smallest padded bucket
    max_pending_rows: int = 8192      # backpressure across all keys
    block: bool = True                # submit blocks when full vs raises
    block_timeout_s: float = 30.0     # blocked submit gives up after this
