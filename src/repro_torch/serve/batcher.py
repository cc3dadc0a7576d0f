"""Power-of-two batch buckets (copied from ``repro/serve/batcher.py``).

The coalescing ``Batcher`` itself waits for the port of ``serve/``.
"""
from __future__ import annotations


def bucket_size(n: int, min_bucket: int = 8) -> int:
    """Smallest power-of-two >= max(n, min_bucket)."""
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b


def bucket_for(n: int, min_bucket: int, n_shards: int = 1) -> int:
    """Dispatch bucket: power-of-two floor, rounded up to a multiple of
    the data-shard count."""
    b = bucket_size(n, max(min_bucket, n_shards))
    if n_shards > 1 and b % n_shards:
        b += -b % n_shards
    return b
