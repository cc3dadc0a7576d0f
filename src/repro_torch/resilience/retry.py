"""Retry policy for transient dispatch failures (counterpart of
``repro/resilience/retry.py``).

Capped exponential backoff with deterministic-seedable jitter.  The
batcher retries the gather→apply→to_host pipeline under this policy
before failing futures; engine/bundle *load* failures never retry (they
are deterministic, not transient — see ``Batcher.dispatch``).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: delay(k) = min(base * 2**k, max) with
    up to ``jitter`` fractional randomization to decorrelate retries."""

    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 0.25
    jitter: float = 0.5
    seed: Optional[int] = None

    def delay_for(self, attempt: int, rng: Optional[random.Random] = None
                  ) -> float:
        """Backoff delay after failed attempt ``attempt`` (0-indexed)."""
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        if self.jitter <= 0.0:
            return d
        if rng is None:
            rng = random.Random(self.seed) if self.seed is not None \
                else random
        return d * (1.0 - self.jitter * rng.random())


#: default policy used by the batcher
DEFAULT_RETRY = RetryPolicy()
