"""Deterministic, seekable data pipeline (counterpart of
``repro/data/pipeline.py``, numpy only; the port keeps its own copy).

``batch_at(step)`` is a pure function of (seed, step, host slice): a
restart or an elastic re-scale replays nothing and skips nothing.  The
data order is the same whether a step is produced before or after a
failure, and a re-sharded job (another dp_rank/dp_size split) still
covers the global batch exactly once.  The arrays are the reference's,
bit for bit.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    """Synthetic LM token stream (markov-ish mixture so loss can fall)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, dp_rank: int = 0, dp_size: int = 1):
        if global_batch % dp_size:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {dp_size} ranks")
        self.V, self.S = vocab_size, seq_len
        self.B = global_batch
        self.local_B = global_batch // dp_size
        self.rank, self.size = dp_rank, dp_size
        self.seed = seed

    def batch_at(self, step: int):
        """Returns dict(tokens, targets), int32 numpy ``[local_B, S]``, for
        this host's slice of `step`."""
        lo = self.rank * self.local_B
        rows = [self._row(step, lo + i) for i in range(self.local_B)]
        toks = np.stack(rows)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def _row(self, step: int, row: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))
        # structured stream: arithmetic progressions + noise -> learnable
        start = rng.integers(0, self.V)
        stride = rng.integers(1, 7)
        seq = (start + stride * np.arange(self.S + 1)) % self.V
        noise = rng.random(self.S + 1) < 0.1
        seq = np.where(noise, rng.integers(0, self.V, self.S + 1), seq)
        return seq

    def reshard(self, dp_rank: int, dp_size: int):
        """Elastic re-split: same global order, new host slice."""
        return TokenPipeline(self.V, self.S, self.B, self.seed,
                             dp_rank, dp_size)
