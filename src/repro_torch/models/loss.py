"""Embedding lookup of the LM (counterpart of ``repro/models/loss.py``).

Only the forward of ``embed_lookup`` is ported, for serving; the losses
and the gather's sharded backward wait for the training slice.
"""
from __future__ import annotations


def embed_lookup(embed, tokens):
    """Rows of ``embed`` ``[V, D]`` at ``tokens`` ``[...]``: ``[..., D]``."""
    return embed[tokens]
