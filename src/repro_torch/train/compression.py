"""Gradient compression: int8 quantization with error feedback
(counterpart of ``repro/train/compression.py``).

Each leaf is quantized to int8 at a per-leaf scale and dequantized; the
quantization error is carried in an f32 error-feedback residual added
to the next step's gradient.  ``wire_bytes`` gives the analytic wire
saving of one cross-pod all-reduce: the port runs on one card, so no
collective carries the int8 payload yet (ROADMAP item 9b-ii).
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def _q_leaf(g, r):
    gf = g.to(torch.float32) + r
    # a true division by a tensor: on the card, a tensor divided by a
    # Python number is a multiply by its reciprocal
    scale = torch.clamp(gf.abs().max(), min=1e-12) / gf.new_tensor(127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq.to(g.dtype), gf - deq


def init_residual(grads):
    """Zero f32 residuals shaped as ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


@torch.no_grad()
def ef_compress(grads, residual):
    """Returns (dequantized grads, new residual)."""
    errs = []

    def leaf(g, r):
        deq, err = _q_leaf(g, r)
        errs.append(err)
        return deq
    deq = tree_map(leaf, grads, residual)
    it = iter(errs)  # tree_map visits the leaves in the same order
    return deq, tree_map(lambda g: next(it), grads)


def wire_bytes(grads, dtype_bytes=4):
    """(uncompressed, int8) wire bytes for one cross-pod all-reduce."""
    leaves = tree_leaves(grads)
    n = sum(x.numel() for x in leaves)
    return n * dtype_bytes, n * 1 + 4 * len(leaves)
