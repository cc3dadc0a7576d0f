"""Plain PyTorch version of fused_mlp (counterpart of
``repro/kernels/fused_mlp/ref.py``): the CPU path and the kernel's
yardstick on the card, computed in f32 as the JAX oracle does."""
from __future__ import annotations

import torch

from repro_torch.nn.layers import ACTS


def fused_mlp_ref(x, weights, biases, acts):
    h = x.to(torch.float32)
    for w, b, a in zip(weights, biases, acts):
        h = ACTS[a](h @ w + b)
    return h.to(x.dtype)
