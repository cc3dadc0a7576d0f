"""Rotary position embeddings (counterpart of ``repro/models/rope.py``):
standard RoPE, Qwen2-VL's M-RoPE and Whisper's sinusoidal table.

Frequencies and angles are computed in f32, as the reference's jnp code
does (a float64 ``theta ** (i / half)`` rounds differently in the last
bits, which shows at positions in the thousands); the rotation runs in
f32 and is cast back to the input's dtype.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (i / half)`` for ``i < head_dim // 2``, in f32."""
    half = head_dim // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / half))


def _rotate(x, ang):
    """x ``[..., S, H, hd]`` rotated by angles ``ang`` ``[..., S, hd/2]``."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x ``[..., S, H, hd]``; positions ``[..., S]`` integers
    (broadcastable)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x, position_ids, theta: float, sections):
    """Qwen2-VL multimodal RoPE.  x ``[B, S, H, hd]``; position_ids ``[3,
    B, S]`` (temporal, height, width); ``sections`` split the hd/2
    frequencies among the three components."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"hd/2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    parts, start = [], 0
    for c, sec in enumerate(sections):
        pos = position_ids[c].to(device=x.device, dtype=torch.float32)
        parts.append(pos[..., None] * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


def sinusoidal(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table ``[length, dim]`` in f32."""
    half = dim // 2
    log_ts = torch.log(torch.tensor(10000.0, device=device))
    scale = torch.exp(-log_ts * torch.arange(half, device=device)
                      / (half - 1))
    pos = torch.arange(length, device=device)[:, None] * scale[None, :]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=1)
