"""Plain PyTorch version of the RWKV6 WKV recurrence (counterpart of
``repro/kernels/rwkv6_chunk/ref.py``), and the shape check every path
shares."""
from __future__ import annotations

import torch


def check_shapes(r, k, v, w, u, s0) -> None:
    """Raise ``ValueError`` unless r, k, v, w are ``[B, T, H, hd]``, u is
    ``[H, hd]`` and s0 is ``[B, H, hd, hd]``."""
    if r.ndim != 4:
        raise ValueError(f"r must be [B, T, H, hd], got {tuple(r.shape)}")
    B, T, H, hd = r.shape
    for name, t, want in (("k", k, r.shape), ("v", v, r.shape),
                          ("w", w, r.shape), ("u", u, (H, hd)),
                          ("s0", s0, (B, H, hd, hd))):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} must be {tuple(want)}, got "
                             f"{tuple(t.shape)}")


def rwkv6_chunk_ref(r, k, v, w, u, s0):
    """The sequential recurrence in f32, step by step::

        o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
        S_t = diag(w_t) S_{t-1} + k_t^T v_t

    r, k, v, w: ``[B, T, H, hd]``; u: ``[H, hd]``; s0: ``[B, H, hd, hd]``.
    Returns ``(o [B, T, H, hd] in r's dtype, sT [B, H, hd, hd] f32)``.
    """
    check_shapes(r, k, v, w, u, s0)
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = s0.to(torch.float32, copy=True)
    o = torch.empty_like(rf)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # [B, H, hd, hd]
        o[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf * kv)
        S = wf[:, t, :, :, None] * S + kv
    return o.to(r.dtype), S
