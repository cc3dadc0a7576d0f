"""Plain PyTorch version of the RWKV6 WKV recurrence (counterpart of
``repro/kernels/rwkv6_chunk/ref.py``), its plain backward, and the shape
check every path shares."""
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


def rwkv6_chunk_bwd_ref(r, k, v, w, u, s0, do, dsT=None):
    """The recurrence's gradient in f32, step by step: the cotangents of
    r, k, v, w, u and s0 given ``do`` (o's, ``[B, T, H, hd]``) and
    ``dsT`` (the final state's, ``[B, H, hd, hd]``; None is zeros).  With
    ``S_{t-1}`` the state before step t (a forward walk from s0) and
    ``G_t`` the cotangent of the state after it (``G_{T-1} = dsT``), for
    t = T-1 .. 0::

        dr_t[i] = sum_j do_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
        dk_t[i] = sum_j G_t[i,j] v_t[j] + r_t[i] u[i] (do_t . v_t)
        dv_t[j] = sum_i G_t[i,j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) do_t[j]
        dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
        du[i]  += sum_b r_t[i] k_t[i] (do_t . v_t)
        G_{t-1} = diag(w_t) G_t + r_t^T do_t

    and ``ds0 = G_{-1}``.  Returns ``(dr, dk, dv, dw, du, ds0)``, each in
    its input's dtype."""
    check_shapes(r, k, v, w, u, s0)
    f32 = torch.float32
    rf, kf, vf, wf, dof = (t.to(f32) for t in (r, k, v, w, do))
    uf = u.to(f32)
    B, T, H, hd = r.shape
    S = s0.to(f32, copy=True)
    before = []
    for t in range(T):
        before.append(S)
        S = wf[:, t, :, :, None] * S + kf[:, t, :, :, None] * vf[:, t, :,
                                                                None, :]
    G = (torch.zeros_like(S) if dsT is None
         else dsT.to(f32, copy=True))
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=f32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dot_ = rf[:, t], kf[:, t], vf[:, t], wf[:, t], dof[:, t]
        dov = (dot_ * vt).sum(-1, keepdim=True)            # [B, H, 1]
        dr[:, t] = torch.einsum("bhj,bhij->bhi", dot_, before[t]) \
            + uf * kt * dov
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + rt * uf * dov
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) \
            + (rt * uf * kt).sum(-1, keepdim=True) * dot_
        dw[:, t] = (G * before[t]).sum(-1)
        du += rt * kt * dov
        G = wt[..., None] * G + rt[..., None] * dot_[:, :, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype), G.to(s0.dtype))
