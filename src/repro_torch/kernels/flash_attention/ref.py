"""Plain PyTorch version of flash attention (counterpart of
``repro/kernels/flash_attention/ref.py``): naive softmax over
materialized scores, GQA by repeating K/V; and the plain version of its
backward, which the reference has none of (it differentiates its jnp
attention)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, *, causal: bool, q_offset: int,
                   kv_valid_len, device) -> torch.Tensor:
    """``[sq, skv]`` bool: key ``c`` is seen by query ``i`` when ``c <
    kv_valid_len`` and, if causal, ``c <= i + q_offset``."""
    k_pos = torch.arange(skv, device=device)
    valid = skv if kv_valid_len is None else int(kv_valid_len)
    mask = (k_pos < valid)[None, :]
    if causal:
        q_pos = torch.arange(sq, device=device) + q_offset
        return mask & (k_pos[None, :] <= q_pos[:, None])
    return mask.expand(sq, skv)


def _probs(q, k, *, causal, q_offset, kv_valid_len):
    """The softmax of the masked scores ``[B, H, Sq, Skv]`` in f32, K
    repeated per group; also returns the mask and K repeated."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // KV, dim=2).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kr) / (hd ** 0.5)
    mask = attention_mask(Sq, Skv, causal=causal, q_offset=q_offset,
                          kv_valid_len=kv_valid_len, device=q.device)
    s = torch.where(mask[None, None], s, s.new_tensor(NEG_INF))
    return torch.softmax(s, dim=-1), mask, kr


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0,
                        kv_valid_len=None):
    """q ``[B, Sq, H, hd]``, k and v ``[B, Skv, KV, hd]`` -> ``[B, Sq, H,
    hd]`` of q's dtype, computed in f32.  A row that sees no key gets the
    mean of V over the ``Skv`` keys (every score is -1e30)."""
    H, KV = q.shape[2], k.shape[2]
    p, _, _ = _probs(q, k, causal=causal, q_offset=q_offset,
                     kv_valid_len=kv_valid_len)
    vr = v.repeat_interleave(H // KV, dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    return o.to(q.dtype)


def _group_sum(t, kv):
    """``[B, Skv, H, hd]`` -> ``[B, Skv, KV, hd]``: each kv head's sum over
    the q heads that read it, in f32."""
    B, S, H, hd = t.shape
    return t.reshape(B, S, kv, H // kv, hd).sum(3)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal=True, q_offset=0,
                            kv_valid_len=None):
    """The gradient of :func:`flash_attention_ref` at ``(q, k, v)`` for the
    cotangent ``do`` of its output ``o``: ``(dq, dk, dv)`` in the inputs'
    dtypes, computed in f32 from the materialized probabilities P::

        D = rowsum(do * o),  dV = P^T do,  dS = P (do V^T - D)
        dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd)

    with dS 0 where a key is masked (its score is the constant -1e30) and
    dK, dV summed over each kv head's group in f32.  D is read from ``o``
    as given, which for bf16 is the rounded output where autograd of the
    plain version sees the f32 one."""
    hd, KV = q.shape[3], k.shape[2]
    f32 = torch.float32
    p, mask, kr = _probs(q, k, causal=causal, q_offset=q_offset,
                         kv_valid_len=kv_valid_len)
    vr = v.repeat_interleave(q.shape[2] // KV, dim=2).to(f32)
    dof = do.to(f32)
    delta = (dof * o.to(f32)).sum(-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = torch.where(mask[None, None], p * (dp - delta), p.new_zeros(()))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) / (hd ** 0.5)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f32)) / (hd ** 0.5)
    return (dq.to(q.dtype), _group_sum(dk, KV).to(k.dtype),
            _group_sum(dv, KV).to(v.dtype))
