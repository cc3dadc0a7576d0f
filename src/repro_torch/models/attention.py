"""Attention in plain PyTorch (counterpart of
``repro/models/attention.py``): the naive and the chunked online-softmax
forms, and the KV-head repeat.

These are the counterparts of the reference's jnp oracles.  The LM does
not call them on the card: its GQA mixer routes attention through
:func:`~repro_torch.kernels.flash_attention.ops.flash_attention_op`,
which takes K/V at their own head count.  All inputs are ``[B, S, H,
hd]``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq, skv, *, causal, q_offset, kv_valid_len, k_pos, device):
    """``[sq, len(k_pos)]`` bool: key position ``c`` is seen by query
    ``i`` when ``c < kv_valid_len`` (``skv`` when None) and, if causal,
    ``c <= i + q_offset``."""
    valid = skv if kv_valid_len is None else kv_valid_len
    mask = (k_pos < valid)[None, :]
    if causal:
        q_pos = torch.arange(sq, device=device) + q_offset
        return mask & (k_pos[None, :] <= q_pos[:, None])
    return mask.expand(sq, k_pos.shape[0])


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                      q_offset=0, kv_valid_len=None, unroll: bool = False):
    """Online-softmax attention over ``chunk``-sized K/V blocks.

    q ``[B, Sq, H, hd]``; k ``[B, Skv, H, hd]``; v ``[B, Skv, H, vd]``
    (``vd`` may differ from ``hd``, as in MLA).  The probabilities are
    rounded to bf16 before ``p @ v`` (the max, denominator and
    accumulator stay f32), as the reference's scan keeps them.
    ``unroll`` is the reference's scan option and changes nothing here.
    Returns ``[B, Sq, H, vd]`` in q's dtype.
    """
    del unroll
    B, Sq, H, hd = q.shape
    vd, Skv = v.shape[-1], k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    f32 = torch.float32
    qf = q.to(f32)
    acc = torch.zeros((B, H, Sq, vd), dtype=f32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=f32, device=q.device)
    for start in range(0, Skv, chunk):
        kb, vb = k[:, start:start + chunk], v[:, start:start + chunk]
        k_pos = start + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(f32)) * scale
        if kb.shape[1] < chunk:  # the reference's zero padding, masked
            s = torch.nn.functional.pad(s, (0, chunk - kb.shape[1]))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0,
                                              0, chunk - vb.shape[1]))
        mask = _mask(Sq, Skv, causal=causal, q_offset=q_offset,
                     kv_valid_len=kv_valid_len, k_pos=k_pos,
                     device=q.device)
        s = torch.where(mask[None, None], s, s.new_tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).to(f32), vb.to(f32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, q_offset=0, kv_valid_len=None):
    """Plain softmax attention over materialized f32 scores (the decode
    path and oracle of the reference)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = _mask(Sq, Skv, causal=causal, q_offset=q_offset,
                 kv_valid_len=kv_valid_len,
                 k_pos=torch.arange(Skv, device=q.device), device=q.device)
    s = torch.where(mask[None, None], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.to(torch.float32))
    return out.transpose(1, 2).to(q.dtype)


def repeat_kv(k, n_rep: int, target_heads: int):
    """KV heads ``[B, S, KV, hd]`` gathered to ``target_heads`` (the
    padded query head count): head ``h`` takes kv head ``min(h // n_rep,
    KV - 1)``."""
    KV = k.shape[2]
    idx = torch.clamp(torch.arange(target_heads, device=k.device) // n_rep,
                      max=KV - 1)
    return k.index_select(2, idx)
