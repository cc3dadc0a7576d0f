"""Plain PyTorch version of flash attention (counterpart of
``repro/kernels/flash_attention/ref.py``): naive softmax over
materialized scores, GQA by repeating K/V."""
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


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0,
                        kv_valid_len=None):
    """q ``[B, Sq, H, hd]``, k and v ``[B, Skv, KV, hd]`` -> ``[B, Sq, H,
    hd]`` of q's dtype, computed in f32.  A row that sees no key gets the
    mean of V over the ``Skv`` keys (every score is -1e30)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    group = H // KV
    kr = k.repeat_interleave(group, dim=2)
    vr = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     kr.to(torch.float32)) / (hd ** 0.5)
    mask = attention_mask(Sq, Skv, causal=causal, q_offset=q_offset,
                          kv_valid_len=kv_valid_len, device=q.device)
    s = torch.where(mask[None, None], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    return o.to(q.dtype)
