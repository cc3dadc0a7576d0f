"""Layer blocks of the LM (counterpart of ``repro/models/blocks.py``):
the norms, the GQA (and, with ``cross_kv``, an encoder-decoder's cross
attention), MLA, RWKV6 and Mamba mixers, and the swiglu, gelu, MoE and
RWKV channel-mix MLPs.

Each mixer exposes, as in the reference:
  ``<name>_init(gen, cfg)``                   -> param dict
  ``<name>_seq(cfg, p, x, *, positions, position_ids)`` -> (y, cache)
  ``<name>_step(cfg, p, x, state, pos, *, position_ids)`` -> (y, state)
  ``<name>_init_cache(cfg, batch, cache_len, dtype, device)``
with parameters and states as dicts of tensors under the reference's
key names.  Randomness comes from the ``torch.Generator`` passed in, on
the device the parameters are made on.

The reference computes GQA attention in jnp (``full_attention``, or
``chunked_attention`` past 2,048 x 2,048 scores, over K/V repeated to
the padded head count); the port runs it through
:func:`~repro_torch.kernels.flash_attention.ops.flash_attention_op`,
the hand-written kernel on the card, with K/V at their own head count
(the kernel reads kv head ``h // (H / KV)``).  It computes RWKV6's WKV
recurrence over a sequence with its own chunked associative scan
(``lax.scan`` over chunks, blocks.py:457-479) and the one-token update
with einsums; the port runs both through
:func:`~repro_torch.kernels.rwkv6_chunk.ops.rwkv6_chunk_op`.  Each is
the same function: the reference's own tests hold its jnp code equal to
the kernel's oracle.  MLA's prefill attention (q.k heads of 192 over v
heads of 128) runs through the same kernel, which takes a v head of its
own width; its absorbed decode step and the MoE MLP (router, capacity
dispatch, expert products, combine) have no Pallas kernel in the
reference and stay torch einsums and indexing here, their products on
cuBLAS.  Mamba's selective scan over a sequence (the reference's
chunked associative scan in jnp, blocks.py:563-586) runs through
:func:`~repro_torch.kernels.mamba_scan.ops.mamba_scan_op`, a kernel the
port adds; its one-token step stays plain torch, which rounds where the
reference's step rounds (it rounds ``dt * x`` to the model dtype, where
the sequence form takes both in f32).
The reference's sharding hints (``constrain``) stand at its sites in
the GQA mixer and the dense MLPs: no-ops without a mesh, a DTensor
redistribution under one.  Under a mesh the attention kernel runs on
each rank's local heads and rows (:func:`_attention`, a ``local_map``
on the heads' placement), so the registry dispatches only local tensors,
and MoE tokens route in groups aligned to the batch shards
(:func:`_moe_groups`).  The port pads no query heads
(:func:`_padded_heads`): its kernel takes K/V at their own head count.
The MLA, MoE-expert, Mamba and RWKV6 sites are not placed yet (ROADMAP
item 9b-ii); under a mesh those mixers run on DTensor's own layouts.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (block_offset, constrain, current_ctx,
                                       is_dtensor, matmul)
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.mamba_scan.ops import mamba_scan_op
from repro_torch.kernels.rwkv6_chunk.ops import rwkv6_chunk_op
from repro_torch.models import rope as rope_lib
from repro_torch.models.attention import NEG_INF, repeat_kv


def _dense_init(gen, shape, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


# ---------------------------------------------------------------- norms ----
def norm_init(cfg, device):
    d = cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.torch_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.torch_dtype, device=device)
    return p


def apply_norm(cfg, p, x, eps=1e-6):
    """LayerNorm or RMSNorm over the last axis, in f32 (eps 1e-6, the
    reference's), cast back to x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_head(x, scale, eps=1e-6):
    """Per-head RMS norm over the last axis (qwen3's qk_norm), in f32,
    cast back to x's dtype."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * scale.to(torch.float32)).to(x.dtype)


def _act(name):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    if name == "silu":
        return F.silu
    return functools.partial(F.gelu, approximate="tanh")


# ------------------------------------------------------------- GQA mixer ---
def gqa_init(gen, cfg, cross=False):
    """GQA's projections (``bq``/``bk``/``bv`` with ``qkv_bias``, qwen3's
    ``q_norm``/``k_norm`` with ``qk_norm``); a ``cross`` attention's have
    no q/k norm, as in the reference."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt, dev = cfg.torch_dtype, gen.device
    p = {"wq": _dense_init(gen, (d, H * hd), dt),
         "wk": _dense_init(gen, (d, KV * hd), dt),
         "wv": _dense_init(gen, (d, KV * hd), dt),
         "wo": _dense_init(gen, (H * hd, d), dt)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((KV * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((KV * hd,), dtype=dt, device=dev)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def _padded_heads(cfg, tp=16):
    """The reference's query head count padded to a multiple of ``tp``
    for tensor parallelism (llama3.2-3b: 24 -> 32).  The port runs on
    one card and pads nothing: the padded heads' outputs are sliced off
    in the reference, so the result is the same (pinned in
    tests/test_torch_gqa.py)."""
    H = cfg.n_heads
    return ((H + tp - 1) // tp) * tp if H % tp else H


def _project_qkv(cfg, p, x, positions, position_ids=None):
    """q ``[B, S, H, hd]`` and k, v ``[B, S, KV, hd]`` of x ``[B, S, d]``,
    with bias, qk-norm and the rotary embedding at ``positions`` ``[S]``
    (``position_ids`` ``[3, B, S]`` for mrope)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = _heads(q, H, hd), _heads(k, KV, hd), _heads(v, KV, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_head(q, p["q_norm"])
        k = rms_head(k, p["k_norm"])
    if cfg.rope == "rope":
        q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
        k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        if position_ids is None:
            raise ValueError(f"{cfg.name}: mrope needs position_ids "
                             f"[3, B, S]")
        q = rope_lib.apply_mrope(q, position_ids, cfg.rope_theta,
                                 cfg.mrope_sections)
        k = rope_lib.apply_mrope(k, position_ids, cfg.rope_theta,
                                 cfg.mrope_sections)
    return q, k, v


def _heads(t, n: int, hd: int):
    """``[B, S, n * hd]`` as ``[B, S, n, hd]``.  A DTensor whose last dim
    is split finer than whole heads (``n`` does not divide its shards)
    is gathered on it first: DTensor cannot split a shard across the
    head boundary."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        pl, sizes = t.placements, t.device_mesh.shape
        m = 1
        for i, pi in enumerate(pl):
            if pi.is_shard(t.ndim - 1):
                m *= sizes[i]
        if n % m:
            t = t.redistribute(t.device_mesh, [
                Replicate() if pi.is_shard(t.ndim - 1) else pi for pi in pl])
    return t.reshape(*t.shape[:-1], n, hd)


def _cross_q(cfg, p, x):
    """A cross attention's query ``[B, S, H, hd]``: x's projection (with
    ``bq`` under ``qkv_bias``), no norm and no rotation."""
    q = matmul(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    return _heads(q, cfg.n_heads, cfg.head_dim)


def gqa_seq(cfg, p, x, *, positions, position_ids=None, causal=True,
            cross_kv=None):
    """Attention over a sequence x ``[B, S, d]`` at ``positions``
    ``[S]``.  Returns ``(y, (k, v))``, k and v ``[B, S, KV, hd]`` for the
    cache.  With ``cross_kv`` (the encoder's k and v ``[B, Se, KV, hd]``)
    it is cross attention: only q is projected, and every query sees
    every key (``causal`` is ignored); ``(k, v)`` are ``cross_kv``."""
    B, S, _ = x.shape
    if cross_kv is not None:
        q, (k, v), causal = _cross_q(cfg, p, x), cross_kv, False
    else:
        q, k, v = _project_qkv(cfg, p, x, positions, position_ids)
    q = constrain(q, "batch", None, "heads", None)
    k_h = constrain(k, "batch", None, "heads", None)
    v_h = constrain(v, "batch", None, "heads", None)
    o = _attention(q, k_h, v_h, causal=causal)
    return matmul(o.reshape(B, S, -1), p["wo"]), (k, v)


def _attention(q, k, v, *, causal):
    """``flash_attention_op`` on plain tensors; on DTensors (under a
    mesh) on each rank's local rows and heads, through ``local_map`` on
    q's placement.  A rank whose query heads cover whole groups of its
    kv heads' block reads that block; otherwise (kv heads replicated
    where their count does not divide the shards) its kv heads are
    repeated to the query heads it holds."""
    if not is_dtensor(q):
        return flash_attention_op(q, k, v, causal=causal, q_offset=0)
    from torch.distributed.tensor.experimental import local_map
    H, KV = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    q_off = block_offset(mesh, q.placements, 2, H)
    k_off = block_offset(mesh, k.placements, 2, KV)

    def local(ql, kl, vl):
        hq, hk, group = ql.shape[2], kl.shape[2], H // KV
        if (q_off // group, hq // group) != (k_off, hk) or hq % group:
            # the rank's query heads read kv heads outside its block:
            # take each query head's kv head explicitly
            heads = (torch.arange(q_off, q_off + hq, device=ql.device)
                     // group) - k_off
            kl, vl = kl[:, :, heads], vl[:, :, heads]
        return flash_attention_op(ql, kl, vl, causal=causal, q_offset=0)

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(list(q.placements), list(k.placements),
                                    list(v.placements)),
                     device_mesh=mesh)(q, k, v)


def gqa_init_cache(cfg, batch, cache_len, dtype, device):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, cache_len, KV, hd)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(t):
    """Per-(token, head) symmetric int8 of t ``[B, S, KV, hd]``: the f32
    scale ``max(absmax, 1e-6) / 127`` (a true division by a tensor, which
    a CUDA tensor divided by a Python number is not), values rounded
    half to even and clipped to [-127, 127]; returns the int8 values and
    the scale ``[B, S, KV]`` in bf16."""
    tf = t.to(torch.float32)
    scale = torch.clamp(tf.abs().amax(-1), min=1e-6) / tf.new_tensor(127.0)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(tq, scale):
    """int8 ``[B, S, KV, hd]`` times its bf16 scale, in bf16."""
    return tq.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def _int8_decode_attention(cfg, q, kq, vq, ks, vs, valid, *, chunk=2048):
    """Online-softmax decode attention that dequantizes the int8 cache a
    chunk at a time (``blocks.py:172-216`` of the reference, which has
    no caller there either; the decode step attends over the whole
    dequantized cache instead).  q ``[B, 1, H, hd]``; kq, vq ``[B, S, KV,
    hd]`` int8; ks, vs ``[B, S, KV]``; ``valid`` keys are seen."""
    B, _, H, hd = q.shape
    S, KV = kq.shape[1], kq.shape[2]
    n_rep = max(1, H // KV)
    scale = 1.0 / (hd ** 0.5)
    nchunk = max(1, S // chunk)
    chunk = S // nchunk
    f32 = torch.float32
    qf = q.to(f32)
    acc = torch.zeros((B, H, 1, hd), dtype=f32, device=q.device)
    m = torch.full((B, H, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, 1), dtype=f32, device=q.device)
    for ci in range(nchunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kd = repeat_kv(_dequantize_kv(kq[:, sl], ks[:, sl]), n_rep, H)
        vd = repeat_kv(_dequantize_kv(vq[:, sl], vs[:, sl]), n_rep, H)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kd.to(f32)) * scale
        pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.where((pos < valid)[None, None, None, :], s,
                        s.new_tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).to(f32), vd.to(f32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def gqa_step(cfg, p, x, cache, pos, *, position_ids=None, cross_kv=None):
    """One token x ``[B, 1, d]`` at position ``pos`` against the cache
    (k, v ``[B, S, KV, hd]``; int8 with per-token scales when
    ``cfg.kv_cache_dtype == "int8"``).  The token's K/V are written into
    the cache's buffers in place (the reference returns updated copies),
    and attention runs over the whole cache with ``kv_valid_len = pos +
    1``; an int8 cache is dequantized to bf16 first, as the reference
    does, then cast to q's dtype for the kernel.  For mrope without
    ``position_ids``, every component is ``pos``.  With ``cross_kv``
    (the cross cache's k and v ``[B, Se, KV, hd]``, in the model's dtype
    whatever the cache's) only q is projected, it sees all ``Se`` keys,
    and ``cache`` is returned as given."""
    B = x.shape[0]
    if cross_kv is not None:
        k, v = cross_kv
        o = flash_attention_op(_cross_q(cfg, p, x), k, v, causal=False,
                               kv_valid_len=k.shape[1])
        return o.reshape(B, 1, -1) @ p["wo"], cache
    pid = position_ids
    if cfg.rope == "mrope" and pid is None:
        pid = torch.full((3, B, 1), int(pos), dtype=torch.int64,
                         device=x.device)
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions, pid)
    if cfg.kv_cache_dtype == "int8":
        kq, ks_new = _quantize_kv(k_new)
        vq, vs_new = _quantize_kv(v_new)
        for key, val in (("k", kq), ("v", vq), ("k_scale", ks_new),
                         ("v_scale", vs_new)):
            cache[key][:, pos] = val[:, 0]
        k = _dequantize_kv(cache["k"], cache["k_scale"]).to(q.dtype)
        v = _dequantize_kv(cache["v"], cache["v_scale"]).to(q.dtype)
    else:
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
        k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    o = flash_attention_op(q, k, v, causal=False, kv_valid_len=pos + 1)
    return o.reshape(B, 1, -1) @ p["wo"], cache


# ------------------------------------------------------------- MLA mixer ---
def mla_init(gen, cfg):
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rdim, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.torch_dtype
    return {"w_q": _dense_init(gen, (d, H * (nope + rdim)), dt),
            "w_dkv": _dense_init(gen, (d, r), dt),
            "w_kr": _dense_init(gen, (d, rdim), dt),
            "w_ukv": _dense_init(gen, (r, H * (nope + vd)), dt),
            "wo": _dense_init(gen, (H * vd, d), dt),
            "ckv_norm": torch.ones((r,), dtype=dt, device=gen.device)}


def _mla_q(cfg, p, x, positions):
    """The query's no-position part ``[B, S, H, nope]`` and its rotated
    part ``[B, S, H, rdim]``."""
    B, S, _ = x.shape
    nope, rdim = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p["w_q"]).reshape(B, S, cfg.n_heads, nope + rdim)
    return (q[..., :nope],
            rope_lib.apply_rope(q[..., nope:], positions, cfg.rope_theta))


def _rms_vec(x, scale, eps=1e-6):
    """RMS norm of MLA's latent over its last axis, in f32 with an f32
    scale, cast back to x's dtype (:func:`rms_head`'s function)."""
    return rms_head(x, scale, eps)


def _mla_latent(cfg, p, x, positions):
    """The normed latent ``ckv`` ``[B, S, r]`` and the one rotated key
    head ``kr`` ``[B, S, 1, rdim]`` that every head shares."""
    ckv = _rms_vec(x @ p["w_dkv"], p["ckv_norm"])
    kr = rope_lib.apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                             cfg.rope_theta)
    return ckv, kr


def mla_seq(cfg, p, x, *, positions, position_ids=None, causal=True):
    """MLA over a sequence x ``[B, S, d]``: q and k of ``nope + rdim``
    (192) per head, v of ``v_head_dim`` (128), through the kernel, which
    takes v at its own width.  The reference switches to its chunked
    attention above 2,048 x 2,048 scores, which rounds p to bf16 before
    ``p @ v``; the kernel keeps p in f32 at every length.  Returns ``(y,
    (ckv, kr))``, ``ckv`` ``[B, S, r]`` and ``kr`` ``[B, S, rdim]`` for
    the cache."""
    del position_ids
    B, S, _ = x.shape
    H, nope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    qn, qr = _mla_q(cfg, p, x, positions)
    ckv, kr = _mla_latent(cfg, p, x, positions)
    kv = (ckv @ p["w_ukv"]).reshape(B, S, H, nope + vd)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kv[..., :nope], kr.expand(B, S, H, kr.shape[-1])],
                  dim=-1)
    o = flash_attention_op(q, k, kv[..., nope:], causal=causal)
    return o.reshape(B, S, H * vd) @ p["wo"], (ckv, kr[:, :, 0])


def mla_init_cache(cfg, batch, cache_len, dtype, device):
    """The latent cache: ``ckv`` ``[B, L, r]`` and ``kr`` ``[B, L,
    rdim]`` (no int8 form, as in the reference)."""
    return {"ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                              dtype=dtype, device=device)}


def mla_step(cfg, p, x, cache, pos, *, position_ids=None):
    """One token x ``[B, 1, d]`` at position ``pos`` in the absorbed form:
    q's no-position part taken into the latent space through ``w_uk``,
    scores against the cached latent and rotated keys in f32, divided by
    ``sqrt(nope + rdim)``, ``pos + 1`` keys seen, and the context taken
    out through ``w_uv``.  The token's ``ckv``/``kr`` are written into the
    cache's buffers in place (the reference returns updated copies)."""
    del position_ids
    B = x.shape[0]
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rdim, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    f32 = torch.float32
    positions = torch.full((1,), int(pos), dtype=torch.int64,
                           device=x.device)
    qn, qr = _mla_q(cfg, p, x, positions)
    ckv_new, kr_new = _mla_latent(cfg, p, x, positions)
    cache["ckv"][:, pos] = ckv_new[:, 0]
    cache["kr"][:, pos] = kr_new[:, 0, 0]
    ckv, kr = cache["ckv"].to(f32), cache["kr"].to(f32)
    w_ukv = p["w_ukv"].reshape(r, H, nope + vd).to(f32)
    q_lat = torch.einsum("bqhn,rhn->bqhr", qn.to(f32), w_ukv[..., :nope])
    s = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
    s = s + torch.einsum("bqhn,bsn->bhqs", qr.to(f32), kr)
    s = s / s.new_tensor(math.sqrt(nope + rdim))  # a true division
    valid = torch.arange(ckv.shape[1], device=x.device) < pos + 1
    s = torch.where(valid[None, None, None, :], s, s.new_tensor(NEG_INF))
    ctx = torch.einsum("bhqs,bsr->bqhr", torch.softmax(s, dim=-1), ckv)
    o = torch.einsum("bqhr,rhv->bqhv", ctx, w_ukv[..., nope:]).to(x.dtype)
    return o.reshape(B, 1, H * vd) @ p["wo"], cache


# ----------------------------------------------------------- RWKV6 mixer ---
def rwkv6_init(gen, cfg):
    d, ld = cfg.d_model, cfg.rwkv_lora_dim
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    dt, dev = cfg.torch_dtype, gen.device

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dt)
    decay = -6.0 + 5.0 * (torch.arange(d, dtype=torch.float32, device=dev)
                          / max(1, d - 1)) ** 0.7
    p = {"mu_base": torch.full((d,), 0.5, dtype=dt, device=dev),
         "mu_wkvrg": torch.full((5, d), 0.5, dtype=dt, device=dev)}
    # drawn in the order of the reference's keys ks[0..9]
    p["lora_a_mix"] = _dense_init(gen, (d, 5 * ld), dt, 0.01)
    p["lora_b_mix"] = normal(5, ld, d, scale=0.01)
    p["w0"] = decay.to(dt)
    p["lora_a_w"] = _dense_init(gen, (d, 2 * ld), dt, 0.01)
    p["lora_b_w"] = normal(2 * ld, d, scale=0.01)
    p["w_u"] = normal(H, hd, scale=0.1)
    for name in ("wr_tm", "wk_tm", "wv_tm", "wg_tm", "wo"):
        p[name] = _dense_init(gen, (d, d), dt)
    p["gn_scale"] = torch.ones((d,), dtype=dt, device=dev)
    p["gn_bias"] = torch.zeros((d,), dtype=dt, device=dev)
    return p


def _rwkv_mix(cfg, p, x, x_prev):
    """Data-dependent token-shift (Finch ddlerp). Returns xw,xk,xv,xr,xg."""
    dx = x_prev - x
    xxx = x + dx * p["mu_base"]
    mix = torch.tanh(xxx @ p["lora_a_mix"])
    B, S, _ = x.shape
    mix = mix.reshape(B, S, 5, cfg.rwkv_lora_dim)
    delta = torch.einsum("bsfl,fld->fbsd", mix, p["lora_b_mix"])
    return [x + dx * (p["mu_wkvrg"][i] + delta[i]) for i in range(5)]


def _rwkv_wkvrg(cfg, p, x, x_prev):
    xw, xk, xv, xr, xg = _rwkv_mix(cfg, p, x, x_prev)
    B, S, d = x.shape
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    r = (xr @ p["wr_tm"]).reshape(B, S, H, hd)
    k = (xk @ p["wk_tm"]).reshape(B, S, H, hd)
    v = (xv @ p["wv_tm"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg_tm"])
    lora = torch.tanh(xw @ p["lora_a_w"][:, :cfg.rwkv_lora_dim * 2]
                      .to(x.dtype)) @ p["lora_b_w"].to(x.dtype)
    w_log = -torch.exp(torch.clamp(
        p["w0"].to(torch.float32) + lora.to(torch.float32), -20.0, 1.0))
    w = torch.exp(w_log).reshape(B, S, H, hd)  # decay in (0,1)
    return r, k, v, g, w


def _rwkv_groupnorm(cfg, p, o):
    """Per-head group norm of the wkv output. o: [B,S,H,hd]"""
    B, S, H, hd = o.shape
    of = o.to(torch.float32)
    mu = of.mean(-1, keepdim=True)
    var = ((of - mu) ** 2).mean(-1, keepdim=True)
    y = ((of - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, H * hd)
    return (y * p["gn_scale"].to(torch.float32)
            + p["gn_bias"].to(torch.float32))


def _rwkv_out(cfg, p, x, r, k, v, g, w, S):
    """The WKV recurrence from state S through the op (f32 r, k, v, w, as
    the reference casts them), then group norm, gate and output
    projection.  Returns (y, final state)."""
    f32 = torch.float32
    o, S_fin = rwkv6_chunk_op(r.to(f32), k.to(f32), v.to(f32), w,
                              p["w_u"].to(f32), S)
    y = _rwkv_groupnorm(cfg, p, o) * g.to(f32)
    return y.to(x.dtype) @ p["wo"], S_fin


def rwkv6_seq(cfg, p, x, *, positions=None, position_ids=None, chunk=64,
              x_prev0=None, S0=None):
    """The mixer over a sequence x ``[B, S, d]``, from token-shift input
    ``x_prev0`` ``[B, d]`` and state ``S0`` (zeros when None).  Returns
    ``(y, {"S", "x_last"})``.  ``chunk`` is the reference's scan chunk;
    the kernel walks the whole sequence, so it changes nothing.  A
    recurrent mixer takes no positions."""
    del positions, position_ids, chunk
    B, S, d = x.shape
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    first = (x_prev0[:, None] if x_prev0 is not None
             else x.new_zeros((B, 1, d)))
    x_prev = torch.cat([first, x[:, :-1]], dim=1)
    r, k, v, g, w = _rwkv_wkvrg(cfg, p, x, x_prev)
    if S0 is None:
        S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)
    y, S_fin = _rwkv_out(cfg, p, x, r, k, v, g, w, S0)
    return y, {"S": S_fin, "x_last": x[:, -1]}


def rwkv6_init_cache(cfg, batch, cache_len, dtype, device):
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                         device=device),
        "x_last": torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device),
    }


def rwkv6_step(cfg, p, x, state, pos, *, position_ids=None):
    """One token x ``[B, 1, d]``: the recurrence at T = 1."""
    del pos, position_ids  # recurrent: the state carries the position
    r, k, v, g, w = _rwkv_wkvrg(cfg, p, x, state["x_last"][:, None])
    y, S_new = _rwkv_out(cfg, p, x, r, k, v, g, w, state["S"])
    return y, {"S": S_new, "x_last": x[:, 0]}


# ----------------------------------------------------------- Mamba mixer ---
def mamba_init(gen, cfg):
    """The reference's leaves and layouts: ``w_in [d, 2 di]``, ``conv_w
    [dc, di]`` (normal x 0.1), ``conv_b``, ``w_x [di, dt_rank + 2 ds]``,
    ``w_dt``, ``b_dt`` = -4.6 (softplus^-1(0.01)), ``A_log`` = log(1 ..
    ds) per channel, ``D_skip`` ones and ``w_out``, all in the model dtype,
    drawn in the order of the reference's keys."""
    d, di = cfg.d_model, cfg.mamba_d_inner
    ds, dc, dr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.dt_rank
    dt, dev = cfg.torch_dtype, gen.device
    p = {"w_in": _dense_init(gen, (d, 2 * di), dt),
         "conv_w": (torch.randn((dc, di), generator=gen, device=dev)
                    * 0.1).to(dt),
         "conv_b": torch.zeros((di,), dtype=dt, device=dev),
         "w_x": _dense_init(gen, (di, dr + 2 * ds), dt),
         "w_dt": _dense_init(gen, (dr, di), dt),
         "b_dt": torch.full((di,), -4.6, dtype=dt, device=dev)}
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    p["A_log"] = torch.log(A).repeat(di, 1).to(dt)
    p["D_skip"] = torch.ones((di,), dtype=dt, device=dev)
    p["w_out"] = _dense_init(gen, (di, d), dt)
    return p


def _mamba_ssm_inputs(cfg, p, xc):
    """xc: the conv'd activation ``[B, S, di]`` -> (dt ``[B, S, di]``, Bm,
    Cm ``[B, S, ds]``), dt = softplus(... @ w_dt + b_dt) written as
    ``jax.nn.softplus`` computes it (``logaddexp(s, 0) = max(s, 0) +
    log1p(exp(-|s|))``), each op in the model dtype as XLA rounds it."""
    ds, dr = cfg.mamba_d_state, cfg.dt_rank
    proj = xc @ p["w_x"]
    dt, Bm, Cm = torch.split(proj, [dr, ds, ds], dim=-1)
    s = dt @ p["w_dt"] + p["b_dt"]
    dt = torch.clamp(s, min=0) + torch.log1p(torch.exp(-s.abs()))
    return dt, Bm, Cm


def _mamba_decays(p):
    """``A = -exp(A_log)`` ``[di, ds]`` in f32."""
    return -torch.exp(p["A_log"].to(torch.float32))


def _mamba_conv(cfg, p, xin, conv0=None):
    """The causal depthwise conv of xin ``[B, S, di]`` after the window
    ``conv0`` ``[B, dc - 1, di]`` (zeros when None), as the reference's
    shifted sum ``sum_i xp[:, i:i + S] * conv_w[i] + conv_b`` in the model
    dtype (each product and sum rounded); returns it and the window the
    next call starts from."""
    B, S, di = xin.shape
    dc = cfg.mamba_d_conv
    prev = conv0 if conv0 is not None else xin.new_zeros((B, dc - 1, di))
    xp = torch.cat([prev, xin], dim=1)
    conv = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(dc)) \
        + p["conv_b"]
    return conv, xp[:, xp.shape[1] - (dc - 1):].clone()  # frees xp


def mamba_seq(cfg, p, x, *, positions=None, position_ids=None, conv0=None,
              h0=None):
    """The mixer over a sequence x ``[B, S, d]``, from the conv window
    ``conv0`` ``[B, dc - 1, di]`` and state ``h0`` ``[B, di, ds]`` (zeros
    when None): the causal depthwise conv as the reference's shifted sum
    in the model dtype, silu, the selective scan through the op (its f32
    D skip included), the silu(z) gate and ``w_out``.  Returns ``(y,
    {"conv", "h"})``.  A recurrent mixer takes no positions."""
    del positions, position_ids
    B = x.shape[0]
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    xin, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    conv, conv_state = _mamba_conv(cfg, p, xin, conv0)
    xc = F.silu(conv)
    dt, Bm, Cm = _mamba_ssm_inputs(cfg, p, xc)
    if h0 is None:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    y, h = mamba_scan_op(dt, xc, Bm, Cm, _mamba_decays(p), p["D_skip"], h0)
    y = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return y, {"conv": conv_state, "h": h}


def mamba_init_cache(cfg, batch, cache_len, dtype, device):
    """The conv window ``[B, dc - 1, di]`` in the model dtype and the
    state ``[B, di, ds]`` in f32."""
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device)}


def mamba_step(cfg, p, x, state, pos, *, position_ids=None):
    """One token x ``[B, 1, d]`` in plain torch, line by line the
    reference's step (blocks.py:599-618): the conv as a sum over the
    window in f32 cast back (``jnp.sum`` upcasts), ``dt * xc`` rounded to
    the model dtype before the f32 update, y in f32 with the D skip.
    Returns new ``{"conv", "h"}``."""
    del pos, position_ids  # recurrent: the state carries the position
    f32 = torch.float32
    xin, z = torch.chunk(x @ p["w_in"], 2, dim=-1)              # [B, 1, di]
    xp = torch.cat([state["conv"], xin], dim=1)                  # [B, dc, di]
    conv = (xp * p["conv_w"]).to(f32).sum(1, keepdim=True).to(x.dtype) \
        + p["conv_b"]
    xc = F.silu(conv)
    dt, Bm, Cm = _mamba_ssm_inputs(cfg, p, xc)
    a = torch.exp(dt[:, 0, :, None].to(f32) * _mamba_decays(p))
    b = (dt[:, 0] * xc[:, 0]).to(f32)[..., None] * \
        Bm[:, 0, None, :].to(f32)
    h = a * state["h"] + b
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0].to(f32))
    y = y + xc[:, 0].to(f32) * p["D_skip"].to(f32)
    y = (y[:, None].to(x.dtype) * F.silu(z)) @ p["w_out"]
    return y, {"conv": xp[:, 1:], "h": h}


# -------------------------------------------------------------- MLPs -------
def mlp_init(gen, cfg, kind):
    d, ff, dt, dev = cfg.d_model, cfg.d_ff, cfg.torch_dtype, gen.device
    if kind == "swiglu":
        return {"w1": _dense_init(gen, (d, ff), dt),
                "w3": _dense_init(gen, (d, ff), dt),
                "w2": _dense_init(gen, (ff, d), dt)}
    if kind == "gelu":
        p = {"w_up": _dense_init(gen, (d, ff), dt),
             "w_down": _dense_init(gen, (ff, d), dt)}
        if cfg.qkv_bias:
            p["b_up"] = torch.zeros((ff,), dtype=dt, device=dev)
            p["b_down"] = torch.zeros((d,), dtype=dt, device=dev)
        return p
    if kind == "rwkv_cm":
        return {
            "cm_mu_k": torch.full((d,), 0.5, dtype=dt, device=dev),
            "cm_mu_r": torch.full((d,), 0.5, dtype=dt, device=dev),
            "wk_cm": _dense_init(gen, (d, ff), dt),
            "wv_cm": _dense_init(gen, (ff, d), dt),
            "wr_cm": _dense_init(gen, (d, d), dt),
        }
    if kind == "moe":
        e_ff, E = cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
        # the router is f32 in every model, as in the reference; an
        # expert's init scale is 1/sqrt(E), the reference's leading axis
        p = {"w_router": _dense_init(gen, (d, E), torch.float32),
             "we1": _dense_init(gen, (E, d, e_ff), dt),
             "we3": _dense_init(gen, (E, d, e_ff), dt),
             "we2": _dense_init(gen, (E, e_ff, d), dt)}
        if cfg.n_shared_experts:
            sf = e_ff * cfg.n_shared_experts
            p["ws1"] = _dense_init(gen, (d, sf), dt)
            p["ws3"] = _dense_init(gen, (d, sf), dt)
            p["ws2"] = _dense_init(gen, (sf, d), dt)
        return p
    raise ValueError(f"unknown mlp {kind!r}")


# --------------------------------------------------------------- MoE -------
def _moe_groups(T: int) -> int:
    """Routing groups, aligned to the batch shards of the active mesh
    (GShard-style local dispatch: tokens scatter only within their
    group); 1 without a mesh or when ``T`` does not divide."""
    ctx = current_ctx()
    g = ctx.axis_size("batch") if ctx is not None else 1
    return g if g > 1 and T % g == 0 else 1


def moe_route(cfg, p, x):
    """The router over x ``[G, Tg, d]``: f32 logits against the f32
    ``w_router``, softmax, ``top_k`` experts a token, their gates
    renormalised by ``max(sum, 1e-9)``; then each ``(token, slot)`` route
    in token-major order takes the next row of its expert's ``C = max(1,
    ceil(capacity_factor * k * Tg / E))``, and a route past ``C`` is
    dropped (row ``C``, zero weight).  Returns ``(gates [G, Tg, k],
    experts [G, Tg * k], rows [G, Tg * k], keep [G, Tg * k], C)``."""
    G, Tg, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.to(torch.float32) @ p["w_router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    C = max(1, -(-int(cfg.capacity_factor * k * Tg) // E))
    experts = idx.reshape(G, Tg * k)
    # each expert's running count of routes, scanned along the routes
    # laid out innermost ([G, E, Tg * k]): a scan along the outer axis of
    # [G, Tg * k, E] took 13 ms a layer at 49,152 routes on an H100
    seen = torch.cumsum(F.one_hot(experts, E).transpose(1, 2).contiguous(),
                        dim=2) - 1
    rows = seen.gather(1, experts[:, None, :])[:, 0]
    keep = rows < C
    return gates, experts, torch.where(keep, rows, C), keep, C


def moe_apply(cfg, p, x):
    """Capacity-based top-k MoE over x ``[B, S, d]`` (the reference's
    ``moe_apply``): :func:`moe_route`, each kept route's token written to
    its expert's row (a dropped one to the spare row ``C``, with a zero
    update), the experts' swiglu as batched products ``[G, E, C, d]``,
    each route's output gathered back and summed over its token's slots
    by gate weight, then the shared experts' swiglu added.  Drops are
    part of the function: a decode step of few tokens has a small ``C``
    and drops routes a prefill keeps, as in the reference."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    G = _moe_groups(T)
    Tg = T // G
    xg = x.reshape(G, Tg, d)
    gates, experts, rows, keep, C = moe_route(cfg, p, xg)
    group = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    upd = xg.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    # kept routes land on distinct rows; only the spare row takes several
    # (zero) updates, and it is dropped
    buf = x.new_zeros((G, E, C + 1, d)).index_put_((group, experts, rows),
                                                   upd)
    xin = buf[:, :, :C]
    act = _act(cfg.act)
    h = act(torch.einsum("gecd,edf->gecf", xin, p["we1"])) * \
        torch.einsum("gecd,edf->gecf", xin, p["we3"])
    out_e = F.pad(torch.einsum("gecf,efd->gecd", h, p["we2"]),
                  (0, 0, 0, 1))
    w = (gates.reshape(G, Tg * k) * keep.to(torch.float32)).to(x.dtype)
    y = (out_e[group, experts, rows] * w[..., None]).reshape(
        G, Tg, k, d).sum(dim=2)
    if cfg.n_shared_experts:
        y = y + (act(xg @ p["ws1"]) * (xg @ p["ws3"])) @ p["ws2"]
    return y.reshape(B, S, d), None


def mlp_apply(cfg, p, x, kind, cm_prev=None):
    """The MLP over x ``[B, S, d]``.  Returns ``(y, cm)``: for the RWKV
    channel mix, ``cm`` is ``x[:, -1:]``, the next call's token-shift
    input ``cm_prev`` (zeros when None); for the others it is None."""
    if kind == "swiglu":
        h = _act(cfg.act)(matmul(x, p["w1"])) * matmul(x, p["w3"])
        h = constrain(h, "batch", "seq", "ffn")
        return matmul(h, p["w2"]), None
    if kind == "gelu":
        h = matmul(x, p["w_up"])
        if "b_up" in p:
            h = h + p["b_up"]
        h = constrain(F.gelu(h, approximate="tanh"), "batch", "seq", "ffn")
        y = matmul(h, p["w_down"])
        return (y + p["b_down"] if "b_down" in p else y), None
    if kind == "moe":
        return moe_apply(cfg, p, x)
    if kind != "rwkv_cm":
        raise ValueError(f"unknown mlp {kind!r}")
    B, S, d = x.shape
    prev = cm_prev if cm_prev is not None else x.new_zeros((B, 1, d))
    x_prev = torch.cat([prev, x[:, :-1]], dim=1) if S > 1 else prev
    xk = x + (x_prev - x) * p["cm_mu_k"]
    xr = x + (x_prev - x) * p["cm_mu_r"]
    h = constrain(torch.square(F.relu(matmul(xk, p["wk_cm"]))), "batch",
                  "seq", "ffn")
    return torch.sigmoid(matmul(xr, p["wr_cm"])) * matmul(h, p["wv_cm"]), \
        x[:, -1:]


MIXER_INIT = {"gqa": gqa_init, "mla": mla_init, "rwkv6": rwkv6_init,
              "mamba": mamba_init}
MIXER_SEQ = {"gqa": gqa_seq, "mla": mla_seq, "rwkv6": rwkv6_seq,
             "mamba": mamba_seq}
MIXER_STEP = {"gqa": gqa_step, "mla": mla_step, "rwkv6": rwkv6_step,
              "mamba": mamba_step}
MIXER_CACHE = {"gqa": gqa_init_cache, "mla": mla_init_cache,
               "rwkv6": rwkv6_init_cache, "mamba": mamba_init_cache}


def mixer(table, name):
    """``table[name]``, or raise for a mixer the config names and no
    table holds."""
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown mixer {name!r}") from None
