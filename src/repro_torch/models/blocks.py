"""Layer blocks of the LM (counterpart of ``repro/models/blocks.py``):
so far the norms, the RWKV6 mixer and the RWKV channel-mix MLP.

Each mixer exposes, as in the reference:
  ``<name>_init(gen, cfg)``                   -> param dict
  ``<name>_seq(cfg, p, x, ...)``              -> (y, final_state)
  ``<name>_step(cfg, p, x, state, pos)``      -> (y, new_state)
  ``<name>_init_cache(cfg, batch, cache_len, dtype, device)``
with parameters and states as dicts of tensors under the reference's
key names.  Randomness comes from the ``torch.Generator`` passed in, on
the device the parameters are made on.

The reference computes RWKV6's WKV recurrence over a sequence with its
own chunked associative scan (``lax.scan`` over chunks, blocks.py:457-479)
and the one-token update with einsums; the port runs both through
:func:`~repro_torch.kernels.rwkv6_chunk.ops.rwkv6_chunk_op`, the
hand-written kernel on the card.  It is the same function: the
reference's own test holds its scan equal to the kernel's oracle.
The reference's sharding hints (``constrain``) are no-ops without a mesh
and are dropped: the port runs on one device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_chunk.ops import rwkv6_chunk_op


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


def rwkv6_seq(cfg, p, x, *, chunk=64, x_prev0=None, S0=None):
    """The mixer over a sequence x ``[B, S, d]``, from token-shift input
    ``x_prev0`` ``[B, d]`` and state ``S0`` (zeros when None).  Returns
    ``(y, {"S", "x_last"})``.  ``chunk`` is the reference's scan chunk;
    the kernel walks the whole sequence, so it changes nothing."""
    del chunk
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


def rwkv6_step(cfg, p, x, state, pos):
    """One token x ``[B, 1, d]``: the recurrence at T = 1."""
    del pos  # recurrent: the state carries the position
    r, k, v, g, w = _rwkv_wkvrg(cfg, p, x, state["x_last"][:, None])
    y, S_new = _rwkv_out(cfg, p, x, r, k, v, g, w, state["S"])
    return y, {"S": S_new, "x_last": x[:, 0]}


# -------------------------------------------------------------- MLPs -------
def mlp_init(gen, cfg, kind):
    d, dt = cfg.d_model, cfg.torch_dtype
    if kind != "rwkv_cm":
        raise NotImplementedError(
            f"mlp {kind!r} is not in the port yet (ROADMAP queue 1 item 14)")
    return {
        "cm_mu_k": torch.full((d,), 0.5, dtype=dt, device=gen.device),
        "cm_mu_r": torch.full((d,), 0.5, dtype=dt, device=gen.device),
        "wk_cm": _dense_init(gen, (d, cfg.d_ff), dt),
        "wv_cm": _dense_init(gen, (cfg.d_ff, d), dt),
        "wr_cm": _dense_init(gen, (d, d), dt),
    }


def mlp_apply(cfg, p, x, kind, cm_prev=None):
    """The RWKV channel mix over x ``[B, S, d]`` with token-shift input
    ``cm_prev`` ``[B, 1, d]`` (zeros when None).  Returns ``(y, x[:, -1:])``,
    the second being the next call's ``cm_prev``."""
    if kind != "rwkv_cm":
        raise NotImplementedError(
            f"mlp {kind!r} is not in the port yet (ROADMAP queue 1 item 14)")
    B, S, d = x.shape
    prev = cm_prev if cm_prev is not None else x.new_zeros((B, 1, d))
    x_prev = torch.cat([prev, x[:, :-1]], dim=1) if S > 1 else prev
    xk = x + (x_prev - x) * p["cm_mu_k"]
    xr = x + (x_prev - x) * p["cm_mu_r"]
    h = torch.square(F.relu(xk @ p["wk_cm"]))
    return torch.sigmoid(xr @ p["wr_cm"]) * (h @ p["wv_cm"]), x[:, -1:]


MIXER_INIT = {"rwkv6": rwkv6_init}
MIXER_SEQ = {"rwkv6": rwkv6_seq}
MIXER_STEP = {"rwkv6": rwkv6_step}
MIXER_CACHE = {"rwkv6": rwkv6_init_cache}


def mixer(table, name):
    """``table[name]``, or raise for a mixer the port has not reached."""
    try:
        return table[name]
    except KeyError:
        raise NotImplementedError(
            f"mixer {name!r} is not in the port yet (ROADMAP queue 1 item "
            f"14: the GQA, MLA and Mamba blocks)") from None
