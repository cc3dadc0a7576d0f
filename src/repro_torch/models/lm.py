"""The LM (counterpart of ``repro/models/lm.py``).

Public surface, under the reference's names:
  init_params(seed, cfg, device=None)    -> params
  params_from_jax(cfg, tree, device=None) -> params
  forward(cfg, params, tokens, ...)      -> logits
  train_loss(cfg, params, batch)         -> scalar loss
  encode(cfg, params, enc_embeds)        -> encoder output
  init_caches(cfg, batch, cache_len)     -> decode caches
  lay_out_caches(cfg, caches, long_ctx=) -> caches on the mesh
  prefill(cfg, params, tokens)           -> (logits_last, caches)
  serve_step(cfg, params, caches, tokens, pos, long_ctx=) -> (logits,
                                                              caches)

Parameters are dicts of tensors with the reference's keys.  The
reference stacks each pattern slot's ``R`` repeats on a leading axis
(built by ``vmap``, walked by ``lax.scan``); the port keeps a list of
``R`` per-layer dicts instead, ``params["stack"][slot][r]``, and walks
the layers in an unrolled loop.  Caches are laid out the same way, and
so is the encoder of an encoder-decoder model,
``params["encoder"]["stack"][slot][r]``.
The port runs every registered family: the GQA decoders (llama,
qwen1.5, qwen3, qwen2-vl with ``position_ids``) with bf16 or int8 KV
caches, the RWKV6 model, the MoE models deepseek-v2-lite (MLA, with its
latent cache) and grok-1 (GQA), the hybrid jamba (Mamba and GQA layers,
learned positions: a decoder with ``rope="none"`` and a layer that is
not recurrent adds ``pos_embed``), and the encoder-decoder whisper: an
encoder over frame embeddings (``enc_embeds`` ``[B, Se, d]``, the
reference's stub frontend) with sinusoidal positions, run **causal** as
the reference runs it, and decoder layers with cross attention over its
output, whose K/V a decode cache keeps per layer (``cross_k``,
``cross_v``, in the model's dtype under an int8 cache too).  A decode
step writes its token's K/V (or MLA's latent and rotated key) into the
cache buffers it is given.
With ``cfg.remat`` each pattern layer of a
differentiated forward runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body): only the layer inputs
are kept, and each layer runs again in the backward, under the mesh the
forward ran under.
Under a mesh (:func:`~repro_torch.dist.sharding.use_mesh`) parameters
and batches are DTensors, and ``constrain`` at the reference's sites
lays out the residual stream (batch on ``data``, the sequence on
``model`` for attention models, Megatron-SP style) and the logits
(vocabulary on ``model``; a decode step's ``[B, Vp]`` on ``("batch",
"vocab")``, where the reference places nothing).  A prefill under a
mesh makes its caches in the layout of ``cache_spec_tree``
(:func:`lay_out_caches`) and fills them through the mixers' cache
sites; ``serve_step``'s ``long_ctx`` lays a decode cache's sequence on
``"longseq"`` (data and model) where it is ``"kvseq"`` (model) without.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (cache_spec_tree, constrain,
                                       current_ctx, is_dtensor, lay_out,
                                       matmul, placements_for, reinstall)
from repro_torch.models.blocks import (MIXER_CACHE, MIXER_INIT, MIXER_SEQ,
                                       MIXER_STEP, _dense_init,
                                       _quantize_kv, _write_seq,
                                       apply_norm, gqa_init, gqa_seq,
                                       gqa_step, mixer, mlp_apply,
                                       mlp_init, norm_init)
from repro_torch.models import loss as loss_lib
from repro_torch.models.loss import embed_lookup
from repro_torch.models.rope import sinusoidal
from repro_torch.optim.adamw import tree_map


def _layers(cfg):
    """Every layer's (slot, repeat, spec) in the reference's order: the
    prefix (slot None), then the pattern repeated."""
    out = [(None, i, s) for i, s in enumerate(cfg.prefix)]
    for r in range(cfg.pattern_repeats):
        out += [(slot, r, s) for slot, s in enumerate(cfg.pattern)]
    return out


_MLPS = ("swiglu", "gelu", "rwkv_cm", "moe")


def _check_supported(cfg):
    """Raise ``ValueError`` for a mixer or MLP kind the port does not
    know (every registered config passes)."""
    specs = list(cfg.prefix) + list(cfg.pattern)
    if cfg.enc_dec:
        specs += list(cfg.enc_pattern)
    for s in specs:
        mixer(MIXER_INIT, s.mixer)
        if s.mlp not in _MLPS:
            raise ValueError(f"unknown mlp {s.mlp!r}")


def _is_recurrent_only(cfg):
    return all(s.mixer in ("rwkv6", "mamba")
               for s in list(cfg.prefix) + list(cfg.pattern))


def _seq_ax(cfg):
    """SSM/hybrid models keep the sequence unsharded (sequential chunk
    scans); attention models shard the residual stream's sequence."""
    return None if any(s.mixer in ("rwkv6", "mamba")
                       for s in list(cfg.pattern) + list(cfg.prefix)) \
        else "seq"


def _get(tree, slot, r):
    return tree["prefix"][r] if slot is None else tree["stack"][slot][r]


def _enc_layers(cfg):
    """The encoder's (slot, repeat, spec) in the reference's order (its
    pattern repeated ``enc_layers / len(enc_pattern)`` times)."""
    R = cfg.enc_layers // len(cfg.enc_pattern)
    return [(slot, r, s) for r in range(R)
            for slot, s in enumerate(cfg.enc_pattern)]


# ---------------------------------------------------------------- init -----


def init_layer(gen, cfg, spec):
    p = {
        "ln1": norm_init(cfg, gen.device),
        "mixer": mixer(MIXER_INIT, spec.mixer)(gen, cfg),
        "ln2": norm_init(cfg, gen.device),
        "mlp": mlp_init(gen, cfg, spec.mlp),
    }
    if spec.cross_attn:
        p["ln_cross"] = norm_init(cfg, gen.device)
        p["cross"] = gqa_init(gen, cfg, cross=True)
    if cfg.ffn_surrogate_dim:
        d, sd = cfg.d_model, cfg.ffn_surrogate_dim
        p["surr"] = {
            "w1": _dense_init(gen, (d, sd), cfg.torch_dtype),
            "w2": _dense_init(gen, (sd, d), cfg.torch_dtype),
        }
    return p


def init_params(seed, cfg, *, device=None):
    """Seeded random parameters of the whole model, made on ``device``
    (None: the card) in the configured dtype by a ``torch.Generator``
    there.  The draws differ from the reference's ``jax.random`` ones:
    to run the reference's weights, use :func:`params_from_jax`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    Vp, D, dt = cfg.padded_vocab, cfg.d_model, cfg.torch_dtype
    p = {"tok_embed": (torch.randn((Vp, D), generator=gen, device=dev)
                       * 0.02).to(dt),
         "prefix": [], "stack": tuple([] for _ in cfg.pattern)}
    for slot, _, spec in _layers(cfg):
        layer = init_layer(gen, cfg, spec)
        (p["prefix"] if slot is None else p["stack"][slot]).append(layer)
    p["final_norm"] = norm_init(cfg, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((D, Vp), generator=gen, device=dev)
                        * 0.02).to(dt)
    if cfg.rope == "none" and not _is_recurrent_only(cfg):
        p["pos_embed"] = (torch.randn((cfg.max_pos, D), generator=gen,
                                      device=dev) * 0.01).to(dt)
    if cfg.enc_dec:
        enc = tuple([] for _ in cfg.enc_pattern)
        for slot, _, spec in _enc_layers(cfg):
            enc[slot].append(init_layer(gen, cfg, spec))
        p["encoder"] = {"stack": enc, "final_norm": norm_init(cfg, dev)}
    return p


def _tensor(a, dev):
    """A numpy leaf as a tensor of the same dtype, bf16 bit for bit (numpy's
    bf16 comes from ml_dtypes, which ``torch.from_numpy`` rejects)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stack, R, dev):
    """Each slot's ``R`` stacked layers as a list of per-layer dicts."""
    return tuple([_map(slot, lambda a, r=r: _tensor(np.asarray(a)[r], dev))
                  for r in range(R)] for slot in stack)


def params_from_jax(cfg, tree, *, device=None):
    """The port's parameters from the reference's ``init_params`` pytree
    given as numpy arrays: the stacked ``R`` axis of ``tree["stack"]``
    (and of the encoder's ``tree["encoder"]["stack"]``) unstacked into
    per-layer dicts (an MoE layer's ``[R, E, d, f]`` experts into its
    ``[E, d, f]``), every leaf carried bit for bit in its own dtype (the
    router stays f32 in a bf16 model)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    p = {"tok_embed": _tensor(tree["tok_embed"], dev),
         "prefix": [_map(lp, lambda a: _tensor(a, dev))
                    for lp in tree["prefix"]],
         "stack": _unstack(tree["stack"], cfg.pattern_repeats, dev),
         "final_norm": _map(tree["final_norm"], lambda a: _tensor(a, dev))}
    for name in ("lm_head", "pos_embed"):
        if name in tree:
            p[name] = _tensor(tree[name], dev)
    if "encoder" in tree:
        enc = tree["encoder"]
        p["encoder"] = {
            "stack": _unstack(enc["stack"],
                              cfg.enc_layers // len(cfg.enc_pattern), dev),
            "final_norm": _map(enc["final_norm"],
                               lambda a: _tensor(a, dev))}
    return p


# ------------------------------------------------------------- forward -----


def _cross_kv(cfg, pc, enc_out):
    """A decoder layer's cross-attention K and V ``[B, Se, KV, hd]`` of
    the encoder output ``enc_out`` ``[B, Se, d]`` (with ``bk``/``bv``
    under ``qkv_bias``)."""
    B, Se, _ = enc_out.shape
    k, v = matmul(enc_out, pc["wk"]), matmul(enc_out, pc["wv"])
    if cfg.qkv_bias:
        k, v = k + pc["bk"], v + pc["bv"]
    shape = (B, Se, cfg.n_kv_heads, cfg.head_dim)
    return k.reshape(shape), v.reshape(shape)


def _apply_layer_seq(cfg, p, spec, x, *, positions, position_ids,
                     enc_out=None):
    """One layer over a sequence: the mixer, then (a decoder layer with
    ``cross_attn``, given ``enc_out``) cross attention over the encoder
    output, then the MLP, each a pre-norm residual."""
    h, mc = mixer(MIXER_SEQ, spec.mixer)(
        cfg, p["mixer"], apply_norm(cfg, p["ln1"], x), positions=positions,
        position_ids=position_ids)
    x = constrain(x + h, "batch", _seq_ax(cfg), None)
    if spec.cross_attn and enc_out is not None:
        h, _ = gqa_seq(cfg, p["cross"], apply_norm(cfg, p["ln_cross"], x),
                       positions=positions,
                       cross_kv=_cross_kv(cfg, p["cross"], enc_out))
        x = x + h
    h, cm_new = mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                          spec.mlp)
    x = constrain(x + h, "batch", _seq_ax(cfg), None)
    cache = {"mixer": mc}
    if spec.mlp == "rwkv_cm":
        cache["cm_x_last"] = cm_new
    return x, cache


def _remat_layer(cfg, p, spec, x, positions, position_ids, enc_out=None):
    """One layer's output, its activations recomputed in the backward
    (under the forward's mesh: the backward runs on another thread)."""
    ctx = current_ctx()

    def body(h, lp, e):
        with reinstall(ctx):
            return _apply_layer_seq(cfg, lp, spec, h, positions=positions,
                                    position_ids=position_ids,
                                    enc_out=e)[0]
    return checkpoint(body, x, p, enc_out, use_reentrant=False), None


def encode(cfg, params, enc_embeds, *, remat=None):
    """The encoder over frame embeddings ``enc_embeds`` ``[B, Se, d]``
    (the reference's stub frontend): the sinusoidal table added in their
    dtype, the encoder stack, **causal** as the reference runs it
    (``gqa_seq``'s default), and its final norm.  With ``remat`` (None:
    ``cfg.remat`` while autograd records) each layer is recomputed in
    the backward, as the decoder's are."""
    if not cfg.enc_dec:
        raise ValueError(f"{cfg.name} has no encoder")
    S = enc_embeds.shape[1]
    x = enc_embeds + sinusoidal(S, cfg.d_model, enc_embeds.device).to(
        enc_embeds.dtype)[None]
    x = constrain(x, "batch", None, None)
    positions = torch.arange(S, device=x.device)
    if remat is None:
        remat = cfg.remat and torch.is_grad_enabled()
    for slot, r, spec in _enc_layers(cfg):
        p = params["encoder"]["stack"][slot][r]
        if remat:
            x, _ = _remat_layer(cfg, p, spec, x, positions, None)
        else:
            x, _ = _apply_layer_seq(cfg, p, spec, x, positions=positions,
                                    position_ids=None)
    return apply_norm(cfg, params["encoder"]["final_norm"], x)


def hidden_states(cfg, params, tokens, *, position_ids=None,
                  enc_embeds=None, collect_caches=False):
    """tokens [B,S] (and, for mrope, position_ids [3,B,S]; for an
    encoder-decoder model, enc_embeds [B,Se,D], which a decoder-only one
    ignores, as the reference does) -> (final-normed hidden [B,S,D],
    caches or None).  The encoder's output travels in the caches as
    ``caches["enc_out"]`` (the reference returns it third)."""
    remat = cfg.remat and torch.is_grad_enabled() and not collect_caches
    enc_out = None
    if cfg.enc_dec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             f"pass enc_embeds [B, Se, {cfg.d_model}]")
        enc_out = encode(cfg, params, enc_embeds, remat=remat)
    x = embed_lookup(params["tok_embed"], tokens)
    if "pos_embed" in params:
        S, max_pos = tokens.shape[1], params["pos_embed"].shape[0]
        if S > max_pos:  # the reference's dynamic_slice_in_dim refuses it
            raise ValueError(f"{S} tokens past the {max_pos} learned "
                             f"positions")
        x = x + params["pos_embed"][:S]
    x = constrain(x, "batch", _seq_ax(cfg), None)
    positions = torch.arange(tokens.shape[1], device=x.device)
    caches = {"prefix": [], "stack": tuple([] for _ in cfg.pattern)}
    if enc_out is not None:
        caches["enc_out"] = enc_out
    for slot, r, spec in _layers(cfg):
        p = _get(params, slot, r)
        if remat and slot is not None:  # the reference remats the scan body
            x, c = _remat_layer(cfg, p, spec, x, positions, position_ids,
                                enc_out)
            continue
        x, c = _apply_layer_seq(cfg, p, spec, x, positions=positions,
                                position_ids=position_ids, enc_out=enc_out)
        if collect_caches:
            (caches["prefix"] if slot is None
             else caches["stack"][slot]).append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, caches if collect_caches else None


def _head_matrix(cfg, params, dtype):
    head = params.get("lm_head")
    return head if head is not None else params["tok_embed"].T.to(dtype)


def _logits_from_hidden(cfg, params, x):
    """The logits of hidden states ``[B, S, d]`` or ``[B, d]`` (a decode
    step's), the vocabulary on ``"vocab"``, the pad masked."""
    logits = constrain(matmul(x, _head_matrix(cfg, params, x.dtype)),
                       "batch", *(None,) * (x.ndim - 2), "vocab")
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
            cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(cfg, params, tokens, *, position_ids=None, enc_embeds=None,
            collect_caches=False, last_only=False):
    """tokens [B,S] -> logits [B,S,Vp] (or [B,1,Vp] with last_only), and
    the caches with ``collect_caches`` (holding the encoder's output as
    ``"enc_out"`` for an encoder-decoder model)."""
    x, caches = hidden_states(cfg, params, tokens, position_ids=position_ids,
                              enc_embeds=enc_embeds,
                              collect_caches=collect_caches)
    if last_only:
        x = x[:, -1:]
    logits = _logits_from_hidden(cfg, params, x)
    return (logits, caches) if collect_caches else logits


def train_loss(cfg, params, batch, *, fused: bool = True):
    """Mean next-token cross-entropy of ``batch`` (``tokens`` and
    ``targets`` ``[B, S]``, ``position_ids`` ``[3, B, S]`` for mrope and
    ``enc_embeds`` ``[B, Se, d]`` for an encoder-decoder model, which a
    decoder-only one ignores), through
    :func:`~repro_torch.models.loss.fused_linear_xent` or, with
    ``fused=False``, the naive loss."""
    x, _ = hidden_states(cfg, params, batch["tokens"],
                         position_ids=batch.get("position_ids"),
                         enc_embeds=batch.get("enc_embeds"))
    W = _head_matrix(cfg, params, x.dtype)
    if fused:
        return loss_lib.fused_linear_xent(x, W, batch["targets"],
                                          cfg.vocab_size,
                                          unroll=cfg.unroll_inner)
    return loss_lib.naive_xent(x, W, batch["targets"], cfg.vocab_size)


# -------------------------------------------------------------- decode -----


def _layer_cache(cfg, spec, batch, cache_len, dtype, device):
    c = {"mixer": mixer(MIXER_CACHE, spec.mixer)(cfg, batch, cache_len,
                                                 dtype, device)}
    if spec.mlp == "rwkv_cm":
        c["cm_x_last"] = torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                     device=device)
    return c


def init_caches(cfg, batch, cache_len, dtype=None, *, enc_out=None,
                params=None, device=None):
    """Zero decode caches, laid out as the parameters.  An
    encoder-decoder model needs the encoder's output ``enc_out`` and the
    ``params``: each cross-attention layer's cache gets ``cross_k`` and
    ``cross_v`` (:func:`_cross_kv`, in the model's dtype whatever
    ``kv_cache_dtype`` says, as in the reference), which every decode
    step attends to unchanged."""
    dtype = dtype or cfg.torch_dtype
    dev = resolve_device(device)
    if cfg.enc_dec and (enc_out is None or params is None):
        raise ValueError(f"{cfg.name}: the cross caches need enc_out and "
                         f"params")
    caches = {"prefix": [], "stack": tuple([] for _ in cfg.pattern)}
    for slot, r, spec in _layers(cfg):
        c = _layer_cache(cfg, spec, batch, cache_len, dtype, dev)
        if spec.cross_attn and cfg.enc_dec:
            c["cross_k"], c["cross_v"] = _cross_kv(
                cfg, _get(params, slot, r)["cross"], enc_out)
        (caches["prefix"] if slot is None else caches["stack"][slot]).append(c)
    return caches


def _step_residual(x, h):
    """``x + h``, a block's output ``h`` laid out first as a decode step's
    residual stream (``serve_step``'s site: the batch on data, whole
    elsewhere): torch 2.11's DTensor cannot add a partial sum to a
    tensor sharded otherwise."""
    return x + constrain(h, "batch", None, None)


def _apply_layer_step(cfg, p, spec, x, cache, pos, *, position_ids,
                      long_ctx=False):
    h, mc = mixer(MIXER_STEP, spec.mixer)(
        cfg, p["mixer"], apply_norm(cfg, p["ln1"], x), cache["mixer"], pos,
        position_ids=position_ids, long_ctx=long_ctx)
    x = _step_residual(x, h)
    if spec.cross_attn and "cross_k" in cache:
        h, _ = gqa_step(cfg, p["cross"], apply_norm(cfg, p["ln_cross"], x),
                        None, pos,
                        cross_kv=(cache["cross_k"], cache["cross_v"]))
        x = _step_residual(x, h)
    cm_prev = cache.get("cm_x_last")
    cm_new = cm_prev
    if cfg.ffn_surrogate_dim and "surr" in p:
        # surrogate execution path (paper: the NN replaces the dominant
        # kernel); the accurate path is taken on interleaved steps
        xn = apply_norm(cfg, p["ln2"], x)
        h = F.silu(xn @ p["surr"]["w1"]) @ p["surr"]["w2"]
    else:
        h, cm_new = mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                              spec.mlp, cm_prev=cm_prev)
    x = _step_residual(x, h)
    new_cache = dict(cache)
    new_cache["mixer"] = mc
    if cm_prev is not None:
        new_cache["cm_x_last"] = cm_new
    return x, new_cache


def serve_step(cfg, params, caches, tokens, pos, *, position_ids=None,
               long_ctx=False):
    """One decode step at position ``pos``. tokens [B,1] (and, for mrope,
    position_ids [3,B,1]) -> (logits [B,Vp], new caches).  ``long_ctx``
    puts the KV caches' sequence on ``"longseq"`` at the mixers' sites
    (the reference's keyword; a no-op without a mesh)."""
    x = embed_lookup(params["tok_embed"], tokens)
    if "pos_embed" in params:  # clamped, as lax.dynamic_slice_in_dim
        table = params["pos_embed"]
        x = x + table[min(max(int(pos), 0), table.shape[0] - 1)]
    x = constrain(x, "batch", None, None)
    new = {"prefix": [], "stack": tuple([] for _ in cfg.pattern)}
    for slot, r, spec in _layers(cfg):
        x, c = _apply_layer_step(cfg, _get(params, slot, r), spec, x,
                                 _get(caches, slot, r), pos,
                                 position_ids=position_ids,
                                 long_ctx=long_ctx)
        (new["prefix"] if slot is None else new["stack"][slot]).append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits_from_hidden(cfg, params, x[:, 0]), new


def prefill(cfg, params, tokens, *, position_ids=None, enc_embeds=None,
            cache_len=None):
    """Forward over the prompt (and, for an encoder-decoder model, the
    encoder over ``enc_embeds``); returns (last-token logits, decode
    caches of ``cache_len`` positions, the prompt's length when None,
    with the cross caches)."""
    logits, caches = forward(cfg, params, tokens, position_ids=position_ids,
                             enc_embeds=enc_embeds, collect_caches=True,
                             last_only=True)
    B, S = tokens.shape
    out = lay_out_caches(cfg, init_caches(
        cfg, B, cache_len or S, cfg.torch_dtype,
        enc_out=caches.get("enc_out"), params=params,
        device=params["tok_embed"].device))
    for slot, r, spec in _layers(cfg):
        src, dst = _get(caches, slot, r), _get(out, slot, r)
        dst["mixer"] = _fill_mixer(cfg, spec, dst["mixer"], src["mixer"])
        if "cm_x_last" in src:
            dst["cm_x_last"] = _like(src["cm_x_last"], dst["cm_x_last"])
    return logits[:, -1], out


def lay_out_caches(cfg, caches, *, long_ctx=False, mesh=None,
                   multi_pod=None):
    """``caches`` laid out on ``mesh`` (the active context's by default)
    by ``cache_spec_tree`` (the KV sequence on ``"longseq"`` with
    ``long_ctx``, on ``"kvseq"`` without): a plain leaf distributed, a
    DTensor one (an encoder-decoder model's cross cache) redistributed.
    Without a mesh, ``caches`` as they are."""
    ctx = current_ctx()
    if mesh is None and ctx is not None:
        mesh, multi_pod = ctx.mesh, ctx.multi_pod
    if mesh is None:
        return caches
    specs = cache_spec_tree(caches, cfg, mesh, bool(multi_pod),
                            long_ctx=long_ctx)
    return tree_map(lambda t, sp: lay_out(t, mesh, placements_for(sp, mesh)),
                    caches, specs)


def _fill_mixer(cfg, spec, dst, src):
    """The prefill's K/V (MLA: its latent ``ckv`` and rotated key ``kr``)
    written into the first positions of the cache (K/V quantized per
    token and head for an int8 cache; each rank into its block of a
    sharded one, :func:`~repro_torch.models.blocks._write_seq`), or a
    recurrent mixer's state (RWKV6's ``S`` and ``x_last``, Mamba's
    ``conv`` and ``h``) in its cache's dtypes and layout."""
    if spec.mixer == "mla":
        for name, t in zip(("ckv", "kr"), src):
            dst[name] = _write_seq(dst[name], t, 0)
        return dst
    if spec.mixer != "gqa":
        return {k: _like(src[k].to(dst[k].dtype), dst[k]) for k in dst}
    k, v = src
    for name, t in (("k", k), ("v", v)):
        if name + "_scale" in dst:
            t, scale = _quantize_kv(t)
            dst[name + "_scale"] = _write_seq(dst[name + "_scale"], scale, 0)
        dst[name] = _write_seq(dst[name], t, 0)
    return dst


def _like(t, like):
    """``t`` in the layout of the cache leaf ``like`` (as it is when
    ``like`` is a plain tensor)."""
    if not is_dtensor(like):
        return t
    return lay_out(t, like.device_mesh, like.placements)
