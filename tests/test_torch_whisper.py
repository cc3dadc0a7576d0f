"""Port parity: the encoder-decoder LM (whisper-medium) against
repro.models on the CPU, at the reference's reduced config (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16 with no GQA, 16 encoder
frames, qkv bias, LayerNorm, gelu, learned decoder positions), in f32
and bf16, with bf16 and int8 self-attention caches.

Both packages get the same numpy-seeded frame embeddings and tokens, and
the port runs the reference's weights (``params_from_jax``).  Every
attention call (the encoder's, the decoder's self attention and its
cross attention) goes through ``flash_attention_op``, which on the CPU
runs the kernel's plain version.  Tolerances are the GQA family's
(tests/test_torch_gqa.py):

- f32: rtol = atol = 1e-4 element by element; gradients, each leaf's
  largest error within 1e-4 of its largest magnitude, the loss rtol
  1e-5 (tests/test_torch_train.py).  The key bias ``bk`` is the
  exception: without a rotation it adds ``q . bk`` to every score of a
  row, which the softmax cancels, so its exact gradient is zero and both
  packages give rounding noise (about 1e-9, where its neighbours are
  1e-2); it is held to zero, within 1e-6 of the layer's largest ``wk``
  gradient, in both;
- bf16, and every comparison through an int8 self cache: the largest
  error within 2e-2 of the largest magnitude (plus 2e-2).
"""
import functools

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import archs, base  # noqa: E402
from repro_torch.examples import serve_lm as example  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from test_torch_gqa import (CACHES, DTYPES, Model, _j, _normal, _np,  # noqa: E402
                            _t, assert_close)

WHISPER = "whisper-medium"
B, PROMPT, STEPS = 2, 9, 3
GRAD_TOL_F32 = 1e-4
#: a gradient that is zero in exact arithmetic (``bk``'s), as a share of
#: the largest gradient of the same layer's ``wk``
ZERO_GRAD_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _model(dtype, cache="bfloat16"):
    return Model(WHISPER, dtype, cache)


def _frames(m, seed=5, batch=B):
    """(jax, torch) frame embeddings ``[batch, enc_ctx, d]`` in the model's
    dtype, from one numpy draw."""
    e = _normal(seed, batch, m.cfg.enc_ctx, m.cfg.d_model)
    return _j(e, m.jcfg.jdtype), _t(e, m.dtype)


def _layers_of(caches, key, mixer=False):
    """Every decoder layer's ``key`` (in its mixer's cache with
    ``mixer``), stacked as the reference stacks them."""
    return torch.stack([(c["mixer"] if mixer else c)[key]
                        for c in caches["stack"][0]])


def assert_cross_and_self_close(m, caches, jcaches):
    """Every decoder layer's cross K/V (always in the model's dtype) and
    self K/V (an int8 cache dequantized) against the reference's."""
    jc = jcaches["stack"][0]
    for key in ("cross_k", "cross_v"):
        got = _layers_of(caches, key)
        assert got.dtype == getattr(torch, m.dtype)
        assert str(jc[key].dtype) == m.dtype
        assert_close(got, jc[key], m.dtype)
    tol = "int8" if m.int8 else m.dtype
    for key in ("k", "v"):
        got = _layers_of(caches, key, mixer=True)
        want = jc["mixer"][key]
        assert got.dtype == getattr(torch, str(want.dtype))
        if m.int8:
            scale = _layers_of(caches, key + "_scale", mixer=True)
            got = got.float() * scale.float()[..., None]
            want = (jnp.asarray(want, jnp.float32) * jnp.asarray(
                jc["mixer"][key + "_scale"], jnp.float32)[..., None])
        assert_close(got, want, tol)


# ----------------------------------------------------------- parameters ----
@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_jax_carries_every_leaf_bit_for_bit(dtype):
    """Every leaf of the reference's tree, the encoder's and each decoder
    layer's ``cross``/``ln_cross`` among them, bit for bit in its dtype."""
    m = _model(dtype)
    flat, _ = jax.tree_util.tree_flatten_with_path(m.tree)
    keys_seen = set()
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        keys_seen.update(k for k in keys if isinstance(k, str))
        if keys[0] == "encoder" and keys[1] == "stack":
            R, tree, rest = m.cfg.enc_layers, m.params["encoder"]["stack"][
                keys[2]], keys[3:]
        elif keys[0] == "stack":
            R, tree, rest = m.cfg.pattern_repeats, m.params["stack"][
                keys[1]], keys[2:]
        else:
            R, tree, rest = None, m.params, keys
        for r in ([None] if R is None else range(R)):
            t = tree if r is None else tree[r]
            for k in rest:
                t = t[k]
            a = np.asarray(leaf if r is None else leaf[r])
            assert tuple(t.shape) == a.shape
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)
    assert {"encoder", "cross", "ln_cross", "bq", "bk", "bv",
            "pos_embed"} <= keys_seen


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_builds_the_reference_layout(dtype):
    m = _model(dtype)
    mine = lm.init_params(3, m.cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine)
    want = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), m.params)
    assert got == want
    assert len(mine["encoder"]["stack"][0]) == m.cfg.enc_layers


def test_cross_init_has_no_qk_norm():
    """``gqa_init(cross=True)`` leaves out q/k norms under ``qk_norm``,
    as the reference's does; the self-attention init keeps them."""
    cfg = archs.reduced(base.get_config("qwen3-4b"))
    jcfg = jarchs.reduced(jbase.get_config("qwen3-4b"))
    for cross in (False, True):
        mine = blocks.gqa_init(torch.Generator().manual_seed(0), cfg,
                               cross=cross)
        ref = jblocks.gqa_init(jax.random.PRNGKey(0), jcfg, cross=cross)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}
        assert ("q_norm" in mine) is not cross


# ------------------------------------------------------ cross attention ----
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kv_matches_reference(dtype):
    """K and V of the encoder output, ``bk``/``bv`` added (non-zero
    here), in the model's dtype."""
    m = _model(dtype)
    lp, jlp = m.layer(1)
    p, jp = _nonzero_bias(m, lp, jlp, 20)
    e = _normal(6, B, m.cfg.enc_ctx, m.cfg.d_model)
    k, v = lm._cross_kv(m.cfg, p, _t(e, dtype))
    jk, jv = jlm._cross_kv(m.jcfg, jp, _j(e, m.jcfg.jdtype))
    for got, want in ((k, jk), (v, jv)):
        assert got.shape == (B, m.cfg.enc_ctx, m.cfg.n_kv_heads,
                             m.cfg.head_dim)
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, dtype)


def _nonzero_bias(m, lp, jlp, seed):
    """The cross layer's parameters with seeded non-zero biases (the
    init's are zeros), the same in both packages."""
    jp = dict(jlp["cross"])
    for i, key in enumerate(("bq", "bk", "bv")):
        jp[key] = _j(_normal(seed + i, jp[key].shape[0]) * 0.3,
                     m.jcfg.jdtype)
    return {k: lm._tensor(np.asarray(v), "cpu") for k, v in jp.items()}, jp


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_seq_cross_matches_reference(dtype):
    """Cross attention over a sequence: q alone projected (with ``bq``),
    no rotation, every query over every encoder key, one plain attention
    call; the K/V it returns are the ones given."""
    m = _model(dtype)
    lp, jlp = m.layer(0)
    p, jp = _nonzero_bias(m, lp, jlp, 30)
    x = _normal(7, B, PROMPT, m.cfg.d_model)
    e = _normal(8, B, m.cfg.enc_ctx, m.cfg.d_model)
    ckv = lm._cross_kv(m.cfg, p, _t(e, dtype))
    jckv = jlm._cross_kv(m.jcfg, jp, _j(e, m.jcfg.jdtype))
    flash_ops.SPEC.reset_counts()
    y, kv = blocks.gqa_seq(m.cfg, p, _t(x, dtype),
                           positions=torch.arange(PROMPT), cross_kv=ckv)
    assert flash_ops.SPEC.plain_calls == 1
    assert kv[0] is ckv[0] and kv[1] is ckv[1]
    jy, _ = jblocks.gqa_seq(m.jcfg, jp, _j(x, m.jcfg.jdtype),
                            positions=jnp.arange(PROMPT), cross_kv=jckv)
    assert y.dtype == getattr(torch, dtype)
    assert_close(y, jy, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_step_cross_matches_reference(dtype):
    """A decode step's cross attention: over all the encoder's keys, the
    cache handed back as it came."""
    m = _model(dtype)
    lp, jlp = m.layer(1)
    p, jp = _nonzero_bias(m, lp, jlp, 40)
    x = _normal(9, B, 1, m.cfg.d_model)
    e = _normal(10, B, m.cfg.enc_ctx, m.cfg.d_model)
    ckv = lm._cross_kv(m.cfg, p, _t(e, dtype))
    jckv = jlm._cross_kv(m.jcfg, jp, _j(e, m.jcfg.jdtype))
    flash_ops.SPEC.reset_counts()
    sentinel = {"k": torch.zeros(1)}
    y, back = blocks.gqa_step(m.cfg, p, _t(x, dtype), sentinel, 11,
                              cross_kv=ckv)
    assert flash_ops.SPEC.plain_calls == 1 and back is sentinel
    jy, _ = jblocks.gqa_step(m.jcfg, jp, _j(x, m.jcfg.jdtype), None, 11,
                             cross_kv=jckv)
    assert_close(y, jy, dtype)


# -------------------------------------------------------------- encoder ----
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    """Sinusoidal positions, the encoder stack and its final norm; one
    plain attention call a layer."""
    m = _model(dtype)
    je, te = _frames(m)
    flash_ops.SPEC.reset_counts()
    got = lm.encode(m.cfg, m.params, te)
    assert flash_ops.SPEC.plain_calls == m.cfg.enc_layers
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, jlm.encode(m.jcfg, m.jparams, je), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_is_causal_in_both_packages(dtype):
    """The reference runs its encoder's attention causal (``gqa_seq``'s
    default), so does the port: a change to frame 11 moves no earlier
    frame's output, in either package, and moves frame 11's."""
    m = _model(dtype)
    e = _normal(5, B, m.cfg.enc_ctx, m.cfg.d_model)
    e2 = e.copy()
    e2[:, 11] += 3.0
    mine = [lm.encode(m.cfg, m.params, _t(a, dtype)) for a in (e, e2)]
    ref = [_np(jlm.encode(m.jcfg, m.jparams, _j(a, m.jcfg.jdtype)))
           for a in (e, e2)]
    assert torch.equal(mine[0][:, :11], mine[1][:, :11])
    np.testing.assert_array_equal(ref[0][:, :11], ref[1][:, :11])
    assert not torch.equal(mine[0][:, 11], mine[1][:, 11])
    assert not np.array_equal(ref[0][:, 11], ref[1][:, 11])


# ---------------------------------------------------------------- model ----
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    """Logits of the whole sequence, and the encoder's output, which
    ``forward(collect_caches=True)`` returns in its caches as
    ``"enc_out"`` (the reference returns it third)."""
    m = _model(dtype)
    je, te = _frames(m)
    jt, tt = m.tokens((B, PROMPT))
    flash_ops.SPEC.reset_counts()
    logits = lm.forward(m.cfg, m.params, tt, enc_embeds=te)
    assert flash_ops.SPEC.plain_calls == m.cfg.enc_layers + \
        2 * m.cfg.n_layers
    jlogits, _, jenc = jlm.forward(m.jcfg, m.jparams, jt, enc_embeds=je,
                                   collect_caches=True)
    assert logits.shape == (B, PROMPT, m.cfg.padded_vocab)
    assert_close(logits[..., :m.cfg.vocab_size],
                 jlogits[..., :m.cfg.vocab_size], dtype)
    _, caches = lm.forward(m.cfg, m.params, tt, enc_embeds=te,
                           collect_caches=True, last_only=True)
    assert_close(caches["enc_out"], jenc, dtype)


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_serve_steps_match_reference(dtype, cache):
    """prefill of 9 tokens over 16 frames into a cache of 12, then three
    serve_steps: logits, every layer's self and cross K/V, and the plain
    attention calls (encoder, self and cross a prefill; self and cross a
    step)."""
    m = _model(dtype, cache)
    tol = "int8" if m.int8 else dtype
    je, te = _frames(m)
    jt, tt = m.tokens((B, PROMPT))
    L = m.cfg.n_layers
    flash_ops.SPEC.reset_counts()
    logits, caches = lm.prefill(m.cfg, m.params, tt, enc_embeds=te,
                                cache_len=PROMPT + STEPS)
    assert flash_ops.SPEC.plain_calls == m.cfg.enc_layers + 2 * L
    jlogits, jcaches = jlm.prefill(m.jcfg, m.jparams, jt, enc_embeds=je,
                                   cache_len=PROMPT + STEPS)
    assert logits.shape == (B, m.cfg.padded_vocab)
    assert_close(logits, jlogits, dtype)
    assert_cross_and_self_close(m, caches, jcaches)
    cross = [c["cross_k"] for c in caches["stack"][0]]
    feed = np.random.default_rng(4).integers(0, m.cfg.vocab_size,
                                             (STEPS, B))
    for i, tok in enumerate(feed):
        flash_ops.SPEC.reset_counts()
        logits, caches = lm.serve_step(m.cfg, m.params, caches,
                                       torch.from_numpy(tok[:, None]),
                                       PROMPT + i)
        assert flash_ops.SPEC.plain_calls == 2 * L
        jlogits, jcaches = jlm.serve_step(
            m.jcfg, m.jparams, jcaches, jnp.asarray(tok[:, None], jnp.int32),
            PROMPT + i)
        assert_close(logits, jlogits, tol)
    assert all(c["cross_k"] is k for c, k in zip(caches["stack"][0], cross))
    assert_cross_and_self_close(m, caches, jcaches)


def test_cross_cache_stays_in_the_model_dtype_under_int8():
    """An int8 self cache quantizes K/V; the cross cache stays in the
    model's dtype, as the reference's, whose cross K/V are never
    quantized; ``init_caches`` makes them from ``enc_out`` and the
    parameters."""
    m = _model("bfloat16", "int8")
    je, te = _frames(m)
    enc = lm.encode(m.cfg, m.params, te)
    caches = lm.init_caches(m.cfg, B, 8, enc_out=enc, params=m.params,
                            device="cpu")
    jcaches = jlm.init_caches(m.jcfg, B, 8, enc_out=jlm.encode(
        m.jcfg, m.jparams, je), params=m.jparams)
    for c in caches["stack"][0]:
        assert c["mixer"]["k"].dtype == torch.int8
        assert c["cross_k"].dtype == c["cross_v"].dtype == torch.bfloat16
    jc = jcaches["stack"][0]
    assert str(jc["mixer"]["k"].dtype) == "int8"
    assert str(jc["cross_k"].dtype) == "bfloat16"
    assert_close(_layers_of(caches, "cross_v"), jc["cross_v"], "bfloat16")


def test_enc_dec_without_enc_embeds_raises():
    m = _model("float32")
    _, tt = m.tokens((B, PROMPT))
    for call in (lambda: lm.forward(m.cfg, m.params, tt),
                 lambda: lm.prefill(m.cfg, m.params, tt),
                 lambda: lm.train_loss(m.cfg, m.params,
                                       {"tokens": tt, "targets": tt}),
                 lambda: lm.init_caches(m.cfg, B, 4, device="cpu")):
        with pytest.raises(ValueError, match="enc"):
            call()


def test_decoder_only_config_ignores_enc_embeds():
    """llama's logits and loss are the same with and without frame
    embeddings, in both packages (the reference's ``hidden_states``
    encodes only under ``enc_dec``)."""
    m = Model("llama3.2-3b", "float32")
    jt, tt = m.tokens((B, PROMPT))
    e = _normal(12, B, 5, m.cfg.d_model)
    without = lm.forward(m.cfg, m.params, tt)
    assert torch.equal(lm.forward(m.cfg, m.params, tt, enc_embeds=_t(e)),
                       without)
    jwithout = jlm.forward(m.jcfg, m.jparams, jt)
    np.testing.assert_array_equal(
        _np(jlm.forward(m.jcfg, m.jparams, jt, enc_embeds=_j(e))),
        _np(jwithout))
    assert_close(without, jwithout, "float32")


def test_decode_matches_forward_f32():
    """The port's own check: prefill of half the sequence, then
    serve_step token by token, against one forward over the whole
    sequence over the same frames, below 1e-3 in f32."""
    cfg = archs.reduced(base.get_config(WHISPER)).replace(dtype="float32")
    params = lm.init_params(0, cfg, device="cpu")
    S, half = 12, 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)))
    e = _t(_normal(13, B, cfg.enc_ctx, cfg.d_model))
    full = lm.forward(cfg, params, toks, enc_embeds=e)
    lg, caches = lm.prefill(cfg, params, toks[:, :half], enc_embeds=e,
                            cache_len=S)
    errs = [(lg - full[:, half - 1]).abs().max().item()]
    for t in range(half, S):
        lg, caches = lm.serve_step(cfg, params, caches, toks[:, t:t + 1], t)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 1e-3, errs


# ------------------------------------------------------------- training ----
def _stacked(layers):
    if isinstance(layers[0], dict):
        return {k: _stacked([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack([_np(t.detach()) for t in layers])


def _ref_layout(tree):
    """A port gradient tree in the reference's layout: each stack slot's
    layers (the encoder's too) stacked on a leading axis."""
    out = {}
    for k, v in tree.items():
        if k == "stack":
            out[k] = tuple(_stacked(slot) for slot in v)
        elif k == "encoder":
            out[k] = _ref_layout(v)
        else:
            out[k] = jax.tree.map(lambda t: _np(t.detach()), v)
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_train_loss_and_every_grad_match_reference_f32(remat):
    """f32: the loss within rtol 1e-5 and every leaf's gradient (the
    encoder's, the cross projections' and norms' among them) within 1e-4
    of its largest magnitude of ``jax.value_and_grad`` of the reference's
    ``train_loss`` with ``enc_embeds``; with and without remat."""
    m = _model("float32")
    cfg, jcfg = m.cfg.replace(remat=remat), m.jcfg.replace(remat=remat)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT + 1))
    e = _normal(14, B, cfg.enc_ctx, cfg.d_model)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "targets": jnp.asarray(toks[:, 1:], jnp.int32),
              "enc_embeds": _j(e)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, jbatch))(m.jparams)
    params = lm.params_from_jax(cfg, m.tree, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:]),
             "enc_embeds": _t(e)}
    loss = lm.train_loss(cfg, params, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    it = iter(torch.autograd.grad(loss, leaves))
    got = dict(jax.tree_util.tree_flatten_with_path(
        _ref_layout(tree_map(lambda t: next(it), params)))[0])
    want, _ = jax.tree_util.tree_flatten_with_path(jax.tree.map(_np, jgrads))
    assert set(got) == {p for p, _ in want}
    assert any("encoder" in jax.tree_util.keystr(p) for p, _ in want)
    want = dict(want)
    for path, w in want.items():
        name = jax.tree_util.keystr(path)
        if path[-1].key == "bk":
            scale = np.abs(want[path[:-1] + (jax.tree_util.DictKey("wk"),)]
                           ).max()
            for g in (got[path], w):
                assert np.abs(g).max() <= ZERO_GRAD_TOL * scale, name
            continue
        err = np.abs(got[path] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL_F32, (name, err)


# -------------------------------------------------------------- serving ----
def test_greedy_tokens_equal_reference_f32():
    """serve_lm.generate with frame embeddings against the loop of
    examples/serve_lm.py on the reference, token for token."""
    m = _model("float32")
    je, te = _frames(m, seed=15)
    jt, tt = m.tokens((B, 8), seed=7)
    gen = 5
    res = serve_lm.generate(m.cfg, m.params, tt, gen, enc_embeds=te)
    jlogits, jcaches = jlm.prefill(m.jcfg, m.jparams, jt, enc_embeds=je,
                                   cache_len=8 + gen)
    tok = jnp.argmax(jlogits, -1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        jlogits, jcaches = jlm.serve_step(m.jcfg, m.jparams, jcaches, tok,
                                          8 + i)
        tok = jnp.argmax(jlogits, -1)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))
    assert_close(res["logits"], jlogits, "float32")


def test_serve_demo_takes_reduced_whisper():
    """The demo twin at ``--arch whisper-medium``: the reduced config,
    seeded weights, prompts and frames, greedy tokens in the vocabulary,
    the same on a second run."""
    res = example.serve_demo(device="cpu", arch=WHISPER)
    vocab = archs.reduced(base.get_config(WHISPER)).vocab_size
    assert res["tokens"].shape == (example.BATCH, example.GEN)
    assert ((res["tokens"] >= 0) & (res["tokens"] < vocab)).all()
    again = example.serve_demo(device="cpu", arch=WHISPER)
    assert torch.equal(res["tokens"], again["tokens"])
    assert example.main(["--device", "cpu", "--arch", WHISPER]) == 0


def test_enc_embeds_for_follows_the_config():
    """The launcher's stub frontend: frames ``[B, enc_ctx, d]`` in the
    model's dtype for whisper, None for a decoder-only model."""
    cfg = archs.reduced(base.get_config(WHISPER))
    e = serve_lm.enc_embeds_for(cfg, 3, torch.Generator().manual_seed(0))
    assert e.shape == (3, cfg.enc_ctx, cfg.d_model)
    assert e.dtype == cfg.torch_dtype
    assert serve_lm.enc_embeds_for(archs.reduced(base.get_config(
        "llama3.2-3b")), 3, torch.Generator()) is None
