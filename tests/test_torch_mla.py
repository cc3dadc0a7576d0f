"""Port parity: MLA (deepseek-v2-lite's mixer) and the widened
flash_attention it runs through, against repro.models on the CPU.

Both packages get the same seeded numpy inputs, and the models run the
reference's weights (``params_from_jax``).  MLA's prefill attention
(q.k heads of ``nope + rdim``, v heads of ``v_head_dim``) goes through
``flash_attention_op``, which on the CPU runs the kernel's plain version;
its decode step is the absorbed form in f32 einsums.  The reduced
deepseek-v2-lite has 3 layers (a dense prefix layer and 2 MoE layers),
d_model 64, 4 heads of q.k 16 + 8 and v 16, a latent of 32, and 4
experts top-2 with 2 shared.  Tolerances:

- f32: rtol = atol = 1e-4 element by element (summation order, and
  where the 1/sqrt(hd) scale is applied).
- bf16: the largest error within 2e-2 of the largest magnitude (plus
  2e-2), as tests/test_torch_gqa.py holds bf16: XLA and PyTorch round a
  bf16 matmul one ulp apart here and there.
- gradients through the plain backward: ``ops.bwd_autograd_tol``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import archs, base  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    MAX_HEAD_DIM, MAX_V_HEAD_DIM, fits, flash_attention_bwd, head_tile,
    smem_bytes, v_tile)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.models import blocks, lm  # noqa: E402

DTYPES = ("float32", "bfloat16")
DEEPSEEK = "deepseek-v2-lite-16b"
PROMPT = 11


def _np(a):
    """Either package's array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, dtype):
    """``dtype`` "float32": elementwise 1e-4; bf16: the largest error
    within 2e-2 of the largest magnitude (plus 2e-2)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max()
        assert err <= 2e-2 + 2e-2 * np.abs(want).max(), err


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tree(jtree):
    """A reference parameter dict as the port's CPU tensors, bit for bit."""
    return {k: lm._tensor(np.asarray(v), "cpu") for k, v in jtree.items()}


class Model:
    """A reduced config in both packages, with the reference's weights."""

    def __init__(self, name, dtype, **kw):
        self.dtype = dtype
        kw = dict(kw, dtype=dtype)
        self.jcfg = jarchs.reduced(jbase.get_config(name)).replace(**kw)
        self.cfg = archs.reduced(base.get_config(name)).replace(**kw)
        self.jparams = jlm.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.params = lm.params_from_jax(self.cfg, self.tree, device="cpu")

    def tokens(self, shape, seed=0):
        t = np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, shape).astype(np.int32)
        return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))

    def layer(self, r):
        """Pattern layer ``r`` in both packages."""
        return (self.params["stack"][0][r],
                jax.tree.map(lambda a: a[r], self.jparams["stack"][0]))


@functools.lru_cache(maxsize=None)
def _model(name, dtype, **kw):
    return Model(name, dtype, **kw)


def assert_params_carried(m):
    """Every leaf of the reference's tree in the port's per-layer dicts,
    bit for bit and in its own dtype."""
    flat, _ = jax.tree_util.tree_flatten_with_path(m.tree)
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        reps = range(m.cfg.pattern_repeats) if keys[0] == "stack" else [None]
        for r in reps:
            t = m.params["stack"][keys[1]][r] if r is not None else m.params
            for k in (keys[2:] if r is not None else keys):
                t = t[k]
            a = np.asarray(leaf if r is None else leaf[r])
            assert tuple(t.shape) == a.shape
            assert str(t.dtype).removeprefix("torch.") == a.dtype.name
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)


def assert_layout_matches(m):
    """``init_params`` builds the tree ``params_from_jax`` carries."""
    mine = lm.init_params(3, m.cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine)
    want = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), m.params)
    assert got == want


def run_prefill_and_steps(m, cache_keys, n_steps=3, plain_per_step=0):
    """prefill of ``PROMPT`` tokens into a cache of ``PROMPT + n_steps``,
    then ``n_steps`` serve_steps, against repro.models.lm: logits and
    every layer's cache (``cache_keys`` of each layer's mixer); one plain
    attention call per layer of the prefill, ``plain_per_step`` per layer
    of a step."""
    jt, tt = m.tokens((2, PROMPT))
    L = m.cfg.n_layers
    ops.SPEC.reset_counts()
    logits, caches = lm.prefill(m.cfg, m.params, tt,
                                cache_len=PROMPT + n_steps)
    assert ops.SPEC.plain_calls == L and ops.SPEC.launches == 0
    jlogits, jcaches = jlm.prefill(m.jcfg, m.jparams, jt,
                                   cache_len=PROMPT + n_steps)
    assert logits.shape == (2, m.cfg.padded_vocab)
    assert_close(logits, jlogits, m.dtype)
    assert_caches_close(m, caches, jcaches, cache_keys)
    feed = np.random.default_rng(4).integers(0, m.cfg.vocab_size,
                                             (n_steps, 2))
    for i, tok in enumerate(feed):
        ops.SPEC.reset_counts()
        logits, caches = lm.serve_step(m.cfg, m.params, caches,
                                       torch.from_numpy(tok[:, None]),
                                       PROMPT + i)
        assert ops.SPEC.plain_calls == plain_per_step * L
        jlogits, jcaches = jlm.serve_step(
            m.jcfg, m.jparams, jcaches, jnp.asarray(tok[:, None], jnp.int32),
            PROMPT + i)
        assert_close(logits, jlogits, m.dtype)
    assert_caches_close(m, caches, jcaches, cache_keys)


def assert_caches_close(m, caches, jcaches, keys):
    """The prefix layers' and every pattern layer's cache against the
    reference's (stacked over repeats), dtypes exactly."""
    pairs = [(c["mixer"], jc["mixer"]) for c, jc in
             zip(caches["prefix"], jcaches["prefix"])]
    jstack = jcaches["stack"][0]["mixer"]
    pairs += [(c["mixer"], {k: jstack[k][r] for k in keys})
              for r, c in enumerate(caches["stack"][0])]
    for got, want in pairs:
        for key in keys:
            assert got[key].dtype == getattr(torch, str(want[key].dtype))
            assert_close(got[key], want[key], m.dtype)


def assert_handoff(m):
    """The port's own check: prefill of all but the last token into a
    cache of the prompt's length, then serve_step on the last token,
    against the logits of the whole prompt's prefill (f32 within 1e-4,
    bf16 at its tolerance)."""
    _, tt = m.tokens((2, PROMPT), seed=5)
    want, _ = lm.prefill(m.cfg, m.params, tt)
    _, short = lm.prefill(m.cfg, m.params, tt[:, :-1], cache_len=PROMPT)
    got, _ = lm.serve_step(m.cfg, m.params, short, tt[:, -1:], PROMPT - 1)
    assert_close(got, want, m.dtype)


# ------------------------------------------- the widened attention op -----
ATTN_CASES = {
    "causal": dict(shape=(2, 9, 9, 3), kw={"causal": True}),
    "q_offset": dict(shape=(2, 5, 13, 3), kw={"causal": True,
                                             "q_offset": 8}),
    "valid 0": dict(shape=(1, 3, 10, 2), kw={"causal": False,
                                            "kv_valid_len": 0}),
    "valid partial": dict(shape=(2, 1, 21, 2),
                          kw={"causal": False, "kv_valid_len": 13}),
    "causal, valid partial": dict(shape=(1, 7, 12, 2),
                                  kw={"causal": True, "q_offset": 5,
                                      "kv_valid_len": 9}),
}
WIDTHS = [(24, 16), (192, 128)]


def _mla_inputs(shape, hd, hdv, seed=0):
    B, Sq, Skv, H = shape
    return (_normal(seed, B, Sq, H, hd), _normal(seed + 1, B, Skv, H, hd),
            _normal(seed + 2, B, Skv, H, hdv))


@pytest.mark.parametrize("hd,hdv", WIDTHS)
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_plain_version_matches_full_attention(case, hd, hdv):
    """The kernel's plain version with v narrower than q and k (GQA group
    1, as MLA calls it) against the reference's ``full_attention``."""
    c = ATTN_CASES[case]
    q, k, v = _mla_inputs(c["shape"], hd, hdv)
    got = flash_attention_ref(_t(q), _t(k), _t(v), **c["kw"])
    want = jattn.full_attention(_j(q), _j(k), _j(v), **c["kw"])
    assert got.shape == q.shape[:3] + (hdv,)
    assert_close(got, want, "float32")
    registry.reset_counts()
    op = ops.flash_attention_op(_t(q), _t(k), _t(v), **c["kw"])
    assert ops.SPEC.plain_calls == 1 and ops.SPEC.launches == 0
    assert torch.equal(op, got)


def test_wide_head_tiles_and_their_shared_memory():
    """q.k heads past 128 take tiles of 160, 192 or 256 and V a tile of
    its own (at most 128); f32 tiles past 128 keep one raw K/V stage.
    The MLA prefill's bf16 tile (128 x 128): two stages of 128 K rows of
    200 halves and V rows of 136, through which the 128 q rows pass
    first; in f32 (128 x 32): the q tile of 128 rows of 196 words, one
    raw stage and the TF32 split of K (rows of 196 words) and V (132)."""
    assert [head_tile(hd) for hd in (1, 96, 128, 129, 160, 161, 192, 200,
                                      256)] == [32, 96, 128, 160, 160, 192,
                                                192, 256, 256]
    assert [v_tile(hd) for hd in (24, 96, 128, 192, 256)] == [
        32, 96, 128, 128, 128]
    assert (MAX_HEAD_DIM, MAX_V_HEAD_DIM) == (256, 128)
    assert smem_bytes(128, 128, 192, bf16=True) == (
        2 * 2 * 128 * (200 + 136))
    assert smem_bytes(128, 32, 192, bf16=True) == 2 * 128 * 200
    assert smem_bytes(128, 32, 192) == 4 * 128 * 196 + 3 * 32 * 4 * (
        196 + 132)
    assert smem_bytes(64, 32, 256) == 4 * 64 * 260 + 3 * 32 * 4 * (
        260 + 132)
    # at hd = hdv the layout is the one the kernel always had
    assert smem_bytes(128, 32, 128) == 4 * 128 * 132 + 8 * 32 * 4 * 132
    assert fits(192, 128, 32, True, 128) and fits(192, 128, 128, True, 128)
    assert fits(192, 128, 32, False, 128)
    assert not fits(192, 64, 64, False, 128)
    assert fits(256, 64, 32, False, 128) and not fits(256, 128, 32, False,
                                                      128)
    assert not fits(192, 128, 32, True, 160)   # v past its tile
    assert not fits(24, 128, 32, True, 25)     # v wider than q.k
    assert not fits(264, 64, 32, True, 128)    # q.k past 256
    mla = {"b": 4, "sq": 2048, "skv": 2048, "h": 16, "kv": 16, "hd": 192,
           "hdv": 128, "causal": True, "q_offset": 0, "dtype": "bfloat16"}
    assert ops.SPEC.supports(mla)
    assert registry.resolve_params_info(ops.SPEC, mla) == (
        {"block_q": 128, "block_kv": 128}, "default")
    assert [(c["block_q"], c["block_kv"]) for c in
            ops.SPEC.candidates(mla)] == [(128, 128), (128, 32), (128, 64),
                                         (64, 128), (64, 32), (64, 64)]
    wide32 = dict(mla, hd=256, dtype="float32")
    assert registry.resolve_params_info(ops.SPEC, wide32) == (
        {"block_q": 64, "block_kv": 32}, "default")
    assert not ops.SPEC.supports(dict(mla, hdv=160))
    assert not ops.SPEC.supports(dict(mla, hd=264))
    # the tune cache keys v's width only where it differs
    assert ops.cache_key(mla, "cuda") == (
        "b4-sq2048-skv2048-h16-kv16-hd192-hdv128-c1|bfloat16|cuda")
    q, k, v = (_t(a) for a in _mla_inputs((1, 4, 4, 2), 24, 16))
    assert ops.inspect_call(q, k, v)["hdv"] == 16
    assert "hdv" not in ops.inspect_call(q, k, k)


@pytest.mark.parametrize("hd,hdv", [(24, 16), (192, 128), (160, 160)])
def test_backward_kernel_refuses_the_wider_shapes(hd, hdv):
    """flash_attention_bwd raises NotImplementedError, naming ROADMAP's
    backward kernels list, for a v head of its own width or a q.k head
    past 128, on any device, before it checks anything else."""
    q, k, v = (_t(a) for a in _mla_inputs((1, 4, 4, 2), hd, hdv))
    o = q[..., :hdv].contiguous()
    with pytest.raises(NotImplementedError, match="Backward kernels"):
        flash_attention_bwd(q, k, v, o, o)


@pytest.mark.parametrize("dtype", DTYPES)
def test_differentiable_dispatch_at_the_mla_shape(dtype):
    """``registry._Differentiable`` at q.k 192 / v 128 on the CPU: the
    plain backward's gradients against jax.grad of the reference's
    ``full_attention`` (``bwd_autograd_tol``, group 1)."""
    c = ATTN_CASES["q_offset"]
    q, k, v = _mla_inputs(c["shape"], 192, 128, seed=7)
    do = _normal(11, *q.shape[:3], 128)
    dt = getattr(torch, dtype)
    tq, tk, tv = (_t(a, dtype).requires_grad_() for a in (q, k, v))
    registry.reset_counts()
    o = ops.flash_attention_op(tq, tk, tv, **c["kw"])
    assert o.grad_fn is not None and ops.SPEC.plain_calls == 1
    o.backward(_t(do, dtype))
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, b, d: jattn.full_attention(a, b, d,
                                                           **c["kw"]),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    tol = ops.bwd_autograd_tol(dt, 1)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == dt and tuple(got.shape) == w.shape
        w = _np(w)
        assert np.abs(_np(got) - w).max() <= tol * np.abs(w).max()


# ------------------------------------------------------------ MLA mixer ----
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_vec_matches_reference(dtype):
    x = _normal(5, 2, 3, 32) * 3
    scale = np.linspace(0.5, 1.5, 32).astype(np.float32)
    got = blocks._rms_vec(_t(x, dtype), _t(scale, dtype))
    want = jblocks._rms_vec(_j(x, dtype), _j(scale, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_init_and_cache_take_the_reference_layout(dtype):
    m = _model(DEEPSEEK, dtype)
    jp = jblocks.mla_init(jax.random.PRNGKey(2), m.jcfg)
    mine = blocks.mla_init(torch.Generator().manual_seed(0), m.cfg)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in mine.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    cache = blocks.mla_init_cache(m.cfg, 2, 7, m.cfg.torch_dtype, "cpu")
    jcache = jblocks.mla_init_cache(m.jcfg, 2, 7, m.jcfg.jdtype)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in cache.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jcache.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_seq_matches_reference(dtype):
    """The mixer over 11 tokens at positions 3..13: its output and the
    (ckv, kr) it hands the cache; one plain attention call at q.k 24 / v
    16."""
    m = _model(DEEPSEEK, dtype)
    lp, jlp = m.layer(1)
    x = _normal(10, 2, PROMPT, m.cfg.d_model)
    pos = np.arange(3, 3 + PROMPT)
    registry.reset_counts()
    y, (ckv, kr) = blocks.mla_seq(m.cfg, lp["mixer"], _t(x, dtype),
                                  positions=_t(pos))
    assert ops.SPEC.plain_calls == 1
    jy, (jckv, jkr) = jblocks.mla_seq(m.jcfg, jlp["mixer"],
                                      _j(x, m.jcfg.jdtype),
                                      positions=_j(pos))
    assert ckv.shape == (2, PROMPT, m.cfg.kv_lora_rank)
    assert kr.shape == (2, PROMPT, m.cfg.qk_rope_dim)
    for got, want in ((y, jy), (ckv, jckv), (kr, jkr)):
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_step_matches_reference_and_writes_in_place(dtype):
    """One token at position 9 against a latent cache of 14 positions
    holding random values (those past 9 must not be seen): the output and
    the updated cache, which the port writes into the buffers it was
    given (the reference returns copies); no attention kernel call."""
    m = _model(DEEPSEEK, dtype)
    lp, jlp = m.layer(0)
    cfg, jcfg = m.cfg, m.jcfg
    x = _normal(11, 2, 1, cfg.d_model)
    jcache = {"ckv": _j(_normal(12, 2, 14, cfg.kv_lora_rank), jcfg.jdtype),
              "kr": _j(_normal(13, 2, 14, cfg.qk_rope_dim), jcfg.jdtype)}
    cache = _tree(jcache)
    buffers = dict(cache)
    registry.reset_counts()
    y, new = blocks.mla_step(cfg, lp["mixer"], _t(x, dtype), cache, 9)
    assert ops.SPEC.plain_calls == 0 and ops.SPEC.launches == 0
    assert all(new[k] is buffers[k] for k in buffers)
    jy, jnew = jblocks.mla_step(jcfg, jlp["mixer"], _j(x, jcfg.jdtype),
                                jcache, 9)
    assert_close(y, jy, dtype)
    for key in jnew:
        assert new[key].dtype == getattr(torch, str(jnew[key].dtype))
        assert_close(new[key], jnew[key], dtype)
    # positions past 9 change nothing
    cache2 = _tree(jcache)
    cache2["ckv"][:, 10:] = 100.0
    y2, _ = blocks.mla_step(cfg, lp["mixer"], _t(x, dtype), cache2, 9)
    assert torch.equal(y, y2)


# ---------------------------------------------------- deepseek-v2-lite ----
@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_params_carry_every_leaf_and_init_matches(dtype):
    """Every reference leaf, the stacked experts ``[R, E, d, f]`` among
    them, lands in the port's per-layer dicts bit for bit, the router in
    f32; ``init_params`` builds the same layout."""
    m = _model(DEEPSEEK, dtype)
    assert_params_carried(m)
    moe = m.params["stack"][0][0]["mlp"]
    assert moe["w_router"].dtype == torch.float32
    assert moe["we1"].shape == (m.cfg.n_experts, m.cfg.d_model,
                                m.cfg.moe_d_ff)
    assert set(m.params["prefix"][0]["mlp"]) == {"w1", "w2", "w3"}
    assert_layout_matches(m)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_forward_matches_reference(dtype):
    m = _model(DEEPSEEK, dtype)
    jt, tt = m.tokens((2, PROMPT), seed=1)
    registry.reset_counts()
    got = lm.forward(m.cfg, m.params, tt)
    assert ops.SPEC.plain_calls == m.cfg.n_layers
    assert_close(got, jlm.forward(m.jcfg, m.jparams, jt), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_prefill_and_serve_steps_match_reference(dtype):
    """prefill of 11 tokens into a cache of 14, then three serve_steps:
    logits and every layer's latent cache; attention runs through the
    plain version once per layer of the prefill and not at all in a
    step (the absorbed form)."""
    run_prefill_and_steps(_model(DEEPSEEK, dtype), ("ckv", "kr"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_handoff_matches_the_prefill(dtype):
    assert_handoff(_model(DEEPSEEK, dtype))


def test_deepseek_decode_matches_forward_f32():
    """After tests/test_models.py:52-73: prefill of half the sequence,
    then serve_step token by token, against the logits of one forward
    over the whole sequence, below 1e-3 in f32 (the reduced config's
    capacity drops nothing)."""
    cfg = archs.reduced(base.get_config(DEEPSEEK)).replace(dtype="float32")
    params = lm.init_params(0, cfg, device="cpu")
    S, half = 12, 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)))
    full = lm.forward(cfg, params, toks)
    _, caches = lm.prefill(cfg, params, toks[:, :half], cache_len=S)
    for t in range(half, S):
        logits, caches = lm.serve_step(cfg, params, caches,
                                       toks[:, t:t + 1], t)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-3, atol=1e-3)
