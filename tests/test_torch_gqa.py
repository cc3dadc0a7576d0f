"""Port parity: the GQA/llama LM path (rope, attention, the GQA mixer with
bf16 and int8 KV caches, the swiglu and gelu MLPs, lm.prefill and
serve_step) against repro.models on the CPU, at the reference's reduced
llama3.2-3b, qwen3-4b, qwen1.5-32b and qwen2-vl-7b (2 layers, d_model
64, 4 q heads and 2 kv heads of 16), in f32 and bf16.

Both packages get the same seeded numpy inputs, and the models run the
reference's weights (``params_from_jax``).  The port's attention goes
through ``flash_attention_op``, which on the CPU runs the kernel's plain
version.  Tolerances:

- f32: rtol = atol = 1e-4 element by element (summation order and the
  1/sqrt(hd) scale applied to q or to the scores).
- bf16, and every comparison through an int8 KV cache: the largest error
  within 2e-2 of the largest magnitude (plus 2e-2), as
  tests/test_torch_lm.py holds bf16.  XLA and PyTorch round a bf16
  matmul one ulp apart here and there; one int8 step is about 0.8% of a
  row's absmax, and a value near a rounding boundary may land one step
  apart.
- ``chunked_attention`` against ``full_attention``: the bf16 rounding
  of p before ``p @ v`` (relative 2^-8 per term), atol = rtol = 1e-2.
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
from repro.models import rope as jrope  # noqa: E402
from repro_torch.configs import archs, base  # noqa: E402
from repro_torch.examples import serve_lm as example  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import attention, blocks, lm, rope  # noqa: E402

GQA_ARCHS = ("llama3.2-3b", "qwen3-4b", "qwen1.5-32b", "qwen2-vl-7b")
DTYPES = ("float32", "bfloat16")
CACHES = ("bfloat16", "int8")
PROMPT = 11


def _np(a):
    """Either package's array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, dtype):
    """``dtype`` "float32": elementwise 1e-4; anything else (bf16, an
    int8 cache): the largest error within 2e-2 of the largest
    magnitude."""
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


# ----------------------------------------------------------------- rope ----
@pytest.mark.parametrize("hd,theta", [(16, 1e4), (64, 1e4), (128, 5e5),
                                      (128, 1e6)])
def test_rope_freqs_match_reference(hd, theta):
    got = rope.rope_freqs(hd, theta)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jrope.rope_freqs(hd, theta)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference_up_to_position_4096(dtype, theta):
    x = _normal(1, 2, 64, 3, 32)
    pos = np.arange(4096 - 64, 4097 - 1).astype(np.int32)
    pos[:8] = np.arange(8)  # small positions in the same call
    got = rope.apply_rope(_t(x, dtype), _t(pos), theta)
    want = jrope.apply_rope(_j(x, dtype), _j(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(dtype, hd, sections):
    B, S = 2, 9
    x = _normal(2, B, S, 4, hd)
    rng = np.random.default_rng(3)
    pid = rng.integers(0, 4096, (3, B, S)).astype(np.int32)
    got = rope.apply_mrope(_t(x, dtype), _t(pid), 1e6, sections)
    want = jrope.apply_mrope(_j(x, dtype), _j(pid), 1e6, sections)
    assert_close(got, want, dtype)
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(_t(x, dtype), _t(pid), 1e6, (1, 1, 1))


@pytest.mark.parametrize("length,dim", [(16, 64), (1500, 1024)])
def test_sinusoidal_matches_reference(length, dim):
    """Whisper's table (1,500 frames of 1,024).  Its angles reach
    ``length`` radians, where one f32 ulp is 1.2e-4 at 1,500, and XLA's
    exp and PyTorch's round some of the scales one ulp apart: the
    elementwise tolerance is 1e-4 plus one ulp of the largest angle."""
    got = rope.sinusoidal(length, dim)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    tol = 1e-4 + float(np.spacing(np.float32(length)))
    np.testing.assert_allclose(got.numpy(), _np(jrope.sinusoidal(
        length, dim)), rtol=1e-4, atol=tol)


# ------------------------------------------------------------ attention ----
ATTN_CASES = {
    "causal": dict(shape=(2, 9, 9, 4, 16), kw={"causal": True}),
    "q_offset": dict(shape=(2, 5, 13, 4, 16),
                     kw={"causal": True, "q_offset": 8}),
    "valid 0": dict(shape=(1, 3, 10, 2, 8),
                    kw={"causal": False, "kv_valid_len": 0}),
    "valid partial": dict(shape=(2, 1, 21, 4, 16),
                          kw={"causal": False, "kv_valid_len": 13}),
    "causal, valid partial": dict(shape=(1, 7, 12, 2, 8),
                                  kw={"causal": True, "q_offset": 5,
                                      "kv_valid_len": 9}),
    "vd != hd (MLA)": dict(shape=(1, 6, 6, 2, 24), kw={"causal": True},
                           vd=16),
}


def _attn_inputs(shape, vd=None, seed=0):
    B, Sq, Skv, H, hd = shape
    return (_normal(seed, B, Sq, H, hd), _normal(seed + 1, B, Skv, H, hd),
            _normal(seed + 2, B, Skv, H, vd or hd))


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_full_attention_matches_reference(case):
    c = ATTN_CASES[case]
    q, k, v = _attn_inputs(c["shape"], c.get("vd"))
    got = attention.full_attention(_t(q), _t(k), _t(v), **c["kw"])
    want = jattn.full_attention(_j(q), _j(k), _j(v), **c["kw"])
    assert_close(got, want, "float32")


@pytest.mark.parametrize("chunk", [4, 5, 64])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_reference(case, chunk):
    """Chunks that divide Skv, that do not (5), and one past it (64).
    Against the naive form they differ by the bf16 rounding of p, except
    in rows that see no key: there the chunked form averages V over the
    keys padded to whole chunks (zeros past Skv), as the reference does,
    and the naive form over Skv."""
    c = ATTN_CASES[case]
    q, k, v = _attn_inputs(c["shape"], c.get("vd"))
    got = attention.chunked_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                      **c["kw"])
    want = jattn.chunked_attention(_j(q), _j(k), _j(v), chunk=chunk,
                                   **c["kw"])
    assert_close(got, want, "float32")
    full = attention.full_attention(_t(q), _t(k), _t(v), **c["kw"])
    if c["kw"].get("kv_valid_len") == 0:
        skv = k.shape[1]
        full = full * skv / (-(-skv // chunk) * chunk)
    torch.testing.assert_close(got, full, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kv,n_rep,target", [(4, 1, 4), (2, 2, 4),
                                             (2, 3, 6), (8, 3, 32),
                                             (2, 2, 16)])
def test_repeat_kv_matches_reference(kv, n_rep, target):
    """Unpadded, and padded past H = kv * n_rep (llama3.2-3b: 8 kv heads
    to 32 padded q heads)."""
    k = _normal(4, 2, 5, kv, 8)
    got = attention.repeat_kv(_t(k), n_rep, target)
    want = jattn.repeat_kv(_j(k), n_rep, target)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rms_head_matches_reference():
    x = _normal(5, 2, 3, 4, 16) * 3
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    for dtype in DTYPES:
        got = blocks.rms_head(_t(x, dtype), _t(scale, dtype))
        want = jblocks.rms_head(_j(x, dtype), _j(scale, dtype))
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_kv_bit_equal_to_reference(dtype):
    t = _normal(6, 2, 7, 3, 16) * 4
    t[0, 1, 2] = 0.0                       # a zero row: scale 1e-6 / 127
    t[1, 3, 0, :4] = [127.5, -0.5, 0.5, 1.5]  # ties to even
    got_q, got_s = blocks._quantize_kv(_t(t, dtype))
    want_q, want_s = jblocks._quantize_kv(_j(t, dtype))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.view(torch.int16).numpy(),
                                  np.asarray(want_s).view(np.int16))


@pytest.mark.parametrize("S,chunk,valid", [(24, 8, 24), (24, 8, 13),
                                           (20, 6, 17), (16, 2048, 1)])
def test_int8_decode_attention_matches_reference(S, chunk, valid):
    cfg = archs.reduced(base.get_config("llama3.2-3b"))
    jcfg = jarchs.reduced(jbase.get_config("llama3.2-3b"))
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _normal(7, 2, 1, H, hd)
    kq, ks = jblocks._quantize_kv(_j(_normal(8, 2, S, KV, hd)))
    vq, vs = jblocks._quantize_kv(_j(_normal(9, 2, S, KV, hd)))
    arrays = [lm._tensor(np.asarray(a), "cpu") for a in (kq, vq, ks, vs)]
    got = blocks._int8_decode_attention(cfg, _t(q, "bfloat16"), *arrays,
                                        valid, chunk=chunk)
    want = jblocks._int8_decode_attention(
        jcfg, _j(q, jnp.bfloat16), kq, vq, ks, vs, valid, chunk=chunk)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, "bfloat16")


# --------------------------------------------------------------- models ----
def _pid(B, S, start=0):
    """Three distinct position components (temporal, height, width)."""
    t = np.arange(start, start + S)
    return np.stack([np.broadcast_to(t, (B, S)),
                     np.broadcast_to(t // 2, (B, S)),
                     np.broadcast_to(t % 5, (B, S))]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _model(name, dtype, cache="bfloat16"):
    return Model(name, dtype, cache)


class Model:
    """A reduced config in both packages, with the reference's weights."""

    def __init__(self, name, dtype, cache="bfloat16", **kw):
        self.dtype, self.int8 = dtype, cache == "int8"
        kw = dict(kw, dtype=dtype, kv_cache_dtype=cache)
        self.jcfg = jarchs.reduced(jbase.get_config(name)).replace(**kw)
        self.cfg = archs.reduced(base.get_config(name)).replace(**kw)
        self.jparams = jlm.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.params = lm.params_from_jax(self.cfg, self.tree, device="cpu")
        self.mrope = self.cfg.rope == "mrope"

    def tokens(self, shape, seed=0):
        t = np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, shape).astype(np.int32)
        return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))

    def pid(self, B, S, start=0):
        """(jax, torch) position_ids, or (None, None) without mrope."""
        if not self.mrope:
            return None, None
        p = _pid(B, S, start)
        return jnp.asarray(p), torch.from_numpy(p.astype(np.int64))

    def layer(self, r):
        return (self.params["stack"][0][r],
                jax.tree.map(lambda a: a[r], self.jparams["stack"][0]))


def _layer_kv(caches, key):
    return torch.stack([c["mixer"][key] for c in caches["stack"][0]])


def _dequant(caches, key, scale):
    return (_layer_kv(caches, key).to(torch.float32)
            * _layer_kv(caches, scale).to(torch.float32)[..., None])


def _jdequant(c, key, scale):
    return (jnp.asarray(c[key], jnp.float32)
            * jnp.asarray(c[scale], jnp.float32)[..., None])


def assert_caches_close(model, caches, jcaches):
    """Every layer's cache against the reference's stacked one; an int8
    cache compared dequantized, its dtypes and layout exactly."""
    jc = jcaches["stack"][0]["mixer"]
    tol = "int8" if model.int8 else model.dtype
    for key in ("k", "v"):
        got = _layer_kv(caches, key)
        assert got.dtype == getattr(torch, str(jc[key].dtype))
        if model.int8:
            assert_close(_dequant(caches, key, key + "_scale"),
                         _jdequant(jc, key, key + "_scale"), tol)
        else:
            assert_close(got, jc[key], tol)


@pytest.mark.parametrize("name", GQA_ARCHS)
def test_params_from_jax_carries_every_leaf_bit_for_bit(name):
    m = _model(name, "bfloat16")
    flat, _ = jax.tree_util.tree_flatten_with_path(m.tree)
    assert {"wq", "wk", "wv", "wo"} <= set(m.params["stack"][0][0]["mixer"])
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        reps = range(m.cfg.pattern_repeats) if keys[0] == "stack" else [None]
        for r in reps:
            t = m.params["stack"][keys[1]][r] if r is not None else m.params
            for k in (keys[2:] if r is not None else keys):
                t = t[k]
            a = np.asarray(leaf if r is None else leaf[r])
            assert tuple(t.shape) == a.shape
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("name", GQA_ARCHS)
def test_init_params_builds_the_reference_layout(name):
    m = _model(name, "bfloat16")
    mine = lm.init_params(3, m.cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine)
    want = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), m.params)
    assert got == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", GQA_ARCHS)
def test_gqa_seq_matches_reference(name, dtype):
    m = _model(name, dtype)
    lp, jlp = m.layer(1)
    x = _normal(10, 2, PROMPT, m.cfg.d_model)
    jpid, tpid = m.pid(2, PROMPT)
    flash_ops.SPEC.reset_counts()
    y, (k, v) = blocks.gqa_seq(m.cfg, lp["mixer"], _t(x, dtype),
                               positions=torch.arange(PROMPT),
                               position_ids=tpid)
    assert flash_ops.SPEC.plain_calls == 1 and flash_ops.SPEC.launches == 0
    jy, (jk, jv) = jblocks.gqa_seq(m.jcfg, jlp["mixer"],
                                   _j(x, m.jcfg.jdtype),
                                   positions=jnp.arange(PROMPT),
                                   position_ids=jpid)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, dtype)


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", GQA_ARCHS)
def test_gqa_step_matches_reference(name, dtype, cache):
    """One token at position 9 against a cache of 14 positions holding
    random K/V below it, through the plain version of the kernel."""
    m = _model(name, dtype, cache)
    lp, jlp = m.layer(0)
    cfg, jcfg = m.cfg, m.jcfg
    x = _normal(11, 2, 1, cfg.d_model)
    shape = (2, 14, cfg.n_kv_heads, cfg.head_dim)
    kv = {"k": _normal(12, *shape), "v": _normal(13, *shape)}
    jcache = {}
    for key, val in kv.items():
        if m.int8:
            jcache[key], jcache[key + "_scale"] = jblocks._quantize_kv(
                _j(val, jcfg.jdtype))
        else:
            jcache[key] = _j(val, jcfg.jdtype)
    cache_t = {k: lm._tensor(np.asarray(v), "cpu")
               for k, v in jcache.items()}
    jpid, tpid = m.pid(2, 1, start=9)
    flash_ops.SPEC.reset_counts()
    y, new = blocks.gqa_step(cfg, lp["mixer"], _t(x, dtype), cache_t, 9,
                             position_ids=tpid)
    assert flash_ops.SPEC.plain_calls == 1
    jy, jnew = jblocks.gqa_step(jcfg, jlp["mixer"], _j(x, jcfg.jdtype),
                                jcache, 9, position_ids=jpid)
    assert_close(y, jy, "int8" if m.int8 else dtype)
    for key in jnew:
        assert new[key].dtype == getattr(torch, str(jnew[key].dtype))
        if m.int8 and key in ("k", "v"):
            assert_close(new[key].float() * new[key + "_scale"].float()
                         [..., None], _jdequant(jnew, key, key + "_scale"),
                         "int8")
        else:
            assert_close(new[key], jnew[key], "int8" if m.int8 else dtype)


def test_gqa_step_mrope_default_broadcasts_pos():
    """Without position_ids, an mrope step takes ``pos`` in all three
    components (the reference's broadcast to [3, B, 1])."""
    m = _model("qwen2-vl-7b", "float32")
    lp, _ = m.layer(0)
    x = _t(_normal(14, 2, 1, m.cfg.d_model))

    def step(**kw):
        cache = blocks.gqa_init_cache(m.cfg, 2, 8, torch.float32, "cpu")
        return blocks.gqa_step(m.cfg, lp["mixer"], x, cache, 5, **kw)[0]
    pid = torch.full((3, 2, 1), 5, dtype=torch.int64)
    assert torch.equal(step(), step(position_ids=pid))
    assert not torch.equal(step(), step(position_ids=pid * 2))


@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen3-4b"])
def test_padded_heads_give_the_unpadded_output(name):
    """The reference pads q heads to a multiple of 16 for tensor
    parallelism and slices the padded heads off; the port pads nothing.
    Attention over the padded heads (the reference's repeat_kv to the
    padded count) equals the unpadded kernel path on the real heads."""
    assert blocks._padded_heads(base.get_config(name)) == 32  # 24 or 32
    cfg = _model(name, "float32").cfg
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hp = blocks._padded_heads(cfg)
    assert (H, Hp) == (4, 16)
    q = _t(_normal(20, 2, 9, H, hd))
    k, v = _t(_normal(21, 2, 9, KV, hd)), _t(_normal(22, 2, 9, KV, hd))
    qp = torch.nn.functional.pad(q, (0, 0, 0, Hp - H))
    n_rep = H // KV
    padded = attention.full_attention(
        qp, attention.repeat_kv(k, n_rep, Hp),
        attention.repeat_kv(v, n_rep, Hp), causal=True)[:, :, :H]
    unpadded = flash_ops.flash_attention_op(q, k, v, causal=True)
    torch.testing.assert_close(padded, unpadded, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,act,bias", [("swiglu", "silu", False),
                                           ("swiglu", "gelu", False),
                                           ("gelu", "gelu", False),
                                           ("gelu", "gelu", True)])
def test_mlp_matches_reference(kind, act, bias, dtype):
    cfg = archs.reduced(base.get_config("llama3.2-3b")).replace(
        dtype=dtype, act=act, qkv_bias=bias)
    jcfg = jarchs.reduced(jbase.get_config("llama3.2-3b")).replace(
        dtype=dtype, act=act, qkv_bias=bias)
    jp = jblocks.mlp_init(jax.random.PRNGKey(4), jcfg, kind)
    if bias:  # non-zero biases, the same in both
        jp = dict(jp, b_up=_j(_normal(15, cfg.d_ff), jcfg.jdtype),
                  b_down=_j(_normal(16, cfg.d_model), jcfg.jdtype))
    p = {k: lm._tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    mine = blocks.mlp_init(torch.Generator().manual_seed(0), cfg, kind)
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in p.items()}
    x = _normal(17, 2, 5, cfg.d_model) * 2
    y, cm = blocks.mlp_apply(cfg, p, _t(x, dtype), kind)
    jy, _ = jblocks.mlp_apply(jcfg, jp, _j(x, jcfg.jdtype), kind)
    assert cm is None and y.dtype == getattr(torch, dtype)
    assert_close(y, jy, dtype)


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", GQA_ARCHS)
def test_prefill_and_serve_steps_match_reference(name, dtype, cache):
    """prefill of 11 tokens into a cache of 14, then three serve_steps,
    against repro.models.lm under the reference's weights: logits and
    every layer's cache; one plain attention call per layer and call."""
    m = _model(name, dtype, cache)
    tol = "int8" if m.int8 else dtype
    jt, tt = m.tokens((2, PROMPT))
    jpid, tpid = m.pid(2, PROMPT)
    flash_ops.SPEC.reset_counts()
    logits, caches = lm.prefill(m.cfg, m.params, tt, position_ids=tpid,
                                cache_len=PROMPT + 3)
    assert flash_ops.SPEC.plain_calls == m.cfg.n_layers
    jlogits, jcaches = jlm.prefill(m.jcfg, m.jparams, jt, position_ids=jpid,
                                   cache_len=PROMPT + 3)
    assert logits.shape == (2, m.cfg.padded_vocab)
    assert_close(logits, jlogits, dtype)
    assert_caches_close(m, caches, jcaches)
    feed = np.random.default_rng(4).integers(0, m.cfg.vocab_size, (3, 2))
    for i, tok in enumerate(feed):
        jpid, tpid = m.pid(2, 1, start=PROMPT + i)
        flash_ops.SPEC.reset_counts()
        logits, caches = lm.serve_step(
            m.cfg, m.params, caches, torch.from_numpy(tok[:, None]),
            PROMPT + i, position_ids=tpid)
        assert flash_ops.SPEC.plain_calls == m.cfg.n_layers
        jlogits, jcaches = jlm.serve_step(
            m.jcfg, m.jparams, jcaches, jnp.asarray(tok[:, None], jnp.int32),
            PROMPT + i, position_ids=jpid)
        assert_close(logits, jlogits, tol)
    assert_caches_close(m, caches, jcaches)


@pytest.mark.parametrize("name,cache", [(n, c) for n in GQA_ARCHS
                                        for c in CACHES]
                         + [("rwkv6-1.6b", "bfloat16")])
def test_decode_matches_forward_f32(name, cache):
    """The port's own check, after tests/test_models.py:52-73: prefill of
    half the sequence, then serve_step token by token, against the
    logits of one forward over the whole sequence, below 1e-3 in f32 (an
    int8 cache: within its quantization, as the reference's own
    bf16-cache check would be)."""
    cfg = archs.reduced(base.get_config(name)).replace(
        dtype="float32", kv_cache_dtype=cache)
    params = lm.init_params(0, cfg, device="cpu")
    S, half = 12, 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)))
    pid = (torch.from_numpy(_pid(2, S).astype(np.int64))
           if cfg.rope == "mrope" else None)

    def cut(a, b):
        return None if pid is None else pid[:, :, a:b]
    full = lm.forward(cfg, params, toks, position_ids=pid)
    lg, caches = lm.prefill(cfg, params, toks[:, :half], cache_len=S,
                            position_ids=cut(0, half))
    errs = [(lg - full[:, half - 1]).abs().max().item()]
    for t in range(half, S):
        lg, caches = lm.serve_step(cfg, params, caches, toks[:, t:t + 1], t,
                                   position_ids=cut(t, t + 1))
        errs.append((lg - full[:, t]).abs().max().item())
    if cache == "int8":
        assert max(errs) < 2e-2 * (1 + full.abs().max().item()), errs
    else:
        assert max(errs) < 1e-3, errs


def test_serve_step_writes_the_cache_in_place():
    """A decode step writes its token's K/V into the buffers it is given
    (the reference returns updated copies) and returns them."""
    m = _model("llama3.2-3b", "float32")
    _, tt = m.tokens((2, PROMPT))
    _, caches = lm.prefill(m.cfg, m.params, tt, cache_len=PROMPT + 1)
    k0 = caches["stack"][0][0]["mixer"]["k"]
    before = k0.clone()
    _, new = lm.serve_step(m.cfg, m.params, caches, tt[:, :1], PROMPT)
    assert new["stack"][0][0]["mixer"]["k"] is k0
    assert torch.equal(k0[:, :PROMPT], before[:, :PROMPT])
    assert not torch.equal(k0[:, PROMPT], before[:, PROMPT])


def test_mrope_prefill_needs_position_ids():
    m = _model("qwen2-vl-7b", "float32")
    _, tt = m.tokens((1, 4))
    with pytest.raises(ValueError, match="position_ids"):
        lm.prefill(m.cfg, m.params, tt)


@pytest.mark.parametrize("name", GQA_ARCHS)
def test_greedy_tokens_equal_reference_f32(name):
    """serve_lm.generate against the loop of examples/serve_lm.py on the
    reference (text prompts under mrope: every component at t)."""
    m = _model(name, "float32")
    jt, tt = m.tokens((2, 8), seed=7)
    gen = 5
    res = serve_lm.generate(m.cfg, m.params, tt, gen)
    pid = (jnp.broadcast_to(jnp.arange(8), (3, 2, 8)) if m.mrope else None)
    jlogits, jcaches = jlm.prefill(m.jcfg, m.jparams, jt, position_ids=pid,
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


def test_serve_lm_example_twin_on_the_cpu():
    """The demo config of examples/serve_lm.py (GQA + swiglu, 4 layers,
    d_model 256, 8 q / 4 kv heads of 32): the twin's greedy tokens, and
    the same loop in f32 under the reference's weights against the
    reference's model token for token."""
    res = example.serve_demo(device="cpu")
    assert res["tokens"].shape == (example.BATCH, example.GEN)
    assert ((res["tokens"] >= 0)
            & (res["tokens"] < example.CFG.vocab_size)).all()
    again = example.serve_demo(device="cpu")
    assert torch.equal(res["tokens"], again["tokens"])
    assert example.main(["--device", "cpu"]) == 0

    jcfg = jbase.ModelConfig(**{
        f: getattr(example.CFG, f) for f in ("name", "n_layers", "d_model",
                                             "n_heads", "n_kv_heads",
                                             "head_dim", "d_ff",
                                             "vocab_size")}).replace(
        dtype="float32")
    cfg = example.CFG.replace(dtype="float32")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (example.BATCH, example.PROMPT_LEN))
    gen = 6
    res = serve_lm.generate(cfg, params, torch.from_numpy(prompts), gen)
    jlogits, jcaches = jlm.prefill(jcfg, jparams, jnp.asarray(prompts),
                                   cache_len=example.PROMPT_LEN + gen)
    step = jax.jit(lambda p, c, t, pos: jlm.serve_step(jcfg, p, c, t, pos))
    tok = jnp.argmax(jlogits, -1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        jlogits, jcaches = step(jparams, jcaches, tok,
                                example.PROMPT_LEN + i)
        tok = jnp.argmax(jlogits, -1)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))
