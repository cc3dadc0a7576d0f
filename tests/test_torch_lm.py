"""Port parity: the RWKV6 LM's serving path (configs, blocks, lm, the
greedy loop) against repro.models on the CPU, at the reference's reduced
rwkv6-1.6b (2 layers, d_model 64, 4 heads of 16), in its configured bf16
and in f32.

Both packages run the reference's weights (``params_from_jax``) on the
same tokens.  Tolerances: in f32, rtol = atol = 1e-4 element by element:
the port's sequential recurrence against the reference's associative
scan differs in the last bits of the state.  In bf16, the reference's own
model tolerance, 2e-2 (``tests/test_kernels.py:118-122``), applied to the
largest error against the largest magnitude of each compared tensor:
XLA and PyTorch round a bf16 matmul's output one ulp apart here and
there, and the recurrence sums those differences over time, so a state
element near zero can differ by more than 2e-2 of itself.
"""
import dataclasses

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
from repro_torch.kernels.rwkv6_chunk import ops as rwkv_ops  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402

DTYPES = ("bfloat16", "float32")
PROMPT = 33


def _np(a):
    """Either package's array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max()
        assert err <= 2e-2 + 2e-2 * np.abs(want).max(), err


def _cfgs(dtype, **kw):
    return (jarchs.reduced(jbase.get_config("rwkv6-1.6b")).replace(
                dtype=dtype, **kw),
            archs.reduced(base.get_config("rwkv6-1.6b")).replace(
                dtype=dtype, **kw))


class Model:
    """The reduced model in both packages, with the reference's weights."""

    def __init__(self, dtype, **kw):
        self.dtype = dtype
        self.jcfg, self.cfg = _cfgs(dtype, **kw)
        self.jparams = jlm.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.params = lm.params_from_jax(self.cfg, self.tree, device="cpu")

    def tokens(self, shape, seed=0):
        t = np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, shape).astype(np.int32)
        return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


@pytest.fixture(scope="module", params=DTYPES)
def model(request):
    return Model(request.param)


def _stacked(caches, key, sub=None):
    """The port's per-layer caches stacked as the reference's [R, ...]."""
    cs = [c[key] if sub is None else c[key][sub] for c in caches["stack"][0]]
    return torch.stack(cs)


def _jstacked(caches, key, sub=None):
    c = caches["stack"][0][key]
    return c if sub is None else c[sub]


# -------------------------------------------------------------- configs ----
@pytest.mark.parametrize("name", jarchs.ARCH_NAMES)
def test_configs_equal_reference_field_by_field(name):
    mine, ref = base.get_config(name), jbase.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_counts() == ref.param_counts()
    for prop in ("pattern_repeats", "n_rwkv_heads", "padded_vocab",
                 "mamba_d_inner", "dt_rank"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.torch_dtype == getattr(torch, str(ref.jdtype))
    small, jsmall = archs.reduced(mine), jarchs.reduced(ref)
    assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    assert small.param_counts() == jsmall.param_counts()
    for shape in jbase.SHAPES:
        assert base.cell_supported(mine, base.SHAPES[shape]) == \
            jbase.cell_supported(ref, jbase.SHAPES[shape])


def test_registry_and_shapes_equal_reference():
    assert archs.ARCH_NAMES == jarchs.ARCH_NAMES
    assert sorted(base.all_configs()) == sorted(jbase.all_configs())
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    cfg = base.get_config("rwkv6-1.6b")
    assert base.with_repeats(cfg, 3).n_layers == 3


def test_unported_mixers_raise_naming_the_queue_item():
    """No registered config raises from ``_check_supported`` any more:
    whisper-medium (item 10.4, the encoder and cross attention) was the
    last family the port refused, and every family builds at its
    reduced size (tests/test_torch_whisper.py, test_torch_mla.py,
    test_torch_moe.py and test_torch_mamba.py hold them to the
    reference).  A mixer or MLP kind the port does not know still
    raises."""
    for name in archs.ARCH_NAMES:
        cfg = archs.reduced(base.get_config(name))
        lm._check_supported(cfg)
        lm._check_supported(base.get_config(name))
        assert lm.init_params(0, cfg, device="cpu")["tok_embed"].shape == (
            cfg.padded_vocab, cfg.d_model)
    llama = archs.reduced(base.get_config("llama3.2-3b"))
    with pytest.raises(ValueError, match="unknown mixer"):
        lm._check_supported(llama.replace(
            pattern=(base.LayerSpec(mixer="lstm"),)))
    with pytest.raises(ValueError, match="unknown mlp"):
        lm._check_supported(llama.replace(
            pattern=(base.LayerSpec(mlp="relu"),)))


# ----------------------------------------------------------- parameters ----
def test_params_from_jax_carries_every_leaf_bit_for_bit(model):
    cfg = model.cfg
    flat, _ = jax.tree_util.tree_flatten_with_path(model.tree)
    assert flat
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "stack":
            for r in range(cfg.pattern_repeats):
                t = model.params["stack"][keys[1]][r]
                for k in keys[2:]:
                    t = t[k]
                _assert_bits(t, leaf[r])
        else:
            t = model.params
            for k in keys:
                t = t[k]
            _assert_bits(t, leaf)


def _assert_bits(t, a):
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape
    if a.dtype.name == "bfloat16":
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("surrogate", [0, 16])
def test_init_params_builds_the_reference_layout(model, surrogate):
    cfg = model.cfg.replace(ffn_surrogate_dim=surrogate)
    jcfg = model.jcfg.replace(ffn_surrogate_dim=surrogate)
    mine = lm.init_params(3, cfg, device="cpu")
    ref = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    unstacked = lm.params_from_jax(cfg, jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), ref), device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine)
    want = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), unstacked)
    assert got == want
    again = lm.init_params(3, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(mine), jax.tree.leaves(again)))


# ---------------------------------------------------------------- mixer ----
@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("carry", [False, True])
def test_rwkv6_seq_matches_reference(model, chunk, carry):
    cfg, jcfg = model.cfg, model.jcfg
    lp = model.params["stack"][0][1]["mixer"]
    jlp = jax.tree.map(lambda a: a[1], model.jparams["stack"][0]["mixer"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, PROMPT, cfg.d_model)).astype(np.float32)
    kw, jkw = {}, {}
    if carry:
        xp = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
        s0 = rng.normal(size=(2, cfg.n_rwkv_heads, cfg.rwkv_head_size,
                              cfg.rwkv_head_size)).astype(np.float32)
        kw = {"x_prev0": torch.from_numpy(xp).to(cfg.torch_dtype),
              "S0": torch.from_numpy(s0)}
        jkw = {"x_prev0": jnp.asarray(xp, jcfg.jdtype),
               "S0": jnp.asarray(s0)}
    y, st = blocks.rwkv6_seq(cfg, lp, torch.from_numpy(x).to(
        cfg.torch_dtype), chunk=chunk, **kw)
    jy, jst = jblocks.rwkv6_seq(jcfg, jlp, jnp.asarray(x, jcfg.jdtype),
                                chunk=chunk, **jkw)
    assert y.dtype == cfg.torch_dtype and st["S"].dtype == torch.float32
    assert_close(y, jy, model.dtype)
    assert_close(st["S"], jst["S"], model.dtype)
    assert_close(st["x_last"], jst["x_last"], model.dtype)


def test_rwkv6_step_matches_reference(model):
    cfg, jcfg = model.cfg, model.jcfg
    lp = model.params["stack"][0][0]["mixer"]
    jlp = jax.tree.map(lambda a: a[0], model.jparams["stack"][0]["mixer"])
    rng = np.random.default_rng(6)
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    state = {"S": rng.normal(size=(3, H, hd, hd)).astype(np.float32),
             "x_last": rng.normal(size=(3, cfg.d_model)).astype(np.float32)}
    y, st = blocks.rwkv6_step(
        cfg, lp, torch.from_numpy(x).to(cfg.torch_dtype),
        {"S": torch.from_numpy(state["S"]),
         "x_last": torch.from_numpy(state["x_last"]).to(cfg.torch_dtype)}, 7)
    jy, jst = jblocks.rwkv6_step(
        jcfg, jlp, jnp.asarray(x, jcfg.jdtype),
        {"S": jnp.asarray(state["S"]),
         "x_last": jnp.asarray(state["x_last"], jcfg.jdtype)}, 7)
    assert_close(y, jy, model.dtype)
    assert_close(st["S"], jst["S"], model.dtype)
    assert torch.equal(st["x_last"], torch.from_numpy(x[:, 0]).to(
        cfg.torch_dtype))


def test_rwkv_channel_mix_matches_reference(model):
    cfg, jcfg = model.cfg, model.jcfg
    p = model.params["stack"][0][0]["mlp"]
    jp = jax.tree.map(lambda a: a[0], model.jparams["stack"][0]["mlp"])
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    for cm_prev, jprev, xs in ((None, None, x),
                               (torch.from_numpy(prev).to(cfg.torch_dtype),
                                jnp.asarray(prev, jcfg.jdtype), x[:, :1])):
        y, last = blocks.mlp_apply(cfg, p, torch.from_numpy(xs).to(
            cfg.torch_dtype), "rwkv_cm", cm_prev=cm_prev)
        jy, jlast = jblocks.mlp_apply(jcfg, jp, jnp.asarray(xs, jcfg.jdtype),
                                      "rwkv_cm", cm_prev=jprev)
        assert_close(y, jy, model.dtype)
        assert_close(last, jlast, model.dtype)


def test_norm_matches_reference(model):
    cfg, jcfg = model.cfg, model.jcfg
    x = np.random.default_rng(9).normal(3.0, 2.0, (4, cfg.d_model)).astype(
        np.float32)
    p = {"scale": torch.linspace(0.5, 1.5, cfg.d_model).to(cfg.torch_dtype),
         "bias": torch.linspace(-1, 1, cfg.d_model).to(cfg.torch_dtype)}
    jp = {k: jnp.asarray(v.float().numpy(), jcfg.jdtype)
          for k, v in p.items()}
    for norm in ("layernorm", "rmsnorm"):
        c, jc = cfg.replace(norm=norm), jcfg.replace(norm=norm)
        got = blocks.apply_norm(c, p, torch.from_numpy(x).to(cfg.torch_dtype))
        want = jblocks.apply_norm(jc, jp, jnp.asarray(x, jcfg.jdtype))
        assert got.dtype == cfg.torch_dtype
        assert_close(got, want, model.dtype)


# ----------------------------------------------------------------- model ---
def test_forward_logits_match_reference(model):
    jt, tt = model.tokens((2, 9), seed=2)
    got = lm.forward(model.cfg, model.params, tt)
    want = jlm.forward(model.jcfg, model.jparams, jt)
    assert got.shape == (2, 9, model.cfg.padded_vocab)
    assert_close(got, want, model.dtype)


def test_prefill_logits_and_caches_match_reference(model):
    jt, tt = model.tokens((2, PROMPT))
    rwkv_ops.SPEC.reset_counts()
    logits, caches = lm.prefill(model.cfg, model.params, tt)
    assert rwkv_ops.SPEC.plain_calls == model.cfg.n_layers
    jlogits, jcaches = jlm.prefill(model.jcfg, model.jparams, jt)
    assert_close(logits, jlogits, model.dtype)
    for key, sub in (("mixer", "S"), ("mixer", "x_last"),
                     ("cm_x_last", None)):
        got = _stacked(caches, key, sub)
        want = _jstacked(jcaches, key, sub)
        assert got.dtype == getattr(torch, str(want.dtype)), (key, sub)
        assert_close(got, want, model.dtype)


def test_four_serve_steps_match_reference(model):
    jt, tt = model.tokens((2, PROMPT))
    _, caches = lm.prefill(model.cfg, model.params, tt)
    _, jcaches = jlm.prefill(model.jcfg, model.jparams, jt)
    feed = np.random.default_rng(4).integers(0, model.cfg.vocab_size, (4, 2))
    for i, tok in enumerate(feed):
        rwkv_ops.SPEC.reset_counts()
        logits, caches = lm.serve_step(
            model.cfg, model.params, caches,
            torch.from_numpy(tok[:, None].astype(np.int64)), PROMPT + i)
        assert rwkv_ops.SPEC.plain_calls == model.cfg.n_layers
        jlogits, jcaches = jlm.serve_step(
            model.jcfg, model.jparams, jcaches,
            jnp.asarray(tok[:, None].astype(np.int32)), PROMPT + i)
        assert logits.shape == (2, model.cfg.padded_vocab)
        assert_close(logits, jlogits, model.dtype)
    assert_close(_stacked(caches, "mixer", "S"),
                 _jstacked(jcaches, "mixer", "S"), model.dtype)
    assert_close(_stacked(caches, "cm_x_last"),
                 _jstacked(jcaches, "cm_x_last"), model.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_step_with_ffn_surrogate_matches_reference(dtype):
    """The paper's approx-ml region inside the LM: with
    ``ffn_surrogate_dim`` the decode step's MLP is the surrogate, and
    ``cm_x_last`` is carried unchanged."""
    m = Model(dtype, ffn_surrogate_dim=32)
    jt, tt = m.tokens((2, 12), seed=3)
    _, caches = lm.prefill(m.cfg, m.params, tt)
    _, jcaches = jlm.prefill(m.jcfg, m.jparams, jt)
    before = _stacked(caches, "cm_x_last")
    for i, tok in enumerate((5, 77)):
        t = np.full((2, 1), tok)
        logits, caches = lm.serve_step(m.cfg, m.params, caches,
                                       torch.from_numpy(t), 12 + i)
        jlogits, jcaches = jlm.serve_step(m.jcfg, m.jparams, jcaches,
                                          jnp.asarray(t, jnp.int32), 12 + i)
        assert_close(logits, jlogits, dtype)
    assert torch.equal(_stacked(caches, "cm_x_last"), before)


def test_serve_step_continues_prefill(model):
    """The cache handoff: serve_step on token T after prefill(prompt[:T])
    gives the last logits of prefill(prompt[:T + 1])."""
    _, tt = model.tokens((2, PROMPT))
    full, _ = lm.prefill(model.cfg, model.params, tt)
    _, caches = lm.prefill(model.cfg, model.params, tt[:, :-1])
    step, _ = lm.serve_step(model.cfg, model.params, caches, tt[:, -1:],
                            PROMPT - 1)
    assert_close(step, full, model.dtype)


def test_padded_vocab_is_masked():
    m = Model("float32", vocab_size=250)
    assert m.cfg.padded_vocab == 256
    jt, tt = m.tokens((1, 4))
    logits, caches = lm.prefill(m.cfg, m.params, tt)
    assert (logits[:, 250:] == -1e30).all()
    assert_close(logits, jlm.prefill(m.jcfg, m.jparams, jt)[0], "float32")
    step, _ = lm.serve_step(m.cfg, m.params, caches, tt[:, :1], 4)
    assert (step[:, 250:] == -1e30).all()


def test_greedy_tokens_equal_reference_f32():
    m = Model("float32")
    jt, tt = m.tokens((2, 16), seed=7)
    gen = 8
    res = serve_lm.generate(m.cfg, m.params, tt, gen)
    assert res["tokens"].shape == (2, gen)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    # the loop of examples/serve_lm.py, on the reference
    jlogits, jcaches = jlm.prefill(m.jcfg, m.jparams, jt, cache_len=16 + gen)
    tok = jnp.argmax(jlogits, -1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        jlogits, jcaches = jlm.serve_step(m.jcfg, m.jparams, jcaches, tok,
                                          16 + i)
        tok = jnp.argmax(jlogits, -1)[:, None]
        out.append(tok)
    want = np.asarray(jnp.concatenate(out, axis=1))
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    assert_close(res["logits"], jlogits, "float32")


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_caches(cfg, 1, 4)
