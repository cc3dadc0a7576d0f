"""Port parity: the MoE MLP (deepseek-v2-lite's and grok-1's) against
repro.models on the CPU.

Both packages get the same seeded numpy inputs and the reference's
weights.  The routing is compared first, exactly: the reference's
``top_k`` experts (recorded from its ``jax.lax.top_k`` call) against
the port's, and the kept routes and their rows against a numpy model of
the capacity rule (on the port's experts; which routes are kept, on the
reference's too).  An expert that
differs must be a near-tie: its router probability within 1e-6 of the
other's (both packages form the f32 router from the same inputs; their
f32 sums differ by a few ulps).  Outputs are then compared at
tests/test_torch_mla.py's tolerances (f32 elementwise 1e-4; bf16 within
2e-2 of the largest magnitude), over the tokens whose routes agree.

The reduced grok-1 has 3 layers of GQA + MoE (4 experts top-2, gelu, no
shared experts), d_model 64.
"""
import types

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
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from test_torch_mla import (DTYPES, PROMPT, _j, _model, _normal, _t,  # noqa: E402
                            _tree, assert_close, assert_handoff,
                            assert_layout_matches, assert_params_carried,
                            run_prefill_and_steps)

GROK = "grok-1-314b"
DEEPSEEK = "deepseek-v2-lite-16b"
TIE = 1e-6   # router probabilities this close are a tie in f32


def _cfgs(name, dtype, **kw):
    kw = dict(kw, dtype=dtype)
    return (archs.reduced(base.get_config(name)).replace(**kw),
            jarchs.reduced(jbase.get_config(name)).replace(**kw))


def kept_rows(experts, E, C):
    """The capacity rule in numpy: each route of ``experts`` ``[G, N]``
    (token-major) takes the next row of its expert; (keep, row) with the
    row ``C`` for a dropped route."""
    keep = np.zeros(experts.shape, bool)
    rows = np.zeros(experts.shape, np.int64)
    for g in range(experts.shape[0]):
        seen = np.zeros(E, np.int64)
        for j, e in enumerate(experts[g]):
            keep[g, j], rows[g, j] = seen[e] < C, min(seen[e], C)
            seen[e] += 1
    return keep, rows


def reference_moe(jcfg, jp, x, monkeypatch):
    """The reference's ``moe_apply`` on ``x``, and the experts its
    ``top_k`` chose ``[G, Tg, k]``."""
    seen = []
    top_k = jax.lax.top_k

    def recording(probs, k):
        out = top_k(probs, k)
        seen.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(jax.lax, "top_k", recording)
    y, _ = jblocks.moe_apply(jcfg, jp, x)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(seen) == 1
    return y, seen[0]


def assert_routes_match(cfg, p, xg, want_idx):
    """The port's routing of ``xg`` ``[G, Tg, d]`` against the
    reference's experts: equal, or a near-tie in the f32 router
    probabilities; kept routes and rows exactly as the capacity rule on
    the port's own experts gives them.  Returns the tokens ``[G, Tg]``
    that compare, and the count of routes dropped."""
    gates, experts, rows, keep, C = blocks.moe_route(cfg, p, xg)
    G, Tg, k = want_idx.shape
    got_idx = experts.reshape(G, Tg, k).numpy()
    probs = torch.softmax(xg.float() @ p["w_router"], dim=-1).numpy()
    for g, t, s in zip(*np.nonzero(got_idx != want_idx)):
        a, b = got_idx[g, t, s], want_idx[g, t, s]
        assert abs(probs[g, t, a] - probs[g, t, b]) <= TIE, (g, t, s)
    want_keep, want_rows = kept_rows(experts.numpy(), cfg.n_experts, C)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    assert gates.dtype == torch.float32
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    # a token compares where its experts agree and so does whether each
    # of its routes is kept (a flip moves later routes' rows)
    ref_keep, _ = kept_rows(want_idx.reshape(G, Tg * k), cfg.n_experts, C)
    same = (got_idx == want_idx) & (keep.numpy() == ref_keep).reshape(
        G, Tg, k)
    return same.all(-1), int((~keep).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", [0, 2])
def test_moe_init_takes_the_reference_layout_router_f32(shared, dtype):
    cfg, jcfg = _cfgs(DEEPSEEK, dtype, n_shared_experts=shared)
    jp = jblocks.mlp_init(jax.random.PRNGKey(4), jcfg, "moe")
    mine = blocks.mlp_init(torch.Generator().manual_seed(0), cfg, "moe")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in mine.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    assert mine["w_router"].dtype == torch.float32
    assert ("ws1" in mine) == bool(shared)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity", [0.5, 4.0])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shared", [0, 2])
def test_moe_apply_matches_reference(shared, act, capacity, dtype,
                                     monkeypatch):
    """18 tokens, 4 experts top-2, with and without shared experts, silu
    and gelu, a capacity of 0.5 (C = 5 of 36 routes: some must drop) and
    4.0 (C = 36: none may): the routing first, then the output."""
    cfg, jcfg = _cfgs(DEEPSEEK, dtype, n_shared_experts=shared, act=act,
                      capacity_factor=capacity)
    jp = jblocks.mlp_init(jax.random.PRNGKey(5), jcfg, "moe")
    p = _tree(jp)
    x = _normal(6, 2, 9, cfg.d_model) * 2
    jy, want_idx = reference_moe(jcfg, jp, _j(x, jcfg.jdtype), monkeypatch)
    xt = _t(x, dtype)
    agree, dropped = assert_routes_match(cfg, p, xt.reshape(1, 18, -1),
                                         want_idx)
    assert (dropped > 0) == (capacity < 1)
    y, aux = blocks.mlp_apply(cfg, p, xt, "moe")
    assert aux is None and y.dtype == xt.dtype and y.shape == xt.shape
    mask = agree.reshape(2, 9)
    assert mask.sum() >= 16
    assert_close(y[torch.from_numpy(mask)], np.asarray(
        jnp.asarray(jy, jnp.float32))[mask], dtype)


def test_capacity_at_deepseek_sizes_drops_at_decode():
    """``C = max(1, ceil(capacity_factor * k * Tg / E))`` at
    deepseek-v2-lite's 64 experts top-6 and capacity 1.25: one decode
    step of 4 sequences gets C = 1 for 24 routes and drops a route for
    every second pick of an expert; a prefill of 4 x 2,048 tokens gets C
    = 960.  ``_moe_groups`` is 1 without a mesh, the batch shards under
    one."""
    cfg = base.get_config(DEEPSEEK).replace(d_model=8)
    assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor) == (64, 6, 1.25)
    g = torch.Generator().manual_seed(0)
    p = {"w_router": torch.randn(8, 64, generator=g)}
    _, experts, rows, keep, C = blocks.moe_route(
        cfg, p, torch.randn(1, 4, 8, generator=g))
    assert C == 1 and experts.shape == (1, 24)
    want_keep, want_rows = kept_rows(experts.numpy(), 64, 1)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    assert int((~keep).sum()) == 24 - len(np.unique(experts.numpy()))
    assert blocks.moe_route(cfg, p, torch.randn(1, 8192, 8,
                                                generator=g))[4] == 960
    assert blocks._moe_groups(8192) == 1
    # under a mesh: groups aligned to its batch shards, as the reference
    from repro.dist import sharding as jsharding
    from repro_torch.dist.sharding import use_mesh
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    with jsharding.use_mesh(mesh):
        want = jblocks._moe_groups(8192)
    with use_mesh(mesh):
        assert blocks._moe_groups(8192) == want == 4


def test_moe_drops_match_the_reference_at_capacity_one(monkeypatch):
    """A step-sized call (4 tokens, 4 experts top-2, capacity 0.5: C =
    1) drops the same routes as the reference, and gives its output."""
    cfg, jcfg = _cfgs(DEEPSEEK, "float32", capacity_factor=0.5)
    jp = jblocks.mlp_init(jax.random.PRNGKey(7), jcfg, "moe")
    x = _normal(8, 4, 1, cfg.d_model)
    jy, want_idx = reference_moe(jcfg, jp, _j(x), monkeypatch)
    p = _tree(jp)
    agree, dropped = assert_routes_match(cfg, p, _t(x).reshape(1, 4, -1),
                                         want_idx)
    assert agree.all() and dropped > 0
    assert_close(blocks.moe_apply(cfg, p, _t(x))[0], jy, "float32")


# ------------------------------------------------------------- grok-1 ------
@pytest.mark.parametrize("dtype", DTYPES)
def test_grok_params_carry_every_leaf_and_init_matches(dtype):
    m = _model(GROK, dtype)
    assert_params_carried(m)
    assert all(lp["mlp"]["w_router"].dtype == torch.float32
               for lp in m.params["stack"][0])
    assert_layout_matches(m)


@pytest.mark.parametrize("capacity", [None, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grok_forward_matches_reference(dtype, capacity):
    """The whole reduced model, at its config's capacity (4.0: no drops)
    and at 1.0 (22 tokens, C = 11 of 44 routes over 4 experts)."""
    kw = {} if capacity is None else {"capacity_factor": capacity}
    m = _model(GROK, dtype, **kw)
    jt, tt = m.tokens((2, PROMPT), seed=2)
    registry.reset_counts()
    got = lm.forward(m.cfg, m.params, tt)
    assert ops.SPEC.plain_calls == m.cfg.n_layers
    assert_close(got, jlm.forward(m.jcfg, m.jparams, jt), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grok_prefill_and_serve_steps_match_reference(dtype):
    """prefill of 11 tokens, then three serve_steps, K/V caches and
    logits; GQA attention runs through the plain version once per layer
    of every call."""
    run_prefill_and_steps(_model(GROK, dtype), ("k", "v"),
                          plain_per_step=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grok_handoff_matches_the_prefill(dtype):
    assert_handoff(_model(GROK, dtype))


def test_grok_greedy_tokens_equal_reference_f32():
    """``generate``'s greedy loop against the reference's prefill and
    serve_step loop: the same tokens."""
    from repro_torch.launch.serve_lm import generate
    m = _model(GROK, "float32")
    jt, tt = m.tokens((2, PROMPT), seed=3)
    res = generate(m.cfg, m.params, tt, 4)
    logits, caches = jlm.prefill(m.jcfg, m.jparams, jt, cache_len=PROMPT + 4)
    tok = jnp.argmax(logits, -1)[:, None]
    out = [tok]
    for i in range(3):
        logits, caches = jlm.serve_step(m.jcfg, m.jparams, caches, tok,
                                        PROMPT + i)
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))


@pytest.mark.parametrize("arch", [GROK, DEEPSEEK])
def test_serve_demo_takes_a_reduced_arch(arch):
    """The demo twin with ``--arch``: the reduced config, seeded weights
    and prompts, greedy tokens in the vocabulary, the same on a rerun."""
    from repro_torch.examples import serve_lm as example
    res = example.serve_demo(device="cpu", arch=arch)
    vocab = archs.reduced(base.get_config(arch)).vocab_size
    assert res["tokens"].shape == (example.BATCH, example.GEN)
    assert ((res["tokens"] >= 0) & (res["tokens"] < vocab)).all()
    again = example.serve_demo(device="cpu", arch=arch)
    assert torch.equal(res["tokens"], again["tokens"])
    assert example.main(["--device", "cpu", "--arch", arch]) == 0
