"""Port parity: the reduced jamba-v0.1-52b (Mamba and GQA layers, MoE on
every other layer, learned positions) against repro.lm on the CPU.

Both packages get the same seeded numpy inputs, and the models run the
reference's weights (``params_from_jax``).  The reduced jamba has 16
layers, two periods of its pattern (7 Mamba + 1 GQA layer a period, MoE
on alternate layers: 4 experts top-2, capacity 4), d_model 64, d_inner
128, d_state 16, dt_rank 8, 4 q / 2 kv heads of 16, no rope and a
128-position learned table.  Its scan runs through ``mamba_scan_op`` and
its attention through ``flash_attention_op``, their plain versions here.

Tolerances (``assert_close`` of tests/test_torch_mamba.py): f32 1e-3
elementwise; bf16 ``LM_TOL_BF16``, chip_smoke.py's 0.1 of the largest
magnitude.  Each layer, held from the reference's own input, lies within
2 bf16 ulps of the reference's output (0.5-2.1 on a residual stream of
150-292: the MoE experts' 1/sqrt(E) init makes it large), and 16 layers
of random weights amplify that, through the Mamba states, to 0.169 of
logits of 0.707 over 70 tokens (0.01 over 11); so the bf16 forward over
70 tokens is held layer by layer, from the reference's inputs, and
prefill and steps over 11 end to end.

The MoE layers route by ``top_k`` of f32 router probabilities made from
bf16 activations, which XLA and PyTorch round one ulp apart here and
there: a near-tied route then flips, and the flipped token's output,
and through the Mamba states every later token's, changes by its own
size.  So these comparisons run the port on the experts the reference
chose (recorded from its ``jax.lax.top_k``) and check that every expert
the port would have chosen otherwise is a near-tie: the two experts'
router probabilities within twice the largest probability drift between
the packages, plus ``TIE``.
"""
import contextlib
import copy
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import archs, base  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from test_torch_mamba import (JAMBA, PROMPT, assert_close)  # noqa: E402
from test_torch_mla import (DTYPES, _model, _np,  # noqa: E402
                            assert_layout_matches, assert_params_carried)
from test_torch_train import assert_trees_close  # noqa: E402

TIE = 1e-6   # router probabilities this close are a tie in f32


_ROUTES = []  # where the reference's recorded top_k calls land


@contextlib.contextmanager
def reference_routes():
    """The reference's ``top_k`` calls inside the block, recorded in order
    (a list of (probabilities, experts), filled when the block ends),
    whether its layers run under ``lax.scan`` or under a ``jit`` traced
    inside an earlier such block (its callback appends to ``_ROUTES``)."""
    calls, top_k = [], jax.lax.top_k
    del _ROUTES[:]

    def recording(probs, k):
        out = top_k(probs, k)
        jax.debug.callback(lambda p, i: _ROUTES.append((np.asarray(p),
                                                        np.asarray(i))),
                           probs, out[1], ordered=True)
        return out
    with mock.patch.object(jax.lax, "top_k", recording):
        yield calls
    jax.effects_barrier()
    calls.extend(_ROUTES)


@contextlib.contextmanager
def port_routes_from(calls):
    """The port's MoE layers route to the reference's recorded experts
    (``calls``, in order), their gates from the port's own probabilities;
    yields the list of (probabilities, own experts, reference
    probabilities, reference experts) that :func:`assert_near_ties`
    checks."""
    it, topk, seen = iter(calls), torch.topk, []

    def forced(probs, k, dim=-1):
        ref_p, ref_i = next(it)
        own = topk(probs, k, dim=dim)
        idx = torch.from_numpy(ref_i.astype(np.int64)).reshape(
            own.indices.shape)
        seen.append((probs.numpy(), own.indices.numpy(),
                     ref_p.reshape(probs.shape), idx.numpy()))
        return probs.gather(dim, idx), idx
    with mock.patch.object(torch, "topk", forced):
        yield seen
    assert next(it, None) is None and len(seen) == len(calls)


def assert_near_ties(seen):
    """Every token whose experts (as a set) the port would have chosen
    otherwise: each swapped pair's probabilities (the port's) within twice
    the layer's largest probability drift between the packages, plus
    ``TIE``."""
    for probs, own, ref_p, ref_i in seen:
        drift = np.abs(probs - ref_p).max()
        differ = (np.sort(own, -1) != np.sort(ref_i, -1)).any(-1)
        for tok in map(tuple, np.argwhere(differ)):
            mine, theirs = set(own[tok]), set(ref_i[tok])
            gap = max(abs(probs[tok][a] - probs[tok][b])
                      for a in mine - theirs for b in theirs - mine)
            assert gap <= 2 * drift + TIE, (tok, gap, drift)


def _run_both(port_fn, ref_fn):
    """``ref_fn()`` with its routes recorded, then ``port_fn()`` on them;
    the flips the port would have taken checked to be near-ties."""
    with reference_routes() as calls:
        want = ref_fn()
        jax.block_until_ready(want)
    with port_routes_from(calls) as seen:
        got = port_fn()
    assert_near_ties(seen)
    return got, want


def _jamba(dtype, cache="bfloat16"):
    """The reduced jamba in both packages (one set of weights a dtype),
    with a ``cache`` KV cache."""
    m = _model(JAMBA, dtype)
    if cache == m.cfg.kv_cache_dtype:
        return m
    other = copy.copy(m)
    other.cfg = m.cfg.replace(kv_cache_dtype=cache)
    other.jcfg = m.jcfg.replace(kv_cache_dtype=cache)
    return other


CACHE_KEYS = {"gqa": ("k", "v"), "mamba": ("conv", "h")}


def assert_caches_close(m, caches, jcaches):
    """Every pattern layer's cache (Mamba: conv and h; GQA: K/V, int8 with
    their scales) against the reference's, dtypes exactly."""
    for slot, spec in enumerate(m.cfg.pattern):
        keys = CACHE_KEYS[spec.mixer]
        jslot = jcaches["stack"][slot]["mixer"]
        for r, c in enumerate(caches["stack"][slot]):
            for key in keys:
                got, want = c["mixer"][key], jslot[key][r]
                assert got.dtype == getattr(torch, str(want.dtype)), key
                if key + "_scale" in jslot:  # int8: compared dequantized
                    scale = c["mixer"][key + "_scale"]
                    assert scale.dtype == torch.bfloat16
                    got = _np(got) * _np(scale)[..., None]
                    want = _np(want) * _np(jslot[key + "_scale"][r])[
                        ..., None]
                assert_close(got, want, m.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jamba_params_carry_every_leaf_and_init_matches(dtype):
    """Every reference leaf (the Mamba leaves, the stacked experts, the
    learned positions among them) lands in the port's per-layer dicts bit
    for bit; ``init_params`` builds the same layout, ``pos_embed``
    ``[max_pos, d]`` included."""
    m = _jamba(dtype)
    assert_params_carried(m)
    assert m.params["pos_embed"].shape == (m.cfg.max_pos, m.cfg.d_model)
    assert set(m.params["stack"][0][0]["mixer"]) == set(
        m.tree["stack"][0]["mixer"])
    assert_layout_matches(m)


def test_jamba_forward_matches_reference_f32():
    """70 tokens (a partial second chunk of the scan) through 16 layers:
    one scan per Mamba layer and one attention call per GQA layer, the
    logits within 1e-3."""
    m = _jamba("float32")
    jt, tt = m.tokens((2, 70), seed=1)
    registry.reset_counts()
    got, want = _run_both(lambda: lm.forward(m.cfg, m.params, tt),
                          lambda: jlm.forward(m.jcfg, m.jparams, jt))
    per_period = sum(s.mixer == "mamba" for s in m.cfg.pattern)
    assert ops.SPEC.plain_calls == per_period * m.cfg.pattern_repeats
    assert flash_ops.SPEC.plain_calls == m.cfg.pattern_repeats
    assert_close(got, want, "float32")


@contextlib.contextmanager
def reference_layers():
    """Every layer the reference's forward runs inside the block: its
    input and output (the residual stream), recorded in order."""
    seen, layer = [], jlm._apply_layer_seq

    def recording(cfg, p, spec, x, **kw):
        out = layer(cfg, p, spec, x, **kw)
        jax.debug.callback(lambda a, b: seen.append((np.asarray(a),
                                                     np.asarray(b))),
                           x, out[0], ordered=True)
        return out
    with mock.patch.object(jlm, "_apply_layer_seq", recording):
        yield seen
    jax.effects_barrier()


def test_jamba_bf16_layers_match_reference_from_its_inputs():
    """bf16, 70 tokens: every layer of the port run from the reference's
    own input to that layer (its MoE on the reference's experts) within
    ``LM_TOL_BF16`` of the reference's output, and the logits of the
    whole forward within it too over 11 tokens."""
    m = _jamba("bfloat16")
    jt, tt = m.tokens((2, 70), seed=1)
    with reference_routes() as calls, reference_layers() as layers:
        jax.block_until_ready(jlm.forward(m.jcfg, m.jparams, jt))
    assert len(layers) == m.cfg.n_layers
    positions = torch.arange(70)
    with port_routes_from(calls) as seen:
        for (slot, r, spec), (x, want) in zip(lm._layers(m.cfg), layers):
            got = lm._apply_layer_seq(
                m.cfg, lm._get(m.params, slot, r), spec,
                torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
                positions=positions, position_ids=None)[0]
            assert_close(got, want.astype(np.float32), "bfloat16")
    assert_near_ties(seen)
    jt, tt = m.tokens((2, PROMPT), seed=1)
    got, want = _run_both(lambda: lm.forward(m.cfg, m.params, tt),
                          lambda: jlm.forward(m.jcfg, m.jparams, jt))
    assert_close(got, want, "bfloat16")


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jamba_prefill_and_serve_steps_match_reference(dtype, cache):
    """prefill of 11 tokens into a cache of 14, then three serve_steps:
    logits and every layer's cache; the scan runs once per Mamba layer of
    the prefill and never in a step (the step is plain torch)."""
    m = _jamba(dtype, cache)
    jt, tt = m.tokens((2, PROMPT))
    n_mamba = sum(s.mixer == "mamba" for s in m.cfg.pattern) * \
        m.cfg.pattern_repeats
    registry.reset_counts()
    (logits, caches), (jlogits, jcaches) = _run_both(
        lambda: lm.prefill(m.cfg, m.params, tt, cache_len=PROMPT + 3),
        lambda: jlm.prefill(m.jcfg, m.jparams, jt, cache_len=PROMPT + 3))
    assert ops.SPEC.plain_calls == n_mamba
    assert logits.shape == (2, m.cfg.padded_vocab)
    assert_close(logits, jlogits, dtype)
    assert_caches_close(m, caches, jcaches)
    feed = np.random.default_rng(4).integers(0, m.cfg.vocab_size, (3, 2))
    # one trace of the reference's step for the three (a new function, so
    # that it is traced here, with its top_k recorded)
    jstep = jax.jit(lambda p, c, t, pos: jlm.serve_step(m.jcfg, p, c, t, pos))
    for i, tok in enumerate(feed):
        registry.reset_counts()
        (logits, caches), (jlogits, jcaches) = _run_both(
            lambda: lm.serve_step(m.cfg, m.params, caches,
                                  torch.from_numpy(tok[:, None]),
                                  PROMPT + i),
            lambda: jstep(m.jparams, jcaches,
                          jnp.asarray(tok[:, None], jnp.int32), PROMPT + i))
        assert ops.SPEC.plain_calls == 0
        assert flash_ops.SPEC.plain_calls == m.cfg.pattern_repeats
        assert_close(logits, jlogits, dtype)
    assert_caches_close(m, caches, jcaches)


def test_jamba_decode_matches_forward_f32():
    """After tests/test_models.py:52-73: prefill of half the sequence,
    then serve_step token by token, against one forward over the whole
    sequence, below 1e-3 in f32 (the reduced config drops no route)."""
    cfg = archs.reduced(base.get_config(JAMBA)).replace(dtype="float32")
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


def test_jamba_train_loss_and_every_grad_match_reference():
    """f32: the loss within rtol 1e-5 and every leaf's gradient within
    1e-4 of its largest magnitude of ``jax.value_and_grad`` (the scan's
    gradient through the registry's autograd function and the plain
    backward, ``mamba_scan_bwd_ref``)."""
    m = _jamba("float32")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, m.cfg.vocab_size, (2, 25)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(m.jcfg, p, jbatch)))(m.jparams)
    params = lm.params_from_jax(m.cfg, m.tree, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)),
             "targets": torch.from_numpy(toks[:, 1:].astype(np.int64))}
    loss = lm.train_loss(m.cfg, params, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    it = iter(torch.autograd.grad(loss, leaves))
    assert_trees_close(tree_map(lambda t: next(it), params), jgrads, 1e-4)


# ------------------------------------------------------------ the demo -----
def test_serve_demo_takes_reduced_jamba():
    """The demo twin at ``--arch jamba-v0.1-52b`` (what ``main`` serves
    with that flag): the reduced config, seeded weights and prompts,
    greedy tokens in the vocabulary."""
    from repro_torch.examples import serve_lm as example
    res = example.serve_demo(device="cpu", arch=JAMBA)
    vocab = archs.reduced(base.get_config(JAMBA)).vocab_size
    assert res["tokens"].shape == (example.BATCH, example.GEN)
    assert ((res["tokens"] >= 0) & (res["tokens"] < vocab)).all()
