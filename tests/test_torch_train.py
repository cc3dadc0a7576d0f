"""Port parity: LM training (train_loss, compute_grads with microbatches,
AdamW, clipping, the schedule, int8 error-feedback compression and
train_step) against repro.models / repro.optim / repro.train on the CPU,
at the reference's reduced llama3.2-3b, qwen3-4b (qk_norm), qwen2-vl-7b
(mrope, ``position_ids``), rwkv6-1.6b (the WKV recurrence through its
op's plain backward) and deepseek-v2-lite-16b (MLA at q.k 24 over v 16
through attention's plain backward, and the MoE dispatch through
autograd of its gather and ``index_put_``), with the reference's weights
(``lm.params_from_jax``).  Also the registry's guard against kernels
without a backward, remat, and the ``train_lm`` example's twin.

Tolerances, each gradient's largest error over its largest magnitude:

- f32: 1e-4 for gradients (summation order through two layers, the
  fused loss's chunks and attention's plain backward), loss rtol 1e-5;
- bf16: the loss within 2e-2, as tests/test_torch_lm.py holds bf16;
  gradients within 5e-2 (``BF16_GRAD_TOL``).  The reference's own bf16
  gradients lie 2.3-2.7% of the largest magnitude from its f32 ones at
  these configs (a norm scale, k_norm, w1; measured on the CPU), and the
  port's lie 2.2-2.4% from the reference's bf16 ones, at the same leaves:
  XLA and PyTorch round some bf16 products one ulp apart, and sums over
  the tokens of a batch (a norm scale's gradient) gather them.  5e-2 is
  twice the reference's own bf16 spread.  rwkv6-1.6b in bf16 is held to
  ``RWKV6_BF16_GRAD_TOL``: the reference's own bf16 gradients lie 0.149
  of the largest magnitude from its f32 ones there (llama: 0.023),
  spread over the first layer's mixer and channel mix, and the port's
  lie 0.066 from the reference's bf16 ones (measured on the CPU); 0.15
  is the reference's own spread.  deepseek-v2-lite-16b in bf16 keeps
  ``BF16_GRAD_TOL``: its routes agree with the reference's on every
  token of both MoE layers (bf16 and f32), and its gradients lie 0.047
  of the largest magnitude from the reference's bf16 ones at 1, 2, 4 and
  8 torch threads alike, where the reference's own bf16 gradients lie
  0.28 from its f32 ones (measured on the CPU);
- three f32 train_steps: losses rtol 1e-5; every parameter within
  ``3 * 2 * lr`` and, without compression, at most 1e-3 of them more
  than 1e-6 apart (measured: 5 of 90,432, the largest 1.3e-5).  Adam's
  step of an element is lr times m/sqrt(v), about +-1 in the first steps
  (the sign of the gradient at the first), so a gradient element near
  zero whose sign follows a rounding can move up to 2 lr a step.  With
  ``ef_compress`` a rounding-level difference at a half-step boundary
  becomes a whole int8 step (1/127 of the leaf's largest magnitude), and
  the error feedback carries it on: the grad norm within 1/127 (measured
  2.4e-4) and no count bound on the parameters (39% of them move more
  than 1e-6, the largest 5.6e-4 after three steps).
- AdamW and clipping alone, on the same gradients and rate: bit for bit
  (AdamW) and rtol 1e-6 (the norm's sum order); the schedule exact in
  its warmup and within rtol 1e-6 after it (XLA's cos and PyTorch's
  round one ulp apart at some angles, which ``1 + cos`` near 0.19
  magnifies to a few ulps of the rate).
"""
import functools
import types

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import archs, base  # noqa: E402
from repro_torch.examples import train_lm as example  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import compression, trainer  # noqa: E402

B, S = 2, 24
BF16_GRAD_TOL = 5e-2
RWKV6_BF16_GRAD_TOL = 0.15


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack([_np(t) for t in layers])


def ref_layout(tree):
    """A port parameter (or gradient) tree in the reference's layout: each
    pattern slot's layers stacked on a leading axis, leaves as f32
    numpy."""
    out = {k: jax.tree.map(_np, tree[k]) for k in tree
           if k not in ("prefix", "stack")}
    out["prefix"] = [jax.tree.map(_np, lay) for lay in tree["prefix"]]
    out["stack"] = tuple(_stack(slot) for slot in tree["stack"])
    return out


def assert_trees_close(got, want, tol):
    """Every leaf of the port's ``got`` (its layout) against the
    reference's ``want``: the largest error within ``tol`` of the leaf's
    largest magnitude; returns the worst ratio."""
    flat_w, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, want))
    got = dict(jax.tree_util.tree_flatten_with_path(ref_layout(got))[0])
    assert set(got) == {p for p, _ in flat_w}
    worst = 0.0
    for path, w in flat_w:
        g = got[path]
        assert g.shape == w.shape, path
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (jax.tree_util.keystr(path), err)
        worst = max(worst, err)
    return worst


class Model:
    """A reduced config in both packages, the reference's weights, and a
    seeded batch (with mrope ``position_ids`` where the config needs
    them)."""

    def __init__(self, name, dtype):
        self.jcfg = jarchs.reduced(jbase.get_config(name)).replace(
            dtype=dtype)
        self.cfg = archs.reduced(base.get_config(name)).replace(dtype=dtype)
        self.jparams = jlm.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.tree = jax.tree.map(np.asarray, self.jparams)
        rng = np.random.default_rng(1)
        toks = rng.integers(0, self.cfg.vocab_size, (B, S + 1)).astype(
            np.int32)
        self.np_batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.rope == "mrope":
            pid = np.stack([np.arange(S)[None].repeat(B, 0) + d
                            for d in (0, 3, 5)]).astype(np.int32)
            self.np_batch["position_ids"] = pid

    def params(self):
        p = lm.params_from_jax(self.cfg, self.tree, device="cpu")
        for t in tree_leaves(p):
            t.requires_grad_(True)
        return p

    def jbatch(self):
        return {k: jnp.asarray(v) for k, v in self.np_batch.items()}

    def batch(self):
        return trainer.to_device(self.np_batch, "cpu")


@functools.lru_cache(maxsize=None)
def _model(name, dtype):
    return Model(name, dtype)


# the reference's microbatches take the fused loss only
GRAD_CASES = [("llama3.2-3b", dt, fused, mb) for dt in ("float32",
                                                         "bfloat16")
              for fused, mb in ((True, 1), (False, 1), (True, 2))] + [
    (name, dt, True, 1) for name in ("qwen3-4b", "qwen2-vl-7b",
                                     "rwkv6-1.6b", "deepseek-v2-lite-16b")
    for dt in ("float32", "bfloat16")]


def bf16_grad_tol(name):
    return RWKV6_BF16_GRAD_TOL if name == "rwkv6-1.6b" else BF16_GRAD_TOL


@pytest.mark.parametrize("name,dtype,fused,mb", GRAD_CASES)
def test_loss_and_every_grad_match_reference(name, dtype, fused, mb):
    m = _model(name, dtype)
    jcfg = m.jcfg
    if mb == 1:
        jloss, jgrads = jax.value_and_grad(
            lambda p: jlm.train_loss(jcfg, p, m.jbatch(), fused=fused))(
                m.jparams)
    else:
        jloss, jgrads = jtrainer.compute_grads(jcfg, m.jparams, m.jbatch(),
                                               microbatches=mb)
    params = m.params()
    if mb == 1:
        loss = lm.train_loss(m.cfg, params, m.batch(), fused=fused)
        leaves = tree_leaves(params)
        it = iter(torch.autograd.grad(loss, leaves))
        grads = adamw.tree_map(lambda p: next(it), params)
    else:
        loss, grads = trainer.compute_grads(m.cfg, params, m.batch(),
                                            microbatches=mb)
    assert loss.dtype == torch.float32
    f32 = dtype == "float32"
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=1e-5 if f32 else 2e-2)
    # a gradient takes its parameter's dtype (the model's, and f32 for
    # deepseek's router), f32 when summed over microbatches
    assert all(g.dtype == (torch.float32 if mb > 1 else p.dtype)
               for g, p in zip(tree_leaves(grads), tree_leaves(params)))
    assert_trees_close(grads, jgrads, 1e-4 if f32 else bf16_grad_tol(name))


@pytest.mark.parametrize("remat", [True, False])
def test_remat_changes_no_bit(remat):
    """Recomputing each layer in the backward gives the gradients of the
    plain backward bit for bit on the CPU; the remat path saves only the
    layer inputs."""
    m = _model("llama3.2-3b", "float32")
    cfg = m.cfg.replace(remat=remat)
    params = m.params()
    loss = lm.train_loss(cfg, params, m.batch())
    got = torch.autograd.grad(loss, tree_leaves(params))
    params = m.params()
    loss2 = lm.train_loss(m.cfg.replace(remat=not remat), params, m.batch())
    want = torch.autograd.grad(loss2, tree_leaves(params))
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_loss_refuses_encoder_inputs():
    """A decoder-only config ignores ``enc_embeds``, as the reference's
    ``hidden_states`` does (it encodes only under ``enc_dec``): llama's
    loss and gradients are the same with and without them, and the loss
    equals the reference's with them."""
    m = _model("llama3.2-3b", "float32")
    e = np.random.default_rng(3).standard_normal(
        (B, 4, m.cfg.d_model)).astype(np.float32)
    losses, grads = [], []
    for batch in (m.batch(), dict(m.batch(),
                                  enc_embeds=torch.from_numpy(e))):
        params = m.params()
        losses.append(lm.train_loss(m.cfg, params, batch))
        grads.append(torch.autograd.grad(losses[-1], tree_leaves(params)))
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    jloss = jlm.train_loss(m.jcfg, m.jparams,
                           dict(m.jbatch(), enc_embeds=jnp.asarray(e)))
    np.testing.assert_allclose(losses[1].item(), float(jloss), rtol=1e-5)


# ------------------------------------------------------------- optimizer ---
def _rand_tree(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": [(3,), (2, 4, 3)], "c": {"d": (11,)}}
    return jax.tree.map(
        lambda s: (rng.standard_normal(s) * 0.1).astype(dtype), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _to_t(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).to(dtype),
                        tree)


@pytest.mark.parametrize("policy", ["full", "lean"])
def test_adamw_update_matches_reference_bit_for_bit(policy):
    """Three updates on the same gradients: parameters and moments equal
    to the reference's (f32 params under ``full``, bf16 under ``lean``)."""
    pdt = np.float32 if policy == "full" else jnp.bfloat16
    tdt = torch.float32 if policy == "full" else torch.bfloat16
    params0 = _rand_tree(0, np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, pdt), params0)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), params0)
    jstate = jadamw.init_opt_state(jp, policy)
    tstate = adamw.init_opt_state(tp, policy)
    for i, step in enumerate((0, 150, 7000)):
        g = _rand_tree(10 + i, np.float32)
        lr = jadamw.warmup_cosine(jnp.asarray(step, jnp.int32))
        jp, jstate = jadamw.adamw_update(
            jp, jax.tree.map(lambda a: jnp.asarray(a, pdt), g), jstate, lr,
            policy=policy)
        adamw.adamw_update(tp, _to_t(g, tdt), tstate,
                           torch.from_numpy(np.asarray(lr)), policy=policy)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    keys = ("m", "v", "master") if policy == "full" else ("m", "v")
    for got, want in [(tp, jp)] + [(tstate[k], jstate[k]) for k in keys]:
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    g = jax.tree.map(lambda a: a * scale, _rand_tree(3, np.float32))
    jg, jnorm = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g))
    tg, tnorm = adamw.clip_by_global_norm(_to_t(g))
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=0)


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 50, 99, 100, 101, 2500, 5000, 9999, 10000, 20000):
        for kw in ({}, {"peak_lr": 1e-3, "warmup": 10, "total": 60}):
            want = _np(jadamw.warmup_cosine(jnp.asarray(step, jnp.int32),
                                            **kw))
            got = adamw.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                      **kw)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=0)
            if step < kw.get("warmup", 100):  # no cos: exact
                assert _np(got) == want


# ----------------------------------------------------------- compression ---
def test_ef_compress_and_wire_bytes_match_reference():
    g = _rand_tree(4, np.float32)
    jr = jcomp.init_residual(jax.tree.map(jnp.asarray, g))
    tr = compression.init_residual(_to_t(g))
    for i in range(3):
        g = _rand_tree(20 + i, np.float32)
        jg, jr = jcomp.ef_compress(jax.tree.map(jnp.asarray, g), jr)
        tg, tr = compression.ef_compress(_to_t(g), tr)
        for a, b in zip(tree_leaves(tg) + tree_leaves(tr),
                        jax.tree.leaves(jg) + jax.tree.leaves(jr)):
            np.testing.assert_array_equal(_np(a), _np(b))
    assert compression.wire_bytes(_to_t(g)) == jcomp.wire_bytes(
        jax.tree.map(jnp.asarray, g))
    assert compression.wire_bytes(_to_t(g), 2) == jcomp.wire_bytes(
        jax.tree.map(jnp.asarray, g), 2)


# ------------------------------------------------------------ train step ---
@pytest.mark.parametrize("variant", ["plain", "microbatches 2",
                                     "ef_compress"])
def test_three_train_steps_match_reference(variant):
    """Three steps past the warmup (``step`` 200) from the same weights
    and fresh optimizer state, one batch per step."""
    m = _model("llama3.2-3b", "float32")
    jcfg, cfg = m.jcfg, m.cfg
    mb = 2 if variant == "microbatches 2" else 1
    jstate = {"params": m.jparams,
              "opt": jadamw.init_opt_state(m.jparams, jcfg.opt_policy)}
    params = m.params()
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    jcomp_fn = tcomp_fn = None
    if variant == "ef_compress":
        box = {"j": jcomp.init_residual(m.jparams),
               "t": compression.init_residual(params)}

        def jcomp_fn(g):
            out, box["j"] = jcomp.ef_compress(g, box["j"])
            return out

        def tcomp_fn(g):
            out, box["t"] = compression.ef_compress(g, box["t"])
            return out
    rng = np.random.default_rng(5)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        nb = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        jstate, jm = jtrainer.train_step(
            jcfg, jstate, {k: jnp.asarray(v) for k, v in nb.items()},
            step=200 + i, microbatches=mb, grad_compress=jcomp_fn)
        state, tm = trainer.train_step(cfg, state, trainer.to_device(
            nb, "cpu"), step=200 + i, microbatches=mb,
            grad_compress=tcomp_fn)
        gn_tol = 1 / 127 if variant == "ef_compress" else 1e-5
        for k, tol in (("loss", 1e-5), ("grad_norm", gn_tol), ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=tol, err_msg=k)
    got = dict(jax.tree_util.tree_flatten_with_path(
        ref_layout(state["params"]))[0])
    diffs = np.concatenate([np.abs(got[path] - w).ravel() for path, w in
                            jax.tree_util.tree_flatten_with_path(
                                jax.tree.map(_np, jstate["params"]))[0]])
    assert diffs.max() <= 3 * 2 * 3e-4
    if variant != "ef_compress":
        assert (diffs > 1e-6).mean() <= 1e-3
    assert int(state["opt"]["step"]) == 3


def test_train_state_and_shardings():
    cfg = _model("llama3.2-3b", "bfloat16").cfg
    st = trainer.make_train_state(0, cfg, device="cpu")
    assert all(p.requires_grad and p.dtype == torch.bfloat16
               for p in tree_leaves(st["params"]))
    assert all(t.dtype == torch.float32 for k in ("m", "v", "master")
               for t in tree_leaves(st["opt"][k]))
    assert trainer.state_shardings(cfg, st) is None
    # on a mesh: the reference's rules by leaf name, the optimizer's
    # mirrors as their parameters, the step replicated
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    sh = trainer.state_shardings(cfg, st, mesh=mesh)
    assert sh["params"]["tok_embed"].placements == (Shard(1), Shard(0))
    assert sh["params"]["final_norm"]["scale"].placements == (
        Replicate(), Replicate())
    for k in ("m", "v", "master"):
        assert sh["opt"][k] == sh["params"]
    assert sh["opt"]["step"].placements == (Replicate(), Replicate())
    lean = trainer.make_train_state(0, cfg.replace(opt_policy="lean"),
                                    device="cpu")
    assert "master" not in lean["opt"]
    assert lean["opt"]["m"]["tok_embed"].dtype == torch.bfloat16


# ------------------------------------------------------- registry guard ---
@pytest.mark.parametrize("kernel", ["fused_mlp", "fused_mlp_int8",
                                    "stencil_gather", "flash_attention_int8"])
def test_kernel_without_backward_refuses_grad_on_the_card(kernel):
    """On CUDA a spec without a backward raises for an input that
    requires grad (before any launch: no card is needed to reach it);
    under no_grad, or on the CPU, it dispatches as before."""
    spec = registry.get_spec(kernel)
    assert spec.backward is None
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="Backward kernels"):
        registry.dispatch(spec, {}, (x,), torch.device("cuda"))
    calls = []
    toy = registry.KernelSpec(
        name="toy", params=(), kernel=spec.kernel,
        run_call=lambda p, a, c: calls.append("kernel") or a[0] * 2,
        ref_call=lambda p, a: calls.append("plain") or a[0] * 2,
        make_call=None, cache_key=None, candidates=None, fits=None,
        supports=lambda p: True)
    with torch.no_grad():
        registry.dispatch(toy, {}, (x,), torch.device("cuda"))
    out = registry.dispatch(toy, {}, (x,), torch.device("cpu"))
    out.sum().backward()  # the plain version differentiates
    assert calls == ["kernel", "plain"] and torch.equal(x.grad,
                                                        torch.full((3,), 2.))


def test_flash_attention_differentiates_through_its_backward():
    """The spec with a backward runs under the registry's autograd
    function: its output has a grad_fn on the CPU and the plain backward
    serves the gradient."""
    assert flash_ops.SPEC.backward is not None
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k = torch.randn(1, 4, 1, 8, requires_grad=True)
    v = torch.randn(1, 4, 1, 8, requires_grad=True)
    out = flash_ops.flash_attention_op(q, k, v)
    assert type(out.grad_fn).__name__ == "_DifferentiableBackward"
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    with torch.no_grad():
        assert flash_ops.flash_attention_op(q, k, v).grad_fn is None


def test_rwkv6_chunk_differentiates_through_its_backward():
    """The WKV recurrence's spec has a backward: both outputs carry a
    grad_fn on the CPU, the plain backward serves the gradient (no
    kernel launch), and an input without grad (s0, zeros in training)
    gets none."""
    from repro_torch.kernels.rwkv6_chunk import ops as rwkv_ops
    from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk_bwd
    assert rwkv_ops.SPEC.backward is not None
    assert rwkv_ops.SPEC.backward.kernel is rwkv6_chunk_bwd
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 5, 2, 8, generator=g, requires_grad=True)
               for _ in range(3))
    w = (torch.rand(1, 5, 2, 8, generator=g) * 0.5 + 0.4).requires_grad_()
    u = torch.randn(2, 8, generator=g, requires_grad=True)
    s0 = torch.zeros(1, 2, 8, 8)
    o, sT = rwkv_ops.rwkv6_chunk_op(r, k, v, w, u, s0)
    assert type(o.grad_fn).__name__ == "_DifferentiableBackward"
    assert sT.grad_fn is o.grad_fn
    o.sum().backward()
    assert all(t.grad is not None for t in (r, k, v, w, u))
    assert s0.grad is None and rwkv6_chunk_bwd.launches == 0
    with torch.no_grad():
        assert rwkv_ops.rwkv6_chunk_op(r, k, v, w, u, s0)[0].grad_fn is None


# ------------------------------------------------------ the example twin ---
def test_train_lm_simulated_failure_then_resume(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "10", "--batch", "2", "--seq",
            "32", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path),
            "--simulate-failure"]
    with pytest.raises(SystemExit) as exc:
        example.main(argv)
    assert exc.value.code == example.FAILURE_EXIT == 17
    assert "simulated failure after step 5" in capsys.readouterr().out
    res = example.train(example.parser().parse_args(argv), log=print)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 6" in out
    assert res["start"] == 6 and sorted(res["losses"]) == list(range(6, 10))
    assert all(np.isfinite(v) for v in res["losses"].values())
    # an uninterrupted run agrees bit for bit: the resume replays nothing
    full = example.train(example.parser().parse_args(
        argv[:-3] + ["--ckpt-dir", str(tmp_path / "full")]), log=print)
    assert full["losses"][9] == res["losses"][9]
    assert sorted(int(p.name[5:]) for p in tmp_path.glob("step_*")) == [8, 10]
