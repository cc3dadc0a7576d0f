"""Port parity: the RWKV6 WKV recurrence's plain version, op and registry
declaration against repro.kernels.rwkv6_chunk (the Pallas kernel in
interpret mode and the jnp oracle), on the CPU, at the reference's
tolerance (1e-5, 1e-5)."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_chunk import ops as jax_ops  # noqa: E402
from repro.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref as jax_ref  # noqa: E402
from repro.kernels.rwkv6_chunk.rwkv6_chunk import (  # noqa: E402
    rwkv6_chunk as jax_pallas)
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import ops  # noqa: E402
from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref  # noqa: E402
from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5


def _inputs(B, T, H, hd, seed=3):
    """The inputs of tests/test_kernels.py:88-103, as numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.7, 0.999, (B, T, H, hd)).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32) * 0.1
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T", [8, 33, 64])
@pytest.mark.parametrize("hd", [8, 16])
def test_plain_version_matches_pallas_interpret_and_oracle(T, hd):
    arrays = _inputs(2, T, 2, hd)
    jarrays = [jnp.asarray(a) for a in arrays]
    po, ps = jax_pallas(*jarrays, interpret=True)
    ro, rs = jax_ref(*jarrays)
    o, s = rwkv6_chunk_ref(*(torch.from_numpy(a) for a in arrays))
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    for want_o, want_s in ((po, ps), (ro, rs)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=RTOL,
                                   atol=ATOL)


def test_plain_version_bf16_inputs_match_oracle():
    """bf16 r, k, v, w: computed in f32, o returned in bf16, sT in f32."""
    arrays = _inputs(2, 17, 2, 16, seed=4)
    jarrays = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:4]] + \
        [jnp.asarray(a) for a in arrays[4:]]
    ro, rs = jax_ref(*jarrays)
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:4]] + \
        [torch.from_numpy(a) for a in arrays[4:]]
    o, s = rwkv6_chunk_ref(*targs)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=RTOL,
                               atol=ATOL)
    # o rounds once to bf16 from f32 values that agree to 1e-5
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ro.astype(jnp.float32)),
                               rtol=2 ** -7, atol=ATOL)


def test_zero_steps_return_the_initial_state():
    arrays = [torch.from_numpy(a) for a in _inputs(1, 0, 2, 8)]
    o, s = rwkv6_chunk_ref(*arrays)
    assert o.shape == (1, 0, 2, 8)
    assert torch.equal(s, arrays[5]) and s.data_ptr() != arrays[5].data_ptr()


def test_one_step_is_the_models_decode_update():
    """At T = 1 the op is blocks.py:502-504's one-token update."""
    r, k, v, w, u, s0 = _inputs(3, 1, 2, 16, seed=5)
    o, s = ops.rwkv6_chunk_op(*(torch.from_numpy(a) for a in
                                (r, k, v, w, u, s0)))
    rf, kf, vf, wf = (a[:, 0] for a in (r, k, v, w))
    want_o = np.einsum("bhi,bhij->bhj", rf, s0) + np.einsum(
        "bhi,bhi,bhj->bhj", rf, u * kf, vf)
    want_s = wf[..., None] * s0 + kf[..., None] * vf[..., None, :]
    np.testing.assert_allclose(o[:, 0].numpy(), want_o, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["k", "u", "s0", "rank"])
def test_shapes_are_checked_on_every_path(bad):
    arrays = dict(zip(("r", "k", "v", "w", "u", "s0"),
                      (torch.from_numpy(a) for a in _inputs(1, 4, 2, 8))))
    if bad == "rank":
        arrays["r"] = arrays["r"][0]
    else:
        arrays[bad] = arrays[bad][..., :4]
    with pytest.raises(ValueError):
        rwkv6_chunk_ref(**arrays)
    with pytest.raises(ValueError):
        ops.rwkv6_chunk_op(**arrays)


def test_cpu_dispatch_takes_plain_version_and_counts():
    registry.reset_counts()
    arrays = [torch.from_numpy(a) for a in _inputs(2, 5, 2, 8)]
    o, s = ops.rwkv6_chunk_op(*arrays)
    want_o, want_s = rwkv6_chunk_ref(*arrays)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    assert ops.SPEC.plain_calls == 1 and ops.SPEC.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_chunk(*arrays)
    assert ops.SPEC.launches == 0


def test_spec_matches_reference_declaration():
    jspec = jax_ops.SPEC
    assert ops.SPEC.params == () == jspec.params
    assert ops.SPEC.tol == jspec.tol == (1e-5, 1e-5)
    assert ops.SPEC.default_problems == jspec.default_problems
    problem = ops.SPEC.default_problems[0]
    assert ops.SPEC.cache_key(problem, "cuda") == \
        jspec.cache_key(problem, "cuda")
    assert ops.SPEC.candidates(problem) == [{}]
    assert registry.resolve_params_info(ops.SPEC, problem) == ({}, "default")
    for hd, ok in ((8, True), (16, True), (32, True), (64, True),
                   (12, False), (128, False)):
        assert ops.SPEC.supports(dict(problem, hd=hd)) is ok, hd
    assert ops.SPEC.supports(dict(problem, dtype="bfloat16"))
    assert not ops.SPEC.supports(dict(problem, dtype="float16"))
    assert registry.get_spec("rwkv6_chunk") is ops.SPEC


def test_make_call_draws_the_reference_inputs():
    problem = dict(ops.SPEC.default_problems[0])
    r, k, v, w, u, s0 = ops.SPEC.make_call(
        problem, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert r.shape == k.shape == v.shape == w.shape == (2, 64, 2, 16)
    assert u.shape == (2, 16) and s0.shape == (2, 2, 16, 16)
    assert 0.7 <= float(w.min()) and float(w.max()) < 0.999
    assert float(s0.abs().max()) < 1.0
    bf = ops.SPEC.make_call(dict(problem, dtype="bfloat16"),
                            torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    assert all(t.dtype == torch.bfloat16 for t in bf)


def test_autotune_registered_skips_paramless_kernels(monkeypatch):
    """The twin of tests/test_tune.py's: rwkv6_chunk has no tunables, so
    the deploy warm-up sweeps nothing for it."""
    import repro_torch.tune.kernel_tuner as kt
    from repro_torch.tune import autotune_registered
    swept = []
    monkeypatch.setattr(
        kt, "sweep",
        lambda spec, problem, **kw: swept.append(spec.name) or
        {"params": {}, "us": 1.0, "default_us": 1.0, "speedup_x": 1.0,
         "exact": True})
    assert autotune_registered(["rwkv6_chunk"]) == []
    assert swept == []
    autotune_registered(["stencil_gather"])
    assert swept == ["stencil_gather"]
