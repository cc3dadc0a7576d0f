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
from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import (  # noqa: E402
    MAX_HEAD_DIM, launch_shape, rwkv6_chunk)

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
    for hd, ok in ((1, True), (8, True), (12, True), (64, True),
                   (128, True), (129, False)):
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


def _kernel_order(r, k, v, w, u, s0):
    """A torch emulation of csrc/rwkv6_chunk.cu's arithmetic: the head
    padded with zeros to its tile, each row group's partial of o a chain
    of fused multiply-adds over its rows in ascending i (emulated in f64,
    rounded to f32: exact up to a double rounding), the partials added in
    ascending group order in f32, and the state updated as the plain
    version updates it.  Returns (o, sT) in f32 at the head size."""
    B, T, H, hd = r.shape
    shape = launch_shape(hd)
    ht, groups, rows = (shape["head_tile"], shape["row_groups"],
                        shape["rows_per_group"])

    def pad(t, dims):
        return torch.nn.functional.pad(t.float(), [0, ht - hd] * dims)
    rf, kf, vf, wf = (pad(t, 1) for t in (r, k, v, w))
    uf = pad(u, 1)[None, :, :, None]
    S = pad(s0, 2)
    o = torch.empty((B, T, H, ht))
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # [B, H, i, j]
        term = (uf.double() * kv.double() + S.double()).float()
        term = term.view(B, H, groups, rows, ht)
        rg = rf[:, t].view(B, H, groups, rows)
        p = torch.zeros((B, H, groups, ht))
        for q in range(rows):
            p = (rg[..., q, None].double() * term[:, :, :, q].double()
                 + p.double()).float()
        acc = p[:, :, 0]
        for g in range(1, groups):
            acc = acc + p[:, :, g]
        o[:, t] = acc
        S = wf[:, t, :, :, None] * S + kv
    return o[..., :hd], S[:, :, :hd, :hd]


def _term_scale(r, k, v, w, u, s0):
    """``sum_i |r_i| |S_ij + u_i k_i v_j|`` per output, in f64: the scale
    of a dot product's rounding error, whatever its order."""
    rf, kf, vf, wf = (a.astype(np.float64) for a in (r, k, v, w))
    S = s0.astype(np.float64)
    out = np.empty_like(rf)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        out[:, t] = np.einsum("bhi,bhij->bhj", np.abs(rf[:, t]),
                              np.abs(S + u[None, :, :, None] * kv))
        S = wf[:, t, :, :, None] * S + kv
    return out


@pytest.mark.parametrize("T", [1, 33, 100])
@pytest.mark.parametrize("hd", [12, 24, 64, 96, 128])
def test_kernel_order_matches_oracle_and_state_bit_for_bit(hd, T):
    """The kernel's o order (row-group partials, then groups in ascending
    order) and its padded head tile, against the jnp oracle and the
    Pallas kernel in interpret mode; its state equals the plain version's
    bit for bit."""
    arrays = _inputs(1, T, 2, hd, seed=hd + T)
    targs = [torch.from_numpy(a) for a in arrays]
    o, s = _kernel_order(*targs)
    want_o, want_s = rwkv6_chunk_ref(*targs)
    assert torch.equal(s, want_s)
    jarrays = [jnp.asarray(a) for a in arrays]
    scale = _term_scale(*arrays)
    for jo, js in (jax_ref(*jarrays), jax_pallas(*jarrays, interpret=True)):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL,
                                   atol=ATOL)
        err = np.abs(o.numpy() - np.asarray(jo))
        assert (err <= ATOL + RTOL * scale).all(), err.max()
    # the emulation and the plain version differ by rounding only
    err = (o - want_o).abs().numpy()
    assert (err <= ATOL + RTOL * scale).all(), err.max()


@pytest.mark.parametrize("hd,tile,groups,threads,chunk", [
    (1, 32, 4, 128, 32), (12, 32, 4, 128, 32), (32, 32, 4, 128, 32),
    (33, 64, 8, 512, 32), (64, 64, 8, 512, 32), (96, 128, 4, 512, 16),
    (128, 128, 4, 512, 16)])
def test_launch_shape_per_head_tile(hd, tile, groups, threads, chunk):
    """Head sizes 1 to MAX_HEAD_DIM: the tile each takes, its row groups
    (rows a group: a multiple of 4, the kernel's vector reads) and
    threads; above the limit the wrapper raises and names it."""
    shape = launch_shape(hd)
    assert (shape["head_tile"], shape["row_groups"], shape["threads"],
            shape["chunk"]) == (tile, groups, threads, chunk)
    assert shape["rows_per_group"] * groups == tile
    assert shape["rows_per_group"] % 4 == 0
    assert MAX_HEAD_DIM == 128
    with pytest.raises(ValueError, match="128"):
        launch_shape(MAX_HEAD_DIM + 1)
