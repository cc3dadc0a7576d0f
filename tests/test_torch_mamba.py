"""Port parity: the Mamba mixer, its selective-scan op and learned
positions, against repro.models on the CPU (the reduced jamba as a whole
is held in tests/test_torch_jamba.py).

Both packages get the same seeded numpy inputs and the reference's
weights.  The scan goes through ``mamba_scan_op``, whose plain version
(the reference's chunked associative scan, its combines in
``lax.associative_scan``'s order) runs on the CPU; a sequential
emulation of the CUDA kernel's arithmetic (:func:`_kernel_order`) is
held to it.  A mixer test runs one Mamba layer of the reduced jamba
(d_model 64, d_inner 128, d_state 16, dt_rank 8), its weights from the
reference's ``mamba_init``.

Tolerances:

- the scan: ``ops.TOL`` (1e-5, 1e-5) with the relative part taken
  against the scale of its terms (``ops.term_scale``), the rounding of a
  sum whatever its order;
- a Mamba mixer: f32 elementwise 1e-5; bf16 within 2e-2 of the largest
  magnitude, plus 2e-2 (``BF16_TOL``, as tests/test_torch_mla.py holds
  bf16; the conv within one bf16 ulp, dt within a bf16 ulp of the sum it
  is the softplus of);
- a model: f32 1e-3 elementwise (``tests/test_models.py`` holds the
  reference's decode to its forward at 1e-3); bf16 ``LM_TOL_BF16``,
  chip_smoke.py's 0.1 of the largest magnitude (``assert_close``).
"""
import contextlib
import functools
import re
from pathlib import Path

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
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.kernels.mamba_scan.mamba_scan import (  # noqa: E402
    CHANNELS, LANES, MAX_STATE, STEPS, launch_shape, mamba_scan, smem_bytes)
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    _combine, associative_scan, mamba_scan_ref)
from repro_torch.models import blocks, lm  # noqa: E402
from test_torch_mla import (DTYPES, _j, _model, _normal, _np, _t,  # noqa: E402
                            _tree, assert_layout_matches,
                            assert_params_carried)

JAMBA = "jamba-v0.1-52b"
BF16_TOL = 2e-2     # one layer, as tests/test_torch_mla.py holds bf16
LM_TOL_BF16 = 0.1   # the whole model, chip_smoke.py's
PROMPT = 11


@contextlib.contextmanager
def ieee_f32():
    """The process-wide state the plain scan's f32 arithmetic needs, set
    inside the block and restored after it: f32 matrix products in IEEE
    f32 (its ``einsum`` over the states; at ``"medium"`` the CPU computes
    them from bf16 operands) and the f32 default dtype."""
    prec = torch.get_float32_matmul_precision()
    dtype = torch.get_default_dtype()
    torch.set_float32_matmul_precision("highest")
    torch.set_default_dtype(torch.float32)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.set_default_dtype(dtype)


@pytest.fixture(autouse=True)
def _ieee_f32():
    """Every test here runs in :func:`ieee_f32`, whatever an earlier test
    of the same worker left behind (the driver runs files one after
    another in a worker, ``--dist loadfile``)."""
    with ieee_f32():
        yield


def assert_close(got, want, dtype, tol=1e-3, bf16_tol=LM_TOL_BF16):
    """f32: elementwise ``tol``; bf16: the largest error within
    ``bf16_tol`` of the largest magnitude (plus ``bf16_tol``)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        err = np.abs(got - want).max()
        assert err <= bf16_tol * (1 + np.abs(want).max()), err


# ------------------------------------------------------------ the scan -----
def _scan_inputs(B, S, di, ds, dtype="float32", seed=0):
    """The op's inputs as numpy: dt = softplus(normal - 3), normal x, Bm,
    Cm, D; A = -(1 .. ds) per channel; a small state."""
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.standard_normal((B, S, di)) - 3.0, 0.0)
    x = rng.standard_normal((B, S, di))
    Bm, Cm = (rng.standard_normal((B, S, ds)) for _ in range(2))
    A = -np.broadcast_to(np.arange(1, ds + 1), (di, ds))
    D = rng.standard_normal(di)
    h0 = rng.standard_normal((B, di, ds)) * 0.1
    arrays = [a.astype(np.float32) for a in (dt, x, Bm, Cm, A, D, h0)]
    t = [torch.from_numpy(a.copy()) for a in arrays]
    t[:4] = [a.to(getattr(torch, dtype)) for a in t[:4]]
    return t


def _kernel_order(dt, x, Bm, Cm, A, D, h0):
    """A torch emulation of csrc/mamba_scan.cu's arithmetic, step by step:
    the decay ``exp2(dt * fl(A log2 e))`` (an exact exp2: the SFU's 2-ulp
    ``ex2.approx`` is not emulated), the state update ``fma(a, h,
    fl(fl(dt x) Bm))``; y's sum as the kernel takes it: in each of the
    ``LANES`` lanes of a channel, state slot j into chain j mod 2 by fused
    multiply-adds in ascending j, the chains added, the two lanes' sums
    added, then ``+ fl(D x)``.  Each fused operation in f64 rounded to f32
    (exact up to a double rounding), the states zero-padded to
    ``MAX_STATE``.  Returns (y, hT) in f32."""
    f32, f64 = torch.float32, torch.float64
    B, S, di = dt.shape
    ds = Bm.shape[2]
    spl = MAX_STATE // LANES

    def pad(t):
        return torch.nn.functional.pad(t.to(f32), (0, MAX_STATE - ds))

    def fma(a, b, c):
        return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)
    a2 = pad(A) * torch.tensor(1.4426950408889634, dtype=f32)
    h = pad(h0)
    Bp, Cp = pad(Bm), pad(Cm)
    dtf, xf = dt.to(f32), x.to(f32)
    y = torch.empty((B, S, di), dtype=f32)
    for t in range(S):
        a = torch.exp2((dtf[:, t, :, None] * a2).to(f64)).to(f32)
        b = (dtf[:, t] * xf[:, t])[..., None] * Bp[:, t, None, :]
        h = fma(a, h, b)
        total = None
        for g in range(LANES):
            acc = [torch.zeros((B, di), dtype=f32) for _ in range(2)]
            for j in range(spl):
                s = g * spl + j
                acc[j % 2] = fma(h[..., s], Cp[:, t, None, s], acc[j % 2])
            total = acc[0] + acc[1] if total is None \
                else total + (acc[0] + acc[1])
        y[:, t] = total + D.to(f32) * xf[:, t]
    return y, h[..., :ds]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,di,ds", [(1, 24, 16), (70, 200, 16),
                                     (70, 33, 5), (130, 8, 16)])
def test_kernel_order_matches_plain_scan(S, di, ds, dtype):
    """The kernel's order (a sequential chain per state, exp2 of a
    prescaled argument) against the plain version (the associative
    scan's tree), y and hT within ``ops.TOL`` of the scale of their
    terms; S 70 and 130 take a partial last chunk of 64 steps."""
    arrays = _scan_inputs(2, S, di, ds, dtype, seed=S + di + ds)
    worst = ops.held_to_plain(arrays, *_kernel_order(*arrays))
    assert max(worst["worst_vs_terms"].values()) <= 1.0, worst


def test_kernel_order_holds_after_reduced_precision_products():
    """What an earlier test can leave behind does not reach the order
    test: with f32 products set to bf16 operands
    (``set_float32_matmul_precision("medium")``, process-wide), the S 1
    case of :func:`test_kernel_order_matches_plain_scan` (the one that
    failed once under four workers) holds within its allowance inside
    :func:`ieee_f32`, and the setting is back on the way out; the same
    comparison outside the block reads past it wherever the CPU has bf16
    products (AVX512-BF16 or AMX), and as inside where it has none."""
    arrays = _scan_inputs(2, 1, 24, 16, "float32", seed=41)
    mine = _kernel_order(*arrays)
    torch.set_float32_matmul_precision("medium")
    loose = max(ops.held_to_plain(arrays, *mine)["worst_vs_terms"].values())
    with ieee_f32():
        pinned = max(ops.held_to_plain(arrays, *mine)[
            "worst_vs_terms"].values())
    assert torch.get_float32_matmul_precision() == "medium"
    assert pinned <= 1.0
    assert loose > 1.0 or loose == pinned


def test_held_to_plain_fails_a_scan_without_its_states():
    """The comparison the card's checks use: the plain version's own
    outputs read 0, and y of the D skip alone with a zero final state
    (a scan that drops its recurrence) reads far past the allowance."""
    arrays = _scan_inputs(2, 70, 24, 16, seed=5)
    y, h = mamba_scan_ref(*arrays)
    same = ops.held_to_plain(arrays, y, h)["worst_vs_terms"]
    assert max(same.values()) == 0.0
    x, D = arrays[1], arrays[5]
    lost = ops.held_to_plain(arrays, x.float() * D, torch.zeros_like(h))
    assert min(lost["worst_vs_terms"].values()) > 100.0, lost


def test_associative_scan_takes_jax_order_bit_for_bit():
    """The plain version's tree of combines is ``lax.associative_scan``'s:
    equal bit for bit at every length up to past one chunk."""
    def comb(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5, 8, 13, 64, 65):
        a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
        b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
        want = jax.lax.associative_scan(comb, (jnp.asarray(a),
                                               jnp.asarray(b)), axis=1)
        got = associative_scan(_combine, [torch.from_numpy(a),
                                          torch.from_numpy(b)], axis=1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_term_scale_bounds_the_outputs():
    arrays = _scan_inputs(1, 40, 16, 16, seed=3)
    y, h = mamba_scan_ref(*arrays)
    sy, sh = ops.term_scale(*arrays)
    assert bool((y.abs() <= sy * (1 + 1e-6)).all())
    assert bool((h.abs() <= sh * (1 + 1e-6)).all())


def test_zero_steps_return_the_initial_state():
    arrays = _scan_inputs(1, 0, 8, 4)
    y, h = mamba_scan_ref(*arrays)
    assert y.shape == (1, 0, 8)
    assert torch.equal(h, arrays[6]) and h.data_ptr() != arrays[6].data_ptr()


@pytest.mark.parametrize("bad", ["x", "Cm", "A", "D", "h0", "rank"])
def test_shapes_are_checked_on_every_path(bad):
    arrays = dict(zip(("dt", "x", "Bm", "Cm", "A", "D", "h0"),
                      _scan_inputs(1, 4, 8, 4)))
    if bad == "rank":
        arrays["dt"] = arrays["dt"][0]
    else:
        arrays[bad] = arrays[bad][..., :3]
    with pytest.raises(ValueError):
        mamba_scan_ref(**arrays)
    with pytest.raises(ValueError):
        ops.mamba_scan_op(**arrays)


def test_cpu_dispatch_takes_plain_version_and_counts():
    registry.reset_counts()
    arrays = _scan_inputs(2, 9, 16, 16)
    y, h = ops.mamba_scan_op(*arrays)
    want_y, want_h = mamba_scan_ref(*arrays)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert ops.SPEC.plain_calls == 1 and ops.SPEC.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan(*arrays)
    assert ops.SPEC.launches == 0


def test_plain_version_differentiates_on_the_cpu():
    """On the CPU the op differentiates through the registry's autograd
    function and the plain backward (``mamba_scan_bwd_ref``): the gradient
    of every input equal (1e-4 of the largest) to autograd of the
    forward kernel's sequential order."""
    arrays = _scan_inputs(1, 9, 6, 4, seed=4)
    w = torch.from_numpy(_normal(5, 1, 9, 6))
    grads = []
    for fn in (ops.mamba_scan_op, _kernel_order):
        args = [a.clone().requires_grad_(True) for a in arrays]
        y, h = fn(*args)
        (y * w).sum().add(h.sum()).backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        err = (got - want).abs().max() / want.abs().max()
        assert err <= 1e-4, err


def test_spec_declaration():
    assert ops.SPEC.params == () and ops.SPEC.tol == ops.TOL == (1e-5, 1e-5)
    problem = ops.SPEC.default_problems[0]
    assert ops.SPEC.cache_key(problem, "cuda") == \
        "b2-s70-di200-ds16|float32|cuda"
    assert ops.SPEC.candidates(problem) == [{}]
    assert registry.resolve_params_info(ops.SPEC, problem) == ({}, "default")
    for ds, ok in ((1, True), (5, True), (16, True), (17, False)):
        assert ops.SPEC.supports(dict(problem, ds=ds)) is ok, ds
    assert ops.SPEC.supports(dict(problem, dtype="bfloat16"))
    assert not ops.SPEC.supports(dict(problem, dtype="float16"))
    assert registry.get_spec("mamba_scan") is ops.SPEC
    arrays = ops.SPEC.make_call(dict(problem, dtype="bfloat16"),
                                torch.Generator().manual_seed(0),
                                torch.device("cpu"))
    assert [tuple(a.shape) for a in arrays] == [
        (2, 70, 200), (2, 70, 200), (2, 70, 16), (2, 70, 16), (200, 16),
        (200,), (2, 200, 16)]
    assert all(a.dtype == torch.bfloat16 for a in arrays[:4])
    assert float(arrays[0].min()) > 0 and float(arrays[4].max()) < 0


def test_autotune_registered_skips_the_scan(monkeypatch):
    import repro_torch.tune.kernel_tuner as kt
    from repro_torch.tune import autotune_registered
    swept = []
    monkeypatch.setattr(kt, "sweep",
                        lambda spec, problem, **kw: swept.append(spec.name))
    assert autotune_registered(["mamba_scan"]) == [] and swept == []


def test_launch_shape_and_shared_memory():
    """jamba's prefill: 64 blocks of 128 channels a batch row, 256 in
    all, two threads a channel; two staged chunks (dt and x in the
    input's type, Bm and Cm in f32) fit a block's shared memory in both
    dtypes."""
    shape = launch_shape(4, 8192)
    assert shape == {"threads": CHANNELS * LANES, "blocks": 256,
                     "grid": (64, 4), "steps_a_chunk": STEPS}
    assert LANES == 2 and shape["threads"] == 256
    assert launch_shape(2, 200)["grid"] == (2, 2)
    assert smem_bytes(torch.bfloat16) == 40_960
    assert smem_bytes(torch.float32) == 73_728 <= registry.SMEM_PER_BLOCK
    assert MAX_STATE == 16


SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "mamba_scan" / "csrc" / "mamba_scan.cu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ds,dt_max", [(8, None), (16, 200.0)],
                         ids=["ds8", "underflow"])
def test_kernel_order_at_padding_and_underflow(ds, dt_max, dtype):
    """The kernel's order against the plain version within ``ops.TOL`` of
    the terms' scale at ds 8 (the second lane of a channel holds only
    padding) and with dt uniform up to 200, where most decays underflow
    to 0 beside decays that do not."""
    arrays = _scan_inputs(2, 40, 20, ds, dtype, seed=40 + ds)
    if dt_max is not None:
        dt = np.random.default_rng(40).uniform(0.0, dt_max, (2, 40, 20))
        arrays[0] = torch.from_numpy(dt.astype(np.float32)).to(
            arrays[0].dtype)
        a = torch.exp2(arrays[0].to(torch.float32)[..., None]
                       * arrays[4].to(torch.float32) * 1.4426950408889634)
        assert 0.5 < float((a == 0).float().mean()) < 1.0
    worst = ops.held_to_plain(arrays, *_kernel_order(*arrays))
    assert max(worst["worst_vs_terms"].values()) <= 1.0, (ds, worst)


def test_source_constants_are_the_wrappers():
    """csrc/mamba_scan.cu's constants are the ones mamba_scan.py declares
    (the wrapper checks the built library's against them too)."""
    text = SOURCE.read_text()
    for name, value in (("MAX_STATE", MAX_STATE), ("CHANNELS", CHANNELS),
                        ("STEPS", STEPS), ("LANES", LANES)):
        assert re.search(rf"#define {name} {value}\b", text), name


# ---------------------------------------------------------- the mixer ------
class Mixer:
    """One Mamba layer of the reduced jamba in both packages: the configs,
    the reference's ``mamba_init`` weights (``jp``) and the same weights
    as the port's tensors (``p``), bit for bit."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.jcfg = jarchs.reduced(jbase.get_config(JAMBA)).replace(
            dtype=dtype)
        self.cfg = archs.reduced(base.get_config(JAMBA)).replace(dtype=dtype)
        self.jp = jblocks.mamba_init(jax.random.PRNGKey(0), self.jcfg)
        self.p = _tree(self.jp)


@functools.lru_cache(maxsize=None)
def _mixer(dtype):
    return Mixer(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_init_and_cache_take_the_reference_layout(dtype):
    m = _mixer(dtype)
    cfg = m.cfg
    gen = torch.Generator().manual_seed(0)
    mine = blocks.mamba_init(gen, cfg)
    want = jblocks.mamba_init(jax.random.PRNGKey(0), m.jcfg)
    assert set(mine) == set(want)
    for k, v in want.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert mine[k].dtype == getattr(torch, str(v.dtype)), k
    for k in ("conv_b", "b_dt", "D_skip"):
        np.testing.assert_array_equal(_np(mine[k]), _np(want[k]))
    # torch.log and XLA's log of 1 .. 16 differ by an f32 ulp at one value
    np.testing.assert_allclose(_np(mine["A_log"]), _np(want["A_log"]),
                               rtol=2 ** -23, atol=0)
    assert mine["A_log"].is_contiguous()
    cache = blocks.mamba_init_cache(cfg, 3, 99, cfg.torch_dtype, "cpu")
    jcache = jblocks.mamba_init_cache(m.jcfg, 3, 99, m.jcfg.jdtype)
    for k in ("conv", "h"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert cache[k].dtype == getattr(torch, str(jcache[k].dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_is_the_reference_shifted_sum(dtype):
    """Exact in f32; in bf16 within one ulp (XLA may keep f32 between the
    bf16 adds of its fused sum)."""
    m = _mixer(dtype)
    p, jp = m.p, m.jp
    di, dc = m.cfg.mamba_d_inner, m.cfg.mamba_d_conv
    xin, prev = _normal(1, 2, 9, di), _normal(2, 2, dc - 1, di)
    conv, window = blocks._mamba_conv(m.cfg, p, _t(xin, dtype),
                                      _t(prev, dtype))
    xp = jnp.concatenate([_j(prev, dtype), _j(xin, dtype)], axis=1)
    want = sum(xp[:, i:i + 9] * jp["conv_w"][i] for i in range(dc)) \
        + jp["conv_b"]
    np.testing.assert_array_equal(_np(window), _np(xp[:, 9:]))
    if dtype == "float32":
        np.testing.assert_array_equal(_np(conv), _np(want))
    else:
        np.testing.assert_allclose(_np(conv), _np(want), rtol=2 ** -8,
                                   atol=1e-30)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_inputs_match_reference(dtype):
    """dt, Bm, Cm from the same activation: softplus computed as
    ``jax.nn.softplus`` does, op by op in the model dtype (bf16 bit for
    bit on the same sum)."""
    m = _mixer(dtype)
    p, jp = m.p, m.jp
    xc = _normal(3, 2, 7, m.cfg.mamba_d_inner)
    got = blocks._mamba_ssm_inputs(m.cfg, p, _t(xc, dtype))
    want = jblocks._mamba_ssm_inputs(m.jcfg, jp, _j(xc, dtype))
    s = _normal(4, 3, 50) * 4 - 4
    sp = blocks._mamba_ssm_inputs(
        m.cfg, {"w_x": torch.eye(8 + 32, dtype=getattr(torch, dtype))[:8],
                "w_dt": torch.eye(8, dtype=getattr(torch, dtype)),
                "b_dt": torch.zeros(8, dtype=getattr(torch, dtype))},
        _t(s, dtype)[..., :8])[0]
    # bf16 bit for bit; f32 within two ulps (XLA's exp and log1p and
    # PyTorch's round an ulp apart at some arguments)
    np.testing.assert_allclose(_np(sp), _np(jax.nn.softplus(
        _j(s, dtype)[..., :8])), rtol=0 if dtype == "bfloat16" else 2.4e-7,
        atol=0)
    for g, w, bf16_rtol in zip(got, want, (2 ** -4, 2 ** -7, 2 ** -7)):
        assert g.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)
        else:
            # Bm, Cm: a bf16 product one ulp apart here and there; dt: a
            # ulp of the sum near -4.6 (2^-5) moves its softplus by 3%
            np.testing.assert_allclose(_np(g), _np(w), rtol=bf16_rtol,
                                       atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_seq_matches_reference_from_conv0_and_h0(dtype):
    """70 tokens (a partial second chunk) from a nonzero conv window and
    state: y, the next window and the state; the scan runs through the op
    (its plain version here)."""
    m = _mixer(dtype)
    p, jp = m.p, m.jp
    cfg = m.cfg
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    x = _normal(4, 2, 70, cfg.d_model)
    conv0, h0 = _normal(5, 2, dc - 1, di), _normal(6, 2, di, ds) * 0.1
    registry.reset_counts()
    y, c = blocks.mamba_seq(cfg, p, _t(x, dtype), conv0=_t(conv0, dtype),
                            h0=_t(h0))
    assert ops.SPEC.plain_calls == 1
    jy, jc = jblocks.mamba_seq(m.jcfg, jp, _j(x, dtype),
                               conv0=_j(conv0, dtype), h0=_j(h0))
    assert y.dtype == getattr(torch, dtype) and c["h"].dtype == torch.float32
    assert c["conv"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(c["conv"]), _np(jc["conv"]))
    for got, want in ((y, jy), (c["h"], jc["h"])):
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5)
        else:
            assert_close(got, want, dtype, bf16_tol=BF16_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_step_matches_reference(dtype):
    m = _mixer(dtype)
    p, jp = m.p, m.jp
    cfg = m.cfg
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    x = _normal(7, 3, 1, cfg.d_model)
    conv, h = _normal(8, 3, dc - 1, di), _normal(9, 3, di, ds) * 0.1
    registry.reset_counts()
    y, st = blocks.mamba_step(cfg, p, _t(x, dtype),
                              {"conv": _t(conv, dtype), "h": _t(h)}, 5)
    assert ops.SPEC.plain_calls == 0 and ops.SPEC.launches == 0
    jy, jst = jblocks.mamba_step(m.jcfg, jp, _j(x, dtype),
                                 {"conv": _j(conv, dtype), "h": _j(h)}, 5)
    np.testing.assert_array_equal(_np(st["conv"]), _np(jst["conv"]))
    assert st["h"].dtype == torch.float32
    for got, want in ((y, jy), (st["h"], jst["h"])):
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-6)
        else:
            assert_close(got, want, dtype, bf16_tol=BF16_TOL)


def test_mamba_step_rounds_dt_x_to_bf16_as_the_reference():
    """The reference's step rounds ``dt * xc`` to bf16 before its f32
    update (blocks.py:611), where the sequence form takes both in f32.
    Each package's step state, from a zero state, is ``fl(dt xc) Bm`` of
    its own ``dt``, ``xc`` and ``Bm`` bit for bit, and not the same with
    the product kept in f32."""
    m = _mixer("bfloat16")
    p, jp = m.p, m.jp
    cfg = m.cfg
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    x = _normal(10, 4, 1, cfg.d_model)
    conv = _normal(11, 4, dc - 1, di)
    h = np.zeros((4, di, ds), np.float32)
    _, st = blocks.mamba_step(cfg, p, _t(x, "bfloat16"),
                              {"conv": _t(conv, "bfloat16"), "h": _t(h)}, 0)
    _, jst = jblocks.mamba_step(m.jcfg, jp, _j(x, "bfloat16"),
                                {"conv": _j(conv, "bfloat16"), "h": _j(h)},
                                0)
    f32 = torch.float32
    # the port's own dt, xc, Bm
    xin = torch.chunk(_t(x, "bfloat16") @ p["w_in"], 2, dim=-1)[0]
    xp = torch.cat([_t(conv, "bfloat16"), xin], dim=1)
    xc = torch.nn.functional.silu((xp * p["conv_w"]).to(f32).sum(
        1, keepdim=True).to(torch.bfloat16) + p["conv_b"])
    dt, Bm, _ = blocks._mamba_ssm_inputs(cfg, p, xc)
    rounded = (dt[:, 0] * xc[:, 0]).to(f32)[..., None] * \
        Bm[:, 0, None, :].to(f32)
    wide = (dt[:, 0].to(f32) * xc[:, 0].to(f32))[..., None] * \
        Bm[:, 0, None, :].to(f32)
    assert torch.equal(st["h"], rounded)
    assert not torch.equal(st["h"], wide)
    # the reference's own
    jxin = jnp.split(_j(x, "bfloat16") @ jp["w_in"], 2, axis=-1)[0]
    jxp = jnp.concatenate([_j(conv, "bfloat16"), jxin], axis=1)
    jxc = jax.nn.silu((jxp * jp["conv_w"]).sum(axis=1, keepdims=True)
                      + jp["conv_b"])
    jdt, jBm, _ = jblocks._mamba_ssm_inputs(m.jcfg, jp, jxc)
    jround = (jdt[:, 0] * jxc[:, 0]).astype(jnp.float32)[..., None] * \
        jBm[:, 0, None, :].astype(jnp.float32)
    jwide = (jdt[:, 0].astype(jnp.float32) * jxc[:, 0].astype(jnp.float32)
             )[..., None] * jBm[:, 0, None, :].astype(jnp.float32)
    np.testing.assert_array_equal(_np(jst["h"]), _np(jround))
    assert not np.array_equal(_np(jst["h"]), _np(jwide))


# ----------------------------------------------------- learned positions ---
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_none_llama_takes_learned_positions(dtype):
    """A GQA decoder with ``rope="none"``: the reference's ``pos_embed``
    carried bit for bit, forward and prefill against the reference, and a
    serve_step past ``max_pos`` (128) taking the last row, as
    ``lax.dynamic_slice_in_dim`` clamps it."""
    m = _model("llama3.2-3b", dtype, rope="none")
    assert "pos_embed" in m.tree and "pos_embed" in m.params
    assert_params_carried(m)
    assert_layout_matches(m)
    jt, tt = m.tokens((2, PROMPT), seed=6)
    assert_close(lm.forward(m.cfg, m.params, tt),
                 jlm.forward(m.jcfg, m.jparams, jt), dtype)
    L = m.cfg.max_pos + 12
    logits, caches = lm.prefill(m.cfg, m.params, tt, cache_len=L)
    jlogits, jcaches = jlm.prefill(m.jcfg, m.jparams, jt, cache_len=L)
    assert_close(logits, jlogits, dtype)
    tok = np.array([[3], [5]])
    for pos in (PROMPT, m.cfg.max_pos + 2):
        logits, caches = lm.serve_step(m.cfg, m.params, caches,
                                       torch.from_numpy(tok), pos)
        jlogits, jcaches = jlm.serve_step(m.jcfg, m.jparams, jcaches,
                                          jnp.asarray(tok, jnp.int32), pos)
        assert_close(logits, jlogits, dtype)


def test_learned_positions_clamp_and_refuse_too_long_prompts():
    """A step past the table reads only its last row: the same logits
    with every other row zeroed, other logits with the last row zeroed;
    a prompt longer than the table raises, as the reference's slice
    does."""
    m = _model("llama3.2-3b", "float32", rope="none")
    _, tt = m.tokens((1, 5), seed=7)
    pos, table = m.cfg.max_pos + 40, m.params["pos_embed"]
    last_only, no_last = torch.zeros_like(table), table.clone()
    last_only[-1], no_last[-1] = table[-1], 0.0

    def step(tab):
        _, caches = lm.prefill(m.cfg, m.params, tt, cache_len=pos + 1)
        return lm.serve_step(m.cfg, dict(m.params, pos_embed=tab), caches,
                             tt[:, :1], pos)[0]
    want = step(table)
    assert torch.equal(step(last_only), want)
    assert not torch.equal(step(no_last), want)
    long = torch.zeros((1, m.cfg.max_pos + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="learned positions"):
        lm.forward(m.cfg, m.params, long)


def test_recurrent_only_models_take_no_learned_positions():
    cfg = archs.reduced(base.get_config("rwkv6-1.6b"))
    assert cfg.rope == "none"
    assert "pos_embed" not in lm.init_params(0, cfg, device="cpu")
