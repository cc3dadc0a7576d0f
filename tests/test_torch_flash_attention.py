"""Port parity: flash attention's plain versions (f32 and the int8 KV
path), ``quantize_kv``, the ops and the registry declarations against
repro.kernels.flash_attention (the jnp oracles and the Pallas kernels in
interpret mode) and repro.quant.quantize, on the CPU."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import int8 as jax_int8  # noqa: E402
from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as jax_pallas)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_ref)
from repro.quant import quantize as jq  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import int8, ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention, fits, smem_bytes, softmax_scale)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.quant.quantize import quantize_kv  # noqa: E402

# (rtol, atol) of the f32 path: the spec's, both sides f32 on the CPU
TOL = ops.TOL


def _qkv(b, sq, skv, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("shape", [
    (1, 16, 16, 2, 2, 8),      # MHA
    (2, 24, 40, 4, 2, 16),     # GQA group 2, ragged blocks
    (1, 32, 48, 6, 2, 8),      # GQA group 3
    (1, 8, 64, 8, 1, 16),      # group 8 (MQA)
])
@pytest.mark.parametrize("causal,q_offset,kv_valid_len", [
    (True, 0, None), (False, 0, None), (True, 8, None), (True, 0, 5),
    (False, 0, 9)])
def test_plain_version_matches_jax_oracle_and_pallas_interpret(
        shape, causal, q_offset, kv_valid_len):
    b, sq, skv, h, kv, hd = shape
    q, k, v = _qkv(*shape)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
    oracle = np.asarray(jax_ref(*_j(q, k, v), **kw))
    pallas = np.asarray(jax_pallas(*_j(q, k, v), block_q=8, block_k=8,
                                   interpret=True, **kw))
    plain = flash_attention_ref(*_t(q, k, v), **kw)
    op = ops.flash_attention_op(*_t(q, k, v), **kw)
    rtol, atol = TOL
    np.testing.assert_allclose(plain.numpy(), oracle, rtol=rtol, atol=atol)
    np.testing.assert_allclose(plain.numpy(), pallas, rtol=rtol, atol=atol)
    assert torch.equal(op, plain)


@pytest.mark.parametrize("causal", [True, False])
def test_no_visible_key_is_the_mean_of_v(causal):
    """kv_valid_len=0: every score is -1e30, so the oracle's softmax is
    uniform over the Skv keys and a row is the mean of its kv head's V.
    The Pallas kernel would also average its zero padding when Skv is
    not a whole number of blocks; the port follows the oracle."""
    b, sq, skv, h, kv, hd = 2, 12, 21, 4, 2, 8
    q, k, v = _qkv(b, sq, skv, h, kv, hd, seed=5)
    oracle = np.asarray(jax_ref(*_j(q, k, v), causal=causal,
                                kv_valid_len=0))
    plain = flash_attention_ref(*_t(q, k, v), causal=causal,
                                kv_valid_len=0).numpy()
    mean_v = np.repeat(v.mean(axis=1), h // kv, axis=1)   # [B, H, hd]
    want = np.broadcast_to(mean_v[:, None], plain.shape)
    np.testing.assert_allclose(plain, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(plain, oracle, rtol=1e-6, atol=1e-6)


def test_bf16_inputs_compute_in_f32():
    q, k, v = _qkv(1, 16, 24, 4, 2, 16, seed=2)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    jq_, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    plain = flash_attention_ref(tq, tk, tv)
    assert plain.dtype == torch.bfloat16
    oracle = np.asarray(jax_ref(jq_, jk, jv).astype(jnp.float32))
    # one bf16 rounding of f32 values that agree to f32 tolerance: at
    # most one bf16 ulp apart (2**-7 relative)
    np.testing.assert_allclose(plain.to(torch.float32).numpy(), oracle,
                               rtol=2 ** -7, atol=TOL[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_kv_bit_equal_to_reference(seed):
    _, k, v = _qkv(2, 1, 33, 3, 3, 16, seed=seed)
    k[0, 3] = 0.0           # a zero token: scale 1/127
    v[1, :, 2, 5] = 0.0     # a zero channel
    want = [np.asarray(a) for a in jq.quantize_kv(*_j(k, v))]
    got = [a.numpy() for a in quantize_kv(*_t(k, v))]
    assert [a.dtype for a in got] == [np.int8, np.float32, np.int8,
                                      np.float32]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[1][0, 3, 0, 0] == np.float32(1.0) / np.float32(127.0)


@pytest.mark.parametrize("shape,causal,q_offset", [
    ((1, 16, 16, 2, 2, 8), True, 0),
    ((2, 24, 40, 4, 2, 16), False, 0),
    ((4, 8, 64, 6, 2, 16), True, 56),     # a decode window, GQA group 3
])
def test_int8_plain_version_matches_jax_oracle_and_pallas_interpret(
        shape, causal, q_offset):
    q, k, v = _qkv(*shape, seed=3)
    jarr = (jnp.asarray(q),) + tuple(jq.quantize_kv(*_j(k, v)))
    tarr = (torch.from_numpy(q),) + tuple(quantize_kv(*_t(k, v)))
    kw = dict(causal=causal, q_offset=q_offset)
    oracle = np.asarray(jax_int8.flash_attention_int8_ref(*jarr, **kw))
    pallas = np.asarray(jax_int8.flash_attention_int8(
        *jarr, block_q=8, block_k=8, interpret=True, **kw))
    plain = int8.flash_attention_int8_ref(*tarr, **kw).numpy()
    op = int8.flash_attention_int8_op(*tarr, **kw).numpy()
    np.testing.assert_array_equal(op, plain)
    rtol, atol = int8.TOL
    np.testing.assert_allclose(plain, oracle, rtol=rtol, atol=atol)
    np.testing.assert_allclose(plain, pallas, rtol=rtol, atol=atol)
    # the quantization and the exact integer scores are the same in both
    # packages: what differs is the softmax's summation order, far below
    # one int8 step (no element is off by 1e-5)
    differing = int((plain != oracle).sum())
    assert differing <= plain.size
    assert not (np.abs(plain - oracle) > 1e-5).any(), differing


def test_cpu_dispatch_takes_plain_version_and_counts():
    registry.reset_counts()
    q, k, v = _t(*_qkv(1, 8, 8, 2, 1, 8))
    assert ops.flash_attention_op(q, k, v).shape == (1, 8, 2, 8)
    assert ops.SPEC.plain_calls == 1 and ops.SPEC.launches == 0
    qkv = quantize_kv(k, v)
    int8.flash_attention_int8_op(q, *qkv)
    assert int8.SPEC.plain_calls == 1 and int8.SPEC.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, block_q=16, block_kv=16)
    with pytest.raises(ValueError, match="CUDA"):
        int8.flash_attention_int8(q, *qkv, block_q=16, block_kv=16)
    assert ops.SPEC.launches == 0 and int8.SPEC.launches == 0
    with pytest.raises(ValueError, match="serve"):
        ops.flash_attention_op(q, k[..., :4], v[..., :4])


def test_specs_match_reference_declarations():
    for spec, jspec in ((ops.SPEC, jax_ops.SPEC),
                        (int8.SPEC, jax_int8.SPEC)):
        assert [p.name for p in spec.params] == \
            [p.name for p in jspec.params]
        # the port's tolerance is at least as strict as the reference's
        assert all(a <= b for a, b in zip(spec.tol, jspec.tol))
        assert spec.tier == jspec.tier
        assert spec.default_problems == jspec.default_problems
        for problem in spec.default_problems:
            assert spec.cache_key(problem, "cuda") == \
                jspec.cache_key(problem, "cuda")
            assert spec.supports(problem)
            cands = spec.candidates(problem)
            assert cands[0] == spec.defaults()
            assert all(spec.fits(problem, c) for c in cands)
    assert ops.SPEC.tol == (2e-5, 2e-5) and int8.SPEC.tol == (1e-5, 1e-5)
    # the int8 kernel keeps the reference's ladders; the f32 kernel's are
    # the tiles it launches (warps of 16 rows, two K/V stages)
    assert [(p.default, p.ladder) for p in int8.SPEC.params] == \
        [(p.default, p.ladder) for p in jax_int8.SPEC.params]
    assert [(p.default, p.ladder) for p in ops.SPEC.params] == \
        [(128, (64, 128)), (32, (32, 64, 128))]


def test_shared_memory_and_register_model():
    """The port's own design: the f32 q tile, two K/V stages and, for f32
    inputs, one chunk split into TF32 hi and lo in shared memory, rows
    padded against bank conflicts; hd rounds up to a head tile of 32, 64,
    96 or 128."""
    assert smem_bytes(128, 32, 128) == (4 * 128 * 132
                                        + (2 * 2 + 4) * 32 * 4 * 132)
    assert smem_bytes(64, 32, 100) == smem_bytes(64, 32, 128)
    assert smem_bytes(128, 128, 64, bf16=True) == (
        4 * 128 * 68 + 2 * 2 * 128 * 2 * 72)
    assert smem_bytes(64, 32, 1) == 4 * 64 * 36 + 8 * 32 * 4 * 36
    assert fits(128, 128, 32) and fits(128, 64, 32)
    assert not fits(128, 128, 64)           # 270 KB of chunks, 66 KB of q
    assert not fits(128, 64, 64)
    assert fits(128, 128, 128, bf16=True)   # bf16: no split chunk, half-width
    assert fits(96, 128, 32) and not fits(96, 128, 64)
    assert fits(1, 64, 32) and fits(64, 128, 64) and fits(32, 128, 128)
    assert not fits(64, 32, 64)             # block_q: 4 or 8 warps of 16
    assert not fits(64, 256, 64) and not fits(64, 128, 16)
    assert not fits(64, 128, 256)
    assert not fits(160, 64, 32)            # hd past 128
    assert int8.smem_bytes(32, 128, 128) == 4 * (
        32 * 32 + 32 + 128 * 33 + 128 + 128 * 128 + 32 * 128 + 3 * 32)
    assert not int8.fits(62, 16, 16)        # hd % 4 != 0
    assert int8.fits(64, 256, 16) and not int8.fits(128, 256, 16)
    llama = {"b": 1, "sq": 4096, "skv": 4096, "h": 24, "kv": 8, "hd": 128,
             "causal": True, "q_offset": 0, "dtype": "float32"}
    # the default 128 x 32 tile fits at every head dim and dtype
    assert registry.resolve_params_info(ops.SPEC, llama) == \
        ({"block_q": 128, "block_kv": 32}, "default")
    # an explicit tile that does not fit serves the default
    assert registry.resolve_params_info(ops.SPEC, llama, {"block_kv": 64}) \
        == ({"block_q": 128, "block_kv": 32}, "default:smem-fallback")
    assert registry.resolve_params_info(int8.SPEC, dict(llama, sq=32)) == \
        ({"block_q": 128, "block_kv": 128}, "default")
    assert not ops.SPEC.supports(dict(llama, dtype="float16"))
    assert ops.SPEC.supports(dict(llama, dtype="bfloat16", hd=1))
    assert not int8.SPEC.supports(dict(llama, dtype="bfloat16"))


# ------------------------------------------------------ 3xTF32 numerics ---
# A CPU emulation of the products csrc/flash_attention.cu forms on the
# tensor cores, to predict the tolerance before any chip run.

def _tf32_rna(x):
    """cvt.rna.tf32.f32: the magnitude rounded half away from zero at
    bit 13, the low 13 bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    return (r | (u & np.uint32(0x80000000))).view(np.float32)


def _mma_matmul(a, b, passes):
    """``a @ b`` in k-steps of 8, each adding the TF32 products lo.hi,
    hi.lo, hi.hi (``passes=1``: hi.hi alone) to an f32 accumulator."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))[3 - passes:]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            acc = (acc + x[:, k0:k0 + 8].astype(np.float64)
                   @ y[k0:k0 + 8].astype(np.float64)).astype(np.float32)
    return acc


def test_3xtf32_llama_prefill_within_tolerance_1xtf32_not():
    """One head of the llama3.2-3b causal prefill (4,096 keys, hd 128),
    its last 128 query rows (the longest): scores q*scale . k and p @ v
    as 3xTF32 products stay inside (2e-5, 2e-5) of the f32 plain
    version; single-pass TF32 scores and products do not."""
    s, hd, rows = 4096, 128, 128
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, rows, 1, hd)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, 1, hd)).astype(np.float32)
            for _ in range(2))
    offset = s - rows
    want = flash_attention_ref(*_t(q, k, v), q_offset=offset).numpy()[0, :, 0]
    qs = q[0, :, 0] * np.float32(softmax_scale(hd))
    mask = np.arange(s)[None, :] <= np.arange(rows)[:, None] + offset

    def emulate(passes):
        sc = np.where(mask, _mma_matmul(qs, k[0, :, 0].T.copy(), passes),
                      np.float32(-1e30))
        p = np.exp(sc - sc.max(axis=1, keepdims=True)).astype(np.float32)
        o = _mma_matmul(p, v[0, :, 0], passes)
        return o / p.sum(axis=1, keepdims=True, dtype=np.float32)

    rtol, atol = TOL
    worst = lambda got: float(np.max(  # noqa: E731
        np.abs(got - want) / (atol + rtol * np.abs(want))))
    assert worst(emulate(3)) < 0.1
    assert worst(emulate(1)) > 1.0

