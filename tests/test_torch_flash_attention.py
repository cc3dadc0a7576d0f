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
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    decode_smem_bytes, flash_attention, fits, smem_bytes, softmax_scale)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_combine_ref, flash_attention_decode_ref,
    flash_attention_ref)
from repro_torch.quant.quantize import _scale, quantize_kv  # noqa: E402

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


@pytest.mark.parametrize("shape,causal,q_offset,kv_valid_len", [
    ((2, 16, 37, 4, 2, 16), True, 21, 30),    # Skv no block divides
    ((1, 12, 45, 6, 2, 8), False, 0, 17),     # non-causal, group 3
    ((4, 8, 61, 6, 2, 16), True, 53, 1),      # one key seen
    ((2, 16, 40, 4, 2, 16), True, 24, 0),     # no key: block_k divides Skv
    ((1, 8, 24, 4, 1, 8), False, 0, 0),
])
def test_int8_kv_valid_len_matches_pallas_interpret(shape, causal, q_offset,
                                                    kv_valid_len):
    """kv_valid_len, carried from the reference's Pallas function (its
    oracle has none).  At 0 every score is -1e30 and the Pallas kernel
    averages V over its padded keys too, so only shapes whose Skv the
    8-key block divides compare there."""
    q, k, v = _qkv(*shape, seed=4)
    jarr = (jnp.asarray(q),) + tuple(jq.quantize_kv(*_j(k, v)))
    tarr = (torch.from_numpy(q),) + tuple(quantize_kv(*_t(k, v)))
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
    pallas = np.asarray(jax_int8.flash_attention_int8(
        *jarr, block_q=8, block_k=8, interpret=True, **kw))
    plain = int8.flash_attention_int8_ref(*tarr, **kw).numpy()
    op = int8.flash_attention_int8_op(*tarr, **kw).numpy()
    np.testing.assert_array_equal(op, plain)
    rtol, atol = int8.TOL
    np.testing.assert_allclose(plain, pallas, rtol=rtol, atol=atol)
    if kv_valid_len == 0:   # the mean of each kv head's dequantized V
        v_deq = (tarr[3].float() * tarr[4]).numpy().mean(axis=1)
        want = np.repeat(v_deq, shape[3] // shape[4], axis=1)[:, None]
        np.testing.assert_allclose(plain, np.broadcast_to(want, plain.shape),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------ the split-key design ---
# A model of csrc/flash_attention_int8.cu's key partition and combine, to
# hold the design to the plain version before any chip run.

def _kv_end(skv, valid, causal, q_offset, first, last):
    """The keys a block (or warp) visits: all Skv unless every row sees
    key 0; ``first``/``last``: its rows' first and last positions."""
    if valid > 0 and (not causal or q_offset + first >= 0):
        end = min(skv, valid)
        return min(end, q_offset + last + 1) if causal else end
    return skv


def _split_model(q, kq, ks, vq, vs, *, causal, q_offset, kv_valid_len,
                 block_q, splits):
    """The kernel's arithmetic by blocks: per (q tile, slice) the keys it
    visits, ``per`` = ceil(kv_end / splits) rounded up to 16 keys a split,
    each split's (m, l, acc = sum p vq) per row (a split past kv_end is
    flagged and adds nothing), the splits added in ascending order with
    weights exp(m_s - M), then o = vs * acc / max(l, 1e-30).  Returns the
    output and the number of (block, split) pairs that were empty."""
    B, Sq, H, hd = q.shape
    Skv, KV = kq.shape[1], kq.shape[2]
    group = H // KV
    valid = Skv if kv_valid_len is None else min(max(kv_valid_len, 0), Skv)
    qf = q.float()
    qs = _scale(qf.abs().amax(-1, keepdim=True))
    qq = torch.round(qf / qs)
    s32 = torch.einsum("bqhd,bkhd->bhqk", qq,
                       kq.float().repeat_interleave(group, dim=2))
    s = (s32 * (qs * np.float32(softmax_scale(hd))).permute(0, 2, 1, 3)
         * ks.repeat_interleave(group, dim=2).permute(0, 2, 3, 1))
    pos = torch.arange(Sq)[:, None] + q_offset
    key = torch.arange(Skv)[None, :]
    seen = (key < valid) & ((key <= pos) if causal else True)
    s = torch.where(seen[None, None], s, torch.tensor(-1e30))   # [B,H,Sq,Skv]
    vqf = vq.float().permute(0, 2, 1, 3)                         # [B,KV,Skv,hd]
    shape = int8.launch_shape(Sq, H, KV, block_q)
    rows_cap = 16 * shape["row_tiles"]
    out = torch.zeros_like(qf)
    empty = 0
    for tile in range(shape["q_tiles"]):
        q0 = tile * block_q
        live = (min(q0 + block_q, Sq) - q0) * group
        for sl in range(shape["slices"]):
            r0 = sl * rows_cap
            n = min(live - r0, rows_cap)
            if n <= 0:
                continue
            R = torch.arange(r0, r0 + n)
            rpos, hh = q0 + R // group, R % group
            end = _kv_end(Skv, valid, causal, q_offset, int(rpos[0]),
                          int(rpos[-1]))
            per = -(-(-(-end // splits)) // 16) * 16
            heads = torch.arange(KV)[:, None] * group + hh[None, :]  # [KV,n]
            sb = s[:, heads, rpos[None, :]]                   # [B,KV,n,Skv]
            M = torch.full(sb.shape[:3], -float("inf"))
            parts = []
            for sp in range(splits):
                a, e = sp * per, min(sp * per + per, end)
                if a >= end:
                    empty += 1
                    continue
                m = sb[..., a:e].amax(-1)
                p = torch.exp(sb[..., a:e] - m[..., None])
                parts.append((m, p.sum(-1), p @ vqf[:, :, a:e]))
                M = torch.maximum(M, m)
            L = torch.zeros_like(M)
            A = torch.zeros(sb.shape[:3] + (hd,))
            for m, l, acc in parts:
                w = torch.exp(m - M)
                L = L + l * w
                A = A + acc * w[..., None]
            o = A * vs[:, 0, :, None, :] / torch.clamp(L, min=1e-30)[..., None]
            out[:, rpos[None, :], heads] = o
    return out, empty


@pytest.mark.parametrize("shape,kw,block_q", [
    ((4, 32, 300, 6, 2, 16), {"q_offset": 268}, 32),      # a decode window
    ((1, 40, 40, 4, 1, 8), {}, 16),                       # prefill: empty splits
    ((1, 50, 90, 3, 1, 8), {"q_offset": -20}, 16),        # rows that see no key
    ((2, 24, 77, 4, 2, 12), {"kv_valid_len": 0}, 128),
    ((2, 24, 77, 4, 2, 12), {"kv_valid_len": 0, "causal": False}, 16),
    ((1, 20, 100, 16, 1, 8), {"kv_valid_len": 41, "causal": False}, 64),
])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
def test_split_and_combine_model_matches_plain_version(shape, kw, block_q,
                                                       splits):
    q, k, v = _t(*_qkv(*shape, seed=6))
    arrays = (q,) + tuple(quantize_kv(k, v))
    kw = dict({"causal": True, "q_offset": 0, "kv_valid_len": None}, **kw)
    want = int8.flash_attention_int8_ref(*arrays, **kw)
    got, empty = _split_model(*arrays, block_q=block_q, splits=splits, **kw)
    rtol, atol = int8.TOL
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if splits == 16 and shape[1] == shape[2]:
        assert empty > 0   # the causal prefill's early tiles


def test_split_model_covers_slices_and_empty_splits():
    """A group of 16 at block_q 16 is 256 rows: three blocks of 6 row
    tiles per q tile; a causal tile near the start leaves most of 16
    splits empty."""
    assert int8.launch_shape(20, 16, 1, 16) == {
        "q_tiles": 2, "row_tiles": 6, "key_groups": 1, "warps": 6,
        "slices": 3}
    q, k, v = _t(*_qkv(1, 20, 100, 16, 1, 8, seed=7))
    arrays = (q,) + tuple(quantize_kv(k, v))
    want = int8.flash_attention_int8_ref(*arrays, causal=True, q_offset=3)
    got, empty = _split_model(*arrays, causal=True, q_offset=3,
                              kv_valid_len=None, block_q=16, splits=16)
    assert empty >= 16
    torch.testing.assert_close(got, want, rtol=int8.TOL[0], atol=int8.TOL[1])


def test_launch_shape_and_split_count():
    """The llama3.2-3b decode window (B 4, 32 queries, 8,192 keys, 24
    heads over 8 kv heads): one q tile of 96 rows per (b, kv head), 32
    blocks, so the keys are split until the grid holds about two blocks
    on each of 132 SMs, at every block_q; enough blocks already, or a
    short cache, split less."""
    assert int8.launch_shape(32, 24, 8, 32) == {
        "q_tiles": 1, "row_tiles": 6, "key_groups": 1, "warps": 6,
        "slices": 1}
    # positions past Sq are no rows: the untuned block_q 128 is the same
    assert int8.launch_shape(32, 24, 8, 128) == int8.launch_shape(32, 24, 8,
                                                                  32)
    # one decode step: 3 rows, one tile, four warps taking turns over keys
    assert int8.launch_shape(1, 24, 8, 128) == {
        "q_tiles": 1, "row_tiles": 1, "key_groups": 4, "warps": 4,
        "slices": 1}
    assert int8.launch_shape(2, 12, 4, 16)["key_groups"] == 4
    assert int8.launch_shape(8, 12, 4, 16)["key_groups"] == 2
    assert int8.launch_shape(300, 32, 2, 256) == {
        "q_tiles": 2, "row_tiles": 6, "key_groups": 1, "warps": 6,
        "slices": 43}
    for sq in (32, 1):
        for bq in int8.LADDER:
            shape = int8.launch_shape(sq, 24, 8, bq)
            splits = int8.split_count(4, sq, 8192, 24, 8, bq, 132)
            blocks = 4 * 8 * shape["q_tiles"] * shape["slices"] * splits
            assert 132 <= blocks <= 2 * 132 and splits > 1
    assert int8.split_count(4, 32, 8192, 24, 8, 128, 132) == 8
    assert int8.split_count(1, 4096, 4096, 24, 8, 128, 132) == 1
    assert int8.split_count(4, 32, 512, 8, 2, 128, 132) == 2  # 256 keys each
    assert int8.split_count(1, 1, 100, 1, 1, 16, 132) == 1
    assert int8.split_count(1, 1, 1 << 20, 1, 1, 16, 132) == int8.MAX_SPLITS


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
    """The port's own designs.  f32: the q tile, two K/V stages and one
    chunk split into TF32 hi and lo in shared memory, rows padded against
    bank conflicts.  bf16: two bf16 K/V stages, rows padded by 16 bytes,
    the q rows staged through the same memory (so at least their tile),
    and the decode kernel's one tile of 16 q rows beside two stages of 64
    keys.  hd rounds up to a head tile of 32, 64, 96 or 128."""
    assert smem_bytes(128, 32, 128) == (4 * 128 * 132
                                        + (2 * 2 + 4) * 32 * 4 * 132)
    assert smem_bytes(64, 32, 100) == smem_bytes(64, 32, 128)
    assert smem_bytes(128, 128, 64, bf16=True) == 2 * 2 * 128 * 2 * 72
    assert smem_bytes(128, 32, 128, bf16=True) == 2 * 2 * 32 * 2 * 136
    # 128 q rows of 264 halves outweigh two stages of 32 keys at q.k 256
    assert smem_bytes(128, 32, 256, bf16=True) == 2 * 128 * 264
    assert smem_bytes(64, 32, 1) == 4 * 64 * 36 + 8 * 32 * 4 * 36
    assert decode_smem_bytes(128) == 2 * (16 * 136 + 2 * 64 * 2 * 136)
    assert decode_smem_bytes(192) == 2 * (16 * 200 + 2 * 64 * (200 + 136))
    assert fits(128, 128, 32) and fits(128, 64, 32)
    assert not fits(128, 128, 64)           # 270 KB of chunks, 66 KB of q
    assert not fits(128, 64, 64)
    # bf16: every tile of the ladders at every head width, the widest
    # (q.k 256, 128 keys a chunk) in 205 KB
    assert all(fits(hd, bq, bkv, True, min(hd, 128)) for hd in (1, 128, 256)
               for bq in fa.BLOCK_Q for bkv in fa.BLOCK_KV)
    assert smem_bytes(128, 128, 256, bf16=True) == 204_800
    assert fits(96, 128, 32) and not fits(96, 128, 64)
    assert fits(1, 64, 32) and fits(64, 128, 64) and fits(32, 128, 128)
    assert not fits(64, 32, 64)             # block_q: 4 or 8 warps of 16
    assert not fits(64, 256, 64) and not fits(64, 128, 16)
    assert not fits(64, 128, 256)
    assert not fits(160, 64, 32)            # hd past 128
    # int8: the q rows of 6 warps and their scales, two stages of int8 K
    # and V rows (hd padded to 32, plus 16 bytes) and K scales
    assert int8.smem_bytes(96, 128, 128) == (96 * (144 + 4)
                                             + 2 * 128 * (2 * 144 + 4))
    assert int8.smem_bytes(64, 16, 36) == int8.smem_bytes(64, 16, 64)
    # short chunks: the stages are at least the key groups' exchange
    assert int8.smem_bytes(16, 16, 128) == 16 * 148 + 48 * 132 * 4
    assert not int8.fits(62, 16, 16)        # hd % 4 != 0
    assert not int8.fits(132, 16, 16) and not int8.fits(64, 48, 16)
    # every tile of the ladder at every head dim: rows past 6 tiles of 16
    # go to further blocks, not into registers
    assert all(int8.fits(hd, bq, bkv) for hd in (4, 36, 128)
               for bq in int8.LADDER for bkv in int8.LADDER)
    llama = {"b": 1, "sq": 4096, "skv": 4096, "h": 24, "kv": 8, "hd": 128,
             "causal": True, "q_offset": 0, "dtype": "float32"}
    # the f32 default 128 x 32 tile fits at every head dim; bf16 problems
    # default to the bf16 design's 128 x 128, first among its candidates
    assert registry.resolve_params_info(ops.SPEC, llama) == \
        ({"block_q": 128, "block_kv": 32}, "default")
    bf16 = dict(llama, dtype="bfloat16")
    assert registry.resolve_params_info(ops.SPEC, bf16) == \
        ({"block_q": 128, "block_kv": 128}, "default")
    assert ops.SPEC.candidates(bf16)[0] == ops.BF16_DEFAULTS
    assert len(ops.SPEC.candidates(bf16)) == 6
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


# -------------------------------------------------------- bf16 numerics ---
# A CPU emulation of the products csrc/flash_attention_bf16.cu forms on
# the bf16 tensor cores: why P is split into bf16 hi + lo.

def test_bf16_products_llama_prefill_within_tolerance_one_bf16_p_not():
    """Four heads of the llama3.2-3b causal prefill (2,048 keys, hd 128)
    in bf16: q . k as one product of the exact bf16 values, summed in f32
    and scaled afterwards; P @ V with p split into bf16 hi + lo = bf16(p -
    hi) against bf16 V, l the sum of the f32 p; o = acc / l rounded to
    bf16 once.  That stays within (2^-7, 2e-5) of the plain version (one
    bf16 ulp); one bf16 P does not, by more than 10x."""
    s, hd, heads = 2048, 128, 4
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, heads, hd))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    want = flash_attention_ref(q, k, v).float()
    qf, kf, vf = (t[0].float().transpose(0, 1) for t in (q, k, v))
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    sc = (qf @ kf.transpose(1, 2) * softmax_scale(hd)).masked_fill(~mask,
                                                                  -1e30)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    l = p.sum(-1, keepdim=True)

    def worst(acc):
        got = (acc / l).to(torch.bfloat16).float().transpose(0, 1)[None]
        return float(((got - want).abs()
                      / (2e-5 + 2 ** -7 * want.abs())).max())
    assert worst(hi @ vf + lo @ vf) <= 1.0
    assert worst(hi @ vf) > 10.0


@pytest.mark.parametrize("sq,h,kv,decode", [
    (1, 24, 8, True),      # llama3.2-3b decode step: 3 rows a kv head
    (1, 32, 8, True),      # jamba's GQA layer: 4
    (1, 20, 20, True),     # one q head a kv head (cross-attention step)
    (1, 16, 1, True),      # 16 rows: the threshold
    (5, 6, 2, True),       # 15 rows
    (16, 1, 1, True),      # 16
    (17, 1, 1, False),     # 17: the prefill kernel
    (6, 24, 8, False),     # 18
    (2048, 24, 8, False),  # the llama3.2-3b prefill
])
def test_decode_row_rule(sq, h, kv, decode):
    """bf16 problems of at most 16 rows a kv head (Sq x H / KV) run the
    decode kernel, larger ones the prefill kernel."""
    assert fa.DECODE_ROWS == 16
    assert fa.is_decode(sq, h, kv) is decode


def test_decode_split_count_at_the_lm_shapes():
    """About two blocks an SM over the (batch, kv head) blocks, at least
    256 visited keys a split, at most 32 splits, one where the blocks
    alone fill the card: the llama3.2-3b and jamba decode steps (B 4, 8
    kv heads, 2,049 of 2,081 keys) on the H100's 132 SMs take 8."""
    keys = fa.visited_keys(1, 2081, False, 0, 2049)
    assert keys == 2049
    assert fa.split_count(4, 8, keys, 132) == 8
    assert fa.split_count(4, 8, 2049 + 32, 132) == 8
    assert fa.split_count(1, 8, 8192, 132) == 32         # capped
    assert fa.split_count(4, 8, 300, 132) == 1           # few keys
    assert fa.split_count(64, 8, 8192, 132) == 1         # blocks fill it
    # every row sees a key: the keys stop at kv_valid and the causal
    # horizon; else all Skv are visited (rows that see none average V)
    assert fa.visited_keys(4, 500, True, 100, 300) == 104
    assert fa.visited_keys(4, 500, True, -1, 300) == 500
    assert fa.visited_keys(1, 500, False, 0, 0) == 500


@pytest.mark.parametrize("shape,kw", [
    ((2, 1, 300, 6, 2, 64), {"causal": False, "kv_valid_len": 200}),
    ((1, 5, 700, 6, 2, 40), {"q_offset": 650}),
    ((2, 1, 50, 4, 4, 16), {"causal": False, "kv_valid_len": 0}),
    ((1, 4, 130, 16, 4, 24), {"q_offset": -2}),
    ((1, 1, 2081, 3, 1, 32), {"causal": False, "kv_valid_len": 2049}),
])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_decode_partials_and_combine_match_jax_oracle(shape, kw, splits):
    """The plain versions of the bf16 decode kernel's partials (its
    partition: chunks of 64 keys over the splits, 16 keys a warp) and of
    their combine give the reference's attention, in f32, at any split
    count, rows that see no key included."""
    q, k, v = _qkv(*shape, seed=splits)
    part_acc, part_ml = flash_attention_decode_ref(*_t(q, k, v),
                                                   splits=splits, **kw)
    b, sq, _, h, _, hd = shape
    assert part_acc.shape == (splits * fa.DECODE_WARPS, b * sq * h, hd)
    got = flash_attention_combine_ref(part_acc, part_ml, hd, torch.float32)
    oracle = np.asarray(jax_ref(*_j(q, k, v), **kw))
    np.testing.assert_allclose(got.reshape(oracle.shape).numpy(), oracle,
                               rtol=TOL[0], atol=TOL[1])


def test_kernel_wrappers_need_the_card():
    """Each kernel's wrapper refuses CPU tensors, counting nothing; the
    op's spec resets every one of their counts."""
    q, k, v = _t(*_qkv(1, 1, 16, 2, 2, 8))
    out = torch.empty_like(q)
    kw = dict(causal=True, q_offset=0, valid=16)
    calls = [
        lambda: fa.flash_attention_f32(q, k, v, out, block_q=64,
                                       block_kv=32, **kw),
        lambda: fa.flash_attention_bf16_prefill(q, k, v, out, block_q=64,
                                                block_kv=32, **kw),
        lambda: fa.flash_attention_bf16_decode(q, k, v, splits=1, **kw),
        lambda: fa.flash_attention_bf16_combine(
            torch.zeros(4, 2, 8), torch.zeros(4, 2, 2),
            out.to(torch.bfloat16), 8),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for kernel in fa.KERNELS:
        kernel.launches = 7
    ops.SPEC.reset_counts()
    assert ops.SPEC.parts == fa.KERNELS
    assert all(kernel.launches == 0 for kernel in fa.KERNELS)
