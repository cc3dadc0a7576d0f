"""Port parity: the int8 fused-MLP plain version, packing, registry
declaration and dispatch against repro.kernels.fused_mlp.int8 and
repro.quant.quantize, on the CPU."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_mlp.int8 import fused_mlp_int8 as jax_int8  # noqa: E402
from repro.quant import quantize as jq  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.fused_mlp import int8  # noqa: E402
from repro_torch.kernels.fused_mlp import ops as fused_ops  # noqa: E402
from repro_torch.nn.serialize import qlayers_from_jax  # noqa: E402
from repro_torch.quant.quantize import quant_mlp_ref, quantize_rows  # noqa: E402

BUDE = (6, 1024, 819, 655, 524, 419, 335, 1)


def _stack(widths, batch, seed=0):
    """Seeded f32 weights, biases and rows, the reference's ``_make``
    scales (weights 0.3, biases 0.1)."""
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(a, b)) * 0.3).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.normal(size=(b,)) * 0.1).astype(np.float32)
          for b in widths[1:]]
    x = rng.normal(size=(batch, widths[0])).astype(np.float32)
    return x, ws, bs


def _jax_qlayers(ws, bs):
    return [tuple(np.asarray(a) for a in q)
            for q in jq.quantize_params(ws, bs)]


# (rtol, atol): the reference's TOL, one int8 step of a unit-scale
# activation (see int8.py); the same bound holds port vs JAX, whose
# activations differ by f32 ulps
TOL = int8.TOL


@pytest.mark.parametrize("widths,acts", [
    ((4, 16, 2), ("relu", "identity")),
    ((6, 64, 48, 1), ("relu", "relu", "identity")),
    ((5, 40, 24, 3), ("gelu", "tanh", "identity")),
    ((7, 33, 17, 2), ("silu", "sigmoid", "identity")),
])
@pytest.mark.parametrize("batch", [1, 37, 130])
def test_plain_version_matches_jax_oracle_and_pallas_interpret(widths, acts,
                                                               batch):
    x, ws, bs = _stack(widths, batch)
    qnp = _jax_qlayers(ws, bs)
    jql = [tuple(jnp.asarray(a) for a in q) for q in qnp]
    oracle = np.asarray(jq.quant_mlp_ref(jnp.asarray(x), jql, acts))
    pallas = np.asarray(jax_int8(jnp.asarray(x), jql, acts, batch_tile=32,
                                 interpret=True))
    packed = qlayers_from_jax(qnp, acts, device="cpu")
    tx = torch.from_numpy(x)
    plain = quant_mlp_ref(tx, packed.qlayers, acts).numpy()
    op = int8.fused_mlp_int8_op(tx, packed).numpy()
    np.testing.assert_array_equal(op, plain)
    rtol, atol = TOL
    np.testing.assert_allclose(plain, oracle, rtol=rtol, atol=atol)
    np.testing.assert_allclose(plain, pallas, rtol=rtol, atol=atol)


def test_relu_net_matches_jax_oracle_bit_for_bit():
    """Quantization, the exact integer dot and the dequant epilogue are
    the same ops in both packages: with relu/identity activations (exact
    in both) nothing can differ."""
    widths, acts = (6, 64, 48, 1), ("relu", "relu", "identity")
    x, ws, bs = _stack(widths, 256, seed=3)
    qnp = _jax_qlayers(ws, bs)
    oracle = np.asarray(jq.quant_mlp_ref(
        jnp.asarray(x), [tuple(jnp.asarray(a) for a in q) for q in qnp],
        acts))
    packed = qlayers_from_jax(qnp, acts, device="cpu")
    plain = quant_mlp_ref(torch.from_numpy(x), packed.qlayers, acts)
    np.testing.assert_array_equal(plain.numpy(), oracle)


def _unpack(words, k, n):
    """Inverse of pack_words: the int8 [k, n] it packed."""
    kt, nt = int(words.shape[0]), int(words.shape[1])
    b = words.contiguous().view(torch.int8).view(kt, nt, 8, 4, 2, 4)
    # [kt, nt, g, t, r, b] -> [kt, r, t, b, nt, g]
    return b.permute(0, 4, 3, 5, 1, 2).reshape(32 * kt, 8 * nt)[:k, :n]


@pytest.mark.parametrize("k,n", [(6, 5), (16, 3), (17, 1), (335, 7),
                                 (40, 33)])
def test_pack_words_layout(k, n):
    """unpack(pack(wq)) == wq at ragged K and N; the padding is zeros;
    lane (g, t)'s word r of tile (kt, nt) holds wq[32 kt + 16 r + 4 t +
    b, 8 nt + g] in byte b, the B fragment of mma.sync m16n8k32."""
    wq = torch.from_numpy(np.random.default_rng(k).integers(
        -127, 128, size=(k, n)).astype(np.int8))
    words = int8.pack_words(wq)
    kp = -(-k // int8.K_PAD) * int8.K_PAD
    np_ = -(-n // int8.N_PAD) * int8.N_PAD
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (kp // 32, np_ // 8, 32, 2)
    assert torch.equal(_unpack(words, k, n), wq)
    padded = _unpack(words, kp, np_)
    assert not padded[k:].any() and not padded[:, n:].any()
    b = words.view(torch.int8).view(kp // 32, np_ // 8, 32, 2, 4)
    full = torch.zeros((kp, np_), dtype=torch.int8)
    full[:k, :n] = wq
    for kt, nt, lane, r, byte in ((0, 0, 0, 0, 1), (0, 0, 13, 1, 2),
                                  (kp // 32 - 1, np_ // 8 - 1, 31, 1, 3)):
        g, t = divmod(lane, 4)
        assert int(b[kt, nt, lane, r, byte]) == int(
            full[32 * kt + 16 * r + 4 * t + byte, 8 * nt + g])


def _mma_product(hq, words):
    """The kernel's int8 product, emulated from what each lane holds:
    A fragments as ldmatrix.x4 hands them out from the int8 rows (lane l
    gives the address of row l % 16, byte 16 * (l // 16); register q of
    lane l is matrix q's row l // 4, bytes 4 (l % 4) .. + 3), B fragments
    as 8-byte loads from the pack, the m16n8k32 product of the matrices
    the PTX fragment layout assembles from them, and the C fragments
    (lane l: rows l // 4 and + 8, columns 2 (l % 4) and + 1) written back.
    Returns int64 [M, Np] for hq int8 [M, Kp], M a multiple of 16."""
    m, kp = hq.shape
    kts, nts = words.shape[:2]
    assert kp == 32 * kts and m % 16 == 0
    bfrag = words.view(torch.int8).view(kts, nts, 32, 2, 4).numpy()
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    byte = np.arange(4)
    out = np.zeros((m, 8 * nts), np.int64)
    for mt in range(m // 16):
        for kt in range(kts):
            tile = hq[16 * mt:16 * mt + 16, 32 * kt:32 * kt + 32]
            addr_row, addr_col = lanes % 16, 16 * (lanes // 16)
            a = np.empty((32, 4, 4), np.int64)
            for q in range(4):
                src = 8 * q + lanes // 4   # the lane that gave the row
                a[:, q] = tile[addr_row[src][:, None],
                               addr_col[src][:, None] + 4 * t[:, None]
                               + byte]
            A = np.zeros((16, 32), np.int64)
            for q in range(4):
                A[(g + 8 * (q & 1))[:, None],
                  (4 * t + 16 * (q >> 1))[:, None] + byte] = a[:, q]
            assert (A == tile).all()   # ldmatrix gives the A fragment
            for nt in range(nts):
                Bm = np.zeros((32, 8), np.int64)
                for r in range(2):
                    Bm[(4 * t + 16 * r)[:, None] + byte,
                       g[:, None]] = bfrag[kt, nt, :, r]
                C = A @ Bm
                for e in range(4):
                    rows = 16 * mt + g + 8 * (e >> 1)
                    cols = 8 * nt + 2 * t + (e & 1)
                    out[rows, cols] += C[g + 8 * (e >> 1), 2 * t + (e & 1)]
    return out


def _kernel_quantize(h):
    """csrc/fused_mlp_int8.cu's quantize, in numpy f32: the row scale by
    a true division, q = v * fl(1/s), rounded by adding and subtracting
    1.5 * 2^23 (the integer read from the sum's bits), and the true
    division where q lies within 2^-14 of a half-integer.  Returns (int8
    rows, the fallback count)."""
    f = np.float32
    m = np.abs(h).max(axis=1, keepdims=True)
    s = np.where(m > 0, m, f(1)).astype(f) / f(127)
    rs = (f(1) / s).astype(f)
    q = (h * rs).astype(f)
    t = (q + f(12582912.0)).astype(f)
    n = t.view(np.int32) - 0x4B400000
    near = np.abs((q - (t - f(12582912.0)).astype(f)).astype(f)) >= \
        f(0.5) - f(2.0 ** -14)
    exact = np.rint((h / s).astype(f)).astype(np.int32)
    return np.where(near, exact, n).astype(np.int8), int(near.sum())


def test_kernel_quantize_rule_equals_true_division():
    """The kernel rounds the product with the reciprocal and falls back
    to the division near half-integers; on random rows (a third zeros,
    scales over five decades) and on rows whose quotients sit at or a
    few ulps from half-integers, it quantizes as ``quantize_rows``."""
    rng = np.random.default_rng(7)
    rows = (rng.standard_normal((512, 700))
            * rng.uniform(1e-3, 1e2, (512, 1))).astype(np.float32)
    rows[rng.random(rows.shape) < 0.3] = 0.0
    s = np.float32(0.37)
    halves = (np.arange(-127, 127) + 0.5).astype(np.float32) * s
    inf = np.float32(np.inf)
    near = np.stack([np.nextafter(halves, -inf), halves,
                     np.nextafter(halves, inf)]).astype(np.float32)
    near = np.concatenate([near, np.full((3, 1), 127 * s, np.float32)], 1)
    for h in (rows, near):
        got, fallbacks = _kernel_quantize(h)
        want = quantize_rows(torch.from_numpy(h))[0].numpy()
        np.testing.assert_array_equal(got, want)
    assert fallbacks > 0   # the half-integer rows take the division


@pytest.mark.parametrize("k,n", [(6, 1024), (1024, 819), (419, 335),
                                 (335, 1)])
def test_mma_fragment_product_is_exact(k, n):
    """At the minibude widths, the m16n8k32 fragment product from the
    packed words equals hq @ wq in int32 exactly."""
    rng = np.random.default_rng(k + n)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    hq = rng.integers(-127, 128, size=(32, k)).astype(np.int8)
    kp = -(-k // int8.K_PAD) * int8.K_PAD
    hq_pad = np.zeros((32, kp), np.int8)
    hq_pad[:, :k] = hq
    got = _mma_product(hq_pad, int8.pack_words(torch.from_numpy(wq)))
    want = hq.astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(got[:, :n], want)
    assert not got[:, n:].any()
    assert (np.abs(want) < 2 ** 31).all()


def test_pack_int8_mlp_table_and_views():
    widths, acts = (6, 64, 33, 1), ("relu", "gelu", "identity")
    x, ws, bs = _stack(widths, 2)
    qnp = _jax_qlayers(ws, bs)
    packed = qlayers_from_jax(qnp, acts, device="cpu")
    assert packed.widths == widths and packed.acts == acts
    assert packed.table[:, 2].tolist() == [1, 2, 0]
    q_off = 0
    for e, (wq, s, b), (jwq, jws, jb), (k, n) in zip(
            packed.table, packed.qlayers, qnp, zip(widths[:-1], widths[1:])):
        assert tuple(e[:2]) == (k, n) and e[3] == q_off
        kp = -(-k // int8.K_PAD) * int8.K_PAD
        np_ = -(-n // int8.N_PAD) * int8.N_PAD
        n_words = kp * np_ // 4
        words = packed.qweights[q_off:q_off + n_words].view(
            kp // 32, np_ // 8, 32, 2)
        assert torch.equal(_unpack(words, k, n), wq)
        assert q_off * 4 % 256 == 0   # the TMA's 16-byte alignment
        q_off += n_words
        np.testing.assert_array_equal(wq.numpy(), jwq)
        np.testing.assert_array_equal(s.numpy(), jws)
        np.testing.assert_array_equal(b.numpy(), jb)
        assert torch.equal(packed.fparams[int(e[4]):int(e[4]) + n], s)
        assert torch.equal(packed.fparams[int(e[5]):int(e[5]) + n], b)
    assert packed.qweights.numel() == q_off
    with pytest.raises(ValueError, match="int8"):
        qlayers_from_jax([(np.zeros((3, 2), np.float32), np.ones(2),
                           np.zeros(2))], ("relu",), device="cpu")
    with pytest.raises(ValueError, match="chain"):
        int8.pack_int8_mlp([packed.qlayers[0], packed.qlayers[2]],
                           ("relu", "identity"))


def _problem(widths):
    return {"widths": tuple(widths), "acts": ("relu",) * (len(widths) - 1),
            "batch": 256, "ndim": 2, "dtype": "float32"}


def test_shared_memory_model_and_spec():
    # mma path: barriers, counts, scales and table (2 KB), a layer's ws
    # and b, as many slabs of two k32 steps of the widest output (1,024)
    # as fit (at least 2, at most 6), the int8 rows padded to 1,024 + 16
    assert int8.mma_stages(BUDE, 32) == 2 and int8.mma_stages(BUDE, 16) == 3
    assert int8.smem_bytes(BUDE, 32) == \
        2048 + 2 * 4 * 1024 + 2 * 2 * 32 * 1024 + 32 * 1040
    assert int8.smem_bytes(BUDE, 16) == \
        2048 + 2 * 4 * 1024 + 3 * 2 * 32 * 1024 + 16 * 1040
    # rows path: f32 rows, int8 rows (K padded to 32), scales
    assert int8.smem_bytes(BUDE, 8) == 8 * 1024 * 4 + 8 * 1024 + 32
    assert int8.smem_bytes((4, 16, 2), 1) == 64 + 32 + 16
    # the accumulators: 128 int32 a thread over 8 warps, per block
    assert [int8.mma_max_out(r) for r in int8.MMA_BLOCK_ROWS] == \
        [2048, 1024, 512]
    assert int8.fits_smem(BUDE, 32) and not int8.fits_smem(BUDE, 64)
    assert int8.fits_smem((4, 512, 512, 2), 64)
    assert int8.mma_stages((4, 512, 512, 2), 64) == 5
    assert int8.DEFAULT_BLOCK_ROWS == 32
    assert registry.resolve_params(int8.SPEC, _problem(BUDE)) == \
        {"block_rows": 32}
    # width 8192: past every mma block; 8 rows take 320 KB, 4 rows 160 KB
    assert registry.resolve_params(int8.SPEC, _problem((6, 8192, 1))) == \
        {"block_rows": 4}
    assert registry.resolve_params(int8.SPEC, _problem(BUDE),
                                   {"block_rows": 16}) == {"block_rows": 16}
    assert registry.resolve_params_info(
        int8.SPEC, _problem((6, 8192, 1)), {"block_rows": 16}) == \
        ({"block_rows": 4}, "default:smem-fallback")
    assert registry.resolve_params_info(
        int8.SPEC, _problem(BUDE), {"block_rows": 64}) == \
        ({"block_rows": 32}, "default:smem-fallback")
    assert int8.SPEC.supports(_problem(BUDE))
    assert int8.SPEC.supports(_problem((6, 8192, 1)))
    assert not int8.SPEC.supports(_problem((6, 50000, 1)))
    assert not int8.SPEC.supports(_problem((6,) + (8,) * 17 + (1,)))
    assert not int8.SPEC.supports(dict(_problem(BUDE), dtype="bfloat16"))
    assert int8.SPEC.tier == "int8" and int8.SPEC.tol == (2e-2, 2e-2)
    assert fused_ops.SPEC.tier == "f32"
    names = [s.name for s in registry.all_specs()]
    assert names == ["flash_attention", "flash_attention_int8", "fused_mlp",
                     "fused_mlp_int8", "mamba_scan", "rwkv6_chunk",
                     "stencil_gather"]


@pytest.mark.parametrize("block_rows,path,slabs", [
    (1, "dp4a", 0), (8, "dp4a", 0), (16, "mma.sync s8", 3),
    (32, "mma.sync s8", 2)])
def test_launch_shape(block_rows, path, slabs):
    """What a launch at each block size runs: the path, one block per
    block_rows rows (the last one ragged), the ring's slabs."""
    shape = int8.launch_shape(BUDE, 65536 + 1, block_rows)
    assert shape["path"] == path and shape["ring_slabs"] == slabs
    assert shape["blocks"] == -(-(65536 + 1) // block_rows)
    assert shape["smem_bytes"] == int8.smem_bytes(BUDE, block_rows)


def test_cpu_dispatch_takes_plain_version_and_counts():
    registry.reset_counts()
    x, ws, bs = _stack((6, 16, 1), 9)
    packed = qlayers_from_jax(_jax_qlayers(ws, bs), ("relu", "identity"),
                              device="cpu")
    y = int8.fused_mlp_int8_op(torch.from_numpy(x), packed)
    assert y.shape == (9, 1)
    assert int8.SPEC.plain_calls == 1 and int8.SPEC.launches == 0
    # the kernel wrapper itself takes CUDA tensors only: no CPU fallback
    with pytest.raises(ValueError, match="CUDA"):
        int8.fused_mlp_int8(torch.from_numpy(x), packed, block_rows=16)
    assert int8.SPEC.launches == 0


def test_from_spec_adapter_matches_jax():
    # a flatten ahead of the dense stack: the adapter reshapes the rows
    spec = {"in_shape": [1, 5, 1], "layers": [
        {"kind": "flatten"}, {"kind": "dense", "features": 12},
        {"kind": "act", "name": "relu"}, {"kind": "dense", "features": 2}]}
    x, ws, bs = _stack((5, 12, 2), 11, seed=4)
    qnp = _jax_qlayers(ws, bs)
    packed = qlayers_from_jax(qnp, ("relu", "identity"), device="cpu")
    got = int8.fused_mlp_int8_from_spec(spec, packed,
                                        torch.from_numpy(x[:, :, None]))
    want = jq.quant_mlp_ref(jnp.asarray(x),
                            [tuple(jnp.asarray(a) for a in q) for q in qnp],
                            ("relu", "identity"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
