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
from repro_torch.quant.quantize import quant_mlp_ref  # noqa: E402

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
    """Inverse of pack_words: int32 words [Kp/4, n] -> int8 [k, n]."""
    kp4 = words.shape[0]
    return (words.reshape(-1).view(torch.int8).view(kp4, n, 4)
            .permute(0, 2, 1).reshape(4 * kp4, n)[:k])


@pytest.mark.parametrize("k,n", [(6, 5), (16, 3), (17, 1), (335, 7)])
def test_pack_words_layout(k, n):
    wq = torch.from_numpy(np.random.default_rng(k).integers(
        -127, 128, size=(k, n)).astype(np.int8))
    words = int8.pack_words(wq)
    kp = -(-k // int8.K_PAD) * int8.K_PAD
    assert words.dtype == torch.int32 and tuple(words.shape) == (kp // 4, n)
    assert torch.equal(_unpack(words, k, n), wq)
    padded = _unpack(words, kp, n)
    assert not padded[k:].any()
    # byte j of word (g, c) is wq[4g + j, c], as __dp4a reads it
    b = words.reshape(-1).view(torch.int8).view(kp // 4, n, 4)
    assert int(b[0, 0, 1]) == int(wq[1, 0])


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
        n_words = -(-k // int8.K_PAD) * int8.K_PAD // 4 * n
        words = packed.qweights[q_off:q_off + n_words].view(-1, n)
        assert torch.equal(_unpack(words, k, n), wq)
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
    # f32 rows 16 x 1024, int8 rows 16 x 1024, 16 scales
    assert int8.smem_bytes(BUDE, 16) == 16 * 1024 * 4 + 16 * 1024 + 64
    assert int8.smem_bytes((4, 16, 2), 1) == 64 + 16 + 16
    assert registry.resolve_params(int8.SPEC, _problem(BUDE)) == \
        {"block_rows": 16}
    # width 8192: 8 rows take 320 KB, 4 rows 160 KB
    assert registry.resolve_params(int8.SPEC, _problem((6, 8192, 1))) == \
        {"block_rows": 4}
    assert registry.resolve_params(int8.SPEC, _problem(BUDE),
                                   {"block_rows": 32}) == {"block_rows": 32}
    assert registry.resolve_params_info(
        int8.SPEC, _problem((6, 8192, 1)), {"block_rows": 16}) == \
        ({"block_rows": 4}, "default:smem-fallback")
    assert int8.SPEC.supports(_problem(BUDE))
    assert not int8.SPEC.supports(_problem((6, 50000, 1)))
    assert not int8.SPEC.supports(_problem((6,) + (8,) * 17 + (1,)))
    assert not int8.SPEC.supports(dict(_problem(BUDE), dtype="bfloat16"))
    assert int8.SPEC.tier == "int8" and int8.SPEC.tol == (2e-2, 2e-2)
    assert fused_ops.SPEC.tier == "f32"
    names = [s.name for s in registry.all_specs()]
    assert names == ["flash_attention", "flash_attention_int8", "fused_mlp",
                     "fused_mlp_int8", "rwkv6_chunk", "stencil_gather"]


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
