"""Port parity: the fused-MLP plain version, stack adapter, registry
dispatch and shared-memory model against repro.kernels.fused_mlp."""
import os
import subprocess
import sys
import pathlib

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_mlp import ops as jops  # noqa: E402
from repro.kernels.fused_mlp.fused_mlp import fused_mlp as jax_fused_mlp  # noqa: E402
from repro.kernels.fused_mlp.ref import fused_mlp_ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build, registry  # noqa: E402
from repro_torch.kernels.registry import round_up  # noqa: E402
from repro_torch.kernels.fused_mlp import ops  # noqa: E402
from repro_torch.kernels.fused_mlp.fused_mlp import (fused_mlp,  # noqa: E402
                                                     pack_mlp, smem_bytes)
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _stack(widths, batch, seed=0):
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(a, b)) * 0.3).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.normal(size=(b,)) * 0.1).astype(np.float32)
          for b in widths[1:]]
    x = rng.normal(size=(batch, widths[0])).astype(np.float32)
    return x, ws, bs


# the grid of tests/test_kernels.py::test_fused_mlp_sweep, plus every act
@pytest.mark.parametrize("widths,acts", [
    ((8, 32, 1), ("relu", "identity")),
    ((6, 64, 16, 4), ("gelu", "tanh", "identity")),
    ((5, 128, 2), ("silu", "identity")),
    ((7, 24, 9, 3), ("sigmoid", "relu", "identity")),
])
@pytest.mark.parametrize("batch", [16, 37, 130])
def test_plain_version_matches_pallas_interpret_and_jax_ref(widths, acts,
                                                            batch):
    x, ws, bs = _stack(widths, batch)
    pallas = np.asarray(jax_fused_mlp(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs], acts, batch_tile=32, interpret=True))
    oracle = np.asarray(jax_ref(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                [jnp.asarray(b) for b in bs], acts))
    tw = [torch.from_numpy(w) for w in ws]
    tb = [torch.from_numpy(b) for b in bs]
    plain = fused_mlp_ref(torch.from_numpy(x), tw, tb, acts).numpy()
    op = ops.fused_mlp_op(torch.from_numpy(x), pack_mlp(tw, tb, acts)).numpy()
    np.testing.assert_array_equal(op, plain)
    np.testing.assert_allclose(plain, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain, oracle, rtol=2e-5, atol=2e-5)


def _spec(layers, in_shape):
    return {"in_shape": list(in_shape), "layers": layers}


@pytest.mark.parametrize("layers,in_shape", [
    ([{"kind": "dense", "features": 8}, {"kind": "act", "name": "relu"},
      {"kind": "dense", "features": 1}], (1, 5)),
    # flatten, a bias-free dense, dense followed directly by dense
    ([{"kind": "flatten"}, {"kind": "dense", "features": 8,
                            "use_bias": False},
      {"kind": "dense", "features": 6}, {"kind": "act", "name": "gelu"},
      {"kind": "dense", "features": 2}, {"kind": "act", "name": "tanh"}],
     (1, 3, 4)),
])
def test_mlp_stack_from_spec_matches_jax(layers, in_shape):
    rng = np.random.default_rng(1)
    spec = _spec(layers, in_shape)
    params, width = [], int(np.prod(in_shape[1:]))
    for layer in layers:
        p = {}
        if layer["kind"] == "dense":
            p["w"] = rng.normal(size=(width, layer["features"])).astype(
                np.float32)
            if layer.get("use_bias", True):
                p["b"] = rng.normal(size=layer["features"]).astype(np.float32)
            width = layer["features"]
        params.append(p)
    x = rng.normal(size=(4,) + tuple(in_shape[1:])).astype(np.float32)
    jx, jw, jb, jacts = jops.mlp_stack_from_spec(
        spec, [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        jnp.asarray(x))
    tx, tw, tb, tacts = ops.mlp_stack_from_spec(
        spec, [{k: torch.from_numpy(v) for k, v in p.items()}
               for p in params], torch.from_numpy(x))
    assert tacts == jacts
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for a, b in zip(tw + tb, jw + jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_dispatch_takes_plain_version_and_counts():
    registry.reset_counts()
    x, ws, bs = _stack((6, 16, 1), 9)
    packed = pack_mlp([torch.from_numpy(w) for w in ws],
                      [torch.from_numpy(b) for b in bs], ("relu", "identity"))
    y = ops.fused_mlp_op(torch.from_numpy(x), packed)
    assert y.shape == (9, 1)
    assert ops.SPEC.plain_calls == 1
    assert ops.SPEC.launches == 0
    # the kernel wrapper itself takes CUDA tensors only: no CPU fallback
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(torch.from_numpy(x), packed, block_rows=16)
    assert ops.SPEC.launches == 0


def test_pack_round_trips_weights_and_table():
    x, ws, bs = _stack((6, 16, 5, 1), 2)
    packed = pack_mlp([torch.from_numpy(w) for w in ws],
                      [torch.from_numpy(b) for b in bs],
                      ("relu", "gelu", "identity"))
    assert packed.widths == (6, 16, 5, 1)
    for a, b in zip(packed.weights + packed.biases, ws + bs):
        np.testing.assert_array_equal(a.numpy(), b)
    assert packed.table[:, 2].tolist() == [1, 2, 0]
    # each layer's weights once, in the kernel's layout: [in rounded to 8,
    # out rounded to 32 + 8], zero-padded, 32-byte aligned, then its bias
    blocks = [(8, 40), (16, 40), (8, 40)]
    assert packed.table[:, 3].tolist() == [0, 336, 984]
    assert packed.table[:, 4].tolist() == [320, 976, 1304]
    assert packed.params.numel() == 1305
    for (r, c), off, w in zip(blocks, packed.table[:, 3], ws):
        block = packed.params[off:off + r * c].view(r, c).numpy()
        np.testing.assert_array_equal(block[:w.shape[0], :w.shape[1]], w)
        assert not block[w.shape[0]:].any()
        assert not block[:, w.shape[1]:].any()
    # the weights are views into those blocks, not a second copy
    assert all(w.data_ptr() == packed.params[off:].data_ptr()
               for w, off in zip(packed.weights, packed.table[:, 3]))
    with pytest.raises(ValueError):
        pack_mlp([torch.zeros(3, 4), torch.zeros(5, 1)],
                 [torch.zeros(4), torch.zeros(1)], ("relu", "identity"))


def _problem(widths, n_layers=None):
    acts = ("relu",) * (n_layers or len(widths) - 1)
    return {"widths": tuple(widths), "acts": acts, "batch": 256, "ndim": 2,
            "dtype": "float32"}


def test_shared_memory_model():
    bude = (6, 1024, 819, 655, 524, 419, 335, 1)
    # one activation buffer (rows of 1024 + 4 words), three 8-row weight
    # tiles (rows of 1024 + 8 words), 1 KB of barriers and table
    assert smem_bytes(bude, 16) == 4 * (16 * 1028 + 3 * 8 * 1032) + 1024
    assert smem_bytes(bude, 32) == 4 * (32 * 1028 + 3 * 8 * 1032) + 1024
    assert smem_bytes(bude, 32) <= 232_448
    assert smem_bytes((6, 130, 17, 3), 32) == \
        4 * (32 * 164 + 3 * 8 * 168) + 1024
    # 1 to 8 rows: two activation buffers, rows of the widest layer
    # rounded up to the k-step of 8
    assert smem_bytes(bude, 8) == 2 * 8 * 1024 * 4
    assert smem_bytes((6, 130, 17, 3), 1) == 2 * 136 * 4
    assert registry.resolve_params(ops.SPEC, _problem(bude)) == \
        {"block_rows": 32}
    # a 1,500-wide input: 32 rows would take 292 KB, over the 227 KB a
    # block has
    assert registry.resolve_params(ops.SPEC, _problem((1500, 1024, 1))) == \
        {"block_rows": 16}
    # width 4096: past 1,024 for 16 and 32 rows, and 8 rows would take
    # 256 KB
    assert registry.resolve_params(ops.SPEC, _problem((6, 4096, 1))) == \
        {"block_rows": 4}
    # an explicit tile that overflows this card serves the fitting
    # defaults, and says so in its provenance
    assert registry.resolve_params_info(
        ops.SPEC, _problem((1500, 1024, 1)), {"block_rows": 32}) == \
        ({"block_rows": 16}, "default:smem-fallback")
    assert registry.resolve_params_info(
        ops.SPEC, _problem((6, 4096, 1)), {"block_rows": 16}) == \
        ({"block_rows": 4}, "default:smem-fallback")
    assert ops.SPEC.supports(_problem(bude))
    assert ops.SPEC.supports(_problem((6, 1024, 1024, 1)))
    assert ops.SPEC.supports(_problem((6, 1025, 1)))
    assert ops.SPEC.supports(_problem((6, 4096, 1)))
    # the domain of the CUDA-core kernel this one replaced, exactly: one
    # row's two buffers of the widest layer rounded to 4 floats fit 227 KB
    for w in (1, 7, 1023, 1025, 4096, 29_052, 29_053, 29_056, 29_057,
              29_060, 30_000):
        old = 2 * round_up(w, 4) * 4 <= 232_448
        assert ops.SPEC.supports(_problem((6, w, 1))) == old, w
        assert ops.SPEC.supports(_problem((w, 64, 1))) == old, w
    assert ops.SPEC.supports(_problem((6, 29_056, 1)))
    assert not ops.SPEC.supports(_problem((6, 30000, 1)))
    assert not ops.SPEC.supports(_problem((6,) + (8,) * 17 + (1,)))
    assert not ops.SPEC.supports(dict(_problem(bude), dtype="bfloat16"))
    assert not ops.SPEC.supports(dict(_problem(bude), ndim=3))


def test_kernel_modules_import_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=str(ROOT / "src"))
    code = ("import torch\n"
            "from repro_torch.kernels import _build\n"
            "from repro_torch.kernels.fused_mlp import ops\n"
            "from repro_torch.kernels.fused_mlp.fused_mlp import pack_mlp\n"
            "p = pack_mlp([torch.ones(3, 2)], [torch.zeros(2)], ['relu'])\n"
            "y = ops.fused_mlp_op(torch.ones(4, 3), p)\n"
            "assert y.tolist() == [[3.0, 3.0]] * 4\n"
            "assert _build._built == {}\n")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header names a new library: a source that includes it
    (directly or through another header) is rebuilt, not reused stale."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "k" / "csrc").mkdir(parents=True)
    top = tmp_path / "csrc" / "top.cuh"
    inner = tmp_path / "csrc" / "inner.cuh"
    src = tmp_path / "k" / "csrc" / "k.cu"
    top.write_text('#pragma once\n#include "inner.cuh"\n')
    inner.write_text("#define X 1\n")
    src.write_text('#include <cstdint>\n#include "../../csrc/top.cuh"\n')
    assert _build.includes(src) == [top.resolve(), inner.resolve()]
    before = _build._target(src)
    assert before.parent == tmp_path / "build"
    assert before.name.startswith("k-") and before.suffix == ".so"
    assert _build._target(src) == before
    inner.write_text("#define X 2\n")
    after = _build._target(src)
    assert after != before
    top.write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    assert _build._target(src) not in (before, after)
    # the port's two tensor-core kernels share the 3xTF32 header
    shared = _build.KERNELS_DIR / "csrc" / "tf32x3.cuh"
    for name in ("fused_mlp", "flash_attention"):
        assert _build.includes(_build.sources()[name]) == [shared]


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    assert set(_build.sources()) == {"flash_attention", "flash_attention_bf16",
                                     "flash_attention_bwd",
                                     "flash_attention_int8",
                                     "fused_mlp", "fused_mlp_int8",
                                     "mamba_scan", "rwkv6_chunk",
                                     "stencil_gather"}


# ------------------------------------------------------ 3xTF32 numerics ---
# A CPU emulation of what csrc/fused_mlp.cu computes on the tensor cores,
# to predict the tolerance before any chip run.

def tf32_rna(x):
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: the magnitude
    rounded half away from zero at bit 13, the low 13 bits cleared (inf
    and nan pass through)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    special = (u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    r = np.where(special, u, r | (u & np.uint32(0x80000000)))
    return r.astype(np.uint32).view(np.float32)


def tf32_split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna((np.asarray(x, np.float32) - hi).astype(np.float32))


def mma_accumulate(acc, x, y, guard):
    """One k-step's mma, ``acc + x @ y`` ([M, N] f32, [M, 8], [8, N]
    TF32).  ``guard=None``: the exact sum rounded to nearest.  Else the
    tensor core's accumulation as Fasi et al. (PeerJ Comput. Sci. 7:e330,
    2021) found it on A100: the accumulator and the eight exact products
    aligned to the largest exponent among them and truncated ``guard``
    bits past f32's 24, summed, and the sum truncated to f32."""
    if guard is None:
        return (acc + x.astype(np.float64) @ y.astype(np.float64)
                ).astype(np.float32)
    terms = np.concatenate(
        [acc.astype(np.float64)[..., None],
         x.astype(np.float64)[:, None, :] * y.T.astype(np.float64)[None]],
        -1)
    _, e = np.frexp(np.abs(terms).max(-1, keepdims=True))
    ulp = np.ldexp(1.0, e - 24 - guard)
    total = (np.trunc(terms / ulp) * ulp).sum(-1)
    _, e = np.frexp(total)
    ulp = np.ldexp(1.0, e - 24)
    return (np.trunc(total / ulp) * ulp).astype(np.float32)


def mma_matmul(a, b, passes=3, guard=None, partials=True):
    """``a @ b`` as the kernel forms it: k-steps of 8 (K zero-padded),
    each forming the TF32 products lo.hi, hi.lo, hi.hi in that order
    (``passes=1``: hi.hi alone, a single-pass TF32 kernel) as mma
    accumulated as :func:`mma_accumulate` says: into a partial that
    starts at zero and is then added to the f32 accumulator rounded to
    nearest (``partials``, the kernel), or straight into the accumulator
    (the kernel's first design)."""
    k = a.shape[1]
    a = np.pad(a, ((0, 0), (0, -k % 8)))
    b = np.pad(b, ((0, -k % 8), (0, 0)))
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
    terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))[3 - passes:]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        part = np.zeros_like(acc) if partials else acc
        for x, y in terms:
            part = mma_accumulate(part, x[:, k0:k0 + 8], y[k0:k0 + 8], guard)
        acc = (acc + part).astype(np.float32) if partials else part
    return acc


def test_tf32_split_reconstructs_f32():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-30, 30, 100_000)).astype(np.float32)
    hi, lo = tf32_split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                 - lo.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()
    # round half away from zero at bit 13: 1 + 2^-11 is a tie
    tie = np.float32(1 + 2.0 ** -11)
    assert tf32_rna(np.array([tie, -tie, np.nextafter(tie, np.float32(0))],
                             np.float32)).tolist() == \
        [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    assert np.isinf(tf32_rna(np.array([np.inf], np.float32))).all()


def test_3xtf32_minibude_net_within_tolerance_1xtf32_not():
    """The widest minibude net at 256 rows (He-normal weights, as
    chip_smoke.py draws them): the 3xTF32 products stay inside the
    kernel's 1e-4 of the f32 plain version; single-pass TF32 does not."""
    widths = (6, 1024, 819, 655, 524, 419, 335, 1)
    acts = ("relu",) * 6 + ("identity",)
    rng = np.random.default_rng(7)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.standard_normal(b) * 0.1).astype(np.float32)
          for b in widths[1:]]
    x = rng.standard_normal((256, 6)).astype(np.float32)
    want = fused_mlp_ref(torch.from_numpy(x),
                         [torch.from_numpy(w) for w in ws],
                         [torch.from_numpy(b) for b in bs], acts).numpy()
    rtol, atol = ops.SPEC.tol

    def emulate(passes):
        h = x
        for w, b, a in zip(ws, bs, acts):
            h = mma_matmul(h, w, passes) + b
            h = np.maximum(h, 0) if a == "relu" else h
        return h

    def worst(got):
        return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))
    assert worst(emulate(3)) < 0.1
    assert worst(emulate(1)) > 1.0


def _he_net(widths, seed):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.standard_normal(b) * 0.1).astype(np.float32)
          for b in widths[1:]]
    return ws, bs


@pytest.mark.parametrize("case", ["minibude", "wide_k"])
def test_3xtf32_truncating_accumulation_predicts_the_cards_error(case):
    """The tensor core's truncating accumulation (3 guard bits, the
    model chip_smoke.py's probe holds the card to) on two inputs the card
    ran: chip_smoke.py's minibude check (weights of seed 8, the first 37
    rows of seed 1) and the K 29,056 case of tests/test_torch_cuda.py
    (one row).  Chaining every mma into the accumulator, the kernel's
    first design, gives the error the card showed then (3.6e-5 and
    6.8e-4, NVIDIA H100 80GB HBM3, 700 W): five times the exact sums' at
    the minibude widths, past the 1e-4 tolerance at K 29,056.  Summing
    each K-step into a partial added rounded to nearest, as the kernel
    now does, keeps both under 1e-5."""
    if case == "minibude":
        widths = (6, 1024, 819, 655, 524, 419, 335, 1)
        acts = ("relu",) * 6 + ("identity",)
        ws, bs = _he_net(widths, len(widths))
        x = np.random.default_rng(1).standard_normal(
            (65536, 6)).astype(np.float32)[:37]
    else:
        widths, acts = (5, 29056, 3), ("relu", "identity")
        ws, bs = _he_net(widths, 1)
        x = np.random.default_rng(4).standard_normal((1, 5)).astype(
            np.float32)
    want = fused_mlp_ref(torch.from_numpy(x),
                         [torch.from_numpy(w) for w in ws],
                         [torch.from_numpy(b) for b in bs], acts).numpy()
    rtol, atol = ops.SPEC.tol

    def emulate(guard, partials):
        h = x
        for w, b, a in zip(ws, bs, acts):
            h = mma_matmul(h, w, 3, guard, partials) + b
            h = np.maximum(h, 0) if a == "relu" else h
        err = np.abs(h - want)
        return err.max(), (err / (atol + rtol * np.abs(want))).max()
    chained, chained_worst = emulate(3, False)
    kernel, kernel_worst = emulate(3, True)
    if case == "minibude":
        exact, _ = emulate(None, False)
        assert 3 * exact < chained < atol and chained_worst < 1.0
    else:
        assert chained > 5 * atol and chained_worst > 1.0
    assert kernel < 1e-5 and kernel_worst < 0.1


def test_mma_accumulate_models():
    """The truncating model on single sums: a product of 0.75 ulp is
    dropped (rounded to nearest it would count), eight of a quarter ulp
    count only with guard bits."""
    one = np.ones((1, 1), np.float32)
    x = np.zeros((1, 8), np.float32)
    y = np.zeros((8, 1), np.float32)
    x[0, 0], y[0, 0] = 1.5 * 2.0 ** -24, 1.0
    assert mma_accumulate(one, x, y, None)[0, 0] == 1 + 2.0 ** -23
    assert mma_accumulate(one, x, y, 3)[0, 0] == 1.0
    x[0], y[:, 0] = 2.0 ** -25, 1.0
    assert mma_accumulate(one, x, y, None)[0, 0] == 1 + 2.0 ** -22
    assert mma_accumulate(one, x, y, 0)[0, 0] == 1.0
    assert mma_accumulate(one, x, y, 3)[0, 0] == 1 + 2.0 ** -22
    assert mma_accumulate(-one, -x, y, 3)[0, 0] == -(1 + 2.0 ** -22)
