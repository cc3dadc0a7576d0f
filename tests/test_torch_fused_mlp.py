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
    assert packed.params.numel() == sum(w.size + b.size for w, b in
                                        zip(ws, bs))
    for a, b in zip(packed.weights + packed.biases, ws + bs):
        np.testing.assert_array_equal(a.numpy(), b)
    assert packed.table[:, 2].tolist() == [1, 2, 0]
    with pytest.raises(ValueError):
        pack_mlp([torch.zeros(3, 4), torch.zeros(5, 1)],
                 [torch.zeros(4), torch.zeros(1)], ("relu", "identity"))


def _problem(widths, n_layers=None):
    acts = ("relu",) * (n_layers or len(widths) - 1)
    return {"widths": tuple(widths), "acts": acts, "batch": 256, "ndim": 2,
            "dtype": "float32"}


def test_shared_memory_model():
    bude = (6, 1024, 819, 655, 524, 419, 335, 1)
    assert smem_bytes(bude, 16) == 2 * 16 * 1024 * 4
    assert registry.resolve_params(ops.SPEC, _problem(bude)) == \
        {"block_rows": 16}
    # width 4096: 8 rows would take 256 KB, over the 227 KB a block has
    assert registry.resolve_params(ops.SPEC, _problem((6, 4096, 1))) == \
        {"block_rows": 4}
    # an explicit tile that overflows this card serves the fitting
    # defaults, and says so in its provenance
    assert registry.resolve_params_info(
        ops.SPEC, _problem((6, 4096, 1)), {"block_rows": 16}) == \
        ({"block_rows": 4}, "default:smem-fallback")
    assert ops.SPEC.supports(_problem(bude))
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


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    assert set(_build.sources()) == {"flash_attention", "flash_attention_int8",
                                     "fused_mlp", "fused_mlp_int8",
                                     "rwkv6_chunk", "stencil_gather"}
