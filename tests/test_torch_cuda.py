"""The hand-written CUDA kernel against its plain version, on the card.

Marked ``cuda``: every test decides inside itself whether a card is
present and skips where there is none, so all pytest-xdist workers
collect the same tests.  Run on a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    return resolve_device(None)


def _packed(widths, acts, dev, seed=0):
    from repro_torch.kernels.fused_mlp.fused_mlp import pack_mlp
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
                           .astype(np.float32))
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.from_numpy((rng.standard_normal(b) * 0.1).astype(np.float32))
          for b in widths[1:]]
    return pack_mlp(ws, bs, acts, device=dev)


@pytest.mark.parametrize("widths,acts", [
    ((6, 64, 33, 1), ("relu", "relu", "identity")),
    ((5, 130, 17, 3), ("gelu", "tanh", "identity")),
    ((7, 40, 9, 2), ("silu", "sigmoid", "identity")),
])
@pytest.mark.parametrize("batch", [1, 37, 300])
def test_kernel_matches_plain_version(dev, widths, acts, batch):
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    packed = _packed(widths, acts, dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, widths[0])).astype(np.float32)).to(dev)
    before = ops.SPEC.launches
    got = ops.fused_mlp_op(x, packed)
    want = fused_mlp_ref(x, packed.weights, packed.biases, acts)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == before + 1
    rtol, atol = ops.SPEC.tol
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_rows_bit_identical_across_batch_and_block_rows(dev):
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp
    packed = _packed((6, 96, 50, 1), ("relu", "relu", "identity"), dev)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 6)).astype(np.float32)).to(dev)
    alone = ops.fused_mlp_op(x[:37].contiguous(), packed)
    padded = ops.fused_mlp_op(x, packed)[:37]
    assert torch.equal(alone, padded)
    for rows in (1, 2, 4, 8, 16):
        assert torch.equal(alone, fused_mlp(x[:37].contiguous(), packed,
                                            block_rows=rows))


def test_engine_routes_pure_mlp_to_kernel(dev, tmp_path):
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.nn import MLP, save_model
    path = save_model(tmp_path / "b", MLP((1, 6), [32, 16], 1).init(0))
    eng = InferenceEngine.get(path)
    assert eng.route == "fused_mlp"
    before = ops.SPEC.launches
    x = torch.randn(40, 6, device=dev)
    y = eng(x)
    assert ops.SPEC.launches == before + 1
    torch.testing.assert_close(y, eng.net(x), rtol=1e-4, atol=1e-4)
    assert torch.equal(eng.apply_batched(x), y)
    wide = save_model(tmp_path / "w", MLP((1, 6), [30000], 1))
    unsupported = ops.SPEC.unsupported
    assert InferenceEngine.get(wide).route == "sequential"
    assert ops.SPEC.unsupported == unsupported + 1
