"""The hand-written CUDA kernels against their plain versions, on the card.

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


def _qpacked(widths, acts, dev, seed=0):
    from repro_torch.kernels.fused_mlp.int8 import pack_int8_mlp
    from repro_torch.quant.quantize import quantize_params
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.standard_normal(b) * 0.1).astype(np.float32)
          for b in widths[1:]]
    return pack_int8_mlp(quantize_params(ws, bs, device=dev), acts)


@pytest.mark.parametrize("widths,acts", [
    ((6, 64, 33, 1), ("relu", "relu", "identity")),
    ((5, 130, 17, 3), ("gelu", "tanh", "identity")),
    ((7, 40, 9, 2), ("silu", "sigmoid", "identity")),
])
@pytest.mark.parametrize("batch", [1, 300])
def test_int8_kernel_matches_plain_version(dev, widths, acts, batch):
    from repro_torch.kernels.fused_mlp import int8
    from repro_torch.quant.quantize import quant_mlp_ref
    packed = _qpacked(widths, acts, dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, widths[0])).astype(np.float32)).to(dev)
    before = int8.SPEC.launches
    got = int8.fused_mlp_int8_op(x, packed)
    want = quant_mlp_ref(x, packed.qlayers, acts)
    torch.cuda.synchronize()
    assert int8.SPEC.launches == before + 1
    rtol, atol = int8.SPEC.tol
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if set(acts) <= {"relu", "identity"}:
        assert torch.equal(got, want)


def test_int8_rows_bit_identical_across_batch_and_block_rows(dev):
    from repro_torch.kernels.fused_mlp import int8
    packed = _qpacked((6, 96, 50, 1), ("relu", "gelu", "identity"), dev)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 6)).astype(np.float32)).to(dev)
    alone = int8.fused_mlp_int8_op(x[:37].contiguous(), packed)
    padded = int8.fused_mlp_int8_op(x, packed)[:37]
    assert torch.equal(alone, padded)
    for rows in int8.BLOCK_ROWS:
        assert torch.equal(alone, int8.fused_mlp_int8(
            x[:37].contiguous(), packed, block_rows=rows))


def test_int8_wrapper_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels.fused_mlp import int8
    packed = _qpacked((6, 16, 1), ("relu", "identity"), dev)
    before = int8.SPEC.launches
    with pytest.raises(ValueError, match="CUDA"):
        int8.fused_mlp_int8(torch.zeros(4, 6), packed, block_rows=16)
    with pytest.raises(ValueError, match="f32"):
        int8.fused_mlp_int8(torch.zeros(4, 6, device=dev,
                                        dtype=torch.float64),
                            packed, block_rows=16)
    with pytest.raises(ValueError, match="f32"):
        int8.fused_mlp_int8(torch.zeros(4, 5, device=dev), packed,
                            block_rows=16)
    with pytest.raises(ValueError, match="block_rows"):
        int8.fused_mlp_int8(torch.zeros(4, 6, device=dev), packed,
                            block_rows=3)
    assert int8.SPEC.launches == before


def test_engine_int8_route_launches_kernel(dev, tmp_path, monkeypatch):
    import repro_torch.tune.cache as tcache
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels.fused_mlp import int8
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.nn import MLP, save_model
    from repro_torch.quant.budgets import clear_budgets
    from repro_torch.quant.gate import gate_bundle
    from repro_torch.quant.quantize import quant_mlp_ref
    monkeypatch.setattr(tcache, "_default", {"quant_gate": tcache.TuneCache(
        "quant_gate", path=tmp_path / "gate.json")})
    monkeypatch.delenv("REPRO_QUANT", raising=False)
    path = save_model(tmp_path / "b", MLP((1, 6), [64, 32], 1).init(0))
    rows = np.random.default_rng(3).standard_normal((256, 6)).astype(
        np.float32)
    try:
        assert gate_bundle(path, rows, budget=1.0)["exact"]
        eng = InferenceEngine.get(path)
        assert (eng.tier, eng.route) == ("int8", "fused_mlp_int8")
        x = torch.randn(40, 6, device=dev)
        q, f = int8.SPEC.launches, ops.SPEC.launches
        y = eng(x)
        torch.cuda.synchronize()
        assert int8.SPEC.launches == q + 1 and ops.SPEC.launches == f
        assert torch.equal(y, quant_mlp_ref(x, eng._packed.qlayers,
                                            eng._packed.acts))
        assert torch.equal(eng.apply_batched(x), y)
        # the fail drill: a mis-scaled gate serves f32 through fused_mlp
        assert not gate_bundle(path, rows, budget=1e-9,
                               scale_mult=64.0)["exact"]
        eng = InferenceEngine.get(path)
        assert (eng.tier, eng.route) == ("f32", "fused_mlp")
        eng(x)
        assert ops.SPEC.launches == f + 1
    finally:
        InferenceEngine.invalidate()
        clear_budgets()
