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


@pytest.mark.parametrize("widths,acts", [
    # minibude-wide: 16-byte (1024) and 4-byte (819, 655) weight copies
    ((6, 1024, 819, 655, 1), ("relu", "relu", "relu", "identity")),
    # widths off the n8 tile, every activation
    ((6, 100, 36, 13, 1), ("gelu", "tanh", "silu", "sigmoid")),
    ((3, 8, 1), ("identity", "relu")),
    # past 1,024 wide: 1 to 8 rows only, three column passes
    ((6, 2100, 1100, 3), ("relu", "tanh", "identity")),
    # the widest one row's two buffers hold (exactly 227 KB)
    ((5, 29056, 3), ("relu", "identity")),
])
@pytest.mark.parametrize("batch", [1, 37, 300])
def test_kernel_matches_plain_version_at_every_block_rows(dev, widths, acts,
                                                          batch):
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import (BLOCK_ROWS,
                                                         fits_smem, fused_mlp)
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    packed = _packed(widths, acts, dev, seed=batch)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (batch, widths[0])).astype(np.float32)).to(dev)
    want = fused_mlp_ref(x, packed.weights, packed.biases, acts)
    rtol, atol = ops.SPEC.tol
    tiles = [r for r in BLOCK_ROWS if fits_smem(widths, r)]
    assert tiles and ops.SPEC.supports(ops.inspect_call(x, packed))
    for rows in tiles:
        got = fused_mlp(x, packed, block_rows=rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"block_rows {rows}: {m}")


def test_rows_bit_identical_across_batch_and_block_rows(dev):
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import BLOCK_ROWS, fused_mlp
    packed = _packed((6, 96, 50, 1), ("relu", "relu", "identity"), dev)
    # 64 rows run as clusters of blocks sharing the columns, 8,192 rows as
    # single blocks: the rows agree bit for bit all the same
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8192, 6)).astype(np.float32)).to(dev)
    alone = ops.fused_mlp_op(x[:37].contiguous(), packed)
    padded = ops.fused_mlp_op(x[:64].contiguous(), packed)[:37]
    assert torch.equal(alone, padded)
    for rows in BLOCK_ROWS:
        assert torch.equal(alone, fused_mlp(x[:37].contiguous(), packed,
                                            block_rows=rows))
        assert torch.equal(alone, fused_mlp(x, packed, block_rows=rows)[:37])
    # past 1,024 wide (1 to 8 rows, column passes)
    wide = _packed((6, 1300, 40, 1), ("relu", "relu", "identity"), dev)
    alone = ops.fused_mlp_op(x[:37].contiguous(), wide)
    for rows in (1, 2, 4, 8):
        assert torch.equal(alone, fused_mlp(x[:37].contiguous(), wide,
                                            block_rows=rows))
        assert torch.equal(alone, fused_mlp(x[:300].contiguous(), wide,
                                            block_rows=rows)[:37])


@pytest.mark.parametrize("hidden", [[32, 16], [4096]])
def test_engine_routes_pure_mlp_to_kernel(dev, tmp_path, hidden):
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.nn import MLP, save_model
    path = save_model(tmp_path / "b", MLP((1, 6), hidden, 1).init(0))
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


# one epoch of fit on the card against the CPU, the tolerance chip_smoke.py
# states and reasons for (TRAIN_PARAM_TOL, TRAIN_RMSE_RTOL): Adam's
# normalized step carries rounding differences forward, so the parameters
# are held by their L2 distance over their distance from the init
TRAIN_PARAM_TOL, TRAIN_RMSE_RTOL = 0.4, 0.02


def _train_rows(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + X[:, 1:2] * X[:, 2:3]).astype(np.float32)
    return X, Y


def _distance(a, b):
    return float(torch.sqrt(sum(((x[k].double().cpu() - y[k].double().cpu())
                                 ** 2).sum() for x, y in zip(a, b)
                                for k in x)))


def test_fit_one_epoch_on_the_card_against_the_cpu(dev):
    from repro_torch.nas.train_surrogate import fit
    from repro_torch.nn import MLP
    X, Y = _train_rows()
    p_card, r_card, s_card = fit(MLP((1, 5), [64, 64], 1), X, Y, epochs=1,
                                 device=dev)
    p_cpu, r_cpu, s_cpu = fit(MLP((1, 5), [64, 64], 1), X, Y, epochs=1,
                              device="cpu")
    assert s_card == s_cpu
    assert all(t.device.type == "cuda" for layer in p_card
               for t in layer.values())
    init = MLP((1, 5), [64, 64], 1).init(0).param_list()
    assert _distance(p_card, p_cpu) <= \
        TRAIN_PARAM_TOL * _distance(p_cpu, init)
    assert abs(r_card / r_cpu - 1) <= TRAIN_RMSE_RTOL


def test_port_trained_mlp_is_served_through_fused_mlp(dev, tmp_path):
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.nas.train_surrogate import fit
    from repro_torch.nn import MLP, save_model
    X, Y = _train_rows()
    net = MLP((1, 5), [64, 32], 1)
    _, _, stats = fit(net, X, Y, epochs=2, device=dev)
    path = save_model(tmp_path / "trained", net, extra=stats)
    eng = InferenceEngine.get(path)
    assert eng.route == "fused_mlp"
    x = torch.from_numpy(X[:300]).to(dev)
    before = ops.SPEC.launches
    y = eng(x)
    assert ops.SPEC.launches == before + 1
    with torch.no_grad():
        xn = (x - eng.norm[0]) / eng.norm[1]
        want = net(xn) * eng.norm[3] + eng.norm[2]
    rtol, atol = ops.SPEC.tol
    torch.testing.assert_close(y, want, rtol=rtol,
                               atol=atol * float(eng.norm[3].max()))


def test_latency_on_the_card_is_a_positive_median(dev):
    from repro_torch.nas.train_surrogate import latency
    from repro_torch.nn import MLP
    net = MLP((1, 6), [1024, 512], 1).init(0).to(dev)
    assert latency(net, (256, 6), reps=5, device=dev) > 0


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


@pytest.mark.parametrize("widths,acts", [
    ((6, 96, 50, 1), ("relu", "gelu", "identity")),
    ((5, 130, 17, 3), ("gelu", "tanh", "identity")),
    ((6, 8192, 1), ("relu", "identity")),   # the rows path only
])
def test_int8_rows_bit_identical_across_batch_and_block_rows(dev, widths,
                                                            acts):
    """A row's bits do not depend on the batch, the padding, the path or
    ``block_rows``."""
    from repro_torch.kernels.fused_mlp import int8
    packed = _qpacked(widths, acts, dev)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, widths[0])).astype(np.float32)).to(dev)
    alone = int8.fused_mlp_int8_op(x[:37].contiguous(), packed)
    padded = int8.fused_mlp_int8_op(x, packed)[:37]
    assert torch.equal(alone, padded)
    launched = [rows for rows in int8.BLOCK_ROWS
                if int8.fits_smem(widths, rows)]
    for rows in launched:
        assert torch.equal(alone, int8.fused_mlp_int8(
            x[:37].contiguous(), packed, block_rows=rows)), rows
    mma = [r for r in launched if r in int8.MMA_BLOCK_ROWS]
    assert bool(mma) == (max(widths[1:]) <= int8.mma_max_out(16))


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


def test_engine_int8_route_launches_kernel_on_a_wide_bundle(dev, tmp_path,
                                                           monkeypatch):
    """A (6, 8192, 1) bundle, past every mma block's accumulators, is
    still served by the int8 kernel (rows path), bit for bit."""
    import repro_torch.tune.cache as tcache
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import int8
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.nn import MLP, save_model
    from repro_torch.quant.budgets import clear_budgets
    from repro_torch.quant.gate import gate_bundle
    from repro_torch.quant.quantize import quant_mlp_ref
    monkeypatch.setattr(tcache, "_default", {"quant_gate": tcache.TuneCache(
        "quant_gate", path=tmp_path / "gate.json")})
    monkeypatch.delenv("REPRO_QUANT", raising=False)
    path = save_model(tmp_path / "b", MLP((1, 6), [8192], 1).init(0))
    rows = np.random.default_rng(4).standard_normal((256, 6)).astype(
        np.float32)
    try:
        assert gate_bundle(path, rows, budget=1.0)["exact"]
        eng = InferenceEngine.get(path)
        assert (eng.tier, eng.route) == ("int8", "fused_mlp_int8")
        assert eng._packed.widths == (6, 8192, 1)
        x = torch.randn(300, 6, device=dev)
        assert registry.resolve_params(
            int8.SPEC, int8.inspect_call(x, eng._packed)) == \
            {"block_rows": 4}
        q, f = int8.SPEC.launches, ops.SPEC.launches
        y = eng(x)
        torch.cuda.synchronize()
        assert int8.SPEC.launches == q + 1 and ops.SPEC.launches == f
        assert torch.equal(y, quant_mlp_ref(x, eng._packed.qlayers,
                                            eng._packed.acts))
    finally:
        InferenceEngine.invalidate()
        clear_budgets()


# ------------------------------------------- the tune path's kernels ------
FIVE = ((0, 1), (2, 0), (1, 1), (0, 0), (1, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,out_h,out_w,origin,tile", [
    (512, 512, 508, 508, (1, 1), (8, 128)),
    (512, 512, 508, 508, (1, 1), (64, 512)),
    (101, 77, 97, 73, (1, 1), (16, 256)),
    (9, 9, 1, 1, (3, 2), (8, 128)),
])
def test_stencil_gather_kernel_matches_plain_version(dev, dtype, h, w, out_h,
                                                     out_w, origin, tile):
    from repro_torch.kernels.stencil_gather import ops
    from repro_torch.kernels.stencil_gather.ref import stencil_gather_ref
    from repro_torch.kernels.stencil_gather.stencil_gather import (
        stencil_gather)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (h, w)).astype(np.float32)).to(dev, getattr(torch, dtype))
    before = ops.SPEC.launches
    got = stencil_gather(x, FIVE, out_h, out_w, origin=origin,
                         block_h=tile[0], block_w=tile[1])
    torch.cuda.synchronize()
    assert ops.SPEC.launches == before + 1
    assert torch.equal(got, stencil_gather_ref(x, FIVE, out_h, out_w,
                                               origin=origin))
    with pytest.raises(ValueError):
        stencil_gather(x, ((0, 0), (h, 0)), out_h, out_w, block_h=8,
                       block_w=128)


def _attn(shape, dev, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    b, sq, skv, h, kv, hd = shape

    def t(*dims):
        return torch.from_numpy(rng.standard_normal(dims).astype(
            np.float32)).to(dev, dtype)
    return t(b, sq, h, hd), t(b, skv, kv, hd), t(b, skv, kv, hd)


@pytest.mark.parametrize("shape,kw", [
    ((1, 256, 256, 8, 2, 64), {}),                     # the default prefill
    ((4, 32, 512, 8, 2, 64), {"q_offset": 480}),       # the default decode
    ((2, 37, 101, 6, 2, 40), {"causal": False}),       # ragged, group 3
    ((1, 20, 50, 4, 4, 16), {"kv_valid_len": 0}),      # group 1
    ((1, 20, 50, 3, 1, 96), {"kv_valid_len": 7, "causal": False}),
    ((1, 300, 300, 2, 2, 64), {}),
    ((1, 77, 133, 6, 2, 100), {"kv_valid_len": 90}),   # hd 100, partial
    ((1, 150, 201, 3, 1, 128), {"q_offset": 17}),      # hd 128, group 3
    ((2, 65, 129, 4, 4, 32), {}),                      # hd 32, group 1
    ((1, 40, 70, 2, 1, 7), {}),                        # hd 7: plain copies
    ((1, 64, 100, 2, 2, 128), {"kv_valid_len": 0}),
    ((1, 50, 60, 2, 2, 64), {"q_offset": -20}),        # rows that see no key
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_version(dev, shape, kw, dtype):
    """Every tile of the ladders that fits, against the plain version."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        BLOCK_KV, BLOCK_Q, fits, flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _attn(shape, dev, dtype=getattr(torch, dtype))
    want = flash_attention_ref(q, k, v, **kw)
    rtol, atol = ops.TOL
    tiles = [(bq, bkv) for bq in BLOCK_Q for bkv in BLOCK_KV
             if fits(shape[-1], bq, bkv, dtype == "bfloat16")]
    assert len(tiles) >= 2
    for bq, bkv in tiles:
        before = ops.SPEC.launches
        got = flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
        torch.cuda.synchronize()
        assert ops.SPEC.launches == before + 1 and got.dtype == q.dtype
        # bf16 outputs: one rounding of f32 results, at most one ulp apart
        torch.testing.assert_close(
            got.float(), want.float(), atol=atol,
            rtol=rtol if dtype == "float32" else 2 ** -7,
            msg=lambda m: f"tile {bq}x{bkv}: {m}")


@pytest.mark.parametrize("shape,kw", [
    ((4, 32, 1024, 6, 2, 128), {"q_offset": 992}),     # decode window / 8
    ((4, 32, 512, 8, 2, 64), {"q_offset": 480}),       # the default decode
    ((2, 37, 101, 4, 4, 64), {"causal": False}),       # group 1, ragged
    ((1, 20, 777, 8, 2, 36), {"q_offset": 757}),       # group 4, hd 36
    ((2, 1, 4099, 6, 2, 128), {"q_offset": 4098}),     # Sq 1, Skv 4,099
    ((1, 50, 300, 3, 1, 4), {"q_offset": -20}),        # hd 4, rows see none
    ((1, 24, 500, 4, 1, 64), {"kv_valid_len": 0}),
    ((2, 40, 1000, 6, 2, 128), {"kv_valid_len": 333, "q_offset": 960}),
    ((1, 16, 300, 16, 1, 32), {"causal": False, "kv_valid_len": 150}),
    ((1, 300, 300, 24, 8, 128), {}),                   # q tiles and slices
])
def test_flash_attention_int8_kernel_matches_plain_version(dev, shape, kw):
    """Every tile of the ladders (all fit), against the plain version:
    scores bit-equal, so the difference is the softmax's f32 rounding;
    a second launch equals the first bit for bit."""
    from repro_torch.kernels.flash_attention import int8
    from repro_torch.quant.quantize import quantize_kv
    q, k, v = _attn(shape, dev, seed=1)
    arrays = (q,) + quantize_kv(k, v)
    want = int8.flash_attention_int8_ref(*arrays, **kw)
    rtol, atol = int8.TOL
    tiles = [(bq, bkv) for bq in int8.LADDER for bkv in int8.LADDER
             if int8.fits(shape[-1], bq, bkv)]
    assert len(tiles) == 25
    for bq, bkv in tiles:
        before = int8.SPEC.launches
        got = int8.flash_attention_int8(*arrays, block_q=bq, block_kv=bkv,
                                        **kw)
        again = int8.flash_attention_int8(*arrays, block_q=bq, block_kv=bkv,
                                          **kw)
        torch.cuda.synchronize()
        assert int8.SPEC.launches == before + 2
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"tile {bq}x{bkv}: {m}")
        # the scores are equal bit for bit: only the softmax's sums differ
        assert (got - want).abs().max().item() < 1e-5, f"tile {bq}x{bkv}"
        assert torch.equal(got, again), f"tile {bq}x{bkv}: launches differ"


@pytest.mark.parametrize("splits", [1, 2, 5, 32])
def test_flash_attention_int8_any_split_count(dev, monkeypatch, splits):
    """Split counts past the one split_count picks: a causal prefill whose
    early q tiles leave splits empty, rows that see no key (q_offset < 0)
    and a partial kv_valid_len; and K/V at an odd address (byte copies)."""
    from repro_torch.kernels.flash_attention import int8
    from repro_torch.quant.quantize import quantize_kv
    monkeypatch.setattr(int8, "split_count", lambda *args: splits)
    q, k, v = _attn((2, 70, 600, 6, 2, 64), dev, seed=2)
    arrays = (q,) + quantize_kv(k, v)
    odd = []
    for a in (arrays[1], arrays[3]):   # kq, vq one byte past an aligned start
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
        odd.append(buf[1:].view(a.shape).copy_(a))
    shifted = (q, odd[0], arrays[2], odd[1], arrays[4])
    assert shifted[1].data_ptr() % 4 == 1
    for kw in ({}, {"q_offset": -30}, {"q_offset": 500, "kv_valid_len": 444},
               {"causal": False, "kv_valid_len": 0}):
        want = int8.flash_attention_int8_ref(*arrays, **kw)
        for bq, bkv in ((16, 16), (32, 64), (128, 256)):
            for args in (arrays, shifted):
                got = int8.flash_attention_int8(*args, block_q=bq,
                                                block_kv=bkv, **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, rtol=int8.TOL[0], atol=int8.TOL[1],
                    msg=lambda m: f"{kw} tile {bq}x{bkv}: {m}")


@pytest.mark.parametrize("name,problem", [
    ("stencil_gather", {"h": 96, "w": 200, "out_h": 92, "out_w": 196,
                        "offsets": FIVE, "origin": (1, 1),
                        "dtype": "float32"}),
    ("flash_attention", {"b": 1, "sq": 64, "skv": 96, "h": 4, "kv": 2,
                         "hd": 32, "causal": True, "q_offset": 0,
                         "dtype": "float32"}),
    ("flash_attention_int8", {"b": 2, "sq": 16, "skv": 128, "h": 4, "kv": 2,
                              "hd": 64, "causal": True, "q_offset": 112,
                              "dtype": "float32"}),
])
def test_one_problem_sweep_winner_is_exact(dev, tmp_path, name, problem):
    from repro_torch.kernels import registry
    from repro_torch.tune import TuneCache, sweep
    spec = registry.get_spec(name)
    before = spec.launches
    rec = sweep(name, problem, reps=2, warmup=1,
                cache=TuneCache(name, tmp_path / f"{name}.json"))
    assert rec["exact"] is True and rec["backend"] == "cuda"
    assert all(e["exact"] and "error" not in e for e in rec["swept"])
    assert rec["params"] in spec.candidates(dict(problem))
    assert rec["us"] <= rec["default_us"] and spec.launches > before


def test_tuned_block_rows_reach_engine_bit_identical(dev, tmp_path,
                                                     monkeypatch):
    import repro_torch.tune.cache as tcache
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp
    from repro_torch.nn import MLP, save_model
    from repro_torch.tune import autotune
    monkeypatch.setattr(tcache, "ART", tmp_path / "tune_torch")
    monkeypatch.setattr(tcache, "_default", {})
    monkeypatch.delenv("REPRO_QUANT", raising=False)
    path = save_model(tmp_path / "b", MLP((1, 6), [64, 32], 1).init(0))
    rec, = autotune(path, buckets=[64], reps=2, warmup=1)
    assert rec["exact"]
    seen = []
    run = ops.SPEC.run_call
    monkeypatch.setattr(ops.SPEC, "run_call", lambda problem, arrays, params:
                        seen.append(dict(params)) or run(problem, arrays,
                                                         params))
    try:
        InferenceEngine.invalidate()
        eng = InferenceEngine.get(path)
        assert eng.route == "fused_mlp"
        x = torch.randn(40, 6, device=dev)
        y = eng.apply_batched(x)              # padded to bucket 64
        assert seen == [rec["params"]]
        padded = torch.cat([x, x.new_zeros((24, 6))])
        assert registry.resolve_params_info(
            ops.SPEC, ops.inspect_call(padded, eng._packed)) == (
            rec["params"], "tuned")
        default = fused_mlp(padded, eng._packed, block_rows=16)[:40]
        torch.cuda.synchronize()
        assert torch.equal(y, default)
    finally:
        InferenceEngine.invalidate()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,hd", [
    (2, 64, 2, 16),    # the spec's default problem
    (4, 1, 32, 64),    # one decode step of rwkv6-1.6b
    (2, 33, 2, 16),    # a ragged last chunk
    (2, 64, 2, 8),
    (1, 70, 3, 32),
    (2, 100, 4, 64),
    (1, 0, 2, 8),      # no step: sT is s0
])
def test_rwkv6_chunk_kernel_matches_plain_version(dev, dtype, b, t, h, hd):
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    problem = {"b": b, "t": t, "h": h, "hd": hd, "dtype": dtype}
    arrays = ops.SPEC.make_call(problem, torch.Generator().manual_seed(t),
                                dev)
    before = ops.SPEC.launches
    o, sT = ops.rwkv6_chunk_op(*arrays)
    want_o, want_s = rwkv6_chunk_ref(*arrays)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == before + 1
    assert o.dtype == arrays[0].dtype and sT.dtype == torch.float32
    # the state's update rounds as the plain version's: bit for bit
    assert torch.equal(sT, want_s)
    rtol, atol = ops.SPEC.tol
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol,
                               rtol=rtol if dtype == "float32" else 2 ** -7)


def _rwkv6_term_scale(r, k, v, w, u, s0):
    """``sum_i |r_i| |S_ij + u_i k_i v_j|`` per output, in f64: the scale
    of a dot product's rounding error, whatever its order."""
    rf, kf, vf, wf = (t.double() for t in (r, k, v, w))
    uf = u.double()[None, :, :, None]
    S = s0.double()
    out = torch.empty_like(rf)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        out[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t].abs(),
                                 (S + uf * kv).abs())
        S = wf[:, t, :, :, None] * S + kv
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [0, 1, 33])
@pytest.mark.parametrize("hd", [7, 12, 24, 96, 128])
def test_rwkv6_chunk_kernel_any_head_size(dev, dtype, t, hd):
    """Head sizes off 8/16/32/64 (padded head tiles of 32 and 128; hd 7's
    rows stage by 4-byte copies in f32 and plain loads in bf16): the
    state bit for bit, o within the spec's (1e-5, 1e-5) against the scale
    of its terms, sum_i |r_i t_ij| (a 128-term f32 dot product's rounding
    reaches the flat 1e-5 in any order), bf16 outputs one bf16 ulp."""
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    problem = {"b": 2, "t": t, "h": 2, "hd": hd, "dtype": dtype}
    arrays = ops.SPEC.make_call(problem,
                                torch.Generator().manual_seed(hd + t), dev)
    before = ops.SPEC.launches
    o, sT = ops.rwkv6_chunk_op(*arrays)
    want_o, want_s = rwkv6_chunk_ref(*arrays)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == before + 1
    assert o.dtype == arrays[0].dtype and o.shape == arrays[0].shape
    assert torch.equal(sT, want_s)
    rtol, atol = ops.SPEC.tol
    if dtype == "bfloat16":
        rtol = 2 ** -7
    scale = _rwkv6_term_scale(*arrays).float()
    err = (o.float() - want_o.float()).abs()
    assert bool((err <= atol + rtol * scale).all()), err.max().item()


def test_rwkv6_chunk_wrapper_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk
    arrays = ops.SPEC.make_call({"b": 1, "t": 4, "h": 2, "hd": 16,
                                 "dtype": "float32"},
                                torch.Generator().manual_seed(0), dev)
    bad_hd = ops.SPEC.make_call({"b": 1, "t": 4, "h": 2, "hd": 129,
                                 "dtype": "float32"},
                                torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_chunk(*bad_hd)
    with pytest.raises(ValueError, match="the kernel does not take"):
        ops.rwkv6_chunk_op(*bad_hd)
    mixed = (arrays[0].to(torch.bfloat16),) + arrays[1:]
    with pytest.raises(ValueError, match="one dtype"):
        rwkv6_chunk(*mixed)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_chunk(*(arrays[:5] + (arrays[5].cpu(),)))


def test_lm_prefill_and_serve_step_launch_the_kernel(dev):
    """At the reduced rwkv6-1.6b: one launch per layer for prefill and
    for each decode step, the logits within the reference's bf16
    tolerance of the same model with the plain recurrence, and the
    cache handoff."""
    from unittest import mock

    from repro_torch.configs.archs import reduced
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    from repro_torch.models import blocks, lm
    cfg = reduced(get_config("rwkv6-1.6b"))
    params = lm.init_params(0, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    ops.SPEC.reset_counts()
    logits, caches = lm.prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == cfg.n_layers and ops.SPEC.plain_calls == 0
    with mock.patch.object(blocks, "rwkv6_chunk_op", rwkv6_chunk_ref):
        plain, _ = lm.prefill(cfg, params, tokens)
    assert ops.SPEC.launches == cfg.n_layers
    err = (logits.float() - plain.float()).abs().max().item()
    assert err <= 2e-2 * (1 + plain.float().abs().max().item())
    _, short = lm.prefill(cfg, params, tokens[:, :-1])
    ops.SPEC.reset_counts()
    step, _ = lm.serve_step(cfg, params, short, tokens[:, -1:], 39)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == cfg.n_layers
    err = (step.float() - logits.float()).abs().max().item()
    assert err <= 2e-2 * (1 + logits.float().abs().max().item())


@pytest.mark.parametrize("valid", [1, 100, 2049, 2081])
def test_flash_attention_at_the_lm_decode_shape(dev, valid):
    """The llama3.2-3b decode step's call: bf16, one query row, GQA group
    3 at hd 128, over a 2,081-key cache that no ``block_kv`` divides,
    with ``kv_valid_len`` moving; through the op and at every tile that
    fits, against the plain version (bf16 outputs within one ulp)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        BLOCK_KV, BLOCK_Q, fits, flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _attn((4, 1, 2081, 24, 8, 128), dev, seed=valid,
                    dtype=torch.bfloat16)
    kw = {"causal": False, "kv_valid_len": valid}
    want = flash_attention_ref(q, k, v, **kw).float()
    tol = dict(rtol=2 ** -7, atol=ops.TOL[1])
    ops.SPEC.reset_counts()
    got = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == 1 and ops.SPEC.plain_calls == 0
    torch.testing.assert_close(got.float(), want, **tol)
    for bq, bkv in [(bq, bkv) for bq in BLOCK_Q for bkv in BLOCK_KV
                    if fits(128, bq, bkv, True)]:
        got = flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **tol,
                                   msg=lambda m: f"tile {bq}x{bkv}: {m}")


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen2-vl-7b"])
def test_gqa_lm_on_the_card_matches_the_cpu(dev, name, dtype, cache):
    """Reduced llama3.2-3b and qwen2-vl-7b (mrope with position_ids):
    prefill and three serve_steps on the card, one flash_attention launch
    per layer and call, against the same weights and tokens on the CPU
    (plain attention): f32 within 1e-4, bf16 and the int8 cache within
    2e-2 of the largest magnitude."""
    from repro_torch.configs.archs import reduced
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm
    cfg = reduced(get_config(name)).replace(dtype=dtype,
                                            kv_cache_dtype=cache)
    cpu = lm.init_params(0, cfg, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(v, device) for v in tree)
        return tree.to(device)
    card = to(cpu, dev)
    B, S = 2, 13
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 3),
                           generator=torch.Generator().manual_seed(2))
    pid = torch.stack([torch.arange(S + 3).expand(B, -1),
                       torch.arange(S + 3).expand(B, -1) // 2,
                       torch.arange(S + 3).expand(B, -1) % 5])
    mrope = cfg.rope == "mrope"

    def close(got, want):
        got, want = got.float().cpu(), want.float()
        if dtype == "float32" and cache != "int8":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            err = (got - want).abs().max().item()
            assert err <= 2e-2 * (1 + want.abs().max().item()), err

    def run(params, device):
        p = pid.to(device) if mrope else None
        out = []
        logits, caches = lm.prefill(cfg, params, tokens[:, :S].to(device),
                                    cache_len=S + 3,
                                    position_ids=None if p is None
                                    else p[:, :, :S])
        out.append(logits)
        for t in range(S, S + 3):
            logits, caches = lm.serve_step(
                cfg, params, caches, tokens[:, t:t + 1].to(device), t,
                position_ids=None if p is None else p[:, :, t:t + 1])
            out.append(logits)
        return out

    want = run(cpu, torch.device("cpu"))
    ops.SPEC.reset_counts()
    got = run(card, dev)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == 4 * cfg.n_layers
    assert ops.SPEC.plain_calls == 0
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_on_the_card_matches_the_cpu(dev, dtype, cache):
    """Reduced whisper-medium (2 encoder and 2 decoder layers, 16 frames):
    prefill over the frames and three serve_steps on the card, one
    flash_attention launch per encoder layer and two per decoder layer
    (self and cross) and call, against the same weights, frames and
    tokens on the CPU (plain attention): logits and every layer's cross
    K/V, f32 within 1e-4, bf16 and the int8 self cache within 2e-2 of the
    largest magnitude; the cross cache stays in the model's dtype."""
    from repro_torch.configs.archs import reduced
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm
    cfg = reduced(get_config("whisper-medium")).replace(
        dtype=dtype, kv_cache_dtype=cache)
    cpu = lm.init_params(0, cfg, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(v, device) for v in tree)
        return tree.to(device)
    card = to(cpu, dev)
    B, S = 2, 13
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 3), generator=gen)
    frames = torch.randn((B, cfg.enc_ctx, cfg.d_model), generator=gen).to(
        cfg.torch_dtype)

    def close(got, want):
        got, want = got.float().cpu(), want.float()
        if dtype == "float32" and cache != "int8":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            err = (got - want).abs().max().item()
            assert err <= 2e-2 * (1 + want.abs().max().item()), err

    def run(params, device):
        logits, caches = lm.prefill(cfg, params, tokens[:, :S].to(device),
                                    enc_embeds=frames.to(device),
                                    cache_len=S + 3)
        out = [logits]
        for t in range(S, S + 3):
            logits, caches = lm.serve_step(cfg, params, caches,
                                           tokens[:, t:t + 1].to(device), t)
            out.append(logits)
        return out, caches

    want, want_c = run(cpu, torch.device("cpu"))
    ops.SPEC.reset_counts()
    got, got_c = run(card, dev)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == cfg.enc_layers + 2 * cfg.n_layers \
        + 3 * 2 * cfg.n_layers
    assert ops.SPEC.plain_calls == 0
    for g, w in zip(got, want):
        close(g, w)
    for gc_, wc in zip(got_c["stack"][0], want_c["stack"][0]):
        for key in ("cross_k", "cross_v"):
            assert gc_[key].dtype == cfg.torch_dtype
            close(gc_[key], wc[key])


# ------------------------------------------------ the serving layer -------
def _serve_bundle(tmp_path, monkeypatch, hidden=(64, 32), gated=False):
    """A seeded minibude-shaped bundle on the card, through the gate when
    ``gated`` (the tests' own gate namespace under tmp_path)."""
    import repro_torch.tune.cache as tcache
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.nn import MLP, save_model
    from repro_torch.quant.gate import gate_bundle
    monkeypatch.setattr(tcache, "_default", {"quant_gate": tcache.TuneCache(
        "quant_gate", path=tmp_path / "gate.json")})
    monkeypatch.delenv("REPRO_QUANT", raising=False)
    path = save_model(tmp_path / ("q" if gated else "f"),
                      MLP((1, 6), list(hidden), 1).init(0))
    if gated:
        rows = np.random.default_rng(3).standard_normal((256, 6)).astype(
            np.float32)
        assert gate_bundle(path, rows, budget=1.0)["exact"]
    eng = InferenceEngine.get(path)
    assert eng.route == ("fused_mlp_int8" if gated else "fused_mlp")
    return path, eng


@pytest.mark.parametrize("gated", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("on_card", [True, False], ids=["card", "host"])
def test_coalesced_rows_bit_identical_to_sync(dev, tmp_path, monkeypatch,
                                              gated, on_card):
    """Requests of 1-300 rows, from the card or the host, coalesce into
    bucket-padded batches through fused_mlp / fused_mlp_int8 and come
    back bit for bit as a synchronous call of each alone."""
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.serve import FlushPolicy, ServeQueue
    path, eng = _serve_bundle(tmp_path, monkeypatch, gated=gated)
    spec = registry.get_spec(eng.route)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
          for n in (1, 7, 37, 300, 64, 3)]
    if on_card:
        xs = [x.to(dev) for x in xs]
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20))
    try:
        before = spec.launches
        futs = [q.submit(path, x) for x in xs]
        q.flush()
        assert spec.launches == before + 1  # one batch, one launch
        for x, f in zip(xs, futs):
            y = f.result(10)
            assert y.device.type == "cpu"
            assert torch.equal(y, eng(x.to(dev)).cpu())
        assert q.stats(path).snapshot()["bucket_rows"] == 512
    finally:
        q.close()
        InferenceEngine.invalidate()


def test_dispatcher_thread_serves_on_the_card(dev, tmp_path, monkeypatch):
    """A started queue: the dispatcher thread launches on the queue's
    device, and rows made on a side stream are waited for."""
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.serve import FlushPolicy, ServeQueue
    path, eng = _serve_bundle(tmp_path, monkeypatch)
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20, max_delay_s=0.002))
    q.start()
    side = torch.cuda.Stream()
    try:
        before = ops.SPEC.launches
        futs, xs = [], []
        for i in range(8):
            with torch.cuda.stream(side):
                x = torch.full((4 + i, 6), float(i), device=dev)
                xs.append(x)
                futs.append(q.submit(path, x))
        ys = [f.result(10) for f in futs]
        assert ops.SPEC.launches > before
        side.synchronize()
        for x, y in zip(xs, ys):
            assert torch.equal(y, eng(x).cpu())
    finally:
        q.close()
        InferenceEngine.invalidate()


def test_pinned_pool_reuse_rule(dev):
    """Page-locked buffers are not handed out again while a view lives,
    and a landed batch is complete before any view is taken."""
    from repro_torch.serve import ScratchPool
    from repro_torch.serve.batcher import Batcher
    pool = ScratchPool()
    a = pool.take((64, 3), torch.float32, pin=True)
    assert a.is_pinned()
    base = a.untyped_storage().data_ptr()
    view = a[5:9]
    del a
    b = pool.take((64, 3), torch.float32, pin=True)
    assert b.untyped_storage().data_ptr() != base
    assert pool.take((64, 3), torch.float32).is_pinned() is False
    del view, b
    c = pool.take((8, 3), torch.float32, pin=True)
    assert c.untyped_storage().data_ptr() == base
    del c
    y = torch.arange(4096 * 3, dtype=torch.float32, device=dev).view(-1, 3)
    host, finite = Batcher(engine_for=lambda k: None, scratch=pool)._to_host(
        y * 2)
    assert host.is_pinned() and bool(finite.all())
    assert torch.equal(host, (y * 2).cpu())


def test_nonfinite_screened_on_the_card(dev):
    from repro_torch.serve import FlushPolicy, ServeQueue
    from repro_torch.serve.batcher import Batcher, NonFiniteOutput

    class _Engine:
        def apply_batched(self, x, **kw):
            y = x.to(dev)[:, :1] * 2
            return torch.where(y > 100, torch.full_like(y, float("nan")), y)

    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20),
                   batcher=Batcher(engine_for=lambda k: _Engine()))
    xs = [torch.ones(3, 2, device=dev), torch.ones(4, 2, device=dev),
          torch.ones(2, 2, device=dev)]
    xs[1][2, 0] = 1e3
    futs = [q.submit("k", x) for x in xs]
    q.flush()
    with pytest.raises(NonFiniteOutput):
        futs[1].result(5)
    for i in (0, 2):
        assert torch.equal(futs[i].result(5), torch.full((xs[i].shape[0], 1),
                                                         2.0))
    q.close()


def test_corrupt_fault_reaches_the_packed_weights(dev, tmp_path,
                                                  monkeypatch):
    """A ``corrupt`` fault moves what the fused_mlp kernel serves: the
    pack is rebuilt from the corrupted weights."""
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.resilience import FAULTS
    path, eng = _serve_bundle(tmp_path, monkeypatch)
    x = torch.randn(40, 6, device=dev)
    clean = eng.apply_batched(x)
    try:
        FAULTS.configure("engine.apply:corrupt:n=1,scale=0.01")
        bad = eng.apply_batched(x)
        assert not torch.equal(bad, clean)
        with torch.no_grad():
            want = ops.fused_mlp_from_spec(eng.spec, eng.params, x)
        assert torch.equal(bad, want)
        torch.testing.assert_close(bad, eng.net(x), rtol=1e-4, atol=1e-4)
    finally:
        FAULTS.clear()
        InferenceEngine.invalidate()


# ------------------------------------------------ the control plane -------
@pytest.mark.parametrize("gated", [False, True], ids=["f32", "int8"])
def test_controller_driven_queue_bit_identical_to_sync(dev, tmp_path,
                                                       monkeypatch, gated):
    """The adaptive flush controller (H100 defaults) drives a threaded
    queue on the card: every request equals its synchronous call bit for
    bit, and every decision's deadline lies within its bounds."""
    import threading
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.serve import FlushPolicy, ServeQueue
    from repro_torch.tune import AdaptiveFlushController
    path, eng = _serve_bundle(tmp_path, monkeypatch, gated=gated)
    pol = FlushPolicy(max_batch_rows=4096, max_delay_s=0.002,
                      max_pending_rows=1 << 16)
    ctrl = AdaptiveFlushController(pol, measured_min_batches=1)
    q = ServeQueue(pol, controller=ctrl).start()
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
          for n in rng.choice([1, 7, 64, 300], size=64)]
    outs = [None] * len(xs)

    def submitter(lane):
        for i in range(lane, len(xs), 4):
            outs[i] = q.submit(path, xs[i]).result(30)

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        q.close()
    for x, y in zip(xs, outs):
        assert torch.equal(y, eng(x.to(dev)).cpu())
    dec = ctrl.last_decision[path]
    assert ctrl.min_delay_s <= dec["delay_s"] <= pol.max_delay_s
    assert q.stats(path).snapshot()["requests_completed"] == len(xs)
    InferenceEngine.invalidate()


def test_resweep_on_its_own_stream_ends_tuned(dev, tmp_path, monkeypatch):
    """A sustained untuned bucket triggers a background sweep of both
    tiers' cells on a side stream; the records are exact, and the next
    dispatch at that bucket resolves ``tuned`` with the untuned rows."""
    import repro_torch.tune.cache as tcache
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.obs import metrics
    from repro_torch.serve import FlushPolicy, ServeQueue
    from repro_torch.tune.resweep import ResweepWorker
    import repro_torch.tune.resweep as resweep
    path, eng = _serve_bundle(tmp_path, monkeypatch, gated=True)
    for k in ("fused_mlp", "fused_mlp_int8"):
        tcache._default[k] = tcache.TuneCache(k, path=tmp_path / f"{k}.json")
    worker = ResweepWorker(after=2).enable()
    monkeypatch.setattr(resweep, "get_resweeper", lambda: worker)
    import repro_torch.tune.kernel_tuner as kt
    streams = []
    real_sweep = kt.sweep

    def watched(kernel, problem, **kw):  # the stream the sweep runs on
        streams.append(torch.cuda.current_stream(kw["device"]))
        return real_sweep(kernel, problem, **kw)

    monkeypatch.setattr(kt, "sweep", watched)
    dispatches = metrics.counter(
        "repro_kernel_dispatch_total",
        "kernel dispatches by resolved-params provenance and precision tier",
        ("kernel", "provenance", "tier"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (300, 6)).astype(np.float32))
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20))
    try:
        untuned = [q.submit(path, x).result(30) for _ in range(3)]
        assert worker.flush(120)
        before = dispatches.value(kernel="fused_mlp_int8",
                                  provenance="tuned", tier="int8")
        tuned = q.submit(path, x).result(30)
    finally:
        q.close()
    assert dispatches.value(kernel="fused_mlp_int8", provenance="tuned",
                            tier="int8") == before + 1
    for kernel in ("fused_mlp", "fused_mlp_int8"):
        entries = tcache._default[kernel].entries()
        assert len(entries) == 1
        (key, rec), = entries.items()
        assert rec["exact"] and key.endswith("|cuda|b512")
    assert len(streams) == 2
    assert all(s != torch.cuda.default_stream(dev) for s in streams)
    assert all(torch.equal(u, untuned[0]) for u in untuned)
    assert torch.equal(tuned, untuned[0])
    InferenceEngine.invalidate()


def test_obs_demo_self_check_on_the_card(dev):
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.server", "--demo",
         "--self-check"], env=dict(os.environ, PYTHONPATH=str(root / "src")),
        cwd=str(root), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "self-check ok" in out.stdout


# ------------------------------------------- flash_attention backward ---
# (B, Sq, Skv, H, KV, hd, hdv)
BWD_CASES = [
    ((1, 130, 130, 4, 2, 24, 24), {"causal": True}),
    ((2, 70, 200, 3, 1, 64, 64), {"causal": True, "q_offset": -70}),
    ((1, 130, 130, 4, 4, 128, 128), {"causal": False, "kv_valid_len": 0}),
    ((1, 130, 200, 8, 2, 100, 100), {"causal": True, "q_offset": 30,
                                     "kv_valid_len": 100}),
    ((2, 257, 257, 8, 2, 128, 128), {"causal": True}),
    ((1, 1, 300, 4, 1, 128, 128), {"causal": False, "kv_valid_len": 290}),
    # a group of 8 q heads on one kv head
    ((1, 130, 130, 8, 1, 64, 64), {"causal": True}),
    # hd not a multiple of the bf16 mma's k (16), 160 rows
    ((1, 160, 160, 4, 2, 120, 120), {"causal": True}),
    # every tile and chunk whole, no mask
    ((1, 64, 64, 2, 1, 64, 64), {"causal": False}),
    # past a q.k tile of 128, V a tile of its own: MLA's 192 / 128, the
    # widest tile with rows that see no key, and 160 with kv_valid_len
    ((1, 130, 130, 4, 4, 192, 128), {"causal": True}),
    ((1, 70, 200, 2, 1, 256, 128), {"causal": True, "q_offset": -70}),
    ((1, 130, 200, 4, 2, 160, 128), {"causal": True, "kv_valid_len": 100}),
    # up to a q.k tile of 128 a narrower v is padded to hd
    ((1, 130, 130, 4, 2, 24, 16), {"causal": True}),
    ((1, 130, 200, 4, 2, 128, 64), {"causal": True, "q_offset": 30}),
]


def _bwd_inputs(dev, shape, dtype, seed=0):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Sq, Skv, H, KV, hd, hdv = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)
    q, k, v = t(B, Sq, H, hd), t(B, Skv, KV, hd), t(B, Skv, KV, hdv)
    return q, k, v, t(B, Sq, H, hdv), flash_attention_ref


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain_backward(dev, dtype,
                                                           shape, kw):
    """The backward kernel against the plain backward (``TOL_BWD``) and
    autograd of the plain version (``bwd_autograd_tol``); two launches
    give the same bits."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    q, k, v, do, ref = _bwd_inputs(dev, shape, dtype)
    o = ref(q, k, v, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, **kw)
    again = flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(ref(qq, kk, vv, **kw), (qq, kk, vv), do)
    group = shape[3] // shape[4]
    for g, w, a in zip(got, want, auto):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= ops.TOL_BWD[dtype]
        assert _rel(g, a) <= ops.bwd_autograd_tol(dtype, group)


def test_flash_attention_op_differentiates_on_the_card(dev):
    """flash_attention_op's gradient on the card launches the forward and
    the backward kernel once each and matches autograd of the plain
    version; no_grad leaves the output detached and launches no
    backward."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd)
    q, k, v, do, ref = _bwd_inputs(dev, (2, 96, 96, 6, 2, 64, 64),
                                   torch.float32, seed=3)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    fwd, bwd = ops.SPEC.launches, flash_attention_bwd.launches
    out = ops.flash_attention_op(qq, kk, vv)
    got = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert (ops.SPEC.launches, flash_attention_bwd.launches) == (fwd + 1,
                                                                 bwd + 1)
    q2, k2, v2 = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(ref(q2, k2, v2), (q2, k2, v2), do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= ops.TOL_BWD[torch.float32]
    with torch.no_grad():
        assert ops.flash_attention_op(qq, kk, vv).grad_fn is None
    assert flash_attention_bwd.launches == bwd + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_op_differentiates_at_the_mla_shape(dev, dtype):
    """At MLA's q.k 192 / v 128 flash_attention_op's gradient runs on the
    card through the kernels: one forward and one backward launch, no
    plain call, within ``bwd_autograd_tol`` (group 1) of autograd of the
    plain version."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd)
    q, k, v, do, ref = _bwd_inputs(dev, (2, 200, 200, 4, 4, 192, 128),
                                   dtype, seed=5)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    registry.reset_counts()
    bwd = flash_attention_bwd.launches
    out = ops.flash_attention_op(qq, kk, vv)
    assert out.shape == do.shape
    got = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert (ops.SPEC.launches, ops.SPEC.plain_calls,
            flash_attention_bwd.launches) == (1, 0, bwd + 1)
    q2, k2, v2 = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(ref(q2, k2, v2), (q2, k2, v2), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= ops.bwd_autograd_tol(dtype, 1)


def test_kernel_without_backward_raises_on_the_card(dev):
    """stencil_gather has no backward kernel: an input that requires grad
    raises on the card, and under no_grad the kernel runs (rwkv6_chunk,
    which this test held until it had a backward, differentiates now:
    test_rwkv6_chunk_op_differentiates_on_the_card)."""
    from repro_torch.kernels.stencil_gather import ops
    x = torch.randn(16, 16, device=dev, requires_grad=True)
    kw = dict(offsets=((0, 1), (1, 0)), out_h=8, out_w=8)
    with pytest.raises(NotImplementedError, match="Backward kernels"):
        ops.stencil_gather_op(x, **kw)
    before = ops.SPEC.launches
    with torch.no_grad():
        ops.stencil_gather_op(x, **kw)
    assert ops.SPEC.launches == before + 1


RWKV_BWD_CASES = [
    # (b, t, h, hd, with a cotangent on the final state, decays)
    (2, 2048, 32, 64, False, "make_call"),  # rwkv6-1.6b's training shape,
    (2, 2048, 32, 64, False, "model"),      # with the model's decays too
    (2, 64, 2, 16, True, "make_call"),
    (4, 1, 32, 64, True, "make_call"),
    (2, 33, 2, 24, True, "make_call"),
    (1, 100, 3, 8, True, "make_call"),
    (1, 70, 2, 128, True, "make_call"),
    (1, 0, 2, 8, True, "make_call"),        # no step: ds0 is dsT
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,hd,with_dsT,decays", RWKV_BWD_CASES)
def test_rwkv6_chunk_bwd_kernel_matches_plain_backward(dev, dtype, b, t, h,
                                                       hd, with_dsT, decays):
    """The backward kernel against the plain backward, from s0 != 0: each
    gradient within TOL_BWD of its largest magnitude, in its input's
    dtype, one launch counted, a relaunch bit for bit.  Decays as the
    spec's ``make_call`` draws them (0.7 to 0.999) or as rwkv6's mixer
    makes them (exp(-exp(c)), c in [-6, 1]: 0.066 to 0.998)."""
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.ref import (rwkv6_chunk_bwd_ref,
                                                     rwkv6_chunk_ref)
    from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk_bwd
    problem = {"b": b, "t": t, "h": h, "hd": hd, "dtype": dtype}
    arrays = ops.SPEC.make_call(problem, torch.Generator().manual_seed(t),
                                dev)
    if decays == "model":
        c = torch.rand(arrays[3].shape,
                       generator=torch.Generator().manual_seed(1)) * 7 - 6
        w = torch.exp(-torch.exp(c)).to(dev, arrays[3].dtype)
        arrays = (*arrays[:3], w, *arrays[4:])
    o, sT = rwkv6_chunk_ref(*arrays)
    g = torch.Generator().manual_seed(hd)
    do = torch.randn(o.shape, generator=g).to(dev, o.dtype)
    dsT = torch.randn(sT.shape, generator=g).to(dev) if with_dsT else None
    before = rwkv6_chunk_bwd.launches
    got = rwkv6_chunk_bwd(*arrays, do, dsT, sT=sT)
    again = rwkv6_chunk_bwd(*arrays, do, dsT, sT=sT)
    want = rwkv6_chunk_bwd_ref(*arrays, do, dsT)
    torch.cuda.synchronize()
    assert rwkv6_chunk_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    tol = ops.TOL_BWD[arrays[0].dtype]
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.numel():
            assert _rel(x, y) <= tol


def test_rwkv6_chunk_bwd_wrapper_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk_bwd
    problem = {"b": 1, "t": 4, "h": 2, "hd": 8, "dtype": "float32"}
    arrays = ops.SPEC.make_call(problem, torch.Generator().manual_seed(0),
                                dev)
    do = torch.ones_like(arrays[0])
    with pytest.raises(ValueError, match="one dtype"):
        rwkv6_chunk_bwd(*arrays, do.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_chunk_bwd(*arrays, do.cpu())
    wide = ops.SPEC.make_call(dict(problem, hd=129),
                              torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError, match="128"):
        rwkv6_chunk_bwd(*wide, torch.ones_like(wide[0]))


def test_rwkv6_chunk_op_differentiates_on_the_card(dev):
    """rwkv6_chunk_op's gradient on the card, through both outputs,
    launches the forward and the backward kernel once each and matches
    autograd of the plain version; no_grad launches no backward."""
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk_bwd
    problem = {"b": 2, "t": 50, "h": 3, "hd": 16, "dtype": "float32"}
    arrays = ops.SPEC.make_call(problem, torch.Generator().manual_seed(1),
                                dev)
    leaves = [a.clone().requires_grad_() for a in arrays]
    fwd, bwd = ops.SPEC.launches, rwkv6_chunk_bwd.launches
    o, sT = ops.rwkv6_chunk_op(*leaves)
    do, dsT = torch.randn_like(o), torch.randn_like(sT)
    got = torch.autograd.grad((o, sT), leaves, (do, dsT))
    torch.cuda.synchronize()
    assert (ops.SPEC.launches, rwkv6_chunk_bwd.launches) == (fwd + 1, bwd + 1)
    plain = [a.clone().requires_grad_() for a in arrays]
    want = torch.autograd.grad(rwkv6_chunk_ref(*plain), plain, (do, dsT))
    for x, y in zip(got, want):
        assert _rel(x, y) <= ops.TOL_BWD[torch.float32]
    with torch.no_grad():
        o, sT = ops.rwkv6_chunk_op(*leaves)
    assert o.grad_fn is None and rwkv6_chunk_bwd.launches == bwd + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_train_gradient_matches_plain_recurrence(dev, dtype):
    """Every gradient of reduced rwkv6-1.6b's loss through the kernels
    against the same loss with the recurrence computed by the plain
    version (differentiated by autograd) on the card: one backward launch
    per layer; f32 within 1e-4 of each leaf's largest magnitude, bf16
    within test_torch_train.py's RWKV6_BF16_GRAD_TOL (0.15)."""
    from unittest import mock

    from repro_torch.configs import archs, base
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk_bwd
    from repro_torch.models import blocks
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer
    cfg = archs.reduced(base.get_config("rwkv6-1.6b")).replace(dtype=dtype)
    st = trainer.make_train_state(0, cfg, device=dev)
    batch = trainer.to_device(TokenPipeline(cfg.vocab_size, 96, 2,
                                            seed=1).batch_at(0), dev)
    before = rwkv6_chunk_bwd.launches
    loss, got = trainer.compute_grads(cfg, st["params"], batch)
    torch.cuda.synchronize()
    assert rwkv6_chunk_bwd.launches == before + cfg.n_layers
    with mock.patch.object(blocks, "rwkv6_chunk_op", rwkv6_chunk_ref):
        loss_p, want = trainer.compute_grads(cfg, st["params"], batch)
    assert rwkv6_chunk_bwd.launches == before + cfg.n_layers
    tol = 1e-4 if dtype == "float32" else 0.15
    assert abs(loss.item() - loss_p.item()) <= tol * abs(loss_p.item())
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_seq_gradient_matches_plain_attention(dev, dtype):
    """Every gradient of reduced llama3.2-3b's loss through the kernels
    against the same loss with attention computed by the plain version
    (differentiated by autograd) on the card: f32 within 1e-4 of each
    leaf's largest magnitude, bf16 within 5e-2 (test_torch_train.py's
    bf16 gradient tolerance)."""
    from unittest import mock

    from repro_torch.configs import archs, base
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import blocks
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer
    cfg = archs.reduced(base.get_config("llama3.2-3b")).replace(dtype=dtype)
    st = trainer.make_train_state(0, cfg, device=dev)
    batch = trainer.to_device(TokenPipeline(cfg.vocab_size, 96, 2,
                                            seed=1).batch_at(0), dev)
    before = flash_attention_bwd.launches
    loss, got = trainer.compute_grads(cfg, st["params"], batch)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + cfg.n_layers
    with mock.patch.object(blocks, "flash_attention_op",
                           flash_attention_ref):
        loss_p, want = trainer.compute_grads(cfg, st["params"], batch)
    assert flash_attention_bwd.launches == before + cfg.n_layers
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert abs(loss.item() - loss_p.item()) <= tol * abs(loss_p.item())
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert _rel(g, w) <= tol


def _attn_wide(shape, dev, seed=0, dtype=torch.float32):
    """q, k [.., hd] and v [.., hdv] of ``shape`` (b, sq, skv, h, kv, hd,
    hdv)."""
    rng = np.random.default_rng(seed)
    b, sq, skv, h, kv, hd, hdv = shape

    def t(*dims):
        return torch.from_numpy(rng.standard_normal(dims).astype(
            np.float32)).to(dev, dtype)
    return t(b, sq, h, hd), t(b, skv, kv, hd), t(b, skv, kv, hdv)


WIDE_CASES = [
    ((2, 200, 200, 16, 16, 192, 128), {}),             # MLA, cut in length
    ((1, 150, 333, 4, 1, 256, 128), {"q_offset": 183}),
    ((1, 77, 133, 6, 2, 192, 128), {"kv_valid_len": 90, "causal": False}),
    ((1, 64, 100, 2, 2, 192, 128), {"kv_valid_len": 0}),
    ((1, 40, 70, 4, 4, 160, 96), {}),                  # v under its tile
    ((2, 33, 65, 4, 2, 24, 16), {"q_offset": 32}),     # both under 32
    ((1, 20, 50, 2, 1, 200, 7), {}),                   # v: plain copies
]


@pytest.mark.parametrize("shape,kw", WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_wide_heads_match_plain_version(dev, shape, kw,
                                                        dtype):
    """The widened kernel: q.k heads past 128 and v heads of their own
    width, at every tile that fits, against the plain version at the
    kernel's tolerance (bf16 outputs within one ulp); a second launch
    gives the same bits."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        BLOCK_KV, BLOCK_Q, fits, flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _attn_wide(shape, dev, dtype=getattr(torch, dtype))
    hd, hdv = shape[-2:]
    want = flash_attention_ref(q, k, v, **kw)
    assert want.shape == q.shape[:3] + (hdv,)
    rtol, atol = ops.TOL
    tiles = [(bq, bkv) for bq in BLOCK_Q for bkv in BLOCK_KV
             if fits(hd, bq, bkv, dtype == "bfloat16", hdv)]
    assert tiles
    for bq, bkv in tiles:
        before = ops.SPEC.launches
        got = flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
        again = flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
        torch.cuda.synchronize()
        assert ops.SPEC.launches == before + 2 and got.dtype == q.dtype
        assert got.shape == want.shape and torch.equal(got, again)
        torch.testing.assert_close(
            got.float(), want.float(), atol=atol,
            rtol=rtol if dtype == "float32" else 2 ** -7,
            msg=lambda m: f"tile {bq}x{bkv}: {m}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [192, 256])
def test_flash_attention_op_at_the_mla_prefill_shape(dev, hd, dtype):
    """deepseek-v2-lite's prefill call, q.k ``hd`` over v 128, 16 heads,
    B 4 x 2,048 causal (256: the widest tile), through the op: one
    launch, within the kernel's tolerance of the plain version, the same
    bits again."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dt = getattr(torch, dtype)
    q, k, v = _attn_wide((4, 2048, 2048, 16, 16, hd, 128), dev, seed=hd,
                         dtype=dt)
    ops.SPEC.reset_counts()
    got = ops.flash_attention_op(q, k, v, causal=True)
    again = ops.flash_attention_op(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == 2 and ops.SPEC.plain_calls == 0
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(
        got.float(), want.float(), atol=ops.TOL[1],
        rtol=ops.TOL[0] if dtype == "float32" else 2 ** -7)


def test_flash_attention_refuses_what_it_does_not_take(dev):
    """On the card a shape the kernel does not take raises: no fallback
    to the plain version."""
    from repro_torch.kernels.flash_attention import ops
    q, k, v = _attn_wide((1, 8, 8, 2, 2, 192, 160), dev)   # v past 128
    ops.SPEC.reset_counts()
    with pytest.raises(ValueError, match="does not take"):
        ops.flash_attention_op(q, k, v)
    q, k, v = _attn_wide((1, 8, 8, 2, 2, 264, 128), dev)   # q.k past 256
    with pytest.raises(ValueError, match="does not take"):
        ops.flash_attention_op(q, k, v)
    assert ops.SPEC.launches == 0 and ops.SPEC.plain_calls == 0


# ------------------------------------------ flash_attention bf16 design ---
# (b, sq, skv, h, kv, hd, hdv), keywords: the decode kernel at Sq 1 with
# GQA groups 1, 3 and 4 over the llama3.2-3b decode step's 2,081-key cache
# and kv_valid_len 0, 1, 2,049 and 2,081; Sq x group 15, 16 (decode) and 17
# (prefill); MLA's 192 / 128 and the widest 256 / 128
BF16_CASES = [
    ((4, 1, 2081, g * 8, 8, 128, 128), {"causal": False, "kv_valid_len": n})
    for g in (1, 3, 4) for n in (0, 1, 2049, 2081)
] + [
    ((2, 5, 300, 6, 2, 64, 64), {"q_offset": 290}),        # 15 rows
    ((2, 16, 300, 2, 2, 96, 96), {"q_offset": 280}),       # 16
    ((2, 17, 300, 2, 2, 96, 96), {"q_offset": 280}),       # 17: prefill
    ((2, 4, 300, 12, 3, 40, 40), {"q_offset": -2}),        # 16, no key seen
    ((4, 1, 2081, 16, 16, 192, 128), {"causal": False, "kv_valid_len": 2049}),
    ((2, 1, 513, 16, 16, 256, 128), {"causal": False}),
    ((2, 200, 200, 16, 16, 192, 128), {}),
    ((1, 150, 333, 4, 1, 256, 128), {"q_offset": 183}),
]


def _bf16_ids(case):
    (b, sq, skv, h, kv, hd, hdv), kw = case
    return f"sq{sq}-skv{skv}-g{h // kv}-hd{hd}-{hdv}-" + "-".join(
        f"{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("case", BF16_CASES, ids=_bf16_ids)
def test_flash_attention_bf16_kernels_match_plain_version(dev, case):
    """bf16 through the op and at every tile that fits: the decode kernel
    and its combine at most 16 rows a kv head, the prefill kernel past it,
    never the f32 design or the plain version; within one bf16 ulp of the
    plain version; a relaunch gives the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    shape, kw = case
    b, sq, skv, h, kv, hd, hdv = shape
    q, k, v = _attn_wide(shape, dev, seed=sq + skv, dtype=torch.bfloat16)
    want = flash_attention_ref(q, k, v, **kw).float()
    tol = dict(rtol=2 ** -7, atol=ops.TOL[1])
    decode = fa.is_decode(sq, h, kv)
    ops.SPEC.reset_counts()
    got = ops.flash_attention_op(q, k, v, **kw)
    again = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == 2 and ops.SPEC.plain_calls == 0
    assert {f.__name__: f.launches for f in fa.KERNELS} == {
        "flash_attention_f32": 0,
        "flash_attention_bf16_prefill": 0 if decode else 2,
        "flash_attention_bf16_decode": 2 if decode else 0,
        "flash_attention_bf16_combine": 2 if decode else 0}
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want, **tol)
    for bq, bkv in [(bq, bkv) for bq in fa.BLOCK_Q for bkv in fa.BLOCK_KV
                    if fa.fits(hd, bq, bkv, True, hdv)]:
        got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
        again = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), want, **tol,
                                   msg=lambda m: f"tile {bq}x{bkv}: {m}")


@pytest.mark.parametrize("splits", [1, 2, 5, 32])
@pytest.mark.parametrize("valid", [0, 700, 2081])
def test_flash_attention_bf16_decode_partials_and_combine(dev, splits,
                                                          valid):
    """The decode kernel's partials at any split count against their plain
    version (f32, to 1e-4 of the largest magnitude: ex2.approx and the
    order of the sums), and the combine kernel against its plain version
    on the same partials (one bf16 ulp)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_combine_ref, flash_attention_decode_ref)
    q, k, v = _attn_wide((4, 1, 2081, 24, 8, 128, 128), dev, seed=splits,
                         dtype=torch.bfloat16)
    kw = dict(causal=False, q_offset=0)
    part_acc, part_ml = fa.flash_attention_bf16_decode(q, k, v, valid=valid,
                                                       splits=splits, **kw)
    want_acc, want_ml = flash_attention_decode_ref(
        q, k, v, kv_valid_len=valid, splits=splits, **kw)
    torch.cuda.synchronize()
    for got, want in ((part_acc, want_acc), (part_ml, want_ml)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * (1 + want.abs().max().item())
    out = torch.empty_like(q)
    fa.flash_attention_bf16_combine(part_acc, part_ml, out, 128)
    want = flash_attention_combine_ref(part_acc, part_ml, 128).reshape(
        out.shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), rtol=2 ** -7,
                               atol=2e-5)


# ------------------------------------------------------------ mamba_scan ---
MAMBA_CASES = [
    # jamba's prefill (B 4, S 2,048, d_inner 8,192, d_state 16) and one
    # step at its width
    dict(b=4, s=2048, di=8192, ds=16),
    dict(b=4, s=1, di=8192, ds=16),
    # a partial chunk of 64 steps and a partial block of 128 channels
    dict(b=2, s=70, di=200, ds=16),
    # a state of 5: rows the wrapper pads to 16 states
    dict(b=2, s=70, di=200, ds=5),
    dict(b=1, s=33, di=7, ds=1),
    # a state of 8: the second lane of each channel holds only padding
    dict(b=2, s=70, di=200, ds=8),
    # dt uniform up to 200: with A = -(1 .. ds), dt |A| log2(e) passes
    # 127 on every state at more than half the steps, so those decays
    # underflow to 0, beside decays that do not
    dict(b=2, s=70, di=200, ds=16, dt_max=200.0),
]


def _mamba_arrays(problem, dev, seed):
    """``ops.SPEC.make_call``'s inputs; with ``dt_max``, dt uniform in
    [0, dt_max]."""
    from repro_torch.kernels.mamba_scan import ops
    gen = torch.Generator().manual_seed(seed)
    arrays = ops.SPEC.make_call(problem, gen, dev)
    if "dt_max" not in problem:
        return arrays
    dt = torch.rand(arrays[0].shape, generator=gen) * problem["dt_max"]
    return (dt.to(device=dev, dtype=arrays[0].dtype),) + arrays[1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MAMBA_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_mamba_scan_kernel_matches_plain_version(dev, case, dtype):
    """One launch through the op against the plain version from a nonzero
    state: y and the final state within the spec's tolerance of the scale
    of their terms; a second launch bit for bit."""
    from repro_torch.kernels.mamba_scan import ops
    problem = dict(case, dtype=dtype)
    arrays = _mamba_arrays(problem, dev, 3)
    ops.SPEC.reset_counts()
    y, hT = ops.mamba_scan_op(*arrays)
    y2, hT2 = ops.mamba_scan_op(*arrays)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == 2 and ops.SPEC.plain_calls == 0
    assert y.dtype == hT.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    worst = ops.held_to_plain(arrays, y, hT)["worst_vs_terms"]
    assert max(worst.values()) <= 1.0, worst


def test_mamba_scan_wrapper_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan
    problem = dict(b=1, s=8, di=16, ds=16, dtype="float32")
    arrays = ops.SPEC.make_call(problem, torch.Generator().manual_seed(0),
                                dev)
    wide = ops.SPEC.make_call(dict(problem, ds=17),
                              torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan(*wide)
    with pytest.raises(ValueError, match="does not take"):
        ops.mamba_scan_op(*wide)
    mixed = (arrays[0].to(torch.bfloat16),) + arrays[1:]
    with pytest.raises(ValueError, match="one dtype"):
        mamba_scan(*mixed)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan(*(arrays[:6] + (arrays[6].cpu(),)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [dict(b=2, s=70, di=200, ds=16),
                                  dict(b=2, s=33, di=7, ds=5),
                                  dict(b=1, s=0, di=16, ds=16)],
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_mamba_scan_keeps_its_states_on_the_card(dev, case, dtype):
    """``keep_states``: y and hT bit for bit as without; the state before
    every BWD_CHUNK-th step bit for bit the final state of the kernel over
    the steps before it, zero past ds."""
    from repro_torch.kernels.mamba_scan.mamba_scan import (
        BWD_CHUNK, MAX_STATE, kept_chunks, mamba_scan)
    arrays = _mamba_arrays(dict(case, dtype=dtype), dev, 4)
    y, hT, states = mamba_scan(*arrays, keep_states=True)
    y2, hT2 = mamba_scan(*arrays)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    S, ds = case["s"], case["ds"]
    assert states.shape == (case["b"], kept_chunks(S), case["di"], MAX_STATE)
    assert not states[..., ds:].any()
    for c in range(kept_chunks(S)):
        prefix = [a[:, :c * BWD_CHUNK] for a in arrays[:4]] + list(arrays[4:])
        assert torch.equal(states[:, c, :, :ds], mamba_scan(*prefix)[1]), c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_op_differentiates_on_the_card(dev, dtype):
    """An input that requires grad: the op runs the forward kernel once
    (keeping its states) and, through the registry's autograd function,
    the backward kernel once, with no plain call; the gradients are the
    kernel's own (bit for bit a direct launch on the same cotangents and
    the forward's kept states, zeros for the unread final state) and
    within TOL_BWD of the plain backward."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.mamba_scan import (mamba_scan,
                                                           mamba_scan_bwd)
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_ref
    arrays = ops.SPEC.make_call(dict(b=2, s=70, di=200, ds=16, dtype=dtype),
                                torch.Generator().manual_seed(5), dev)
    leaves = [a.clone().requires_grad_(True) for a in arrays]
    ops.SPEC.reset_counts()
    before = mamba_scan_bwd.launches
    y, _ = ops.mamba_scan_op(*leaves)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(6)
                     ).to(dev)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert ops.SPEC.launches == 1 and ops.SPEC.plain_calls == 0
    assert mamba_scan_bwd.launches == before + 1
    states = mamba_scan(*arrays, keep_states=True)[2]
    direct = mamba_scan_bwd(*arrays, dy, torch.zeros_like(arrays[6]),
                            states=states)
    want = mamba_scan_bwd_ref(*arrays, dy)
    tol = ops.TOL_BWD[arrays[0].dtype]
    for g, k, w, a in zip(got, direct, want, arrays):
        assert g.dtype == a.dtype and torch.equal(g, k)
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err.item() <= tol


def test_mamba_scan_bwd_wrapper_refuses_what_it_cannot_take(dev):
    """A state of 17, mixed dtypes, a CPU tensor and kept states that are
    not the kernel forward's: each raises before any launch."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_bwd
    problem = dict(b=1, s=8, di=16, ds=16, dtype="float32")
    arrays = ops.SPEC.make_call(problem, torch.Generator().manual_seed(0),
                                dev)
    wide = ops.SPEC.make_call(dict(problem, ds=17),
                              torch.Generator().manual_seed(0), dev)
    dy = torch.ones((1, 8, 16), device=dev)
    states = torch.zeros((1, 1, 16, 16), device=dev)
    before = mamba_scan_bwd.launches
    with pytest.raises(ValueError, match="state size"):
        mamba_scan_bwd(*wide, dy, states=states)
    mixed = (arrays[0].to(torch.bfloat16),) + arrays[1:]
    with pytest.raises(ValueError, match="one dtype"):
        mamba_scan_bwd(*mixed, dy, states=states)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd(*arrays, dy.cpu(), states=states)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd(*arrays, dy, states=states.cpu())
    with pytest.raises(ValueError, match="states must be"):
        mamba_scan_bwd(*arrays, dy, states=states[..., :8])
    assert mamba_scan_bwd.launches == before


MAMBA_BWD_CASES = [
    # jamba's training width (d_inner 8,192, d_state 16) at a shorter
    # sequence, without a cotangent on the final state (as in training)
    dict(b=1, s=300, di=8192, ds=16, dhT=False),
    # a ragged last chunk of 16 steps, a partial block of 64 channels
    dict(b=2, s=70, di=200, ds=16),
    dict(b=2, s=1, di=200, ds=16),
    dict(b=2, s=70, di=200, ds=8),
    dict(b=2, s=33, di=7, ds=5),
    dict(b=2, s=70, di=200, ds=16, dt_max=200.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MAMBA_BWD_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_mamba_scan_bwd_kernel_matches_plain_backward(dev, case, dtype):
    """The backward kernel, from the forward kernel's kept states, against
    the plain backward from h0 != 0, with a cotangent on the final state
    unless the case says otherwise: each gradient in its input's dtype,
    finite, within ``ops.TOL_BWD`` of the plain backward's largest
    magnitude; a second launch bit for bit."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.mamba_scan import (mamba_scan,
                                                           mamba_scan_bwd)
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_ref
    problem = {k: v for k, v in case.items() if k != "dhT"}
    arrays = _mamba_arrays(dict(problem, dtype=dtype), dev, 7)
    gen = torch.Generator().manual_seed(8)
    B, S, di = arrays[0].shape
    dy = torch.randn((B, S, di), generator=gen).to(dev)
    dhT = (torch.randn(tuple(arrays[6].shape), generator=gen).to(dev)
           if case.get("dhT", True) else None)
    states = mamba_scan(*arrays, keep_states=True)[2]
    before = mamba_scan_bwd.launches
    got = mamba_scan_bwd(*arrays, dy, dhT, states=states)
    again = mamba_scan_bwd(*arrays, dy, dhT, states=states)
    want = mamba_scan_bwd_ref(*arrays, dy, dhT)
    torch.cuda.synchronize()
    assert mamba_scan_bwd.launches == before + 2
    tol = ops.TOL_BWD[arrays[0].dtype]
    for g, a2, w, a in zip(got, again, want, arrays):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert torch.equal(g, a2)
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max() / \
            w.float().abs().max().clamp_min(1e-30)
        assert err.item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_on_the_card_matches_the_cpu(dev, dtype):
    """Reduced jamba (16 layers: 14 Mamba on mamba_scan, 2 GQA on
    flash_attention, MoE on every other one, learned positions): prefill
    and three serve_steps on the card against the same weights and
    tokens on the CPU (plain versions): one scan per Mamba layer of the
    prefill and none in a step, one attention launch per GQA layer and
    call; f32 within 1e-4, bf16 within 0.1 of the largest magnitude
    (chip_smoke.py's ``LM_TOL_BF16``: 16 layers of random weights
    amplify bf16 rounding).  Each layer's scan is also held to the plain
    version on its own inputs at the op's tolerance, which the bf16
    bound on the logits and states is too loose to stand in for."""
    from unittest import mock

    from repro_torch.configs.archs import reduced
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.models import blocks, lm
    cfg = reduced(get_config("jamba-v0.1-52b")).replace(dtype=dtype)
    cpu = lm.init_params(0, cfg, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(v, device) for v in tree)
        return tree.to(device)
    card = to(cpu, dev)
    B, S = 2, 40
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 3),
                           generator=torch.Generator().manual_seed(2))

    def run(params, device):
        out = []
        logits, caches = lm.prefill(cfg, params, tokens[:, :S].to(device),
                                    cache_len=S + 3)
        out.append(logits)
        for t in range(S, S + 3):
            logits, caches = lm.serve_step(cfg, params, caches,
                                           tokens[:, t:t + 1].to(device), t)
            out.append(logits)
        return out, caches

    want, want_c = run(cpu, torch.device("cpu"))
    ops.SPEC.reset_counts()
    flash_ops.SPEC.reset_counts()
    scans, scan_op = [], blocks.mamba_scan_op

    def recorded(*args):
        out = scan_op(*args)
        scans.append((args, out))
        return out
    with torch.no_grad(), mock.patch.object(blocks, "mamba_scan_op",
                                            recorded):
        got, got_c = run(card, dev)
    torch.cuda.synchronize()
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * \
        cfg.pattern_repeats
    assert ops.SPEC.launches == n_mamba and ops.SPEC.plain_calls == 0
    assert flash_ops.SPEC.launches == 4 * (cfg.n_layers - n_mamba)
    assert len(scans) == n_mamba
    for args, (y, hT) in scans:
        worst = ops.held_to_plain(args, y, hT)["worst_vs_terms"]
        assert max(worst.values()) <= 1.0, worst

    def close(g, w):
        g, w = g.float().cpu(), w.float()
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            err = (g - w).abs().max().item()
            assert err <= 0.1 * (1 + w.abs().max().item()), err
    for g, w in zip(got, want):
        close(g, w)
    for slot, spec in enumerate(cfg.pattern):
        for gc_, wc in zip(got_c["stack"][slot], want_c["stack"][slot]):
            for key in wc["mixer"]:
                close(gc_["mixer"][key], wc["mixer"][key])


# ------------------------------------------------ sharding on the card ----
_SHARDED_WORKER = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np
import torch
import torch.distributed as dist
rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.device import resolve_device
from repro_torch.dist import use_mesh
from repro_torch.dist.sharding import full_tensor, local_block
from repro_torch.kernels.fused_mlp import int8 as qops
from repro_torch.kernels.fused_mlp import ops as fops
from repro_torch.kernels.fused_mlp.fused_mlp import pack_mlp
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.quant.quantize import quantize_params
out = {}
try:
    dev = resolve_device(None)
    mesh = make_local_mesh(device="cuda")
    rng = np.random.default_rng(0)
    widths = (6, 1024, 819, 655, 1)
    ws = [torch.from_numpy((rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
                           .astype(np.float32))
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.from_numpy((rng.standard_normal(b) * 0.1).astype(np.float32))
          for b in widths[1:]]
    acts = ("relu", "relu", "relu", "identity")
    x = torch.from_numpy(rng.standard_normal((4096, 6)).astype(np.float32)
                         ).to(dev)
    packed = pack_mlp(ws, bs, acts, device=dev)
    q = qops.pack_int8_mlp(quantize_params(ws, bs, device=dev), acts)
    for tier, shard, one, pk in (
            ("f32", fops.fused_mlp_sharded, fops.fused_mlp_op, packed),
            ("int8", qops.fused_mlp_int8_sharded, qops.fused_mlp_int8_op, q)):
        spec = fops.SPEC if tier == "f32" else qops.SPEC
        before = spec.launches
        with use_mesh(mesh):
            y = shard(x, pk, mesh=mesh, data_axes=("data",))
            whole = full_tensor(y)
        launched = spec.launches - before
        out[tier] = {"bits_equal": bool(torch.equal(whole, one(x, pk))),
                     "local_rows": int(y.to_local().shape[0]),
                     "launches": launched}
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.base import LayerSpec, ModelConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer
    cfg = ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                      pattern=(LayerSpec(),))
    grid = make_local_mesh((1, world), device="cuda")
    state = trainer.make_train_state(0, cfg, device=dev, mesh=grid)
    mgr = CheckpointManager(f"{tmp}/ckpt", async_write=False)
    trainer.save_train_state(mgr, 3, state)
    back, step = trainer.restore_train_state(mgr, cfg, state, mesh=mesh)
    same = all(torch.equal(full_tensor(a).detach(), full_tensor(b).detach())
               for a, b in zip(tree_leaves(state), tree_leaves(back)))
    out["restore"] = {"step": step, "bits_equal": same,
                      "on_card": all(t.to_local().is_cuda
                                     for t in tree_leaves(back)),
                      "relaid": any(tuple(a.placements) != tuple(b.placements)
                                    for a, b in zip(tree_leaves(state),
                                                    tree_leaves(back)))}
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """Two gloo ranks on the one card (``_SHARDED_WORKER``), run once for
    the module: each rank's report."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp_path = tmp_path_factory.mktemp("sharded")
    import json
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SHARDED_WORKER, str(r), "2", str(port),
         str(tmp_path)], env=env, cwd=str(root), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    reports = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    return reports


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_sharded_fused_mlp_equals_one_rank_on_the_card(sharded_run, tier):
    """Two ranks on cuda:0 each run the kernel on their own 2,048 of
    4,096 rows: gathered, bit for bit one rank's launch on all of them
    (neither kernel splits a row's sums)."""
    for r in sharded_run:
        assert r[tier]["bits_equal"] and r[tier]["local_rows"] == 2048
        assert r[tier]["launches"] == 1


def test_restore_onto_shardings_on_the_card(sharded_run):
    """A state sharded on data 1 x model 2, saved and restored onto data
    2 x model 1: every leaf bit for bit, on the card, laid out anew."""
    for r in sharded_run:
        rr = r["restore"]
        assert rr["step"] == 3 and rr["bits_equal"] and rr["on_card"]
        assert rr["relaid"]
