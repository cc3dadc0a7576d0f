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
