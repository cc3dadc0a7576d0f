"""Port parity of the quantized tier: quantization math against
repro.quant.quantize, the gate verdict lifecycle, calibration rows,
engine tier resolution and the tune cache, on the CPU.

The gate and engine cases are those of tests/test_quant.py, ported case
for case.  Every test runs with empty budget registries, the port's gate
namespace under tmp_path, no cached engines in either package and
``REPRO_QUANT`` set only through monkeypatch, so nothing leaks into the
JAX tests on the same worker.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.tune.cache as tcache  # noqa: E402
from repro.quant import quantize as jq  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.obs import metrics as _m  # noqa: E402
from repro_torch.quant import budgets, quantize  # noqa: E402
from repro_torch.quant.gate import GATE_NAMESPACE  # noqa: E402
from repro_torch.tune.cache import TuneCache, best_params  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    from repro.core.engine import InferenceEngine as JaxEngine
    from repro.quant.budgets import clear_budgets as jax_clear
    budgets.clear_budgets()
    jax_clear()
    monkeypatch.setattr(tcache, "_default", {
        GATE_NAMESPACE: TuneCache(GATE_NAMESPACE,
                                  path=tmp_path / "quant_gate.json")})
    monkeypatch.delenv("REPRO_QUANT", raising=False)
    InferenceEngine.invalidate()
    JaxEngine.invalidate()
    yield
    InferenceEngine.invalidate()
    JaxEngine.invalidate()
    budgets.clear_budgets()
    jax_clear()


def _bundle(tmp, widths=(4, 16, 2), seed=0):
    from repro_torch.nn import MLP, save_model
    net = MLP((1, widths[0]), list(widths[1:-1]), widths[-1]).init(seed)
    return save_model(tmp / "m", net)


def _rows(n, d=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _gate_budget(mp, rows, rel=0.05):
    """Register a budget at ``rel`` x the bundle's f32 output RMS."""
    from repro_torch.nn.serialize import load_model
    net, _, _ = load_model(mp, "cpu")
    with torch.no_grad():
        y = net(torch.from_numpy(rows)).numpy()
    budget = rel * float(np.sqrt(np.mean(np.square(y))))
    budgets.set_rmse_budget(mp, budget)
    return budget


def _gate(mp, rows, **kw):
    from repro_torch.quant.gate import gate_bundle
    return gate_bundle(mp, rows, device="cpu", **kw)


# ------------------------------------------------------------ quant math ----
@pytest.mark.parametrize("shape,scale_mult", [((16, 8), 1.0),
                                              ((1100, 300), 1.0),
                                              ((64, 33), 64.0)])
def test_quantize_weights_matches_jax(shape, scale_mult):
    rng = np.random.default_rng(shape[0])
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 3] = 0.0  # a zero channel takes the 1/127 guard
    jwq, jws = jq.quantize_weights_per_channel(jnp.asarray(w),
                                               scale_mult=scale_mult)
    wq, ws = quantize.quantize_weights_per_channel(w, scale_mult=scale_mult,
                                                   device="cpu")
    assert wq.dtype == torch.int8 and ws.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


def test_quantize_rows_matches_jax():
    """Bit-equal scales and equal codes: both divide truly (XLA's CPU
    division and torch's agree on all 4,096 rows of mixed magnitude)."""
    rng = np.random.default_rng(0)
    h = (rng.normal(size=(4096, 64)) *
         rng.uniform(0.01, 100, size=(4096, 1))).astype(np.float32)
    h[5] = 0.0
    jhq, jhs = jq.quantize_rows(jnp.asarray(h))
    hq, hs = quantize.quantize_rows(torch.from_numpy(h))
    assert hq.dtype == torch.int8 and tuple(hs.shape) == (4096, 1)
    np.testing.assert_array_equal(hq.numpy(), np.asarray(jhq))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(jhs))


def test_quantize_params_matches_jax():
    rng = np.random.default_rng(2)
    ws = [rng.normal(size=(5, 9)).astype(np.float32),
          rng.normal(size=(9, 2)).astype(np.float32)]
    bs = [rng.normal(size=(9,)).astype(np.float32),
          rng.normal(size=(2,)).astype(np.float32)]
    for mine, ref in zip(quantize.quantize_params(ws, bs, device="cpu"),
                         jq.quantize_params(ws, bs)):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_weight_scale_factoring_is_exact():
    """Row and channel scales factor exactly out of the int32 dot, and
    the dequant is bit-equal to the reference's."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    h = rng.normal(size=(4, 16)).astype(np.float32)
    wq, ws = quantize.quantize_weights_per_channel(w, device="cpu")
    hq, hs = quantize.quantize_rows(torch.from_numpy(h))
    manual = (hq.to(torch.float32) @ wq.to(torch.float32)) * hs * ws
    got = quantize.qdot(hq, hs, wq, ws)
    assert torch.equal(got, manual)
    want = jq.qdot(jnp.asarray(hq.numpy()), jnp.asarray(hs.numpy()),
                   jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # roundtrip error bounded by half an int8 step per element
    np.testing.assert_allclose(wq.numpy().astype(np.float32) * ws.numpy(), w,
                               atol=float(np.abs(w).max()) / 127.0)


def test_int8_matmul_exact_beyond_f32_limit():
    """K = 1,100 int8 terms of up to 127 * 127: partial sums pass 2**24,
    where f32 stops holding odd integers; the float64 product does not."""
    rng = np.random.default_rng(5)
    hq = rng.integers(-127, 128, size=(8, 1100)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(1100, 6)).astype(np.int8)
    hq[0], wq[:, 0] = 127, 127   # every product 16,129: sum 17,741,900
    exact = hq.astype(np.int64) @ wq.astype(np.int64)
    got = quantize.int8_matmul(torch.from_numpy(hq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exact)
    f32 = np.cumsum(np.full(1100, 16129, np.float32), dtype=np.float32)[-1]
    assert int(f32) != exact[0, 0]  # the premise: f32 would not be exact
    ones = torch.ones(())
    assert torch.equal(quantize.qdot(torch.from_numpy(hq), ones,
                                     torch.from_numpy(wq), ones),
                       got.to(torch.float32))


def test_quantize_zero_guards():
    wq, ws = quantize.quantize_weights_per_channel(torch.zeros(8, 4),
                                                   device="cpu")
    assert torch.isfinite(ws).all() and not wq.any()
    hq, hs = quantize.quantize_rows(torch.zeros(3, 8))
    assert torch.isfinite(hs).all() and not hq.any()
    assert torch.equal(hs, torch.full((3, 1), 1.0) / torch.tensor(127.0))


def test_quant_mlp_ref_tracks_f32():
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=(8, 32)).astype(np.float32) * 0.3,
          rng.normal(size=(32, 2)).astype(np.float32) * 0.3]
    bs = [rng.normal(size=(32,)).astype(np.float32) * 0.1,
          rng.normal(size=(2,)).astype(np.float32) * 0.1]
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    acts = ("relu", "identity")
    y32 = torch.relu(x @ torch.from_numpy(ws[0]) + torch.from_numpy(bs[0]))
    y32 = y32 @ torch.from_numpy(ws[1]) + torch.from_numpy(bs[1])
    yq = quantize.quant_mlp_ref(
        x, quantize.quantize_params(ws, bs, device="cpu"), acts)
    rmse = float(torch.sqrt(torch.mean((yq - y32) ** 2)))
    assert rmse < 0.05 * float(torch.sqrt(torch.mean(y32 ** 2)))


# ------------------------------------------------- gate verdict lifecycle ---
def test_gate_pass_roundtrips_schema2_and_binds_fingerprint(tmp_path):
    from repro_torch.quant.gate import gate_passed, verdict
    mp = _bundle(tmp_path)
    rows = _rows(128)
    budget = _gate_budget(mp, rows)
    rec = _gate(mp, rows)
    assert rec["exact"] is True and rec["params"] == {"gated": 1}
    assert rec["rmse"] <= budget and rec["budget"] == pytest.approx(budget)
    assert rec["rows"] == 128 and rec["scale_mult"] == 1.0
    assert gate_passed(mp)
    data = json.loads((tmp_path / "quant_gate.json").read_text())
    assert data["schema"] == 2 and data["kernel"] == GATE_NAMESPACE
    assert verdict(mp)["fingerprint"] == rec["fingerprint"]
    assert best_params(GATE_NAMESPACE, [os.path.abspath(mp)]) == {"gated": 1}
    # rewriting the bundle un-gates it until it is gated again
    _bundle(tmp_path, seed=7)
    assert not gate_passed(mp)


def test_gate_fail_is_never_resolvable(tmp_path):
    from repro_torch.quant.gate import gate_passed
    mp = _bundle(tmp_path)
    rows = _rows(128)
    _gate_budget(mp, rows)
    fails = _m.counter("repro_quant_gate_fail_total",
                       "quant gate evaluations that failed the RMSE budget",
                       ("bundle",))
    before = fails.value(bundle=mp)
    rec = _gate(mp, rows, scale_mult=64.0)
    assert rec["exact"] is False and rec["params"] == {"gated": 0}
    assert not gate_passed(mp)
    assert fails.value(bundle=mp) == before + 1
    assert best_params(GATE_NAMESPACE, [os.path.abspath(mp)]) is None


def test_gate_without_budget_is_an_error(tmp_path):
    mp = _bundle(tmp_path)
    with pytest.raises(ValueError, match="no RMSE budget"):
        _gate(mp, _rows(32))


def test_gate_rmse_matches_jax_gate(tmp_path, monkeypatch):
    """The same bundle and rows through both gates: the int8 forwards
    agree to the kernel tolerance, so the RMSEs do too."""
    import repro.tune.cache as jcache
    from repro.quant.budgets import set_rmse_budget as jax_budget
    from repro.quant.gate import gate_bundle as jax_gate
    from repro.tune.cache import TuneCache as JaxCache
    monkeypatch.setattr(jcache, "_default", {
        "quant_gate": JaxCache("quant_gate", path=tmp_path / "jax.json")})
    mp = _bundle(tmp_path, widths=(4, 32, 16, 2))
    rows = _rows(256)
    budget = _gate_budget(mp, rows)
    jax_budget(mp, budget)
    mine, ref = _gate(mp, rows), jax_gate(mp, rows)
    assert mine["exact"] is ref["exact"] is True
    assert mine["fingerprint"] == ref["fingerprint"]
    assert mine["rmse"] == pytest.approx(ref["rmse"], rel=1e-3, abs=1e-6)


def test_calibration_rows_are_heldout(tmp_path):
    from repro_torch.core.database import SurrogateDB
    from repro_torch.quant.calibrate import calibration_rows
    db = SurrogateDB(tmp_path / "db")
    db.group("r").append(_rows(100), _rows(100, d=1, seed=1), 0.0)
    db.flush()
    rows = calibration_rows(db, "r", max_rows=8)
    assert rows.shape == (8, 4) and rows.dtype == np.float32
    _, held = db.group("r").train_test_split()
    np.testing.assert_array_equal(rows, held["inputs"][:8])
    # the reference reads the same held-out rows from the same store
    from repro.quant.calibrate import calibration_rows as jax_rows
    np.testing.assert_array_equal(
        calibration_rows(str(tmp_path / "db"), "r"),
        jax_rows(str(tmp_path / "db"), "r"))
    db.group("empty").append(_rows(0), _rows(0, d=1), 0.0)
    db.flush()
    with pytest.raises(ValueError, match="no held-out"):
        calibration_rows(db, "empty")


def test_activation_ranges_match_jax(tmp_path):
    from repro.quant.calibrate import activation_ranges as jax_ranges
    from repro_torch.quant.calibrate import activation_ranges
    mp = _bundle(tmp_path, widths=(4, 32, 16, 2), seed=3)
    rows = _rows(64)
    mine, ref = activation_ranges(mp, rows, device="cpu"), \
        jax_ranges(mp, rows)
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        assert a["absmax"] == pytest.approx(b["absmax"], rel=1e-5)
        assert a["p50"] == pytest.approx(b["p50"], rel=1e-5)


# -------------------------------------------------- engine tier selection ---
def test_engine_tier_modes(tmp_path, monkeypatch):
    mp = _bundle(tmp_path)
    rows = _rows(128)
    budget = _gate_budget(mp, rows)
    _gate(mp, rows)
    x = torch.from_numpy(rows)

    # auto on the CPU: serve f32
    eng = InferenceEngine.get(mp, "cpu")
    assert eng.tier == "f32" and eng.route == "sequential"

    # never pins f32 even with a passing gate
    monkeypatch.setenv("REPRO_QUANT", "never")
    InferenceEngine.invalidate(mp)
    y_f32 = InferenceEngine.get(mp, "cpu").apply_batched(x)

    # force serves the gated int8 tier on any device, via the plain version
    monkeypatch.setenv("REPRO_QUANT", "force")
    InferenceEngine.invalidate(mp)
    eng = InferenceEngine.get(mp, "cpu")
    assert eng.tier == "int8" and eng.route == "fused_mlp_int8"
    served = _m.counter("repro_quant_served_rows_total",
                        "rows served by the gated int8 tier", ("bundle",))
    before = served.value(bundle=mp)
    plain = registry.get_spec("fused_mlp_int8").plain_calls
    yq = eng.apply_batched(x[:100])
    assert served.value(bundle=mp) == before + 100
    assert registry.get_spec("fused_mlp_int8").plain_calls == plain + 1
    assert torch.isfinite(yq).all()
    assert float(torch.sqrt(torch.mean((yq - y_f32[:100]) ** 2))) <= budget
    # bucket padding does not change a row
    assert torch.equal(yq, eng(x[:100]))


def test_engine_force_without_gate_serves_f32(tmp_path, monkeypatch):
    """force is not a gate bypass: no verdict (or a fail) means f32."""
    mp = _bundle(tmp_path)
    monkeypatch.setenv("REPRO_QUANT", "force")
    assert InferenceEngine.get(mp, "cpu").tier == "f32"
    rows = _rows(64)
    _gate_budget(mp, rows)
    _gate(mp, rows, scale_mult=64.0)
    eng = InferenceEngine.get(mp, "cpu")
    assert eng.tier == "f32"
    y_force = eng.apply_batched(torch.from_numpy(rows))
    monkeypatch.setenv("REPRO_QUANT", "never")
    InferenceEngine.invalidate(mp)
    y_never = InferenceEngine.get(mp, "cpu").apply_batched(
        torch.from_numpy(rows))
    assert torch.equal(y_force, y_never)


def test_engine_retrain_ungates(tmp_path, monkeypatch):
    mp = _bundle(tmp_path)
    rows = _rows(64)
    _gate_budget(mp, rows)
    _gate(mp, rows)
    monkeypatch.setenv("REPRO_QUANT", "force")
    assert InferenceEngine.get(mp, "cpu").tier == "int8"
    # rewrite: fresh weights, stale verdict -> f32 until gated again
    _bundle(tmp_path, seed=9)
    assert InferenceEngine.get(mp, "cpu").tier == "f32"


def test_engine_serves_the_blessed_scale_mult(tmp_path, monkeypatch):
    """A verdict that passed at scale_mult=2 is served at scale_mult=2."""
    from repro_torch.kernels.fused_mlp.ops import mlp_stack_from_spec
    mp = _bundle(tmp_path)
    rows = _rows(64)
    budgets.set_rmse_budget(mp, 1e9)
    _gate(mp, rows, scale_mult=2.0)
    monkeypatch.setenv("REPRO_QUANT", "force")
    eng = InferenceEngine.get(mp, "cpu")
    _, weights, _, _ = mlp_stack_from_spec(eng.spec, eng.params,
                                           torch.zeros(1, 4))
    want = quantize.quantize_weights_per_channel(weights[0], scale_mult=2.0,
                                                 device="cpu")
    assert torch.equal(eng._packed.qlayers[0][0], want[0])
    assert torch.equal(eng._packed.qlayers[0][1], want[1])


def test_unreadable_verdict_serves_f32_and_counts(tmp_path, monkeypatch):
    """Only OSError/ValueError from reading the verdict are answered with
    f32 (and counted); any other fault raises."""
    from repro_torch.quant import gate
    mp = _bundle(tmp_path)
    monkeypatch.setenv("REPRO_QUANT", "force")
    errors = _m.counter("repro_quant_verdict_read_errors_total",
                        "gate verdicts that could not be read at bundle "
                        "load (served f32)", ("bundle",))
    before = errors.value(bundle=mp)

    def unreadable(path):
        raise OSError("verdict file unreadable")

    monkeypatch.setattr(gate, "gate_passed", unreadable)
    assert InferenceEngine.get(mp, "cpu").tier == "f32"
    assert errors.value(bundle=mp) == before + 1

    def broken(path):
        raise KeyError("not a read error")

    monkeypatch.setattr(gate, "gate_passed", broken)
    InferenceEngine.invalidate(mp)
    with pytest.raises(KeyError):
        InferenceEngine.get(mp, "cpu")


def test_jax_verdicts_are_not_read(tmp_path, monkeypatch):
    """A passing verdict written by the JAX gate does not gate the
    port: its namespace is separate."""
    import repro.tune.cache as jcache
    from repro.quant.budgets import set_rmse_budget as jax_budget
    from repro.quant.gate import gate_bundle as jax_gate
    from repro.tune.cache import TuneCache as JaxCache
    monkeypatch.setattr(jcache, "_default", {
        "quant_gate": JaxCache("quant_gate", path=tmp_path / "jax.json")})
    mp = _bundle(tmp_path)
    jax_budget(mp, 1e9)
    assert jax_gate(mp, _rows(32))["exact"]
    monkeypatch.setenv("REPRO_QUANT", "force")
    assert InferenceEngine.get(mp, "cpu").tier == "f32"
    assert tcache.ART.name == "tune_torch"


def test_select_tier_spec_resolution_order():
    base = registry.get_spec("fused_mlp")
    q = registry.quantized_variant(base)
    assert (base.name, q.name) == ("fused_mlp", "fused_mlp_int8")
    problem = {"widths": (4, 16, 2), "acts": ("relu", "identity"),
               "batch": 32, "ndim": 2, "dtype": "float32"}
    # ungated -> base; gated -> int8; explicit f32 pins base even gated;
    # explicit int8 bypasses the gate (direct testing only)
    assert registry.select_tier_spec(base, problem, gated=False) == \
        (base, "f32")
    assert registry.select_tier_spec(base, problem, gated=True) == \
        (q, "int8")
    assert registry.select_tier_spec(base, problem, gated=True,
                                     explicit="f32")[0] is base
    assert registry.select_tier_spec(base, problem, gated=False,
                                     explicit="int8")[0] is q
    # a problem the int8 variant can't hold falls back to base
    fat = dict(problem, widths=(8, 60000, 2))
    assert registry.select_tier_spec(base, fat, gated=True)[0] is base
    # a kernel with no quantized twin always resolves itself
    assert registry.quantized_variant(q) is None
    assert registry.select_tier_spec(q, None, gated=True)[0] is q


# -------------------------------------------------------------- tune cache ---
def test_tune_cache_schema2_atomic_and_not_schema2_reads_empty(tmp_path):
    path = tmp_path / "k.json"
    c = TuneCache("k", path=path)
    c.put("a", {"params": {"block_rows": 8}, "exact": True})
    c.put("b", {"params": {"block_rows": 4}, "exact": False})
    data = json.loads(path.read_text())
    assert data == {"schema": 2, "kernel": "k", "entries": {
        "a": {"params": {"block_rows": 8}, "exact": True},
        "b": {"params": {"block_rows": 4}, "exact": False}}}
    assert not list(tmp_path.glob("*.tmp"))
    # a second cache on the same file merges rather than clobbers
    TuneCache("k", path=path).put("c", {"params": {"x": 1}, "exact": True})
    assert sorted(c.entries()) == ["a", "b", "c"]
    # a flat (schema-1 style) or torn file is a miss, never a crash
    path.write_text(json.dumps({"a": {"batch_tile": 64, "exact": True}}))
    assert TuneCache("k", path=path).get("a") is None
    path.write_text("{torn")
    assert TuneCache("k", path=path).entries() == {}


def test_best_params_and_shape_key(monkeypatch, tmp_path):
    monkeypatch.setitem(tcache._default, "k",
                        TuneCache("k", path=tmp_path / "k.json"))
    tcache.default_cache("k").put("hit", {"params": {"block_rows": 8},
                                          "exact": True})
    tcache.default_cache("k").put("fail", {"params": {"block_rows": 4},
                                           "exact": False})
    lookups = _m.counter("repro_tune_cache_lookups_total",
                         "tune-cache lookups by outcome",
                         ("kernel", "outcome"))
    hits = lookups.value(kernel="k", outcome="hit")
    assert best_params("k", ["fail", "hit"]) == {"block_rows": 8}
    assert best_params("k", ["fail", "none"]) is None
    assert lookups.value(kernel="k", outcome="hit") == hits + 1
    assert tcache.shape_key((6, 16, 1), torch.float32, "cuda", 64) == \
        "6-16-1|float32|cuda|b64"
    from repro.tune.cache import shape_key as jax_key
    assert tcache.shape_key((6, 16, 1), "float32", "cpu", 64) == \
        jax_key((6, 16, 1), np.float32, "cpu", 64)


def test_metrics_dump_matches_reference_format():
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    dumps = []
    for reg in (_m.MetricsRegistry(), JaxRegistry()):
        reg.counter("c_total", "a counter", ("k",)).inc(2, k='a"b')
        reg.gauge("g", "a gauge").set(float("inf"))
        h = reg.histogram("h_seconds", "a histogram", (), buckets=(0.1, 1))
        h.observe(0.5)
        h.observe(5)
        dumps.append(reg.dump())
    assert dumps[0] == dumps[1]
    assert 'c_total{k="a\\"b"} 2' in dumps[0] and "g +Inf" in dumps[0]
