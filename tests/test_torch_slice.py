"""The port's slices end to end against the JAX package, at a small size
on the CPU: the minibude surrogate loop (collect -> bundle -> infer /
predicated) and its gated int8 tier (calibration rows -> gate -> int8
engine -> infer)."""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps import minibude as jmb  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro.nn.serialize import save_model as jax_save  # noqa: E402
from repro_torch.apps import minibude as tmb  # noqa: E402

N = 64
# energies sum 1,024 f32 pair terms in each framework's own reduction
# order; the sums differ by ~1e-6 relative, and no energy is near zero
RTOL = 1e-5


def test_inputs_and_molecule_match_jax():
    np.testing.assert_array_equal(tmb.make_inputs(N, device="cpu").numpy(),
                                  np.asarray(jmb.make_inputs(N)))
    mol = tmb.make_molecule(device="cpu")
    for k, v in jmb.MOL.items():
        np.testing.assert_array_equal(mol[k].numpy(), np.asarray(v))


def test_energies_match_jax():
    poses = tmb.make_inputs(N, device="cpu")
    want = np.asarray(jmb.energies(jmb.make_inputs(N)))
    np.testing.assert_allclose(tmb.energies(poses).numpy(), want,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """The same poses collected by both packages' regions."""
    tmp = tmp_path_factory.mktemp("slice")
    jr = jmb.make_region(N, "collect", database=str(tmp / "jdb"))
    jr(poses=jmb.make_inputs(N))
    jr.db.flush()
    tr = tmb.make_region(N, "collect", database=str(tmp / "tdb"),
                         device="cpu")
    tr(poses=tmb.make_inputs(N, device="cpu"))
    tr.db.flush()
    return (tmp, jr.db.group("minibude").load(),
            tr.db.group("minibude").load())


def test_collect_rows_match_jax(collected):
    _, jd, td = collected
    np.testing.assert_array_equal(td["inputs"], jd["inputs"])
    assert td["outputs"].shape == jd["outputs"].shape == (N, 1)
    np.testing.assert_allclose(td["outputs"], jd["outputs"], rtol=RTOL)
    assert td["runtime"].shape == (1,) and td["runtime"][0] > 0


@pytest.fixture(scope="module")
def bundle(collected):
    """A (6, 32, 16, 1) bundle with normalization from the collected rows,
    written by the JAX package."""
    tmp, jd, _ = collected
    X, Y = jd["inputs"], jd["outputs"]
    stats = {"x_mu": X.mean(0).tolist(), "x_sd": (X.std(0) + 1e-6).tolist(),
             "y_mu": Y.mean(0).tolist(), "y_sd": (Y.std(0) + 1e-6).tolist()}
    net = jl.MLP((1, 6), [32, 16], 1)
    params = net.init(jax.random.PRNGKey(0))
    return jax_save(tmp / "bundle", net, params, extra=stats)


def test_infer_matches_jax(bundle):
    want = jmb.make_region(N, "infer", model=bundle)(
        poses=jmb.make_inputs(N))["out"]
    got = tmb.make_region(N, "infer", model=bundle, device="cpu")(
        poses=tmb.make_inputs(N, device="cpu"))["out"]
    assert tuple(got.shape) == (N, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("predicate", [True, False])
def test_predicated_matches_jax(bundle, predicate):
    want = jmb.make_region(N, "predicated", model=bundle)(
        predicate=predicate, poses=jmb.make_inputs(N))["out"]
    got = tmb.make_region(N, "predicated", model=bundle, device="cpu")(
        predicate=predicate, poses=tmb.make_inputs(N, device="cpu"))["out"]
    # the surrogate's outputs as in test_infer, or the accurate energies
    atol = 1e-5 if predicate else 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=atol)


def test_qoi_error_matches_jax():
    ref = np.linspace(-3, 3, 11).astype(np.float32)
    approx = ref + 0.01
    assert tmb.qoi_error(torch.from_numpy(ref), torch.from_numpy(approx)) == \
        pytest.approx(jmb.qoi_error(ref, approx))
    assert tmb.surrogate_space() == jmb.surrogate_space()


@pytest.fixture
def quant_env(tmp_path, monkeypatch):
    """Both packages' gate namespaces under tmp_path, empty budget
    registries, no cached engines, and ``REPRO_QUANT=force`` (the CPU
    serves the int8 tier only when forced)."""
    import repro.tune.cache as jcache
    import repro_torch.tune.cache as tcache
    from repro.core.engine import InferenceEngine as JaxEngine
    from repro.quant.budgets import clear_budgets as jax_clear
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.quant.budgets import clear_budgets
    monkeypatch.setattr(jcache, "_default", {"quant_gate": jcache.TuneCache(
        "quant_gate", path=tmp_path / "jax_gate.json")})
    monkeypatch.setattr(tcache, "_default", {"quant_gate": tcache.TuneCache(
        "quant_gate", path=tmp_path / "torch_gate.json")})
    monkeypatch.setenv("REPRO_QUANT", "force")
    for clear in (jax_clear, clear_budgets, JaxEngine.invalidate,
                  InferenceEngine.invalidate):
        clear()
    yield
    for clear in (jax_clear, clear_budgets, JaxEngine.invalidate,
                  InferenceEngine.invalidate):
        clear()


def test_int8_slice_matches_jax(collected, tmp_path, quant_env,
                                monkeypatch):
    """collect -> calibration rows -> gate -> engine tier int8 -> infer,
    held against the JAX engine serving the same bundle, gated by the
    JAX gate, under REPRO_QUANT=force."""
    from repro.quant.budgets import set_rmse_budget as jax_budget
    from repro.quant.calibrate import calibration_rows as jax_rows
    from repro.quant.gate import gate_bundle as jax_gate
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels.fused_mlp.int8 import TOL
    from repro_torch.nn import MLP, save_model
    from repro_torch.quant.budgets import set_rmse_budget
    from repro_torch.quant.calibrate import calibration_rows
    from repro_torch.quant.gate import gate_bundle
    tmp, jd, td = collected
    rows = calibration_rows(str(tmp / "tdb"), "minibude")
    np.testing.assert_array_equal(rows, jax_rows(str(tmp / "jdb"),
                                                 "minibude"))
    X, Y = td["inputs"], td["outputs"]
    stats = {"x_mu": X.mean(0).tolist(), "x_sd": (X.std(0) + 1e-6).tolist(),
             "y_mu": Y.mean(0).tolist(), "y_sd": (Y.std(0) + 1e-6).tolist()}
    mp = save_model(tmp_path / "bundle", MLP((1, 6), [32, 16], 1).init(1),
                    extra=stats)
    # the rule of tests/test_quant.py: 5% of the f32 output RMS, here in
    # the physical units the gate measures
    y32 = tmb.make_region(len(rows), "infer", model=mp, device="cpu")(
        poses=torch.from_numpy(rows))["out"]
    budget = 0.05 * float(torch.sqrt(torch.mean(y32 ** 2)))
    set_rmse_budget(mp, budget)
    jax_budget(mp, budget)
    rec, jrec = gate_bundle(mp, rows, device="cpu"), jax_gate(mp, rows)
    assert rec["exact"] and jrec["exact"]
    assert rec["rmse"] == pytest.approx(jrec["rmse"], rel=1e-3)

    got = tmb.make_region(N, "infer", model=mp, device="cpu")(
        poses=tmb.make_inputs(N, device="cpu"))["out"]
    eng = InferenceEngine.get(mp, "cpu")
    assert (eng.tier, eng.route) == ("int8", "fused_mlp_int8")
    want = jmb.make_region(N, "infer", model=mp)(
        poses=jmb.make_inputs(N))["out"]
    from repro.core.engine import InferenceEngine as JaxEngine
    assert JaxEngine.get(mp).tier == "int8"
    # the int8 tolerance of the kernel, scaled by the engine's y_sd
    rtol, atol = TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol * stats["y_sd"][0])
    monkeypatch.setenv("REPRO_QUANT", "never")
    InferenceEngine.invalidate(mp)
    y_f32 = tmb.make_region(N, "infer", model=mp, device="cpu")(
        poses=tmb.make_inputs(N, device="cpu"))["out"]
    assert float(torch.sqrt(torch.mean((got - y_f32) ** 2))) <= budget
