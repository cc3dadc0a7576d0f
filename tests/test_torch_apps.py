"""Port parity of the bonds and binomial apps: inputs, accurate paths,
collect regions, QoI metrics and surrogate spaces against repro.apps, on
the CPU."""
import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro.apps import binomial as jbin  # noqa: E402
from repro.apps import bonds as jbonds  # noqa: E402
from repro_torch.apps import binomial as tbin  # noqa: E402
from repro_torch.apps import bonds as tbonds  # noqa: E402

N = 256
# bonds: a sum of <= 60 discounted coupons in each framework's reduction
# order, exp in two libms: ~1e-7 relative on prices up to ~190
BONDS_TOL = dict(rtol=1e-5, atol=1e-5)
# binomial: 256 levels of backward induction, each spot price u**k from
# pow in two libms (u**256 carries ~256 ulps of u's rounding), the
# errors compounding over the levels: ~1e-4 absolute on prices in [0, 100]
BINOMIAL_TOL = dict(rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("app", [tbonds, tbin], ids=["bonds", "binomial"])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_inputs_match_jax(app, seed):
    ref = jbonds if app is tbonds else jbin
    np.testing.assert_array_equal(app.make_inputs(N, seed, device="cpu")
                                  .numpy(), np.asarray(ref.make_inputs(N, seed)))


@pytest.mark.parametrize("seed", [0, 3])
def test_bond_valuations_match_jax(seed):
    got = tbonds.valuations(tbonds.make_inputs(N, seed, device="cpu"))
    want = np.asarray(jbonds.valuations(jbonds.make_inputs(N, seed)))
    assert tuple(got.shape) == (N, 2)
    np.testing.assert_allclose(got.numpy(), want, **BONDS_TOL)


def test_bond_at_zero_accrual_has_no_accrued_interest():
    z = torch.tensor([[0.05, 0.03, 10.0, 0.0]])
    assert abs(float(tbonds.valuations(z)[0, 0])) < 1e-6


@pytest.mark.parametrize("seed", [0, 3])
def test_binomial_prices_match_jax(seed):
    got = tbin.prices(tbin.make_inputs(N, seed, device="cpu"))
    want = np.asarray(jbin.prices(jbin.make_inputs(N, seed)))
    assert tuple(got.shape) == (N,)
    np.testing.assert_allclose(got.numpy(), want, **BINOMIAL_TOL)


def test_binomial_put_price_bounds():
    """An American put is worth at least its exercise value and at most
    the strike (tests/test_apps.py's bounds)."""
    opts = tbin.make_inputs(64, device="cpu")
    pr = tbin.prices(opts)
    S, K = opts[:, 0], opts[:, 1]
    assert (pr >= torch.clamp(K - S, min=0) - 1e-3).all()
    assert (pr <= K + 1e-3).all()


@pytest.mark.parametrize("name", ["bonds", "binomial"])
def test_collect_rows_match_jax(tmp_path, name):
    tapp, japp = {"bonds": (tbonds, jbonds), "binomial": (tbin, jbin)}[name]
    tol = BONDS_TOL if name == "bonds" else BINOMIAL_TOL
    n = 64
    key = "bonds" if name == "bonds" else "opts"
    jr = japp.make_region(n, "collect", database=str(tmp_path / "j"))
    jr(**{key: japp.make_inputs(n)})
    jr.db.flush()
    tr = tapp.make_region(n, "collect", database=str(tmp_path / "t"),
                          device="cpu")
    out = tr(**{key: tapp.make_inputs(n, device="cpu")})["out"]
    tr.db.flush()
    jd, td = jr.db.group(name).load(), tr.db.group(name).load()
    np.testing.assert_array_equal(td["inputs"], jd["inputs"])
    assert td["outputs"].shape == jd["outputs"].shape
    np.testing.assert_allclose(td["outputs"], jd["outputs"], **tol)
    np.testing.assert_array_equal(out.numpy(), td["outputs"])


def test_qoi_errors_and_spaces_match_jax():
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(11, 2)).astype(np.float32)
    approx = ref + 0.01
    assert tbonds.qoi_error(torch.from_numpy(ref), torch.from_numpy(
        approx)) == pytest.approx(jbonds.qoi_error(ref, approx))
    assert tbin.qoi_error(torch.from_numpy(ref[:, :1]), torch.from_numpy(
        approx[:, :1])) == pytest.approx(jbin.qoi_error(ref[:, :1],
                                                        approx[:, :1]))
    assert tbonds.surrogate_space() == jbonds.surrogate_space()
    assert tbin.surrogate_space() == jbin.surrogate_space()
