"""Port parity of the CNN apps (miniweather, particlefilter) and the
quickstart twin against repro.apps and examples/quickstart.py, on the
CPU."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps import miniweather as jmw  # noqa: E402
from repro.apps import particlefilter as jpf  # noqa: E402
from repro_torch.apps import miniweather as tmw  # noqa: E402
from repro_torch.apps import particlefilter as tpf  # noqa: E402
from repro_torch.nas.space import build_net  # noqa: E402
from repro_torch.nas.train_surrogate import fit  # noqa: E402
from repro_torch.nn.serialize import save_model  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# miniweather: XLA fuses the stencil update and rounds it its own way,
# a few f32 ulps a step on fields of magnitude up to 2, over 50 steps
MW_TOL = dict(rtol=1e-6, atol=1e-6)
# particlefilter: softmax and cumsum in two libraries' reduction orders
PF_TOL = dict(rtol=1e-5, atol=1e-5)


def test_miniweather_init_state_bit_equal():
    for seed in (0, 4):
        np.testing.assert_array_equal(tmw.init_state(seed, device="cpu")
                                      .numpy(),
                                      np.asarray(jmw.init_state(seed)))


@pytest.mark.parametrize("steps", [1, 10, 50])
def test_miniweather_run_matches_jax(steps):
    got = tmw.run(tmw.init_state(device="cpu"), steps)
    want = np.asarray(jmw.run(jmw.init_state(), steps))
    assert tuple(got.shape) == (tmw.NY, tmw.NX, tmw.NF)
    np.testing.assert_allclose(got.numpy(), want, **MW_TOL)
    # the boundary ring is never written
    s0 = tmw.init_state(device="cpu")
    assert torch.equal(got[0], s0[0]) and torch.equal(got[:, -1], s0[:, -1])


def test_miniweather_collect_rows_match_jax(tmp_path):
    jr = jmw.make_region(mode="collect", database=str(tmp_path / "j"))
    tr = tmw.make_region(mode="collect", database=str(tmp_path / "t"),
                         device="cpu")
    js, ts = jmw.init_state(), tmw.init_state(device="cpu")
    for _ in range(4):
        js = jr(state=js)["state"]
        ts = tr(state=ts)["state"]
    jd, td = jr.db.group("miniweather").load(), tr.db.group(
        "miniweather").load()
    assert td["inputs"].shape == jd["inputs"].shape == (4, 30, 30, 5, 4)
    assert td["outputs"].shape == jd["outputs"].shape == (4, 30, 30, 4)
    np.testing.assert_array_equal(td["inputs"][0], jd["inputs"][0])
    np.testing.assert_allclose(td["inputs"], jd["inputs"], **MW_TOL)
    np.testing.assert_allclose(td["outputs"], jd["outputs"], **MW_TOL)


def test_miniweather_qoi_error_and_space_match_jax():
    a = np.random.default_rng(0).normal(size=(32, 32, 4)).astype(np.float32)
    b = a + np.random.default_rng(1).normal(size=a.shape).astype(
        np.float32) * 0.1
    assert tmw.qoi_error(torch.from_numpy(a), torch.from_numpy(b)) == \
        pytest.approx(jmw.qoi_error(jnp.asarray(a), jnp.asarray(b)),
                      rel=1e-6)
    assert tmw.surrogate_space() == jmw.surrogate_space()


def test_miniweather_interleave_reduces_error(tmp_path):
    """Observation 4 (tests/test_apps.py's property, on the port):
    interleaving accurate steps cuts propagated error."""
    region = tmw.make_region(mode="collect", database=str(tmp_path / "db"),
                             device="cpu")
    s = tmw.init_state(device="cpu")
    for _ in range(60):
        s = region(state=s)["state"]
    region.db.flush()
    d = region.db.group("miniweather").load()
    X = d["inputs"].reshape(d["inputs"].shape[0], -1)
    Y = d["outputs"].reshape(d["outputs"].shape[0], -1)
    net = build_net(tmw.surrogate_space(), {"k1": 3, "ch1": 8, "k2": 0})
    _, rmse, stats = fit(net, X, Y, epochs=25, x_reshape=(30, 30, 20),
                         device="cpu")
    mp = save_model(tmp_path / "m", net, extra=stats)
    region2 = tmw.make_region(mode="predicated", model=str(mp),
                              device="cpu")
    s0 = tmw.init_state(device="cpu")
    ref = tmw.run(s0, 16)
    err_all = tmw.qoi_error(ref, tmw.run(s0, 16, region2, interleave=(0, 1)))
    err_mix = tmw.qoi_error(ref, tmw.run(s0, 16, region2, interleave=(1, 1)))
    assert np.isfinite(rmse) and np.isfinite(err_all)
    assert err_mix < err_all + 1e-9, (err_mix, err_all)


@pytest.mark.parametrize("n,seed", [(5, 0), (60, 3)])
def test_make_video_bit_equal(n, seed):
    jf, jt = jpf.make_video(n, seed=seed)
    tf, tt = tpf.make_video(n, seed=seed, device="cpu")
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_pf_step_with_jax_noise_matches_jax():
    """The reference's step, its noise drawn from jax.random keys, against
    the port's step fed the same noise, over a run of frames."""
    frames, _ = jpf.make_video(12, seed=1)
    key = jax.random.PRNGKey(4)
    parts = jnp.full((jpf.N_PART, 2), jpf.H * 0.3) + \
        jax.random.normal(key, (jpf.N_PART, 2)) * 2.0
    vels = jnp.zeros((jpf.N_PART, 2))
    tparts = torch.from_numpy(np.array(parts))
    tvels = torch.from_numpy(np.array(vels))
    for i, k in enumerate(jax.random.split(key, frames.shape[0])):
        (parts, vels), est = jpf._pf_step((parts, vels), frames[i], k)
        k1, k2, k3 = jax.random.split(k, 3)
        noise = [torch.from_numpy(np.array(a)) for a in (
            jax.random.normal(k1, (jpf.N_PART, 2)),
            jax.random.normal(k2, (jpf.N_PART, 2)), jax.random.uniform(k3))]
        tparts, tvels, test = tpf.pf_step(tparts, tvels,
                                          torch.from_numpy(np.array(
                                              frames[i])), *noise)
        np.testing.assert_allclose(test.numpy(), np.asarray(est), **PF_TOL)
        np.testing.assert_allclose(tparts.numpy(), np.asarray(parts),
                                   **PF_TOL)
        np.testing.assert_allclose(tvels.numpy(), np.asarray(vels), **PF_TOL)


def test_pf_resampling_clamps_past_the_last_particle():
    """A sampling position past the weights' sum (which rounding can put
    below 1) resamples the last particle, as the reference's gather
    clamps the index searchsorted puts past the end."""
    n = tpf.N_PART
    parts = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2) % 20 + 2
    frame = torch.zeros((tpf.H, tpf.W))
    zeros = torch.zeros((n, 2))
    p, v, _ = tpf.pf_step(parts, zeros, frame, zeros, zeros,
                          torch.tensor(1.5))
    assert torch.equal(p[-1], parts[-1]) and p.shape == parts.shape


def test_track_rmse_below_three():
    """tests/test_apps.py's bound on the reference, on the port."""
    frames, truth = tpf.make_video(60, seed=3, device="cpu")
    est = tpf.track(frames)
    assert tuple(est.shape) == (60, 2)
    assert tpf.qoi_error(truth, est) < 3.0
    assert torch.equal(tpf.track(frames), est)


def test_particlefilter_collect_and_qoi_match_jax(tmp_path):
    """Collected rows are the frames (bit-equal to the reference's video)
    and the filter's estimates; the QoI is the reference's metric."""
    n = 8
    tf, truth = tpf.make_video(n, device="cpu")
    tr = tpf.make_region(n, "collect", database=str(tmp_path / "t"),
                         device="cpu")
    loc = tr(frames=tf.reshape(n, -1))["loc"]
    td = tr.db.group("particlefilter").load()
    np.testing.assert_array_equal(
        td["inputs"], np.asarray(jpf.make_video(n)[0]).reshape(n, -1))
    assert td["outputs"].shape == (n, 2)
    np.testing.assert_array_equal(td["outputs"], loc.numpy())
    assert tpf.qoi_error(truth, loc) == pytest.approx(
        jpf.qoi_error(truth.numpy(), loc.numpy()), rel=1e-6)
    assert tpf.surrogate_space() == jpf.surrogate_space()


# ------------------------------------------------------- quickstart ---

def _reference_quickstart(t, workdir, steps, epochs):
    """examples/quickstart.py's main, on a given grid, step count and
    epoch count; returns its surrogate RMSE against the accurate step."""
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    from repro.core import approx_ml
    from repro.nas.train_surrogate import fit as jfit
    from repro.nn import MLP
    from repro.nn.serialize import save_model as jsave
    region = approx_ml(qs.smooth_step, name="smooth",
                       inputs={"t": (qs.ifn, qs.RANGES)},
                       outputs={"t": (qs.ofn, qs.RANGES)},
                       mode="collect", database=str(workdir / "db"))
    state = t
    for _ in range(steps):
        state = region(t=state)["t"]
    region.db.flush()
    d = region.db.group("smooth").load()
    net = MLP((1, 5), [32], 1)
    params, _, stats = jfit(net, d["inputs"].reshape(-1, 5),
                            d["outputs"].reshape(-1, 1), epochs=epochs)
    mp = jsave(workdir / "model", net, params, extra=stats)
    region2 = approx_ml(qs.smooth_step, name="smooth",
                        inputs={"t": (qs.ifn, qs.RANGES)},
                        outputs={"t": (qs.ofn, qs.RANGES)},
                        mode="predicated", model=str(mp))
    ref = qs.smooth_step(t)["t"]
    ml = region2(predicate=True, t=t)["t"]
    return float(jnp.sqrt(jnp.mean((ml - ref) ** 2))), d


def test_quickstart_twin_within_reference(tmp_path):
    from repro_torch.examples.quickstart import N, M, quickstart
    grid = np.random.default_rng(0).standard_normal((N, M)).astype(
        np.float32)
    res = quickstart(torch.from_numpy(grid), tmp_path / "port", steps=8,
                     epochs=6, device="cpu")
    want, jd = _reference_quickstart(jnp.asarray(grid), tmp_path / "jax",
                                     steps=8, epochs=6)
    assert res["samples"] == jd["inputs"].reshape(-1, 5).shape[0] == 8192
    assert res["accurate_exact"]
    # different initial weights (numpy He-normal against jax.random), the
    # same rows and training: the twin's error is held to the reference's
    assert res["surrogate_rmse"] <= 1.5 * want, (res["surrogate_rmse"], want)


def test_nas_search_twin_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import nas_search
    nas_search.main(["--app", "bonds", "--n", "256", "--outer", "2",
                     "--inner", "0", "--out", str(tmp_path),
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "explored 2 architectures" in out
    assert (tmp_path / "model" / "params.npz").exists()
