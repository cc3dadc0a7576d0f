"""Port parity: repro_torch.nas (search space, GP, BO, surrogate training)
and train-time Dropout against repro.nas and repro.nn, on the CPU."""
import json

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps import ALL_APPS as J_APPS  # noqa: E402
from repro.core.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.nas import gp as jgp  # noqa: E402
from repro.nas import nested as jnested  # noqa: E402
from repro.nas import space as jspace  # noqa: E402
from repro.nas import train_surrogate as jtrain  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro.nn.serialize import save_model as jax_save  # noqa: E402
from repro_torch.apps import ALL_APPS as T_APPS  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.nas import gp as tgp  # noqa: E402
from repro_torch.nas import nested as tnested  # noqa: E402
from repro_torch.nas import space as tspace  # noqa: E402
from repro_torch.nas import train_surrogate as ttrain  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402
from repro_torch.nn.serialize import params_from_jax, save_model  # noqa: E402

APPS = sorted(J_APPS)
# parameters after a few epochs of the same Adam on the same batches from
# the same weights: the two frameworks' gradients differ in the last bits
# of their reductions, and Adam carries that forward over the steps
PARAM_ATOL = 1e-5
# both engines compute the same f32 forward in their own reduction order
ENGINE_TOL = dict(rtol=1e-5, atol=1e-5)


def test_all_apps_match():
    assert sorted(T_APPS) == APPS


@pytest.mark.parametrize("app", APPS)
def test_arch_space_decodes_like_jax(app):
    space_cfg = T_APPS[app].surrogate_space()
    assert space_cfg == J_APPS[app].surrogate_space()
    ja, ta = jspace.arch_space(space_cfg), tspace.arch_space(space_cfg)
    assert [(d.name, d.lo, d.hi, d.kind) for d in ta.dims] == \
        [(d.name, d.lo, d.hi, d.kind) for d in ja.dims]
    U = np.vstack([np.zeros(ta.d), np.ones(ta.d),
                   ta.sample(np.random.default_rng(len(app)), 16)])
    for u in U:
        assert ta.decode(u) == ja.decode(u)


def test_hyper_space_and_dim_kinds_decode_like_jax():
    jh, th = jspace.hyper_space(), tspace.hyper_space()
    for u in np.random.default_rng(0).uniform(0, 1, (32, th.d)):
        assert th.decode(u) == jh.decode(u)
    dims = [("a", 2, 12, "int"), ("b", 64, 4096, "log2"), ("c", 0.1, 0.8,
                                                           "float")]
    js = jspace.Space([jspace.Dim(*d) for d in dims])
    ts = tspace.Space([tspace.Dim(*d) for d in dims])
    for u in ([0.0, 1.0, 0.5], [0.49, 0.51, 0.0], [1.0, 0.0, 1.0]):
        assert ts.decode(u) == js.decode(u)
    with pytest.raises(ValueError):
        tspace.Dim("x", 0, 1, "cubic").decode(0.5)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_build_net_spec_matches_jax(app, dropout):
    space_cfg = T_APPS[app].surrogate_space()
    aspace = tspace.arch_space(space_cfg)
    for u in aspace.sample(np.random.default_rng(7), 6):
        cfg = aspace.decode(u)
        jnet = jspace.build_net(space_cfg, cfg, dropout=dropout)
        tnet = tspace.build_net(space_cfg, cfg, dropout=dropout)
        assert tnet.spec() == jnet.spec(), cfg
        assert tuple(tnet.out_shape()) == tuple(jnet.out_shape())


def test_miniweather_and_particlefilter_stacks():
    """The two CNN shapes build_net makes: a same-size conv stack and a
    flatten -> fc regression head."""
    mw = T_APPS["miniweather"].surrogate_space()
    net = tspace.build_net(mw, {"k1": 3, "ch1": 8, "k2": 4})
    assert [layer["kind"] for layer in net.spec()["layers"]] == \
        ["conv2d", "act", "conv2d", "act", "conv2d"]
    assert net.out_shape() == (1, 30, 30, 4)
    pf = T_APPS["particlefilter"].surrogate_space()
    net = tspace.build_net(pf, {"conv_k": 3, "stride": 2, "pool": 2,
                                "fc2": 64})
    assert [layer["kind"] for layer in net.spec()["layers"]] == \
        ["conv2d", "act", "maxpool2d", "flatten", "dense", "act", "dense"]
    assert net.out_shape() == (1, 2)


def test_matern52_and_gp_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (30, 3))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2]
    Xs = rng.uniform(0, 1, (50, 3))
    for ls, var in ((0.1, 1.0), (0.5, 2.0)):
        np.testing.assert_array_equal(tgp.matern52(X, Xs, ls, var),
                                      jgp.matern52(X, Xs, ls, var))
    jg, tg = jgp.GP().fit(X, y), tgp.GP().fit(X, y)
    assert tg.ls == jg.ls
    for a, b in zip(tg.predict(Xs), jg.predict(Xs)):
        np.testing.assert_array_equal(a, b)


def test_gp_fits_smooth_function():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (40, 2))
    gp = tgp.GP().fit(X, np.sin(3 * X[:, 0]) + X[:, 1] ** 2)
    Xs = rng.uniform(0.1, 0.9, (64, 2))
    mu, sd = gp.predict(Xs)
    assert np.sqrt(np.mean((mu - np.sin(3 * Xs[:, 0]) - Xs[:, 1] ** 2)
                           ** 2)) < 0.15
    assert (sd > 0).all()


def test_expected_improvement_and_pareto_front_equal_jax():
    rng = np.random.default_rng(3)
    mu, sd = rng.normal(size=64), rng.uniform(0, 1, 64)
    sd[:4] = 0.0
    np.testing.assert_array_equal(
        tnested.expected_improvement(mu, sd, 0.1),
        jnested.expected_improvement(mu, sd, 0.1))
    pts = rng.integers(0, 6, (40, 2))
    assert tnested.pareto_front(pts) == jnested.pareto_front(pts)
    assert tnested.pareto_front([(1, 5), (2, 2), (5, 1), (3, 3), (6, 6)]) \
        == [0, 1, 2]


def test_bo_minimize_history_equals_jax():
    def f(cfg):
        return (cfg["x"] - 0.3) ** 2 + 2 * (cfg["y"] - 0.7) ** 2

    dims = [("x", 0, 1), ("y", 0, 1)]
    got = tnested.bo_minimize(
        f, tspace.Space([tspace.Dim(*d) for d in dims]), iters=12, init=4)
    want = jnested.bo_minimize(
        f, jspace.Space([jspace.Dim(*d) for d in dims]), iters=12, init=4)
    assert got == want
    assert got[1] < 0.05


# --------------------------------------------------------------- fit ---

def _mlp_data(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    Y = np.concatenate([np.sin(X[:, :1]) + X[:, 1:2] * X[:, 2:3],
                        X[:, 3:4] ** 2], 1).astype(np.float32)
    return X, Y


def _cnn_data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6 * 6 * 3)).astype(np.float32)
    Y = (X.reshape(n, 6, 6, 3)[..., :2] * 0.5 + 1.0).reshape(n, -1)
    return X, Y.astype(np.float32)


FITS = {
    # weight decay, a large step, a partial batch left out; the
    # validation loss stops improving and patience 2 ends the run before
    # its 12 epochs (a 30-epoch run returns the same)
    "mlp": (lambda: jl.MLP((1, 5), [32, 16], 2), _mlp_data,
            dict(epochs=12, lr=0.1, weight_decay=0.01, batch_size=64,
                 patience=2)),
    # a miniweather-style same-size conv stack, reshaped rows
    "cnn": (lambda: jspace.build_net(
        {"kind": "cnn", "grid": (6, 6), "in_ch": 3, "out_ch": 2},
        {"k1": 3, "ch1": 4, "k2": 2}), _cnn_data,
        dict(epochs=4, batch_size=8, x_reshape=(6, 6, 3))),
}


def _port_from_jax_init(jnet, seed):
    """The port's net for ``jnet``, its ``init`` loading the JAX init."""
    spec = jnet.spec()
    init = params_from_jax(spec, jax.tree.map(
        np.asarray, jnet.init(jax.random.PRNGKey(seed))))
    tnet = tl.from_spec(spec)
    tnet.init = lambda seed=0: tnet.load_params(init)
    return tnet


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_matches_jax_from_the_same_init(name):
    make, data, kw = FITS[name]
    X, Y = data()
    jnet = make()
    jp, jr, js = jtrain.fit(jnet, X, Y, seed=1, **kw)
    tnet = _port_from_jax_init(jnet, seed=1)
    tp, tr, ts = ttrain.fit(tnet, X, Y, seed=1, device="cpu", **kw)
    assert ts == js
    assert tr == pytest.approx(jr, rel=1e-6)
    for want, got, held in zip(jp, tp, tnet.param_list()):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=PARAM_ATOL)
            assert torch.equal(held[k], got[k])
    # the net is left as the engine expects it
    assert not tnet.training
    assert not any(p.requires_grad for p in tnet.parameters())


def test_fit_stats_use_numpy_std_ddof0():
    """Normalization std is numpy's population std (ddof=0) + 1e-6, not
    torch.std's unbiased estimate."""
    X = np.array([[0.0], [1.0], [2.0], [10.0], [4.0]], np.float32)
    Y = np.array([[1.0], [3.0], [2.0], [7.0], [0.0]], np.float32)
    net = tl.MLP((1, 1), [4], 1)
    _, _, stats = ttrain.fit(net, X, Y, epochs=1, batch_size=2, device="cpu")
    tr = np.random.default_rng(0).permutation(5)[:4]
    assert stats["x_sd"] == (X[tr].std(0) + 1e-6).tolist()
    assert stats["y_sd"] == (Y[tr].std(0) + 1e-6).tolist()
    unbiased = float(torch.std(torch.from_numpy(X[tr]), dim=0)[0]) + 1e-6
    assert abs(stats["x_sd"][0] - unbiased) > 0.1


def test_adam_with_weight_decay_matches_jax():
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (3,), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(p) for p in params]
    jstate = ([jnp.zeros_like(p) for p in jparams],
              [jnp.zeros_like(p) for p in jparams], 0)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = ([torch.zeros_like(p) for p in tparams],
              [torch.zeros_like(p) for p in tparams], 0)
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jparams, jstate = jtrain._adam(jparams, [jnp.asarray(g) for g in
                                                 grads], jstate, 3e-3,
                                       wd=0.05)
        tstate = ttrain._adam(tparams, [torch.from_numpy(g) for g in grads],
                              tstate, 3e-3, wd=0.05)
    assert tstate[2] == jstate[2] == 5
    for got, want in zip(tparams + tstate[0] + tstate[1],
                         jparams + jstate[0] + jstate[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                                   atol=1e-9)


def test_latency_is_a_positive_median():
    net = tl.MLP((1, 5), [16], 1).init(0)
    assert ttrain.latency(net, (8, 5), reps=3, device="cpu") > 0


# ----------------------------------------------------------- dropout ---

def test_dropout_is_identity_in_eval_or_without_generator():
    net = tl.MLP((1, 8), [64], 2, dropout=0.5).init(0)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8))
                         .astype(np.float32))
    base = net.eval()(x)
    assert torch.equal(net(x, generator=torch.Generator().manual_seed(0)),
                       base)
    assert torch.equal(net.train()(x), base)


@pytest.mark.parametrize("rate", [0.2, 0.5, 0.8])
def test_dropout_keeps_one_minus_rate_and_scales(rate):
    layer = tl.Dropout(rate).train()
    x = torch.full((200, 500), 3.0)
    y = layer(x, torch.Generator().manual_seed(1))
    kept = y != 0
    # 100,000 Bernoulli draws: the kept share's std is below 0.0013
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        3.0 / (1 - rate)))
    again = layer(x, torch.Generator().manual_seed(1))
    assert torch.equal(again, y)
    assert not torch.equal(layer(x, torch.Generator().manual_seed(2)), y)


# ------------------------------------------------------ nested search ---

def _stub_fit(net, X, Y, **kw):
    """A deterministic stand-in for fit, equal in both packages: the
    error is a function of the spec and the hyper-parameters."""
    spec = json.dumps(net.spec(), sort_keys=True)
    h = sum(ord(c) * (i + 1) for i, c in enumerate(spec)) % 1000
    rmse = 1.0 + h / 1000 + 0.1 * kw.get("lr", 1e-3) \
        + 0.01 * kw.get("weight_decay", 0.0) + 1e-4 * kw.get("batch_size",
                                                             128)
    return [], rmse, {"x_mu": [], "spec": spec}


def _stub_latency(net, *args, **kw):
    widths = [layer.get("features", 0) for layer in net.spec()["layers"]]
    return 1e-4 * (1 + sum(widths))


class _Group:
    def __init__(self, X, Y):
        self.X, self.Y = X, Y

    def load(self):
        return {"inputs": self.X, "outputs": self.Y}


@pytest.mark.parametrize("app", ["bonds", "minibude", "particlefilter"])
def test_nested_search_with_stubs_matches_jax(app, monkeypatch):
    for mod in (jnested, tnested):
        monkeypatch.setattr(mod, "fit", _stub_fit)
        monkeypatch.setattr(mod, "latency", _stub_latency)
    group = _Group(np.zeros((4, 3), np.float32), np.zeros((4, 2), np.float32))
    kw = dict(outer_iters=7, inner_iters=4, seed=2, epochs=1, verbose=False)
    want = jnested.nested_search(J_APPS[app], group, **kw)
    got = tnested.nested_search(T_APPS[app], group, device="cpu", **kw)
    assert [t["arch"] for t in got["trials"]] == \
        [t["arch"] for t in want["trials"]]
    assert [(t["val_rmse"], t["latency"], t.get("hypers")) for t in
            got["trials"]] == [(t["val_rmse"], t["latency"], t.get("hypers"))
                               for t in want["trials"]]
    assert got["pareto"] == want["pareto"]
    assert tnested.best_trial(got)["arch"] == \
        jnested.best_trial(want)["arch"]


# ------------------------------------------------- bundle interchange ---

def test_port_trained_bundle_serves_in_jax_engine(tmp_path):
    X, Y = _mlp_data(300, seed=2)
    net = tl.MLP((1, 5), [24], 2, dropout=0.1)
    params, _, stats = ttrain.fit(net, X, Y, epochs=3, device="cpu")
    trial = {"net": net, "params": params, "stats": stats}
    path = tnested.save_trial(trial, tmp_path / "port")
    x = np.random.default_rng(3).normal(size=(17, 5)).astype(np.float32)
    got = InferenceEngine.get(path, "cpu")(torch.from_numpy(x)).numpy()
    want = np.asarray(JaxEngine.get(path)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **ENGINE_TOL)
    JaxEngine.invalidate(path)


def test_jax_trained_bundle_serves_in_port_engine(tmp_path):
    X, Y = _mlp_data(300, seed=2)
    net = jl.MLP((1, 5), [24], 2)
    params, _, stats = jtrain.fit(net, X, Y, epochs=3)
    path = jax_save(tmp_path / "jax", net, params, extra=stats)
    x = np.random.default_rng(3).normal(size=(17, 5)).astype(np.float32)
    want = np.asarray(JaxEngine.get(path)(jnp.asarray(x)))
    got = InferenceEngine.get(path, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **ENGINE_TOL)
    JaxEngine.invalidate(path)


def test_save_trial_invalidates_the_served_bundle(tmp_path):
    X, Y = _mlp_data(300, seed=2)
    net = tl.MLP((1, 5), [8], 2)
    params, _, stats = ttrain.fit(net, X, Y, epochs=1, device="cpu")
    path = save_model(tmp_path / "b", net, extra=stats)
    x = torch.from_numpy(X[:9])
    first = InferenceEngine.get(path, "cpu")(x)
    net2 = tl.MLP((1, 5), [8], 2)
    params2, _, stats2 = ttrain.fit(net2, X, Y, epochs=4, seed=3,
                                    device="cpu")
    tnested.save_trial({"net": net2, "params": params2, "stats": stats2},
                       path)
    with torch.no_grad():
        want = (net2((x - torch.tensor(stats2["x_mu"])) /
                     torch.tensor(stats2["x_sd"]))
                * torch.tensor(stats2["y_sd"]) + torch.tensor(stats2["y_mu"]))
    got = InferenceEngine.get(path, "cpu")(x)
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
