"""Port parity: repro_torch.nn layers and bundles against repro.nn."""
import json

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.nn import layers as jl  # noqa: E402
from repro.nn import serialize as jser  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402
from repro_torch.nn import serialize as tser  # noqa: E402


def _random_params(net, seed):
    """JAX-shaped parameters with every leaf drawn from numpy (biases and
    LayerNorm affine included, so none of them is trivially zero/one)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0))
    return [{k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in layer.items()} for layer in shapes]


def _port(net, params_np):
    spec = net.spec()
    return tl.from_spec(spec).load_params(tser.params_from_jax(spec, params_np))


NETS = {
    **{f"mlp-{act}": (lambda act=act: jl.MLP((1, 8), [16, 12], 3, act=act),
                      (5, 8))
       for act in ("relu", "gelu", "tanh", "silu", "sigmoid", "identity")},
    "mlp-dropout": (lambda: jl.MLP((1, 8), [16], 2, dropout=0.3), (5, 8)),
    "mlp-layernorm": (lambda: jl.Sequential(
        [jl.Dense(16), jl.LayerNorm(), jl.Activation("gelu"),
         jl.Dense(4, use_bias=False)], (1, 8)), (5, 8)),
    # SAME stride 2 over odd (9) and even (10) extents: XLA pads the odd
    # extra row/column at the end
    "cnn-same-stride2-pool": (lambda: jl.CNN(
        (1, 9, 10, 2), [(4, 3, 2), (6, 2, 1)], [8], 2, pool=2),
        (3, 9, 10, 2)),
    "cnn-valid-flatten": (lambda: jl.Sequential(
        [jl.Conv2D(3, 3, 2, "VALID"), jl.Activation("relu"), jl.Flatten(),
         jl.Dense(2)], (1, 8, 8, 1)), (2, 8, 8, 1)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_port_matches_jax_apply(name):
    make, x_shape = NETS[name]
    net = make()
    params = _random_params(net, seed=len(name))
    x = np.random.default_rng(7).standard_normal(x_shape).astype(np.float32)
    want = np.asarray(net.apply(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x)))
    with torch.no_grad():
        got = _port(net, params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["mlp-layernorm", "cnn-same-stride2-pool"])
def test_out_shape_and_spec_match_jax(name):
    net = NETS[name][0]()
    port = tl.from_spec(net.spec())
    assert port.spec() == net.spec()
    assert tuple(port.out_shape()) == tuple(net.out_shape())


def test_params_from_jax_rejects_wrong_structure():
    net = jl.MLP((1, 4), [8], 1)
    params = _random_params(net, 0)
    bad = [dict(params[0], w=params[0]["w"][:, :3])] + params[1:]
    with pytest.raises(ValueError):
        tser.params_from_jax(net.spec(), bad)
    with pytest.raises(ValueError):
        tser.params_from_jax(net.spec(), params[:1])


@pytest.mark.parametrize("name", ["mlp-layernorm", "cnn-same-stride2-pool"])
def test_jax_bundle_loads_bit_identical(tmp_path, name):
    net = NETS[name][0]()
    params = _random_params(net, 3)
    path = jser.save_model(tmp_path / "b", net,
                           jax.tree.map(jnp.asarray, params),
                           extra={"note": "x"})
    tnet, tparams, spec = tser.load_model(path, device="cpu")
    assert spec == json.loads((tmp_path / "b" / "spec.json").read_text())
    for want, got in zip(params, tparams):
        assert sorted(want) == list(got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("name", ["mlp-layernorm", "cnn-same-stride2-pool"])
def test_port_bundle_loads_in_jax(tmp_path, name):
    net = NETS[name][0]()
    params = _random_params(net, 4)
    port = _port(net, params)
    path = tser.save_model(tmp_path / "b", port, extra={"x_mu": [0.0]})
    jnet, jparams, spec = jser.load_model(path)
    assert spec["extra"] == {"x_mu": [0.0]}
    assert jnet.spec() == net.spec()
    for want, got in zip(params, jparams):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_seeded_init_is_he_normal_and_repeatable():
    a = tl.MLP((1, 6), [256, 128], 1).init(seed=0)
    b = tl.MLP((1, 6), [256, 128], 1).init(seed=0)
    for pa, pb in zip(a.param_list(), b.param_list()):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    w = a.param_list()[2]["w"]  # Dense(128) after Dense(256) + act
    assert abs(float(w.std()) - (2.0 / 256) ** 0.5) < 0.01
    assert float(a.param_list()[0]["b"].abs().max()) == 0.0
