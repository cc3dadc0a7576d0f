"""Port parity: functor parser, TensorMap, SurrogateDB and
InferenceEngine of repro_torch.core against repro.core."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.apps import (binomial, bonds, minibude, miniweather,  # noqa: E402
                        particlefilter)
from repro.core.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro.nn.serialize import save_model as jax_save  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

_PF = particlefilter.H * particlefilter.W
# every app's functor declaration (and the quickstart's), beside the
# object the app built from it
FUNCTORS = {
    "binomial-in": ("bin_in: [i, 0:5] = ([i, 0:5])", binomial._ifn),
    "binomial-out": ("bin_out: [i, 0:1] = ([i, 0:1])", binomial._ofn),
    "bonds-in": ("bond_in: [i, 0:4] = ([i, 0:4])", bonds._ifn),
    "bonds-out": ("bond_out: [i, 0:2] = ([i, 0:2])", bonds._ofn),
    "minibude-in": ("bude_in: [i, 0:6] = ([i, 0:6])", minibude._ifn),
    "minibude-out": ("bude_out: [i, 0:1] = ([i, 0:1])", minibude._ofn),
    "miniweather-in": ("mw_in: [i, j, 0:5, 0:4] = ([i-1, j, 0:4], "
                       "[i+1, j, 0:4], [i, j-1:j+2, 0:4])",
                       miniweather.stencil_fn),
    "miniweather-out": ("mw_out: [i, j, 0:4] = ([i, j, 0:4])",
                        miniweather.point_fn),
    "particlefilter-in": (f"pf_in: [i, 0:{_PF}] = ([i, 0:{_PF}])",
                          particlefilter.frame_fn),
    "particlefilter-out": ("pf_out: [i, 0:2] = ([i, 0:2])",
                           particlefilter.loc_fn),
    "quickstart-in": ("ifnctr: [i, j, 0:5] = ([i-1,j],[i+1,j],[i,j-1:j+2])",
                      None),
    "quickstart-out": ("ofnctr: [i, j] = ([i,j])", None),
    "strided": ("s: [i] = ([2*i])", None),
}
# array shape and ranges each functor is mapped over
MAPS = {
    "binomial-in": ((12, 5), {"i": (0, 12)}),
    "binomial-out": ((12, 1), {"i": (0, 12)}),
    "bonds-in": ((9, 4), {"i": (0, 9)}),
    "bonds-out": ((9, 2), {"i": (0, 9)}),
    "minibude-in": ((16, 6), {"i": (0, 16)}),
    "minibude-out": ((16, 1), {"i": (0, 16)}),
    "miniweather-in": ((miniweather.NY, miniweather.NX, 4),
                       miniweather.RANGES),
    "miniweather-out": ((miniweather.NY, miniweather.NX, 4),
                        miniweather.RANGES),
    "particlefilter-in": ((3, _PF), {"i": (0, 3)}),
    "particlefilter-out": ((3, 2), {"i": (0, 3)}),
    "quickstart-in": ((34, 34), {"i": (1, 33), "j": (1, 33)}),
    "quickstart-out": ((34, 34), {"i": (1, 33), "j": (1, 33)}),
    "strided": ((20,), {"i": (0, 8)}),
}


@pytest.mark.parametrize("name", sorted(FUNCTORS))
def test_functor_parse_matches_jax(name):
    decl, app_obj = FUNCTORS[name]
    jf, tf = jcore.tensor_functor(decl), tcore.tensor_functor(decl)
    if app_obj is not None:
        assert dataclasses.astuple(jf) == dataclasses.astuple(app_obj)
    assert dataclasses.astuple(tf) == dataclasses.astuple(jf)
    assert tf.sweep_symbols == jf.sweep_symbols
    assert tf.n_features == jf.n_features


@pytest.mark.parametrize("name", sorted(MAPS))
def test_tensor_map_bit_exact_against_jax(name):
    decl = FUNCTORS[name][0]
    shape, ranges = MAPS[name]
    rng = np.random.default_rng(len(name))
    a = rng.standard_normal(shape).astype(np.float32)
    jtm = jcore.TensorMap(jcore.tensor_functor(decl), jnp.asarray(a), ranges)
    ttm = tcore.TensorMap(tcore.tensor_functor(decl), torch.from_numpy(a),
                          ranges)
    want = np.asarray(jtm.to_tensor())
    np.testing.assert_array_equal(ttm.to_tensor().numpy(), want)
    assert ttm.tensor_shape == jtm.tensor_shape
    assert ttm.min_array_shape() == jtm.min_array_shape()

    y = rng.standard_normal(want.shape).astype(np.float32)
    template = rng.standard_normal(shape).astype(np.float32)
    caller = torch.from_numpy(template.copy())
    got = tcore.TensorMap(ttm.functor, caller, ranges, "from").from_tensor(
        torch.from_numpy(y))
    exp = jcore.TensorMap(jtm.functor, jnp.asarray(template), ranges,
                          "from").from_tensor(jnp.asarray(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # functional, as in JAX: the caller's array is left as it was
    np.testing.assert_array_equal(caller.numpy(), template)


def test_from_tensor_clamps_out_of_range_start_like_jax():
    decl = "c: [i, 0:2] = ([i+4, 0:2])"
    ranges = {"i": (0, 8)}  # rows 4..11 of a 10-row array: start clamps
    y = np.arange(16, dtype=np.float32).reshape(8, 2)
    exp = jcore.TensorMap(jcore.tensor_functor(decl), jnp.zeros((10, 2)),
                          ranges, "from").from_tensor(jnp.asarray(y))
    got = tcore.TensorMap(tcore.tensor_functor(decl), torch.zeros((10, 2)),
                          ranges, "from").from_tensor(torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(got[2:].numpy(), y)
    with pytest.raises(ValueError, match="outside"):
        tcore.TensorMap(tcore.tensor_functor(decl), torch.zeros((10, 2)),
                        ranges).to_tensor()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_written_by_one_package_loads_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(0)
    chunks = [(rng.standard_normal((5, 6)).astype(np.float32),
               rng.standard_normal((5, 1)).astype(np.float32), 0.25 * k)
              for k in range(3)]
    w_db, r_db = ((jcore.SurrogateDB, tcore.SurrogateDB) if writer == "jax"
                  else (tcore.SurrogateDB, jcore.SurrogateDB))
    db = w_db(tmp_path / "db")
    for x, y, rt in chunks:
        db.group("bude").append(x, y, rt)
    db.flush()
    d = r_db(tmp_path / "db").group("bude").load()
    np.testing.assert_array_equal(d["inputs"],
                                  np.concatenate([c[0] for c in chunks]))
    np.testing.assert_array_equal(d["outputs"],
                                  np.concatenate([c[1] for c in chunks]))
    np.testing.assert_array_equal(d["runtime"], [0.0, 0.25, 0.5])


def _bundle(path, net, seed, norm=True):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0))
    params = [{k: jnp.asarray((rng.standard_normal(v.shape) * 0.5)
                              .astype(np.float32)) for k, v in p.items()}
              for p in shapes]
    extra = None
    if norm:
        ish, osh = net.in_shape[1:], net.out_shape()[1:]
        extra = {"x_mu": rng.standard_normal(ish).tolist(),
                 "x_sd": (rng.uniform(0.5, 2.0, ish)).tolist(),
                 "y_mu": rng.standard_normal(osh).tolist(),
                 "y_sd": (rng.uniform(0.5, 2.0, osh)).tolist()}
    return jax_save(path, net, params, extra=extra)


ENGINE_NETS = {
    "mlp-norm": (lambda: jl.MLP((1, 5), [16, 8], 2), True, (13, 5)),
    "mlp-dropout": (lambda: jl.MLP((1, 5), [16], 1, dropout=0.2), False,
                    (7, 5)),
    "cnn-norm": (lambda: jl.CNN((1, 8, 8, 2), [(4, 3, 2)], [8], 2), True,
                 (3, 8, 8, 2)),
}


@pytest.mark.parametrize("name", sorted(ENGINE_NETS))
def test_engine_matches_jax_engine(tmp_path, name):
    make, norm, x_shape = ENGINE_NETS[name]
    path = _bundle(tmp_path / name, make(), seed=1, norm=norm)
    x = np.random.default_rng(2).standard_normal(x_shape).astype(np.float32)
    want = np.asarray(JaxEngine.get(path)(jnp.asarray(x)))
    eng = InferenceEngine.get(path, device="cpu")
    assert eng.route == "sequential"
    got = eng(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    batched = eng.apply_batched(torch.from_numpy(x)).numpy()
    assert batched.shape == want.shape
    np.testing.assert_allclose(batched, want, rtol=1e-5, atol=1e-5)


def test_engine_reloads_on_fingerprint_change(tmp_path):
    net = jl.MLP((1, 5), [8], 1)
    path = _bundle(tmp_path / "b", net, seed=1)
    x = torch.from_numpy(np.ones((4, 5), np.float32))
    eng = InferenceEngine.get(path, "cpu")
    y1 = eng(x)
    assert InferenceEngine.get(path, "cpu") is eng
    _bundle(tmp_path / "b", net, seed=2)  # retrain in place
    future = os.stat(os.path.join(path, "params.npz")).st_mtime_ns + 10**9
    for f in ("spec.json", "params.npz"):
        os.utime(os.path.join(path, f), ns=(future, future))
    eng2 = InferenceEngine.get(path, "cpu")
    assert eng2 is eng
    assert not torch.equal(eng2(x), y1)
    InferenceEngine.invalidate(path)
    eng3 = InferenceEngine.get(path, "cpu")
    assert eng3 is not eng
    assert torch.equal(eng3(x), eng2(x))


def test_entry_points_need_a_card_unless_told_cpu(tmp_path):
    path = _bundle(tmp_path / "b", jl.MLP((1, 5), [8], 1), seed=1)
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.approx_ml(lambda x: {"y": x}, inputs={}, outputs={},
                            mode="infer", model=path)
