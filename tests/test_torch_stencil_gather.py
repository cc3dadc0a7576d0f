"""Port parity: the stencil gather's plain version, op and registry
declaration against repro.kernels.stencil_gather (the jnp oracle and the
Pallas kernel in interpret mode), on the CPU.  A gather is exact: every
comparison is bit for bit."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps import miniweather  # noqa: E402
from repro.core.tensor_map import TensorMap as JaxTensorMap  # noqa: E402
from repro.kernels.stencil_gather import ops as jax_ops  # noqa: E402
from repro.kernels.stencil_gather.ref import stencil_gather_ref as jax_ref  # noqa: E402
from repro.kernels.stencil_gather.stencil_gather import (  # noqa: E402
    stencil_gather as jax_pallas)
from repro_torch.core.functor import tensor_functor  # noqa: E402
from repro_torch.core.tensor_map import TensorMap  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.stencil_gather import ops  # noqa: E402
from repro_torch.kernels.stencil_gather.ref import stencil_gather_ref  # noqa: E402
from repro_torch.kernels.stencil_gather.stencil_gather import (  # noqa: E402
    stencil_gather)

FIVE = ((0, 1), (2, 0), (1, 1), (0, 0), (1, 2))
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _grid(h, w, seed=0):
    return np.random.default_rng(seed).normal(size=(h, w)).astype(np.float32)


def _np(a):
    """Either package's array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,w,out_h,out_w,offsets,origin", [
    (40, 40, 36, 36, ((0, 1), (1, 0), (0, 0)), (1, 1)),
    (24, 37, 21, 33, FIVE, (1, 1)),
    (17, 9, 15, 7, ((0, 0), (2, 2), (1, 0)), (0, 0)),
    (8, 8, 1, 1, ((0, 0),), (7, 7)),
])
def test_plain_version_matches_jax_oracle_and_pallas_interpret(
        dtype, h, w, out_h, out_w, offsets, origin):
    tdt, jdt = DTYPES[dtype]
    x = _grid(h, w)
    jx = jnp.asarray(x, jdt)
    oracle = _np(jax_ref(jx, offsets, out_h, out_w, origin=origin))
    pallas = _np(jax_pallas(jx, offsets, out_h, out_w, origin=origin,
                            block_h=8, block_w=16, interpret=True))
    tx = torch.from_numpy(x).to(tdt)
    plain = stencil_gather_ref(tx, offsets, out_h, out_w, origin=origin)
    op = ops.stencil_gather_op(tx, offsets=offsets, out_h=out_h,
                               out_w=out_w, origin=origin)
    assert plain.dtype == tdt and plain.shape == (out_h, out_w, len(offsets))
    np.testing.assert_array_equal(_np(plain), oracle)
    np.testing.assert_array_equal(_np(plain), pallas)
    assert torch.equal(op, plain)


@pytest.mark.parametrize("offsets,origin,out", [
    (((0, 0), (-1, 0)), (0, 0), (4, 4)),     # a row before the first
    (((0, 0),), (0, -2), (4, 4)),            # a column before the first
    (((0, 0), (3, 0)), (0, 0), (6, 4)),      # rows past the end
    (((0, 0), (0, 5)), (1, 1), (4, 4)),      # columns past the end
    ((), (0, 0), (4, 4)),                    # no feature at all
])
def test_out_of_bounds_problems_raise(offsets, origin, out):
    """The reference slices, so its problems must be in bounds; the port
    checks that on the host (every path) and never reads past the end."""
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        stencil_gather_ref(x, offsets, *out, origin=origin)
    with pytest.raises(ValueError):
        ops.stencil_gather_op(x, offsets=offsets, out_h=out[0],
                              out_w=out[1], origin=origin)
    if offsets:
        problem = ops.inspect_call(x, offsets=offsets, out_h=out[0],
                                   out_w=out[1], origin=origin)
        assert not ops.SPEC.supports(problem)


def test_cpu_dispatch_takes_plain_version_and_counts():
    registry.reset_counts()
    x = torch.from_numpy(_grid(16, 16))
    y = ops.stencil_gather_op(x, offsets=FIVE, out_h=12, out_w=12,
                              origin=(1, 1))
    assert y.shape == (12, 12, 5)
    assert ops.SPEC.plain_calls == 1 and ops.SPEC.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        stencil_gather(x, FIVE, 12, 12, origin=(1, 1), block_h=8,
                       block_w=128)
    assert ops.SPEC.launches == 0


def test_functor_offsets_match_reference_on_miniweather_stencil():
    state = np.zeros((miniweather.NY, miniweather.NX, miniweather.NF),
                     np.float32)
    jmap = JaxTensorMap(miniweather.stencil_fn, jnp.asarray(state),
                        miniweather.RANGES)
    tmap = TensorMap(tensor_functor(
        "mw_in: [i, j, 0:5, 0:4] = "
        "([i-1, j, 0:4], [i+1, j, 0:4], [i, j-1:j+2, 0:4])"),
        torch.from_numpy(state), miniweather.RANGES)
    assert ops.functor_offsets(tmap) == jax_ops.functor_offsets(jmap)


def test_gather_over_functor_offsets_equals_tensor_map():
    """The paper's 5-point stencil functor: the gather at its offsets is
    the TensorMap's own composition."""
    fn = "s: [i, j, 0:5] = ([i-1,j],[i+1,j],[i,j-1:j+2])"
    x = torch.from_numpy(_grid(11, 13, seed=4))
    tmap = TensorMap(tensor_functor(fn), x, {"i": (1, 10), "j": (1, 12)})
    got = ops.stencil_gather_op(x, offsets=ops.functor_offsets(tmap),
                                out_h=9, out_w=11)
    assert torch.equal(got, tmap.to_tensor())


def test_spec_matches_reference_declaration():
    jspec = jax_ops.SPEC
    assert [(p.name, p.default, p.ladder) for p in ops.SPEC.params] == \
        [(p.name, p.default, p.ladder) for p in jspec.params]
    assert ops.SPEC.tol is None
    assert ops.SPEC.default_problems == jspec.default_problems
    problem = ops.SPEC.default_problems[0]
    assert ops.SPEC.cache_key(problem, "cuda") == \
        jspec.cache_key(problem, "cuda")
    cands = ops.SPEC.candidates(problem)
    assert cands[0] == ops.SPEC.defaults()
    # clipped to the rounded-up output extent, every combo once
    assert len(cands) == 4 * 3
    assert ops.SPEC.supports(problem)
    assert not ops.SPEC.supports(dict(problem, dtype="float64"))
    assert not ops.SPEC.supports(dict(problem, offsets=((0, 0),) * 65))
    small = dict(problem, h=20, w=20, out_h=12, out_w=12)
    assert {(c["block_h"], c["block_w"]) for c in
            ops.SPEC.candidates(small)} == {(8, 128), (16, 128)}
