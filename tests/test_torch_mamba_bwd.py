"""Port parity: the Mamba selective scan's gradient on the CPU.

- the plain backward (``mamba_scan_bwd_ref``) against autograd of the
  port's plain version, with cotangents on y and on the final state and
  h0 != 0, in f32 and bf16, at d_state 16 and 5, S 1, a ragged last chunk
  and decays that underflow to 0 (dt up to 200): each gradient's largest
  error over its largest magnitude within ``ops.TOL_BWD``;
- ``jax.vjp`` of the reference's ``mamba_seq`` (through its weights, x
  and h0, cotangents on y and the state) against autograd of the port's
  ``mamba_seq``, whose scan now differentiates through the registry's
  autograd function and the plain backward, on the reference's weights
  (one Mamba layer of the reduced jamba): f32 within
  ``MIXER_GRAD_TOL_F32`` of each leaf's largest magnitude, bf16 within
  ``MIXER_GRAD_TOL_BF16``;
- the states the forward keeps for the backward (``keep_states``): the
  plain forward's are the states ``mamba_scan_ref`` passes through at
  every ``BWD_CHUNK``-th step, and the plain backward given them is the
  plain backward without them, bit for bit;
- the registry's two-output autograd function: the residual kept by the
  forward under grad and handed to the backward (never to the caller),
  ``needs_input_grad`` honoured, zeros for a final state the loss does
  not read; specs without residuals called as before;
- a model of the backward kernel's arithmetic (``_kernel_model``: the
  states before every chunk of ``BWD_CHUNK`` steps from the forward's
  sequential chain, then one reverse walk over the chunks, each chunk's
  states recomputed from its boundary state and its cotangent walked
  back from the one carried from the chunk after it, as
  ``csrc/mamba_scan_bwd.cu`` computes them) at the training length, S
  2,048, and with a padded last chunk, against the plain backward within
  a quarter of ``ops.TOL_BWD``.
"""
import dataclasses
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.kernels.mamba_scan.mamba_scan import (  # noqa: E402
    BWD_CHANNELS, BWD_CHUNK, BWD_LANES, MAX_STATE, bwd_launch_shape,
    bwd_smem_bytes, kept_chunks, mamba_scan_bwd)
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    mamba_scan_bwd_ref, mamba_scan_ref)
from repro_torch.models import blocks  # noqa: E402
from test_torch_mamba import (SOURCE, _mixer, _scan_inputs,  # noqa: E402
                              ieee_f32)
from test_torch_mla import _j, _normal, _np, _t  # noqa: E402

NAMES = ("ddt", "dx", "dBm", "dCm", "dA", "dD", "dh0")
TOL = ops.TOL_BWD[torch.float32]
#: one Mamba layer's gradients against the reference's: f32, the two
#: packages' forwards differ by f32 rounding (XLA fuses, the scans group
#: their products differently), which the layer's gradients carry at about
#: 1e-6 of their largest magnitude: 1e-4; bf16, as tests/test_torch_train.py
#: holds the port's bf16 gradients to the reference's (BF16_GRAD_TOL)
MIXER_GRAD_TOL_F32, MIXER_GRAD_TOL_BF16 = 1e-4, 5e-2
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")


@pytest.fixture(autouse=True)
def _ieee_f32():
    """Every test here runs in IEEE f32 products and the f32 default
    dtype (``test_torch_mamba.ieee_f32``), whatever an earlier test of the
    same worker left behind."""
    with ieee_f32():
        yield


def _inputs(B, S, di, ds, dtype="float32", seed=0, dt_max=None):
    """The op's inputs as ``test_torch_mamba._scan_inputs`` makes them,
    dt uniform up to ``dt_max`` where given, and normal cotangents dy
    (f32) and dhT."""
    arrays = _scan_inputs(B, S, di, ds, dtype, seed)
    rng = np.random.default_rng(seed + 1000)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if dt_max is not None:
        dt = rng.uniform(0.0, dt_max, (B, S, di)).astype(np.float32)
        arrays[0] = torch.from_numpy(dt).to(arrays[0].dtype)
    return arrays, normal(B, S, di), normal(B, di, ds)


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _autograd(arrays, dy, dhT):
    leaves = [a.clone().requires_grad_() for a in arrays]
    y, hT = mamba_scan_ref(*leaves)
    return torch.autograd.grad((y, hT), leaves, (dy, dhT))


CASES = {
    # a ragged last chunk of 64 steps
    "ds16": dict(B=2, S=70, di=12, ds=16),
    # a state the kernel's wrapper pads
    "ds5": dict(B=2, S=70, di=12, ds=5),
    "S1": dict(B=2, S=1, di=12, ds=16),
    # decays that underflow to 0 beside decays that do not
    "underflow": dict(B=2, S=40, di=12, ds=16, dt_max=200.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd(case, dtype):
    """Cotangents on y and hT, h0 != 0: every gradient of the plain
    backward, each in its input's dtype, within TOL_BWD of autograd of
    the plain version, and finite."""
    arrays, dy, dhT = _inputs(**CASES[case], dtype=dtype,
                              seed=len(case) + len(dtype))
    got = mamba_scan_bwd_ref(*arrays, dy, dhT)
    want = _autograd(arrays, dy, dhT)
    assert [g.dtype for g in got] == [a.dtype for a in arrays]
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= ops.TOL_BWD[arrays[0].dtype], (name, _rel(g, w))
    if case == "underflow":
        a = torch.exp(arrays[0].float()[..., None] * arrays[4])
        assert 0.5 < float((a == 0).float().mean()) < 1.0


def test_plain_backward_without_dhT_is_zero_dhT():
    arrays, dy, _ = _inputs(1, 9, 6, 4, seed=7)
    none = mamba_scan_bwd_ref(*arrays, dy)
    zero = mamba_scan_bwd_ref(*arrays, dy, torch.zeros_like(arrays[6]))
    assert all(torch.equal(a, b) for a, b in zip(none, zero))


def test_zero_steps_pass_dhT_to_dh0():
    arrays, dy, dhT = _inputs(1, 0, 6, 4, seed=8)
    got = mamba_scan_bwd_ref(*arrays, dy, dhT)
    assert got[0].shape == (1, 0, 6) and got[2].shape == (1, 0, 4)
    assert torch.equal(got[4], torch.zeros(6, 4))
    assert torch.equal(got[6], dhT)


def test_plain_backward_checks_its_cotangents():
    arrays, dy, dhT = _inputs(1, 5, 6, 4, seed=9)
    with pytest.raises(ValueError, match="dy must be"):
        mamba_scan_bwd_ref(*arrays, dy[:, :3])
    with pytest.raises(ValueError, match="dhT must be"):
        mamba_scan_bwd_ref(*arrays, dy, dhT[..., :2])


# ------------------------------------- the states kept for the backward ---
@pytest.mark.parametrize("S", [70, 64, 17, 1, 0])
def test_plain_forward_keeps_the_states_it_passes_through(S):
    """``keep_states``: the state before every BWD_CHUNK-th step, bit for
    bit the final state of ``mamba_scan_ref`` over the steps before it,
    in f32 and unpadded; y and hT bit for bit as without."""
    arrays, _, _ = _inputs(2, S, 6, 5, dtype="bfloat16", seed=50 + S)
    y, hT, states = mamba_scan_ref(*arrays, keep_states=True)
    want_y, want_h = mamba_scan_ref(*arrays)
    assert torch.equal(y, want_y) and torch.equal(hT, want_h)
    assert states.shape == (2, kept_chunks(S), 6, 5)
    assert states.dtype == torch.float32
    for c in range(kept_chunks(S)):
        t = c * BWD_CHUNK
        prefix = [a[:, :t] for a in arrays[:4]] + list(arrays[4:])
        assert torch.equal(states[:, c], mamba_scan_ref(*prefix)[1]), c


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_from_kept_states_is_the_plain_backward(case):
    """Given the plain forward's kept states, the plain backward takes
    the state before each of its chunks from them: the same gradients,
    bit for bit; states of another shape are refused."""
    arrays, dy, dhT = _inputs(**CASES[case], seed=60 + len(case))
    states = mamba_scan_ref(*arrays, keep_states=True)[2]
    got = mamba_scan_bwd_ref(*arrays, dy, dhT, states=states)
    want = mamba_scan_bwd_ref(*arrays, dy, dhT)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    with pytest.raises(ValueError, match="states must be"):
        mamba_scan_bwd_ref(*arrays, dy, dhT, states=states[:, 1:])


# ------------------------------------------------ against the reference ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_seq_grads_match_jax_vjp(dtype):
    """One Mamba layer of the reduced jamba on the reference's weights, 70
    tokens (a ragged second chunk of 64) from h0 != 0: ``jax.vjp`` of
    ``repro.models.blocks.mamba_seq`` through every weight, x and h0, with
    cotangents on y and the final state (jitted, as the reference trains),
    against autograd of the port's ``mamba_seq`` (the plain backward
    through the registry), each gradient's largest error over its largest
    magnitude."""
    m = _mixer(dtype)
    cfg = m.cfg
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    x, h0 = _normal(20, 2, 70, cfg.d_model), _normal(21, 2, di, ds) * 0.1
    dy, dh = _normal(22, 2, 70, cfg.d_model), _normal(23, 2, di, ds)
    def reference(p, x, h0, dy, dh):
        (_, c), vjp = jax.vjp(
            lambda p, x, h0: jblocks.mamba_seq(m.jcfg, p, x, h0=h0), p, x,
            h0)
        return vjp((dy, {"conv": jnp.zeros_like(c["conv"]), "h": dh}))
    jgp, jgx, jgh = jax.jit(reference)(m.jp, _j(x, dtype), _j(h0),
                                       _j(dy, dtype), _j(dh))
    names = sorted(m.p)
    leaves = [m.p[k].clone().requires_grad_() for k in names] + [
        _t(x, dtype).requires_grad_(), _t(h0).requires_grad_()]
    registry.reset_counts()
    y, c = blocks.mamba_seq(cfg, dict(zip(names, leaves)), leaves[-2],
                            h0=leaves[-1])
    got = torch.autograd.grad((y, c["h"]), leaves, (_t(dy, dtype), _t(dh)))
    assert ops.SPEC.plain_calls == 1 and mamba_scan_bwd.launches == 0
    tol = MIXER_GRAD_TOL_F32 if dtype == "float32" else MIXER_GRAD_TOL_BF16
    want = [jgp[k] for k in names] + [jgx, jgh]
    for name, g, w in zip(names + ["x", "h0"], got, want):
        g, w = _np(g).astype(np.float64), _np(w).astype(np.float64)
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (name, err)


# ------------------------------------------- the registry's autograd path ---
def _leaves(arrays, grad=(True,) * 7):
    return [a.clone().requires_grad_(g) for a, g in zip(arrays, grad)]


def test_op_outputs_carry_a_grad_fn_and_take_the_plain_backward():
    """Both outputs of the op come out of the registry's autograd
    function; their gradient is the plain backward's, bit for bit, and
    within TOL_BWD of autograd of the plain version."""
    arrays, dy, dhT = _inputs(2, 12, 6, 4, seed=10)
    registry.reset_counts()
    leaves = _leaves(arrays)
    y, hT = ops.mamba_scan_op(*leaves)
    assert type(y.grad_fn).__name__ == "_DifferentiableBackward"
    assert y.grad_fn is hT.grad_fn
    got = torch.autograd.grad((y, hT), leaves, (dy, dhT))
    assert ops.SPEC.plain_calls == 1 and ops.SPEC.launches == 0
    assert mamba_scan_bwd.launches == 0
    want = mamba_scan_bwd_ref(*arrays, dy, dhT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for name, g, w in zip(NAMES, got, _autograd(arrays, dy, dhT)):
        assert _rel(g, w) <= TOL, name
    with torch.no_grad():
        y, hT = ops.mamba_scan_op(*leaves)
    assert y.grad_fn is None and hT.grad_fn is None


def test_a_loss_on_y_alone_takes_zeros_for_the_state():
    """hT's cotangent, which the loss does not reach, arrives as zeros:
    the gradients equal the plain backward's without dhT."""
    arrays, dy, _ = _inputs(1, 10, 6, 4, seed=11)
    leaves = _leaves(arrays)
    y, _ = ops.mamba_scan_op(*leaves)
    (y * dy).sum().backward()
    want = mamba_scan_bwd_ref(*arrays, dy)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name


def test_needs_input_grad_is_honoured():
    """Inputs that do not require grad (A, D and h0 here) get none; the
    others get the plain backward's.  A loss on hT alone reaches h0."""
    arrays, dy, _ = _inputs(1, 6, 6, 4, seed=12)
    leaves = _leaves(arrays, grad=(True,) * 4 + (False,) * 3)
    y, _ = ops.mamba_scan_op(*leaves)
    (y * dy).sum().backward()
    assert all(leaf.grad is None for leaf in leaves[4:])
    want = mamba_scan_bwd_ref(*arrays, dy)
    assert all(torch.equal(leaf.grad, w) for leaf, w in zip(leaves[:4],
                                                            want[:4]))
    leaves = _leaves(arrays, grad=(False,) * 6 + (True,))
    _, hT = ops.mamba_scan_op(*leaves)
    (dh0,) = torch.autograd.grad(hT.sum(), [leaves[6]])
    assert torch.equal(dh0, mamba_scan_bwd_ref(
        *arrays, torch.zeros_like(dy), torch.ones_like(hT))[6])


def test_op_keeps_states_for_its_backward_not_for_the_caller():
    """Under grad the op's forward is the backward's ``keep_ref``: the
    caller gets (y, hT) alone, the backward gets the plain forward's kept
    states and gives the plain backward's gradients bit for bit; without
    grad nothing is kept."""
    arrays, dy, dhT = _inputs(2, 40, 6, 4, seed=14)
    bwd, seen = ops.SPEC.backward, {"keep": 0, "residuals": []}

    def keep_ref(problem, arrays):
        seen["keep"] += 1
        return bwd.keep_ref(problem, arrays)

    def ref_call(problem, arrays, outs, grads, *residuals):
        seen["residuals"].append(residuals)
        return bwd.ref_call(problem, arrays, outs, grads, *residuals)
    patched = dataclasses.replace(bwd, keep_ref=keep_ref, ref_call=ref_call)
    with mock.patch.object(ops.SPEC, "backward", patched):
        assert len(ops.mamba_scan_op(*arrays)) == 2  # nothing requires grad
        assert seen["keep"] == 0
        leaves = _leaves(arrays)
        out = ops.mamba_scan_op(*leaves)
        assert seen["keep"] == 1 and len(out) == 2
        got = torch.autograd.grad(out, leaves, (dy, dhT))
    ((states,),) = seen["residuals"]
    assert torch.equal(states, mamba_scan_ref(*arrays, keep_states=True)[2])
    want = mamba_scan_bwd_ref(*arrays, dy, dhT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _rwkv6_call(g):
    r, k, v = (torch.randn(1, 6, 2, 8, generator=g) for _ in range(3))
    w = torch.rand(1, 6, 2, 8, generator=g) * 0.25 + 0.7
    u, s0 = torch.randn(2, 8, generator=g), torch.randn(1, 2, 8, 8,
                                                        generator=g)
    return "rwkv6_chunk", "rwkv6_chunk_op", (r, k, v, w, u, s0)


def _flash_call(g):
    q = torch.randn(1, 6, 4, 8, generator=g)
    k, v = (torch.randn(1, 6, 2, 8, generator=g) for _ in range(2))
    return "flash_attention", "flash_attention_op", (q, k, v)


@pytest.mark.parametrize("make", [_rwkv6_call, _flash_call],
                         ids=["rwkv6_chunk", "flash_attention"])
def test_a_backward_without_residuals_is_called_as_before(make):
    """A spec whose backward keeps no residuals: its own forward under
    grad (no ``keep_ref``), its backward called with (problem, arrays,
    out, grad) alone."""
    import importlib
    name, op, arrays = make(torch.Generator().manual_seed(15))
    spec = registry.get_spec(name)
    module = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    assert spec.backward.keep_run is None and spec.backward.keep_ref is None
    calls, ref_call = [], spec.backward.ref_call

    def counted(*args):
        calls.append(len(args))
        return ref_call(*args)
    patched = dataclasses.replace(spec.backward, ref_call=counted)
    leaves = [a.clone().requires_grad_() for a in arrays]
    with mock.patch.object(spec, "backward", patched):
        out = getattr(module, op)(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])
    assert calls == [4]


def test_kernel_wrapper_refuses_before_any_launch():
    """On CPU tensors, with cotangents of the wrong shape, and with kept
    states that are not the kernel forward's (the plain forward's are not
    padded to MAX_STATE), the wrapper raises without launching."""
    arrays, dy, dhT = _inputs(1, 4, 6, 4, seed=13)
    states = torch.zeros(1, kept_chunks(4), 6, MAX_STATE)
    before = mamba_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd(*arrays, dy, dhT, states=states)
    with pytest.raises(ValueError, match="dy must be"):
        mamba_scan_bwd(*arrays, dy[:, :2], states=states)
    with pytest.raises(ValueError, match="dhT must be"):
        mamba_scan_bwd(*arrays, dy, dhT[0], states=states)
    plain = mamba_scan_ref(*arrays, keep_states=True)[2]
    for wrong in (plain, states[:, :0], states.double()):
        with pytest.raises(ValueError, match="states must be"):
            mamba_scan_bwd(*arrays, dy, dhT, states=wrong)
    assert mamba_scan_bwd.launches == before


@pytest.mark.parametrize("b,s,di,chunks,blocks", [
    (2, 2048, 8192, 128, 128),   # jamba's training shape: 256 blocks
    (2, 1, 8192, 1, 128),
    (1, 70, 200, 5, 4),          # a ragged chunk, a partial block
    (3, 17, 7, 2, 1)])
def test_bwd_launch_shape(b, s, di, chunks, blocks):
    """One walk a (channel block, batch row), over every chunk."""
    shape = bwd_launch_shape(b, s, di)
    assert (shape["chunks"], shape["channel_blocks"]) == (chunks, blocks)
    assert shape["chunks"] == kept_chunks(s)
    assert shape["threads"] == BWD_CHANNELS * BWD_LANES == 256
    assert shape["grid"] == (blocks, b)
    # a lane holds MAX_STATE / BWD_LANES states, a warp 8 channels (the
    # kernel's reductions), and a chunk's recomputed states in registers
    assert MAX_STATE // BWD_LANES == 4 and 32 // BWD_LANES == 8
    assert BWD_CHUNK * MAX_STATE // BWD_LANES == 64


def test_bwd_shared_memory_fits_two_blocks_an_sm():
    """The walk's dynamic shared memory (the source's ``WalkSmem``, which
    the wrapper's ``_bwd_lib`` checks against the built library): 110,592
    bytes in f32, 102,400 in bf16, so that two blocks of 256 threads, each
    with the 1 KB the card reserves a block, fit an SM's 228 KB (233,472
    bytes) beside their registers."""
    assert bwd_smem_bytes(torch.float32) == 110_592
    assert bwd_smem_bytes(torch.bfloat16) == 102_400
    assert 2 * (bwd_smem_bytes(torch.float32) + 1024) <= 233_472


def test_bwd_source_constants_are_the_wrappers():
    """csrc/mamba_scan_bwd.cu's constants are the ones mamba_scan.py
    declares, and the forward keeps its states every BWD_CHUNK steps (the
    wrappers check the built libraries' against them too)."""
    import re
    text = BWD_SOURCE.read_text()
    for name, value in (("MAX_STATE", MAX_STATE), ("CHUNK", BWD_CHUNK),
                        ("CHANNELS", BWD_CHANNELS), ("LANES", BWD_LANES)):
        assert re.search(rf"#define {name} {value}\b", text), name
    assert re.search(rf"#define KEEP_EVERY {BWD_CHUNK}\b",
                     SOURCE.read_text())


def test_bwd_source_is_one_walk_and_its_sum():
    """The backward is two kernels: the reverse walk, which reads the
    forward's kept states (no local pass, no chain, no boundary scratch),
    and the ordered sum of its partials."""
    import re
    text = BWD_SOURCE.read_text()
    kernels = re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", text)
    assert kernels == ["mamba_bwd_walk", "mamba_bwd_sum"]
    assert not re.search(r"\b(GC|DTS|HB)\b", text)


# ------------------------------------ a model of the kernel's arithmetic ---
LOG2E = 1.4426950408889634


def _kernel_model(dt, x, Bm, Cm, A, D, h0, dy, dhT=None):
    """csrc/mamba_scan_bwd.cu's arithmetic in f32 (sums over channels and
    states in torch's order, not the kernel's trees; exact exp2, not the
    SFU's), at the kernel's chunk C (``BWD_CHUNK``), the last chunk padded
    with zero steps (a = 1, no input).  The states before every chunk
    from the forward kernel's sequential chain (``csrc/mamba_scan.cu``
    keeps them under grad); then one reverse walk over the chunks: each
    chunk's states recomputed from its boundary state, its cotangent
    walked back from the one carried from the chunk after it (dhT first;
    it ends as dh0), dx, ddt and the sums of dBm, dCm, dA (over each batch
    row's steps, then the rows) and dD."""
    f32 = torch.float32
    B, S, di = dt.shape
    C = BWD_CHUNK
    nc = -(-S // C)
    pad = nc * C - S

    def chunks(t):  # [B, S, k] -> [B, nc, C, k]
        t = torch.nn.functional.pad(t.to(f32), (0, 0, 0, pad))
        return t.reshape(B, nc, C, t.shape[-1])
    DT, X, DY, BM, CM = (chunks(t) for t in (dt, x, dy, Bm, Cm))
    Af = A.to(f32)
    a2 = Af * torch.tensor(LOG2E, dtype=f32)
    a = torch.exp2(DT[..., None] * a2)              # [B, nc, C, di, ds]
    u = DT * X
    ub = u[..., None] * BM[:, :, :, None, :]        # dt x Bm
    e = DY[..., None] * CM[:, :, :, None, :]        # dy Cm
    # the forward's chain, the state before each chunk kept
    h, kept = h0.to(f32), []
    for c in range(nc):
        kept.append(h)
        for t in range(C):
            h = a[:, c, t] * h + ub[:, c, t]
    # every chunk's states recomputed from its boundary: prev[t] = h_{t-1}
    hc, prev = torch.stack(kept, 1), []
    for t in range(C):
        prev.append(hc)
        hc = a[:, :, t] * hc + ub[:, :, t]
    prev.append(hc)
    # the reverse walk, the cotangent carried across chunks
    gg = torch.zeros_like(h) if dhT is None else dhT.to(f32)
    ddt, dx = (torch.empty_like(DT) for _ in range(2))
    dB, dC = (torch.empty_like(BM) for _ in range(2))
    dA = torch.zeros_like(h)                        # [B, di, ds]
    for c in reversed(range(nc)):
        for t in reversed(range(C)):
            g = e[:, c, t] + gg
            gg = a[:, c, t] * g
            q = gg * prev[t][:, c]
            du = (g * BM[:, c, t, None, :]).sum(-1)
            ddt[:, c, t] = X[:, c, t] * du + (q * Af).sum(-1)
            dx[:, c, t] = DT[:, c, t] * du + D.to(f32) * DY[:, c, t]
            dA = dA + q * DT[:, c, t, :, None]
            dB[:, c, t] = (u[:, c, t, :, None] * g).sum(-2)
            dC[:, c, t] = (DY[:, c, t, :, None] * prev[t + 1][:, c]).sum(-2)
    dD = (DY * X).sum((1, 2)).sum(0)

    def back(t):  # [B, nc, C, k] -> [B, S, k]
        return t.reshape(B, nc * C, t.shape[-1])[:, :S]
    return back(ddt), back(dx), back(dB), back(dC), dA.sum(0), dD, gg


@pytest.mark.parametrize("decays", ["model", "underflow"])
def test_kernel_model_at_the_training_length(decays):
    """S 2,048, jamba's training length, at a narrow width, from a zero
    state without a cotangent on the final state (as in training): the
    kernel's chunked arithmetic within a quarter of TOL_BWD of the plain
    backward, every output finite, with dt as the model makes it or up
    to 200 (decays underflowing to 0)."""
    arrays, dy, _ = _inputs(1, 2048, 8, 16, seed=30,
                            dt_max=200.0 if decays == "underflow" else None)
    arrays[6] = torch.zeros_like(arrays[6])
    got = _kernel_model(*arrays, dy)
    plain = mamba_scan_bwd_ref(*arrays, dy)
    for name, g, p in zip(NAMES, got, plain):
        assert torch.isfinite(g).all(), name
        assert _rel(g, p) <= TOL / 4, (name, _rel(g, p))


@pytest.mark.parametrize("B,S,di,ds", [
    (2, 100, 12, 16),   # a ragged last chunk (6 chunks and 4 steps)
    (1, 9, 6, 5),       # S < the chunk: one padded chunk, a padded state
    (2, 1, 7, 16),      # one step
    (1, 2043, 4, 16)])  # the training length less 5
def test_kernel_model_with_a_padded_chunk(B, S, di, ds):
    """The chunked arithmetic where the last chunk is padded, from h0 !=
    0 with a cotangent on the final state: within a quarter of TOL_BWD of
    the plain backward."""
    arrays, dy, dhT = _inputs(B, S, di, ds, seed=40 + S)
    got = _kernel_model(*arrays, dy, dhT)
    plain = mamba_scan_bwd_ref(*arrays, dy, dhT)
    for name, g, p in zip(NAMES, got, plain):
        assert _rel(g, p) <= TOL / 4, (name, _rel(g, p))
