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
- the registry's two-output autograd function: ``needs_input_grad``
  honoured, zeros for a final state the loss does not read;
- a model of the backward kernel's arithmetic (``_kernel_model``: chunks
  of ``BWD_CHUNK`` steps from a zero state and a zero cotangent, the
  boundary states and cotangents chained across chunks by
  ``exp2(A log2(e) sum dt)``, then every chunk from its boundary, as
  ``csrc/mamba_scan_bwd.cu`` computes them) at the training length, S
  2,048, and with a padded last chunk, against the plain backward within
  a quarter of ``ops.TOL_BWD``.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.kernels.mamba_scan.mamba_scan import (  # noqa: E402
    BWD_CHANNELS, BWD_CHUNK, BWD_CHUNKS_A_BLOCK, BWD_LANES, MAX_STATE,
    bwd_launch_shape, bwd_smem_bytes, mamba_scan_bwd)
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


def test_kernel_wrapper_refuses_before_any_launch():
    """On CPU tensors, and with cotangents of the wrong shape, the
    wrapper raises without launching."""
    arrays, dy, dhT = _inputs(1, 4, 6, 4, seed=13)
    before = mamba_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd(*arrays, dy, dhT)
    with pytest.raises(ValueError, match="dy must be"):
        mamba_scan_bwd(*arrays, dy[:, :2])
    with pytest.raises(ValueError, match="dhT must be"):
        mamba_scan_bwd(*arrays, dy, dhT[0])
    assert mamba_scan_bwd.launches == before


@pytest.mark.parametrize("b,s,di,chunks,blocks,groups", [
    (2, 2048, 8192, 128, 128, 32),   # jamba's training shape
    (2, 1, 8192, 1, 128, 1),
    (1, 70, 200, 5, 4, 2),           # a ragged chunk, a partial block
    (3, 17, 7, 2, 1, 1)])
def test_bwd_launch_shape(b, s, di, chunks, blocks, groups):
    shape = bwd_launch_shape(b, s, di)
    assert (shape["chunks"], shape["channel_blocks"],
            shape["chunk_groups"]) == (chunks, blocks, groups)
    assert shape["threads"] == BWD_CHANNELS * BWD_LANES == 256
    assert shape["grids"]["local"] == (blocks, groups, b)
    assert shape["grids"]["chunks"] == (blocks, groups, b)
    # a lane holds MAX_STATE / BWD_LANES states, a warp 8 channels (the
    # kernel's reductions), and a chunk's recomputed states in registers
    assert MAX_STATE // BWD_LANES == 4 and 32 // BWD_LANES == 8
    assert BWD_CHUNK * MAX_STATE // BWD_LANES == 64


def test_bwd_shared_memory_fits_two_blocks_an_sm():
    """The chunk kernel's dynamic shared memory (the source's
    ``ChunkSmem``, which the wrapper's ``_bwd_lib`` checks against the
    built library): 69,632 bytes in f32, 61,440 in bf16, so that two
    blocks of 256 threads fit an SM's 228 KB beside their registers."""
    assert bwd_smem_bytes(torch.float32) == 69_632
    assert bwd_smem_bytes(torch.bfloat16) == 61_440
    assert 2 * bwd_smem_bytes(torch.float32) <= registry.SMEM_PER_BLOCK


def test_bwd_source_constants_are_the_wrappers():
    """csrc/mamba_scan_bwd.cu's constants are the ones mamba_scan.py
    declares (the wrapper checks the built library's against them too)."""
    import re
    text = BWD_SOURCE.read_text()
    for name, value in (("MAX_STATE", MAX_STATE), ("CHUNK", BWD_CHUNK),
                        ("CHANNELS", BWD_CHANNELS), ("LANES", BWD_LANES),
                        ("CHUNKS_A_BLOCK", BWD_CHUNKS_A_BLOCK)):
        assert re.search(rf"#define {name} {value}\b", text), name


# ------------------------------------ a model of the kernel's arithmetic ---
LOG2E = 1.4426950408889634


def _kernel_model(dt, x, Bm, Cm, A, D, h0, dy, dhT=None):
    """csrc/mamba_scan_bwd.cu's arithmetic in f32 (sums over channels and
    states in torch's order, not the kernel's trees; exact exp2, not the
    SFU's), at the kernel's chunk C (``BWD_CHUNK``), the last chunk padded
    with zero steps (a = 1, no input).  Pass 1: every chunk from a zero
    state forward and a zero cotangent back, and its sum of dt.  Pass 2:
    the states before each chunk chained from h0, the cotangents entering
    each chunk's last step chained from dhT, both by the chunk's decay
    ``exp2(dt_sum fl(A log2 e))``.  Pass 3: every chunk's states
    recomputed from its boundary state and its cotangent walked back from
    its incoming one, dx, ddt and the sums of dBm, dCm, dA and dD."""
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
    # pass 1
    h = torch.zeros_like(a[:, :, 0])
    dts = torch.zeros_like(DT[:, :, 0])
    for t in range(C):
        h = a[:, :, t] * h + ub[:, :, t]
        dts = dts + DT[:, :, t]
    gg = torch.zeros_like(h)
    for t in reversed(range(C)):
        gg = a[:, :, t] * (e[:, :, t] + gg)
    # pass 2
    P = torch.exp2(dts[..., None] * a2)             # [B, nc, di, ds]
    state, before = h0.to(f32), []
    for c in range(nc):
        before.append(state)
        state = P[:, c] * state + h[:, c]
    G = torch.zeros_like(state) if dhT is None else dhT.to(f32)
    entering = [None] * nc
    for c in reversed(range(nc)):
        entering[c] = G
        G = P[:, c] * G + gg[:, c]
    dh0 = G
    # pass 3
    hc, prev = torch.stack(before, 1), []
    for t in range(C):
        prev.append(hc)
        hc = a[:, :, t] * hc + ub[:, :, t]
    gg = torch.stack(entering, 1)
    ddt, dx = (torch.empty_like(DT) for _ in range(2))
    dB, dC = (torch.empty_like(BM) for _ in range(2))
    dA = torch.zeros_like(Af)
    for t in reversed(range(C)):
        g = e[:, :, t] + gg
        gg = a[:, :, t] * g
        q = gg * prev[t]
        du = (g * BM[:, :, t, None, :]).sum(-1)
        ddt[:, :, t] = X[:, :, t] * du + (q * Af).sum(-1)
        dx[:, :, t] = DT[:, :, t] * du + D.to(f32) * DY[:, :, t]
        dA = dA + (q * DT[:, :, t, :, None]).sum((0, 1))
        dB[:, :, t] = (u[:, :, t, :, None] * g).sum(-2)
        dC[:, :, t] = (DY[:, :, t, :, None] * hc).sum(-2)
        hc = prev[t]
    dD = (DY * X).sum((0, 1, 2))

    def back(t):  # [B, nc, C, k] -> [B, S, k]
        return t.reshape(B, nc * C, t.shape[-1])[:, :S]
    return back(ddt), back(dx), back(dB), back(dC), dA, dD, dh0


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
