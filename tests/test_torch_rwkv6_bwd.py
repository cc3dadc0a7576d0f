"""Port parity: the RWKV6 WKV recurrence's gradient on the CPU.

- the plain backward (``rwkv6_chunk_bwd_ref``) against ``jax.vjp`` of the
  reference's ``rwkv6_chunk_ref`` and against autograd of the port's
  plain version, with cotangents on o and on the final state and s0 != 0,
  each gradient's largest error over its largest magnitude within
  ``ops.TOL_BWD``;
- ``rwkv6_chunk_op`` differentiating through the registry's autograd
  function, which now takes a kernel with two outputs, and the single
  output of ``flash_attention`` through the same function, unchanged;
- a model of the backward kernel's arithmetic (``_kernel_model``: the
  boundary states chunk by chunk, then each chunk's Horner sums within
  sub-chunks of 16 steps and the cross terms factored through their
  boundary, dv, and dw walked back over parts of 8 steps from a in f64,
  the products split for 3xTF32 by truncation, as
  ``csrc/rwkv6_chunk_bwd.cu`` computes them) at the training length,
  T 2,048, and with a padded last chunk, against the plain backward.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref as jax_ref  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref)
from repro_torch.kernels.rwkv6_chunk import ops  # noqa: E402
from repro_torch.kernels.rwkv6_chunk.ref import (  # noqa: E402
    rwkv6_chunk_bwd_ref, rwkv6_chunk_ref)
from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import (  # noqa: E402
    bwd_launch_shape, rwkv6_chunk_bwd)

NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
TOL = ops.TOL_BWD[torch.float32]


def _inputs(B, T, H, hd, seed, w_lo=0.7, w_hi=0.999):
    """r, k, v, u normal, w uniform in [w_lo, w_hi), s0, do and dsT
    normal (s0 scaled by 0.1), as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (B, T, H, hd)).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, hd, hd)) * 0.1).astype(np.float32)
    do = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    dsT = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    return (r, k, v, w, u, s0), do, dsT


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _autograd(arrays, do, dsT):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    o, sT = rwkv6_chunk_ref(*leaves)
    grads = torch.autograd.grad(
        (o, sT), leaves, (torch.from_numpy(do), torch.from_numpy(dsT)))
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("T", [1, 33, 64])
@pytest.mark.parametrize("hd", [8, 16, 64])
def test_plain_backward_matches_jax_vjp_and_autograd(T, hd):
    """Cotangents on o and on sT, s0 != 0: every gradient of the plain
    backward within TOL_BWD of jax.vjp of the reference's oracle and of
    autograd of the port's plain version."""
    arrays, do, dsT = _inputs(2, T, 2, hd, seed=T + hd)
    got = rwkv6_chunk_bwd_ref(*(torch.from_numpy(a) for a in arrays),
                              torch.from_numpy(do), torch.from_numpy(dsT))
    assert [g.dtype for g in got] == [torch.float32] * 6
    _, vjp = jax.vjp(jax_ref, *(jnp.asarray(a) for a in arrays))
    want_jax = vjp((jnp.asarray(do), jnp.asarray(dsT)))
    want_torch = _autograd(arrays, do, dsT)
    for name, g, wj, wt in zip(NAMES, got, want_jax, want_torch):
        assert g.shape == wj.shape, name
        assert _rel(g.numpy(), wj) <= TOL, (name, _rel(g.numpy(), wj))
        assert _rel(g.numpy(), wt) <= TOL, (name, _rel(g.numpy(), wt))


def test_plain_backward_bf16_inputs():
    """bf16 r, k, v, w and do: computed in f32, each gradient returned in
    its input's dtype, within one bf16 step (TOL_BWD) of the f32 gradient
    of the same rounded inputs."""
    arrays, do, dsT = _inputs(2, 17, 2, 16, seed=4)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:4]]
    rest = [torch.from_numpy(a) for a in arrays[4:]]
    dob = torch.from_numpy(do).to(torch.bfloat16)
    got = rwkv6_chunk_bwd_ref(*bf, *rest, dob, torch.from_numpy(dsT))
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    want = rwkv6_chunk_bwd_ref(*(t.float() for t in bf), *rest, dob.float(),
                               torch.from_numpy(dsT))
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.float().numpy(), w.numpy()) <= ops.TOL_BWD[
            torch.bfloat16], name


def test_plain_backward_without_dsT_is_zero_dsT():
    arrays, do, dsT = _inputs(1, 9, 2, 8, seed=7)
    t = [torch.from_numpy(a) for a in arrays]
    none = rwkv6_chunk_bwd_ref(*t, torch.from_numpy(do))
    zero = rwkv6_chunk_bwd_ref(*t, torch.from_numpy(do),
                               torch.zeros_like(t[5]))
    assert all(torch.equal(a, b) for a, b in zip(none, zero))


def test_zero_steps_pass_dsT_to_ds0():
    arrays, do, dsT = _inputs(1, 0, 2, 8, seed=8)
    got = rwkv6_chunk_bwd_ref(*(torch.from_numpy(a) for a in arrays),
                              torch.from_numpy(do), torch.from_numpy(dsT))
    assert got[0].shape == (1, 0, 2, 8)
    assert torch.equal(got[4], torch.zeros(2, 8))
    assert torch.equal(got[5], torch.from_numpy(dsT))


# ------------------------------------------- the registry's autograd path ---
def _leaves(arrays, grad=(True,) * 6):
    return [torch.from_numpy(a).requires_grad_(g)
            for a, g in zip(arrays, grad)]


def test_op_outputs_carry_a_grad_fn_and_match_autograd():
    """Both outputs of the op come out of the registry's autograd
    function; their gradient is the plain backward's, within TOL_BWD of
    autograd of the plain version."""
    arrays, do, dsT = _inputs(2, 12, 2, 8, seed=9)
    registry.reset_counts()
    leaves = _leaves(arrays)
    o, sT = ops.rwkv6_chunk_op(*leaves)
    assert type(o.grad_fn).__name__ == "_DifferentiableBackward"
    assert o.grad_fn is sT.grad_fn
    got = torch.autograd.grad((o, sT), leaves, (torch.from_numpy(do),
                                                torch.from_numpy(dsT)))
    assert ops.SPEC.plain_calls == 1 and ops.SPEC.launches == 0
    assert rwkv6_chunk_bwd.launches == 0
    want = _autograd(arrays, do, dsT)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w) <= TOL, name
    with torch.no_grad():
        o, sT = ops.rwkv6_chunk_op(*leaves)
    assert o.grad_fn is None and sT.grad_fn is None


def test_a_loss_on_o_alone_takes_zeros_for_the_state():
    """sT's cotangent, which the loss does not reach, arrives as zeros:
    the gradients equal the plain backward's with dsT zero."""
    arrays, do, _ = _inputs(1, 10, 2, 8, seed=10)
    leaves = _leaves(arrays)
    o, _ = ops.rwkv6_chunk_op(*leaves)
    (o * torch.from_numpy(do)).sum().backward()
    want = rwkv6_chunk_bwd_ref(*(torch.from_numpy(a) for a in arrays),
                               torch.from_numpy(do))
    for name, leaf, w in zip(NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name


def test_needs_input_grad_is_honoured():
    """An input that does not require grad (s0 and u here) gets none;
    the others get the plain backward's."""
    arrays, do, _ = _inputs(1, 6, 2, 8, seed=11)
    leaves = _leaves(arrays, grad=(True, True, True, True, False, False))
    o, sT = ops.rwkv6_chunk_op(*leaves)
    (o * torch.from_numpy(do)).sum().backward()
    assert leaves[4].grad is None and leaves[5].grad is None
    want = rwkv6_chunk_bwd_ref(*(torch.from_numpy(a) for a in arrays),
                               torch.from_numpy(do))
    assert all(torch.equal(leaf.grad, w) for leaf, w in zip(leaves[:4],
                                                            want[:4]))
    leaves = _leaves(arrays, grad=(False,) * 5 + (True,))
    o, sT = ops.rwkv6_chunk_op(*leaves)
    (ds0,) = torch.autograd.grad(sT.sum(), [leaves[5]])
    assert torch.equal(ds0, rwkv6_chunk_bwd_ref(
        *(torch.from_numpy(a) for a in arrays), torch.zeros_like(o),
        torch.ones_like(sT))[5])


def test_flash_attention_single_output_is_unchanged():
    """One output through the same autograd function: its gradient is the
    plain backward's on the op's own output, bit for bit."""
    g = torch.Generator().manual_seed(12)
    q = torch.randn(1, 6, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 6, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 6, 2, 8, generator=g, requires_grad=True)
    do = torch.randn(1, 6, 4, 8, generator=g)
    out = flash_ops.flash_attention_op(q, k, v)
    assert not isinstance(out, tuple)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   out.detach(), do, causal=True, q_offset=0,
                                   kv_valid_len=None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    k2 = k.detach()
    (dq,) = torch.autograd.grad(flash_ops.flash_attention_op(q, k2, v.detach()),
                                (q,), do)
    assert torch.equal(dq, want[0])


def test_kernel_wrapper_refuses_cpu_tensors():
    arrays, do, dsT = _inputs(1, 4, 2, 8, seed=13)
    t = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_chunk_bwd(*t, torch.from_numpy(do))
    with pytest.raises(ValueError, match="do must be"):
        rwkv6_chunk_bwd(*t, torch.from_numpy(do)[:, :2])
    with pytest.raises(ValueError, match="dsT needs sT"):
        rwkv6_chunk_bwd(*t, torch.from_numpy(do), torch.from_numpy(dsT))
    assert rwkv6_chunk_bwd.launches == 0


@pytest.mark.parametrize("hd,tile,chunk,threads", [
    (1, 32, 16, 64), (24, 32, 16, 64), (33, 64, 32, 256), (64, 64, 32, 256),
    (96, 128, 16, 256), (128, 128, 16, 256)])
def test_bwd_launch_shape_per_head_tile(hd, tile, chunk, threads):
    shape = bwd_launch_shape(hd)
    assert (shape["head_tile"], shape["chunk"], shape["threads"]) == (
        tile, chunk, threads)
    # a 2 x 4 tile of the chunk's [C, head tile] outputs a thread and a
    # 16 x 16 tile a warp; X, then KL and RF (C 32: two sub-chunks of 16),
    # take S_c's [head tile, head tile] buffer; the dw walks take parts of
    # 8 steps
    assert threads * 8 == chunk * tile
    assert threads // 32 == (chunk // 16) * (tile // 16)
    assert chunk in (16, 32) and (chunk == 16 or chunk + 32 <= tile)
    with pytest.raises(ValueError, match="128"):
        bwd_launch_shape(129)


# ------------------------------------ a model of the kernel's arithmetic ---
def _excl_products(W, reverse):
    """Per lane, the products of W ``[..., C, hd]`` over the steps before
    (reverse False) or after (True) each step of the chunk, as products of
    w (never a quotient), and the chunk's whole product ``[..., hd]``."""
    C = W.shape[-2]
    out = torch.empty_like(W)
    run = torch.ones_like(W[..., 0, :])
    for s in (reversed(range(C)) if reverse else range(C)):
        out[..., s, :] = run
        run = run * W[..., s, :]
    return out, run


def _tf32x3(eq, a, b):
    """torch.einsum(eq, a, b) as the kernel's 3xTF32 ``mma.sync`` takes
    it: each f32 operand split by truncation into hi + lo, both TF32 (hi
    its top 19 bits, lo the rest truncated in turn), and lo.hi + hi.lo +
    hi.hi summed in f32."""
    def split(x):
        hi = (x.contiguous().view(torch.int32) & -8192).view(torch.float32)
        lo = ((x - hi).contiguous().view(torch.int32) & -8192).view(
            torch.float32)
        return hi, lo
    ah, al = split(a)
    bh, bl = split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _kernel_model(r, k, v, w, u, s0, do, dsT=None):
    """csrc/rwkv6_chunk_bwd.cu's arithmetic in f32 (sums and products of
    decays in torch's order, not the kernel's chains of fused
    multiply-adds), at the kernel's chunk C (``bwd_launch_shape``), the
    last chunk padded with w = 1 and zeros.  Pass 1: the boundary states
    chunk by chunk.  Pass 2, every chunk at once, in sub-chunks of 16
    steps: dr' and dk' as Horner sums within a sub-chunk, started from
    S_c do_t and G^_c v_t and, at C 32, from the other sub-chunk's terms
    factored through the boundary between them (KL_s = k_s A(s+1..15),
    RF_s = r_s A(16..s-1)); dv from G^_c and the chunk's matrix M, walked
    within a sub-chunk and KL_t . RF_s across the two; dw per (b, h, i)
    walked back over parts of 8 steps from a at each part's end (a at the
    chunk's end plus the later parts' sums, f64); the u terms and du.
    The products the kernel runs on the tensor cores (pass 1's, D, S_c
    do, G^_c v, the cross terms, dv's two) go through ``_tf32x3``."""
    f32, f64 = torch.float32, torch.float64
    B, T, H, hd = r.shape
    C = bwd_launch_shape(hd)["chunk"]
    nc = -(-T // C)
    pad = nc * C - T

    def chunks(t, fill=0.0):  # [B, T, H, hd] -> [B, H, nc, C, hd]
        t = torch.nn.functional.pad(t.to(f32), (0, 0, 0, 0, 0, pad),
                                    value=fill)
        return t.reshape(B, nc, C, H, hd).permute(0, 3, 1, 2, 4)
    R, K, V, DO = (chunks(t) for t in (r, k, v, do))
    W = chunks(w, 1.0)
    uf = u.to(f32)[None, :, None, None, :]          # [1, H, 1, 1, hd]
    pin, tot = _excl_products(W, reverse=False)     # A(t0..t-1), A(t0..t1)
    pout, _ = _excl_products(W, reverse=True)       # A(t+1..t1)
    # pass 1: S_c before chunk c, G^_c after it
    S = [s0.to(f32)]
    for c in range(nc - 1):
        S.append(tot[:, :, c, :, None] * S[-1] + _tf32x3(
            "bhsi,bhsj->bhij", K[:, :, c] * pout[:, :, c], V[:, :, c]))
    G = [torch.zeros_like(S[0]) if dsT is None else dsT.to(f32)]
    for c in reversed(range(nc)):
        G.insert(0, tot[:, :, c, :, None] * G[0] + _tf32x3(
            "bhsi,bhsj->bhij", R[:, :, c] * pin[:, :, c], DO[:, :, c]))
    ds0, Gc = G[0], torch.stack(G[1:], 2)           # [B, H, nc, hd, hd]
    Sc = torch.stack(S, 2) if nc else Gc
    # pass 2
    X = _tf32x3("bhctj,bhcij->bhcti", DO, Sc)       # S_c do_t
    Y = _tf32x3("bhctj,bhcij->bhcti", V, Gc)        # G^_c v_t
    D = _tf32x3("bhctj,bhcsj->bhcts", DO, V)        # do_t . v_s
    KT = K * pout
    drp, dkp = X.clone(), Y.clone()
    if C == 32:   # the cross terms through the sub-chunks' boundary
        KL = K[..., :16, :] * _excl_products(W[..., :16, :], True)[0]
        pre, a1 = _excl_products(W[..., 16:, :], False)
        RF = R[..., 16:, :] * pre
        a0 = _excl_products(W[..., :16, :], False)[1]
        drp[..., 16:, :] = a0[..., None, :] * X[..., 16:, :] + _tf32x3(
            "bhcts,bhcsi->bhcti", D[..., 16:, :16], KL)
        dkp[..., :16, :] = a1[..., None, :] * Y[..., :16, :] + _tf32x3(
            "bhcst,bhcsi->bhcti", D[..., 16:, :16], RF)
    steps = torch.arange(C)
    sub = steps // 16
    for s in range(C):   # dr': acc w_s + k_s D[t][s] for t > s in s's sub
        upd = drp * W[..., s:s + 1, :] + K[..., s:s + 1, :] * D[..., s:s + 1]
        drp = torch.where(((steps > s) & (sub == s // 16))[:, None], upd,
                          drp)
    for s in reversed(range(C)):   # dk': acc w_s + r_s D[s][t], t < s
        upd = dkp * W[..., s:s + 1, :] \
            + R[..., s:s + 1, :] * D[..., s, :, None]
        dkp = torch.where(((steps < s) & (sub == s // 16))[:, None], upd,
                          dkp)
    M = torch.diag_embed((R * uf * K).sum(-1))      # M[t][t] = r u k
    Q = R.clone()                  # r_s A(s-d+1..s-1) at distance d
    for d in range(1, 16):         # within a sub-chunk
        t = steps[:C - d][sub[:C - d] == sub[d:]]
        M[..., t, t + d] = (K[..., t, :] * Q[..., t + d, :]).sum(-1)
        Q[..., d:, :] = Q[..., d:, :] * W[..., :C - d, :]
    if C == 32:
        M[..., :16, 16:] = _tf32x3("bhcti,bhcsi->bhcts", KL, RF)
    dv = _tf32x3("bhcti,bhcij->bhctj", KT, Gc) \
        + _tf32x3("bhcts,bhcsj->bhctj", M, DO)
    # dw: each part of 8 steps walked back from its end, a relative to it
    parts = C // 8
    kd = (K.to(f64) * dkp.to(f64)).reshape(*K.shape[:3], parts, 8, hd)
    rd = (R.to(f64) * drp.to(f64)).reshape(kd.shape)
    a_rel = torch.zeros_like(kd[..., 0, :])
    x = torch.empty_like(kd)
    for e in reversed(range(8)):
        x[..., e, :] = a_rel - kd[..., e, :]
        a_rel = a_rel + rd[..., e, :] - kd[..., e, :]
    a = tot.to(f64) * (Gc.to(f64) * Sc.to(f64)).sum(-1) \
        + (KT.to(f64) * Y.to(f64)).sum(-2)          # a at the chunk's end
    ends = torch.empty_like(a_rel)
    for p in reversed(range(parts)):
        ends[..., p, :] = a
        a = a + a_rel[..., p, :]
    dw = (ends[..., None, :] + x).to(f32).reshape(W.shape) / W
    dots = torch.diagonal(D, dim1=-2, dim2=-1)[..., None]
    dr = drp + uf * K * dots
    dk = dkp + uf * R * dots
    du = (R * K * dots).sum((0, 2, 3))

    def back(t):  # [B, H, nc, C, hd] -> [B, T, H, hd]
        return t.permute(0, 2, 3, 1, 4).reshape(B, nc * C, H, hd)[:, :T]
    return back(dr), back(dk), back(dv), back(dw), du, ds0


@contextlib.contextmanager
def _one_thread():
    """Run the long step-by-step loops on one thread: thousands of small
    ops, whose time several test workers' threads would otherwise
    multiply."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


#: decays down to 1e-3 (exp(-exp(c)), c up to ln(ln(1000))), below the
#: model's least w, exp(-e): every output finite, all but dw within
#: TOL / 4.  dw divides by w: at T 2,048 the model's dw lies 1.5e-4 of its
#: largest magnitude from the plain backward's, past TOL_BWD (9.4e-5 with
#: the products exact: the truncation split of the 3xTF32 operands costs
#: the rest).  Outside the domain where TOL_BWD holds dw; held here to
#: twice TOL so that a worse factoring still fails.
SMALL_DECAY_C = float(np.log(np.log(1000.0)))
SMALL_DECAY_DW_TOL = 2 * TOL


@pytest.mark.parametrize("decays", ["model", "make_call", "small"])
def test_kernel_model_at_the_training_length(decays):
    """T 2,048 at hd 64 (the rwkv6-1.6b training shape's head and length):
    the kernel's chunked arithmetic within a quarter of TOL_BWD of the
    plain backward, which walks every step (and is itself held to jax.vjp
    above).  Decays as the model makes them (exp(-exp(c)), c in [-6, 1]:
    0.066 to 0.998), as the spec's ``make_call`` draws them (0.7 to
    0.999), or down to 1e-3 (c up to ``SMALL_DECAY_C``), where dw is held
    to ``SMALL_DECAY_DW_TOL`` instead."""
    B, T, H, hd = 1, 2048, 2, 64
    arrays, do, _ = _inputs(B, T, H, hd, seed=20)
    if decays != "make_call":
        hi = 1.0 if decays == "model" else SMALL_DECAY_C
        c = np.random.default_rng(21).uniform(-6.0, hi, (B, T, H, hd))
        arrays = arrays[:3] + (np.exp(-np.exp(c)).astype(np.float32),) \
            + arrays[4:]
    arrays = arrays[:5] + (np.zeros_like(arrays[5]),)  # s0 zero: training
    t = [torch.from_numpy(a) for a in arrays]
    with _one_thread():
        got = _kernel_model(*t, torch.from_numpy(do))
        plain = rwkv6_chunk_bwd_ref(*t, torch.from_numpy(do))
    for name, g, p in zip(NAMES, got, plain):
        assert torch.isfinite(g).all(), name
        tol = SMALL_DECAY_DW_TOL if (decays, name) == ("small", "dw") \
            else TOL / 4
        assert _rel(g.numpy(), p.numpy()) <= tol, (name,
                                                  _rel(g.numpy(), p.numpy()))


@pytest.mark.parametrize("B,T,H,hd", [
    (2, 100, 3, 24),   # a ragged last chunk (C 16: 6 chunks and 4 steps)
    (1, 150, 2, 64),   # a ragged last chunk at the training head (C 32)
    (2, 9, 2, 64),     # T < C: one padded chunk
    (1, 21, 2, 128)])  # hd 128 (C 16): a ragged last chunk
def test_kernel_model_with_a_padded_chunk(B, T, H, hd):
    """The chunked arithmetic where the last chunk is padded (w = 1, the
    other inputs 0), from s0 != 0 with a cotangent on the final state:
    within a quarter of TOL_BWD of the plain backward."""
    arrays, do, dsT = _inputs(B, T, H, hd, seed=30 + T)
    t = [torch.from_numpy(a) for a in arrays]
    got = _kernel_model(*t, torch.from_numpy(do), torch.from_numpy(dsT))
    plain = rwkv6_chunk_bwd_ref(*t, torch.from_numpy(do),
                                torch.from_numpy(dsT))
    for name, g, p in zip(NAMES, got, plain):
        assert _rel(g.numpy(), p.numpy()) <= TOL / 4, (name,
                                                      _rel(g.numpy(),
                                                           p.numpy()))
