"""Port parity: the RWKV6 WKV recurrence's gradient on the CPU.

- the plain backward (``rwkv6_chunk_bwd_ref``) against ``jax.vjp`` of the
  reference's ``rwkv6_chunk_ref`` and against autograd of the port's
  plain version, with cotangents on o and on the final state and s0 != 0,
  each gradient's largest error over its largest magnitude within
  ``ops.TOL_BWD``;
- ``rwkv6_chunk_op`` differentiating through the registry's autograd
  function, which now takes a kernel with two outputs, and the single
  output of ``flash_attention`` through the same function, unchanged;
- a model of the backward kernel's arithmetic (``_kernel_model``: its
  three walks in f32, dw from suffix sums in f64, as
  ``csrc/rwkv6_chunk_bwd.cu`` computes them) at the training length,
  T 2,048, against the plain backward.
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


@pytest.mark.parametrize("hd,tile,groups,threads,chunk", [
    (1, 32, 4, 128, 32), (24, 32, 4, 128, 32), (33, 64, 8, 512, 16),
    (64, 64, 8, 512, 16), (96, 128, 4, 512, 16), (128, 128, 4, 512, 16)])
def test_bwd_launch_shape_per_head_tile(hd, tile, groups, threads, chunk):
    shape = bwd_launch_shape(hd)
    assert (shape["head_tile"], shape["row_groups"], shape["threads"],
            shape["chunk"], shape["segment"]) == (tile, groups, threads,
                                                  chunk, 128)
    assert shape["rows_per_group"] * groups == tile
    assert shape["rows_per_group"] % 4 == 0
    # a state [hd, hd] f32 fits the two partial buffers at both ends
    assert 2 * chunk * groups >= tile
    with pytest.raises(ValueError, match="128"):
        bwd_launch_shape(129)


# ------------------------------------------ a model of the kernel's order ---
def _walk(A, Bv, W, C, u, x0, col, rev):
    """One of the kernel's walks over [B, H] heads, its state X[i][j] in
    f32 (inputs ``[B, T, H, hd]``, x0 ``[B, H, hd, hd]``), the output a
    sum over the state's rows (in torch's order, not the kernel's chains
    of fused multiply-adds: the same f32 rounding, another order).
    Returns (out ``[B, T, H, hd]``, X)."""
    T = A.shape[1]
    X = x0.clone()
    out = torch.empty_like(A)
    for s in range(T):
        t = T - 1 - s if rev else s
        a, b, w, c = A[:, t], Bv[:, t], W[:, t], C[:, t]
        if col:   # out[j] = sum_i a_i X_ij;  X_ij = w_j X_ij + c_i b_j
            out[:, t] = torch.einsum("bhi,bhij->bhj", a, X)
            X = w[..., None, :] * X + c[..., :, None] * b[..., None, :]
        else:     # out[j] = sum_i a_i (X_ij + u_i b_i c_j); X_ij = w_i X + b_i c_j
            kv = b[..., :, None] * c[..., None, :]
            out[:, t] = torch.einsum("bhi,bhij->bhj", a,
                                     X + u[None, :, :, None] * kv)
            X = w[..., :, None] * X + kv
    return out, X


def _kernel_model(r, k, v, w, u, s0, do):
    """csrc/rwkv6_chunk_bwd.cu's arithmetic (dsT zero, as in training):
    dr' and dk' from the transposed walks, dv and ds0 from the plain one,
    all in f32, then per (b, h, i) dw from suffix sums in f64 (the kernel
    adds them by segments of 128 steps, also in f64), the u terms and
    du."""
    rf, kf, vf, wf, dof = (t.float() for t in (r, k, v, w, do))
    uf = u.float()
    zero = torch.zeros_like(s0, dtype=torch.float32)
    drp, _ = _walk(dof, kf, wf, vf, uf, s0.float().transpose(-1, -2),
                   True, False)
    dkp, _ = _walk(vf, rf, wf, dof, uf, zero, True, True)
    dv, ds0 = _walk(kf, rf, wf, dof, uf, zero, False, True)
    dots = (dof * vf).sum(-1)  # [B, T, H]
    a = torch.zeros(r.shape[0], r.shape[2], r.shape[3], dtype=torch.float64)
    dw = torch.empty_like(rf)
    for t in reversed(range(r.shape[1])):
        kd = kf[:, t].double() * dkp[:, t].double()
        dw[:, t] = (a - kd).float() / wf[:, t]
        a = a + rf[:, t].double() * drp[:, t].double() - kd
    ut = uf[None, None]
    dr = drp + ut * kf * dots[..., None]
    dk = dkp + ut * rf * dots[..., None]
    du = (rf * kf * dots[..., None]).sum((0, 1))
    return dr, dk, dv, dw, du, ds0


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


@pytest.mark.parametrize("decays", ["model", "make_call"])
def test_kernel_model_at_the_training_length(decays):
    """T 2,048 at hd 64 (the rwkv6-1.6b training shape's head and length):
    the kernel's arithmetic, with dw from suffix sums, within a quarter of
    TOL_BWD of the plain backward, which sums G S over the head directly
    (and is itself held to jax.vjp above).  Decays as the model makes them
    (exp(-exp(c)), c in [-6, 1]: 0.066 to 0.998) or as the spec's
    ``make_call`` draws them (0.7 to 0.999)."""
    B, T, H, hd = 1, 2048, 2, 64
    arrays, do, _ = _inputs(B, T, H, hd, seed=20)
    if decays == "model":
        c = np.random.default_rng(21).uniform(-6.0, 1.0, (B, T, H, hd))
        arrays = arrays[:3] + (np.exp(-np.exp(c)).astype(np.float32),) \
            + arrays[4:]
    arrays = arrays[:5] + (np.zeros_like(arrays[5]),)  # s0 zero: training
    t = [torch.from_numpy(a) for a in arrays]
    with _one_thread():
        got = _kernel_model(*t, torch.from_numpy(do))
        plain = rwkv6_chunk_bwd_ref(*t, torch.from_numpy(do))
    for name, g, p in zip(NAMES, got, plain):
        assert _rel(g.numpy(), p.numpy()) <= TOL / 4, (name,
                                                      _rel(g.numpy(),
                                                           p.numpy()))
