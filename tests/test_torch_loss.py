"""Port parity: the LM's losses, the embedding lookup's backward and the
gradient of flash attention, against repro.models on the CPU.

Both packages get the same seeded numpy inputs.  Tolerances:

- f32 losses and gradients: rtol = atol = 1e-5 (summation order);
- bf16: the largest error within 2e-2 of the largest magnitude, as
  tests/test_torch_lm.py holds bf16;
- attention gradients: ``ops.TOL_BWD`` for f32 against ``jax.grad`` of
  the reference's ``full_attention`` (K/V repeated per group); bf16
  through :func:`ops.bwd_autograd_tol`, whose bound counts the roundings
  where the two differ (see ops.py).

``_kernel_model`` is the CPU model of the backward kernel's partition
(csrc/flash_attention_bwd.cu: dq blocks of 16 rows a warp with their key
range, dkdv blocks of 64 keys with the query chunks they visit, and the
rows that see no key) held to the plain backward, in f32 and with P and
dS rounded to bf16 where the kernel's bf16 products round them; the
kernel itself is held to the plain backward on the card
(tests/test_torch_cuda.py).
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import loss as jloss  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    bwd_shape, softmax_scale)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.models import loss  # noqa: E402


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()


# ---------------------------------------------------------------- losses ---
LOSS_CASES = {
    # S a multiple of the 512 chunk (two chunks) and a padded vocabulary
    "two chunks, padded vocab": dict(B=2, S=1024, D=32, V=200, Vp=256),
    "one chunk": dict(B=3, S=96, D=16, V=128, Vp=128),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["naive_xent", "fused_linear_xent"])
def test_loss_and_grads_match_reference(case, dtype, fn):
    c = LOSS_CASES[case]
    x = _normal(1, c["B"], c["S"], c["D"])
    W = _normal(2, c["D"], c["Vp"], scale=0.3)
    tgt = np.random.default_rng(3).integers(
        0, c["V"], (c["B"], c["S"])).astype(np.int32)
    jdt = getattr(jnp, dtype)
    jval, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: getattr(jloss, fn)(a, b, jnp.asarray(tgt), c["V"]),
        argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(W, jdt))
    tx, tw = _leaf(x, dtype), _leaf(W, dtype)
    val = getattr(loss, fn)(tx, tw, torch.from_numpy(tgt).long(), c["V"])
    val.backward()
    assert val.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(val.item(), float(jval), rtol=tol)
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        assert got.dtype == getattr(torch, dtype)
        assert _rel(got, want) <= tol


def test_fused_matches_naive_and_holds_no_full_logits():
    """The chunked loss equals the naive one, and its forward saves no
    ``[B, S, Vp]`` tensor for the backward (each chunk recomputes)."""
    B, S, D, V = 2, 1024, 16, 300
    x = torch.from_numpy(_normal(4, B, S, D)).requires_grad_()
    W = torch.from_numpy(_normal(5, D, V, scale=0.3)).requires_grad_()
    tgt = torch.from_numpy(np.random.default_rng(6).integers(0, V, (B, S)))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fused = loss.fused_linear_xent(x, W, tgt, V)
    assert max(saved) < B * S * V // 2
    naive = loss.naive_xent(x, W, tgt, V)
    g_fused = torch.autograd.grad(fused, (x, W))
    g_naive = torch.autograd.grad(naive, (x, W))
    torch.testing.assert_close(fused, naive, rtol=1e-6, atol=0)
    for a, b in zip(g_fused, g_naive):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    odd = torch.zeros(B, 1025, D)  # two chunks do not divide 1,025
    with pytest.raises(ValueError, match="chunks"):
        loss.fused_linear_xent(odd, W, torch.zeros(B, 1025).long(), V)


def test_embed_lookup_backward_sums_in_f32():
    """Token 0 repeated 4,096 times: a bf16 running sum stalls (its ulp
    outgrows the addends), the f32 buffer does not; the result equals the
    reference's custom VJP bit for bit."""
    V, D, n = 8, 4, 4096
    emb = _normal(7, V, D)
    tok = np.zeros((2, n // 2), np.int32)
    tok[0, :5] = [1, 2, 3, 1, 7]
    g = np.full((2, n // 2, D), 0.01, np.float32)
    te = _leaf(emb, "bfloat16")
    out = loss.embed_lookup(te, torch.from_numpy(tok).long())
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    _, vjp = jax.vjp(lambda e: jloss.embed_lookup(e, jnp.asarray(tok)),
                     jnp.asarray(emb, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g, jnp.bfloat16))
    np.testing.assert_array_equal(_np(te.grad), _np(want))
    assert abs(float(te.grad[0, 0]) - 0.01 * (n - 5)) < 0.01 * n * 2 ** -8
    # autograd of the plain gather sums in bf16 and stalls far below
    plain = _leaf(emb, "bfloat16")
    plain[torch.from_numpy(tok).long()].backward(
        torch.from_numpy(g).to(torch.bfloat16))
    assert float(plain.grad[0, 0]) < 0.5 * float(te.grad[0, 0])
    with torch.no_grad():
        assert loss.embed_lookup(te, torch.tensor([3])).grad_fn is None


# ------------------------------------------------------ attention backward ---
ATTN_CASES = {
    "causal, group 1": dict(shape=(2, 9, 9, 2, 2, 16), kw={"causal": True}),
    "causal, group 2, q_offset 4": dict(shape=(1, 5, 9, 4, 2, 16),
                                        kw={"causal": True, "q_offset": 4}),
    "causal, group 4, q_offset -3": dict(shape=(2, 7, 7, 4, 1, 8),
                                         kw={"causal": True, "q_offset": -3}),
    "kv_valid_len 0": dict(shape=(1, 3, 10, 2, 1, 8),
                           kw={"causal": False, "kv_valid_len": 0}),
    "kv_valid_len 6, group 2": dict(shape=(2, 4, 11, 4, 2, 16),
                                    kw={"causal": True, "q_offset": 7,
                                        "kv_valid_len": 6}),
}


def _attn_inputs(shape, dtype, seed=0):
    """q, k, v and do of ``shape`` (B, Sq, Skv, H, KV, hd[, hdv]): v and
    do ``hdv`` wide (``hd`` when not given)."""
    B, Sq, Skv, H, KV, hd, *rest = shape
    hdv = rest[0] if rest else hd
    q, k, v = (_normal(seed + i, *s) for i, s in enumerate(
        ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hdv))))
    do = _normal(seed + 3, B, Sq, H, hdv)
    return q, k, v, do


def _jax_grads(q, k, v, do, kw, dtype):
    H, KV = q.shape[2], k.shape[2]

    def f(q, k, v):
        return jattn.full_attention(q, jattn.repeat_kv(k, H // KV, H),
                                    jattn.repeat_kv(v, H // KV, H), **kw)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return vjp(jnp.asarray(do, jdt))


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_grads_match_jax_grad_of_full_attention(case, dtype):
    """flash_attention_op's gradient on the CPU (its plain backward)
    against jax.grad of the reference's attention."""
    c = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(c["shape"], dtype)
    tq, tk, tv = (_leaf(a, dtype) for a in (q, k, v))
    before = ops.SPEC.plain_calls
    o = ops.flash_attention_op(tq, tk, tv, **c["kw"])
    assert o.grad_fn is not None and ops.SPEC.plain_calls == before + 1
    o.backward(torch.from_numpy(do).to(getattr(torch, dtype)))
    want = _jax_grads(q, k, v, do, c["kw"], dtype)
    group = c["shape"][3] // c["shape"][4]
    tol = ops.bwd_autograd_tol(getattr(torch, dtype), group)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == getattr(torch, dtype)
        assert _rel(got, w) <= tol


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_autograd_of_plain_version(case, dtype):
    c = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(c["shape"], dtype, seed=10)
    tq, tk, tv = (_leaf(a, dtype) for a in (q, k, v))
    tdo = torch.from_numpy(do).to(getattr(torch, dtype))
    o = flash_attention_ref(tq, tk, tv, **c["kw"])
    auto = torch.autograd.grad(o, (tq, tk, tv), tdo)
    got = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                  o.detach(), tdo, **c["kw"])
    group = c["shape"][3] // c["shape"][4]
    tol = ops.bwd_autograd_tol(getattr(torch, dtype), group)
    for g, a in zip(got, auto):
        assert g.dtype == a.dtype
        assert _rel(g, a) <= tol


def _kernel_model(q, k, v, o, do, causal=True, q_offset=0,
                  kv_valid_len=None, dtype=torch.float32):
    """The backward kernel's partition in f64, at its shape for ``dtype``
    and q.k width (``bwd_shape``): the dq kernel's blocks of 16 rows a
    warp with their key bound and log-sum-exp, the dkdv kernel's blocks
    of 64 keys
    visiting only the query chunks that can see them (all of them when
    some row sees no key), such rows adding dO / Skv to every key's dV.
    bf16: P and dS rounded to bf16 (to nearest, from f32) as the operands
    of dV += P^T dO, dQ += dS K and dK += dS^T Q, and dq, dk, dv rounded
    to bf16, where the kernel rounds them."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    group = H // KV
    sc = softmax_scale(hd)
    (dq_warps, _), (kv_warps, chunk) = bwd_shape(hd, dtype)
    tq, tk = 16 * dq_warps, 16 * kv_warps
    bf16 = dtype == torch.bfloat16

    def operand(t):
        return t.float().to(torch.bfloat16).double() if bf16 else t
    valid = Skv if kv_valid_len is None else min(max(kv_valid_len, 0), Skv)
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    lse = torch.full((B, H, Sq), float("inf"), dtype=torch.float64)
    D = (do * o).sum(-1).permute(0, 2, 1)
    for b in range(B):
        for h in range(H):
            g = h // group
            for q0 in range(0, Sq, tq):
                rows = torch.arange(q0, min(q0 + tq, Sq))
                kv_end = min(Skv, valid)
                if causal:
                    kv_end = min(kv_end, q_offset + int(rows[-1]) + 1)
                kv_end = max(kv_end, 0)
                if kv_end == 0:
                    continue
                c = torch.arange(kv_end)
                seen = (c[None] <= rows[:, None] + q_offset if causal
                        else torch.ones(len(rows), kv_end, dtype=torch.bool))
                s = sc * q[b, rows, h] @ k[b, :kv_end, g].T
                s = torch.where(seen, s, float("-inf"))
                lse[b, h, rows] = torch.where(
                    seen.any(-1), torch.logsumexp(s, -1), float("inf"))
                p = torch.where(seen, torch.exp(s - lse[b, h, rows, None]),
                                0.0)
                dp = do[b, rows, h] @ v[b, :kv_end, g].T
                ds = torch.where(seen, p * (dp - D[b, h, rows, None]), 0.0)
                dq[b, rows, h] = sc * operand(ds) @ k[b, :kv_end, g]
    any_dead = valid == 0 or (causal and q_offset < 0)
    for b in range(B):
        for g in range(KV):
            for k0 in range(0, Skv, tk):
                q_lo = 0
                if not any_dead:
                    q_lo = Sq if k0 >= valid else (
                        max(0, k0 - q_offset) if causal else 0)
                cs = torch.arange(k0, min(k0 + tk, Skv))
                for h in range(g * group, (g + 1) * group):
                    for q0 in range(min(q_lo, Sq) // chunk * chunk, Sq,
                                    chunk):
                        rows = torch.arange(q0, min(q0 + chunk, Sq))
                        qpos = rows + q_offset
                        dead = (qpos < 0) & causal | (valid == 0)
                        seen = (~dead[:, None]) & (cs[None] < valid)
                        if causal:
                            seen &= cs[None] <= qpos[:, None]
                        s = sc * q[b, rows, h] @ k[b, cs, g].T
                        p = torch.where(seen, torch.exp(
                            s - lse[b, h, rows, None]), 0.0)
                        p = torch.where(dead[:, None], 1.0 / Skv, p)
                        dp = do[b, rows, h] @ v[b, cs, g].T
                        ds = torch.where(seen, p * (dp - D[b, h, rows, None]),
                                         0.0)
                        dv[b, cs, g] += operand(p).T @ do[b, rows, h]
                        dk[b, cs, g] += sc * operand(ds).T @ q[b, rows, h]
    if bf16:
        return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
    return dq, dk, dv


@pytest.mark.parametrize("shape,kw", [
    ((1, 130, 130, 4, 2, 24), {"causal": True}),
    ((1, 70, 200, 3, 1, 16), {"causal": True, "q_offset": -70}),
    ((1, 130, 150, 2, 2, 8), {"causal": False, "kv_valid_len": 0}),
    ((1, 130, 200, 4, 2, 16), {"causal": True, "q_offset": 30,
                                "kv_valid_len": 100}),
    ((1, 70, 200, 2, 1, 16), {"causal": False, "kv_valid_len": 90}),
    ((1, 70, 70, 2, 1, 16), {"causal": True, "q_offset": -200}),
    # past a q.k tile of 128: the wide tiles' chunks, v at its own width
    ((1, 130, 150, 2, 1, 192, 128), {"causal": True, "q_offset": 10}),
    ((1, 70, 200, 2, 2, 256, 100), {"causal": True, "q_offset": -70}),
])
def test_kernel_partition_model_matches_plain_backward(shape, kw):
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(shape,
                                                             "float32"))
    o = flash_attention_ref(q, k, v, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    got = _kernel_model(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("shape,kw", [
    # one kv head's group at the llama3.2-3b training shape's widths
    ((1, 1024, 1024, 3, 1, 128), {"causal": True}),
    ((1, 130, 150, 2, 2, 8), {"causal": False, "kv_valid_len": 0}),
    ((1, 70, 200, 3, 1, 16), {"causal": True, "q_offset": -70}),
    ((1, 130, 200, 4, 2, 16), {"causal": True, "q_offset": 30,
                                "kv_valid_len": 100}),
    ((1, 160, 160, 4, 2, 120), {"causal": True}),
    ((1, 64, 64, 8, 1, 64), {"causal": False}),
    # one head at the MLA training shape's widths (q.k 192 / v 128), and
    # the widest tile with rows that see no key
    ((1, 1024, 1024, 1, 1, 192, 128), {"causal": True}),
    ((1, 70, 200, 2, 1, 256, 128), {"causal": True, "q_offset": -70}),
])
def test_kernel_model_bf16_rounding_within_backward_tolerances(shape, kw):
    """P and dS rounded to bf16 as the kernel rounds them, against the
    plain backward (``TOL_BWD``) and autograd of the plain version
    (``bwd_autograd_tol``), both on the same bf16 inputs."""
    bf = torch.bfloat16
    q, k, v, do = (torch.from_numpy(a).to(bf) for a in _attn_inputs(
        shape, "bfloat16", seed=20))
    o = flash_attention_ref(q, k, v, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(flash_attention_ref(qq, kk, vv, **kw),
                               (qq, kk, vv), do)
    got = _kernel_model(q, k, v, o, do, dtype=bf, **kw)
    tol_auto = ops.bwd_autograd_tol(bf, shape[3] // shape[4])
    for g, w, a in zip(got, want, auto):
        assert g.dtype == bf
        assert _rel(g, w) <= ops.TOL_BWD[bf]
        assert _rel(g, a) <= tol_auto


def test_backward_tolerances_are_declared():
    assert ops.TOL_BWD[torch.float32] == 1e-4
    assert ops.SPEC.backward.kernel.__name__ == "flash_attention_bwd"
    assert ops.bwd_autograd_tol(torch.float32, 3) == 1e-4
    assert ops.bwd_autograd_tol(torch.bfloat16, 1) < ops.bwd_autograd_tol(
        torch.bfloat16, 3)
