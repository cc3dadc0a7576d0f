"""Plain PyTorch version of the Mamba selective scan, its plain backward,
and the shape check every path shares.

The reference has no Pallas kernel for this scan: its Mamba mixer
computes it in jnp (``repro/models/blocks.py:538-588``), an inclusive
``lax.associative_scan`` over chunks of 64 steps inside a ``lax.scan``
that carries the state across chunks.  :func:`mamba_scan_ref` is that
form, its tree of combines in the order ``associative_scan`` takes
(:func:`associative_scan`: equal to it bit for bit op by op; compiled,
XLA fuses ``a2 * b1 + b2`` into one rounding, so the reference's own
jitted scan differs from both by an f32 ulp here and there).
"""
from __future__ import annotations

import torch

#: Steps a chunk of the scan: the default ``chunk`` of the reference's
#: ``mamba_seq`` (blocks.py:537).
CHUNK = 64
#: Steps between the states a forward keeps for its backward
#: (``keep_states``): the backward kernel's chunk (``BWD_CHUNK``).  It
#: divides :data:`CHUNK`, so the plain backward finds the state before
#: each of its chunks among them.
KEEP_EVERY = 16


def check_shapes(dt, x, Bm, Cm, A, D, h0) -> None:
    """Raise ``ValueError`` unless dt and x are ``[B, S, di]``, Bm and Cm
    ``[B, S, ds]``, A ``[di, ds]``, D ``[di]`` and h0 ``[B, di, ds]``."""
    if dt.ndim != 3 or Bm.ndim != 3:
        raise ValueError(f"dt must be [B, S, di] and Bm [B, S, ds], got "
                         f"{tuple(dt.shape)} and {tuple(Bm.shape)}")
    B, S, di = dt.shape
    ds = Bm.shape[2]
    for name, t, want in (("x", x, (B, S, di)), ("Bm", Bm, (B, S, ds)),
                          ("Cm", Cm, (B, S, ds)), ("A", A, (di, ds)),
                          ("D", D, (di,)), ("h0", h0, (B, di, ds))):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} must be {tuple(want)}, got "
                             f"{tuple(t.shape)}")


def _interleave(even, odd, axis):
    """``even`` at the even indices of ``axis`` and ``odd`` at the odd
    ones (``lax``'s ``_interleave``)."""
    shape = list(even.shape)
    shape[axis] = even.shape[axis] + odd.shape[axis]
    out = even.new_empty(shape)
    idx = [slice(None)] * len(shape)
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = even
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = odd
    return out


def associative_scan(combine, elems, axis):
    """The inclusive scan of ``elems`` (a list of tensors) along ``axis``
    by ``combine(earlier, later)``, in the order of
    ``jax.lax.associative_scan``: adjacent pairs combined, the half-sized
    scan recursively, then each even element combined with the odd
    result before it."""
    def take(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        odd = scan(combine([take(e, 0, n - 1, 2) for e in elems],
                           [take(e, 1, None, 2) for e in elems]))
        tail = [take(e, 2, None, 2) for e in elems]
        even = combine([take(e, 0, -1) for e in odd] if n % 2 == 0 else odd,
                       tail)
        even = [torch.cat([take(e, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]
    return scan(list(elems))


def _combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return [a1 * a2, a2 * b1 + b2]


def _chunk_terms(dtb, xb, Bb, Af):
    """One chunk's decays ``a = exp(dt A)`` and inputs ``b = (dt x) Bm``
    ``[B, c, di, ds]``, and ``u = dt x`` ``[B, c, di]``, all f32."""
    a = torch.exp(dtb[..., None] * Af)
    u = dtb * xb
    return a, u[..., None] * Bb[:, :, None, :], u


def kept_states(h, hs, t0, S):
    """The states before the steps ``t`` in ``[t0, t0 + CHUNK)``, ``t <
    S``, that are multiples of :data:`KEEP_EVERY`, from a chunk's
    incoming state ``h`` and its inclusive states ``hs`` ``[B, CHUNK, di,
    ds]``."""
    return [h if t == t0 else hs[:, t - t0 - 1]
            for t in range(t0, min(t0 + CHUNK, S), KEEP_EVERY)]


def mamba_scan_ref(dt, x, Bm, Cm, A, D, h0, keep_states=False):
    """The selective scan in f32, chunk by chunk, per batch ``b`` and
    channel ``d``::

        a_t = exp(dt_t A),  h_t = a_t h_{t-1} + (dt_t x_t) Bm_t
        y_t = sum_s h_t[s] Cm_t[s] + D x_t

    dt, x: ``[B, S, di]``; Bm, Cm: ``[B, S, ds]`` (any float dtype, cast
    to f32); A: ``[di, ds]``; D: ``[di]``; h0: ``[B, di, ds]``.  Within a
    chunk of :data:`CHUNK` steps the states come from an inclusive
    :func:`associative_scan` of ``(a, b)``, applied to the chunk's
    incoming state; the last chunk is padded with zero steps (a = 1,
    b = 0), as the reference pads it.  Returns ``(y [B, S, di] f32,
    hT [B, di, ds] f32)``; with ``keep_states`` also the states before
    every :data:`KEEP_EVERY`-th step, ``[B, ceil(S / KEEP_EVERY), di,
    ds]`` f32, which :func:`mamba_scan_bwd_ref` takes."""
    check_shapes(dt, x, Bm, Cm, A, D, h0)
    f32 = torch.float32
    B, S, di = dt.shape
    Af = A.to(f32)
    h = h0.to(f32, copy=True)
    pad = -S % CHUNK
    dtp, xp, Bp, Cp = (torch.nn.functional.pad(t.to(f32), (0, 0, 0, pad))
                       for t in (dt, x, Bm, Cm))
    y = torch.empty((B, S + pad, di), dtype=f32, device=dt.device)
    kept = []
    for t0 in range(0, S + pad, CHUNK):
        sl = slice(t0, t0 + CHUNK)
        a, b, _ = _chunk_terms(dtp[:, sl], xp[:, sl], Bp[:, sl], Af)
        Ac, Bc = associative_scan(_combine, [a, b], axis=1)
        hs = Ac * h[:, None] + Bc                             # inclusive
        y[:, sl] = torch.einsum("bcds,bcs->bcd", hs, Cp[:, sl])
        if keep_states:
            kept += kept_states(h, hs, t0, S)
        h = hs[:, -1]
    y = y[:, :S] + x.to(f32) * D.to(f32)
    if not keep_states:
        return y, h
    return y, h, (torch.stack(kept, 1) if kept else
                  h.new_empty((B, 0) + tuple(h.shape[1:])))


def mamba_scan_bwd_ref(dt, x, Bm, Cm, A, D, h0, dy, dhT=None, states=None):
    """The scan's gradient in f32: the cotangents of every input given
    ``dy`` (y's, ``[B, S, di]``) and ``dhT`` (the final state's, ``[B, di,
    ds]``; None is zeros).  With ``g_t`` the cotangent of the state after
    step t, a reverse scan::

        g_t   = dy_t Cm_t + a_{t+1} g_{t+1}       (g_{S-1} = dy Cm + dhT)
        dh0   = a_0 g_0
        dCm_t = sum_d dy_t h_t        dBm_t = sum_d u_t g_t    (u = dt x)
        du_t  = sum_s g_t Bm_t        dx_t  = dt_t du_t + D dy_t
        q_t   = g_t a_t h_{t-1}       ddt_t = x_t du_t + sum_s q_t A
        dA    = sum_{b,t} q_t dt_t    dD    = sum_{b,t} dy_t x_t

    Chunk by chunk (:data:`CHUNK` steps, the last padded as the forward
    pads it): a forward pass keeps only the state before each chunk (or,
    given the forward's kept ``states``, ``mamba_scan_ref(...,
    keep_states=True)``'s third output, takes them from there); then,
    from the last chunk back, each chunk's states are recomputed from it
    by :func:`mamba_scan_ref`'s associative scan and g by the same scan
    over the reversed chunk, so the memory is one chunk's.  No decay is
    divided by: decays that underflow to 0 give zeros, not NaN.  Returns
    ``(ddt, dx, dBm, dCm, dA, dD, dh0)``, each in its input's dtype."""
    check_shapes(dt, x, Bm, Cm, A, D, h0)
    B, S, di = dt.shape
    if tuple(dy.shape) != (B, S, di):
        raise ValueError(f"dy must be {(B, S, di)}, got {tuple(dy.shape)}")
    if dhT is not None and tuple(dhT.shape) != tuple(h0.shape):
        raise ValueError(f"dhT must be {tuple(h0.shape)}, got "
                         f"{tuple(dhT.shape)}")
    want = (B, -(-S // KEEP_EVERY)) + tuple(h0.shape[1:])
    if states is not None and tuple(states.shape) != want:
        raise ValueError(f"states must be the forward's kept states "
                         f"{want}, got {tuple(states.shape)}")
    f32 = torch.float32
    Af, Df = A.to(f32), D.to(f32)
    pad = -S % CHUNK
    dtp, xp, Bp, Cp, dyp = (torch.nn.functional.pad(t.to(f32),
                                                     (0, 0, 0, pad))
                            for t in (dt, x, Bm, Cm, dy))
    starts = range(0, S + pad, CHUNK)
    if states is not None:
        before = [states[:, t0 // KEEP_EVERY].to(f32) for t0 in starts]
    else:
        h, before = h0.to(f32, copy=True), []
        for t0 in starts:
            before.append(h)
            sl = slice(t0, t0 + CHUNK)
            a, b, _ = _chunk_terms(dtp[:, sl], xp[:, sl], Bp[:, sl], Af)
            Ac, Bc = associative_scan(_combine, [a, b], axis=1)
            h = Ac[:, -1] * h + Bc[:, -1]
    G = torch.zeros_like(h0, dtype=f32) if dhT is None \
        else dhT.to(f32, copy=True)
    ddt, dx = (torch.empty_like(dtp) for _ in range(2))
    dB, dC = (torch.empty_like(Bp) for _ in range(2))
    dA = torch.zeros_like(Af)
    dD = torch.zeros_like(Df)
    for t0, hb in zip(reversed(starts), reversed(before)):
        sl = slice(t0, t0 + CHUNK)
        dtb, xb, Bb, Cb, dyb = (t[:, sl] for t in (dtp, xp, Bp, Cp, dyp))
        a, b, u = _chunk_terms(dtb, xb, Bb, Af)
        Ac, Bc = associative_scan(_combine, [a, b], axis=1)
        hs = Ac * hb[:, None] + Bc                          # h_t
        prev = torch.cat([hb[:, None], hs[:, :-1]], dim=1)  # h_{t-1}
        # g over the reversed chunk: G enters the last step with factor 1
        nxt = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        e = dyb[..., None] * Cb[:, :, None, :]
        Ar, Br = associative_scan(_combine, [nxt.flip(1), e.flip(1)], axis=1)
        g = (Ar * G[:, None] + Br).flip(1)
        G = a[:, 0] * g[:, 0]
        q = g * a * prev
        du = torch.einsum("bcds,bcs->bcd", g, Bb)
        ddt[:, sl] = xb * du + torch.einsum("bcds,ds->bcd", q, Af)
        dx[:, sl] = dtb * du + Df * dyb
        dA += (q * dtb[..., None]).sum((0, 1))
        dD += (dyb * xb).sum((0, 1))
        dB[:, sl] = torch.einsum("bcd,bcds->bcs", u, g)
        dC[:, sl] = torch.einsum("bcd,bcds->bcs", dyb, hs)
    return (ddt[:, :S].to(dt.dtype), dx[:, :S].to(x.dtype),
            dB[:, :S].to(Bm.dtype), dC[:, :S].to(Cm.dtype), dA.to(A.dtype),
            dD.to(D.dtype), G.to(h0.dtype))
