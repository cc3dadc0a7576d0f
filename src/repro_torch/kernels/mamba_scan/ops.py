"""Registry declaration and op of the Mamba selective scan.

No tunable parameters: the grid is (channel blocks, batch) and the time
loop runs inside the kernel, so there is nothing to sweep
(:func:`repro_torch.tune.autotune_registered` skips the spec).  The
registry still owns the dispatch: the plain version on the CPU, the
kernel on the card.

The op is differentiable on both devices: the spec's ``backward`` makes
``registry.dispatch`` wrap the call in an autograd function whose
backward is :func:`~.mamba_scan.mamba_scan_bwd` on the card and
:func:`~.ref.mamba_scan_bwd_ref` on the CPU, through both outputs (y and
the final state).  Under grad the forward keeps the states before every
``BWD_CHUNK``-th step (``keep_states``) as the backward's residual, which
the backward starts its chunks from.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.mamba_scan.mamba_scan import (MAX_STATE, mamba_scan,
                                                       mamba_scan_bwd)
from repro_torch.kernels.mamba_scan.ref import (check_shapes,
                                                mamba_scan_bwd_ref,
                                                mamba_scan_ref)

#: (rtol, atol) against the plain version, the relative part taken
#: against the scale of the terms (:func:`term_scale`): both compute in
#: f32 and differ in the grouping of the decays' products (a sequential
#: chain in the kernel, the associative scan's tree in the plain
#: version), in the order of y's sum over the states, and in the
#: exponential (``ex2.approx``, within 2 ulp, of a prescaled argument).
TOL = (1e-5, 1e-5)
#: the backward (kernel) against the plain backward, or either against
#: autograd of the plain version: each gradient's largest error over its
#: largest magnitude, by input dtype.  f32: all compute in f32 and differ
#: in the order of the sums over the channels (dBm, dCm: pairs of
#: channels, then a block's 32 pairs in order, then blocks of 64, where
#: the plain backward runs one einsum), over time (dA, dD: one chain over a batch
#: row's steps, then the rows in order), in the states (the forward
#: kernel's sequential chain, kept every 16 steps and recomputed from
#: there, where the plain backward composes the steps' decays in an
#: associative scan's tree), over the states (du, ddt), and in the
#: exponential (``ex2.approx``, within 2 ulp, of a prescaled argument):
#: relative differences of the order of 1e-6, which 1e-4 bounds.  bf16:
#: f32 results that agree that closely round at most one bf16 step apart,
#: and one ulp of the largest magnitude is at most 2**-7 of it.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inspect_call(dt, x, Bm, Cm, A, D, h0) -> dict:
    B, S, di = dt.shape
    return {"b": int(B), "s": int(S), "di": int(di), "ds": int(Bm.shape[2]),
            "dtype": str(dt.dtype).removeprefix("torch.")}


def term_scale(dt, x, Bm, Cm, A, D, h0):
    """``sum_s H_t[s] |Cm_t[s]| + |D x_t|`` for every output, where ``H``
    is the scan of the terms' magnitudes (``|b|`` from ``|h0|`` with the
    same decays): the scale of the rounding error of y, whatever order
    its sums run in.  Returns ``(y scale [B, S, di], hT scale [B, di,
    ds])``, both f32."""
    f32 = torch.float32
    y, hT = mamba_scan_ref(dt, x.abs(), Bm.abs(), Cm.abs(), A,
                           torch.zeros_like(D, dtype=f32), h0.abs())
    return y + (x.to(f32) * D.to(f32)).abs(), hT


def held_to_plain(arrays, y, hT) -> dict:
    """``(y, hT)``, the scan's outputs on ``arrays``, against the plain
    version's on the same inputs: the largest errors and magnitudes, and
    ``worst_vs_terms``, each output's largest error over its allowance
    ``atol + rtol * term_scale`` (:data:`TOL`; at most 1 passes)."""
    rtol, atol = TOL
    want_y, want_h = mamba_scan_ref(*arrays)
    scale_y, scale_h = term_scale(*arrays)
    return {"max_abs_err": (y - want_y).abs().max().item(),
            "max_abs_err_hT": (hT - want_h).abs().max().item(),
            "max_abs_y": want_y.abs().max().item(),
            "max_abs_hT": want_h.abs().max().item(),
            "worst_vs_terms": {
                k: ((got - want).abs() / (atol + rtol * scale)).max().item()
                for k, got, want, scale in (("y", y, want_y, scale_y),
                                            ("hT", hT, want_h, scale_h))}}


def _run(problem, arrays, params):
    del params  # no tunables
    return mamba_scan(*arrays)


def _ref(problem, arrays):
    return mamba_scan_ref(*arrays)


def _keep_run(problem, arrays, params):
    del params  # no tunables
    y, hT, states = mamba_scan(*arrays, keep_states=True)
    return (y, hT), (states,)


def _keep_ref(problem, arrays):
    y, hT, states = mamba_scan_ref(*arrays, keep_states=True)
    return (y, hT), (states,)


def _bwd_run(problem, arrays, outs, grads, states):
    return mamba_scan_bwd(*arrays, *grads, states=states)


def _bwd_ref(problem, arrays, outs, grads, states):
    return mamba_scan_bwd_ref(*arrays, *grads, states=states)


def _make(problem, generator, device):
    """Inputs shaped like a Mamba layer's: dt = softplus(normal - 3) (the
    model's ``b_dt`` is -4.6), normal x, Bm, Cm and D, ``A = -exp(log(1
    .. ds))`` per channel, a small initial state."""
    B, S, di, ds = (problem[k] for k in ("b", "s", "di", "ds"))
    dt_ = _DTYPES[problem["dtype"]]

    def normal(*shape):
        return torch.randn(shape, generator=generator)
    dt = torch.nn.functional.softplus(normal(B, S, di) - 3.0)
    A = -torch.exp(torch.log(torch.arange(1, ds + 1, dtype=torch.float32))
                   ).expand(di, ds).contiguous()
    x, Bm, Cm = normal(B, S, di), normal(B, S, ds), normal(B, S, ds)
    D, h0 = normal(di), normal(B, di, ds) * 0.1
    return tuple(t.to(device=device, dtype=dt_) for t in (dt, x, Bm, Cm)) \
        + tuple(t.to(device) for t in (A, D, h0))


def _key(problem, backend):
    p = problem
    return (f"b{p['b']}-s{p['s']}-di{p['di']}-ds{p['ds']}"
            f"|{p['dtype']}|{backend}")


def _supports(problem):
    return problem["dtype"] in _DTYPES and 1 <= problem["ds"] <= MAX_STATE


SPEC = registry.register(registry.KernelSpec(
    name="mamba_scan", params=(),
    kernel=mamba_scan, run_call=_run, ref_call=_ref, make_call=_make,
    cache_key=_key, candidates=lambda problem: [{}],
    fits=lambda problem, params: True, supports=_supports, tol=TOL,
    backward=registry.Backward(kernel=mamba_scan_bwd, run_call=_bwd_run,
                               ref_call=_bwd_ref, keep_run=_keep_run,
                               keep_ref=_keep_ref),
    default_problems=(
        {"b": 2, "s": 70, "di": 200, "ds": 16, "dtype": "float32"},
    )))


def mamba_scan_op(dt, x, Bm, Cm, A, D, h0):
    """The selective scan of dt, x ``[B, S, di]`` with Bm, Cm ``[B, S,
    ds]``, decays ``A`` ``[di, ds]`` and skip ``D`` ``[di]`` from state h0
    ``[B, di, ds]``: the plain version on the CPU, the kernel on the card.
    Returns ``(y [B, S, di] f32, hT [B, di, ds] f32)``; differentiable in
    every input on both (the backward kernel on the card)."""
    check_shapes(dt, x, Bm, Cm, A, D, h0)
    return registry.dispatch(SPEC, inspect_call(dt, x, Bm, Cm, A, D, h0),
                             (dt, x, Bm, Cm, A, D, h0), dt.device)
