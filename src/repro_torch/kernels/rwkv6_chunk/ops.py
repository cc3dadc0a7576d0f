"""Registry declaration and op of the RWKV6 WKV recurrence (counterpart of
``repro/kernels/rwkv6_chunk/ops.py``).

No tunable parameters: the grid is (batch, head) and the time loop runs
inside the kernel, so there is nothing to sweep
(:func:`repro_torch.tune.autotune_registered` skips the spec).  The
registry still owns the dispatch: the plain version on the CPU, the
kernel on the card.

The op is differentiable on both devices: the spec's ``backward`` makes
``registry.dispatch`` wrap the call in an autograd function whose
backward is :func:`~.rwkv6_chunk.rwkv6_chunk_bwd` on the card and
:func:`~.ref.rwkv6_chunk_bwd_ref` on the CPU, through both outputs (o and
the final state).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.rwkv6_chunk.ref import (check_shapes,
                                                 rwkv6_chunk_bwd_ref,
                                                 rwkv6_chunk_ref)
from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import (MAX_HEAD_DIM,
                                                         rwkv6_chunk,
                                                         rwkv6_chunk_bwd)

#: (rtol, atol) against the plain version, the reference's: both compute
#: in f32 and differ only in the order of o's sum over the head.
TOL = (1e-5, 1e-5)
#: the backward (kernel) against the plain backward, or either against
#: autograd of the plain version, each gradient's largest error over its
#: largest magnitude, by input dtype.  f32: sums over the head and over
#: time in other orders (the kernel's in chunks, from boundary states),
#: and the kernel's dw from sums of r dr' and k dk' over a chunk, started
#: from the boundary states (the plain backward sums G S over the head
#: directly), which at T 2,048 and decays down to exp(-e) stays within
#: 2.9e-6 (tests/test_torch_rwkv6_bwd.py models it): 1e-4.  bf16: f32
#: results that agree that closely round at most one bf16 step apart, and
#: one ulp of the largest magnitude is at most 2**-7 of it.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inspect_call(r, k, v, w, u, s0) -> dict:
    B, T, H, hd = r.shape
    return {"b": int(B), "t": int(T), "h": int(H), "hd": int(hd),
            "dtype": str(r.dtype).removeprefix("torch.")}


def _run(problem, arrays, params):
    del params  # no tunables
    return rwkv6_chunk(*arrays)


def _ref(problem, arrays):
    return rwkv6_chunk_ref(*arrays)


def _bwd_run(problem, arrays, outs, grads):
    return rwkv6_chunk_bwd(*arrays, *grads, sT=outs[1])


def _bwd_ref(problem, arrays, outs, grads):
    return rwkv6_chunk_bwd_ref(*arrays, *grads)


def _make(problem, generator, device):
    """The reference's inputs: normal r, k, v, u; decays w in
    [0.7, 0.999); a small initial state."""
    B, T, H, hd = problem["b"], problem["t"], problem["h"], problem["hd"]
    dt = _DTYPES[problem["dtype"]]

    def t(*shape, lo=None, hi=None):
        if lo is None:
            a = torch.randn(shape, generator=generator)
        else:
            a = torch.rand(shape, generator=generator) * (hi - lo) + lo
        return a.to(device=device, dtype=dt)
    r, k, v = t(B, T, H, hd), t(B, T, H, hd), t(B, T, H, hd)
    w = t(B, T, H, hd, lo=0.7, hi=0.999)
    u = t(H, hd)
    s0 = t(B, H, hd, hd) * 0.1
    return (r, k, v, w, u, s0)


def _key(problem, backend):
    p = problem
    return (f"b{p['b']}-t{p['t']}-h{p['h']}-hd{p['hd']}"
            f"|{p['dtype']}|{backend}")


def _supports(problem):
    return problem["dtype"] in _DTYPES and 1 <= problem["hd"] <= MAX_HEAD_DIM


SPEC = registry.register(registry.KernelSpec(
    name="rwkv6_chunk", params=(),
    kernel=rwkv6_chunk, run_call=_run, ref_call=_ref, make_call=_make,
    cache_key=_key, candidates=lambda problem: [{}],
    fits=lambda problem, params: True, supports=_supports, tol=TOL,
    backward=registry.Backward(kernel=rwkv6_chunk_bwd, run_call=_bwd_run,
                               ref_call=_bwd_ref),
    default_problems=(
        {"b": 2, "t": 64, "h": 2, "hd": 16, "dtype": "float32"},
    )))


def rwkv6_chunk_op(r, k, v, w, u, s0):
    """The WKV recurrence over r, k, v, w ``[B, T, H, hd]`` from state s0
    ``[B, H, hd, hd]`` with bonus u ``[H, hd]``: the plain version on the
    CPU, the kernel on the card.  Returns ``(o, sT)``; differentiable in
    every input on both (the backward kernel on the card, for w > 0)."""
    check_shapes(r, k, v, w, u, s0)
    return registry.dispatch(SPEC, inspect_call(r, k, v, w, u, s0),
                             (r, k, v, w, u, s0), r.device)
