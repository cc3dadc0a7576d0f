"""Registry declaration and op of the stencil gather (counterpart of
``repro/kernels/stencil_gather/ops.py``).

Tunables: the output tile ``block_h`` x ``block_w`` each block writes.
The kernel is a pure gather, so validation is bit-exact (``tol=None``);
the tile only trades the number of blocks against the work per block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.stencil_gather.ref import (check_bounds,
                                                    stencil_gather_ref)
from repro_torch.kernels.stencil_gather.stencil_gather import (
    ELEMENT_BYTES, MAX_FEATURES, stencil_gather)

_H_LADDER = (8, 16, 32, 64)
_W_LADDER = (128, 256, 512)
_DTYPES = {str(d).removeprefix("torch."): d for d in ELEMENT_BYTES}


def inspect_call(x, *, offsets, out_h, out_w, origin=(0, 0)) -> dict:
    return {"h": int(x.shape[0]), "w": int(x.shape[1]),
            "out_h": int(out_h), "out_w": int(out_w),
            "offsets": tuple(tuple(int(v) for v in o) for o in offsets),
            "origin": tuple(int(v) for v in origin),
            "dtype": str(x.dtype).removeprefix("torch.")}


def _run(problem, arrays, params):
    return stencil_gather(arrays[0], problem["offsets"], problem["out_h"],
                          problem["out_w"], origin=problem["origin"],
                          block_h=params["block_h"],
                          block_w=params["block_w"])


def _ref(problem, arrays):
    return stencil_gather_ref(arrays[0], problem["offsets"],
                              problem["out_h"], problem["out_w"],
                              origin=problem["origin"])


def _make(problem, generator, device):
    x = torch.randn((problem["h"], problem["w"]), generator=generator)
    return (x.to(device=device, dtype=_DTYPES[problem["dtype"]]),)


def _halo(problem):
    o0, o1 = problem["origin"]
    return (max(o0 + dy for dy, _ in problem["offsets"]),
            max(o1 + dx for _, dx in problem["offsets"]))


def _key(problem, backend):
    """The reference's key: the output extent, the feature count and the
    halo, not the individual offsets (tiles are correctness-neutral)."""
    dy, dx = _halo(problem)
    p = problem
    shape = (f"h{p['h']}-w{p['w']}-oh{p['out_h']}-ow{p['out_w']}-"
             f"f{len(p['offsets'])}-dy{dy}-dx{dx}")
    return f"{shape}|{p['dtype']}|{backend}"


def _fits(problem, params):
    """Every tile fits: the kernel stages nothing through shared memory
    but the offsets (512 bytes, static), and a block walks its tile with
    a fixed 256 threads whatever its size."""
    return params["block_h"] >= 1 and params["block_w"] >= 1


def _supports(problem):
    try:
        check_bounds((problem["h"], problem["w"]), problem["offsets"],
                     problem["out_h"], problem["out_w"], problem["origin"])
    except ValueError:
        return False
    return (problem["dtype"] in _DTYPES
            and len(problem["offsets"]) <= MAX_FEATURES)


def _cands(problem):
    clip = {"block_h": registry.round_up(problem["out_h"], 8),
            "block_w": registry.round_up(problem["out_w"], 128)}
    return registry.ladder_candidates(
        SPEC.params, clip, fits=lambda c: _fits(problem, c))


SPEC = registry.register(registry.KernelSpec(
    name="stencil_gather",
    params=(registry.TunableParam("block_h", 8, _H_LADDER),
            registry.TunableParam("block_w", 128, _W_LADDER)),
    kernel=stencil_gather, run_call=_run, ref_call=_ref, make_call=_make,
    cache_key=_key, candidates=_cands, fits=_fits, supports=_supports,
    tol=None,
    default_problems=(
        # the reference's: a miniweather-like sweep grid, 5-point stencil
        {"h": 512, "w": 512, "out_h": 508, "out_w": 508,
         "offsets": ((0, 1), (2, 0), (1, 1), (0, 0), (1, 2)),
         "origin": (1, 1), "dtype": "float32"},
    )))


def stencil_gather_op(x, *, offsets, out_h, out_w, origin=(0, 0),
                      block_h=None, block_w=None):
    """Gather ``[out_h, out_w, F]`` features from ``x`` ([H, W]): the
    plain version on the CPU, the kernel on the card.  Every read must
    lie in ``x``, or it raises."""
    check_bounds(x.shape, offsets, out_h, out_w, origin)
    problem = inspect_call(x, offsets=offsets, out_h=out_h, out_w=out_w,
                           origin=origin)
    return registry.dispatch(SPEC, problem, (x,), x.device,
                             overrides={"block_h": block_h,
                                        "block_w": block_w})


def functor_offsets(tensor_map):
    """Static ``(dy, dx)`` offsets of a 2-D point-slice TensorMap."""
    offs = []
    for desc in tensor_map.descriptors:
        for eo in desc.elem_offsets:
            offs.append((desc.offsets[0] + eo[0], desc.offsets[1] + eo[1]))
    return tuple(offs)
