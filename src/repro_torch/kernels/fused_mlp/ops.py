"""Registry declaration and spec adapters for the fused-MLP kernel
(counterpart of ``repro/kernels/fused_mlp/ops.py``).

The tunable keeps the name the engine, tuner and cache know,
``block_rows``; its ladder is what the kernel instantiates (16 or 32 rows
a block, one or two m16 tiles of tensor-core fragments, for layers up to
1,024 wide; 1 to 8 rows for any width), not the reference's
``batch_tile`` ladder.  ``fused_mlp_sharded`` waits for the port of
``dist/``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.fused_mlp.fused_mlp import (BLOCK_ROWS, MAX_LAYERS,
                                                     PackedMLP, fits_smem,
                                                     fused_mlp, pack_mlp)
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
from repro_torch.serve.batcher import bucket_size
from repro_torch.tune.cache import shape_key

DEFAULT_BLOCK_ROWS = 32
#: the reference's representative problems (``fused_mlp/ops.py:113-118``)
DEFAULT_PROBLEMS = (
    {"widths": (5, 128, 128, 1), "acts": ("relu", "relu", "identity"),
     "batch": 256, "ndim": 2, "dtype": "float32"},
    {"widths": (16, 256, 256, 4), "acts": ("relu", "relu", "identity"),
     "batch": 512, "ndim": 2, "dtype": "float32"},
)


def inspect_call(x, packed: PackedMLP) -> dict:
    """The kernel problem of one call, from shapes alone (``x`` may be a
    meta tensor: the engine routes a bundle before it sees rows)."""
    return {"widths": packed.widths, "acts": packed.acts,
            "batch": int(x.shape[0]), "ndim": x.ndim,
            "dtype": str(x.dtype).removeprefix("torch.")}


def _run(problem, arrays, params):
    x, packed = arrays
    return fused_mlp(x, packed, block_rows=params["block_rows"])


def _ref(problem, arrays):
    x, packed = arrays
    return fused_mlp_ref(x, packed.weights, packed.biases, packed.acts)


def sweep_weights(widths, generator):
    """He-normal weights (std ``sqrt(2 / fan_in)``) and biases of std 0.1
    for a sweep, drawn on the CPU from ``generator``.  They keep every
    layer's activations at unit scale, the regime the kernels'
    tolerances are stated for; the reference's fixed std of 0.3 grows a
    1,024-wide relu stack about 7x per layer, until the plain version's
    own f32 rounding exceeds the tolerance."""
    ws = [torch.randn((a, b), generator=generator) * (2.0 / a) ** 0.5
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.randn((b,), generator=generator) * 0.1 for b in widths[1:]]
    return ws, bs


def _make(problem, generator, device):
    """Sweep inputs: :func:`sweep_weights` and unit-normal rows."""
    widths = problem["widths"]
    ws, bs = sweep_weights(widths, generator)
    x = torch.randn((problem["batch"], widths[0]), generator=generator)
    return (x.to(device), pack_mlp(ws, bs, problem["acts"], device=device))


def mlp_cache_key(problem, backend):
    return shape_key(problem["widths"], problem["dtype"], backend,
                     problem["batch"])


def mlp_cache_keys(problem, backend):
    """Exact batch first (serve-path dispatches arrive bucket-shaped),
    then the power-of-two bucket covering calls of any other size."""
    b = problem["batch"]
    return [shape_key(problem["widths"], problem["dtype"], backend, bb)
            for bb in dict.fromkeys((b, bucket_size(b)))]


def _fits(problem, params):
    return fits_smem(problem["widths"], params["block_rows"])


def candidate_tiles(widths, bucket):
    """``block_rows`` worth sweeping for one bucket: the default first
    (ties keep it), then the rest of the ladder up to the bucket, each
    checked against the kernel's limits (:func:`fits_smem`).  The single
    source of the fused MLP's candidates: the spec and the tuner both
    consume it."""
    tiles = [DEFAULT_BLOCK_ROWS] + [t for t in BLOCK_ROWS if t <= bucket
                                    and t != DEFAULT_BLOCK_ROWS]
    return [t for t in tiles if fits_smem(widths, t)]


def _cands(problem):
    return [{"block_rows": t}
            for t in candidate_tiles(problem["widths"], problem["batch"])]


def _supports(problem):
    """f32 rows [B, F0], at most MAX_LAYERS layers, and one row's two
    activation buffers (``block_rows`` 1) fit a block's shared memory."""
    return (problem["dtype"] == "float32" and problem["ndim"] == 2
            and len(problem["acts"]) <= MAX_LAYERS
            and fits_smem(problem["widths"], BLOCK_ROWS[0]))


# Tolerance of the kernel against the plain version on the card: both sum
# in f32, the kernel as 3xTF32 mma in ascending k (each product to about
# 2^-22 relative), cuBLAS in its own blocked order.  Each layer's sum of
# K <= 1024 terms then differs by a few sqrt(K) * 2^-22 relative, which
# at the minibude widths and O(1) activations stays under 1e-5 (the CPU
# emulation in tests/test_torch_fused_mlp.py); 1e-4 leaves room for seven
# layers.
SPEC = registry.register(registry.KernelSpec(
    name="fused_mlp",
    params=(registry.TunableParam("block_rows", DEFAULT_BLOCK_ROWS,
                                  BLOCK_ROWS),),
    kernel=fused_mlp, run_call=_run, ref_call=_ref, make_call=_make,
    cache_key=mlp_cache_key, cache_keys=mlp_cache_keys, candidates=_cands,
    fits=_fits, supports=_supports, tol=(1e-4, 1e-4),
    default_problems=DEFAULT_PROBLEMS))


def fused_mlp_op(x, packed: PackedMLP, *, block_rows=None):
    """Run a packed stack on ``x``: the plain version on the CPU, the
    kernel on the card with ``block_rows`` resolved explicit > tuned >
    default."""
    return registry.dispatch(SPEC, inspect_call(x, packed), (x, packed),
                             x.device, overrides={"block_rows": block_rows})


def mlp_stack_from_spec(spec, params, x):
    """Walk a pure-dense Sequential bundle spec into the fused kernel's
    call shape: ``(x, weights, biases, acts)``.

    An ``act`` after a dense sets that layer's activation; a dense
    followed directly by another dense, or last, gets ``identity``; a
    missing bias is zeros.  ``params=None`` walks acts/flatten only.
    """
    weights, biases, acts = [], [], []
    pending_w = None
    plist = params if params is not None else [None] * len(spec["layers"])
    for layer_spec, p in zip(spec["layers"], plist):
        if layer_spec["kind"] == "dense":
            if pending_w is not None:
                acts.append("identity")
            if p is not None:
                weights.append(p["w"])
                biases.append(p["b"] if "b" in p else torch.zeros(
                    (p["w"].shape[1],), dtype=p["w"].dtype,
                    device=p["w"].device))
            pending_w = True
        elif layer_spec["kind"] == "act":
            acts.append(layer_spec["name"])
            pending_w = None
        elif layer_spec["kind"] == "flatten":
            x = x.reshape(x.shape[0], -1)
    if pending_w is not None:
        acts.append("identity")
    return x, weights, biases, acts


def pack_from_spec(spec, params, device=None) -> PackedMLP:
    """Pack a pure-dense bundle's layers once (the engine does this at
    load)."""
    _, weights, biases, acts = mlp_stack_from_spec(
        spec, params, torch.zeros((1, 1)))
    return pack_mlp(weights, biases, acts, device=device)


def fused_mlp_from_spec(spec, params, x, *, packed: PackedMLP | None = None):
    """Adapter: run a pure-dense Sequential bundle through the kernel;
    ``packed`` reuses a stack packed by :func:`pack_from_spec` (then
    ``params`` may be None)."""
    x, weights, biases, acts = mlp_stack_from_spec(spec, params, x)
    if packed is None:
        packed = pack_mlp(weights, biases, acts, device=x.device)
    return fused_mlp_op(x, packed)

