"""Hand-written CUDA kernel for the int8 fused MLP (the quantized serving
tier), its wrapper, packing and registry declaration (counterpart of
``repro/kernels/fused_mlp/int8.py``).

Replaces ``src/repro/kernels/fused_mlp/int8.py::fused_mlp_int8`` (the
Pallas TPU kernel).  The kernel, ``csrc/fused_mlp_int8.cu``, takes
weights quantized statically per output channel
(:func:`repro_torch.quant.quantize.quantize_params`, once at bundle
load), quantizes each activation row dynamically inside the kernel
(absmax/127, round half to even), accumulates int8 x int8 -> int32 and
fuses the rank-1 dequant into the bias + activation epilogue.
Activations stay in shared memory between layers.

What bounds it on an H100: int8 operations at serving batches, and the
L2 reads of the weights (every block of rows streams the whole net).
``block_rows`` 16, 32 and 64 run the product on the tensor cores
(``mma.sync`` m16n8k32 s8), the weights streamed through a shared-memory
ring by the TMA; 1, 2, 4 and 8 run it as ``__dp4a`` on the CUDA cores and
take layers of any width whose rows fit a block.  Both read one pack
(:func:`pack_words`): each layer in the order of the mma's B fragments.

The plain version is :func:`repro_torch.quant.quantize.quant_mlp_ref`;
:func:`fused_mlp_int8` counts its launches in ``fused_mlp_int8.launches``.
``fused_mlp_int8_sharded`` waits for the port of ``dist/``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.fused_mlp.fused_mlp import ACT_CODES
from repro_torch.kernels.fused_mlp.ops import (DEFAULT_PROBLEMS,
                                               mlp_cache_key, mlp_cache_keys,
                                               mlp_stack_from_spec,
                                               sweep_weights)
from repro_torch.kernels.registry import SMEM_PER_BLOCK, round_up
from repro_torch.quant.quantize import quant_mlp_ref, quantize_params

MAX_LAYERS = 16            # LayerTable capacity in csrc/fused_mlp_int8.cu
K_PAD = 32                 # K zero-padding of the pack: one mma k (K_PAD)
N_PAD = 8                  # N zero-padding of the pack: one mma n (N_PAD)
ROWS_BLOCK_ROWS = (1, 2, 4, 8)   # the __dp4a rows path, any width
MMA_BLOCK_ROWS = (16, 32, 64)    # the tensor-core path
BLOCK_ROWS = ROWS_BLOCK_ROWS + MMA_BLOCK_ROWS  # the instances the source builds
DEFAULT_BLOCK_ROWS = 32
# the mma path's constants in csrc/fused_mlp_int8.cu
MMA_WARPS, MMA_SLAB_STEPS, MMA_MAX_STAGES = 8, 2, 6
MMA_ACC_REGS, MMA_META_BYTES = 128, 2048
SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp_int8.cu"
REPLACES = "src/repro/kernels/fused_mlp/int8.py:108"

#: Tolerance of the kernel against its plain version, the reference's
#: ``TOL``: both quantize, accumulate and dequantize identically (integer
#: sums are exact; the epilogue is the same three f32 roundings), so a
#: relu/identity net agrees bit for bit.  Where an activation (gelu, tanh,
#: silu, sigmoid) differs by an ulp between the kernel and PyTorch, a value
#: that sits on an int8 rounding boundary can requantize one step apart in
#: the next layer; one step moves that lane by absmax/127, so the tolerance
#: is one step of a unit-scale activation (2/127 ~ 1.6e-2), not f32 eps.
TOL = (2e-2, 2e-2)


def mma_max_out(block_rows: int) -> int:
    """The widest layer output the mma path takes at ``block_rows``: the
    8 warps hold every output column's int32 accumulators, at most
    ``MMA_ACC_REGS`` a thread.  0 for the rows path (no such limit)."""
    if block_rows in ROWS_BLOCK_ROWS:
        return 0
    return MMA_WARPS * N_PAD * (MMA_ACC_REGS // 4 // (block_rows // 16))


def _mma_parts(widths, block_rows):
    """(bytes of a ring slab, bytes of the rest) of an mma-path block."""
    n_pad = round_up(max(widths[1:]), N_PAD)
    slab = MMA_SLAB_STEPS * K_PAD * n_pad
    rest = (MMA_META_BYTES + 2 * 4 * n_pad
            + block_rows * (round_up(max(widths[:-1]), K_PAD) + 16))
    return slab, rest


def mma_stages(widths: Sequence[int], block_rows: int) -> int:
    """The mma path's ring slots: as many slabs (``MMA_SLAB_STEPS`` k32
    steps of the widest output) as fit beside the rest of a block's
    shared memory, at least 2, at most ``MMA_MAX_STAGES`` (as
    ``mma_stages`` in the source)."""
    slab, rest = _mma_parts(widths, block_rows)
    return min(MMA_MAX_STAGES, max(2, (SMEM_PER_BLOCK - rest) // slab))


def smem_bytes(widths: Sequence[int], block_rows: int) -> int:
    """Dynamic shared memory of one block (as ``smem_size`` in the source
    computes it).  Rows path: the f32 rows ``[block_rows, round_up(max
    width, 4)]``, their int8 copy ``[block_rows, round_up(max width,
    K_PAD)]`` and the row scales.  mma path: the barriers, counts, scales
    and table, a layer's ``ws`` and ``b``, :func:`mma_stages` slabs, and
    the int8 rows ``[block_rows, round_up(widest input, K_PAD) + 16]``."""
    if block_rows in ROWS_BLOCK_ROWS:
        w = max(widths)
        return (block_rows * round_up(w, 4) * 4
                + block_rows * round_up(w, K_PAD)
                + round_up(block_rows * 4, 16))
    slab, rest = _mma_parts(widths, block_rows)
    return rest + mma_stages(widths, block_rows) * slab


def fits_smem(widths: Sequence[int], block_rows: int) -> bool:
    """Whether ``block_rows`` takes the net: its shared memory fits a
    block and, on the mma path, every layer output fits the accumulators
    (:func:`mma_max_out`)."""
    if block_rows in MMA_BLOCK_ROWS and \
            max(widths[1:]) > mma_max_out(block_rows):
        return False
    return smem_bytes(widths, block_rows) <= SMEM_PER_BLOCK


def launch_shape(widths: Sequence[int], batch: int, block_rows: int) -> dict:
    """What one launch runs: its path, blocks, threads a block, ring
    slabs and shared memory a block."""
    mma = block_rows in MMA_BLOCK_ROWS
    return {"path": "mma.sync s8" if mma else "dp4a",
            "block_rows": block_rows, "blocks": -(-batch // block_rows),
            "threads": MMA_WARPS * 32 if mma else 256,
            "ring_slabs": mma_stages(widths, block_rows) if mma else 0,
            "smem_bytes": smem_bytes(widths, block_rows)}


@dataclasses.dataclass(frozen=True)
class PackedInt8MLP:
    """A quantized dense stack packed once for the kernel.

    ``qweights`` holds every layer's weights as int32 words, layer ``l``
    at ``qweights[q_off:q_off + round_up(in, K_PAD) * round_up(out,
    N_PAD) / 4]`` in the order of ``mma.sync`` m16n8k32's B fragments
    (:func:`pack_words`).  ``fparams`` holds the f32 ``ws`` then ``b`` of
    each layer; ``table`` holds ``(in, out, act code, q_off, s_off,
    b_off)`` per layer as int64, the layout the C entry point reads.
    ``qlayers`` keeps the unpacked ``(wq int8 [in, out], ws, b)`` for the
    plain version and the quant gate.
    """
    qweights: torch.Tensor
    fparams: torch.Tensor
    qlayers: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    widths: Tuple[int, ...]
    acts: Tuple[str, ...]
    table: np.ndarray


def pack_words(wq: torch.Tensor) -> torch.Tensor:
    """int8 ``[K, N]`` -> int32 words ``[Kp / 32, Np / 8, 32, 2]`` (K
    zero-padded to ``Kp``, a multiple of ``K_PAD``; N to ``Np``, a
    multiple of ``N_PAD``): for each k32 x n8 tile, the two B-fragment
    registers of each lane ``(g, t) = (lane // 4, lane % 4)``, word ``r``
    holding ``wq[32 kt + 16 r + 4 t + b, 8 nt + g]`` in byte ``b``."""
    k, n = int(wq.shape[0]), int(wq.shape[1])
    kp, np_ = round_up(k, K_PAD), round_up(n, N_PAD)
    padded = torch.zeros((kp, np_), dtype=torch.int8, device=wq.device)
    padded[:k, :n] = wq
    # [kt, r, t, b, nt, g] -> [kt, nt, g, t, r, b]
    tiles = padded.view(kp // 32, 2, 4, 4, np_ // 8, 8).permute(
        0, 4, 5, 2, 1, 3)
    return tiles.contiguous().view(torch.int32).view(kp // 32, np_ // 8,
                                                     32, 2)


def pack_int8_mlp(qlayers, acts, device=None) -> PackedInt8MLP:
    """Pack ``qlayers`` (``[(wq int8 [in, out], ws [out], b [out]), ...]``,
    as :func:`repro_torch.quant.quantize.quantize_params` returns them)
    and per-layer ``acts`` on ``device`` (default: the layers' device)."""
    qlayers = list(qlayers)
    if len(qlayers) != len(acts) or not qlayers:
        raise ValueError("need one act per quantized layer, at least one "
                         "layer")
    dev = (torch.device(device) if device is not None
           else torch.as_tensor(qlayers[0][0]).device)
    widths = [int(qlayers[0][0].shape[0])]
    table, words, fparts, layers = [], [], [], []
    q_off = f_off = 0
    for (wq, ws, b), a in zip(qlayers, acts):
        wq = torch.as_tensor(wq).to(dev)
        ws = torch.as_tensor(ws).to(device=dev, dtype=torch.float32)
        b = torch.as_tensor(b).to(device=dev, dtype=torch.float32)
        if wq.dtype != torch.int8 or wq.ndim != 2 or \
                wq.shape[0] != widths[-1] or \
                tuple(ws.shape) != (wq.shape[1],) or \
                tuple(b.shape) != (wq.shape[1],):
            raise ValueError(f"layer {wq.dtype} {tuple(wq.shape)} / "
                             f"{tuple(ws.shape)} / {tuple(b.shape)} does not "
                             f"chain from width {widths[-1]} as int8")
        if a not in ACT_CODES:
            raise ValueError(f"unknown activation {a!r}")
        k, n = int(wq.shape[0]), int(wq.shape[1])
        w = pack_words(wq)
        table.append((k, n, ACT_CODES[a], q_off, f_off, f_off + n))
        words.append(w.reshape(-1))
        fparts += [ws, b]
        layers.append(wq)
        q_off += w.numel()
        f_off += 2 * n
        widths.append(n)
    fparams = torch.cat(fparts)
    table = np.asarray(table, np.int64).reshape(-1, 6)
    views = tuple((wq, fparams[int(e[4]):int(e[4]) + int(e[1])],
                   fparams[int(e[5]):int(e[5]) + int(e[1])])
                  for wq, e in zip(layers, table))
    return PackedInt8MLP(torch.cat(words), fparams, views, tuple(widths),
                         tuple(acts), table)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_mlp_int8")
    lib.fused_mlp_int8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.fused_mlp_int8.restype = ctypes.c_int
    for name in ("fused_mlp_int8_max_layers", "fused_mlp_int8_k_pad"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.fused_mlp_int8_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_mlp_int8_smem_bytes.restype = ctypes.c_size_t
    lib.fused_mlp_int8_max_out.argtypes = [ctypes.c_int]
    lib.fused_mlp_int8_max_out.restype = ctypes.c_int
    widths = (6, 1024, 819, 655, 524, 419, 335, 1)
    if (lib.fused_mlp_int8_max_layers(), lib.fused_mlp_int8_k_pad()) != \
            (MAX_LAYERS, K_PAD) or any(
                lib.fused_mlp_int8_smem_bytes(
                    max(widths[:-1]), max(widths[1:]), max(widths), r)
                != smem_bytes(widths, r)
                or lib.fused_mlp_int8_max_out(r) != mma_max_out(r)
                for r in BLOCK_ROWS):
        raise RuntimeError("csrc/fused_mlp_int8.cu and int8.py disagree on "
                           "MAX_LAYERS, K_PAD or the block model")
    return lib


def fused_mlp_int8(x: torch.Tensor, packed: PackedInt8MLP, *,
                   block_rows: int) -> torch.Tensor:
    """Launch the kernel on ``x`` ([B, widths[0]] f32, on the card that
    holds ``packed``) with ``block_rows`` rows a block; returns [B,
    widths[-1]] f32."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_int8 kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if packed.qweights.device != x.device:
        raise ValueError(f"weights on {packed.qweights.device}, rows on "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or \
            x.shape[1] != packed.widths[0]:
        raise ValueError(f"x must be f32 [B, {packed.widths[0]}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if len(packed.acts) > MAX_LAYERS:
        raise ValueError(f"{len(packed.acts)} layers, the kernel holds at "
                         f"most {MAX_LAYERS}")
    if block_rows not in BLOCK_ROWS or not fits_smem(packed.widths,
                                                     block_rows):
        raise ValueError(f"block_rows={block_rows} does not fit widths "
                         f"{packed.widths}")
    x = x.contiguous()
    out = torch.empty((x.shape[0], packed.widths[-1]), device=x.device,
                      dtype=torch.float32)
    if x.shape[0] == 0:
        return out
    lib = _lib()
    table = np.ascontiguousarray(packed.table)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_mlp_int8(x.data_ptr(), out.data_ptr(),
                                 packed.qweights.data_ptr(),
                                 packed.fparams.data_ptr(), int(x.shape[0]),
                                 table.ctypes.data, len(packed.acts),
                                 int(block_rows), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_int8 launch failed: cudaError {err}")
    fused_mlp_int8.launches += 1
    return out


fused_mlp_int8.launches = 0


# ----------------------------------------------------------- KernelSpec ----
def inspect_call(x, packed: PackedInt8MLP) -> dict:
    """The kernel problem of one call, from shapes alone (``x`` may be a
    meta tensor)."""
    return {"widths": packed.widths, "acts": packed.acts,
            "batch": int(x.shape[0]), "ndim": x.ndim,
            "dtype": str(x.dtype).removeprefix("torch.")}


def _run(problem, arrays, params):
    x, packed = arrays
    return fused_mlp_int8(x, packed, block_rows=params["block_rows"])


def _ref(problem, arrays):
    x, packed = arrays
    return quant_mlp_ref(x, packed.qlayers, packed.acts)


def _make(problem, generator, device):
    """Sweep inputs: the f32 sweep's weights
    (:func:`~repro_torch.kernels.fused_mlp.ops.sweep_weights`), quantized
    per output channel on ``device``, and unit-normal rows."""
    widths = problem["widths"]
    ws, bs = sweep_weights(widths, generator)
    x = torch.randn((problem["batch"], widths[0]), generator=generator)
    return (x.to(device), pack_int8_mlp(
        quantize_params(ws, bs, device=device), problem["acts"]))


def _fits(problem, params):
    return fits_smem(problem["widths"], params["block_rows"])


def _cands(problem):
    return registry.ladder_candidates(
        SPEC.params, {"block_rows": problem["batch"]},
        fits=lambda c: _fits(problem, c))


def _supports(problem):
    """f32 rows [B, F0], at most MAX_LAYERS layers, and one row's buffers
    fit a block's shared memory."""
    return (problem["dtype"] == "float32" and problem["ndim"] == 2
            and len(problem["acts"]) <= MAX_LAYERS
            and fits_smem(problem["widths"], 1))


SPEC = registry.register(registry.KernelSpec(
    name="fused_mlp_int8",
    params=(registry.TunableParam("block_rows", DEFAULT_BLOCK_ROWS,
                                  BLOCK_ROWS),),
    kernel=fused_mlp_int8, run_call=_run, ref_call=_ref, make_call=_make,
    cache_key=mlp_cache_key, cache_keys=mlp_cache_keys, candidates=_cands,
    fits=_fits, supports=_supports, tol=TOL, tier="int8",
    # the reference's representative problems (int8.py:201-206)
    default_problems=DEFAULT_PROBLEMS))


# ------------------------------------------------------------------ ops ----
def fused_mlp_int8_op(x, packed: PackedInt8MLP, *, block_rows=None):
    """Run a packed int8 stack on ``x``: the plain version on the CPU, the
    kernel on the card with ``block_rows`` resolved explicit > tuned >
    default."""
    return registry.dispatch(SPEC, inspect_call(x, packed), (x, packed),
                             x.device, overrides={"block_rows": block_rows})


def fused_mlp_int8_from_spec(spec, packed: PackedInt8MLP, x):
    """Adapter: run a pure-dense bundle through the int8 kernel with the
    stack the engine quantized and packed once at load."""
    x = mlp_stack_from_spec(spec, None, x)[0]
    return fused_mlp_int8_op(x, packed)
