"""Hand-written CUDA kernel for whole-surrogate fused MLP inference, and
its wrapper.

Replaces ``src/repro/kernels/fused_mlp/fused_mlp.py::fused_mlp`` (the
Pallas TPU kernel).  The kernel, ``csrc/fused_mlp.cu``, chains
``h = act_l(h @ W_l + b_l)`` over every layer for a block of ``block_rows``
rows whose activations stay in shared memory: intermediate activations
never go to device memory, as on the TPU.  Unlike the TPU kernel the
weights do not sit on-chip (one 1024x819 f32 layer is 3.4 MB against
227 KB of shared memory per block); they stream from L2 through a ring of
8-row K-tiles in shared memory, which one thread fills through the
Tensor Memory Accelerator (``cp.async.bulk``) from the layout
:func:`pack_mlp` gives them.

What bounds it on an H100: the products at serving batches, then the L2
reads of the weights (every block reads the whole net).  What the design
does about it: the products run on the tensor cores as 3xTF32
``mma.sync`` (f32 accuracy, the 1e-4 tolerance kept), each of 8 warps
owning n8 tiles of the live output columns with register accumulators
for all ``block_rows`` rows, so one activation buffer suffices and
``block_rows`` reaches 32: each weight tile read from L2 feeds 32 rows.
The warps wait only for their data (mbarriers), never for each other
within a layer.  A batch of few row blocks runs as clusters of up to 8
blocks that share the rows and split each layer's columns (distributed
shared memory), so it still spreads over the card.  Layers up to
``MAX_WIDTH`` wide take ``block_rows`` 16 or 32; ``block_rows`` 1 to 8
take any width whose two activation buffers fit a block, the domain of
the CUDA-core kernel this one replaced (one row up to 29,056 wide), with
the weights' fragments read from L2.  See the source for the numerics; a
row's output is bit-identical whatever the batch and ``block_rows``.

The plain version is :func:`repro_torch.kernels.fused_mlp.ref.fused_mlp_ref`;
:func:`fused_mlp` counts its launches in ``fused_mlp.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.registry import SMEM_PER_BLOCK, round_up

MAX_LAYERS = 16            # LayerTable capacity in csrc/fused_mlp.cu
BLOCK_ROWS = (1, 2, 4, 8, 16, 32)  # the template instances the source builds
ROWS_PATH = (1, 2, 4, 8)   # two activation buffers, any width
MAX_WIDTH = 1024           # widest layer output at 16 and 32 rows: 8 warps
                           # x 16 n8 tiles of register accumulators
K_TILE, STAGES = 8, 3      # weight rows per ring stage, stages in the ring
META_BYTES = 1024          # the stages' mbarriers and the layer table
ACT_CODES = {"identity": 0, "relu": 1, "gelu": 2, "tanh": 3, "silu": 4,
             "sigmoid": 5}
SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu"
REPLACES = "src/repro/kernels/fused_mlp/fused_mlp.py:87"


def w_stride(n: int) -> int:
    """Row stride (floats) of an ``n``-wide layer's weights in the kernel
    layout: a multiple of 32 plus 8 words, which keeps a warp's fragment
    loads on 32 distinct banks."""
    return round_up(n, 32) + 8


def smem_bytes(widths: Sequence[int], block_rows: int) -> int:
    """Dynamic shared memory of one block (``smem_size`` in the source).
    ``block_rows`` 16 and 32: one [block_rows, widest + 4 words] f32
    activation buffer, ``STAGES`` [K_TILE, w_stride(widest output)] f32
    weight tiles, and the stages' mbarriers and the layer table.
    ``block_rows`` 1 to 8: two [block_rows, widest rounded up to 8] f32
    activation buffers."""
    if block_rows in ROWS_PATH:
        return 2 * block_rows * round_up(max(widths), K_TILE) * 4
    act_stride = round_up(max(widths), 32) + 4
    return (4 * (block_rows * act_stride
                 + STAGES * K_TILE * w_stride(max(widths[1:])))
            + META_BYTES)


def fits_smem(widths: Sequence[int], block_rows: int) -> bool:
    """Whether the kernel takes ``widths`` at ``block_rows``: an
    instantiated tile, at 16 and 32 rows no layer output past
    ``MAX_WIDTH`` (the register accumulators), and the shared memory
    within a block's 227 KB."""
    return (block_rows in BLOCK_ROWS
            and (block_rows in ROWS_PATH or max(widths[1:]) <= MAX_WIDTH)
            and smem_bytes(widths, block_rows) <= SMEM_PER_BLOCK)


@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """A dense stack packed once into one flat f32 buffer.

    Layer ``l``'s weights occupy ``params[w_off:]`` in the kernel's
    layout (:func:`kernel_block`: row-major, zero-padded, 32-byte
    aligned), then its bias ``params[b_off:b_off+out]``; ``table`` holds
    ``(in, out, act code, w_off, b_off)`` per layer as int64, the layout
    the C entry point reads.  :attr:`weights` are [in, out] views into
    the padded blocks.
    """
    params: torch.Tensor
    widths: Tuple[int, ...]
    acts: Tuple[str, ...]
    table: np.ndarray

    @property
    def weights(self):
        out = []
        for k, n, _, w_off, _ in self.table.tolist():
            kp, np_ = round_up(k, K_TILE), w_stride(n)
            out.append(self.params[w_off:w_off + kp * np_]
                       .view(kp, np_)[:k, :n])
        return out

    @property
    def biases(self):
        return [self.params[int(e[4]):int(e[4]) + int(e[1])]
                for e in self.table]


def kernel_block(w: torch.Tensor) -> torch.Tensor:
    """``w`` [in, out] zero-padded to [in rounded up to ``K_TILE``,
    :func:`w_stride` (out)], flattened: the rows the kernel's weight
    copies bring into shared memory as they are, and whose padding lets
    its fragment loads go unmasked."""
    k, n = w.shape
    block = w.new_zeros((round_up(k, K_TILE), w_stride(n)))
    block[:k, :n] = w
    return block.reshape(-1)


def pack_mlp(weights, biases, acts, device=None) -> PackedMLP:
    """Pack ``weights`` ([in, out] each), ``biases`` and per-layer ``acts``
    into one buffer on ``device`` (default: the weights' device)."""
    if not (len(weights) == len(biases) == len(acts)) or not weights:
        raise ValueError("need one bias and one act per weight, at least "
                         "one layer")
    widths = [int(weights[0].shape[0])]
    rows, parts, off = [], [], 0
    for w, b, a in zip(weights, biases, acts):
        w, b = torch.as_tensor(w), torch.as_tensor(b)
        if w.ndim != 2 or w.shape[0] != widths[-1] or \
                tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer shapes {tuple(w.shape)} / "
                             f"{tuple(b.shape)} do not chain from "
                             f"width {widths[-1]}")
        if a not in ACT_CODES:
            raise ValueError(f"unknown activation {a!r}")
        k, n = int(w.shape[0]), int(w.shape[1])
        block = kernel_block(w)
        pad = round_up(off, 8) - off  # each block 32-byte aligned
        w_off = off + pad
        rows.append((k, n, ACT_CODES[a], w_off, w_off + block.numel()))
        parts += [block.new_zeros(pad), block, b]
        off = w_off + block.numel() + n
        widths.append(n)
    dev = torch.device(device) if device is not None else parts[1].device
    params = torch.cat([p.to(device=dev, dtype=torch.float32)
                        for p in parts])
    return PackedMLP(params, tuple(widths), tuple(acts),
                     np.asarray(rows, np.int64).reshape(-1, 5))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    ``csrc/fused_mlp.cu`` and check that it agrees with this module."""
    lib.fused_mlp_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.fused_mlp_f32.restype = ctypes.c_int
    lib.fused_mlp_max_layers.argtypes = []
    lib.fused_mlp_max_layers.restype = ctypes.c_int
    lib.fused_mlp_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_mlp_smem_bytes.restype = ctypes.c_size_t
    if lib.fused_mlp_max_layers() != MAX_LAYERS or any(
            lib.fused_mlp_smem_bytes(max(w), max(w[1:]), r)
            != smem_bytes(w, r) for w in ((6, 1024, 1), (5, 130, 17, 2))
            for r in BLOCK_ROWS):
        raise RuntimeError("csrc/fused_mlp.cu and fused_mlp.py disagree on "
                           "MAX_LAYERS or the shared-memory layout")
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(_build.load("fused_mlp"))


def fused_mlp(x: torch.Tensor, packed: PackedMLP, *,
              block_rows: int) -> torch.Tensor:
    """Launch the kernel on ``x`` ([B, widths[0]] f32, contiguous, on the
    card that holds ``packed``); returns [B, widths[-1]]."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if packed.params.device != x.device:
        raise ValueError(f"weights on {packed.params.device}, rows on "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or \
            x.shape[1] != packed.widths[0]:
        raise ValueError(f"x must be f32 [B, {packed.widths[0]}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if len(packed.acts) > MAX_LAYERS:
        raise ValueError(f"{len(packed.acts)} layers, the kernel holds at "
                         f"most {MAX_LAYERS}")
    if packed.params.data_ptr() % 16:
        raise ValueError("packed weights must start on a 16-byte boundary "
                         "(the kernel copies weight rows in aligned 16-byte "
                         "chunks)")
    if not fits_smem(packed.widths, block_rows):
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
        err = lib.fused_mlp_f32(x.data_ptr(), out.data_ptr(),
                                packed.params.data_ptr(), int(x.shape[0]),
                                table.ctypes.data, len(packed.acts),
                                int(block_rows), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp launch failed: cudaError {err}")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
