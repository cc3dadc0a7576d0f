"""Hand-written CUDA kernel for whole-surrogate fused MLP inference, and
its wrapper.

Replaces ``src/repro/kernels/fused_mlp/fused_mlp.py::fused_mlp`` (the
Pallas TPU kernel).  The kernel, ``csrc/fused_mlp.cu``, chains
``h = act_l(h @ W_l + b_l)`` over every layer for a block of ``block_rows``
rows whose activations stay in shared memory: intermediate activations
never go to device memory, as on the TPU.  Unlike the TPU kernel the
weights do not sit on-chip (one 1024x819 f32 layer is 3.4 MB against
227 KB of shared memory per block); they are read from L2.

What bounds it on an H100: f32 FMAs on the CUDA cores (67 TFLOP/s) at
serving batches.  What the design does about it: a register tile of
``block_rows`` rows x 4 columns per thread, so each weight load feeds
``block_rows`` FMAs and each float4 activation load 16.  See the source
for the numerics; a row's output is bit-identical whatever the batch.

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
BLOCK_ROWS = (1, 2, 4, 8, 16)   # the template instances the source builds
ACT_CODES = {"identity": 0, "relu": 1, "gelu": 2, "tanh": 3, "silu": 4,
             "sigmoid": 5}
SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu"
REPLACES = "src/repro/kernels/fused_mlp/fused_mlp.py:87"


def smem_bytes(widths: Sequence[int], block_rows: int) -> int:
    """Dynamic shared memory of one block: two [block_rows, stride] f32
    activation buffers, stride = the widest layer rounded to float4."""
    return 2 * block_rows * round_up(max(widths), 4) * 4


def fits_smem(widths: Sequence[int], block_rows: int) -> bool:
    return smem_bytes(widths, block_rows) <= SMEM_PER_BLOCK


@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """A dense stack packed once into one flat f32 buffer.

    Layer ``l`` occupies ``params[w_off:w_off+in*out]`` (row-major
    ``[in, out]``) then ``params[b_off:b_off+out]``; ``table`` holds
    ``(in, out, act code, w_off, b_off)`` per layer as int64, the layout
    the C entry point reads.
    """
    params: torch.Tensor
    widths: Tuple[int, ...]
    acts: Tuple[str, ...]
    table: np.ndarray

    @property
    def weights(self):
        return [self.params[int(e[3]):int(e[3]) + int(e[0] * e[1])]
                .view(int(e[0]), int(e[1])) for e in self.table]

    @property
    def biases(self):
        return [self.params[int(e[4]):int(e[4]) + int(e[1])]
                for e in self.table]


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
        rows.append((k, n, ACT_CODES[a], off, off + k * n))
        parts += [w.reshape(-1), b]
        off += k * n + n
        widths.append(n)
    dev = torch.device(device) if device is not None else parts[0].device
    params = torch.cat([p.to(device=dev, dtype=torch.float32)
                        for p in parts])
    return PackedMLP(params, tuple(widths), tuple(acts),
                     np.asarray(rows, np.int64).reshape(-1, 5))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_mlp")
    lib.fused_mlp_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.fused_mlp_f32.restype = ctypes.c_int
    lib.fused_mlp_max_layers.argtypes = []
    lib.fused_mlp_max_layers.restype = ctypes.c_int
    if lib.fused_mlp_max_layers() != MAX_LAYERS:
        raise RuntimeError("csrc/fused_mlp.cu and fused_mlp.py disagree on "
                           "MAX_LAYERS")
    return lib


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
        err = lib.fused_mlp_f32(x.data_ptr(), out.data_ptr(),
                                packed.params.data_ptr(), int(x.shape[0]),
                                table.ctypes.data, len(packed.acts),
                                int(block_rows), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp launch failed: cudaError {err}")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
