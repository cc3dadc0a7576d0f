"""Hand-written CUDA kernel for the data bridge's stencil gather (im2col),
and its wrapper.

Replaces ``src/repro/kernels/stencil_gather/stencil_gather.py::
stencil_gather`` (the Pallas TPU kernel).  The kernel,
``csrc/stencil_gather.cu``, writes ``out[i, j, f] = x[o0 + i + dy_f,
o1 + j + dx_f]`` one output tile of ``(block_h, block_w)`` per block, one
thread per output element in row-major order.

What bounds it on an H100: bytes (the source read once, the output
written once; no arithmetic).  What the design does about it: a warp's
stores are 32 consecutive elements, and the F reads of one source
element by neighbouring points come from L1/L2.  Elements are copied as
integers of their width, so the result equals the plain version bit for
bit at every tile size.

Unlike the Pallas wrapper, which pads the end of the source to whole
blocks, the port requires every read to lie in the source
(:func:`~repro_torch.kernels.stencil_gather.ref.check_bounds`, as the
reference's slices do) and masks the ragged edge of the output instead.

The plain version is
:func:`repro_torch.kernels.stencil_gather.ref.stencil_gather_ref`;
:func:`stencil_gather` counts its launches in ``stencil_gather.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil_gather.ref import check_bounds

MAX_FEATURES = 64   # Offsets capacity in csrc/stencil_gather.cu
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
SOURCE = "src/repro_torch/kernels/stencil_gather/csrc/stencil_gather.cu"
REPLACES = "src/repro/kernels/stencil_gather/stencil_gather.py:53"


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("stencil_gather")
    lib.stencil_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.stencil_gather.restype = ctypes.c_int
    lib.stencil_gather_max_features.argtypes = []
    lib.stencil_gather_max_features.restype = ctypes.c_int
    if lib.stencil_gather_max_features() != MAX_FEATURES:
        raise RuntimeError("csrc/stencil_gather.cu and stencil_gather.py "
                           "disagree on MAX_FEATURES")
    return lib


def stencil_gather(x: torch.Tensor, offsets, out_h: int, out_w: int, *,
                   origin=(0, 0), block_h: int, block_w: int) -> torch.Tensor:
    """Launch the kernel on ``x`` ([H, W] f32 or bf16 on the card);
    returns ``[out_h, out_w, len(offsets)]`` of ``x``'s dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"stencil_gather kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in ELEMENT_BYTES or x.ndim != 2:
        raise ValueError(f"x must be f32 or bf16 [H, W], got {x.dtype} "
                         f"{tuple(x.shape)}")
    offsets = [(int(dy), int(dx)) for dy, dx in offsets]
    if len(offsets) > MAX_FEATURES:
        raise ValueError(f"{len(offsets)} offsets, the kernel takes at most "
                         f"{MAX_FEATURES}")
    if block_h < 1 or block_w < 1:
        raise ValueError(f"tile {block_h}x{block_w} is empty")
    check_bounds(x.shape, offsets, out_h, out_w, origin)
    x = x.contiguous()
    out = torch.empty((out_h, out_w, len(offsets)), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    w = int(x.shape[1])
    src = np.asarray([(origin[0] + dy) * w + origin[1] + dx
                      for dy, dx in offsets], np.int64)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stencil_gather(x.data_ptr(), out.data_ptr(), w, int(out_h),
                                 int(out_w), src.ctypes.data, len(offsets),
                                 ELEMENT_BYTES[x.dtype], int(block_h),
                                 int(block_w), stream)
    if err != 0:
        raise RuntimeError(f"stencil_gather launch failed: cudaError {err}")
    stencil_gather.launches += 1
    return out


stencil_gather.launches = 0
