"""Hand-written CUDA kernel for the RWKV6 WKV recurrence, and its wrapper.

Replaces ``src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py::rwkv6_chunk``
(the Pallas TPU kernel).  The kernel, ``csrc/rwkv6_chunk.cu``, runs one
block per (batch, head).  The head is padded to a tile of 32, 64 or 128
lanes and its rows are split into row groups (:func:`launch_shape`):
thread ``(g, j)`` keeps the state's column ``j`` over the rows of group
``g`` in registers, each group's partial of ``o`` goes to shared memory
and the block adds the partials in ascending ``g`` once per chunk of
steps.  The steps are staged into shared memory by ``cp.async``,
double-buffered.  Any head size from 1 to :data:`MAX_HEAD_DIM`.

What bounds it on an H100: bytes (r, k, v, w read once, o written once),
but the recurrence is serial in time, so a block per (batch, head) is
bound by issue on its SM.  The state's update is rounded as the plain
version rounds it, so the final state equals it bit for bit; ``o``'s sum
over ``i`` runs in the order above.

The plain version is
:func:`repro_torch.kernels.rwkv6_chunk.ref.rwkv6_chunk_ref`;
:func:`rwkv6_chunk` counts its launches in ``rwkv6_chunk.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_chunk.ref import check_shapes

MAX_HEAD_DIM = 128   # the kernel takes head sizes 1 .. MAX_HEAD_DIM
#: per head tile (csrc/rwkv6_chunk.cu's Tile): (row groups, steps a chunk)
TILES = {32: (4, 32), 64: (8, 32), 128: (4, 16)}
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
SOURCE = "src/repro_torch/kernels/rwkv6_chunk/csrc/rwkv6_chunk.cu"
REPLACES = "src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py:47"


def launch_shape(hd: int) -> dict:
    """The block that walks one (batch, head) at head size ``hd``: its
    head tile, row groups, rows per group, threads and steps a chunk."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head size {hd}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    tile = next(t for t in sorted(TILES) if hd <= t)
    groups, chunk = TILES[tile]
    return {"head_tile": tile, "row_groups": groups,
            "rows_per_group": tile // groups, "threads": tile * groups,
            "chunk": chunk}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rwkv6_chunk")
    lib.rwkv6_chunk.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.rwkv6_chunk.restype = ctypes.c_int
    for name in ("rwkv6_chunk_takes_head_dim", "rwkv6_chunk_threads"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    takes = [n for n in range(1, 257) if lib.rwkv6_chunk_takes_head_dim(n)]
    threads = [lib.rwkv6_chunk_threads(n) for n in takes]
    if takes != list(range(1, MAX_HEAD_DIM + 1)) or threads != [
            launch_shape(n)["threads"] for n in takes]:
        raise RuntimeError("csrc/rwkv6_chunk.cu and rwkv6_chunk.py disagree "
                           "on the head sizes or the block shapes")
    return lib


def rwkv6_chunk(r, k, v, w, u, s0):
    """Launch the kernel on tensors on the card: r, k, v, w
    ``[B, T, H, hd]`` of one dtype (f32 or bf16), u ``[H, hd]``, s0
    ``[B, H, hd, hd]``.  Returns ``(o [B, T, H, hd] in r's dtype,
    sT [B, H, hd, hd] f32)``."""
    check_shapes(r, k, v, w, u, s0)
    devices = {t.device for t in (r, k, v, w, u, s0)}
    if len(devices) != 1 or r.device.type != "cuda":
        raise ValueError(f"rwkv6_chunk kernel needs every tensor on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    if r.dtype not in ELEMENT_BYTES or {k.dtype, v.dtype, w.dtype} != {
            r.dtype}:
        raise ValueError(f"r, k, v, w must share one dtype of "
                         f"{sorted(map(str, ELEMENT_BYTES))}, got "
                         f"{[str(t.dtype) for t in (r, k, v, w)]}")
    B, T, H, hd = (int(n) for n in r.shape)
    launch_shape(hd)  # raises above MAX_HEAD_DIM
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32).contiguous()
    o = torch.empty_like(r)
    sT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return o, sT
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_chunk(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                              o.data_ptr(), sT.data_ptr(), B, T, H, hd,
                              ELEMENT_BYTES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_chunk launch failed: cudaError {err}")
    rwkv6_chunk.launches += 1
    return o, sT


rwkv6_chunk.launches = 0
