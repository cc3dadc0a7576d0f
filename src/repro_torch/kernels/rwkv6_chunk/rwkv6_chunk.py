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

The backward, ``csrc/rwkv6_chunk_bwd.cu`` (:func:`rwkv6_chunk_bwd`,
launches in ``rwkv6_chunk_bwd.launches``; plain version
:func:`~repro_torch.kernels.rwkv6_chunk.ref.rwkv6_chunk_bwd_ref`),
replaces no Pallas kernel: it is the gradient XLA takes of the
reference's chunked scan.  It cuts time into chunks of C steps
(:func:`bwd_launch_shape`) so that only T / C steps are serial.  A first
kernel walks the chunks' boundary states, the state before each chunk
forward from s0 and the cotangent after it backward from dsT, a block per
state of one (batch, head), each chunk one product with the chunk's
decayed inputs on the tensor cores.  A second kernel takes every chunk
at once, a block each: the terms of dr and dk from the boundary states
and the
chunk's own steps (Horner sums over the chunk, so every decay is a
product of w, never a quotient), dv from the cotangent and a [C, C]
matrix of the chunk's pairs, and dw from ``w_t dw_t = a_t - k_t dk'_t``
with ``a_{t-1} = a_t + r_t dr'_t - k_t dk'_t`` (primes: without the u
term; a in f64) walked back over the chunk only, from ``a`` at its end
made of the boundary states (it needs w > 0).  A third adds du's parts
in order.  No per-step state is stored (the scratch holds the boundary
states, freed with the call); no atomics.
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
#: per head tile, the backward's steps a chunk (csrc/rwkv6_chunk_bwd.cu's
#: BwdTile); a chunk block has a 2 x 4 tile of the chunk's [C, head tile]
#: outputs a thread
BWD_TILES = {32: 16, 64: 32, 128: 16}
BWD_SOURCE = "src/repro_torch/kernels/rwkv6_chunk/csrc/rwkv6_chunk_bwd.cu"
BWD_REPLACES = "src/repro/models/blocks.py:457-479"


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


def bwd_launch_shape(hd: int) -> dict:
    """The chunk blocks of the backward at head size ``hd``: the head tile,
    the steps of a chunk and a block's threads."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head size {hd}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    tile = next(t for t in sorted(BWD_TILES) if hd <= t)
    chunk = BWD_TILES[tile]
    return {"head_tile": tile, "chunk": chunk, "threads": chunk * tile // 8}


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


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("rwkv6_chunk_bwd")
    lib.rwkv6_chunk_bwd.argtypes = [ctypes.c_void_p] * 17 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rwkv6_chunk_bwd.restype = ctypes.c_int
    for name in ("rwkv6_chunk_bwd_takes_head_dim", "rwkv6_chunk_bwd_threads",
                 "rwkv6_chunk_bwd_chunk"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    takes = [n for n in range(1, 257)
             if lib.rwkv6_chunk_bwd_takes_head_dim(n)]
    shapes = [(lib.rwkv6_chunk_bwd_threads(n), lib.rwkv6_chunk_bwd_chunk(n))
              for n in takes]
    if takes != list(range(1, MAX_HEAD_DIM + 1)) or shapes != [
            (bwd_launch_shape(n)["threads"], bwd_launch_shape(n)["chunk"])
            for n in takes]:
        raise RuntimeError("csrc/rwkv6_chunk_bwd.cu and rwkv6_chunk.py "
                           "disagree on the head sizes or the block shapes")
    return lib


def rwkv6_chunk_bwd(r, k, v, w, u, s0, do, dsT=None, sT=None):
    """Launch the backward on tensors on the card: the forward's inputs,
    o's cotangent ``do`` (r's shape and dtype) and the final state's
    ``dsT`` ``[B, H, hd, hd]`` (None: zeros), beside the forward's final
    state ``sT``, which the registry hands every backward with a dsT
    (the kernel rebuilds what it needs of the state from s0, so sT is
    checked but not read).  Returns ``(dr, dk, dv, dw, du, ds0)``, each in
    its input's dtype."""
    check_shapes(r, k, v, w, u, s0)
    B, T, H, hd = (int(n) for n in r.shape)
    state = (B, H, hd, hd)
    if tuple(do.shape) != tuple(r.shape):
        raise ValueError(f"do must be {tuple(r.shape)}, got "
                         f"{tuple(do.shape)}")
    if dsT is not None and (sT is None or tuple(dsT.shape) != state
                            or tuple(sT.shape) != state):
        raise ValueError(f"dsT needs sT, both {state}")
    given = [t for t in (r, k, v, w, u, s0, do, dsT, sT) if t is not None]
    devices = {t.device for t in given}
    if len(devices) != 1 or r.device.type != "cuda":
        raise ValueError(f"rwkv6_chunk_bwd kernel needs every tensor on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    if r.dtype not in ELEMENT_BYTES or {k.dtype, v.dtype, w.dtype,
                                        do.dtype} != {r.dtype}:
        raise ValueError(f"r, k, v, w, do must share one dtype of "
                         f"{sorted(map(str, ELEMENT_BYTES))}, got "
                         f"{[str(t.dtype) for t in (r, k, v, w, do)]}")
    shape = bwd_launch_shape(hd)  # raises above MAX_HEAD_DIM
    f32 = torch.float32
    r, k, v, w, do = (t.contiguous() for t in (r, k, v, w, do))
    uf, s0f = (t.to(f32).contiguous() for t in (u, s0))
    if dsT is not None:
        dsT = dsT.to(f32).contiguous()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((H, hd), dtype=f32, device=r.device)
    ds0 = torch.empty(state, dtype=f32, device=r.device)
    if B * H == 0:
        return dr, dk, dv, dw, du.zero_().to(u.dtype), ds0.to(s0.dtype)
    # the boundary states, each [head tile, head tile] (zero padded), and
    # du's part of each (b, h, chunk)
    nc, tile = -(-T // shape["chunk"]), shape["head_tile"]
    S_st, G_st = (torch.empty((B, H, nc, tile, tile), dtype=f32,
                              device=r.device) for _ in range(2))
    du_part = torch.empty((B, H, nc, hd), dtype=f32, device=r.device)
    lib = _bwd_lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_chunk_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uf.data_ptr(), s0f.data_ptr(), do.data_ptr(),
            dsT.data_ptr() if dsT is not None else None, dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), S_st.data_ptr(), G_st.data_ptr(),
            du_part.data_ptr(), B, T, H, hd, ELEMENT_BYTES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_chunk_bwd launch failed: cudaError {err}")
    rwkv6_chunk_bwd.launches += 1
    return dr, dk, dv, dw, du.to(u.dtype), ds0.to(s0.dtype)


rwkv6_chunk_bwd.launches = 0
