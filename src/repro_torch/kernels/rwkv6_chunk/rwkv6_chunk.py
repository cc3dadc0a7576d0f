"""Hand-written CUDA kernel for the RWKV6 WKV recurrence, and its wrapper.

Replaces ``src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py::rwkv6_chunk``
(the Pallas TPU kernel).  The kernel, ``csrc/rwkv6_chunk.cu``, runs one
block per (batch, head) with ``hd`` threads; thread ``j`` keeps column
``j`` of the ``[hd, hd]`` state in registers and walks the time steps,
which the block stages in shared memory ``CHUNK`` at a time.

What bounds it on an H100: bytes (r, k, v, w read once, o written once),
but the recurrence is serial in time, so this simple design is bound by
the latency of each step's chain of ``hd`` FMAs.  The state's update is
rounded as the plain version rounds it, so the final state equals it bit
for bit; ``o``'s sum over ``i`` runs in another order.

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

HEAD_DIMS = (8, 16, 32, 64)   # the head sizes csrc/rwkv6_chunk.cu takes
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
SOURCE = "src/repro_torch/kernels/rwkv6_chunk/csrc/rwkv6_chunk.cu"
REPLACES = "src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py:47"


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rwkv6_chunk")
    lib.rwkv6_chunk.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.rwkv6_chunk.restype = ctypes.c_int
    lib.rwkv6_chunk_takes_head_dim.argtypes = [ctypes.c_int]
    lib.rwkv6_chunk_takes_head_dim.restype = ctypes.c_int
    takes = tuple(n for n in range(1, 257)
                  if lib.rwkv6_chunk_takes_head_dim(n))
    if takes != HEAD_DIMS:
        raise RuntimeError(f"csrc/rwkv6_chunk.cu takes head sizes {takes}, "
                           f"rwkv6_chunk.py says {HEAD_DIMS}")
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd}: the kernel takes {HEAD_DIMS}")
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
