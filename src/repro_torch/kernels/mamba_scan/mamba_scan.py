"""Hand-written CUDA kernel for the Mamba selective scan, and its wrapper.

Replaces no Pallas kernel: the reference computes this scan in jnp in its
Mamba mixer (``src/repro/models/blocks.py:563-586``, an associative scan
over chunks of 64 steps), and so does the port's plain version
(:func:`repro_torch.kernels.mamba_scan.ref.mamba_scan_ref`).  At jamba's
width that form writes ``[B, 64, di, ds]`` f32 tensors several times a
chunk; the kernel, ``csrc/mamba_scan.cu``, reads dt, x, Bm and Cm once
and writes y once.  :data:`LANES` lanes of a warp own one channel of
one batch row, each ``MAX_STATE / LANES`` of its states in registers
(blocks of :data:`CHANNELS` channels; :func:`launch_shape`); each decay
is one ``ex2.approx.ftz`` on the SFUs; the steps are staged into shared
memory in chunks of :data:`STEPS` by ``cp.async``, double-buffered, Bm
and Cm as f32 rows the wrapper converts once.  Any sequence length and
channel count, ``ds`` up to :data:`MAX_STATE`.

What bounds it on an H100: the exponentials (one a state and step, 16 a
clock an SM on the SFUs) and the instruction slots of the f32 work and
the shared-memory loads beside them, ahead of the bytes.

:func:`mamba_scan` counts its launches in ``mamba_scan.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import check_shapes

MAX_STATE = 16   # the kernel takes ds 1 .. MAX_STATE
CHANNELS = 128   # channels a block, LANES threads each
STEPS = 32       # steps a staged chunk
LANES = 2        # threads a channel, MAX_STATE / LANES states each
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
REPLACES = "src/repro/models/blocks.py:563"


def launch_shape(b: int, di: int) -> dict:
    """The grid of one call at batch ``b`` and ``di`` channels: blocks of
    :data:`CHANNELS` channels, :data:`LANES` threads a channel,
    ``ceil(di / CHANNELS)`` of them a batch row."""
    blocks = -(-di // CHANNELS)
    return {"threads": CHANNELS * LANES, "blocks": blocks * b,
            "grid": (blocks, b), "steps_a_chunk": STEPS}


def smem_bytes(dtype) -> int:
    """Dynamic shared memory of one block: two staged chunks of dt and x
    ``[STEPS, CHANNELS]`` in ``dtype`` and Bm and Cm ``[STEPS,
    MAX_STATE]`` in f32."""
    return 2 * (2 * STEPS * CHANNELS * ELEMENT_BYTES[dtype]
                + 2 * STEPS * MAX_STATE * 4)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mamba_scan")
    lib.mamba_scan.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.mamba_scan.restype = ctypes.c_int
    got = []
    for name in ("mamba_scan_max_state", "mamba_scan_channels",
                 "mamba_scan_steps", "mamba_scan_lanes"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_int
        got.append(fn())
    if got != [MAX_STATE, CHANNELS, STEPS, LANES]:
        raise RuntimeError(f"csrc/mamba_scan.cu and mamba_scan.py disagree "
                           f"on (MAX_STATE, CHANNELS, STEPS, LANES): {got}")
    return lib


def mamba_scan(dt, x, Bm, Cm, A, D, h0):
    """Launch the kernel on tensors on the card: dt, x ``[B, S, di]`` and
    Bm, Cm ``[B, S, ds]`` of one dtype (f32 or bf16), A ``[di, ds]``, D
    ``[di]``, h0 ``[B, di, ds]``.  Returns ``(y [B, S, di] f32,
    hT [B, di, ds] f32)``."""
    check_shapes(dt, x, Bm, Cm, A, D, h0)
    devices = {t.device for t in (dt, x, Bm, Cm, A, D, h0)}
    if len(devices) != 1 or dt.device.type != "cuda":
        raise ValueError(f"mamba_scan kernel needs every tensor on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if dt.dtype not in ELEMENT_BYTES or {x.dtype, Bm.dtype, Cm.dtype} != {
            dt.dtype}:
        raise ValueError(f"dt, x, Bm, Cm must share one dtype of "
                         f"{sorted(map(str, ELEMENT_BYTES))}, got "
                         f"{[str(t.dtype) for t in (dt, x, Bm, Cm)]}")
    B, S, di = (int(n) for n in dt.shape)
    ds = int(Bm.shape[2])
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"state size {ds}: the kernel takes 1 to "
                         f"{MAX_STATE}")
    dt, x = dt.contiguous(), x.contiguous()
    # new [B, S, MAX_STATE] f32 tensors, zero past ds: the kernel stages
    # their rows with 16-byte copies and reads them without converting
    Bm, Cm = (t.to(torch.float32, memory_format=torch.contiguous_format,
                   copy=True)
              if ds == MAX_STATE else
              torch.nn.functional.pad(t.to(torch.float32),
                                      (0, MAX_STATE - ds))
              for t in (Bm, Cm))
    A, D, h0 = (t.to(torch.float32).contiguous() for t in (A, D, h0))
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    hT = torch.empty((B, di, ds), dtype=torch.float32, device=dt.device)
    if B == 0:
        return y, hT
    lib = _lib()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.mamba_scan(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(),
                             Cm.data_ptr(), A.data_ptr(), D.data_ptr(),
                             h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B,
                             S, di, ds, ELEMENT_BYTES[dt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {err}")
    mamba_scan.launches += 1
    return y, hT


mamba_scan.launches = 0
