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

The backward, ``csrc/mamba_scan_bwd.cu`` (:func:`mamba_scan_bwd`,
launches in ``mamba_scan_bwd.launches``; plain version
:func:`~repro_torch.kernels.mamba_scan.ref.mamba_scan_bwd_ref`), replaces
no Pallas kernel either: it is the gradient the reference takes of the
same jnp scan.  It cuts time into chunks of :data:`BWD_CHUNK` steps
(:func:`bwd_launch_shape`) so that only ``S / BWD_CHUNK`` steps are
serial: a first kernel runs every chunk from a zero state forward and a
zero cotangent back, a second chains the chunks' boundary states from h0
and their incoming cotangents from dhT by each chunk's decay
``exp2(A log2(e) sum dt)``, a third takes every chunk at once, recomputes
its states from its boundary state (kept in registers, :data:`BWD_LANES`
lanes a channel, 4 states each) and walks its cotangent back to dx, ddt
and the partial sums of dBm, dCm (over a block's channels), dA and dD,
and a fourth adds the partials in a fixed order.  A block of the first
and third kernels walks :data:`BWD_CHUNKS_A_BLOCK` chunks in turn, each
chunk's inputs staged by ``cp.async``, double-buffered
(:func:`bwd_smem_bytes`).  No decay is divided by, no atomics: a relaunch
gives the same bits.
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
BWD_CHUNK = 16           # steps a chunk of the backward
BWD_CHANNELS = 64        # channels a backward block, BWD_LANES threads each
BWD_LANES = 4            # threads a channel, MAX_STATE / BWD_LANES states each
BWD_CHUNKS_A_BLOCK = 4   # chunks a block of the backward's chunk passes takes
BWD_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu"
BWD_REPLACES = "src/repro/models/blocks.py:538-588"


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


def _check_domain(kernel, dt, x, Bm, Cm, *more):
    """Raise ValueError unless every tensor given (None skipped) lies on
    one CUDA device, dt, x, Bm and Cm share one dtype of
    :data:`ELEMENT_BYTES`, and the state size is 1 to :data:`MAX_STATE`:
    the domain of both kernels."""
    devices = {t.device for t in (dt, x, Bm, Cm, *more) if t is not None}
    if len(devices) != 1 or dt.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs every tensor on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if dt.dtype not in ELEMENT_BYTES or {x.dtype, Bm.dtype, Cm.dtype} != {
            dt.dtype}:
        raise ValueError(f"dt, x, Bm, Cm must share one dtype of "
                         f"{sorted(map(str, ELEMENT_BYTES))}, got "
                         f"{[str(t.dtype) for t in (dt, x, Bm, Cm)]}")
    ds = int(Bm.shape[2])
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"state size {ds}: the kernel takes 1 to "
                         f"{MAX_STATE}")


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
    _check_domain("mamba_scan", dt, x, Bm, Cm, A, D, h0)
    B, S, di = (int(n) for n in dt.shape)
    ds = int(Bm.shape[2])
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


def bwd_launch_shape(b: int, s: int, di: int) -> dict:
    """The backward's grids at batch ``b``, ``s`` steps and ``di``
    channels: ``chunks`` of :data:`BWD_CHUNK` steps, ``channel_blocks`` of
    :data:`BWD_CHANNELS` channels, and the chunk groups of
    :data:`BWD_CHUNKS_A_BLOCK` that a block of the first and third
    kernels walks in turn; every block ``threads`` threads."""
    chunks = -(-s // BWD_CHUNK)
    blocks = -(-di // BWD_CHANNELS)
    groups = -(-chunks // BWD_CHUNKS_A_BLOCK)
    return {"threads": BWD_CHANNELS * BWD_LANES, "chunk": BWD_CHUNK,
            "chunks": chunks, "channel_blocks": blocks,
            "chunk_groups": groups,
            "grids": {"local": (blocks, groups, b),
                      "chain": -(-b * di * MAX_STATE // 256),
                      "chunks": (blocks, groups, b)}}


def bwd_smem_bytes(dtype) -> int:
    """Dynamic shared memory of a block of the backward's third kernel:
    two buffers of a chunk's dt and x ``[BWD_CHUNK, BWD_CHANNELS]`` in
    ``dtype``, dy in f32 and Bm, Cm ``[BWD_CHUNK, MAX_STATE]`` in f32, and
    of its boundary states and cotangents ``[BWD_CHANNELS, MAX_STATE]``;
    the warps' sums ``[BWD_CHUNK, 8, 2 MAX_STATE]`` and dx, ddt
    ``[BWD_CHUNK, BWD_CHANNELS]`` in f32."""
    f32, tile = 4, BWD_CHUNK * BWD_CHANNELS
    stage = 2 * tile * ELEMENT_BYTES[dtype] + tile * f32 \
        + 2 * BWD_CHUNK * MAX_STATE * f32
    warps = BWD_CHANNELS * BWD_LANES // 32
    return 2 * stage + 2 * 2 * BWD_CHANNELS * MAX_STATE * f32 \
        + BWD_CHUNK * warps * 2 * MAX_STATE * f32 + 2 * tile * f32


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("mamba_scan_bwd")
    lib.mamba_scan_bwd.argtypes = [ctypes.c_void_p] * 21 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_scan_bwd.restype = ctypes.c_int
    got = []
    for name in ("max_state", "chunk", "channels", "lanes",
                 "chunks_a_block"):
        fn = getattr(lib, f"mamba_scan_bwd_{name}")
        fn.argtypes, fn.restype = [], ctypes.c_int
        got.append(fn())
    lib.mamba_scan_bwd_smem.argtypes = [ctypes.c_int]
    lib.mamba_scan_bwd_smem.restype = ctypes.c_int
    got += [lib.mamba_scan_bwd_smem(ELEMENT_BYTES[t]) for t in ELEMENT_BYTES]
    want = [MAX_STATE, BWD_CHUNK, BWD_CHANNELS, BWD_LANES,
            BWD_CHUNKS_A_BLOCK] + [bwd_smem_bytes(t) for t in ELEMENT_BYTES]
    if got != want:
        raise RuntimeError(f"csrc/mamba_scan_bwd.cu and mamba_scan.py "
                           f"disagree on (MAX_STATE, BWD_CHUNK, "
                           f"BWD_CHANNELS, BWD_LANES, BWD_CHUNKS_A_BLOCK, "
                           f"shared memory f32, bf16): {got}, not {want}")
    return lib


def mamba_scan_bwd(dt, x, Bm, Cm, A, D, h0, dy, dhT=None):
    """Launch the backward on tensors on the card: the forward's inputs
    (as :func:`mamba_scan` takes them), y's cotangent ``dy`` ``[B, S,
    di]`` and the final state's ``dhT`` ``[B, di, ds]`` (None: zeros).
    Returns ``(ddt, dx, dBm, dCm, dA, dD, dh0)``, each in its input's
    dtype."""
    check_shapes(dt, x, Bm, Cm, A, D, h0)
    B, S, di = (int(n) for n in dt.shape)
    ds = int(Bm.shape[2])
    if tuple(dy.shape) != (B, S, di):
        raise ValueError(f"dy must be {(B, S, di)}, got {tuple(dy.shape)}")
    if dhT is not None and tuple(dhT.shape) != (B, di, ds):
        raise ValueError(f"dhT must be {(B, di, ds)}, got "
                         f"{tuple(dhT.shape)}")
    _check_domain("mamba_scan_bwd", dt, x, Bm, Cm, A, D, h0, dy, dhT)
    f32, dev = torch.float32, dt.device

    def wide(t):  # f32, zero-padded to MAX_STATE states, a new tensor
        return torch.nn.functional.pad(t.to(f32), (0, MAX_STATE - ds))
    h0p = wide(h0)
    dhTp = torch.zeros_like(h0p) if dhT is None else wide(dhT)
    if B * S == 0:
        return (torch.zeros_like(dt), torch.zeros_like(x),
                torch.zeros_like(Bm), torch.zeros_like(Cm),
                torch.zeros_like(A), torch.zeros_like(D),
                dhTp[..., :ds].to(h0.dtype))
    dt, x = dt.contiguous(), x.contiguous()
    Bp, Cp, Ap = wide(Bm), wide(Cm), wide(A)
    Df = D.to(f32).contiguous()
    dyf = dy.to(f32).contiguous()
    shape = bwd_launch_shape(B, S, di)
    nc, ng, ndb = (shape[k] for k in ("chunks", "chunk_groups",
                                      "channel_blocks"))

    def empty(*size):
        return torch.empty(size, dtype=f32, device=dev)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dBC, dA, dD, dh0 = (empty(B, S, 2, MAX_STATE), empty(di, MAX_STATE),
                        empty(di), empty(B, di, MAX_STATE))
    # scratch: boundary states and cotangents, the chunks' dt sums, and
    # the partial sums the last kernel adds in order
    HB, GC = empty(B, nc, di, MAX_STATE), empty(B, nc, di, MAX_STATE)
    DTS = empty(B, nc, di)
    BC_part = empty(B, S, ndb, 2 * MAX_STATE)
    A_part, D_part = empty(B, ng, di, MAX_STATE), empty(B, ng, di)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mamba_scan_bwd(*(t.data_ptr() for t in (
            dt, x, dyf, Bp, Cp, Ap, Df, h0p, dhTp, ddt, dx, dBC, dA, dD, dh0,
            HB, GC, DTS, BC_part, A_part, D_part)), B, S, di,
            ELEMENT_BYTES[dt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd launch failed: cudaError {err}")
    mamba_scan_bwd.launches += 1
    return (ddt, dx, dBC[:, :, 0, :ds].to(Bm.dtype),
            dBC[:, :, 1, :ds].to(Cm.dtype), dA[:, :ds].to(A.dtype),
            dD.to(D.dtype), dh0[..., :ds].to(h0.dtype))


mamba_scan_bwd.launches = 0
