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

Under grad the forward also keeps, for the backward, each channel's
state before every :data:`BWD_CHUNK`-th step (``keep_states``: ``[B,
ceil(S / BWD_CHUNK), di, MAX_STATE]`` f32, 134 MB at jamba's training
shape); without it, the serving path, it stores nothing.

The backward, ``csrc/mamba_scan_bwd.cu`` (:func:`mamba_scan_bwd`,
launches in ``mamba_scan_bwd.launches``; plain version
:func:`~repro_torch.kernels.mamba_scan.ref.mamba_scan_bwd_ref`), replaces
no Pallas kernel either: it is the gradient the reference takes of the
same jnp scan.  It is one reverse walk: a block per (batch, block of
:data:`BWD_CHANNELS` channels) takes the chunks of :data:`BWD_CHUNK`
steps from the last to the first, the cotangent carried across chunks in
registers from dhT to dh0; each chunk's states are recomputed from the
forward's kept state before it (in registers, :data:`BWD_LANES` lanes a
channel, 4 states each), then its cotangent is walked back, each step's
sums one shuffle level deep into shared memory, and the chunk's sums give
dx, ddt and the partial sums of dBm, dCm (over a block's channels), dA
and dD; a second kernel adds the partials in a fixed order
(:func:`bwd_launch_shape`).  Each chunk's inputs are staged by
``cp.async``, double-buffered (:func:`bwd_smem_bytes`).  Two
exps a state and step; no decay is divided by, no atomics: a relaunch
gives the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import KEEP_EVERY, check_shapes

MAX_STATE = 16   # the kernel takes ds 1 .. MAX_STATE
CHANNELS = 128   # channels a block, LANES threads each
STEPS = 32       # steps a staged chunk
LANES = 2        # threads a channel, MAX_STATE / LANES states each
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
REPLACES = "src/repro/models/blocks.py:563"
BWD_CHUNK = KEEP_EVERY  # steps a chunk of the backward, between kept states
BWD_CHANNELS = 64  # channels a backward block, BWD_LANES threads each
BWD_LANES = 4      # threads a channel, MAX_STATE / BWD_LANES states each
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
    lib.mamba_scan.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.mamba_scan.restype = ctypes.c_int
    got = []
    for name in ("mamba_scan_max_state", "mamba_scan_channels",
                 "mamba_scan_steps", "mamba_scan_lanes",
                 "mamba_scan_keep_every"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_int
        got.append(fn())
    if got != [MAX_STATE, CHANNELS, STEPS, LANES, BWD_CHUNK]:
        raise RuntimeError(f"csrc/mamba_scan.cu and mamba_scan.py disagree "
                           f"on (MAX_STATE, CHANNELS, STEPS, LANES, "
                           f"BWD_CHUNK): {got}")
    return lib


def kept_chunks(s: int) -> int:
    """Chunks of :data:`BWD_CHUNK` steps in ``s`` steps: the states the
    forward keeps for the backward, a batch row and channel."""
    return -(-s // BWD_CHUNK)


def mamba_scan(dt, x, Bm, Cm, A, D, h0, keep_states=False):
    """Launch the kernel on tensors on the card: dt, x ``[B, S, di]`` and
    Bm, Cm ``[B, S, ds]`` of one dtype (f32 or bf16), A ``[di, ds]``, D
    ``[di]``, h0 ``[B, di, ds]``.  Returns ``(y [B, S, di] f32,
    hT [B, di, ds] f32)``; with ``keep_states`` also the states before
    every :data:`BWD_CHUNK`-th step, ``[B, kept_chunks(S), di,
    MAX_STATE]`` f32, zero past ds, which :func:`mamba_scan_bwd`
    takes."""
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
    hs = (torch.empty((B, kept_chunks(S), di, MAX_STATE),
                      dtype=torch.float32, device=dt.device)
          if keep_states else None)
    out = (y, hT, hs) if keep_states else (y, hT)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.mamba_scan(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(),
                             Cm.data_ptr(), A.data_ptr(), D.data_ptr(),
                             h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
                             None if hs is None else hs.data_ptr(), B, S, di,
                             ds, ELEMENT_BYTES[dt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {err}")
    mamba_scan.launches += 1
    return out


mamba_scan.launches = 0


def bwd_launch_shape(b: int, s: int, di: int) -> dict:
    """The backward's walk at batch ``b``, ``s`` steps and ``di``
    channels: a block of ``threads`` threads per (block of
    :data:`BWD_CHANNELS` channels, batch row), ``grid`` ``(channel_blocks,
    b)``, each walking ``chunks`` chunks of :data:`BWD_CHUNK` steps from
    the last."""
    blocks = -(-di // BWD_CHANNELS)
    return {"threads": BWD_CHANNELS * BWD_LANES, "chunk": BWD_CHUNK,
            "chunks": kept_chunks(s), "channel_blocks": blocks,
            "grid": (blocks, b)}


def bwd_smem_bytes(dtype) -> int:
    """Dynamic shared memory of a block of the backward's walk: two
    stages of a chunk's dt and x ``[BWD_CHUNK, BWD_CHANNELS]`` in
    ``dtype``, dy in f32 and Bm, Cm ``[BWD_CHUNK, MAX_STATE]`` in f32;
    the channel pairs' sums ``[BWD_CHUNK, BWD_CHANNELS / 2, 2 MAX_STATE]``
    and the halves of du and qa ``[BWD_CHUNK, BWD_CHANNELS, BWD_LANES]``
    in f32."""
    f32, tile = 4, BWD_CHUNK * BWD_CHANNELS
    stage = 2 * tile * ELEMENT_BYTES[dtype] + tile * f32 \
        + 2 * BWD_CHUNK * MAX_STATE * f32
    pairs = BWD_CHUNK * BWD_CHANNELS // 2 * 2 * MAX_STATE * f32
    return 2 * stage + pairs + tile * BWD_LANES * f32


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("mamba_scan_bwd")
    lib.mamba_scan_bwd.argtypes = [ctypes.c_void_p] * 18 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_scan_bwd.restype = ctypes.c_int
    got = []
    for name in ("max_state", "chunk", "channels", "lanes"):
        fn = getattr(lib, f"mamba_scan_bwd_{name}")
        fn.argtypes, fn.restype = [], ctypes.c_int
        got.append(fn())
    lib.mamba_scan_bwd_smem.argtypes = [ctypes.c_int]
    lib.mamba_scan_bwd_smem.restype = ctypes.c_int
    got += [lib.mamba_scan_bwd_smem(ELEMENT_BYTES[t]) for t in ELEMENT_BYTES]
    want = [MAX_STATE, BWD_CHUNK, BWD_CHANNELS, BWD_LANES] \
        + [bwd_smem_bytes(t) for t in ELEMENT_BYTES]
    if got != want:
        raise RuntimeError(f"csrc/mamba_scan_bwd.cu and mamba_scan.py "
                           f"disagree on (MAX_STATE, BWD_CHUNK, "
                           f"BWD_CHANNELS, BWD_LANES, shared memory f32, "
                           f"bf16): {got}, not {want}")
    return lib


def mamba_scan_bwd(dt, x, Bm, Cm, A, D, h0, dy, dhT=None, *, states):
    """Launch the backward on tensors on the card: the forward's inputs
    (as :func:`mamba_scan` takes them), y's cotangent ``dy`` ``[B, S,
    di]``, the final state's ``dhT`` ``[B, di, ds]`` (None: zeros) and
    the forward's kept ``states`` (``mamba_scan(..., keep_states=True)``'s
    third output).  Returns ``(ddt, dx, dBm, dCm, dA, dD, dh0)``, each in
    its input's dtype."""
    check_shapes(dt, x, Bm, Cm, A, D, h0)
    B, S, di = (int(n) for n in dt.shape)
    ds = int(Bm.shape[2])
    if tuple(dy.shape) != (B, S, di):
        raise ValueError(f"dy must be {(B, S, di)}, got {tuple(dy.shape)}")
    if dhT is not None and tuple(dhT.shape) != (B, di, ds):
        raise ValueError(f"dhT must be {(B, di, ds)}, got "
                         f"{tuple(dhT.shape)}")
    want = (B, kept_chunks(S), di, MAX_STATE)
    if tuple(states.shape) != want or states.dtype != torch.float32:
        raise ValueError(f"states must be the forward's kept states, f32 "
                         f"{want}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    _check_domain("mamba_scan_bwd", dt, x, Bm, Cm, A, D, h0, dy, dhT,
                  states)
    f32, dev = torch.float32, dt.device

    def wide(t):  # f32, zero-padded to MAX_STATE states, a new tensor
        return torch.nn.functional.pad(t.to(f32), (0, MAX_STATE - ds))
    dhTp = torch.zeros((B, di, MAX_STATE), dtype=f32, device=dev) \
        if dhT is None else wide(dhT)
    if B * S == 0:
        return (torch.zeros_like(dt), torch.zeros_like(x),
                torch.zeros_like(Bm), torch.zeros_like(Cm),
                torch.zeros_like(A), torch.zeros_like(D),
                dhTp[..., :ds].to(h0.dtype))
    dt, x, states = dt.contiguous(), x.contiguous(), states.contiguous()
    Bp, Cp, Ap = wide(Bm), wide(Cm), wide(A)
    Df = D.to(f32).contiguous()
    dyf = dy.to(f32).contiguous()
    ndb = bwd_launch_shape(B, S, di)["channel_blocks"]

    def empty(*size):
        return torch.empty(size, dtype=f32, device=dev)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dBC, dA, dD, dh0 = (empty(B, S, 2, MAX_STATE), empty(di, MAX_STATE),
                        empty(di), empty(B, di, MAX_STATE))
    # scratch: the partial sums the second kernel adds in order
    BC_part = empty(B, S, ndb, 2 * MAX_STATE)
    A_part, D_part = empty(B, di, MAX_STATE), empty(B, di)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mamba_scan_bwd(*(t.data_ptr() for t in (
            dt, x, dyf, Bp, Cp, Ap, Df, states, dhTp, ddt, dx, dBC, dA, dD,
            dh0, BC_part, A_part, D_part)), B, S, di,
            ELEMENT_BYTES[dt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd launch failed: cudaError {err}")
    mamba_scan_bwd.launches += 1
    return (ddt, dx, dBC[:, :, 0, :ds].to(Bm.dtype),
            dBC[:, :, 1, :ds].to(Cm.dtype), dA[:, :ds].to(A.dtype),
            dD.to(D.dtype), dh0[..., :ds].to(h0.dtype))


mamba_scan_bwd.launches = 0
