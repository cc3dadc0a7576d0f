"""Hand-written CUDA kernel for flash attention (online softmax, GQA,
absolute-position causal mask), and its wrapper.

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention`` (the Pallas TPU kernel), widened past it: the q.k head
takes up to 256, and V may be narrower than q and K (MLA's 192-wide q.k
head over a 128-wide v head): past a q.k tile of 128 V has a head tile
(128) and a width of its own; up to 128 the wrapper pads a narrower V to
hd and cuts the output back.  The kernel,
``csrc/flash_attention.cu``, gives each block ``block_q`` query rows of
one (batch, head), one warp per 16 rows, keeps their scaled q tile in
shared memory and streams K/V through a two-stage ring of shared memory
``block_kv`` keys at a time (16-byte ``cp.async``), with the running max,
denominator and accumulator in f32.

What bounds it on an H100: the two products at prefill shapes, bytes for
a decode window.  What the design does about it: both products run on
the tensor cores as 3xTF32 ``mma.sync`` (each f32 operand split into two
TF32 parts, three products; two when K/V are bf16 and so exact in TF32),
which keeps f32 accuracy and the 2e-5 tolerance.  Each f32 chunk is split
once by the whole block into a shared hi/lo buffer.  S stays in registers
as mma accumulators, the online softmax runs on them with quad shuffles,
and P feeds ``P @ V`` from the same registers (the chunk's keys are summed
in a permuted order that matches the accumulator layout); keys past the
causal horizon of a block, or of a warp's 16 rows, are skipped when every
row sees a key.

Keys past ``Skv`` are never read, so a row that sees no key (``kv_valid_len
= 0``) gets the mean of V over the ``Skv`` keys, as the reference's
oracle gives; the Pallas kernel also averages its zero padding there.

The plain version is
:func:`repro_torch.kernels.flash_attention.ref.flash_attention_ref`;
:func:`flash_attention` counts its launches in
``flash_attention.launches``.

:func:`flash_attention_bwd` launches the backward,
``csrc/flash_attention_bwd.cu`` (two kernels: dQ with each row's
log-sum-exp, then dK and dV summed over each kv head's q heads; products
on the tensor cores, bf16 ``mma.sync`` for bf16 inputs with P and dS
rounded to bf16 as operands, 3xTF32 for f32; no atomics); it has no
Pallas source, the JAX package differentiating its jnp attention
instead.  Its plain version is
:func:`repro_torch.kernels.flash_attention.ref.flash_attention_bwd_ref`
and it counts its calls in ``flash_attention_bwd.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.registry import SMEM_PER_BLOCK, round_up

BLOCK_Q = (64, 128)        # rows per block the source launches: 4 or 8 warps
BLOCK_KV = (32, 64, 128)   # the chunk sizes the source instantiates
STAGES = 2                 # K/V chunks in flight (STAGES in the source)
MAX_HEAD_DIM = 256         # q and k
MAX_V_HEAD_DIM = 128       # v, at most hd
DTYPES = (torch.float32, torch.bfloat16)
SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:73"
BWD_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd.cu")
# no Pallas source: the reference's gradient is XLA's autodiff of this
BWD_REPLACES = "src/repro/models/attention.py:82"
# (warps, chunk rows) of the backward's dq and dkdv kernels by input
# dtype: a warp owns 16 of its block's query rows (dq) or keys (dkdv); a
# chunk is the keys (dq) or query rows (dkdv) streamed through shared memory
BWD_SHAPE = {torch.bfloat16: ((4, 64), (4, 64)),
             torch.float32: ((8, 32), (4, 16))}
BWD_MAX_HEAD_DIM = 128     # the backward: hd = hdv up to this


def head_tile(hd: int) -> int:
    """hd rounded up to the q.k head tile the source is built for (32, 64,
    96 or 128, then 160, 192 or 256); the columns past hd are zeros in
    shared memory."""
    if hd <= 128:
        return round_up(hd, 32)
    return next(t for t in (160, 192, MAX_HEAD_DIM) if hd <= t)


def v_tile(hd: int) -> int:
    """V's head tile beside q.k width ``hd`` (``v_tile`` in the source):
    the q.k tile up to 128, then 128."""
    return min(head_tile(hd), MAX_V_HEAD_DIM)


def stages(hd: int, bf16: bool = False) -> int:
    """K/V chunks in flight: ``STAGES``, or one for f32 q.k tiles past 128
    (the TF32 split already frees the raw stage once a chunk is split)."""
    return STAGES if bf16 or head_tile(hd) <= 128 else 1


def smem_bytes(block_q: int, block_kv: int, hd: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of one block (``smem_size`` in the source):
    the f32 q tile (rows padded by 4 words), :func:`stages` K and V chunks
    in the input dtype as they arrive (rows padded by 4 f32 words or 8
    bf16 halves, so a warp's fragment loads hit 32 distinct banks; V rows
    :func:`v_tile` wide), and for f32 inputs one chunk split into TF32 K
    hi, K lo, V hi and V lo."""
    hdt, hdvt, n = head_tile(hd), v_tile(hd), stages(hd, bf16)
    if bf16:
        return 4 * block_q * (hdt + 4) + n * block_kv * 2 * (hdt + hdvt + 16)
    return (4 * block_q * (hdt + 4)
            + (n + 2) * block_kv * 4 * (hdt + hdvt + 8))


def fits(hd: int, block_q: int, block_kv: int, bf16: bool = False,
         hdv: int = None) -> bool:
    """Whether the kernel takes this tile at q.k head dim ``hd`` and v head
    dim ``hdv`` (``hd`` when None): a launched ``block_q`` and
    ``block_kv``, ``hdv`` at most ``hd`` and within V's head tile, and the
    shared memory within a block's 227 KB (at hd 128 in f32 only
    ``block_kv`` 32 fits; past 128 in f32 only ``block_q`` 64 with it)."""
    hdv = hd if hdv is None else hdv
    return (block_q in BLOCK_Q and block_kv in BLOCK_KV
            and 1 <= hd <= MAX_HEAD_DIM and 1 <= hdv <= min(hd, v_tile(hd))
            and smem_bytes(block_q, block_kv, hd, bf16) <= SMEM_PER_BLOCK)


def softmax_scale(hd: int) -> float:
    """The reference's ``1 / hd ** 0.5``, rounded to f32 as the kernel
    (and JAX's weak-typed multiply) uses it."""
    return float(np.float32(1.0 / (hd ** 0.5)))


def check_shapes(q, k, v, *, same_width: bool = False) -> None:
    """q ``[B, Sq, H, hd]``, k ``[B, Skv, KV, hd]`` and v ``[B, Skv, KV,
    hdv]``: k and v agree in B, Skv and KV (and hd, with
    ``same_width``), and KV divides H."""
    if (q.ndim != 4 or k.ndim != 4 or v.ndim != 4
            or tuple(k.shape[:3]) != tuple(v.shape[:3])
            or (same_width and k.shape[3] != v.shape[3])):
        raise ValueError(f"need q [B, Sq, H, hd], k [B, Skv, KV, hd] and v "
                         f"[B, Skv, KV, {'hd' if same_width else 'hdv'}], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (batch, hd, H % KV)")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    if any(lib.flash_attention_smem_bytes(128, 64, hd, bf16)
           != smem_bytes(128, 64, hd, bool(bf16))
           for hd in (40, 128, 192, 256) for bf16 in (0, 1)):
        raise RuntimeError("csrc/flash_attention.cu and flash_attention.py "
                           "disagree on the shared-memory layout")
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len=None, block_q: int,
                    block_kv: int) -> torch.Tensor:
    """Launch the kernel: q ``[B, Sq, H, hd]``, k ``[B, Skv, KV, hd]`` and
    v ``[B, Skv, KV, hdv]``, all f32 or all bf16 on one card; returns
    ``[B, Sq, H, hdv]`` of q's dtype.  A shape or tile the kernel does not
    take raises."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs a CUDA tensor, got "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be f32 or all bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(q, k, v)
    B, Sq, H, hd = (int(s) for s in q.shape)
    Skv, KV, hdv = int(k.shape[1]), int(k.shape[2]), int(v.shape[3])
    if not fits(hd, block_q, block_kv, q.dtype == torch.bfloat16, hdv):
        raise ValueError(f"block_q={block_q}, block_kv={block_kv} does not "
                         f"fit hd={hd}, hdv={hdv}")
    # up to a q.k tile of 128 the kernel's V is as wide as K: a narrower
    # V is padded with zeros to hd, and the output cut back to hdv
    narrow = hdv != hd and head_tile(hd) <= 128
    if narrow:
        v = torch.nn.functional.pad(v, (0, hd - hdv))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty((B, Sq, H, hd if narrow else hdv))
    if out.numel() == 0 or Skv == 0:
        return q.new_zeros((B, Sq, H, hdv))
    valid = Skv if kv_valid_len is None else min(max(int(kv_valid_len), 0),
                                                 Skv)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KV, hd, int(v.shape[3]), int(bool(causal)),
            int(q_offset), valid,
            int(q.dtype == torch.bfloat16), softmax_scale(hd), int(block_q),
            int(block_kv), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out[..., :hdv].contiguous() if narrow else out


flash_attention.launches = 0


def bwd_smem_bytes(hd: int, kernel: int, dtype) -> int:
    """Dynamic shared memory of a backward block (``dq_smem_bytes`` and
    ``dkdv_smem_bytes`` in the source): two tiles of 16 rows a warp (Q and
    dO for dq, ``kernel`` 0; K and V for dkdv, 1) and two stages of two
    chunks (K and V; Q and dO), ``BWD_SHAPE``, in the inputs' dtype, each
    row the head tile (64 or 128) padded by 16 bytes; then f32 row
    statistics: D of the block's rows (dq), or lse and D of each stage's
    chunk (dkdv)."""
    hdt = 64 if hd <= 64 else 128
    warps, chunk = BWD_SHAPE[dtype][kernel]
    elem = 2 if dtype == torch.bfloat16 else 4
    tiles = elem * (hdt + 16 // elem) * (2 * 16 * warps + 4 * chunk)
    return tiles + 4 * (4 * chunk if kernel else 16 * warps)


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float]
        + [ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    if any(lib.flash_attention_bwd_smem_bytes(
            hd, kern, int(dt == torch.bfloat16)) != bwd_smem_bytes(hd, kern, dt)
           for hd in (40, 128) for kern in (0, 1) for dt in DTYPES):
        raise RuntimeError("csrc/flash_attention_bwd.cu and "
                           "flash_attention.py disagree on the shared-memory "
                           "layout")
    return lib


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        q_offset: int = 0, kv_valid_len=None):
    """Launch the backward: q, o and do ``[B, Sq, H, hd]``, k and v ``[B,
    Skv, KV, hd]``, all f32 or all bf16 on one card, ``o`` the forward's
    output and ``do`` its cotangent; returns ``(dq, dk, dv)`` in the
    inputs' shapes and dtype.  The forward's wider shapes, a v head of
    its own width or a q.k head past 128 (MLA's 192 / 128), raise
    ``NotImplementedError`` on any device: their backward kernel waits in
    ROADMAP's backward kernels list."""
    ts = (q, k, v, o, do)
    if v.shape[-1] != k.shape[-1] or k.shape[-1] > BWD_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention_bwd takes hd = hdv up to {BWD_MAX_HEAD_DIM}, "
            f"got q.k {k.shape[-1]} and v {v.shape[-1]}: the MLA backward "
            f"is not written yet (ROADMAP queue 1, 'Backward kernels')")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel needs a CUDA tensor, "
                         f"got {q.device}")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"inputs on {[str(t.device) for t in ts]}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"q, k, v, o, do must all be f32 or all bf16, got "
                         f"{[t.dtype for t in ts]}")
    check_shapes(q, k, v, same_width=True)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    B, Sq, H, hd = (int(s) for s in q.shape)
    Skv, KV = int(k.shape[1]), int(k.shape[2])
    if hd < 1:
        raise ValueError(f"flash_attention_bwd takes hd 1-"
                         f"{BWD_MAX_HEAD_DIM}, got {hd}")
    q, k, v, o, do = (t.contiguous() for t in ts)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    valid = Skv if kv_valid_len is None else min(max(int(kv_valid_len), 0),
                                                 Skv)
    stats = torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), B, Sq, Skv, H, KV, hd,
            int(bool(causal)), int(q_offset), valid,
            int(q.dtype == torch.bfloat16), softmax_scale(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
