"""Hand-written CUDA kernel for flash attention (online softmax, GQA,
absolute-position causal mask), and its wrapper.

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention`` (the Pallas TPU kernel).  The kernel,
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
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:73"


def head_tile(hd: int) -> int:
    """hd rounded up to the head tile the source is built for (32, 64, 96
    or 128); the columns past hd are zeros in shared memory."""
    return round_up(hd, 32)


def smem_bytes(block_q: int, block_kv: int, hd: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of one block (``smem_size`` in the source):
    the f32 q tile (rows padded by 4 words), ``STAGES`` K and V chunks in
    the input dtype as they arrive (rows padded by 4 f32 words or 8 bf16
    halves, so a warp's fragment loads hit 32 distinct banks), and for f32
    inputs one chunk split into TF32 K hi, K lo, V hi and V lo."""
    hdt = head_tile(hd)
    if bf16:
        return 4 * block_q * (hdt + 4) + STAGES * 2 * block_kv * 2 * (hdt + 8)
    return (4 * block_q * (hdt + 4)
            + (STAGES * 2 + 4) * block_kv * 4 * (hdt + 4))


def fits(hd: int, block_q: int, block_kv: int, bf16: bool = False) -> bool:
    """Whether the kernel takes this tile at head dim ``hd``: a launched
    ``block_q`` and ``block_kv``, and its shared memory within a block's
    227 KB (at hd 128 in f32 only ``block_kv`` 32 fits)."""
    return (block_q in BLOCK_Q and block_kv in BLOCK_KV
            and 1 <= hd <= MAX_HEAD_DIM
            and smem_bytes(block_q, block_kv, hd, bf16) <= SMEM_PER_BLOCK)


def softmax_scale(hd: int) -> float:
    """The reference's ``1 / hd ** 0.5``, rounded to f32 as the kernel
    (and JAX's weak-typed multiply) uses it."""
    return float(np.float32(1.0 / (hd ** 0.5)))


def check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"need q [B, Sq, H, hd] and k, v [B, Skv, KV, hd],"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (batch, hd, H % KV)")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    if any(lib.flash_attention_smem_bytes(128, 64, hd, bf16)
           != smem_bytes(128, 64, hd, bool(bf16))
           for hd in (40, 128) for bf16 in (0, 1)):
        raise RuntimeError("csrc/flash_attention.cu and flash_attention.py "
                           "disagree on the shared-memory layout")
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len=None, block_q: int,
                    block_kv: int) -> torch.Tensor:
    """Launch the kernel: q ``[B, Sq, H, hd]``, k and v ``[B, Skv, KV,
    hd]``, all f32 or all bf16 on one card; returns ``[B, Sq, H, hd]`` of
    q's dtype."""
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
    Skv, KV = int(k.shape[1]), int(k.shape[2])
    if not fits(hd, block_q, block_kv, q.dtype == torch.bfloat16):
        raise ValueError(f"block_q={block_q}, block_kv={block_kv} does not "
                         f"fit hd={hd}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()
    valid = Skv if kv_valid_len is None else min(max(int(kv_valid_len), 0),
                                                 Skv)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KV, hd, int(bool(causal)), int(q_offset), valid,
            int(q.dtype == torch.bfloat16), softmax_scale(hd), int(block_q),
            int(block_kv), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
