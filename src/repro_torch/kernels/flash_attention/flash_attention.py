"""Hand-written CUDA kernels for flash attention (online softmax, GQA,
absolute-position causal mask), and their wrapper.

They replace ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention`` (the Pallas TPU kernel), widened past it: the q.k head
takes up to 256, and V may be narrower than q and K (MLA's 192-wide q.k
head over a 128-wide v head): past a q.k tile of 128 V has a head tile
(128) and a width of its own; up to 128 the wrapper pads a narrower V to
hd and cuts the output back.  Two sources, one design for each dtype,
both FlashAttention-2 on ``mma.sync`` with the running max, denominator
and accumulator in f32, and a two-stage ring of K/V chunks in shared
memory filled by 16-byte ``cp.async``:

- bf16, ``csrc/flash_attention_bf16.cu``.  What bounds it on an H100: the
  operations at a prefill, the bytes at a decode step.  Both products run
  as bf16 ``mma.sync`` m16n8k16: q and k are exact in bf16, so S is one
  product, scaled after it; P is split in registers into bf16 hi and lo
  (one bf16 P misses the output tolerance), so P @ V is two.  A problem of
  more than ``DECODE_ROWS`` rows a kv head (``Sq * H / KV``) runs the
  prefill kernel: ``block_q`` query rows of one (batch, head) a block, one
  warp per 16 rows, q's fragments in registers for the whole key loop,
  ``block_kv`` keys a chunk.  Up to ``DECODE_ROWS`` (a decode step) it
  runs the decode kernel: a block takes every q head of one kv head, so
  K/V are read once per GQA group, the keys split across blocks
  (:func:`split_count`, not a tunable) and within a block across its
  ``DECODE_WARPS`` warps, each warp's partial (m, l, acc) into f32
  scratch; a third kernel adds the partials in ascending order
  (deterministic, no atomics).
- f32, ``csrc/flash_attention.cu``.  What bounds it: the two products at
  prefill shapes, bytes for a decode window.  Both run on the tensor
  cores as 3xTF32 ``mma.sync`` (each operand split into two TF32 parts,
  three products), which keeps f32 accuracy and the 2e-5 tolerance.  Each
  chunk is split once by the whole block into a shared hi/lo buffer; the
  scaled q tile stays in shared memory.

In both, S stays in registers as mma accumulators, the online softmax
runs on them with quad shuffles, and P feeds ``P @ V`` from the same
registers; keys past the causal horizon of a block, or of a warp's 16
rows, are skipped when every row sees a key.  Keys past ``Skv`` are never
read, so a row that sees no key (``kv_valid_len = 0``) gets the mean of V
over the ``Skv`` keys, as the reference's oracle gives; the Pallas kernel
also averages its zero padding there.

The plain version is
:func:`repro_torch.kernels.flash_attention.ref.flash_attention_ref`;
:func:`flash_attention` counts its calls in ``flash_attention.launches``,
and each kernel's wrapper its launches (``KERNELS``).

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

BLOCK_Q = (64, 128)        # rows per block the sources launch: 4 or 8 warps
BLOCK_KV = (32, 64, 128)   # the chunk sizes the sources instantiate
STAGES = 2                 # K/V chunks in flight (STAGES in the sources)
MAX_HEAD_DIM = 256         # q and k
MAX_V_HEAD_DIM = 128       # v, at most hd
DTYPES = (torch.float32, torch.bfloat16)
SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
BF16_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_bf16.cu")
REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:73"
# the bf16 decode kernel: problems of at most DECODE_ROWS rows a kv head
# (Sq x H / KV, one m16 tile), DECODE_WARPS warps a block, each taking 16
# keys of every DECODE_BLOCK_KV-key chunk (the source's constants)
DECODE_ROWS, DECODE_WARPS, DECODE_BLOCK_KV = 16, 4, 64
# its split count: about BLOCKS_PER_SM blocks an SM (two of 4 warps fit
# beside each other at every head tile), at least MIN_SPLIT_KEYS keys a
# split, at most MAX_SPLITS splits
BLOCKS_PER_SM, MIN_SPLIT_KEYS, MAX_SPLITS = 2, 256, 32
LOG2E = 1.4426950408889634
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
    """hd rounded up to the q.k head tile the sources are built for (32,
    64, 96 or 128, then 160, 192 or 256); the columns past hd are zeros in
    shared memory."""
    if hd <= 128:
        return round_up(hd, 32)
    return next(t for t in (160, 192, MAX_HEAD_DIM) if hd <= t)


def v_tile(hd: int) -> int:
    """V's head tile beside q.k width ``hd`` (``v_tile`` in the sources):
    the q.k tile up to 128, then 128."""
    return min(head_tile(hd), MAX_V_HEAD_DIM)


def stages(hd: int) -> int:
    """K/V chunks in flight in the f32 kernel: ``STAGES``, or one for q.k
    tiles past 128 (the TF32 split already frees the raw stage once a
    chunk is split)."""
    return STAGES if head_tile(hd) <= 128 else 1


def smem_bytes(block_q: int, block_kv: int, hd: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of one block (``flash_attention_bf16_smem_
    bytes`` and ``flash_attention_smem_bytes`` in the sources).  bf16:
    ``STAGES`` K and V chunks, rows padded by 16 bytes so that the 8 rows
    of an ``ldmatrix`` hit distinct banks (V rows :func:`v_tile` wide);
    the block's q rows pass through the same memory first, so it is at
    least their tile.  f32: the q tile (rows padded by 4 words),
    :func:`stages` K and V chunks as they arrive and one chunk split into
    TF32 K hi, K lo, V hi and V lo."""
    hdt, hdvt = head_tile(hd), v_tile(hd)
    if bf16:
        return 2 * max(block_q * (hdt + 8),
                       STAGES * block_kv * (hdt + hdvt + 16))
    return 4 * (block_q * (hdt + 4)
                + (stages(hd) + 2) * block_kv * (hdt + hdvt + 8))


def decode_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of a bf16 decode block: one tile of
    ``DECODE_ROWS`` q rows, then ``STAGES`` K and V chunks of
    ``DECODE_BLOCK_KV`` keys, rows padded as in :func:`smem_bytes`."""
    hdt, hdvt = head_tile(hd), v_tile(hd)
    return 2 * (DECODE_ROWS * (hdt + 8)
                + STAGES * DECODE_BLOCK_KV * (hdt + hdvt + 16))


def fits(hd: int, block_q: int, block_kv: int, bf16: bool = False,
         hdv: int = None) -> bool:
    """Whether the kernels take this tile at q.k head dim ``hd`` and v
    head dim ``hdv`` (``hd`` when None): a launched ``block_q`` and
    ``block_kv``, ``hdv`` at most ``hd`` and within V's head tile, and the
    shared memory within a block's 227 KB (f32: at hd 128 only
    ``block_kv`` 32 fits; past 128 only ``block_q`` 64 with it; bf16:
    every tile)."""
    hdv = hd if hdv is None else hdv
    return (block_q in BLOCK_Q and block_kv in BLOCK_KV
            and 1 <= hd <= MAX_HEAD_DIM and 1 <= hdv <= min(hd, v_tile(hd))
            and smem_bytes(block_q, block_kv, hd, bf16) <= SMEM_PER_BLOCK)


def softmax_scale(hd: int) -> float:
    """The reference's ``1 / hd ** 0.5``, rounded to f32 as the kernels
    (and JAX's weak-typed multiply) use it."""
    return float(np.float32(1.0 / (hd ** 0.5)))


def exp2_scale(hd: int) -> float:
    """``softmax_scale(hd) * log2(e)`` in f32: the bf16 kernels scale the
    raw scores' differences by it inside ``exp2``."""
    return float(np.float32(softmax_scale(hd)) * np.float32(LOG2E))


def is_decode(sq: int, h: int, kv: int) -> bool:
    """Whether a bf16 problem runs the decode kernel: at most
    ``DECODE_ROWS`` rows a kv head, each kv head's ``Sq * H / KV`` rows in
    one m16 tile."""
    return sq * (h // kv) <= DECODE_ROWS


def visited_keys(sq: int, skv: int, causal: bool, q_offset: int,
                 valid: int) -> int:
    """The keys a decode block visits (``visited_end`` in the source): all
    ``skv`` unless every row sees a key, then up to ``valid`` and, causal,
    the last row's horizon."""
    if valid > 0 and (not causal or q_offset >= 0):
        end = min(skv, valid)
        return min(end, q_offset + sq) if causal else end
    return skv


def split_count(b: int, kv: int, keys: int, sms: int) -> int:
    """How many ways the decode kernel splits the keys: about
    ``BLOCKS_PER_SM`` blocks an SM over ``sms`` SMs for the ``b * kv``
    (batch, kv head) blocks, each split at least ``MIN_SPLIT_KEYS`` of the
    ``keys`` visited, at most ``MAX_SPLITS``; 1 where the blocks alone
    fill the SMs."""
    blocks = b * kv
    if blocks >= sms:
        return 1
    return max(1, min(BLOCKS_PER_SM * sms // blocks, MAX_SPLITS,
                      keys // MIN_SPLIT_KEYS))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    if any(lib.flash_attention_smem_bytes(128, 64, hd) != smem_bytes(128, 64,
                                                                     hd)
           for hd in (40, 128, 192, 256)):
        raise RuntimeError("csrc/flash_attention.cu and flash_attention.py "
                           "disagree on the shared-memory layout")
    return lib


@functools.lru_cache(maxsize=None)
def _bf16_lib():
    lib = _build.load("flash_attention_bf16")
    problem = [ctypes.c_int] * 10 + [ctypes.c_float]
    lib.flash_attention_bf16_prefill.argtypes = (
        [ctypes.c_void_p] * 4 + problem + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    lib.flash_attention_bf16_decode.argtypes = (
        [ctypes.c_void_p] * 5 + problem + [ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_bf16_combine.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.flash_attention_bf16_prefill,
               lib.flash_attention_bf16_decode,
               lib.flash_attention_bf16_combine):
        fn.restype = ctypes.c_int
    lib.flash_attention_bf16_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_bf16_smem_bytes.restype = ctypes.c_size_t
    lib.flash_attention_bf16_decode_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_attention_bf16_decode_smem_bytes.restype = ctypes.c_size_t
    layout = (ctypes.c_int * 4)()
    lib.flash_attention_bf16_layout(layout)
    if (tuple(layout) != (DECODE_ROWS, DECODE_WARPS, DECODE_BLOCK_KV, STAGES)
            or any(lib.flash_attention_bf16_smem_bytes(bq, bkv, hd)
                   != smem_bytes(bq, bkv, hd, True)
                   for bq in BLOCK_Q for bkv in BLOCK_KV
                   for hd in (40, 128, 192, 256))
            or any(lib.flash_attention_bf16_decode_smem_bytes(hd)
                   != decode_smem_bytes(hd) for hd in (40, 128, 192, 256))):
        raise RuntimeError("csrc/flash_attention_bf16.cu and "
                           "flash_attention.py disagree on the layout")
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _on_card(*ts: torch.Tensor) -> None:
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device
                                          for t in ts):
        raise ValueError(f"the flash_attention kernels need CUDA tensors on "
                         f"one card, got {[str(t.device) for t in ts]}")


def _problem(q, k, v, causal, q_offset, valid):
    """The leading C arguments both bf16 kernels share (hdv: v's width as
    the kernel sees it, after any padding)."""
    B, Sq, H, hd = (int(s) for s in q.shape)
    return (B, Sq, int(k.shape[1]), H, int(k.shape[2]), hd, int(v.shape[3]),
            int(bool(causal)), int(q_offset), int(valid), exp2_scale(hd))


def flash_attention_f32(q, k, v, out, *, causal, q_offset, valid, block_q,
                        block_kv):
    """Launch ``csrc/flash_attention.cu`` into ``out``: contiguous f32 q,
    k, v (v padded to hd up to a q.k tile of 128), ``valid`` clamped to
    [0, Skv]."""
    _on_card(q, k, v, out)
    B, Sq, H, hd = (int(s) for s in q.shape)
    with torch.cuda.device(q.device):
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            int(k.shape[1]), H, int(k.shape[2]), hd, int(v.shape[3]),
            int(bool(causal)), int(q_offset), int(valid), softmax_scale(hd),
            int(block_q), int(block_kv), _stream(q))
    _raise_on(err, "flash_attention")
    flash_attention_f32.launches += 1
    return out


def flash_attention_bf16_prefill(q, k, v, out, *, causal, q_offset, valid,
                                 block_q, block_kv):
    """Launch the bf16 prefill kernel into ``out``: contiguous bf16 q, k,
    v (v padded to hd up to a q.k tile of 128), ``valid`` clamped to [0,
    Skv]."""
    _on_card(q, k, v, out)
    with torch.cuda.device(q.device):
        err = _bf16_lib().flash_attention_bf16_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_problem(q, k, v, causal, q_offset, valid), int(block_q),
            int(block_kv), _stream(q))
    _raise_on(err, "flash_attention_bf16_prefill")
    flash_attention_bf16_prefill.launches += 1
    return out


def flash_attention_bf16_decode(q, k, v, *, causal, q_offset, valid,
                                splits):
    """Launch the bf16 decode kernel (at most ``DECODE_ROWS`` rows a kv
    head) over ``splits`` key ranges: returns the f32 partials,
    ``part_acc [splits * DECODE_WARPS, B * Sq * H, hdv]`` and ``part_ml
    [splits * DECODE_WARPS, B * Sq * H, 2]`` (each row's max of raw
    scores and its sum of ``exp2((s - m) * exp2_scale(hd))``), for
    :func:`flash_attention_bf16_combine`."""
    _on_card(q, k, v)
    B, Sq, H, _ = q.shape
    parts, rows = splits * DECODE_WARPS, B * Sq * H
    part_acc = torch.empty((parts, rows, v.shape[3]), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((parts, rows, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        err = _bf16_lib().flash_attention_bf16_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), *_problem(q, k, v, causal, q_offset, valid),
            int(splits), _stream(q))
    _raise_on(err, "flash_attention_bf16_decode")
    flash_attention_bf16_decode.launches += 1
    return part_acc, part_ml


def flash_attention_bf16_combine(part_acc, part_ml, out, hd):
    """Launch the combine kernel: each row of ``out`` (bf16, ``[..., hdv]``)
    from the decode kernel's partials, added in ascending order, at q.k
    width ``hd`` (the scale of the raw scores)."""
    _on_card(part_acc, part_ml, out)
    parts, rows, width = (int(s) for s in part_acc.shape)
    if (tuple(part_ml.shape) != (parts, rows, 2) or out.numel() != rows * width
            or out.dtype != torch.bfloat16 or not out.is_contiguous()):
        raise ValueError(f"partials {tuple(part_acc.shape)} and "
                         f"{tuple(part_ml.shape)} do not fill {out.dtype} "
                         f"{tuple(out.shape)}")
    with torch.cuda.device(out.device):
        err = _bf16_lib().flash_attention_bf16_combine(
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), rows,
            width, parts, exp2_scale(hd), _stream(out))
    _raise_on(err, "flash_attention_bf16_combine")
    flash_attention_bf16_combine.launches += 1
    return out


#: every kernel wrapper :func:`flash_attention` launches through, each
#: counting its own launches
KERNELS = (flash_attention_f32, flash_attention_bf16_prefill,
           flash_attention_bf16_decode, flash_attention_bf16_combine)
for _fn in KERNELS:
    _fn.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len=None, block_q: int,
                    block_kv: int) -> torch.Tensor:
    """Launch the kernels: q ``[B, Sq, H, hd]``, k ``[B, Skv, KV, hd]``
    and v ``[B, Skv, KV, hdv]``, all f32 or all bf16 on one card; returns
    ``[B, Sq, H, hdv]`` of q's dtype.  f32 runs ``csrc/flash_attention.cu``;
    bf16 the decode kernel and its combine at most ``DECODE_ROWS`` rows a
    kv head (``block_q`` and ``block_kv`` unused there), else the prefill
    kernel.  A shape or tile the kernels do not take raises."""
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
    bf16 = q.dtype == torch.bfloat16
    if not fits(hd, block_q, block_kv, bf16, hdv):
        raise ValueError(f"block_q={block_q}, block_kv={block_kv} does not "
                         f"fit hd={hd}, hdv={hdv}")
    # up to a q.k tile of 128 the kernels' V is as wide as K: a narrower
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
    kw = dict(causal=causal, q_offset=q_offset, valid=valid)
    tile = dict(block_q=block_q, block_kv=block_kv)
    if not bf16:
        flash_attention_f32(q, k, v, out, **kw, **tile)
    elif is_decode(Sq, H, KV):
        keys = visited_keys(Sq, Skv, causal, q_offset, valid)
        splits = split_count(B, KV, keys, sm_count(q.device))
        flash_attention_bf16_combine(
            *flash_attention_bf16_decode(q, k, v, **kw, splits=splits), out,
            hd)
    else:
        flash_attention_bf16_prefill(q, k, v, out, **kw, **tile)
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
