"""Hand-written CUDA kernel for flash attention over an int8 KV cache,
its plain version, wrapper and registry declaration (counterpart of
``repro/kernels/flash_attention/int8.py``).

Replaces ``src/repro/kernels/flash_attention/int8.py::
flash_attention_int8`` (the Pallas TPU kernel).  K and V arrive as int8
with per-token K scales and per-channel V scales
(:func:`repro_torch.quant.quantize.quantize_kv`).  The kernel,
``csrc/flash_attention_int8.cu``, quantizes each q row inside the block
(absmax/127, round half to even), forms the score dot as an exact int8
``mma.sync``, dequantizes it as ``((float)s32 * (qs * scale)) * ks``,
runs the softmax in f32 and forms ``p @ vq`` as two f16 ``mma.sync``
products (p split into hi + lo; vq is exact in f16), multiplying by the
per-channel ``vs`` once at the end.

What bounds it on an H100: bytes in the decode regime (a short q block
against a long cache), where K and V cross device memory as int8.  What
the design does about it: the keys are split across blocks
(:func:`split_count`, from the problem and the card's SM count; not a
tunable), each split's partial (m, l, acc) goes to an f32 scratch and a
second kernel adds them in ascending split order; a block takes every q
head of one kv head, so K/V are read once per GQA group
(:func:`launch_shape`); K, V and the K scales are staged by ``cp.async``
into two shared-memory stages.

A row that sees no key (``kv_valid_len`` 0, or ``q_offset`` putting every
key in its future) gets the mean of V over the ``Skv`` keys, as the plain
version does.

:func:`flash_attention_int8` counts its launches in
``flash_attention_int8.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.flash_attention import ops as f32_ops
from repro_torch.kernels.flash_attention.flash_attention import (
    check_shapes, softmax_scale)
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask
from repro_torch.quant.quantize import _scale, quantize_kv

SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
          "flash_attention_int8.cu")
REPLACES = "src/repro/kernels/flash_attention/int8.py:111"

#: (rtol, atol) against the plain version.  The scores are equal bit for
#: bit (same quantization, an exact integer dot, the same two f32
#: roundings of the dequant); the softmax's sums differ in order, and p
#: enters ``p @ vq`` as f16 hi + lo (about 2^-22 of p), so the difference
#: is at f32 rounding level.  The reference's one-int8-step ``TOL`` of
#: 2e-2 would pass an all-zero output at the llama3.2-3b decode window
#: (outputs of about 0.02); 1e-5 still fails a kernel that drops a chunk.
TOL = (1e-5, 1e-5)
#: the reference's ladder (both tunables)
LADDER, DEFAULT_BLOCK = (16, 32, 64, 128, 256), 128
MAX_WARPS, MIN_WARPS = 6, 4    # warps a block
STAGES = 2                     # K/V chunks in flight (STAGES in the source)
XCHG_ROWS = 48                 # rows of partials key groups exchange, at most
MAX_HEAD_DIM = 128             # hd a multiple of 4 up to this
#: the split count: about BLOCKS_PER_SM blocks an SM (two of 6 warps fit
#: at once; more splits start a second round of blocks), at least
#: MIN_SPLIT_KEYS keys a split, at most MAX_SPLITS splits
BLOCKS_PER_SM, MIN_SPLIT_KEYS, MAX_SPLITS = 2, 256, 32


def head_pad(hd: int) -> int:
    """hd padded to the k of the int8 score ``mma`` (32); the columns past
    hd are zeros in the q rows."""
    return registry.round_up(hd, 32)


def smem_bytes(rows: int, block_kv: int, hd: int) -> int:
    """Dynamic shared memory of one block of ``rows`` (16 per row tile)
    rows (``smem_size`` in the source): the int8 q rows and their scales,
    and ``STAGES`` x {the int8 K rows, the int8 V rows, the K scales} of
    ``block_kv`` keys, each row padded to ``head_pad(hd) + 16`` bytes so
    that the 8 rows of an ``ldmatrix`` hit distinct banks; at least the
    ``XCHG_ROWS`` f32 rows (hd padded, plus m and l) through which key
    groups hand over their partials at the end."""
    rs = head_pad(hd) + 16
    return rows * (rs + 4) + max(STAGES * block_kv * (2 * rs + 4),
                                 XCHG_ROWS * (head_pad(hd) + 4) * 4)


def fits(hd: int, block_q: int, block_kv: int) -> bool:
    """Whether the kernel takes this tile at head dim ``hd``: hd a
    multiple of 4 up to 128, ``block_q`` and ``block_kv`` on the ladder,
    and the shared memory of a block of ``MAX_WARPS`` warps within 227 KB
    (every tile of the ladder, at every such hd: the rows of a q tile past
    ``MAX_WARPS`` tiles of 16 go to further blocks, :func:`launch_shape`)."""
    return (hd % 4 == 0 and 4 <= hd <= MAX_HEAD_DIM and block_q in LADDER
            and block_kv in LADDER
            and smem_bytes(16 * MAX_WARPS, block_kv, hd)
            <= registry.SMEM_PER_BLOCK)


def launch_shape(sq: int, h: int, kv: int, block_q: int) -> dict:
    """How a launch covers the rows: ``q_tiles`` tiles of ``block_q``
    query positions; a tile's rows are its positions before ``Sq`` times
    the ``h // kv`` heads of a GQA group, served by ``slices`` blocks of
    ``row_tiles`` tiles of 16 rows (at most 6).  A block has one warp per
    row tile, or, below ``MIN_WARPS`` tiles, ``key_groups`` warps per
    tile that take turns over its keys."""
    tile_rows = min(block_q, sq) * (h // kv)
    row_tiles = min(MAX_WARPS, -(-tile_rows // 16))
    key_groups = max(1, MIN_WARPS // row_tiles)
    return {"q_tiles": -(-sq // block_q), "row_tiles": row_tiles,
            "key_groups": key_groups, "warps": row_tiles * key_groups,
            "slices": -(-tile_rows // (16 * row_tiles))}


def split_count(b: int, sq: int, skv: int, h: int, kv: int, block_q: int,
                sms: int) -> int:
    """How many ways the keys are split: at most ``BLOCKS_PER_SM`` blocks
    an SM over ``sms`` SMs when the (q tile, slice, b, kv head) blocks
    alone are fewer than the SMs, each split at least ``MIN_SPLIT_KEYS``
    keys, at most ``MAX_SPLITS``; 1 otherwise."""
    shape = launch_shape(sq, h, kv, block_q)
    blocks = b * kv * shape["q_tiles"] * shape["slices"]
    if blocks >= sms:
        return 1
    return max(1, min(BLOCKS_PER_SM * sms // blocks, MAX_SPLITS,
                      skv // MIN_SPLIT_KEYS))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_int8_ref(q, kq, ks, vq, vs, *, causal=True,
                             q_offset=0, kv_valid_len=None):
    """int8-simulating naive-softmax version: the same quantization
    decisions as the kernel (q per row; K and V pre-quantized),
    materialized scores.  The int8 score dot is formed in float32, where
    it is exact: every partial sum is an integer of magnitude at most
    127 * 127 * hd, below 2**24 for hd <= 1,040."""
    B, Sq, H, hd = q.shape
    Skv, KV = kq.shape[1], kq.shape[2]
    group = H // KV
    scale = 1.0 / (hd ** 0.5)
    qf = q.to(torch.float32)
    qs = _scale(qf.abs().amax(dim=-1, keepdim=True))
    qq = torch.round(qf / qs).to(torch.int8)
    kqe = kq.repeat_interleave(group, dim=2)
    kse = ks.repeat_interleave(group, dim=2)
    vqe = vq.repeat_interleave(group, dim=2)
    vse = vs.repeat_interleave(group, dim=2)
    s32 = torch.einsum("bqhd,bkhd->bhqk", qq.to(torch.float32),
                       kqe.to(torch.float32))
    s = (s32 * (qs * scale).permute(0, 2, 1, 3)   # [B, H, Sq, 1]
         * kse.permute(0, 2, 3, 1))               # [B, H, 1, Skv]
    mask = attention_mask(Sq, Skv, causal=causal, q_offset=q_offset,
                          kv_valid_len=kv_valid_len, device=q.device)
    s = torch.where(mask[None, None], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    v = vqe.to(torch.float32) * vse                 # [B, Skv, H, hd]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention_int8")
    lib.flash_attention_int8.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.flash_attention_int8.restype = ctypes.c_int
    lib.flash_attention_int8_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_int8_smem_bytes.restype = ctypes.c_size_t
    if any(lib.flash_attention_int8_smem_bytes(rows, bkv, hd)
           != smem_bytes(rows, bkv, hd)
           for rows, bkv, hd in ((96, 64, 64), (64, 256, 36), (16, 16, 128))):
        raise RuntimeError("csrc/flash_attention_int8.cu and int8.py "
                           "disagree on the shared-memory layout")
    return lib


def flash_attention_int8(q, kq, ks, vq, vs, *, causal=True, q_offset=0,
                         kv_valid_len=None, block_q: int,
                         block_kv: int) -> torch.Tensor:
    """Launch the kernel: q ``[B, Sq, H, hd]`` f32, kq and vq ``[B, Skv,
    KV, hd]`` int8, ks ``[B, Skv, KV, 1]`` and vs ``[B, 1, KV, hd]`` f32,
    all on one card; returns ``[B, Sq, H, hd]`` f32.  The keys are split
    :func:`split_count` ways for this card."""
    arrays = (q, kq, ks, vq, vs)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8 kernel needs a CUDA tensor, "
                         f"got {q.device}")
    if any(a.device != q.device for a in arrays):
        raise ValueError("q, kq, ks, vq and vs must lie on one card")
    check_shapes(q, kq, vq, same_width=True)
    B, Sq, H, hd = (int(s) for s in q.shape)
    Skv, KV = int(kq.shape[1]), int(kq.shape[2])
    if (q.dtype, kq.dtype, ks.dtype, vq.dtype, vs.dtype) != (
            torch.float32, torch.int8, torch.float32, torch.int8,
            torch.float32) or tuple(ks.shape) != (B, Skv, KV, 1) or \
            tuple(vs.shape) != (B, 1, KV, hd):
        raise ValueError("need q f32, kq/vq int8, ks f32 [B, Skv, KV, 1] and "
                         "vs f32 [B, 1, KV, hd]")
    if not fits(hd, block_q, block_kv):
        raise ValueError(f"block_q={block_q}, block_kv={block_kv} does not "
                         f"fit hd={hd}")
    q, kq, ks, vq, vs = (a.contiguous() for a in arrays)
    out = torch.empty_like(q)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()
    valid = Skv if kv_valid_len is None else min(max(int(kv_valid_len), 0),
                                                 Skv)
    shape = launch_shape(Sq, H, KV, block_q)
    splits = split_count(B, Sq, Skv, H, KV, block_q, sm_count(q.device))
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((splits, B, Sq, H, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((splits, B, Sq, H, 2), dtype=torch.float32,
                              device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_int8(
            q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), B, Sq, Skv, H,
            KV, hd, int(bool(causal)), int(q_offset), valid,
            softmax_scale(hd), int(block_q), int(block_kv), int(splits),
            shape["slices"], shape["row_tiles"], shape["warps"], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_int8 launch failed: "
                           f"cudaError {err}")
    flash_attention_int8.launches += 1
    return out


flash_attention_int8.launches = 0


# ----------------------------------------------------------- KernelSpec ----
def inspect_call(q, kq, ks, vq, vs, *, causal=True, q_offset=0,
                 kv_valid_len=None) -> dict:
    B, Sq, H, hd = q.shape
    return {"b": int(B), "sq": int(Sq), "skv": int(kq.shape[1]),
            "h": int(H), "kv": int(kq.shape[2]), "hd": int(hd),
            "causal": bool(causal), "q_offset": int(q_offset),
            "kv_valid_len": None if kv_valid_len is None
            else int(kv_valid_len),
            "dtype": str(q.dtype).removeprefix("torch.")}


def _run(problem, arrays, params):
    return flash_attention_int8(*arrays, causal=problem["causal"],
                                q_offset=problem["q_offset"],
                                kv_valid_len=problem.get("kv_valid_len"),
                                block_q=params["block_q"],
                                block_kv=params["block_kv"])


def _ref(problem, arrays):
    return flash_attention_int8_ref(*arrays, causal=problem["causal"],
                                    q_offset=problem["q_offset"],
                                    kv_valid_len=problem.get("kv_valid_len"))


def _make(problem, generator, device):
    p = problem
    q, k, v = (torch.randn(shape, generator=generator).to(device)
               for shape in ((p["b"], p["sq"], p["h"], p["hd"]),
                             (p["b"], p["skv"], p["kv"], p["hd"]),
                             (p["b"], p["skv"], p["kv"], p["hd"])))
    kq, ks, vq, vs = quantize_kv(k, v)
    return (q, kq, ks, vq, vs)


def _fits(problem, params):
    """The port's design: int8 q rows, two stages of int8 K/V chunks and
    their K scales in shared memory (:func:`fits`)."""
    return fits(problem["hd"], params["block_q"], params["block_kv"])


def _supports(problem):
    return (problem["dtype"] == "float32"
            and problem["h"] % problem["kv"] == 0
            and fits(problem["hd"], LADDER[0], LADDER[0]))


SPEC = registry.register(registry.KernelSpec(
    name="flash_attention_int8", params=f32_ops.block_params(
        (DEFAULT_BLOCK, LADDER), (DEFAULT_BLOCK, LADDER)),
    kernel=flash_attention_int8, run_call=_run, ref_call=_ref,
    make_call=_make, cache_key=f32_ops.cache_key,
    candidates=lambda problem: f32_ops.candidates(SPEC, problem, _fits),
    fits=_fits, supports=_supports, tol=TOL, tier="int8",
    default_problems=(
        # the reference's: the decode regime the int8 KV path exists for
        {"b": 4, "sq": 32, "skv": 512, "h": 8, "kv": 2, "hd": 64,
         "causal": True, "q_offset": 480, "dtype": "float32"},
    )))


def flash_attention_int8_op(q, kq, ks, vq, vs, *, causal=True, q_offset=0,
                            kv_valid_len=None, block_q=None, block_kv=None):
    """Attention over a pre-quantized KV cache (layout of
    :func:`repro_torch.quant.quantize.quantize_kv`): the plain version on
    the CPU, the kernel on the card."""
    check_shapes(q, kq, vq, same_width=True)
    problem = inspect_call(q, kq, ks, vq, vs, causal=causal,
                           q_offset=q_offset, kv_valid_len=kv_valid_len)
    return registry.dispatch(SPEC, problem, (q, kq, ks, vq, vs), q.device,
                             overrides={"block_q": block_q,
                                        "block_kv": block_kv})
