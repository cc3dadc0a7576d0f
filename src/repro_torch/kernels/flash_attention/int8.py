"""Hand-written CUDA kernel for flash attention over an int8 KV cache,
its plain version, wrapper and registry declaration (counterpart of
``repro/kernels/flash_attention/int8.py``).

Replaces ``src/repro/kernels/flash_attention/int8.py::
flash_attention_int8`` (the Pallas TPU kernel).  K and V arrive as int8
with per-token K scales and per-channel V scales
(:func:`repro_torch.quant.quantize.quantize_kv`).  The kernel,
``csrc/flash_attention_int8.cu``, quantizes each q row inside the block
(absmax/127, round half to even), forms the score dot with ``__dp4a``,
dequantizes it as ``((float)s32 * (qs * scale)) * ks``, runs the softmax
in f32 and dequantizes V per channel before an f32 ``p @ v``.

What bounds it on an H100: bytes in the decode regime (a short q block
against a long cache), where K and V cross device memory as int8.  The
design reads K as int32 words of four int8 (one ``__dp4a`` each) and
dequantizes V once per chunk into shared memory.

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
    MAX_HEAD_DIM, check_shapes, softmax_scale)
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask
from repro_torch.quant.quantize import _scale, quantize_kv

SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
          "flash_attention_int8.cu")
REPLACES = "src/repro/kernels/flash_attention/int8.py:111"

#: (rtol, atol) against the plain version.  The scores are equal bit for
#: bit (same quantization, an exact integer dot, the same two f32
#: roundings of the dequant); the softmax's sums differ in order only, so
#: the difference is at f32 rounding level: at most 4.9e-7 on an H100 up
#: to the llama3.2-3b decode window (8,192 keys, outputs of about 0.02).
#: The reference's one-int8-step ``TOL`` of 2e-2 would pass an all-zero
#: output there; 1e-5 still fails a kernel that drops a chunk of keys.
TOL = (1e-5, 1e-5)
#: the reference's ladder (both tunables); the source instantiates every
#: block_q rung, and block_kv up to 256
LADDER, DEFAULT_BLOCK = (16, 32, 64, 128, 256), 128
MAX_BLOCK_KV = 256
MAX_ACC = 64               # f32 accumulators a thread may hold


def column_groups(hd: int) -> int:
    """Groups of 32 columns of hd each lane accumulates (1, 2 or 4)."""
    return 1 if hd <= 32 else 2 if hd <= 64 else 4


def smem_bytes(block_q: int, block_kv: int, hd: int) -> int:
    """Dynamic shared memory of one block: the int8 q rows and their
    scales, the int8 K chunk (rows padded by one word) and its token
    scales, the dequantized f32 V chunk, the p tile and m, l and the
    correction per row (``smem_words`` in the source)."""
    hd4 = hd // 4
    return 4 * (block_q * hd4 + block_q + block_kv * (hd4 + 1) + block_kv
                + block_kv * hd + block_q * block_kv + 3 * block_q)


def fits(hd: int, block_q: int, block_kv: int) -> bool:
    """Whether the kernel takes this tile at head dim ``hd``: hd a
    multiple of 4 (int32 words of K), an instantiated ``block_q``,
    ``block_kv`` up to 256, at most 64 register accumulators a thread
    (``block_q / 8`` rows x the column groups) and the shared memory
    within a block's 227 KB."""
    return (hd % 4 == 0 and block_q in LADDER
            and 1 <= block_kv <= MAX_BLOCK_KV and 1 <= hd <= MAX_HEAD_DIM
            and block_q // 8 * column_groups(hd) <= MAX_ACC
            and smem_bytes(block_q, block_kv, hd) <= registry.SMEM_PER_BLOCK)


def flash_attention_int8_ref(q, kq, ks, vq, vs, *, causal=True,
                             q_offset=0):
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
                          kv_valid_len=None, device=q.device)
    s = torch.where(mask[None, None], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    v = vqe.to(torch.float32) * vse                 # [B, Skv, H, hd]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention_int8")
    lib.flash_attention_int8.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_attention_int8.restype = ctypes.c_int
    lib.flash_attention_int8_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_int8_smem_bytes.restype = ctypes.c_size_t
    if lib.flash_attention_int8_smem_bytes(128, 64, 64) != \
            smem_bytes(128, 64, 64):
        raise RuntimeError("csrc/flash_attention_int8.cu and int8.py "
                           "disagree on the shared-memory layout")
    return lib


def flash_attention_int8(q, kq, ks, vq, vs, *, causal=True, q_offset=0,
                         block_q: int, block_kv: int) -> torch.Tensor:
    """Launch the kernel: q ``[B, Sq, H, hd]`` f32, kq and vq ``[B, Skv,
    KV, hd]`` int8, ks ``[B, Skv, KV, 1]`` and vs ``[B, 1, KV, hd]`` f32,
    all on one card; returns ``[B, Sq, H, hd]`` f32."""
    arrays = (q, kq, ks, vq, vs)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8 kernel needs a CUDA tensor, "
                         f"got {q.device}")
    if any(a.device != q.device for a in arrays):
        raise ValueError("q, kq, ks, vq and vs must lie on one card")
    check_shapes(q, kq, vq)
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
    if kq.data_ptr() % 4:
        raise ValueError("kq must be 4-byte aligned (it is read as words)")
    out = torch.empty_like(q)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_int8(
            q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KV, hd,
            int(bool(causal)), int(q_offset), softmax_scale(hd),
            int(block_q), int(block_kv), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_int8 launch failed: "
                           f"cudaError {err}")
    flash_attention_int8.launches += 1
    return out


flash_attention_int8.launches = 0


# ----------------------------------------------------------- KernelSpec ----
def inspect_call(q, kq, ks, vq, vs, *, causal=True, q_offset=0) -> dict:
    B, Sq, H, hd = q.shape
    return {"b": int(B), "sq": int(Sq), "skv": int(kq.shape[1]),
            "h": int(H), "kv": int(kq.shape[2]), "hd": int(hd),
            "causal": bool(causal), "q_offset": int(q_offset),
            "dtype": str(q.dtype).removeprefix("torch.")}


def _run(problem, arrays, params):
    return flash_attention_int8(*arrays, causal=problem["causal"],
                                q_offset=problem["q_offset"],
                                block_q=params["block_q"],
                                block_kv=params["block_kv"])


def _ref(problem, arrays):
    return flash_attention_int8_ref(*arrays, causal=problem["causal"],
                                    q_offset=problem["q_offset"])


def _make(problem, generator, device):
    p = problem
    q, k, v = (torch.randn(shape, generator=generator).to(device)
               for shape in ((p["b"], p["sq"], p["h"], p["hd"]),
                             (p["b"], p["skv"], p["kv"], p["hd"]),
                             (p["b"], p["skv"], p["kv"], p["hd"])))
    kq, ks, vq, vs = quantize_kv(k, v)
    return (q, kq, ks, vq, vs)


def _fits(problem, params):
    """The port's design: int8 q rows and K chunk, f32 dequantized V
    chunk, the p tile and per-row state in shared memory, plus the
    register accumulators."""
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
                            block_q=None, block_kv=None):
    """Attention over a pre-quantized KV cache (layout of
    :func:`repro_torch.quant.quantize.quantize_kv`): the plain version on
    the CPU, the kernel on the card."""
    check_shapes(q, kq, vq)
    problem = inspect_call(q, kq, ks, vq, vs, causal=causal,
                           q_offset=q_offset)
    return registry.dispatch(SPEC, problem, (q, kq, ks, vq, vs), q.device,
                             overrides={"block_q": block_q,
                                        "block_kv": block_kv})
