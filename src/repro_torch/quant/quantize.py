"""Per-channel int8 quantization math (counterpart of
``repro/quant/quantize.py``), shared by the ``fused_mlp_int8`` and
``flash_attention_int8`` CUDA kernels and their plain versions.

Every scale is constant over its dot's contraction dimension, so it
commutes out of the int32 accumulator exactly:

  * **weights** are quantized statically **per output channel** (column
    j of ``W[in, out]`` gets its own absmax/127 scale);
  * **activations** are quantized dynamically **per row** at serve time.

So ``h @ W ~= (hq @ wq) * hs[:, None] * ws[None, :]``: one int8 x int8 ->
int32 dot plus a rank-1 f32 dequant folded into the bias + activation
epilogue.

The numerics follow the reference op for op, and the CUDA kernel
follows them bit for bit:

  * rounding is half to even (``torch.round``; ``__float2int_rn`` in the
    kernel);
  * a zero row or column gets the scale ``1 / 127``, computed as a true
    division by a tensor.  A CUDA tensor divided by a Python number is
    computed as a multiply by its reciprocal, which differs in the last
    bit for some absmax values;
  * :func:`qdot` accumulates exactly: torch has no int8 product on CUDA,
    so the int8 operands are multiplied in float64, where every partial
    sum (at most 127 * 127 * K) is an integer below 2**53, and the sum
    is converted to int32.  float32 would be exact only up to K = 1,040.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.nn.layers import ACTS

#: symmetric int8: values land in [-127, 127] (x/absmax * 127)
QMAX = 127.0


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """``where(absmax > 0, absmax, 1) / 127``, a true division."""
    return (torch.where(absmax > 0, absmax, torch.ones_like(absmax))
            / absmax.new_tensor(QMAX))


def quantize_weights_per_channel(w, *, scale_mult: float = 1.0,
                                 device=None):
    """Static per-output-channel symmetric int8 quantization of ``w``
    ([in, out]) on ``device`` (None means CUDA).

    Returns ``(wq int8 [in, out], ws f32 [out])`` with ``w ~= wq * ws``.
    ``scale_mult`` deliberately mis-scales the calibration (the gate's
    fail drill); 1.0 is the correct absmax calibration.
    """
    w = torch.as_tensor(w).to(device=resolve_device(device),
                              dtype=torch.float32)
    ws = _scale(w.abs().amax(dim=0)) * float(scale_mult)
    wq = torch.clamp(torch.round(w / ws), -QMAX, QMAX).to(torch.int8)
    return wq, ws


def quantize_rows(h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization of ``h [rows, feat]``
    where it lies: returns ``(hq int8, hs f32 [rows, 1])``.  A zero row
    (serve-path padding) quantizes to zeros with scale 1/127."""
    hs = _scale(h.abs().amax(dim=1, keepdim=True))
    hq = torch.round(h / hs).to(torch.int8)
    return hq, hs


def quantize_kv(k, v):
    """int8 KV-cache quantization for the ``flash_attention_int8`` path,
    where ``k`` and ``v`` (``[B, Skv, KV, hd]``) lie.

    K is quantized **per token** (absmax over head_dim, the contraction
    axis of the score dot), V **per channel** (absmax over the tokens,
    the contraction axis of ``p @ v``); a zero token or channel gets the
    scale 1/127.  Returns ``(kq, ks [B, Skv, KV, 1], vq, vs [B, 1, KV,
    hd])``.
    """
    k = k.to(torch.float32)
    v = v.to(torch.float32)
    ks = _scale(k.abs().amax(dim=-1, keepdim=True))
    kq = torch.round(k / ks).to(torch.int8)
    vs = _scale(v.abs().amax(dim=1, keepdim=True))
    vq = torch.round(v / vs).to(torch.int8)
    return kq, ks, vq, vs


def quantize_params(weights: Sequence, biases: Sequence, *,
                    scale_mult: float = 1.0, device=None) -> List[tuple]:
    """Quantize a fused-MLP layer stack on ``device`` (None means CUDA):
    per layer ``(wq, ws, b_f32)``.  Biases stay f32."""
    dev = resolve_device(device)
    return [quantize_weights_per_channel(w, scale_mult=scale_mult,
                                         device=dev)
            + (torch.as_tensor(b).to(device=dev, dtype=torch.float32),)
            for w, b in zip(weights, biases)]


def int8_matmul(hq, wq):
    """The exact int32 sum ``hq @ wq`` of two int8 operands, formed in
    float64 (exact for any K this tier serves, on the CPU and the card)."""
    return (hq.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)


def qdot(hq, hs, wq, ws):
    """One dequantized int8 layer dot: the exact int32 sum of
    ``hq @ wq``, then the rank-1 (row scale x channel scale) dequant."""
    return int8_matmul(hq, wq).to(torch.float32) * hs * ws


def quant_mlp_ref(x, qlayers, acts):
    """int8-simulating fused-MLP forward: the plain version of the
    ``fused_mlp_int8`` kernel and the CPU path of the int8 tier.
    ``qlayers``: [(wq, ws, b), ...] on ``x``'s device."""
    h = x.to(torch.float32)
    for (wq, ws, b), act in zip(qlayers, acts):
        hq, hs = quantize_rows(h)
        h = ACTS[act](qdot(hq, hs, wq, ws) + b)
    return h.to(x.dtype)
