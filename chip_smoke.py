#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one H100 and check them.

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, builds every kernel of
the port from ``src/repro_torch/kernels/*/csrc/*.cu`` (one nvcc per
source, all started together), and prints one JSON line per phase:

1. ``device``  -- the card's name, the device count and its power limit;
2. ``build``   -- one line per kernel: nvcc's time and its register/
   shared-memory/spill report;
3. ``kernel``  -- fused_mlp and fused_mlp_int8 against their plain
   PyTorch versions at the minibude surrogate widths
   (6,1024,819,655,524,419,335,1) and at a gelu/tanh/silu/sigmoid net
   (fused_mlp also at a (6,4096,1500,1) net, past the 1,024 columns of
   its 16- and 32-row blocks), at batches 1, 37, 256 and 65,536, plus
   bit-identical rows across batch sizes, padding and every
   ``block_rows`` that fits; the int8 lines also count the elements that
   differ at all (none on a relu/identity net);
4. ``slice``   -- the minibude surrogate loop on the card, f32 tier:
   ``collect`` over 4,096 poses into a SurrogateDB, a bundle of seeded
   He-normal weights with normalization from the collected rows,
   ``infer`` over 65,536 poses through the InferenceEngine (the fused_mlp
   launch count must rise) held against the torch Sequential, and
   ``predicated`` with both predicates;
5. ``int8_slice`` -- the gated int8 serving tier, for minibude at full
   width, then bonds (4,512,512,2) and binomial (5,512,512,1): collect
   4,096 rows, a seeded bundle, ``calibration_rows``, a budget of 5% of
   the f32 output RMS on them, ``gate_bundle`` (must pass), the engine on
   tier ``int8`` and route ``fused_mlp_int8`` under the default
   ``REPRO_QUANT``, ``infer`` over 65,536 rows (must launch
   fused_mlp_int8 and not fused_mlp) held against the plain int8 path and
   within the budget of the f32 Sequential; then the fail drill
   (``scale_mult=64`` must fail the gate, and the engine must serve f32
   through fused_mlp);
6. ``timing``  -- CUDA-event times of each kernel, its plain version and
   a per-layer library chain (``torch.addmm`` + activation for fused_mlp,
   at each ``block_rows`` too; row quantization + ``torch._int_mm`` +
   dequant for fused_mlp_int8) at batches 256 and 65,536, beside the
   least time the card could take (for fused_mlp and flash_attention
   both the f32 CUDA-core bound, ``bound_ms``, and the 3xTF32
   tensor-core bound their products run at, ``bound_tc_ms``);
   then the tune path's kernels at their largest shapes (stencil_gather
   on a 4096x4096 grid, flash_attention on the llama3.2-3b 4,096-token
   causal prefill, flash_attention_int8 on its decode window of 32
   queries against 8,192 cached tokens), at the untuned tiles and at the
   winner of a sweep of that shape, beside the plain version and a
   library call (``torch.take``, ``scaled_dot_product_attention``);
   flash_attention_int8's line also gives ``bound_tc_ms`` (the int8
   score dot at the int8 peak plus the two f16 products of p.V at the
   f16 peak, or the bytes) with its shares, how the launch covers the
   window (q tiles, slices, warps, the key split count, blocks) at both
   tiles, its design, and the time of one decode step (Sq 1 over the
   same 8,192 keys: ``step_ms``, ``step_plain_ms``, ``step_bound_ms``,
   and its device time from a CUDA graph, ``step_graph_ms``, since a
   loop of such short calls is paced by the wrapper's host time; each
   field also at the swept tile, ``tuned_*``), and that step's device
   time over other launches (``step_graph_ms_by_launch``: ``block_kv``
   32/64/128 x 1, 2 or 4 warps sharing the block's one row tile x 8 to
   64 key splits);
   ``numerics`` -- fused_mlp's error over its tolerance at 65,536
   minibude rows for four seeds, beside the same source built with one
   TF32 product in place of three, and the TF32 ``mma.sync`` rate the
   card sustains (a probe kernel), the yardstick of the two 3xTF32
   kernels;
7. ``tune``/``tune_phase`` -- the deploy-time tuning path into a
   temporary cache directory: ``run_tune`` over the minibude bundle's
   buckets (64, 256, 1024) and every registered kernel's problems, one
   line per record (all must be ``exact``), a second
   ``autotune_registered`` that must launch nothing, and the engine
   serving the bundle at bucket 256 with the tuned ``block_rows``
   (provenance ``tuned``), rows equal to the default config's bit for
   bit;
8. ``lm_slice`` -- the RWKV6 LM's serving path at the full width of
   rwkv6-1.6b (24 layers, d_model 2,048, 32 heads of 64, d_ff 7,168,
   vocab 65,536, bf16, seeded random weights on the card): ``prefill``
   of 4 prompts of 2,048 tokens (exactly 24 rwkv6_chunk launches), the
   same prefill with the WKV recurrence computed by the plain version
   (the first layer's state bit for bit, logits and every layer's
   states within ``LM_TOL_BF16`` of the largest magnitude),
   ``serve_step`` on token 2,047 after a prefill of 2,047 tokens against
   the 2,048-token prefill's logits (the cache handoff), then
   ``launch.serve_lm.generate`` for 33 tokens (24 launches per decode
   step); the same comparisons on an f32 copy of the weights (within
   ``LM_TOL_F32``); host times and the kernel's times at the prefill
   shape and at T = 1;
9. the ``kernels`` line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

Before the slices, the ``kernel`` lines also hold stencil_gather (bit
for bit: every candidate tile of its default problem in f32 and bf16, a
grid no tile divides, 4096x4096), flash_attention (its tolerance: both
default problems, non-causal, GQA groups 1 and 3, ``kv_valid_len`` 0 and
150, ``q_offset``, bf16 inputs, the llama3.2-3b prefill) and
flash_attention_int8 (its default problem, the decode window, one decode
step, GQA groups 1 and 4, hd 4, 36 and 64, 8,191 keys non-causal,
``q_offset`` -16, ``kv_valid_len`` 0 and 5,000, all at the decode
window's size; a second launch bit-identical; the count of elements that
differ at all) and rwkv6_chunk (its default problem, T 1 and 33, head sizes 8, 16, 24, 64
and 128, bf16 inputs, the rwkv6-1.6b prefill shape; the final state bit
for bit) against their plain versions.  fused_mlp_int8's rows are held
bit-identical across every ``block_rows`` that fits;
rwkv6_chunk's timing lines also give its device time from a CUDA graph
(at T = 1 a loop of launches is paced by the host).

Launch counts are set to 0 just before each main path (the f32 slice's
region calls, each int8 slice's infer region, the ``run_tune`` call, the
LM's prefill and its generate loop) and read just after.  Any failure
raises, so the script exits non-zero and prints no result.  The bundle weights are random: nothing here measures
surrogate accuracy.
"""
import functools
import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BUDE_HIDDEN = (1024, 819, 655, 524, 419, 335)  # nas/space.py at n_hidden=6,
BUDE_WIDTHS = (6,) + BUDE_HIDDEN + (1,)         # hidden1=1024, mult=0.8
BUDE_ACTS = ("relu",) * 6 + ("identity",)
ACT_WIDTHS = (6, 512, 300, 130, 64, 1)
ACT_ACTS = ("gelu", "tanh", "silu", "sigmoid", "identity")
WIDE_WIDTHS = (6, 4096, 1500, 1)  # 1 to 8 rows a block, column passes
WIDE_ACTS = ("relu", "relu", "identity")
# fused_mlp's numerics: seeds of the weights and rows held to the
# tolerance at 65,536 rows, and the line of the shared header whose
# replacement by ONE_PASS_LO zeroes every lo part, leaving one TF32
# product (hi.hi) per f32 product
NUMERICS_SEEDS = (100, 101, 102, 103)
SPLIT_LO = "lo = tf32_rna(x - __uint_as_float(hi));"
ONE_PASS_LO = "lo = 0u;"
# each warp: 8 independent accumulators, `iters` rounds of 8 TF32 mma on
# random operands
MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "../../csrc/tf32x3.cuh"
__global__ void probe(float* out, const float* in, int iters) {
  const int tid = threadIdx.x;
  uint32_t a[4], b[8][2];
  for (int i = 0; i < 4; ++i) a[i] = tf32_rna(in[(tid * 4 + i) & 4095]);
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 2; ++i)
      b[j][i] = tf32_rna(in[(tid * 16 + 2 * j + i) & 4095]);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(d[j], a, b[j][0], b[j][1]);
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + tid] = s;
}
extern "C" int mma_probe(float* out, const float* in, int blocks,
                         int threads, int iters, void* stream) {
  probe<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, in, iters);
  return (int)cudaGetLastError();
}
// one mma per warp (block): d = c + a b with a [16][8], b [8][8] (k, n)
// and c, d [16][8], row-major, a and b already TF32
__global__ void once(const float* a, const float* b, const float* c,
                     float* d) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  a += blockIdx.x * 128; b += blockIdx.x * 64; c += blockIdx.x * 128;
  d += blockIdx.x * 128;
  const uint32_t af[4] = {__float_as_uint(a[g * 8 + t]),
                          __float_as_uint(a[(g + 8) * 8 + t]),
                          __float_as_uint(a[g * 8 + t + 4]),
                          __float_as_uint(a[(g + 8) * 8 + t + 4])};
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1],
                  c[(g + 8) * 8 + 2 * t], c[(g + 8) * 8 + 2 * t + 1]};
  mma_tf32(acc, af, __float_as_uint(b[t * 8 + g]),
           __float_as_uint(b[(t + 4) * 8 + g]));
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}
extern "C" int mma_once(const float* a, const float* b, const float* c,
                        float* d, int n, void* stream) {
  once<<<n, 32, 0, (cudaStream_t)stream>>>(a, b, c, d);
  return (int)cudaGetLastError();
}
"""
# models of one TF32 mma's f32 accumulation, d = c + sum_k a_k b_k (the
# products are exact): "rn", the exact sum rounded to nearest; "tG", the
# nine terms aligned to the largest one's exponent and truncated G bits
# past f32's 24, summed, then rounded toward zero to f32 (A100's tensor
# cores keep 3: Fasi et al., PeerJ Comput. Sci. 7:e330, 2021)
MMA_MODELS = ("rn", "t0", "t1", "t2", "t3", "t4")


def mma_model(c, prods, model):
    """One mma's outputs under ``model``: c [...] f64, prods [..., 8]."""
    import numpy as np
    terms = np.concatenate([c[..., None], prods], -1)
    if model == "rn":
        return terms.sum(-1).astype(np.float32)
    _, e = np.frexp(np.abs(terms).max(-1, keepdims=True))
    ulp = np.ldexp(1.0, e - 24 - int(model[1:]))
    s = (np.trunc(terms / ulp) * ulp).sum(-1)
    _, e = np.frexp(s)
    ulp = np.ldexp(1.0, e - 24)
    return (np.trunc(s / ulp) * ulp).astype(np.float32)
BATCHES = (1, 37, 256, 65536)
TIMED_BATCHES = (256, 65536)
COLLECT_POSES, INFER_POSES = 4096, 65536
# the int8 slices: app, its region's input name, the hidden widths of the
# widest surrogate its surrogate_space() allows
INT8_SLICES = (("minibude", "poses", BUDE_HIDDEN),
               ("bonds", "bonds", (512, 512)),
               ("binomial", "opts", (512, 512)))
GATE_BUDGET_REL = 0.05   # x the f32 output RMS (tests/test_quant.py:58-65)
# the tune path's kernels at their largest shapes: the stencil gather of
# the spec's default problem on a 4096x4096 grid, and the attention of
# the repo's llama3.2-3b config (src/repro/configs/archs.py:39-44: 24
# heads, 8 kv heads, head dim 128) as a 4096-token causal prefill and as
# a decode window of 32 queries against an 8,192-token cache
STENCIL_OFFSETS = ((0, 1), (2, 0), (1, 1), (0, 0), (1, 2))
STENCIL_BIG = 4096
LLAMA = {"h": 24, "kv": 8, "hd": 128}
PREFILL = dict(b=1, sq=4096, skv=4096, causal=True, q_offset=0, **LLAMA)
DECODE = dict(b=4, sq=32, skv=8192, causal=True, q_offset=8160, **LLAMA)
# bf16 outputs are the f32 results rounded once: two that agree to f32
# tolerance can round one bf16 ulp apart, 2**-7 of the value at most
BF16_RTOL = 2 ** -7
# flash_attention_int8's further cases beside its default problem and the
# decode window: (label, shape, extra keywords of the call)
FLASH8_CASES = [
    ("decode step (Sq 1)", dict(DECODE, sq=1, q_offset=8191), {}),
    ("group 1", dict(DECODE, h=8), {}),
    ("group 4, hd 64", dict(DECODE, h=32, hd=64), {}),
    ("hd 36", dict(DECODE, hd=36), {}),
    ("hd 4", dict(DECODE, hd=4), {}),
    ("Skv 8,191, non-causal", dict(DECODE, skv=8191, causal=False), {}),
    ("q_offset -16", dict(DECODE, q_offset=-16), {}),
    ("kv_valid_len 0", DECODE, {"kv_valid_len": 0}),
    ("kv_valid_len 5,000", DECODE, {"kv_valid_len": 5000}),
]
TUNE_BUCKETS = (64, 256, 1024)
# the LM slice: rwkv6-1.6b (src/repro/configs/archs.py:23-30) serving 4
# prompts of 2,048 tokens, then 33 generated tokens (32 decode steps); its
# WKV recurrence at the prefill shape (B 4, T 2,048, 32 heads of 64, f32)
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "rwkv6-1.6b", 4, 2048, 33
RWKV_PREFILL = {"b": LM_BATCH, "t": LM_PROMPT, "h": 32, "hd": 64,
                "dtype": "float32"}
# the LM against itself with the plain recurrence, each error against
# the largest magnitude of the compared tensor.  In bf16, 24 layers
# amplify the activations' rounding past the reference's 2e-2
# (tests/test_kernels.py:118-122): 5.8% of the largest logit on the
# H100, so 0.1.  On an f32 copy of the weights only the recurrence's own
# f32 rounding (about 1e-7 of its terms) is amplified: 1e-3
LM_TOL_F32, LM_TOL_BF16 = 1e-3, 0.1
PEAK_F32_FLOPS = 67e12   # H100 SXM f32 outside the tensor cores
# H100 SXM TF32 tensor cores, dense: the fused_mlp and flash_attention
# kernels form each f32 product as three TF32 products (3xTF32), so their
# tensor-core bound is 3 x the operations at this rate
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
PEAK_F16_FLOPS = 989e12  # H100 SXM f16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12
# what each redesigned kernel's timing line names
INT8_DESIGN = ("mma.sync m16n8k32 s8 (16-64 rows a block, 8 warps), "
               "weights by a TMA ring of k64 slabs refilled by the last "
               "warp out, quantized from the accumulators; dp4a at 1-8 "
               "rows")
FLASH8_DESIGN = ("keys split across blocks (split_count: about two blocks "
                 "an SM), partials combined in ascending split order by a "
                 "second kernel; a block takes every q head of one kv head "
                 "(up to 6 row tiles of 16; below 4 tiles, key groups of "
                 "warps share a tile); mma.sync m16n8k32 s8 scores, p.V as "
                 "two f16 m16n8k16 products (p hi + lo, vq exact), a fresh "
                 "partial per 32 keys; cp.async double-buffered int8 K/V")
RWKV_DESIGN = ("one block per (b, h), rows split across warps (row groups "
               "x head tile threads), cp.async double-buffered chunks, o "
               "reduced once per chunk")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def he_stack(widths, seed):
    """Seeded He-normal weights and small random biases, as numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.standard_normal(b) * 0.1).astype(np.float32)
          for b in widths[1:]]
    return ws, bs


def compare(got, want, rtol, atol):
    """(max abs error, worst error over its allowance); fails above 1.
    The tolerance is the kernel's declared ``SPEC.tol``, justified where
    it is declared (kernels/fused_mlp/ops.py)."""
    err = (got - want).abs()
    worst = (err / (atol + rtol * want.abs())).max().item()
    return err.max().item(), worst


def cuda_ms(fn, iters, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernel(name, widths, acts, dev):
    """fused_mlp against its plain version at every batch, and row
    bit-identity across batch sizes and block sizes."""
    import numpy as np
    import torch
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import (BLOCK_ROWS,
                                                         fits_smem, fused_mlp,
                                                         pack_mlp)
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref

    rtol, atol = ops.SPEC.tol
    ws, bs = he_stack(widths, seed=len(widths))
    packed = pack_mlp([torch.from_numpy(w) for w in ws],
                      [torch.from_numpy(b) for b in bs], acts, device=dev)
    rng = np.random.default_rng(1)
    x_all = torch.from_numpy(rng.standard_normal(
        (max(BATCHES), widths[0])).astype(np.float32)).to(dev)
    errs = {}
    for batch in BATCHES:
        x = x_all[:batch].contiguous()
        got = ops.fused_mlp_op(x, packed)
        want = fused_mlp_ref(x, packed.weights, packed.biases, acts)
        torch.cuda.synchronize()
        max_abs, worst = compare(got, want, rtol, atol)
        if not (worst <= 1.0 and torch.isfinite(got).all()):
            raise AssertionError(f"{name} batch {batch}: max abs error "
                                 f"{max_abs}, {worst}x the tolerance")
        errs[batch] = max_abs
    full = ops.fused_mlp_op(x_all, packed)
    x37 = x_all[:37].contiguous()
    alone = ops.fused_mlp_op(x37, packed)
    padded = ops.fused_mlp_op(
        torch.cat([x37, torch.zeros_like(x_all[:27])]), packed)[:37]
    tiles = [r for r in BLOCK_ROWS if fits_smem(widths, r)]
    block_rows = [fused_mlp(x37, packed, block_rows=r) for r in tiles]
    torch.cuda.synchronize()
    identical = (torch.equal(alone, padded) and torch.equal(alone, full[:37])
                 and all(torch.equal(alone, b) for b in block_rows))
    if not identical:
        raise AssertionError(f"{name}: rows differ across batch or block "
                             f"sizes")
    emit("kernel", kernel="fused_mlp", net=name, widths=list(widths),
         acts=list(acts),
         max_abs_err={str(b): e for b, e in errs.items()}, rtol=rtol,
         atol=atol, rows_bit_identical=identical, block_rows=tiles)
    return packed, errs


def check_kernel_int8(name, widths, acts, dev):
    """fused_mlp_int8 against its plain version (quant_mlp_ref) at every
    batch, the count of elements that differ at all, and row
    bit-identity across batch sizes, padding and block sizes."""
    import numpy as np
    import torch
    from repro_torch.kernels.fused_mlp import int8
    from repro_torch.quant.quantize import quant_mlp_ref, quantize_params

    rtol, atol = int8.SPEC.tol
    ws, bs = he_stack(widths, seed=len(widths))
    packed = int8.pack_int8_mlp(quantize_params(ws, bs, device=dev), acts)
    rng = np.random.default_rng(1)
    x_all = torch.from_numpy(rng.standard_normal(
        (max(BATCHES), widths[0])).astype(np.float32)).to(dev)
    errs, differ = {}, {}
    for batch in BATCHES:
        x = x_all[:batch].contiguous()
        got = int8.fused_mlp_int8_op(x, packed)
        want = quant_mlp_ref(x, packed.qlayers, acts)
        torch.cuda.synchronize()
        max_abs, worst = compare(got, want, rtol, atol)
        if not (worst <= 1.0 and torch.isfinite(got).all()):
            raise AssertionError(f"int8 {name} batch {batch}: max abs error "
                                 f"{max_abs}, {worst}x the tolerance")
        errs[batch] = max_abs
        differ[batch] = int((got != want).sum())
    full = int8.fused_mlp_int8_op(x_all, packed)
    x37 = x_all[:37].contiguous()
    alone = int8.fused_mlp_int8_op(x37, packed)
    padded = int8.fused_mlp_int8_op(
        torch.cat([x37, torch.zeros_like(x_all[:27])]), packed)[:37]
    launches = [r for r in int8.BLOCK_ROWS if int8.fits_smem(widths, r)]
    block_rows = [int8.fused_mlp_int8(x37, packed, block_rows=r)
                  for r in launches]
    torch.cuda.synchronize()
    identical = (torch.equal(alone, padded) and torch.equal(alone, full[:37])
                 and all(torch.equal(alone, b) for b in block_rows))
    if not identical:
        raise AssertionError(f"int8 {name}: rows differ across batch or "
                             f"block sizes")
    exact_acts = set(acts) <= {"relu", "identity"}
    if exact_acts and any(differ.values()):
        raise AssertionError(f"int8 {name}: a relu/identity net differs "
                             f"from its plain version in {differ} elements")
    emit("kernel", kernel="fused_mlp_int8", net=name, widths=list(widths),
         acts=list(acts), max_abs_err={str(b): e for b, e in errs.items()},
         elements_differing={str(b): n for b, n in differ.items()},
         bit_exact_expected=exact_acts, rtol=rtol, atol=atol,
         rows_bit_identical=identical, block_rows=launches)
    return packed, errs


def run_slice(dev, work):
    """collect -> bundle -> infer -> predicated, the minibude surrogate
    loop, through the port's entry points."""
    import numpy as np
    import torch
    from repro_torch.apps import minibude
    from repro_torch.core import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.nn import MLP, save_model

    def timed(call, **arrays):
        """A region call's result and its host seconds, ended by a sync."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(**arrays)["out"]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    registry.reset_counts()
    poses_c = minibude.make_inputs(COLLECT_POSES, seed=1, device=dev)
    collect = minibude.make_region(COLLECT_POSES, "collect",
                                   database=str(work / "db"), device=dev)
    seconds = {"collect": timed(collect, poses=poses_c)[1]}
    collect.db.flush()
    rows = collect.db.group("minibude").load()
    X, Y = rows["inputs"], rows["outputs"]
    stats = {"x_mu": X.mean(0).tolist(), "x_sd": (X.std(0) + 1e-6).tolist(),
             "y_mu": Y.mean(0).tolist(), "y_sd": (Y.std(0) + 1e-6).tolist()}
    net = MLP((1, 6), list(BUDE_HIDDEN), 1).init(seed=0)
    bundle = save_model(work / "bundle", net, extra=stats)

    poses = minibude.make_inputs(INFER_POSES, seed=2, device=dev)
    infer = minibude.make_region(INFER_POSES, "infer", model=bundle,
                                 device=dev)
    # the first call loads the bundle and packs its weights on the card
    y, seconds["infer_first"] = timed(infer, poses=poses)
    y, seconds["infer"] = timed(infer, poses=poses)
    pred = minibude.make_region(INFER_POSES, "predicated", model=bundle,
                                device=dev)
    y_true, seconds["predicated_true"] = timed(
        functools.partial(pred, predicate=True), poses=poses)
    y_false, seconds["predicated_false"] = timed(
        functools.partial(pred, predicate=False), poses=poses)
    launches = {s.name: s.launches for s in registry.all_specs()}

    eng = InferenceEngine.get(bundle, dev)
    if eng.route != "fused_mlp":
        raise AssertionError(f"engine routed the bundle to {eng.route}")
    if launches["fused_mlp"] < 1:
        raise AssertionError("the infer region did not launch fused_mlp")
    with torch.no_grad():
        xn = (poses - eng.norm[0]) / eng.norm[1]
        want = eng.net(xn) * eng.norm[3] + eng.norm[2]
    # the engine scales the net's output by y_sd: so does the tolerance
    rtol, atol = ops.SPEC.tol
    y_sd = float(np.max(stats["y_sd"]))
    max_abs, worst = compare(y, want, rtol, atol * y_sd)
    accurate = minibude.energies(poses)[:, None]
    checks = {
        "shape": tuple(y.shape) == (INFER_POSES, 1),
        "finite": bool(torch.isfinite(y).all()),
        "matches_sequential": worst <= 1.0,
        "predicated_true_is_infer": torch.equal(y_true, y),
        "predicated_false_is_accurate": torch.equal(y_false, accurate),
        "int8_not_launched": launches["fused_mlp_int8"] == 0,
        "collected_rows": X.shape == (COLLECT_POSES, 6)
        and Y.shape == (COLLECT_POSES, 1),
    }
    emit("slice", seconds=seconds, launches=launches,
         route=eng.route, max_abs_err_vs_sequential=max_abs,
         untrained_mape_pct=minibude.qoi_error(accurate, y), **checks)
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: {checks}")
    return launches


def run_int8_slice(app, key, hidden, dev, work):
    """collect -> bundle -> calibration rows -> gate -> int8 engine ->
    infer, then the gate's fail drill, for one app through the port's
    entry points.  Returns the infer region's fused_mlp_int8 launches."""
    import numpy as np
    import torch
    from repro_torch.core import InferenceEngine
    from repro_torch.core.engine import bundle_norm
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import int8
    from repro_torch.nn import MLP, load_model, save_model
    from repro_torch.quant.budgets import set_rmse_budget
    from repro_torch.quant.calibrate import calibration_rows
    from repro_torch.quant.gate import gate_bundle
    from repro_torch.quant.quantize import quant_mlp_ref

    mod = importlib.import_module(f"repro_torch.apps.{app}")
    work = work / app

    def timed(call, x):
        """A region call's result and its host seconds, ended by a sync."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(**{key: x})["out"]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    collect = mod.make_region(COLLECT_POSES, "collect",
                              database=str(work / "db"), device=dev)
    seconds = {"collect": timed(collect, mod.make_inputs(
        COLLECT_POSES, seed=1, device=dev))[1]}
    collect.db.flush()
    rows = collect.db.group(app).load()
    X, Y = rows["inputs"], rows["outputs"]
    stats = {"x_mu": X.mean(0).tolist(), "x_sd": (X.std(0) + 1e-6).tolist(),
             "y_mu": Y.mean(0).tolist(), "y_sd": (Y.std(0) + 1e-6).tolist()}
    widths = (X.shape[1],) + tuple(hidden) + (Y.shape[1],)
    net = MLP((1, widths[0]), list(hidden), widths[-1]).init(seed=0)
    bundle = save_model(work / "bundle", net, extra=stats)

    cal = calibration_rows(collect.db, app)
    net32, _, spec = load_model(bundle, dev)
    norm = bundle_norm(spec, net32, dev)
    with torch.no_grad():
        y_cal = net32((torch.from_numpy(cal).to(dev) - norm[0]) / norm[1])
        y_cal = y_cal * norm[3] + norm[2]
    budget = GATE_BUDGET_REL * float(torch.sqrt(torch.mean(y_cal ** 2)))
    set_rmse_budget(bundle, budget)
    t0 = time.perf_counter()
    gate = gate_bundle(bundle, cal, device=dev)
    seconds["gate"] = time.perf_counter() - t0

    x = mod.make_inputs(INFER_POSES, seed=2, device=dev)
    infer = mod.make_region(INFER_POSES, "infer", model=bundle, device=dev)
    registry.reset_counts()
    # the first call loads the bundle, quantizes and packs its weights
    y, seconds["infer_first"] = timed(infer, x)
    y, seconds["infer"] = timed(infer, x)
    launches = {s.name: s.launches for s in registry.all_specs()}

    eng = InferenceEngine.get(bundle, dev)
    with torch.no_grad():
        xn = (x - eng.norm[0]) / eng.norm[1]
        plain = (quant_mlp_ref(xn, eng._packed.qlayers, eng._packed.acts)
                 * eng.norm[3] + eng.norm[2])
        y32 = eng.net(xn) * eng.norm[3] + eng.norm[2]
    rtol, atol = int8.SPEC.tol
    y_sd = float(np.max(stats["y_sd"]))
    max_abs, worst = compare(y, plain, rtol, atol * y_sd)
    rmse_f32 = float(torch.sqrt(torch.mean((y - y32) ** 2)))
    checks = {
        "gate_passed": gate["exact"] is True,
        "tier_int8": eng.tier == "int8",
        "route_int8": eng.route == "fused_mlp_int8",
        "int8_launched": launches["fused_mlp_int8"] >= 1,
        "f32_not_launched": launches["fused_mlp"] == 0,
        "shape": tuple(y.shape) == (INFER_POSES, widths[-1]),
        "finite": bool(torch.isfinite(y).all()),
        "matches_plain_int8": worst <= 1.0,
        "rmse_vs_f32_within_budget": rmse_f32 <= budget,
    }

    fail = gate_bundle(bundle, cal, scale_mult=64.0, device=dev)
    registry.reset_counts()
    y_fail, seconds["drill_infer_first"] = timed(infer, x)
    drill = {s.name: s.launches for s in registry.all_specs()}
    eng = InferenceEngine.get(bundle, dev)
    checks.update({
        "drill_gate_failed": fail["exact"] is False,
        "drill_tier_f32": eng.tier == "f32",
        "drill_route_fused_mlp": eng.route == "fused_mlp",
        "drill_f32_launched": drill["fused_mlp"] >= 1,
        "drill_int8_not_launched": drill["fused_mlp_int8"] == 0,
        "drill_finite": bool(torch.isfinite(y_fail).all()),
    })
    emit("int8_slice", app=app, widths=list(widths), seconds=seconds,
         launches=launches, drill_launches=drill, tier="int8",
         route="fused_mlp_int8", gate_rmse=gate["rmse"], budget=budget,
         gate_rows=gate["rows"], drill_gate_rmse=fail["rmse"],
         rmse_vs_f32=rmse_f32, max_abs_err_vs_plain=max_abs,
         elements_differing_from_plain=int((y != plain).sum()), **checks)
    if not all(checks.values()):
        raise AssertionError(f"int8 slice {app} checks failed: {checks}")
    return launches["fused_mlp_int8"]


def tc_bound_ms(flops, nbytes):
    """The least time of a 3xTF32 kernel: three TF32 products per f32
    one at the tensor cores' rate, or the bytes, whichever is larger."""
    return max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3


def time_kernel(packed, acts, dev, smi):
    """Kernel (at the untuned block_rows and at each of the ladder's),
    plain version and per-layer cuBLAS chain at TIMED_BATCHES, beside the
    CUDA-core f32 bound and the 3xTF32 tensor-core bound."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import BLOCK_ROWS, fused_mlp
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.nn.layers import ACTS

    ws, bs = packed.weights, packed.biases
    widths = packed.widths
    flops_per_row = 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    n_params = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    rng = np.random.default_rng(3)
    timings = {}
    for batch in TIMED_BATCHES:
        x = torch.from_numpy(rng.standard_normal(
            (batch, widths[0])).astype(np.float32)).to(dev)
        iters = 200 if batch <= 4096 else 20
        block_rows = registry.resolve_params(
            ops.SPEC, ops.inspect_call(x, packed))["block_rows"]

        def kernel():
            return fused_mlp(x, packed, block_rows=block_rows)

        def plain():
            return fused_mlp_ref(x, ws, bs, acts)

        def library():
            h = x
            for w, b, a in zip(ws, bs, acts):
                h = ACTS[a](torch.addmm(b, h, w))
            return h

        ms = {k: cuda_ms(f, iters) for k, f in
              (("ms", kernel), ("plain_ms", plain), ("library_ms", library))}
        ms["ms_by_block_rows"] = {
            str(r): cuda_ms(lambda: fused_mlp(x, packed, block_rows=r), iters)
            for r in BLOCK_ROWS}
        flops = flops_per_row * batch
        nbytes = 4 * (batch * widths[0] + batch * widths[-1] + n_params)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_tc = tc_bound_ms(flops, nbytes)
        timings[batch] = dict(
            ms, bound_ms=bound_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            share_of_bound=bound_ms / ms["ms"], bound_tc_ms=bound_tc,
            bound_tc="3xTF32 on the tensor cores",
            tc_share_of_bound=bound_tc / ms["ms"], flops=flops,
            bytes=nbytes, block_rows=block_rows)
        emit("timing", kernel="fused_mlp", batch=batch,
             library="per-layer cuBLAS chain (torch.addmm + activation)",
             nvidia_smi=smi, **timings[batch])
    return timings


def start_probe_builds(work):
    """Start nvcc on the two numerics probes, each beside a copy of the
    shared header (SPLIT_LO replaced by ONE_PASS_LO) so that its relative
    include resolves: fused_mlp.cu as it is, which then forms one TF32
    product per f32 product, and MMA_PROBE.  Returns {name: (process,
    library path)}."""
    from repro_torch.kernels import _build
    header = _build.KERNELS_DIR / "csrc" / "tf32x3.cuh"
    one_pass = header.read_text()
    if one_pass.count(SPLIT_LO) != 1:
        raise AssertionError(f"{header.name}: {SPLIT_LO!r} not found once")
    csrc = work / "probe" / "fused_mlp" / "csrc"
    csrc.mkdir(parents=True)
    (work / "probe" / "csrc").mkdir()
    (work / "probe" / "csrc" / header.name).write_text(
        one_pass.replace(SPLIT_LO, ONE_PASS_LO))
    text = _build.sources()["fused_mlp"].read_text()
    jobs = {}
    for name, source in (("fused_mlp_1xtf32", text), ("mma_probe", MMA_PROBE)):
        src, so = csrc / f"{name}.cu", csrc / f"{name}.so"
        src.write_text(source)
        jobs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return jobs


def finish_probe_builds(jobs, t0):
    """Wait for the probes' nvcc (started at ``t0``) and load them."""
    import ctypes
    libs = {}
    for name, (proc, so) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        emit("build", probe=name, seconds_since_start=time.perf_counter() - t0,
             ptxas=[line.strip() for line in report.splitlines()
                    if "registers" in line or "spill" in line])
        libs[name] = ctypes.CDLL(str(so))
    return libs


def check_numerics(dev, libs, smi):
    """fused_mlp at 65,536 minibude rows for each of NUMERICS_SEEDS: the
    largest error and the worst error over its allowance (fails above
    1), beside the same kernel with one TF32 product per f32 product;
    then the TF32 mma.sync rate of the probe at 8 and 16 warps an SM."""
    import ctypes
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.kernels.fused_mlp import fused_mlp as fm
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref

    rtol, atol = ops.SPEC.tol
    one_pass = fm.bind(libs["fused_mlp_1xtf32"])
    seeds = {}
    for seed in NUMERICS_SEEDS:
        ws, bs = he_stack(BUDE_WIDTHS, seed)
        packed = fm.pack_mlp([torch.from_numpy(w) for w in ws],
                             [torch.from_numpy(b) for b in bs], BUDE_ACTS,
                             device=dev)
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (INFER_POSES, BUDE_WIDTHS[0])).astype(np.float32)).to(dev)
        want = fused_mlp_ref(x, packed.weights, packed.biases, BUDE_ACTS)
        got = fm.fused_mlp(x, packed, block_rows=ops.DEFAULT_BLOCK_ROWS)
        with mock.patch.object(fm, "_lib", lambda: one_pass):
            got1 = fm.fused_mlp(x, packed, block_rows=ops.DEFAULT_BLOCK_ROWS)
        torch.cuda.synchronize()
        (err, worst), (err1, worst1) = (compare(got, want, rtol, atol),
                                        compare(got1, want, rtol, atol))
        seeds[seed] = dict(max_abs_err=err, worst_over_tol=worst,
                           max_abs_y=want.abs().max().item(),
                           mean_signed_err=(got - want).mean().item(),
                           one_tf32_max_abs_err=err1,
                           one_tf32_worst_over_tol=worst1)
        if not (worst <= 1.0 and torch.isfinite(got).all()):
            raise AssertionError(f"fused_mlp seed {seed}: max abs error "
                                 f"{err}, {worst}x the tolerance")
    emit("numerics", kernel="fused_mlp", rows=INFER_POSES, rtol=rtol,
         atol=atol, block_rows=ops.DEFAULT_BLOCK_ROWS, seeds=seeds,
         worst_over_tol=max(v["worst_over_tol"] for v in seeds.values()))

    lib = libs["mma_probe"]
    lib.mma_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(2 * sms * 256, device=dev)
    rnd = torch.randn(4096, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters, rates = 4096, {}
    for warps in (8, 16):
        blocks = sms * warps // 8

        def run():
            err = lib.mma_probe(out.data_ptr(), rnd.data_ptr(), blocks, 256,
                                iters, stream)
            if err:
                raise RuntimeError(f"mma probe launch failed: {err}")
        ms = cuda_ms(run, 5)
        mma = blocks * 8 * iters * 8
        rates[warps] = {"ms": ms, "tflops": mma * 2 * 16 * 8 * 8 / ms / 1e9}
    emit("numerics", probe="mma.sync.m16n8k8 tf32, random operands",
         by_warps_per_sm=rates, peak_tflops=PEAK_TF32_FLOPS / 1e12,
         share_of_peak=max(r["tflops"] for r in rates.values())
         / (PEAK_TF32_FLOPS / 1e12), nvidia_smi=smi)

    # how one mma accumulates: 256 warps of random TF32 a and b (scales
    # 2^-6 .. 2^6) and f32 c (2^-4 .. 2^4), within the range where the
    # f64 sums of the models are exact; the share of the 32,768 outputs
    # each model of MMA_MODELS gives bit for bit
    lib.mma_once.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                     ctypes.c_void_p]
    rng = np.random.default_rng(5)
    n = 256

    def tf32(v):
        u = v.astype(np.float32).view(np.uint32)
        u = ((u & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000 | (u & 0x80000000)
        return u.astype(np.uint32).view(np.float32)

    def draw(shape, spread):
        return (rng.standard_normal(shape)
                * np.exp2(rng.integers(-spread, spread + 1, shape)))
    a, b = tf32(draw((n, 16, 8), 6)), tf32(draw((n, 8, 8), 6))
    c = draw((n, 16, 8), 4).astype(np.float32)
    d = torch.empty((n, 16, 8), device=dev)
    ta, tb, tc = (torch.from_numpy(v).to(dev) for v in (a, b, c))
    if lib.mma_once(ta.data_ptr(), tb.data_ptr(), tc.data_ptr(),
                    d.data_ptr(), n, stream):
        raise RuntimeError("mma_once launch failed")
    got = d.cpu().numpy()
    prods = (a.astype(np.float64)[:, :, None, :]
             * np.swapaxes(b, 1, 2).astype(np.float64)[:, None, :, :])
    match = {m: float((mma_model(c.astype(np.float64), prods, m)
                       == got).mean()) for m in MMA_MODELS}
    emit("numerics", probe="one mma.sync.m16n8k8 tf32 against models of "
         "its accumulation", outputs=int(got.size), share_bit_equal=match)


def int8_library_chain(packed, x):
    """The per-layer library chain computing what fused_mlp_int8 computes
    on a relu/identity net: row quantization, ``torch._int_mm`` (cuBLASLt
    int8, K and N zero-padded to multiples of 8, as it requires) and the
    dequant epilogue.  Returns ``(chain, None)``, or ``(None, error
    text)`` when ``torch._int_mm`` refuses the shapes.  The port never
    calls it: it is the timing yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.registry import round_up
    from repro_torch.nn.layers import ACTS
    from repro_torch.quant.quantize import quantize_rows

    layers = []
    for wq, ws, b in packed.qlayers:
        k, n = wq.shape
        w = torch.zeros((round_up(k, 8), round_up(n, 8)), dtype=torch.int8,
                        device=x.device)
        w[:k, :n] = wq
        s = torch.zeros(w.shape[1], device=x.device)
        bb = torch.zeros(w.shape[1], device=x.device)
        s[:n], bb[:n] = ws, b
        layers.append((w, s, bb))
    pad0 = round_up(packed.widths[0], 8) - packed.widths[0]

    def chain():
        h = F.pad(x, (0, pad0))
        for (w, s, bb), a in zip(layers, packed.acts):
            hq, hs = quantize_rows(h)
            h = ACTS[a](torch._int_mm(hq, w).to(torch.float32) * hs * s + bb)
        return h[:, :packed.widths[-1]]

    try:
        chain()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e)
    return chain, None


def time_int8(packed, dev, smi):
    """fused_mlp_int8, its plain version and the library chain at
    TIMED_BATCHES, beside the bound: int8 multiply-adds at the int8 peak
    (and the f32 quantize/dequant element work at the f32 peak, the larger
    of the two), or the bytes moved at the HBM rate."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import int8
    from repro_torch.quant.quantize import quant_mlp_ref

    widths = packed.widths
    n_weights = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    # per row: |h|, max, divide and round on every layer input; convert,
    # two multiplies, an add and the activation on every layer output
    f32_per_row = 4 * sum(widths[:-1]) + 5 * sum(widths[1:])
    rng = np.random.default_rng(3)
    timings = {}
    for batch in TIMED_BATCHES:
        x = torch.from_numpy(rng.standard_normal(
            (batch, widths[0])).astype(np.float32)).to(dev)
        iters = 200 if batch <= 4096 else 20
        block_rows = registry.resolve_params(
            int8.SPEC, int8.inspect_call(x, packed))["block_rows"]

        def kernel(rows=block_rows):
            return int8.fused_mlp_int8(x, packed, block_rows=rows)

        def plain():
            return quant_mlp_ref(x, packed.qlayers, packed.acts)

        library, library_error = int8_library_chain(packed, x)
        ms = {"ms": cuda_ms(kernel, iters), "plain_ms": cuda_ms(plain, iters),
              "library_ms": cuda_ms(library, iters) if library else None}
        library_agrees = None
        if library is not None:
            library_agrees = bool(torch.equal(library(), plain()))
        # every mma-path block size that fits, and the rows path at 8
        by_rows = {r: cuda_ms(functools.partial(kernel, r), iters)
                   for r in int8.MMA_BLOCK_ROWS + (8,)
                   if int8.fits_smem(widths, r)}
        ops = 2 * n_weights * batch
        f32_ops = f32_per_row * batch
        nbytes = (4 * batch * (widths[0] + widths[-1]) + n_weights
                  + 4 * 2 * sum(widths[1:]))
        t_ops = max(ops / PEAK_INT8_OPS, f32_ops / PEAK_F32_FLOPS)
        t_bytes = nbytes / PEAK_HBM_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        timings[batch] = dict(
            ms, bound_ms=bound_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            share_of_bound=bound_ms / ms["ms"], int8_ops=ops,
            f32_ops=f32_ops, bytes=nbytes, block_rows=block_rows,
            launch=int8.launch_shape(widths, batch, block_rows),
            ms_by_block_rows=by_rows)
        emit("timing", kernel="fused_mlp_int8", batch=batch,
             design=INT8_DESIGN,
             library="per-layer torch quantization + torch._int_mm + "
                     "dequant", library_error=library_error,
             library_equals_plain=library_agrees, nvidia_smi=smi,
             **timings[batch])
    return timings


def attention_inputs(shape, dev, seed, dtype=None):
    """Seeded q [B, Sq, H, hd] and k, v [B, Skv, KV, hd] on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dtype = dtype or torch.float32

    def t(*dims):
        return torch.randn(dims, generator=g).to(device=dev, dtype=dtype)
    return (t(shape["b"], shape["sq"], shape["h"], shape["hd"]),
            t(shape["b"], shape["skv"], shape["kv"], shape["hd"]),
            t(shape["b"], shape["skv"], shape["kv"], shape["hd"]))


def check_stencil(dev):
    """stencil_gather against its plain version, bit for bit: the spec's
    default problem with every candidate tile, in f32 and bf16, a grid
    no tile divides, and the 4096x4096 grid."""
    import torch
    from repro_torch.kernels.stencil_gather import ops
    from repro_torch.kernels.stencil_gather.ref import stencil_gather_ref
    from repro_torch.kernels.stencil_gather.stencil_gather import (
        stencil_gather)

    g = torch.Generator().manual_seed(11)
    default = ops.SPEC.default_problems[0]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((default["h"], default["w"]), generator=g).to(
            dev, dtype)
        for params in ops.SPEC.candidates(default):
            cases.append((f"default {str(dtype)[6:]} {params['block_h']}x"
                          f"{params['block_w']}", x, default["offsets"],
                          default["out_h"], default["out_w"],
                          default["origin"], params))
    ragged = torch.randn((1003, 781), generator=g).to(dev)
    cases.append(("ragged 1003x781", ragged, STENCIL_OFFSETS, 999, 777,
                  (1, 1), ops.SPEC.defaults()))
    big = torch.randn((STENCIL_BIG, STENCIL_BIG), generator=g).to(dev)
    cases.append((f"{STENCIL_BIG}x{STENCIL_BIG}", big, STENCIL_OFFSETS,
                  STENCIL_BIG - 4, STENCIL_BIG - 4, (1, 1),
                  ops.SPEC.defaults()))
    results = {}
    for label, x, offs, oh, ow, origin, params in cases:
        got = stencil_gather(x, offs, oh, ow, origin=origin, **params)
        want = stencil_gather_ref(x, offs, oh, ow, origin=origin)
        torch.cuda.synchronize()
        results[label] = bool(torch.equal(got, want))
    if not all(results.values()):
        raise AssertionError(f"stencil_gather differs from its plain "
                             f"version: {results}")
    emit("kernel", kernel="stencil_gather", bit_exact=results, max_abs_err=0.0)
    return 0.0


def check_flash(dev):
    """flash_attention (through its op) against its plain version at the
    spec's tolerance (bf16 outputs one bf16 ulp): both default problems,
    non-causal, GQA groups 1 and 3, kv_valid_len including 0, bf16
    inputs and the llama3.2-3b prefill."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rtol, atol = ops.TOL
    d0, d1 = ops.SPEC.default_problems
    small = dict(b=2, sq=200, skv=333, h=8, kv=2, hd=64)
    cases = [
        ("default prefill", d0, {}, None),
        ("default decode", d1, {}, None),
        ("non-causal", small, {"causal": False}, None),
        ("group 1", dict(small, h=4, kv=4), {}, None),
        ("group 3, hd 96", dict(small, h=6, kv=2, hd=96), {}, None),
        ("kv_valid_len 0", small, {"kv_valid_len": 0}, None),
        ("kv_valid_len 0, non-causal", small,
         {"kv_valid_len": 0, "causal": False}, None),
        ("kv_valid_len 150", small, {"kv_valid_len": 150}, None),
        ("q_offset 133", dict(small, sq=200), {"q_offset": 133}, None),
        ("bf16", d0, {}, torch.bfloat16),
        ("llama3.2-3b prefill 4096", PREFILL, {}, None),
    ]
    errs = {}
    for i, (label, shape, kw, dtype) in enumerate(cases):
        kw = dict({"causal": shape.get("causal", True),
                   "q_offset": shape.get("q_offset", 0)}, **kw)
        q, k, v = attention_inputs(shape, dev, seed=20 + i, dtype=dtype)
        got = ops.flash_attention_op(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        r = BF16_RTOL if dtype is torch.bfloat16 else rtol
        max_abs, worst = compare(got.float(), want.float(), r, atol)
        if not (worst <= 1.0 and torch.isfinite(got).all()
                and got.dtype == q.dtype):
            raise AssertionError(f"flash_attention {label}: max abs error "
                                 f"{max_abs}, {worst}x the tolerance")
        errs[label] = max_abs
    emit("kernel", kernel="flash_attention", max_abs_err=errs, rtol=rtol,
         atol=atol, bf16_rtol=BF16_RTOL)
    return errs["llama3.2-3b prefill 4096"]


def check_flash8(dev):
    """flash_attention_int8 (through its op) against its plain version
    at the spec's tolerance, with the count of elements that differ at
    all: its default problem, the llama3.2-3b decode window and one decode
    step, and that window with GQA groups 1 and 4, hd 4, 36 and 64, 8,191
    keys (no split or chunk divides them), non-causal, ``q_offset`` < 0
    (rows that see no key) and ``kv_valid_len`` 0 and 5,000."""
    import torch
    from repro_torch.kernels.flash_attention import int8
    from repro_torch.quant.quantize import quantize_kv

    rtol, atol = int8.TOL
    cases = [("default decode", int8.SPEC.default_problems[0], {}),
             ("llama3.2-3b decode window", DECODE, {})] + FLASH8_CASES
    errs, differ = {}, {}
    for i, (label, shape, extra) in enumerate(cases):
        q, k, v = attention_inputs(shape, dev, seed=40 + i)
        arrays = (q,) + quantize_kv(k, v)
        kw = dict({"causal": shape["causal"],
                   "q_offset": shape["q_offset"]}, **extra)
        got = int8.flash_attention_int8_op(*arrays, **kw)
        again = int8.flash_attention_int8_op(*arrays, **kw)
        want = int8.flash_attention_int8_ref(*arrays, **kw)
        torch.cuda.synchronize()
        max_abs, worst = compare(got, want, rtol, atol)
        if not (worst <= 1.0 and torch.isfinite(got).all()
                and torch.equal(got, again)):
            raise AssertionError(f"flash_attention_int8 {label}: max abs "
                                 f"error {max_abs}, {worst}x the tolerance, "
                                 f"repeat equal {torch.equal(got, again)}")
        errs[label], differ[label] = max_abs, int((got != want).sum())
    emit("kernel", kernel="flash_attention_int8", max_abs_err=errs,
         elements_differing=differ, repeat_bit_identical=True, rtol=rtol,
         atol=atol)
    return errs["llama3.2-3b decode window"]


def stencil_cell(dev):
    """The stencil gather of the spec's five offsets over a 4096x4096
    grid; bound by bytes (the grid read once, F times its size written)."""
    import torch
    from repro_torch.kernels.stencil_gather import ops
    from repro_torch.kernels.stencil_gather.ref import stencil_gather_ref

    n, m, f = STENCIL_BIG, STENCIL_BIG - 4, len(STENCIL_OFFSETS)
    x = torch.randn((n, n), generator=torch.Generator().manual_seed(5)).to(
        dev)
    offs = torch.tensor([(1 + dy) * n + 1 + dx for dy, dx in STENCIL_OFFSETS],
                        device=dev)
    index = (torch.arange(m, device=dev)[:, None, None] * n
             + torch.arange(m, device=dev)[None, :, None] + offs)
    nbytes = 4 * (n * n + m * m * f)
    return dict(
        spec=ops.SPEC, arrays=(x,), iters=20,
        problem=ops.inspect_call(x, offsets=STENCIL_OFFSETS, out_h=m,
                                 out_w=m, origin=(1, 1)),
        plain=lambda: stencil_gather_ref(x, STENCIL_OFFSETS, m, m,
                                         origin=(1, 1)),
        library=lambda: torch.take(x, index),
        library_call="torch.take with a precomputed [out_h, out_w, F] index",
        bound_ms=nbytes / PEAK_HBM_BYTES * 1e3, bound_by="bytes",
        bytes=nbytes)


def prefill_cell(dev):
    """The llama3.2-3b causal prefill of 4,096 tokens; bound by f32
    operations (4 * hd per visible query-key pair) on the CUDA cores, and
    by 3x those at the TF32 rate on the tensor cores (3xTF32)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = attention_inputs(PREFILL, dev, seed=6)
    group = PREFILL["h"] // PREFILL["kv"]
    # [B, H, S, hd], K/V repeated per group, all outside the timed call
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    s = PREFILL["sq"]
    flops = 4 * PREFILL["hd"] * s * (s + 1) // 2 * PREFILL["b"] * PREFILL["h"]
    nbytes = 4 * 2 * (q.numel() + k.numel())
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return dict(
        spec=ops.SPEC, arrays=(q, k, v), iters=5,
        problem=ops.inspect_call(q, k, v),
        plain=lambda: flash_attention_ref(q, k, v),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
        library_call="torch.nn.functional.scaled_dot_product_attention, "
                     "f32, is_causal, K/V repeated per group beforehand",
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_tc_ms=tc_bound_ms(flops, nbytes),
        bound_tc="3xTF32 on the tensor cores", flops=flops, bytes=nbytes)


def decode_cell(dev):
    """The llama3.2-3b decode window over an int8 cache; the int8 score
    multiply-adds at the int8 peak and the f32 ``p @ v`` at the f32 peak
    (the larger), or the bytes (K and V as int8), whichever is larger.
    ``bound_tc_ms`` is the design's: the score dot at the int8 peak plus
    the two f16 products of p.V at the f16 peak, or the bytes.  Also one
    decode step (Sq 1 over the same 8,192 keys), bound by bytes."""
    from repro_torch.kernels.flash_attention import int8
    from repro_torch.quant.quantize import quantize_kv

    q, k, v = attention_inputs(DECODE, dev, seed=7)
    arrays = (q,) + quantize_kv(k, v)
    kw = {"causal": True, "q_offset": DECODE["q_offset"]}
    pairs = sum(min(DECODE["skv"], DECODE["q_offset"] + i + 1)
                for i in range(DECODE["sq"])) * DECODE["b"] * DECODE["h"]
    ops = 2 * DECODE["hd"] * pairs
    nbytes = (4 * 2 * q.numel() + 2 * k.numel()
              + 4 * (arrays[2].numel() + arrays[4].numel()))
    t_ops = max(ops / PEAK_INT8_OPS, ops / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_tc = ops / PEAK_INT8_OPS + 2 * ops / PEAK_F16_FLOPS
    step = (q[:, -1:].contiguous(),) + arrays[1:]
    step_kw = {"causal": True, "q_offset": DECODE["skv"] - 1}
    step_bytes = nbytes - 4 * 2 * (q.numel() - step[0].numel())
    sms = int8.sm_count(q.device)

    def describe(params):
        """How the launch covers the window at these tiles, and one decode
        step's time (a loop of wrapper calls, a CUDA graph, the plain
        version)."""
        shape = int8.launch_shape(DECODE["sq"], DECODE["h"], DECODE["kv"],
                                  params["block_q"])
        splits = int8.split_count(DECODE["b"], DECODE["sq"], DECODE["skv"],
                                  DECODE["h"], DECODE["kv"],
                                  params["block_q"], sms)

        step_shape = int8.launch_shape(1, DECODE["h"], DECODE["kv"],
                                       params["block_q"])
        step_splits = int8.split_count(DECODE["b"], 1, DECODE["skv"],
                                       DECODE["h"], DECODE["kv"],
                                       params["block_q"], sms)

        def call():
            return int8.flash_attention_int8(*step, **step_kw, **params)
        return dict(
            launch=dict(shape, splits=splits, sms=sms, blocks=DECODE["b"]
                        * DECODE["kv"] * shape["q_tiles"] * shape["slices"]
                        * splits),
            step_launch=dict(step_shape, splits=step_splits,
                             blocks=DECODE["b"] * DECODE["kv"]
                             * step_shape["slices"] * step_splits),
            step_ms=cuda_ms(call, 20), step_graph_ms=graph_ms(call),
            step_plain_ms=cuda_ms(lambda: int8.flash_attention_int8_ref(
                *step, **step_kw), 5))

    def step_sweep():
        """One decode step's device time (CUDA graph) at each block_kv
        over other launches than the wrapper's: 1, 2 or 4 warps sharing
        the block's one row tile (key groups), and 8 to 64 key splits;
        each launch first held against the plain version."""
        from unittest import mock
        want = int8.flash_attention_int8_ref(*step, **step_kw)
        rtol, atol = int8.TOL
        out = {}
        for bkv in (32, 64, 128):
            params = {"block_q": int8.DEFAULT_BLOCK, "block_kv": bkv}
            for kg in (1, 2, 4):
                shape = dict(int8.launch_shape(1, DECODE["h"], DECODE["kv"],
                                               params["block_q"]))
                shape.update(key_groups=kg, warps=shape["row_tiles"] * kg)
                for splits in (8, 16, 32, 64):
                    with mock.patch.object(int8, "launch_shape",
                                           lambda *a, s=shape: s), \
                            mock.patch.object(int8, "split_count",
                                              lambda *a, n=splits: n):
                        def call(params=params):
                            return int8.flash_attention_int8(
                                *step, **step_kw, **params)
                        max_abs, worst = compare(call(), want, rtol, atol)
                        if worst > 1.0:
                            raise AssertionError(
                                f"flash_attention_int8 decode step, "
                                f"block_kv {bkv}, {kg} key groups, {splits} "
                                f"splits: max abs error {max_abs}")
                        out[f"kv{bkv}_kg{kg}_s{splits}"] = graph_ms(call)
        return out
    return dict(
        spec=int8.SPEC, arrays=arrays, iters=20,
        problem=int8.inspect_call(*arrays, **kw),
        plain=lambda: int8.flash_attention_int8_ref(*arrays, **kw),
        library=None, library_call=None, design=FLASH8_DESIGN,
        describe=describe, step_sweep=step_sweep,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_tc_ms=max(t_tc, t_bytes) * 1e3,
        bound_tc="int8 score dot at the int8 peak + two f16 p.V products "
                 "at the f16 peak, or the bytes",
        step_bound_ms=step_bytes / PEAK_HBM_BYTES * 1e3,
        step_bound_by="bytes", int8_ops=ops, f32_ops=ops, bytes=nbytes)


def time_new_kernels(dev, smi, tmp):
    """CUDA-event times of the tune path's three kernels at their largest
    shapes, at the untuned tiles dispatch resolves and at the winner of a
    sweep of that shape (into a throwaway cache), beside the plain
    version, one library call where one computes the same function, and
    the least time the card could take."""
    from repro_torch.kernels import registry
    from repro_torch.tune import TuneCache, sweep

    timings = {}
    for cell in (stencil_cell(dev), prefill_cell(dev), decode_cell(dev)):
        spec, problem, arrays = (cell.pop(k) for k in ("spec", "problem",
                                                        "arrays"))
        plain, library, iters = (cell.pop(k) for k in ("plain", "library",
                                                        "iters"))
        default = registry.resolve_params(spec, problem)
        rec = sweep(spec, problem, cache=TuneCache(
            spec.name, tmp / f"{spec.name}.json"))
        if not rec["exact"]:
            raise AssertionError(f"{spec.name}: no tile validated at the "
                                 f"timed shape")

        def kernel(params):
            return lambda: spec.run_call(problem, arrays, params)

        ms = {"ms": cuda_ms(kernel(default), iters),
              "tuned_ms": cuda_ms(kernel(rec["params"]), iters),
              "plain_ms": cuda_ms(plain, max(iters // 4, 3)),
              "library_ms": cuda_ms(library, iters) if library else None}
        # what the cell measures beyond that, at the untuned tile and at
        # the tuned one
        describe = cell.pop("describe", None)
        if describe:
            ms.update(describe(default))
            ms.update({"tuned_" + k: v
                       for k, v in describe(rec["params"]).items()})
        step_sweep = cell.pop("step_sweep", None)
        if step_sweep:
            ms["step_graph_ms_by_launch"] = step_sweep()
        timings[spec.name] = dict(
            cell, **ms, problem={k: v for k, v in problem.items()
                                 if k != "offsets"},
            params=default, tuned_params=rec["params"],
            tuned_candidates=len(rec["swept"]),
            share_of_bound=cell["bound_ms"] / ms["ms"],
            tuned_share_of_bound=cell["bound_ms"] / ms["tuned_ms"])
        if "bound_tc_ms" in cell:
            timings[spec.name].update(
                tc_share_of_bound=cell["bound_tc_ms"] / ms["ms"],
                tuned_tc_share_of_bound=cell["bound_tc_ms"] / ms["tuned_ms"])
        emit("timing", kernel=spec.name, nvidia_smi=smi, **timings[spec.name])
    return timings


def run_tune_phase(bundle, dev, work):
    """The deploy-time tuning path through the port's entry points, into
    a temporary cache directory: ``run_tune`` for the minibude bundle's
    serving buckets and every registered kernel's problems, then
    ``autotune_registered`` again (all cache hits, no launch).  Then the
    engine serving that bundle at bucket 256 must run the tuned
    ``block_rows`` (counted under provenance ``tuned``) and equal the
    default config's rows bit for bit.  Returns the launch counts of the
    ``run_tune`` call."""
    import torch
    import repro_torch.tune.cache as tcache
    from repro_torch.apps import minibude
    from repro_torch.core import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp
    from repro_torch.launch.dryrun import run_tune
    from repro_torch.obs import metrics
    from repro_torch.tune import autotune_registered

    # every default cache is made anew under the temporary directory
    tcache.ART = work / "tune_torch"
    tcache._default.clear()
    registry.reset_counts()
    t0 = time.perf_counter()
    run_tune(bundle=str(bundle), buckets=TUNE_BUCKETS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {s.name: s.launches for s in registry.all_specs()}
    registry.reset_counts()
    again = autotune_registered()
    relaunched = {s.name: s.launches for s in registry.all_specs()}

    records = []
    for path in sorted(tcache.ART.glob("*.json")):
        data = json.loads(path.read_text())
        for key, rec in sorted(data["entries"].items()):
            records.append(rec)
            emit("tune", kernel=data["kernel"], key=key,
                 winner=rec["params"], us=rec["us"],
                 default_us=rec["default_us"], speedup_x=rec["speedup_x"],
                 exact=rec["exact"], swept=len(rec["swept"]),
                 valid=sum(1 for e in rec["swept"] if e["exact"]))

    eng = InferenceEngine.get(bundle, dev)
    x = minibude.make_inputs(256, seed=9, device=dev)
    with torch.no_grad():
        xn = (x - eng.norm[0]) / eng.norm[1]
    params, provenance = registry.resolve_params_info(
        ops.SPEC, ops.inspect_call(xn, eng._packed))
    dispatches = metrics.counter(
        "repro_kernel_dispatch_total",
        "kernel dispatches by resolved-params provenance and precision tier",
        ("kernel", "provenance", "tier"))
    before = dispatches.value(kernel="fused_mlp", provenance="tuned",
                              tier="f32")
    y = eng.apply_batched(x)
    served_tuned = dispatches.value(kernel="fused_mlp", provenance="tuned",
                                    tier="f32") - before
    default = registry.fitting_defaults(ops.SPEC,
                                        ops.inspect_call(xn, eng._packed))
    with torch.no_grad():
        y_default = (fused_mlp(xn, eng._packed, **default) * eng.norm[3]
                     + eng.norm[2])
    torch.cuda.synchronize()
    tunable = [s for s in registry.all_specs() if s.params]
    checks = {
        "every_record_exact": bool(records) and all(r["exact"]
                                                    for r in records),
        "records": len(records) == len(TUNE_BUCKETS) + sum(
            len(s.default_problems) for s in tunable),
        "every_kernel_launched": all(launches[s.name] > 0
                                     for s in tunable),
        "second_pass_all_cached": relaunched == {k: 0 for k in relaunched}
        and len(again) == len(records) - len(TUNE_BUCKETS),
        "engine_route_fused_mlp": eng.route == "fused_mlp",
        "engine_provenance_tuned": provenance == "tuned",
        "engine_dispatch_counted_tuned": served_tuned == 1,
        "engine_rows_equal_default_config": bool(torch.equal(y, y_default)),
    }
    emit("tune_phase", seconds=seconds, launches=launches,
         engine_block_rows=params, default_block_rows=default,
         provenance=provenance, cache_dir=str(tcache.ART.relative_to(ROOT)),
         **checks)
    if not all(checks.values()):
        raise AssertionError(f"tune phase checks failed: {checks}")
    return launches


def rwkv6_term_scale(r, k, v, w, u, s0):
    """``sum_i |r_i| |S_ij + u_i k_i v_j|`` for every output of the WKV
    recurrence, by the plain version's loop: the scale of the rounding
    error of o's sum over the head, whatever order it runs in."""
    import torch
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = s0.float()
    out = torch.empty_like(rf)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        out[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t].abs(),
                                 (S + uf * kv).abs())
        S = wf[:, t, :, :, None] * S + kv
    return out


def check_rwkv6(dev):
    """rwkv6_chunk (through its op) against its plain version: o within
    the spec's (1e-5, 1e-5) (bf16 outputs one bf16 ulp), the final state
    bit for bit.  At the rwkv6-1.6b prefill shape the relative part is
    taken against ``sum_i |r_i t_ij|`` (:func:`rwkv6_term_scale`), the
    scale of a dot product's rounding error, and the plain (1e-5, 1e-5)
    ratio is reported beside it.  Returns ``(errors, failures, prefill
    arrays)``; the caller raises on failures after the LM slice has run."""
    import torch
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk as rwkv
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref

    rtol, atol = ops.SPEC.tol
    default = ops.SPEC.default_problems[0]
    cases = [
        ("default", default),
        ("T 1", dict(RWKV_PREFILL, t=1)),
        ("T 33", dict(default, t=33)),
        ("hd 8", dict(default, hd=8)),
        ("hd 64", dict(default, t=100, h=4, hd=64)),
        ("bf16", dict(default, t=100, h=4, hd=64, dtype="bfloat16")),
        ("hd 24", dict(default, t=33, hd=24)),
        ("hd 128", dict(default, t=100, h=4, hd=128)),
        ("hd 128 bf16", dict(default, t=33, hd=128, dtype="bfloat16")),
        ("rwkv6-1.6b prefill", RWKV_PREFILL),
    ]
    # held to the scale of their terms (rwkv6_term_scale): the prefill,
    # and 128-term dot products, whose f32 rounding in any order reaches
    # a flat 1e-5 where o is small
    term_scaled = {"rwkv6-1.6b prefill", "hd 128", "hd 128 bf16"}
    results, failures = {}, []
    for i, (label, problem) in enumerate(cases):
        arrays = ops.SPEC.make_call(
            problem, torch.Generator().manual_seed(60 + i), dev)
        o, sT = ops.rwkv6_chunk_op(*arrays)
        want_o, want_s = rwkv6_chunk_ref(*arrays)
        torch.cuda.synchronize()
        r = BF16_RTOL if problem["dtype"] == "bfloat16" else rtol
        got, want = o.float(), want_o.float()
        max_abs, worst_flat = compare(got, want, r, atol)
        res = {"max_abs_err": max_abs, "worst_flat": worst_flat,
               "max_abs_o": want.abs().max().item(),
               "state_bit_exact": bool(torch.equal(sT, want_s)),
               "finite": bool(torch.isfinite(o).all())}
        if label in term_scaled:
            scale = rwkv6_term_scale(*arrays)
            res["worst_vs_terms"] = ((got - want).abs() / (
                atol + r * scale)).max().item()
            res["max_term_scale"] = scale.max().item()
            worst = res["worst_vs_terms"]
        else:
            worst = worst_flat
        if label == "rwkv6-1.6b prefill":
            prefill = arrays
        res["launch"] = rwkv.launch_shape(problem["hd"])
        results[label] = res
        if not (worst <= 1.0 and res["state_bit_exact"] and res["finite"]
                and o.dtype == arrays[0].dtype):
            failures.append(f"rwkv6_chunk {label}: {res}")
    emit("kernel", kernel="rwkv6_chunk", cases=results, rtol=rtol,
         atol=atol, bf16_rtol=BF16_RTOL, ok=not failures)
    return results, failures, prefill


def rwkv6_bound(problem):
    """(bound_ms, bound_by, bytes, flops) of one WKV call: r, k, v, w read
    and o written once in the problem's dtype, u, s0 and sT in f32; 4 hd^2
    f32 operations per (b, t, h) (r S and the decay-and-add update)."""
    b, t, h, hd = (problem[k] for k in ("b", "t", "h", "hd"))
    el = 4 if problem["dtype"] == "float32" else 2
    nbytes = el * 5 * b * t * h * hd + 4 * (h * hd + 2 * b * h * hd * hd)
    flops = 4 * hd * hd * b * t * h
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nbytes, flops)


def graph_ms(fn, n=20, replays=10):
    """Device ms of one ``fn()`` from a CUDA graph of ``n`` calls, so that
    the host's launch time (the Python wrapper, tens of microseconds)
    does not pace a kernel shorter than it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, replays) / n


def time_rwkv6(dev, prefill_arrays, smi):
    """CUDA-event times of rwkv6_chunk and its plain version at the
    prefill shape and at T = 1 (a decode step), beside the bound: each
    launched from the host in a loop (``ms``, what a caller sees) and
    replayed from a CUDA graph (``graph_ms``, the device's time; at T = 1
    the loop is paced by the host).  No one PyTorch call computes this
    recurrence: no library time."""
    import torch
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk as rwkv
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref

    out = {}
    step = dict(RWKV_PREFILL, t=1)
    for label, problem, arrays, iters in (
            ("prefill", RWKV_PREFILL, prefill_arrays, 20),
            ("decode", step, ops.SPEC.make_call(
                step, torch.Generator().manual_seed(70), dev), 200)):
        bound_ms, bound_by, nbytes, flops = rwkv6_bound(problem)

        def kernel():
            return ops.SPEC.run_call(problem, arrays, {})
        ms = cuda_ms(kernel, iters)
        device_ms = graph_ms(kernel)
        plain_ms = cuda_ms(lambda: rwkv6_chunk_ref(*arrays),
                           3 if problem["t"] > 1 else iters, warmup=1)
        out[label] = dict(problem=problem, ms=ms, graph_ms=device_ms,
                          plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by,
                          share_of_bound=bound_ms / ms,
                          graph_share_of_bound=bound_ms / device_ms,
                          bytes=nbytes, flops=flops,
                          launch=rwkv.launch_shape(problem["hd"]))
        emit("timing", kernel="rwkv6_chunk", case=label, design=RWKV_DESIGN,
             nvidia_smi=smi, **out[label])
    return out


def lm_states(caches):
    """Every layer's S, x_last and cm_x_last, stacked."""
    import torch
    layers = caches["stack"][0]
    return {"S": torch.stack([c["mixer"]["S"] for c in layers]),
            "x_last": torch.stack([c["mixer"]["x_last"] for c in layers]),
            "cm_x_last": torch.stack([c["cm_x_last"] for c in layers])}


def lm_compare(got, want):
    """(max abs error, largest |want|, worst elementwise ratio at rtol =
    atol = 2e-2, the reference's bf16 model tolerance); the checks hold
    the first against tol * (1 + the second)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max().item(), want.abs().max().item(),
            compare(got, want, 2e-2, 2e-2)[1])


def lm_against_plain(cfg, params, prompts, logits, caches):
    """The prefill that gave ``logits``/``caches`` run again with the WKV
    recurrence computed by the plain version (which must launch
    nothing), and the cache handoff: ``serve_step`` on the last prompt
    token after a prefill of the others, against ``logits``."""
    from unittest import mock

    import torch
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    from repro_torch.models import blocks, lm

    before = ops.SPEC.launches
    with mock.patch.object(blocks, "rwkv6_chunk_op", rwkv6_chunk_ref):
        t0 = time.perf_counter()
        logits_p, caches_p = lm.prefill(cfg, params, prompts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    plain_launches = ops.SPEC.launches - before
    mine, ref = lm_states(caches), lm_states(caches_p)
    vs = {"logits": lm_compare(logits, logits_p)}
    vs.update({k: lm_compare(mine[k], ref[k]) for k in mine})
    _, short = lm.prefill(cfg, params, prompts[:, :-1])
    step, _ = lm.serve_step(cfg, params, short, prompts[:, -1:],
                            prompts.shape[1] - 1)
    return {
        "plain_wkv_prefill_s": seconds,
        "plain_path_launches": plain_launches,
        "vs_plain_wkv": {k: dict(zip(("max_abs_err", "max_abs", "worst"), v))
                         for k, v in vs.items()},
        "S_max_abs_err_by_layer": (mine["S"] - ref["S"]).abs().amax(
            dim=(1, 2, 3, 4)).tolist(),
        "layer0_state_bit_exact": bool(torch.equal(mine["S"][0],
                                                   ref["S"][0])),
        "handoff": dict(zip(("max_abs_err", "max_abs", "worst"),
                            lm_compare(step, logits)))}


def lm_within(res, tol):
    """Every comparison of :func:`lm_against_plain` within ``tol`` of the
    largest magnitude."""
    cmp = list(res["vs_plain_wkv"].values()) + [res["handoff"]]
    return all(c["max_abs_err"] <= tol * (1 + c["max_abs"]) for c in cmp)


def run_lm_slice(dev, smi, rwkv_arrays):
    """prefill -> serve_step of rwkv6-1.6b at full width through the
    port's entry points, held against the same model with the WKV
    recurrence computed by the plain version, in its bf16 and as an f32
    copy; then rwkv6_chunk's times (``rwkv_arrays``: its inputs at the
    prefill shape).  Returns the generate loop's rwkv6_chunk launches
    and the kernel's times."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm

    cfg = get_config(LM_ARCH)
    seconds = {}
    t0 = time.perf_counter()
    params = lm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    seconds["init_params"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=g, device=dev)
    lm.prefill(cfg, params, prompts)  # warm-up: cuBLAS handles, allocator

    registry.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, prompts)
    torch.cuda.synchronize()
    seconds["prefill"] = time.perf_counter() - t0
    prefill_launches = (ops.SPEC.launches, ops.SPEC.plain_calls)
    bf16 = lm_against_plain(cfg, params, prompts, logits, caches)

    registry.reset_counts()
    res = serve_lm.generate(cfg, params, prompts, LM_GEN)
    gen_launches = ops.SPEC.launches
    tokens = res["tokens"]
    finite = bool(torch.isfinite(logits).all()
                  and torch.isfinite(res["logits"]).all())
    del caches

    # the same weights in f32: the recurrence's own differences, without
    # bf16 rounding of the activations to amplify them layer by layer
    cfg32 = cfg.replace(dtype="float32")
    params32 = _cast(params, torch.float32)
    del params
    registry.reset_counts()
    logits32, caches32 = lm.prefill(cfg32, params32, prompts)
    torch.cuda.synchronize()
    f32_launches = ops.SPEC.launches
    f32 = lm_against_plain(cfg32, params32, prompts, logits32, caches32)
    finite = finite and bool(torch.isfinite(logits32).all())
    del params32, caches32

    timing = time_rwkv6(dev, rwkv_arrays, smi)
    steps = LM_GEN - 1
    checks = {
        "prefill_launches_one_per_layer":
        prefill_launches == (cfg.n_layers, 0)
        and f32_launches == cfg.n_layers,
        "plain_path_launched_nothing": bf16["plain_path_launches"] == 0
        and f32["plain_path_launches"] == 0,
        "generate_launches_one_per_layer_per_call":
        gen_launches == cfg.n_layers * LM_GEN,
        "logits_finite": finite,
        "logits_shape": tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab),
        "layer0_state_bit_exact": bf16["layer0_state_bit_exact"]
        and f32["layer0_state_bit_exact"],
        "bf16_matches_plain_wkv_and_handoff": lm_within(bf16, LM_TOL_BF16),
        "f32_matches_plain_wkv_and_handoff": lm_within(f32, LM_TOL_F32),
        "tokens": tuple(tokens.shape) == (LM_BATCH, LM_GEN)
        and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
    }
    numbers = dict(
        prefill_s=seconds["prefill"], decode_s=res["decode_s"],
        generate_prefill_s=res["prefill_s"],
        decode_ms_per_token=res["decode_s"] / steps * 1e3,
        tokens_per_s=LM_BATCH * steps / res["decode_s"],
        kernel_ms_prefill=timing["prefill"]["ms"],
        kernel_ms_decode=timing["decode"]["ms"],
        plain_ms_prefill=timing["prefill"]["plain_ms"],
        plain_ms_decode=timing["decode"]["plain_ms"],
        bound_ms_prefill=timing["prefill"]["bound_ms"],
        bound_ms_decode=timing["decode"]["bound_ms"],
        kernel_share_of_prefill=cfg.n_layers * timing["prefill"]["ms"]
        / (seconds["prefill"] * 1e3))
    emit("lm_slice", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_rwkv_heads,
         head_size=cfg.rwkv_head_size, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, dtype=cfg.dtype, params=n_params,
         batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, seconds=seconds,
         launches={"prefill": prefill_launches[0], "generate": gen_launches,
                   "f32_prefill": f32_launches},
         bf16=bf16, f32=f32, tol_bf16=LM_TOL_BF16, tol_f32=LM_TOL_F32,
         sample=tokens[0, :8].tolist(), timing=timing, nvidia_smi=smi,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         **numbers, **checks)
    if not all(checks.values()):
        raise AssertionError(f"lm slice checks failed: {checks}")
    return gen_launches, timing


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # the int8 slices check the engine under the default REPRO_QUANT
    os.environ.pop("REPRO_QUANT", None)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_mlp import int8
    from repro_torch.kernels.fused_mlp.fused_mlp import REPLACES, SOURCE
    from repro_torch.kernels.fused_mlp.ops import SPEC
    from repro_torch.kernels.flash_attention import flash_attention as flash
    from repro_torch.kernels.flash_attention import int8 as flash8
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_chunk import ops as rwkv_ops
    from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk as rwkv
    from repro_torch.kernels.stencil_gather import ops as stencil_ops
    from repro_torch.kernels.stencil_gather import stencil_gather as stencil

    t_start = time.perf_counter()
    dev = resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    probe_jobs = start_probe_builds(work)
    built = _build.build_all()
    probe_libs = finish_probe_builds(probe_jobs, t0)
    build_s = time.perf_counter() - t0
    for b in built.values():
        emit("build", kernel=b.name, source=str(b.source.relative_to(ROOT)),
             seconds=b.seconds, all_builds_seconds=build_s,
             so=str(b.so_path.relative_to(ROOT)),
             ptxas=[line.strip() for line in b.ptxas.splitlines()
                    if "registers" in line or "spill" in line
                    or "smem" in line or "entry function" in line])

    bude, errs = check_kernel("minibude", BUDE_WIDTHS, BUDE_ACTS, dev)
    check_kernel("activations", ACT_WIDTHS, ACT_ACTS, dev)
    check_kernel("wide", WIDE_WIDTHS, WIDE_ACTS, dev)
    bude8, errs8 = check_kernel_int8("minibude", BUDE_WIDTHS, BUDE_ACTS, dev)
    check_kernel_int8("activations", ACT_WIDTHS, ACT_ACTS, dev)
    errs_new = {"stencil_gather": check_stencil(dev),
                "flash_attention": check_flash(dev),
                "flash_attention_int8": check_flash8(dev)}
    rwkv_errs, rwkv_failures, rwkv_arrays = check_rwkv6(dev)

    launches = run_slice(dev, work)
    int8_launches = sum(run_int8_slice(app, key, hidden, dev, work)
                        for app, key, hidden in INT8_SLICES)

    timings = time_kernel(bude, BUDE_ACTS, dev, smi)[INFER_POSES]
    timings8_all = time_int8(bude8, dev, smi)
    timings8, time8_256 = timings8_all[INFER_POSES], timings8_all[256]
    timings_new = time_new_kernels(dev, smi, work / "timing_sweeps")
    check_numerics(dev, probe_libs, smi)
    tune_launches = run_tune_phase(work / "bundle", dev, work)
    shutil.rmtree(work)
    lm_launches, rwkv_timing = run_lm_slice(dev, smi, rwkv_arrays)
    if rwkv_failures:
        raise AssertionError("; ".join(rwkv_failures))
    new_rows = []
    for spec, mod in ((stencil_ops.SPEC, stencil), (flash_ops.SPEC, flash),
                      (flash8.SPEC, flash8)):
        name, t = spec.name, timings_new[spec.name]
        rtol, atol = spec.tol or (0.0, 0.0)  # None: bit-exact
        new_rows.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": tune_launches[name],
            "max_abs_err": errs_new[name], "rtol": rtol, "atol": atol,
            "shape": t["problem"], "ms": t["ms"], "tuned_ms": t["tuned_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if "bound_tc_ms" in t:
            new_rows[-1]["bound_tc_ms"] = t["bound_tc_ms"]
        if "step_ms" in t:
            new_rows[-1].update(step_ms=t["step_ms"],
                                tuned_step_ms=t["tuned_step_ms"],
                                step_graph_ms=t["step_graph_ms"],
                                tuned_step_graph_ms=t["tuned_step_graph_ms"],
                                step_bound_ms=t["step_bound_ms"])
    print(json.dumps({"kernels": [{
        "name": "fused_mlp", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches["fused_mlp"],
        "max_abs_err": errs[INFER_POSES], "rtol": SPEC.tol[0],
        "atol": SPEC.tol[1],
        "batch": INFER_POSES, "ms": timings["ms"],
        "plain_ms": timings["plain_ms"],
        "bound_ms": timings["bound_ms"],
        "bound_by": timings["bound_by"],
        "bound_tc_ms": timings["bound_tc_ms"],
        "library_ms": timings["library_ms"]}, {
        "name": "fused_mlp_int8", "route": "cuda", "source": int8.SOURCE,
        "replaces": int8.REPLACES, "launches": int8_launches,
        "max_abs_err": errs8[INFER_POSES], "rtol": int8.SPEC.tol[0],
        "atol": int8.SPEC.tol[1],
        "batch": INFER_POSES, "ms": timings8["ms"],
        "plain_ms": timings8["plain_ms"],
        "bound_ms": timings8["bound_ms"],
        "bound_by": timings8["bound_by"],
        "library_ms": timings8["library_ms"],
        "launch": timings8["launch"],
        "ms_256": time8_256["ms"], "bound_ms_256": time8_256["bound_ms"],
        "plain_ms_256": time8_256["plain_ms"],
        "library_ms_256": time8_256["library_ms"]}] + new_rows + [{
        "name": "rwkv6_chunk", "route": "cuda", "source": rwkv.SOURCE,
        "replaces": rwkv.REPLACES, "launches": lm_launches,
        "max_abs_err": rwkv_errs["rwkv6-1.6b prefill"]["max_abs_err"],
        "rtol": rwkv_ops.SPEC.tol[0], "atol": rwkv_ops.SPEC.tol[1],
        "shape": RWKV_PREFILL, "ms": rwkv_timing["prefill"]["ms"],
        "plain_ms": rwkv_timing["prefill"]["plain_ms"],
        "bound_ms": rwkv_timing["prefill"]["bound_ms"],
        "bound_by": rwkv_timing["prefill"]["bound_by"],
        "library_ms": None, "graph_ms": rwkv_timing["prefill"]["graph_ms"],
        "launch": rwkv_timing["prefill"]["launch"],
        "decode_ms": rwkv_timing["decode"]["ms"],
        "decode_graph_ms": rwkv_timing["decode"]["graph_ms"],
        "decode_plain_ms": rwkv_timing["decode"]["plain_ms"],
        "decode_bound_ms": rwkv_timing["decode"]["bound_ms"]}]}),
        flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
