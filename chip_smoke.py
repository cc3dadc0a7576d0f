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
   ``train_slice`` -- the paper's training side on the card, one line per
   part: minibude collects 16,384 poses, ``fit`` trains the full-width
   MLP (5 epochs at batch 128; seconds per epoch, steps/s, ``val_rmse``,
   which must beat the mean ``y_sd``), the bundle is served over 65,536
   poses through the engine (fused_mlp must launch; rows within its
   tolerance of the trained Sequential), and one epoch on the card is
   held against one on the CPU from the same seed (``TRAIN_*_TOL``);
   bonds runs ``nested_search`` on 4,096 collected rows and serves its
   ``best_trial`` (the route must be fused_mlp for a pure MLP, the
   Sequential for one with Dropout); miniweather fits a CNN on a
   120-step trajectory and runs the predicated region interleaved 0:1,
   1:1 and 1:3 over 16 steps (1:1 no worse than 0:1); particlefilter
   fits a CNN on the filter's estimates over 256 frames and reports the
   surrogate's and the filter's error against the truth on an unseen
   video;
   ``serve_slice`` -- the serving layer (ServeQueue -> Batcher ->
   InferenceEngine.apply_batched) on the card, one line per part: 8
   submitter threads x 32 ``infer_async`` minibude requests of 1 to 4,096
   rows over the f32 and the gated int8 bundle through one queue
   (``FlushPolicy(16384, 2 ms, 65,536)``), every request bit-identical to
   a synchronous ``infer`` of its rows, once traced (NVTX ranges, every
   request covered from enqueue to scatter, the Chrome trace under
   ``build/chip_smoke/``, the card's busy share from torch.profiler) and
   once plain, beside the same requests one at a time (rows/s, p50/p99
   per key, batches, bucket fill, launches, host time by span);
   binomial's ``price_chunks_async`` (65,536 options in chunks of 4,096,
   bit-equal) and miniweather's ``run_ensemble_async`` (8 members, 16
   steps, within ``MW_SERVE_TOL``); four fault drills through
   ``REPRO_FAULTS`` plans (a ``batcher.scatter`` raise retried; NaN from
   the int8 engine screened, served by the accurate path, the breaker
   OPEN then closed by HALF_OPEN probes on an injected clock; corrupted
   f32 weights under shadow scoring at rate 1: the scorer's RMSE equal
   to the direct one, CRITICAL, the breaker tripped on quality); the
   residency drill (a byte budget below the three bundles' sum: one
   eviction, one reload, metered bytes within 10% of
   ``memory_allocated``); and two tenants weighted 3:1 under overload;
   ``control_slice`` -- the serving layer's control plane on the card,
   one line per part: ``floor`` (the median host time of 200 warm
   ``apply_batched`` calls of 8 rows, each ended by a sync, for the f32
   and the int8 minibude bundle: the dispatch floor the adaptive flush
   controller's default takes); ``model`` (the controller's predicted
   batch latency against the measured median of ``apply_batched`` at
   buckets 8 to 16,384, both tiers, reported, not gated); ``adaptive``
   (the serve slice's 256 requests through a queue driven by
   ``AdaptiveFlushController``, its dispatcher thread and no explicit
   flush: every row bit-identical to its synchronous ``infer``, every
   deadline within ``[min_delay_s, max_delay_s]``, measured or corrected
   latencies used by the end; rows/s, p50/p99, batches and decisions
   beside the serve slice's static numbers); ``low_rate`` (one request
   of 7 rows every 5 ms under a 50 ms static deadline, with and without
   the controller); ``resweep`` (a drift re-sweep drill in a temporary
   tune cache: both bundles served at the untuned bucket 512 until the
   trigger fires, both tiers' cells swept on a side stream while serving
   goes on, the records ``exact``, each counted once, the next dispatch
   ``tuned`` and every row bit-identical throughout); ``endpoint`` (an
   ``ObsServer`` watching the adaptive queue: a valid ``/metrics``
   scrape with the controller, re-sweep and serve families,
   ``/healthz`` 200 while the dispatcher lives and 503 naming the queue
   once it dies, ``/varz`` and ``/tracez``, ``metrics_report --json``
   quantiles, and ``python -m repro_torch.obs.server --demo
   --self-check`` in a subprocess on the card);
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
9. ``gqa_lm_slice`` -- the GQA LM's serving path at the full width of
   llama3.2-3b (28 layers, d_model 3,072, 24 q and 8 kv heads of 128,
   d_ff 8,192, vocab 128,256, tied embeddings, bf16, seeded random
   weights on the card), attention on ``flash_attention``: ``prefill``
   of the same 4 prompts of 2,048 tokens (exactly 28 launches), the
   same prefill with ``blocks.flash_attention_op`` patched to the plain
   version (no launch; logits and every layer's K/V cache within
   ``LM_TOL_BF16`` of the largest magnitude), the cache handoff, the
   same handoff through an int8 KV cache with the kernel against the
   plain version, then ``generate`` for 33 tokens (28 launches per call)
   and the same decode loop traced for the card's busy share; the same
   comparisons on an f32 copy of the weights (``LM_TOL_F32``); generate
   must run its prefill on the bf16 prefill kernel and every step on the
   decode kernel and its combine, none on the f32 design; the kernel's
   times at the path's shapes (the causal prefill, one decode step over
   2,081 cached positions with 2,049 valid, also from a CUDA graph and
   its two kernels alone, and the training step's forward, B 2 x 2,048)
   beside its plain version, ``scaled_dot_product_attention``, the bound
   and ``bound_split_ms``, the operations the bf16 design does (q.k once,
   P.V twice: 1.5x);
   ``mla_lm_slice`` -- the MLA + MoE LM's serving path at the full width
   and depth of deepseek-v2-lite-16b (27 layers, d_model 2,048, 16 heads
   of q.k 192 and v 128 over a 512-wide latent, a dense first layer, 26
   MoE layers of 64 experts top-6 with 2 shared, vocab 102,400, bf16,
   15.7 B seeded parameters made on the card; the llama weights freed
   first), prefill attention on ``flash_attention`` at q.k 192 / v 128:
   ``prefill`` of the same prompts (exactly 27 launches), the same
   prefill with ``blocks.flash_attention_op`` patched to the plain
   version (no launch; logits and every layer's ``ckv``/``kr`` cache),
   each MoE layer's share of (token, slot) routes the two runs agree on,
   every layer held from the plain run's own input with the kernel and
   with the plain version, the cache handoff with each (and its gap to
   the prefill's logits beside the routes its step dropped at C = 1);
   within ``LM_TOL_BF16`` end to end, or, where a route flipped, layer
   by layer; then ``generate`` for 33 tokens (27 launches, none a decode
   step: the absorbed form) and the decode loop traced for the card's
   busy share; the same comparisons on an f32 copy of the weights at
   depth 3 (``LM_TOL_F32``); the kernel's time at the prefill shape
   beside its plain version, SDPA (its backend named) and the bound;
   ``jamba_lm_slice`` -- the hybrid LM's serving path at the full width
   of jamba-v0.1-52b and one period of its pattern (8 layers: 7 Mamba
   layers of d_inner 8,192 and d_state 16, 1 GQA layer of 32 q and 8 kv
   heads of 128 without rope, MoE of 16 experts top-2 on every other
   layer, learned positions, vocab 65,536, bf16, 13.4 B seeded
   parameters made on the card; the deepseek weights freed first), its
   selective scan on ``mamba_scan`` and its attention on
   ``flash_attention``: ``prefill`` of the same prompts (exactly 7 scan
   and 1 attention launches), the same prefill with both ops patched to
   their plain versions (no launch; logits and every layer's cache:
   conv and h, K and V), each MoE layer's route agreement, every layer
   held from the plain run's own input, the cache handoff with both
   (and without drops); within ``LM_TOL_BF16`` end to end, or, where a
   route flipped, layer by layer; then ``generate`` for 33 tokens (one
   attention launch a step, no scan: the step is plain torch), the
   prefill and the decode loop traced (kernel time by kind, busy share);
   the same comparisons on an f32 copy of the weights made leaf by leaf
   as the bf16 ones are freed (``LM_TOL_F32``); the scan's time at the
   prefill shape beside its plain version and the bound;
   ``whisper_lm_slice`` -- the encoder-decoder LM's serving path at the
   full width and depth of whisper-medium (24 encoder and 24 decoder
   layers, d_model 1,024, 16 heads of 64 without GQA, d_ff 4,096, qkv
   bias, LayerNorm, gelu, vocab 51,865 padded to 51,968, learned decoder
   positions, bf16, seeded weights on the card; the jamba weights freed
   first), every attention on ``flash_attention``: ``prefill`` of 4
   prompts of 384 tokens over 4 x 1,500 seeded frame embeddings (the
   reference's stub frontend), exactly 72 launches on the bf16 prefill
   kernel (24 causal encoder 1,500 x 1,500, 24 decoder self, 24 cross
   384 x 1,500), the same prefill and the encoder with
   ``blocks.flash_attention_op`` patched to the plain version (no
   launch; logits, the encoder's output, every layer's self and cross
   K/V), the cache handoff, the int8-cache handoff (the cross cache
   stays bf16) with the kernel against the plain version; then
   ``serve_lm.generate`` for 33 tokens (48 launches a step, each on the
   decode kernel and its combine: 24 self, 24 cross over all 1,500
   frames) and the decode loop traced for the card's busy share; the
   same comparisons on an f32 copy (``LM_TOL_F32``); the kernel's times
   at the path's four shapes (the encoder, the cross prefill, a step's
   self and cross attention) beside its plain version, SDPA and the
   bound;
10. ``lm_train_slice`` -- LM training on the card: the
    ``flash_attention_bwd`` kernel at the training shape (B 2, S 2,048,
    24/8 heads of 128, causal) in f32 and bf16 against the plain backward
    and autograd of the plain version, two launches bit for bit, its time
    beside the plain backward's, SDPA's backward and the bound
    (``kernel`` lines); every leaf's gradient of llama3.2-3b at full
    width and depth 2 through the kernels against the same with
    ``blocks.flash_attention_op`` patched to the plain version
    (``LMT_GRAD_TOL_*``, part ``grads``); 4 ``train_step``s of
    llama3.2-3b at full width and depth (seeded weights, policy full, one
    TokenPipeline batch of 2 x 2,048 tokens, ``step`` past the warmup):
    loss, grad norm, seconds, the device spans of the gradients, the clip
    and AdamW (CUDA events), 56 flash_attention and 28
    flash_attention_bwd launches a step (remat runs each forward twice),
    the last step traced for the card's busy share, ``peak_gib`` (part
    ``train``); then rwkv6-1.6b: the ``rwkv6_chunk_bwd`` kernel at its
    training shape (B 2, T 2,048, 32 heads of 64, f32) with the spec's
    decays and with the model's, and at T 1 and 33, head sizes 8, 24, 64
    and 128 and bf16 inputs, from s0 != 0, with and without a cotangent
    on the final state, against the plain backward and autograd of the
    plain version (``TOL_BWD``), a relaunch bit for bit, its time beside
    the plain backward's, the forward's, the bound (its products in
    3xTF32) and the CUDA-core f32 bound, and each of its kernels' device
    time (``kernel`` line); every leaf's
    gradient at
    full width and depth 2 against ``blocks.rwkv6_chunk_op`` patched to
    the plain version (``LMT_GRAD_TOL_F32``, ``RWKV_GRAD_TOL_BF16``); 4
    ``train_step``s at full width and depth as llama's: 48 rwkv6_chunk
    and 24 rwkv6_chunk_bwd launches a step, none of the plain version,
    the kernel time by kind (``wkv_forward``, ``wkv_backward``), loss
    falling, ``peak_gib`` under 80; the train_lm example's resume drill
    on the 20m preset (60 steps; the simulated failure after 36 exits 17,
    its checkpoint
    restored bit for bit, the run resumed; the last losses of both runs
    and whether they agree bit for bit; the gradient leaves that differ
    between two evaluations of one batch; part ``resume_drill``);
    ``dist_slice`` -- the sharding substrate (``repro_torch.dist``) on
    the card: ``DIST_RANKS`` ranks of one gloo group, each a process of
    this script (``chip_smoke.py --dist-rank RANK WORLD PORT CONFIG``,
    started after the kernels are built and the int8 bundle gated here)
    share the one H100 (NCCL takes no two ranks of one device; the
    collectives go through host memory, the compute stays on the card).
    Part ``serve``: a full-width minibude bundle in each tier through
    ``InferenceEngine.apply_batched`` under ``use_mesh`` (data 4 x model
    1) at 65,536 rows (16,384 a rank) and at 65,533 (bucketed), every row
    bit for bit the one-rank kernel's, the kernel's launches a rank, the
    collectives, rows/s sharded and on one rank. Part ``train``:
    llama3.2-3b at full width cut to 2 layers on data 2 x model 2 (12 q
    and 4 kv heads a rank) in bf16 and f32, one batch of 2 x 2,048: step
    1's loss and every gradient against one rank's with the same kernels
    (``DIST_GRAD_TOL``), then 2 train_steps (the attention kernels'
    launches a rank, collectives by kind, seconds a step, ``peak_gib`` a
    rank). Part ``restore``: the bf16 state saved (gathered whole) and
    restored onto data 4 x model 1, every rank's block of every leaf on
    both meshes equal to the file's bit for bit. Part ``smoke``: the dry
    run's tiny train cell on the card, on a fake group of 256 ranks in
    this process (non-zero bytes of every kind, the attention kernels
    and their backward launched), and the host seconds of its step
    with and without the collective mode (``DIST_MODE_REPS`` each,
    alternated). Sharded times are the cost of sharding on one card,
    not a speedup;
    ``pod_slice`` -- the multi-host pod (``repro_torch.launch.multihost``)
    on the card, its processes spawned by ``spawn_local_pod`` (each a
    rank of one gloo group, all sharing the one H100). Part ``smoke``:
    ``run_smoke`` on 2 processes with the flight recorder and shadow
    scoring on (rows bit for bit one-process serving, remote rows, the
    bucket past the local rows, every host's drift ``OK``, both hosts'
    ``pod.agree`` in the merged trace, ``fused_mlp`` launched on each).
    Part ``minibude``: the full-width bundles in both tiers (the int8
    one gated first) on ``POD_PROCESSES`` processes of 8 callers x 2,048
    rows, 65,536 global rows a ``pod_flush``: rows bit for bit one
    rank's, each process's kernel launches, no collective inside the
    apply, seconds a ``pod_flush`` against rank 0 serving the 65,536 rows
    alone (``pod_bude_worker``). Part ``host_drop``: the drill at the
    reference's defaults (stall 15 s, watchdog 2 s): zero lost, rows
    equal, host 0 degraded within the watchdog + 5 s naming host 1,
    ``/healthz`` critical with ``pod:host-1``. Pod times are the cost of
    the pod on one card, not a speedup;
11. the ``kernels`` line (``flash_attention`` there is its f32 design;
    ``flash_attention_bf16``, ``_bf16_decode`` and ``_bf16_combine`` the
    bf16 one's three kernels, each with its launches by path;
    ``rwkv6_chunk`` with its serving and training launches,
    ``rwkv6_chunk_bwd`` with the training steps'; the script
    fails if a kernel of the line was never launched), the ``nvidia-smi``
    line and, last, ``{"ok": true, "device": {...}}``.

Before the slices, the ``kernel`` lines also hold stencil_gather (bit
for bit: every candidate tile of its default problem in f32 and bf16, a
grid no tile divides, 4096x4096), flash_attention (its tolerance, each
case in f32 and bf16: both default problems, non-causal, GQA groups 1
and 3, ``kv_valid_len`` 0 and 150, ``q_offset``, the llama3.2-3b
prefill, the decode step at groups 1, 3 and 4 and with no valid key,
Sq x group 16 and 17, q.k 192 and 256 over v 128, whisper's encoder
(causal 1,500 x 1,500, hd 64, group 1), cross prefill (384 x 1,500) and
cross step (Sq 1 over 1,500 keys, all valid); bf16 on the bf16
kernels only, a relaunch bit for bit) and
flash_attention_int8 (its default problem, the decode window, one decode
step, GQA groups 1 and 4, hd 4, 36 and 64, 8,191 keys non-causal,
``q_offset`` -16, ``kv_valid_len`` 0 and 5,000, all at the decode
window's size; a second launch bit-identical; the count of elements that
differ at all) and rwkv6_chunk (its default problem, T 1 and 33, head sizes 8, 16, 24, 64
and 128, bf16 inputs, the rwkv6-1.6b prefill shape; the final state bit
for bit) and mamba_scan (jamba's prefill shape in bf16 and f32, one
step, S 70 at d_inner 200, d_state 5 and 8, decays underflowing to 0; y
and the final state against the scale of their terms, a second launch
bit for bit) against their plain
versions.  fused_mlp_int8's rows are held
bit-identical across every ``block_rows`` that fits;
rwkv6_chunk's timing lines also give its device time from a CUDA graph
(at T = 1 a loop of launches is paced by the host).

Launch counts are set to 0 just before each main path (the f32 slice's
region calls, each int8 slice's infer region, the train slice's infer
regions, the serve slice's traced coalesced run, the control slice's
adaptive run, the ``run_tune`` call, each LM's prefill and its generate
loop, the training steps, each dist rank's sharded applies and sharded
train steps) and read just after.  Any failure raises, so
the script exits
non-zero and prints no result.  Outside the train slice the bundle weights are
random: nothing there measures surrogate accuracy.
"""
import contextlib
import functools
import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
from unittest import mock

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
# the train slice: minibude fit at full width on 16,384 collected poses
# (5 epochs at batch 128) and served over 65,536; the bonds search on
# 4,096 rows; miniweather over a 120-step trajectory, interleaved over 16
# steps (tests/test_apps.py:75-100 at the example's 120 steps and 20
# epochs); particlefilter over 256 frames
TRAIN_POSES, TRAIN_INFER, TRAIN_EPOCHS, TRAIN_BATCH = 16384, 65536, 5, 128
SEARCH_ROWS = 4096
MW_STEPS, MW_HORIZON, CNN_EPOCHS = 120, 16, 20
MW_ARCH = {"k1": 3, "ch1": 8, "k2": 0}
PF_FRAMES = 256
PF_ARCH = {"conv_k": 3, "stride": 2, "pool": 2, "fc2": 64}
# one epoch (102 Adam steps) of the minibude fit on the card against the
# CPU, the parameters' L2 distance over the CPU's distance from the init.
# Adam's step is normalized, so an element whose gradient sits at the
# level of rounding takes a step of lr with either sign, and ReLU units
# flip: the difference grows over the epoch.  The phase also runs the
# CPU epoch on one thread, a change of summation order alone; on the
# H100 machine's CPU (8 threads against 1) that leaves the parameters
# 0.18 of their distance from the init apart and the validation RMSE
# 0.7% apart, so the card is held to about twice that: 0.4 and 2%.  The
# first batch's gradients at the init take no step: f32 sums of up to
# 1,024 terms in another order, 1e-4 of each tensor's largest gradient
TRAIN_PARAM_TOL, TRAIN_RMSE_RTOL, TRAIN_GRAD_TOL = 0.4, 0.02, 1e-4
GATE_BUDGET_REL = 0.05   # x the f32 output RMS (tests/test_quant.py:58-65)
# the serve slice: the paper's many-callers regime through ServeQueue ->
# Batcher -> InferenceEngine.apply_batched on fused_mlp / fused_mlp_int8.
# 8 submitter threads x 32 requests, each of a row count drawn with a
# seed from SERVE_ROWS, over the f32 and the gated int8 minibude bundles
SERVE_THREADS, SERVE_REQUESTS = 8, 32
SERVE_ROWS = (1, 7, 64, 256, 1000, 4096)
SERVE_POLICY = dict(max_batch_rows=16384, max_delay_s=0.002,
                    max_pending_rows=65536)
SERVE_SWITCH_S = 5e-4  # sys.setswitchinterval for one more coalesced run
# the control slice: the dispatch floor (a warm apply_batched of 8 rows,
# the median of 200, each ended by a sync), the latency model at every
# bucket from 8 to 16,384, the serve slice's requests through the
# adaptive controller, a low-rate leg (one request of 7 rows every 5 ms
# under a 50 ms static deadline), and the re-sweep drill at 300 rows (the
# untuned bucket 512) after 4 batches
FLOOR_ROWS, FLOOR_CALLS = 8, 200
MODEL_BUCKETS, MODEL_CALLS = tuple(8 << i for i in range(12)), 20
LOW_RATE_REQUESTS, LOW_RATE_ROWS, LOW_RATE_GAP_S = 64, 7, 0.005
LOW_RATE_POLICY = dict(max_batch_rows=16384, max_delay_s=0.05,
                       max_pending_rows=65536)
RESWEEP_AFTER, RESWEEP_ROWS, RESWEEP_BUCKET = 4, 300, 512
# the async app drivers: binomial's 65,536 options in chunks of 4,096,
# miniweather's ensemble of 8 for 16 steps.  The CNN runs through cuDNN
# convolutions, whose algorithm may differ between a batch of 8 and a
# batch of 1: each member's state after 16 steps is held to 1e-4 of the
# state's largest magnitude (f32 sums of 180 products per output
# rounded at 1e-7, carried through 16 autoregressive steps)
BIN_OPTIONS, BIN_CHUNK = 65536, 4096
MW_ENSEMBLE, MW_ENSEMBLE_STEPS, MW_SERVE_TOL = 8, 16, 1e-4
# the residency drill: the metered bytes against memory_allocated deltas
RESIDENCY_TOL = 0.10
# loads one bundle in a fresh process (argv: the port's src directory, the
# bundle) and prints the memory_allocated delta around the load beside
# the engine's metered bytes
RESIDENCY_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core.engine import InferenceEngine
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)
torch.cuda.synchronize()
m0 = torch.cuda.memory_allocated(dev)
eng = InferenceEngine.get(sys.argv[2], dev)
torch.cuda.synchronize()
print(json.dumps({"delta": torch.cuda.memory_allocated(dev) - m0,
                  "metered": eng.resident_nbytes, "route": eng.route}))
"""
# the tenancy drill: 2 tenants weighted 3:1, one key each, both kept
# backlogged for TENANT_ROUNDS rounds of one flush each (capacity for
# one key a round: overload), requests of TENANT_ROWS rows
TENANT_ROUNDS, TENANT_ROWS, TENANT_SHARE_TOL = 64, 256, 0.20
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
# the GQA LM slice: llama3.2-3b (src/repro/configs/archs.py:39-44) serving
# the same 4 prompts of 2,048 tokens and 33 tokens, attention on
# flash_attention; the kernel at its two shapes there: the causal
# prefill, and one decode step over the 2,081-position cache with 2,049
# valid keys (the first decode step of generate)
GQA_ARCH = "llama3.2-3b"
GQA_PREFILL = dict(b=LM_BATCH, sq=LM_PROMPT, skv=LM_PROMPT, causal=True,
                   q_offset=0, **LLAMA)
GQA_DECODE = dict(b=LM_BATCH, sq=1, skv=LM_PROMPT + LM_GEN, causal=False,
                  q_offset=0, **LLAMA)
GQA_DECODE_VALID = LM_PROMPT + 1
# the MLA LM slice: deepseek-v2-lite-16b (src/repro/configs/archs.py:86-94)
# at full width and depth serving the same prompts, its prefill attention
# on flash_attention at q.k 192 / v 128 (16 heads, no GQA); an f32 copy of
# its weights at depth 3, the dense prefix layer and 2 MoE layers (the
# whole model in f32 is 63 GB beside the bf16 one)
MLA_ARCH, MLA_F32_REPEATS = "deepseek-v2-lite-16b", 2
MLA_PREFILL = dict(b=LM_BATCH, sq=LM_PROMPT, skv=LM_PROMPT, causal=True,
                   q_offset=0, h=16, kv=16, hd=192, hdv=128)
# the MLA prefill's kernels by kind in its trace (the first match of a
# substring of the kernel's name)
PREFILL_KERNEL_GROUPS = {
    "attention": ("flash_attention_kernel", "flash_attention_bf16"),
    "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet"),
    "routing": ("index", "scatter", "gather", "scan", "topk", "sort",
                "radix", "one_hot"),
}
# the widened kernel against its plain version, f32 and bf16, at q.k 192
# and 256 over v 128 (MLA's head, and the widest tile)
WIDE_HEADS = ((192, 128), (256, 128))
# the jamba LM slice: jamba-v0.1-52b (src/repro/configs/archs.py:62-75)
# at full width and one period of its 8-layer pattern (7 Mamba layers, 1
# GQA layer, 4 MoE and 4 swiglu MLPs: 13.4 B parameters, where its 4
# periods would be 52 B, 104 GB in bf16), serving the same prompts; its
# selective scan at the prefill shape (B 4, S 2,048, d_inner 8,192,
# d_state 16); an f32 copy of the same weights, made leaf by leaf once the
# bf16 ones are freed (54 GB)
JAMBA_ARCH, JAMBA_REPEATS = "jamba-v0.1-52b", 1
JAMBA_SCAN = {"b": LM_BATCH, "s": LM_PROMPT, "di": 8192, "ds": 16,
              "dtype": "bfloat16"}
# the jamba prefill's kernels by kind in its trace
JAMBA_KERNEL_GROUPS = {
    "mamba_scan": ("mamba_scan_kernel",),
    "attention": ("flash_attention_kernel", "flash_attention_bf16"),
    "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet"),
    "routing": ("index", "scatter", "gather", "scan", "topk", "sort",
                "radix", "one_hot"),
}
# the kernel ops each MoE slice holds against their plain versions
MLA_PLAIN = ("flash_attention_op",)
JAMBA_PLAIN = ("flash_attention_op", "mamba_scan_op")
# the whisper LM slice: whisper-medium (src/repro/configs/archs.py:13-20)
# at full width and depth (24 encoder and 24 decoder layers) serving 4
# prompts of 384 tokens (serve_lm.ENC_DEC_PROMPT: 417 positions with the
# 33 generated, inside whisper's 448-token text context, and the cross
# prefill's 384 x 1,500 scores below the reference's switch to its
# chunked attention at 2,796 rows) over 4 x 1,500 seeded frames; the
# kernel at its four shapes (16 heads of 64, group 1): the causal
# encoder, the cross prefill, and the first decode step's self attention
# (385 of the 417 cached keys valid) and cross attention (all 1,500)
WHISPER_ARCH, WHISPER_PROMPT, WHISPER_FRAMES = "whisper-medium", 384, 1500
WHISPER_HEADS = dict(h=16, kv=16, hd=64)
WHISPER_ENCODER = dict(b=LM_BATCH, sq=WHISPER_FRAMES, skv=WHISPER_FRAMES,
                       causal=True, q_offset=0, **WHISPER_HEADS)
WHISPER_CROSS = dict(b=LM_BATCH, sq=WHISPER_PROMPT, skv=WHISPER_FRAMES,
                     causal=False, q_offset=0, **WHISPER_HEADS)
WHISPER_SELF_STEP = dict(b=LM_BATCH, sq=1, skv=WHISPER_PROMPT + LM_GEN,
                         causal=False, q_offset=0, **WHISPER_HEADS)
WHISPER_CROSS_STEP = dict(WHISPER_CROSS, sq=1)
# exp2 on the SFUs: 16 a clock an SM on Hopper (the CUDA programming
# guide's throughput table, compute capability 9.0); the rate is this
# times the SMs times the SM clock nvidia-smi reports as its maximum
SFU_EXP2_PER_CLOCK_SM = 16
MAMBA_DESIGN = ("2 lanes a channel, each 8 of its d_state states in "
                "registers; one ex2.approx.ftz a decay; blocks of 128 "
                "channels of one batch row; dt/x tiles and Bm/Cm rows (f32, "
                "converted once by the wrapper) of 32 steps staged by "
                "cp.async, double-buffered; two steps an iteration, y's "
                "sum in two interleaved chains a lane met by shfl_xor")
# f32 operations of one exp2 on the f32 pipe, for the joint bound: a
# Cody-Waite reduction and a degree-6 Horner polynomial (the clamp 2, the
# rounding and the reduced argument 3, six fused Horner steps 12, the
# scale 1; the integer work on the exponent field not counted).  The
# kernel keeps every exp on the SFUs: such a split measured slower
# (PERF.md §6, row 8), so the joint bound is a floor no kernel reaches
MAMBA_POLY_OPS = 18
# the mamba_scan cases check_mamba_scan holds beyond jamba's shapes:
# underflow (dt uniform up to 200: with make_call's A = -(1 .. ds), dt
# |A| log2(e) passes 127 on every state at more than half the steps, so
# those decays are 0, and at dt below 20 the states with |A| > 4.4
# underflow beside ones that do not) and d_state 8 (the second lane of
# each channel holds only padding)
MAMBA_UNDERFLOW_DT = 200.0
# f32 operations a state and step that the scan's gradient needs at
# least: the state recomputed (dt x Bm and a fused multiply-add, 3), g
# updated (a fused multiply-add, 2) and decayed (a g, which the step
# before takes, 1), q = (a g) h (1), and the sums of dA, du, ddt's A
# term, dBm and dCm (a fused multiply-add each, 10); beside them one exp2
# a state and step on the SFUs (each decay computed at least once)
MAMBA_BWD_OPS = 17
# the exp2 a state and step the kernel's design computes: the states
# recomputed from the forward's kept ones, then the decays again on the
# walk back
MAMBA_BWD_DESIGN_EXPS = 2
MAMBA_BWD_DESIGN = ("one reverse walk a block of 64 channels of a batch "
                    "row, chunks of 16 steps from the last, the cotangent "
                    "carried across chunks in registers (dhT to dh0); each "
                    "chunk's states recomputed in registers (4 lanes a "
                    "channel, 4 states each) from the state before it that "
                    "the forward kept under grad, then its cotangent walked "
                    "back, each step's sums one shuffle level deep into "
                    "shared memory and finished after the chunk (dx, ddt, "
                    "dBm/dCm over the block's channel pairs in order); "
                    "inputs staged by cp.async, double-buffered, the "
                    "boundary states prefetched into registers, two blocks "
                    "an SM; dBm/dCm over blocks and dA/dD over the batch by "
                    "an ordered sum kernel")
# the LM training slice: llama3.2-3b at full width and depth trained on
# one repeated TokenPipeline batch of 2 x 2,048 tokens, 4 steps past the
# warmup (policy full); attention's backward at that shape
LMT_ARCH, LMT_BATCH, LMT_SEQ, LMT_STEPS = "llama3.2-3b", 2, 2048, 4
LMT_AT_STEP = 1000
LMT_ATTN = dict(b=LMT_BATCH, sq=LMT_SEQ, skv=LMT_SEQ, causal=True,
                q_offset=0, **LLAMA)
# deepseek-v2-lite-16b trained the same way at full width, its depth cut
# from 27 layers to the dense first layer and 5 MoE layers (3.4 B
# parameters: with bf16 gradients and Adam's f32 state the whole model,
# 15.7 B, would need about 190 GB); attention's backward at its training
# shape, MLA's q.k 192 over v 128 (16 heads, no GQA)
DEEPSEEK_ARCH, DEEPSEEK_TRAIN_REPEATS = "deepseek-v2-lite-16b", 5
MLA_TRAIN_ATTN = dict(b=LMT_BATCH, sq=LMT_SEQ, skv=LMT_SEQ, causal=True,
                      q_offset=0, h=16, kv=16, hd=192, hdv=128)
# jamba-v0.1-52b trained at full width, its depth cut to slots 3-5 of its
# 8-layer period: (mamba, swiglu), (gqa, moe), (mamba, swiglu), 3.96 B
# parameters (one period, 13.3 B, would need about 160 GB with bf16
# gradients and Adam's f32 state); the smallest contiguous cut that keeps
# every kind of layer jamba has: Mamba mixers on mamba_scan, the GQA layer
# on flash_attention and its backward, a 16-expert top-2 MoE, swiglu MLPs
# and the learned positions the GQA layer brings
JAMBA_TRAIN_SLOTS = (3, 6)
# the selective scan at jamba's training shape (B 2, S 2,048, d_inner
# 8,192, d_state 16), where its backward runs once a Mamba layer a step
# and its forward twice (remat)
JAMBA_TRAIN_SCAN = {"b": LMT_BATCH, "s": LMT_SEQ, "di": 8192, "ds": 16,
                    "dtype": "bfloat16"}
# every leaf's gradient at full width and depth 2 with attention on the
# kernels against attention by the plain version (autograd of
# flash_attention_ref), each error over the leaf's largest magnitude:
# f32, the kernels' own differences (3xTF32 forward, f32 backward, about
# 1e-6 relative) through two layers and the loss: 1e-3; bf16, as the CPU
# tests hold the port's bf16 gradients to the reference's
# (tests/test_torch_train.py BF16_GRAD_TOL)
LMT_GRAD_TOL_F32, LMT_GRAD_TOL_BF16 = 1e-3, 5e-2
# the traced training step's kernels by kind (the first match of a
# substring of the kernel's name): attention's forward and backward
# kernels, cuBLAS's matrix products, and the rest (elementwise work of the
# model, the loss, the clip and AdamW)
STEP_KERNEL_GROUPS = {
    "attention_forward": ("flash_attention_kernel", "flash_attention_bf16"),
    "attention_backward": ("bwd_dq_kernel", "bwd_dkdv_kernel"),
    "wkv_forward": ("rwkv6_chunk_kernel",),
    "wkv_backward": ("rwkv6_bwd_",),
    "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet"),
}
# and, in a model with Mamba layers, the selective scan's kernels
SCAN_KERNEL_GROUPS = {
    "scan_forward": ("mamba_scan_kernel",),
    "scan_backward": ("mamba_bwd_",),
}
# rwkv6-1.6b trained the same way (4 steps at full width and depth, one
# repeated batch of 2 x 2,048 tokens, policy full); the WKV recurrence at
# its training shape (B 2, T 2,048, 32 heads of 64, f32: the mixer casts
# r, k, v to f32 and makes w in f32), where its backward runs once a layer
# a step and its forward twice (remat)
RWKV_TRAIN = {"b": LMT_BATCH, "t": LMT_SEQ, "h": 32, "hd": 64,
              "dtype": "float32"}
# every leaf's gradient at depth 2 with the recurrence on the kernels
# against the plain recurrence (autograd of rwkv6_chunk_ref), each error
# over the leaf's largest magnitude: f32 as for llama (1e-3); bf16 as the
# CPU tests hold rwkv6's bf16 gradients to the reference's
# (tests/test_torch_train.py RWKV6_BF16_GRAD_TOL: the reference's own bf16
# gradients lie 0.149 of the largest magnitude from its f32 ones)
RWKV_GRAD_TOL_BF16 = 0.15
# f32 operations per state element and step that the gradient needs: the
# state and its cotangent rebuilt (a product and a fused multiply-add
# each, 3 + 3) and four contractions over the head (dr, dk, dv, dw, 2
# each)
RWKV_BWD_OPS = 14
# the resume drill: the train_lm example's 20m preset, 60 steps, the
# simulated failure after 36 (60%)
DRILL_STEPS, DRILL_FAIL_AT = 60, 36
PEAK_F32_FLOPS = 67e12   # H100 SXM f32 outside the tensor cores
# H100 SXM TF32 tensor cores, dense: the fused_mlp and flash_attention
# kernels form each f32 product as three TF32 products (3xTF32), so their
# tensor-core bound is 3 x the operations at this rate
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
PEAK_F16_FLOPS = 989e12  # H100 SXM f16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12
# the products flash_attention_bwd.cu does: S for lse, then S, dO V^T and
# dS K in the dq kernel, S^T, dP^T, P^T dO and dS^T Q in the dkdv kernel
BWD_PRODUCTS = 8
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
FLASH_BF16_DESIGN = ("bf16 mma.sync m16n8k16: q.k once (q's A fragments "
                     "in registers for the key loop, scores scaled after), "
                     "P.V twice (p split in registers into bf16 hi + lo); "
                     "K/V bf16 in a two-stage cp.async ring, V by "
                     "ldmatrix.trans; prefill: a warp per 16 query rows, "
                     "4 or 8 warps a block; decode (at most 16 rows a kv "
                     "head): every q head of a kv head in one m16 tile, "
                     "keys split across blocks and 4 warps, partials "
                     "combined in ascending order by a second kernel")
# each flash_attention kernel's launches in a path's main run, by path
# (record_flash_launches)
FLASH_LAUNCHES = {}
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


def _tree_distance(a, b):
    """The L2 distance between two lists of per-layer parameter dicts."""
    import torch
    return float(torch.sqrt(sum(((x[k].double().cpu() - y[k].double().cpu())
                                 ** 2).sum() for x, y in zip(a, b) for k in x)))


def _first_batch_grads(X, Y, stats, dev):
    """The loss gradients of the seeded minibude net at its init on the
    first 128 normalized rows, as fit forms them, on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.nn import MLP
    net = MLP((1, 6), list(BUDE_HIDDEN), 1).init(0).to(dev)
    params = [p for layer in net.param_list() for p in layer.values()]
    xb = (X[:128] - np.asarray(stats["x_mu"], np.float32)) / np.asarray(
        stats["x_sd"], np.float32)
    yb = (Y[:128] - np.asarray(stats["y_mu"], np.float32)) / np.asarray(
        stats["y_sd"], np.float32)
    for p in params:
        p.requires_grad_(True)
    pred = net(torch.from_numpy(xb.astype(np.float32)).to(dev))
    loss = ((pred - torch.from_numpy(yb.astype(np.float32)).to(dev)) ** 2
            ).mean()
    return [g.cpu() for g in torch.autograd.grad(loss, params)]


def device_busy(fn, groups=None):
    """fn's result, its host seconds (ended by a sync) and the seconds of
    kernel time torch.profiler's CUDA activity records in them (None
    where the trace holds no device time).  With ``groups`` ({name:
    substrings}), also the kernel seconds by the first group one of whose
    substrings the kernel's name holds ("other" for none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) * 1e-6
    if groups is None:
        return out, wall, busy or None
    by = dict.fromkeys(list(groups) + ["other"], 0.0)
    for e in events:
        name = next((g for g, subs in groups.items()
                     if any(x in e.key for x in subs)), "other")
        by[name] += e.self_device_time_total * 1e-6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    by["top_kernels"] = [(e.key[:80], e.self_device_time_total * 1e-6,
                          e.count) for e in top]
    return out, wall, busy or None, by


def run_train_slice(dev, smi, work):
    """The paper's training side on the card: fit -> save -> serve for
    minibude at full width, the nested search for bonds, and the two CNN
    apps.  Returns the fused_mlp launches of its infer calls."""
    import numpy as np
    import torch
    from repro_torch.apps import bonds, minibude, miniweather, particlefilter
    from repro_torch.core import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.nas.nested import best_trial, nested_search, save_trial
    from repro_torch.nas.space import build_net
    from repro_torch.nas.train_surrogate import fit
    from repro_torch.nn import MLP, save_model

    t_phase = time.perf_counter()
    rtol, atol = ops.SPEC.tol
    fused_launches = 0

    def host_s(fn, *args, **kw):
        """fn's result and its host seconds, ended by a sync."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def served(bundle, x, y):
        """The region's rows ``y`` for ``x`` against the bundle's
        Sequential on the same normalized rows: (engine, max abs err,
        worst error over its allowance)."""
        eng = InferenceEngine.get(bundle, dev)
        with torch.no_grad():
            want = eng.net((x - eng.norm[0]) / eng.norm[1]) * eng.norm[3] \
                + eng.norm[2]
        y_sd = float(eng.norm[3].abs().max())
        return (eng,) + compare(y, want, rtol, atol * y_sd)

    # ---- minibude: collect, fit at full width, serve through fused_mlp
    part = "minibude"
    seconds = {}
    collect = minibude.make_region(TRAIN_POSES, "collect",
                                   database=str(work / "db"), device=dev)
    _, seconds["collect"] = host_s(collect, poses=minibude.make_inputs(
        TRAIN_POSES, seed=3, device=dev))
    rows = collect.db.group("minibude").load()
    X, Y = rows["inputs"], rows["outputs"]
    net = MLP((1, 6), list(BUDE_HIDDEN), 1)
    (_, val_rmse, stats), seconds["fit"] = host_s(
        fit, net, X, Y, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
        device=dev)
    n_train = int(X.shape[0] * 0.8)
    steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
    bundle = save_model(work / "minibude", net, extra=stats)
    poses = minibude.make_inputs(TRAIN_INFER, seed=4, device=dev)
    infer = minibude.make_region(TRAIN_INFER, "infer", model=bundle,
                                 device=dev)
    registry.reset_counts()
    _, seconds["infer_first"] = host_s(infer, poses=poses)
    y, seconds["infer"] = host_s(infer, poses=poses)
    y = y["out"]
    launches = registry.get_spec("fused_mlp").launches
    fused_launches += launches
    eng, max_abs, worst = served(bundle, poses, y)
    mape = minibude.qoi_error(minibude.energies(poses)[:, None], y)

    # one epoch on the card, profiled, and on the CPU from the same seed
    (p_card, rmse_card, _), epoch_s, busy_s = device_busy(
        lambda: fit(MLP((1, 6), list(BUDE_HIDDEN), 1), X, Y, epochs=1,
                    batch_size=TRAIN_BATCH, device=dev))
    (p_cpu, rmse_cpu, _), seconds["fit_cpu_epoch"] = host_s(
        fit, MLP((1, 6), list(BUDE_HIDDEN), 1), X, Y, epochs=1,
        batch_size=TRAIN_BATCH, device="cpu")
    # the spread a change of summation order alone makes: the same
    # epoch on one CPU thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (p_cpu1, rmse_cpu1, _), seconds["fit_cpu_epoch_one_thread"] = \
            host_s(fit, MLP((1, 6), list(BUDE_HIDDEN), 1), X, Y, epochs=1,
                   batch_size=TRAIN_BATCH, device="cpu")
    finally:
        torch.set_num_threads(threads)
    p_init = MLP((1, 6), list(BUDE_HIDDEN), 1).init(0).param_list()
    moved = _tree_distance(p_cpu, p_init)
    param_dist = _tree_distance(p_card, p_cpu) / moved
    cpu_spread = _tree_distance(p_cpu1, p_cpu) / moved
    g_card = _first_batch_grads(X, Y, stats, dev)
    g_cpu = _first_batch_grads(X, Y, stats, "cpu")
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(g_card, g_cpu))
    y_sd_mean = float(np.mean(stats["y_sd"]))
    checks = {
        "better_than_the_mean": val_rmse < y_sd_mean,
        "route_fused_mlp": eng.route == "fused_mlp",
        "fused_mlp_launched": launches >= 1,
        "matches_sequential": worst <= 1.0,
        "finite": bool(torch.isfinite(y).all()),
        "card_vs_cpu_params": param_dist <= TRAIN_PARAM_TOL,
        "card_vs_cpu_val_rmse": abs(rmse_card / rmse_cpu - 1)
        <= TRAIN_RMSE_RTOL,
        "card_vs_cpu_grads": grad_err <= TRAIN_GRAD_TOL,
    }
    emit("train_slice", part=part, widths=list(BUDE_WIDTHS),
         rows=int(X.shape[0]), epochs=TRAIN_EPOCHS, batch=TRAIN_BATCH,
         seconds=seconds, seconds_per_epoch=seconds["fit"] / TRAIN_EPOCHS,
         profiled_epoch={"seconds": epoch_s, "device_kernel_s": busy_s,
                         "device_busy_share": busy_s and busy_s / epoch_s},
         steps=steps, steps_per_s=steps / seconds["fit"], val_rmse=val_rmse,
         mean_y_sd=y_sd_mean, infer_rows=TRAIN_INFER,
         launches={"fused_mlp": launches}, route=eng.route,
         max_abs_err_vs_sequential=max_abs, surrogate_mape_pct=mape,
         card_vs_cpu={"param_distance_rel": param_dist,
                      "param_tol": TRAIN_PARAM_TOL,
                      "max_abs_param_diff": max(
                          float((a[k].cpu() - b[k]).abs().max())
                          for a, b in zip(p_card, p_cpu) for k in a),
                      "val_rmse_card": rmse_card, "val_rmse_cpu": rmse_cpu,
                      "grad_err_rel": grad_err, "cpu_threads": threads,
                      "cpu_one_thread_distance_rel": cpu_spread,
                      "val_rmse_cpu_one_thread": rmse_cpu1},
         nvidia_smi=smi, **checks)
    if not all(checks.values()):
        raise AssertionError(f"train_slice {part} checks failed: {checks}")

    # ---- bonds: the nested search on the card, then serve its pick
    part = "bonds"
    seconds = {}
    collect = bonds.make_region(SEARCH_ROWS, "collect",
                                database=str(work / "db"), device=dev)
    collect(bonds=bonds.make_inputs(SEARCH_ROWS, seed=1, device=dev))
    res, seconds["search"] = host_s(
        nested_search, bonds, collect.db.group("bonds"), outer_iters=4,
        inner_iters=2, epochs=5, verbose=False, device=dev)
    bt = best_trial(res)
    bundle = save_trial(bt, work / "bonds")
    x = bonds.make_inputs(TRAIN_INFER, seed=2, device=dev)
    infer = bonds.make_region(TRAIN_INFER, "infer", model=bundle, device=dev)
    registry.reset_counts()
    y, seconds["infer_first"] = host_s(infer, bonds=x)
    y = y["out"]
    launches = registry.get_spec("fused_mlp").launches
    fused_launches += launches
    eng, max_abs, worst = served(bundle, x, y)
    pure = not any(layer["kind"] == "dropout" for layer in eng.spec["layers"])
    checks = {
        "route_matches_purity": eng.route == ("fused_mlp" if pure
                                              else "sequential"),
        "launches_match_route": (launches >= 1) == pure,
        "matches_sequential": worst <= 1.0,
        "finite": bool(torch.isfinite(y).all()),
    }
    emit("train_slice", part=part, rows=SEARCH_ROWS, seconds=seconds,
         trials=[{"arch": t["arch"], "val_rmse": t["val_rmse"],
                  "latency_ms": t["latency"] * 1e3,
                  "hypers": t.get("hypers")} for t in res["trials"]],
         pareto=res["pareto"], best=res["trials"].index(bt),
         pure_mlp=pure, route=eng.route, launches={"fused_mlp": launches},
         max_abs_err_vs_sequential=max_abs,
         surrogate_rmse=bonds.qoi_error(bonds.accurate(x)["out"], y),
         nvidia_smi=smi, **checks)
    if not all(checks.values()):
        raise AssertionError(f"train_slice {part} checks failed: {checks}")

    # ---- miniweather: collect a trajectory, fit the CNN, interleave
    part = "miniweather"
    seconds = {}
    region = miniweather.make_region(mode="collect",
                                     database=str(work / "db"), device=dev)

    def trajectory():
        s = miniweather.init_state(device=dev)
        for _ in range(MW_STEPS):
            s = region(state=s)["state"]

    _, seconds["collect"] = host_s(trajectory)
    d = region.db.group("miniweather").load()
    X = d["inputs"].reshape(d["inputs"].shape[0], -1)
    Y = d["outputs"].reshape(d["outputs"].shape[0], -1)
    net = build_net(miniweather.surrogate_space(), MW_ARCH)
    (_, val_rmse, stats), seconds["fit"] = host_s(
        fit, net, X, Y, epochs=CNN_EPOCHS, x_reshape=(30, 30, 20),
        device=dev)
    bundle = save_model(work / "miniweather", net, extra=stats)
    region2 = miniweather.make_region(mode="predicated", model=bundle,
                                      device=dev)
    s0 = miniweather.init_state(device=dev)
    ref = miniweather.run(s0, MW_HORIZON)
    errs = {}
    for na, ns in ((0, 1), (1, 1), (1, 3)):
        approx, seconds[f"run_{na}:{ns}"] = host_s(
            miniweather.run, s0, MW_HORIZON, region2, (na, ns))
        errs[f"{na}:{ns}"] = miniweather.qoi_error(ref, approx)
    eng = InferenceEngine.get(bundle, dev)
    checks = {
        "route_sequential": eng.route == "sequential",
        "finite": all(np.isfinite(list(errs.values()))),
        "interleave_1:1_no_worse_than_0:1": errs["1:1"]
        <= errs["0:1"] + 1e-9,
    }
    emit("train_slice", part=part, rows=int(X.shape[0]), arch=MW_ARCH,
         epochs=CNN_EPOCHS, seconds=seconds, val_rmse=val_rmse,
         horizon=MW_HORIZON, qoi_error=errs, route=eng.route,
         nvidia_smi=smi, **checks)
    if not all(checks.values()):
        raise AssertionError(f"train_slice {part} checks failed: {checks}")

    # ---- particlefilter: collect the filter's estimates, fit the CNN
    part = "particlefilter"
    seconds = {}
    pf = particlefilter
    frames, _ = pf.make_video(PF_FRAMES, device=dev)
    region = pf.make_region(PF_FRAMES, "collect", database=str(work / "db"),
                            device=dev)
    _, seconds["collect"] = host_s(region, frames=frames.reshape(
        PF_FRAMES, -1))
    d = region.db.group("particlefilter").load()
    net = build_net(pf.surrogate_space(), PF_ARCH)
    (_, val_rmse, stats), seconds["fit"] = host_s(
        fit, net, d["inputs"], d["outputs"], epochs=CNN_EPOCHS,
        x_reshape=(pf.H, pf.W, 1), device=dev)
    bundle = save_model(work / "particlefilter", net, extra=stats)
    # a video the surrogate has not seen, through the filter and the CNN
    test_frames, truth = pf.make_video(PF_FRAMES, seed=1, device=dev)
    flat = test_frames.reshape(PF_FRAMES, -1)
    acc, seconds["accurate"] = host_s(pf.accurate, test_frames)
    infer = pf.make_region(PF_FRAMES, "infer", model=bundle, device=dev)
    sur, seconds["infer"] = host_s(infer, frames=flat)
    errs = {"surrogate": pf.qoi_error(truth, sur["loc"]),
            "accurate": pf.qoi_error(truth, acc["loc"])}
    eng = InferenceEngine.get(bundle, dev)
    checks = {"route_sequential": eng.route == "sequential",
              "finite": all(np.isfinite(list(errs.values())))}
    emit("train_slice", part=part, frames=PF_FRAMES, arch=PF_ARCH,
         epochs=CNN_EPOCHS, seconds=seconds, val_rmse=val_rmse,
         qoi_error_vs_truth=errs, route=eng.route, nvidia_smi=smi,
         **checks)
    if not all(checks.values()):
        raise AssertionError(f"train_slice {part} checks failed: {checks}")
    emit("train_slice", part="total", seconds=time.perf_counter() - t_phase,
         fused_mlp_launches=fused_launches, nvidia_smi=smi)
    return fused_launches


def minibude_regions(dev):
    """``region(key, n, mode, serving=None)``: minibude regions of n
    poses on ``dev``, made once per (key, n, mode, queue)."""
    from repro_torch.apps import minibude
    regions = {}

    def region(key, n, mode, serving=None):
        k = (key, n, mode, id(serving))
        if k not in regions:
            regions[k] = minibude.make_region(n, mode, model=key,
                                              serving=serving, device=dev)
        return regions[k]

    return region


def serve_work_items(key32, key8, dev):
    """The serve slice's requests: SERVE_THREADS lists of SERVE_REQUESTS
    (bundle, poses), row counts drawn with seed 7 from SERVE_ROWS, the
    f32 and the int8 minibude bundle alternating."""
    import numpy as np
    from repro_torch.apps import minibude
    rng = np.random.default_rng(7)
    return [[(key32 if (t + i) % 2 == 0 else key8,
              minibude.make_inputs(int(rng.choice(SERVE_ROWS)),
                                   seed=1000 * t + i, device=dev))
             for i in range(SERVE_REQUESTS)]
            for t in range(SERVE_THREADS)]


def serve_coalesced(queue, work_items, region, lanes=SERVE_THREADS):
    """Every request through ``queue``'s dispatcher (``infer_async``,
    no explicit flush), the threads' lists split over ``lanes`` submitter
    threads (1: one thread submits them all, then waits on each): the
    rows of each, and the host seconds, ended by a sync."""
    import threading
    import torch
    results = [[None] * SERVE_REQUESTS for _ in range(SERVE_THREADS)]
    errors = []

    def submitter(lane):
        try:
            mine = [(t, i) for t in range(SERVE_THREADS)
                    if t % lanes == lane for i in range(SERVE_REQUESTS)]
            handles = []
            for t, i in mine:
                key, x = work_items[t][i]
                handles.append(region(key, int(x.shape[0]),
                                      "infer_async", queue)(poses=x))
            for (t, i), h in zip(mine, handles):
                results[t][i] = h.result(60.0)["out"]
        except Exception as e:  # reported below: the phase fails
            errors.append(repr(e))

    threads = [threading.Thread(target=submitter, args=(lane,))
               for lane in range(lanes)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(120.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serve submitters failed: {errors}")
    return results, wall


def serve_one_at_a_time(work_items, region):
    """The same requests one at a time through synchronous ``infer``,
    after a warm pass (every row count's first call): their rows and
    the host seconds, ended by a sync."""
    import torch

    def run():
        return [[region(key, int(x.shape[0]), "infer")(poses=x)["out"]
                 for key, x in items] for items in work_items]

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_serve_slice(dev, smi, work):
    """The serving layer on the card through the port's entry points:
    coalesced serving from 8 threads against one-at-a-time synchronous
    serving, the two async app drivers, four fault drills, the trace,
    residency and tenancy.  Returns the fused_mlp and fused_mlp_int8
    launches of the coalesced run, and the plain coalesced run's rates,
    latencies and batches (the static policy's numbers)."""
    import collections
    import gc
    import numpy as np
    import torch
    from repro_torch.apps import binomial, minibude, miniweather
    from repro_torch.core import InferenceEngine
    from repro_torch.core.database import SurrogateDB
    from repro_torch.kernels import registry
    from repro_torch.obs import (CRITICAL, SHADOW, TRACER,
                                 request_coverage)
    from repro_torch.quant.calibrate import calibration_rows
    from repro_torch.quant.gate import gate_bundle
    from repro_torch.resilience import BREAKERS, FAULTS, BreakerPolicy
    from repro_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import (RESIDENCY, Batcher, FlushPolicy,
                                   ScratchPool, ServeQueue, TenantBoard,
                                   TenantSpec)

    t_phase = time.perf_counter()
    key32 = str(work / "bundle")
    key8 = str(work / "minibude" / "bundle")
    key_bin = str(work / "binomial" / "bundle")
    key_mw = str(work / "train" / "miniweather")
    # the int8 slice's fail drill left the minibude bundle failed: gate it
    # again at scale_mult 1 (its budget is still registered)
    gate = gate_bundle(key8, calibration_rows(
        SurrogateDB(str(work / "minibude" / "db")), "minibude"), device=dev)
    if gate["exact"] is not True:
        raise AssertionError(f"serve slice: int8 minibude gate {gate}")
    for key, route in ((key32, "fused_mlp"), (key8, "fused_mlp_int8"),
                       (key_bin, "fused_mlp")):
        if InferenceEngine.get(key, dev).route != route:
            raise AssertionError(f"serve slice: {key} not on {route}")

    region = minibude_regions(dev)

    # ---- 1. coalesced serving from 8 threads: once traced (NVTX ranges,
    # under torch.profiler for the card's busy share), once plain for the
    # rates and latencies
    work_items = serve_work_items(key32, key8, dev)
    total_rows = sum(int(x.shape[0]) for items in work_items
                     for _, x in items)
    pool = ScratchPool()

    def serve_queue():
        return ServeQueue(FlushPolicy(**SERVE_POLICY), device=dev,
                          batcher=Batcher(device=dev, scratch=pool))

    def coalesced(queue, lanes=SERVE_THREADS):
        return serve_coalesced(queue, work_items, region, lanes)

    warm = serve_queue().start()
    try:  # the first batches pay the pool's page-locked allocations
        coalesced(warm)
    finally:
        warm.close()
    traced_q = serve_queue().start()
    TRACER.clear()
    TRACER.enable(annotate=True)
    registry.reset_counts()
    try:
        (traced, traced_wall), _, busy = device_busy(
            lambda: coalesced(traced_q))
    finally:
        TRACER.disable()
        traced_q.close()
    launches = {s.name: s.launches for s in registry.all_specs()}
    events = TRACER.chrome_events()
    dropped = sum(TRACER.drop_counts().values())
    trace_path = work / "serve_trace.json"
    TRACER.export_chrome_trace(trace_path)
    TRACER.clear()
    lane_q = serve_queue().start()
    try:  # the same requests from one submitter thread
        one_lane, one_lane_wall = coalesced(lane_q, lanes=1)
    finally:
        lane_q.close()
    queue = serve_queue().start()
    try:
        results, wall = coalesced(queue)
    finally:
        queue.close()
    # the same run with the interpreter's thread switch interval cut from
    # 5 ms to 0.5 ms: the dispatcher waits for the GIL after each stream
    # sync it makes, at most one interval while the submitters run Python
    switch = sys.getswitchinterval()
    sys.setswitchinterval(SERVE_SWITCH_S)
    switch_q = serve_queue().start()
    try:
        switched, switched_wall = coalesced(switch_q)
    finally:
        switch_q.close()
        sys.setswitchinterval(switch)

    # the same requests one at a time, synchronously: the baseline, and
    # each request's rows to hold the coalesced ones against
    sync_out, sync_wall = serve_one_at_a_time(work_items, region)
    mismatched = sum(
        not all(torch.equal(r[t][i], sync_out[t][i])
                for r in (results, traced, one_lane, switched))
        for t in range(SERVE_THREADS) for i in range(SERVE_REQUESTS))
    snaps = {name: queue.stats(key).snapshot()
             for name, key in (("f32", key32), ("int8", key8))}
    names = collections.Counter(e["name"] for e in events)
    # host time by span over the traced run, and per batch
    span_ms = collections.Counter()
    for e in events:
        span_ms[e["name"]] += e.get("dur", 0.0) / 1e3
    n_batches = max(1, names["batch.apply"])
    traces = {e["args"]["trace"] for e in events
              if e["name"] == "queue.submit"}
    cov = request_coverage(events)
    per_request = [cov.get(tr, {}) for tr in traces]
    checks = {
        "bit_identical_to_sync": mismatched == 0,
        "fused_mlp_launched": launches["fused_mlp"] >= 1,
        "fused_mlp_int8_launched": launches["fused_mlp_int8"] >= 1,
        "every_request_completed": sum(
            s["requests_completed"] for s in snaps.values())
        == SERVE_THREADS * SERVE_REQUESTS,
        "no_failures": all(s["requests_failed"] == 0
                           for s in snaps.values()),
        "every_request_traced": len(traces)
        == SERVE_THREADS * SERVE_REQUESTS and dropped == 0,
        "every_request_covered": all(c.get("coverage", 0.0) >= 0.95
                                     and c.get("spans", 0) >= 2
                                     for c in per_request),
    }
    emit("serve_slice", part="coalesced", requests=SERVE_THREADS
         * SERVE_REQUESTS, threads=SERVE_THREADS, rows=total_rows,
         seconds=wall, rows_per_s=total_rows / wall,
         sync_seconds=sync_wall, sync_rows_per_s=total_rows / sync_wall,
         one_thread_seconds=one_lane_wall,
         one_thread_rows_per_s=total_rows / one_lane_wall,
         switch_interval_s={"default": switch, "cut": SERVE_SWITCH_S},
         switch_cut_seconds=switched_wall,
         switch_cut_rows_per_s=total_rows / switched_wall,
         coalescing_gain_x=sync_wall / wall,
         traced_seconds=traced_wall, device_busy_s=busy,
         device_busy_share=busy / traced_wall if busy else None,
         p50_ms={k: s["latency_p50_ms"] for k, s in snaps.items()},
         p99_ms={k: s["latency_p99_ms"] for k, s in snaps.items()},
         batches={k: s["batches"] for k, s in snaps.items()},
         mean_bucket_fill={k: s["batch_occupancy"]
                           for k, s in snaps.items()},
         flush_reasons={k: s["flush_reasons"] for k, s in snaps.items()},
         launches=launches, mismatched_requests=mismatched,
         span_counts=dict(sorted(names.items())),
         span_ms_total={k: round(v, 3) for k, v in sorted(span_ms.items())},
         span_ms_per_batch={k: round(span_ms[k] / n_batches, 4) for k in (
             "batch.gather", "batch.apply", "engine.apply", "batch.to_host",
             "batch.scatter")},
         min_coverage=min((c.get("coverage", 0.0) for c in per_request),
                          default=None),
         trace_events=len(events), trace_dropped=dropped,
         pool=pool.stats(), trace_file=str(
             trace_path.relative_to(ROOT)), policy=SERVE_POLICY,
         nvidia_smi=smi, **checks)
    if not all(checks.values()):
        raise AssertionError(f"serve slice coalesced checks: {checks}")
    static = {"rows_per_s": total_rows / wall,
              "sync_rows_per_s": total_rows / sync_wall,
              "coalescing_gain_x": sync_wall / wall,
              "p50_ms": {k: s["latency_p50_ms"] for k, s in snaps.items()},
              "p99_ms": {k: s["latency_p99_ms"] for k, s in snaps.items()},
              "batches": {k: s["batches"] for k, s in snaps.items()},
              "mean_bucket_fill": {k: s["batch_occupancy"]
                                   for k, s in snaps.items()}}

    # ---- 2. the async app drivers against their synchronous twins
    seconds = {}
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20,
                               max_pending_rows=1 << 20), device=dev)
    opts = binomial.make_inputs(BIN_OPTIONS, seed=11, device=dev)
    r_async = binomial.make_region(BIN_CHUNK, "infer_async", model=key_bin,
                                   serving=q, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = binomial.price_chunks_async(opts, r_async, q, chunk=BIN_CHUNK)
    torch.cuda.synchronize()
    seconds["price_chunks_async"] = time.perf_counter() - t0
    want = binomial.make_region(BIN_OPTIONS, "infer", model=key_bin,
                                device=dev)(opts=opts)["out"]
    bin_batches = q.stats(key_bin).snapshot()["batches"]
    states = [miniweather.init_state(seed=s, device=dev)
              for s in range(MW_ENSEMBLE)]
    mw_async = miniweather.make_region(mode="infer_async", model=key_mw,
                                       serving=q, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = miniweather.run_ensemble_async(states, MW_ENSEMBLE_STEPS,
                                          mw_async, q)
    torch.cuda.synchronize()
    seconds["run_ensemble_async"] = time.perf_counter() - t0
    mw_sync = miniweather.make_region(mode="infer", model=key_mw,
                                      device=dev)
    mw_err = 0.0
    for s0, got_s in zip(states, outs):
        ref = s0
        for _ in range(MW_ENSEMBLE_STEPS):
            ref = mw_sync(state=ref)["state"]
        mw_err = max(mw_err, float((got_s - ref).abs().max())
                     / float(ref.abs().max()))
    q.close()
    mw_snap = q.stats(key_mw).snapshot()
    checks = {
        "binomial_bit_equal": bool(torch.equal(got, want)),
        "binomial_one_batch": bin_batches == 1,
        "miniweather_within_tol": mw_err <= MW_SERVE_TOL,
        "miniweather_batch_per_step": mw_snap["batches"]
        == MW_ENSEMBLE_STEPS,
    }
    emit("serve_slice", part="async_apps", seconds=seconds,
         binomial={"options": BIN_OPTIONS, "chunk": BIN_CHUNK,
                   "batches": bin_batches,
                   "route": InferenceEngine.get(key_bin, dev).route},
         miniweather={"ensemble": MW_ENSEMBLE, "steps": MW_ENSEMBLE_STEPS,
                      "batches": mw_snap["batches"],
                      "max_rel_err": mw_err, "tol": MW_SERVE_TOL},
         nvidia_smi=smi, **checks)
    if not all(checks.values()):
        raise AssertionError(f"serve slice async app checks: {checks}")

    # ---- 3. fault drills, through REPRO_FAULTS plans in this process
    drills = {}
    x = minibude.make_inputs(256, seed=21, device=dev)
    accurate = minibude.accurate(x)["out"]
    sync32 = region(key32, 256, "infer")(poses=x)["out"]
    sync8 = region(key8, 256, "infer")(poses=x)["out"]
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20,
                               max_pending_rows=1 << 20), device=dev)
    retries = obs_metrics.counter("repro_resilience_retries_total",
                                  "dispatch attempts retried after a "
                                  "transient failure", ("key",))
    nonfinite = obs_metrics.counter("repro_resilience_nonfinite_total",
                                    "output rows screened as NaN/Inf "
                                    "before scatter", ("key",))
    fallbacks = obs_metrics.counter("repro_resilience_fallback_total",
                                    "requests routed to the accurate path "
                                    "by the breaker", ("key", "path"))
    try:
        # a raise at batcher.scatter, once: retried, rows unchanged
        os.environ["REPRO_FAULTS"] = "batcher.scatter:raise:n=1"
        FAULTS.configure(os.environ["REPRO_FAULTS"])
        before = retries.value(key=key32)
        hs = [region(key32, 256, "infer_async", q)(poses=x)
              for _ in range(3)]
        q.flush(key32)
        outs = [h.result(30.0)["out"] for h in hs]
        drills["scatter_raise"] = {
            "retried": retries.value(key=key32) - before == 1,
            "rows_bit_identical": all(torch.equal(o, sync32)
                                      for o in outs),
            "fired": FAULTS.rules[0].snapshot()["fires"] == 1}

        # NaN out of the int8 engine: screened, the accurate path serves,
        # the breaker opens, serves the accurate path at once, then its
        # HALF_OPEN probes close it after the cooldown (injected clock)
        now = [0.0]
        brk = BREAKERS.configure(key8, BreakerPolicy(
            min_samples=2, open_cooldown_s=0.2, probe_n=2, probe_every=1),
            clock=lambda: now[0])
        os.environ["REPRO_FAULTS"] = (
            f"engine.apply:nan:key={pathlib.Path(key8).parent.name}/bundle")
        FAULTS.configure(os.environ["REPRO_FAULTS"])
        screened0 = nonfinite.value(key=key8)
        fallback0 = fallbacks.value(key=key8, path="result")
        h = region(key8, 256, "infer_async", q)(poses=x)
        deferred = h.deferred()
        q.flush(key8)
        fell_back = torch.equal(h.result(30.0)["out"], accurate)
        screened = nonfinite.value(key=key8) - screened0 == 256
        counted = fallbacks.value(key=key8, path="result") - fallback0 == 1
        opened = brk.state == OPEN
        h = region(key8, 256, "infer_async", q)(poses=x)
        at_once = (not h.deferred()) and h.done() and torch.equal(
            h.result()["out"], accurate)
        FAULTS.clear()
        now[0] += 0.25
        probes = []
        for _ in range(2):
            h = region(key8, 256, "infer_async", q)(poses=x)
            probes.append(brk.state == HALF_OPEN and h.deferred())
            q.flush(key8)
            probes.append(torch.equal(h.result(30.0)["out"], sync8))
        drills["int8_nan"] = {
            "deferred": deferred, "screened": screened,
            "result_fell_back_to_accurate": fell_back,
            "fallback_counted": counted, "breaker_open": opened,
            "open_serves_accurate_at_once": at_once,
            "half_open_probes_served": all(probes),
            "breaker_closed": brk.state == CLOSED}

        # corrupted f32 weights under shadow scoring at rate 1: the
        # scorer's RMSE is the served rows' against the accurate path,
        # the alert reaches CRITICAL and the closed breaker trips on it
        clean_rmse = float(np.sqrt(np.mean(
            (sync32.double() - accurate.double()).cpu().numpy() ** 2)))
        brk32 = BREAKERS.configure(key32, BreakerPolicy(
            open_cooldown_s=60.0))
        SHADOW.reset()
        SHADOW.set_budget(key32, 2.0 * clean_rmse)
        SHADOW.enable(rate=1.0)
        os.environ["REPRO_FAULTS"] = (
            f"engine.apply:corrupt:key={key32},n=1,scale=0.5")
        FAULTS.configure(os.environ["REPRO_FAULTS"])
        served = []
        for i in range(4):
            h = region(key32, 256, "infer_async", q)(poses=x)
            q.flush(key32)
            served.append(h.result(30.0)["out"])
            if i == 0:
                SHADOW.flush(30.0)
                first = SHADOW.snapshot()["keys"][key32]["rmse_ewma"]
        SHADOW.flush(30.0)
        direct = float(np.sqrt(np.mean(
            (served[0].double() - accurate.double()).cpu().numpy() ** 2)))
        state = SHADOW.state(key32)
        allowed = BREAKERS.allow(key32)
        drills["f32_corrupt"] = {
            "served_rows_moved": not torch.equal(served[0], sync32),
            "rmse_past_budget": direct > 2.0 * clean_rmse,
            "scorer_rmse_matches": abs(first - direct) <= 1e-6 * direct,
            "critical": state == CRITICAL,
            "breaker_tripped_on_quality": (not allowed)
            and brk32.state == OPEN}
        drills["f32_corrupt_rmse"] = {"clean": clean_rmse,
                                      "scorer": first, "direct": direct}
    finally:
        os.environ.pop("REPRO_FAULTS", None)
        FAULTS.clear()
        SHADOW.close(drain=True)
        SHADOW.reset()
        BREAKERS.reset()
        q.close()
        InferenceEngine.invalidate(key32)  # reload the clean weights
    checks = {f"{d}.{k}": v for d, r in drills.items()
              for k, v in r.items() if isinstance(v, bool)}
    emit("serve_slice", part="fault_drills", drills=drills, nvidia_smi=smi,
         **checks)
    if not all(checks.values()):
        raise AssertionError(f"serve slice fault drills: {checks}")

    # ---- 4. residency: a budget below the three bundles' sum
    loads = collections.Counter()
    orig_load = InferenceEngine._load

    def counted(self):
        loads[self.path] += 1
        return orig_load(self)

    InferenceEngine.invalidate()
    RESIDENCY.set_budget(None)
    keys = (key32, key8, key_bin)
    # the meter against memory_allocated, each bundle loaded in a fresh
    # process: in this one, after the earlier phases, the allocator hands
    # a free 2 MB block whole to a 1.2 MB request and counts it whole
    # (on an H100, 40% over the binomial bundle's tensors)
    probes = [subprocess.Popen(
        [sys.executable, "-c", RESIDENCY_PROBE, str(ROOT / "src"), key],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for key in keys]
    fresh = {}
    for key, probe in zip(keys, probes):
        out, err = probe.communicate(timeout=300)
        if probe.returncode:
            raise AssertionError(f"residency probe failed: {err[-2000:]}")
        fresh[key] = json.loads(out.strip().splitlines()[-1])
    metered, deltas = {}, {}
    InferenceEngine._load = counted
    try:
        for key in keys:
            gc.collect()  # engines dropped earlier must not free in here
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated(dev)
            eng = InferenceEngine.get(key, dev)
            torch.cuda.synchronize()
            deltas[key] = torch.cuda.memory_allocated(dev) - m0
            metered[key] = eng.resident_nbytes
            del eng
        budget = sum(metered.values()) - 1
        InferenceEngine.invalidate()
        RESIDENCY.set_budget(budget)
        RESIDENCY.reset_stats()
        loads.clear()
        for key in keys:
            InferenceEngine.get(key, dev)
        evicted_after_three = RESIDENCY.snapshot()["evictions"]
        lru = list(RESIDENCY.resident())
        loads.clear()
        y_again = [region(key32, 256, "infer")(poses=x)["out"]
                   for _ in range(3)]
        reloads = loads[key32]
        snap = RESIDENCY.snapshot()
    finally:
        InferenceEngine._load = orig_load
        RESIDENCY.set_budget(None)
        RESIDENCY.reset_stats()
    checks = {
        "one_eviction": evicted_after_three == 1 and key32 not in lru,
        "evicted_reloads_once": reloads == 1,
        "reloaded_rows_bit_identical": all(torch.equal(y, sync32)
                                           for y in y_again),
        "metered_within_10pct": all(
            abs(metered[k] - fresh[k]["delta"])
            <= RESIDENCY_TOL * fresh[k]["delta"] for k in keys),
        "fresh_process_metered_alike": all(
            fresh[k]["metered"] == metered[k] for k in keys),
    }
    emit("serve_slice", part="residency", budget_bytes=budget,
         metered_bytes=metered,
         allocated_delta_bytes={k: v["delta"] for k, v in fresh.items()},
         allocated_delta_bytes_here=deltas,
         evictions_after_three_loads=evicted_after_three,
         evictions_total=snap["evictions"], reloads_of_evicted=reloads,
         **checks)
    if not all(checks.values()):
        raise AssertionError(f"serve slice residency checks: {checks}")

    # ---- 5. tenancy: weights 3:1 under overload, one flush a round
    board = TenantBoard([TenantSpec("heavy", weight=3.0),
                         TenantSpec("light", weight=1.0)])
    per_key = 4 * TENANT_ROWS
    q = ServeQueue(FlushPolicy(max_batch_rows=per_key + per_key // 2,
                               max_pending_rows=1 << 20),
                   tenancy=board, device=dev)
    tenant_key = {"heavy": key32, "light": key8}
    xs = minibude.make_inputs(TENANT_ROWS, seed=31, device=dev)
    futs = []
    try:
        for _ in range(TENANT_ROUNDS):
            for tenant, key in tenant_key.items():
                while q.depth(key) < per_key:
                    futs.append(q.submit(key, xs, tenant=tenant))
            q.flush(q._flush_order()[0], reason="tenancy")
        served = {t: s["served_rows"] for t, s in board.snapshot().items()}
    finally:
        q.close(drain=True)
    for f in futs:
        f.result(30.0)
    snap = board.snapshot()
    share = served["heavy"] / max(1, served["heavy"] + served["light"])
    checks = {"heavy_share_within_20pct":
              abs(share / 0.75 - 1.0) <= TENANT_SHARE_TOL}
    emit("serve_slice", part="tenancy", rounds=TENANT_ROUNDS,
         served_rows_under_overload=served, heavy_share=share,
         p99_ms={t: s["latency_p99_ms"] for t, s in snap.items()},
         **checks)
    if not all(checks.values()):
        raise AssertionError(f"serve slice tenancy checks: {checks}")
    emit("serve_slice", part="total", seconds=time.perf_counter() - t_phase,
         launches=launches, nvidia_smi=smi)
    return launches, static


def host_seconds(eng, x, calls):
    """Host seconds of ``calls`` calls of ``eng.apply_batched(x)``, each
    ended by a sync."""
    import torch
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        eng.apply_batched(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def http_get(url):
    """(status, body) of one GET, error statuses included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def run_control_slice(dev, smi, work, static):
    """The serving layer's control plane on the card, over the serve
    slice's bundles and requests, one line per part: the dispatch floor,
    the controller's latency model against measured batch times, serving
    through the adaptive flush controller (and a low-rate leg), the drift
    re-sweep drill and the obs endpoint.  Returns the fused_mlp and
    fused_mlp_int8 launches of the adaptive run."""
    import contextlib
    import io
    import statistics
    import threading
    import torch
    import repro_torch.tune.cache as tcache
    from repro_torch.apps import minibude
    from repro_torch.core import InferenceEngine
    from repro_torch.kernels import registry
    from repro_torch.obs import ObsServer, metrics_report, pod_snapshot
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import validate_exposition
    from repro_torch.serve import Batcher, FlushPolicy, ScratchPool, ServeQueue
    from repro_torch.tune import AdaptiveFlushController
    from repro_torch.tune.controller import DISPATCH_FLOOR_S
    from repro_torch.tune.resweep import get_resweeper

    t_phase = time.perf_counter()
    keys = {"f32": str(work / "bundle"),
            "int8": str(work / "minibude" / "bundle")}
    engines = {t: InferenceEngine.get(k, dev) for t, k in keys.items()}
    for tier, route in (("f32", "fused_mlp"), ("int8", "fused_mlp_int8")):
        if engines[tier].route != route:
            raise AssertionError(f"control slice: {tier} not on {route}")
    decisions = obs_metrics.counter(
        "repro_controller_decisions_total",
        "adaptive flush decisions by latency-model source",
        ("key", "source"))
    sources = ("measured", "corrected", "roofline")

    def decided():
        return {t: {s: decisions.value(key=k, source=s) for s in sources}
                for t, k in keys.items()}

    # ---- 1. the dispatch floor: a warm apply_batched of 8 rows
    floor = {}
    for tier, eng in engines.items():
        x = minibude.make_inputs(FLOOR_ROWS, seed=41, device=dev)
        host_seconds(eng, x, 20)
        times = sorted(host_seconds(eng, x, FLOOR_CALLS))
        floor[tier] = {"median_s": statistics.median(times),
                       "p10_s": times[len(times) // 10],
                       "p90_s": times[(9 * len(times)) // 10]}
    emit("control_slice", part="floor", rows=FLOOR_ROWS, calls=FLOOR_CALLS,
         floor=floor, code_default_s=DISPATCH_FLOOR_S, nvidia_smi=smi)

    # ---- 2. the controller's batch-latency model at its defaults
    prior = AdaptiveFlushController(FlushPolicy(**SERVE_POLICY))
    model = []
    for tier, eng in engines.items():
        widths = prior._widths_cached(keys[tier])
        for b in MODEL_BUCKETS:
            x = minibude.make_inputs(b, seed=43, device=dev)
            host_seconds(eng, x, 3)
            meas = statistics.median(host_seconds(eng, x, MODEL_CALLS))
            pred = prior.predict_latency_s(widths, b)
            model.append({"tier": tier, "bucket": b,
                          "measured_ms": meas * 1e3,
                          "predicted_ms": pred * 1e3,
                          "err_pct": (pred - meas) / meas * 100.0})
    emit("control_slice", part="model", calls=MODEL_CALLS, rows=model,
         peak_flops=prior.peak_flops, hbm_bw=prior.hbm_bw,
         overhead_s=prior.overhead_s, nvidia_smi=smi)

    # ---- 3. the serve slice's requests through the adaptive controller
    region = minibude_regions(dev)
    work_items = serve_work_items(keys["f32"], keys["int8"], dev)
    total_rows = sum(int(x.shape[0]) for items in work_items
                     for _, x in items)
    sync_out, sync_wall = serve_one_at_a_time(work_items, region)
    policy = FlushPolicy(**SERVE_POLICY)
    pool = ScratchPool()
    delays = []

    def adaptive_queue():
        ctrl = AdaptiveFlushController(policy)
        decide = ctrl.delay_for

        def recorded(key, stats):  # every deadline the queue is given
            d = decide(key, stats)
            delays.append(d)
            return d

        ctrl.delay_for = recorded
        return ServeQueue(policy, controller=ctrl, device=dev,
                          batcher=Batcher(device=dev, scratch=pool)), ctrl

    warm, _ = adaptive_queue()
    warm.start()
    try:  # the pool's page-locked buffers, as the serve slice warms
        serve_coalesced(warm, work_items, region)
    finally:
        warm.close()
    delays.clear()
    queue, ctrl = adaptive_queue()
    queue.start()
    try:
        before = decided()
        registry.reset_counts()
        results, wall = serve_coalesced(queue, work_items, region)
        launches = {s.name: s.launches for s in registry.all_specs()}
        after = decided()
        by_source = {t: {s: after[t][s] - before[t][s] for s in sources}
                     for t in keys}
        mismatched = sum(
            not torch.equal(results[t][i], sync_out[t][i])
            for t in range(SERVE_THREADS) for i in range(SERVE_REQUESTS))
        snaps = {t: queue.stats(k).snapshot() for t, k in keys.items()}
        last = {t: ctrl.last_decision.get(k, {}) for t, k in keys.items()}
        lo, hi = ctrl.min_delay_s, policy.max_delay_s
        checks = {
            "bit_identical_to_sync": mismatched == 0,
            "fused_mlp_launched": launches["fused_mlp"] >= 1,
            "fused_mlp_int8_launched": launches["fused_mlp_int8"] >= 1,
            "every_request_completed": sum(
                s["requests_completed"] for s in snaps.values())
            == SERVE_THREADS * SERVE_REQUESTS,
            "every_delay_within_bounds": bool(delays) and all(
                d is not None and lo <= d <= hi for d in delays)
            and all(d and lo <= d["delay_s"] <= hi for d in last.values()),
            "measured_or_corrected_seen": all(
                n["measured"] + n["corrected"] > 0
                for n in by_source.values()),
        }
        emit("control_slice", part="adaptive",
             requests=SERVE_THREADS * SERVE_REQUESTS, rows=total_rows,
             seconds=wall, rows_per_s=total_rows / wall,
             sync_rows_per_s=total_rows / sync_wall,
             coalescing_gain_x=sync_wall / wall,
             vs_static_x=total_rows / wall / static["rows_per_s"],
             p50_ms={t: s["latency_p50_ms"] for t, s in snaps.items()},
             p99_ms={t: s["latency_p99_ms"] for t, s in snaps.items()},
             batches={t: s["batches"] for t, s in snaps.items()},
             mean_bucket_fill={t: s["batch_occupancy"]
                               for t, s in snaps.items()},
             flush_reasons={t: s["flush_reasons"] for t, s in snaps.items()},
             decisions_by_source=by_source, decisions=len(delays),
             delay_s={"min": min(delays), "max": max(delays),
                      "median": statistics.median(delays)},
             last_decision=last, static=static, launches=launches,
             mismatched_requests=mismatched, policy=SERVE_POLICY,
             nvidia_smi=smi, **checks)
        if not all(checks.values()):
            raise AssertionError(f"control slice adaptive checks: {checks}")

        # a low arrival rate: one request of 7 rows every 5 ms from one
        # thread, under a 50 ms static deadline, with and without the
        # controller
        x = minibude.make_inputs(LOW_RATE_ROWS, seed=47, device=dev)
        want = region(keys["f32"], LOW_RATE_ROWS, "infer")(poses=x)["out"]
        low = {}
        for leg in ("static", "adaptive"):
            pol = FlushPolicy(**LOW_RATE_POLICY)
            q = ServeQueue(pol, device=dev, controller=(
                AdaptiveFlushController(pol) if leg == "adaptive" else None))
            q.start()
            r = region(keys["f32"], LOW_RATE_ROWS, "infer_async", q)
            try:
                handles = []
                t_next = time.perf_counter()
                for _ in range(LOW_RATE_REQUESTS):
                    handles.append(r(poses=x))
                    t_next += LOW_RATE_GAP_S
                    time.sleep(max(0.0, t_next - time.perf_counter()))
                outs = [h.result(30.0)["out"] for h in handles]
            finally:
                q.close()
            s = q.stats(keys["f32"]).snapshot()
            low[leg] = {"p50_ms": s["latency_p50_ms"],
                        "p99_ms": s["latency_p99_ms"],
                        "batches": s["batches"],
                        "bit_identical": all(torch.equal(o, want)
                                             for o in outs)}
        checks = {f"{leg}_bit_identical": v["bit_identical"]
                  for leg, v in low.items()}
        emit("control_slice", part="low_rate", requests=LOW_RATE_REQUESTS,
             rows=LOW_RATE_ROWS, gap_s=LOW_RATE_GAP_S, legs=low,
             policy=LOW_RATE_POLICY, nvidia_smi=smi, **checks)
        if not all(checks.values()):
            raise AssertionError(f"control slice low-rate checks: {checks}")

        # ---- 4. the drift re-sweep: an untuned bucket sustained by both
        # bundles, swept in the background while serving goes on
        saved = dict(tcache._default)
        for k in ("fused_mlp", "fused_mlp_int8"):
            tcache._default[k] = tcache.TuneCache(
                k, path=work / "resweep_tune" / f"{k}.json")
        resweeps = obs_metrics.counter(
            "repro_tune_resweep_total",
            "drift-triggered background kernel sweeps completed",
            ("kernel",))
        dispatches = obs_metrics.counter(
            "repro_kernel_dispatch_total",
            "kernel dispatches by resolved-params provenance and precision "
            "tier", ("kernel", "provenance", "tier"))
        kernels = {"f32": "fused_mlp", "int8": "fused_mlp_int8"}
        swept0 = {k: resweeps.value(kernel=k) for k in kernels.values()}
        x = minibude.make_inputs(RESWEEP_ROWS, seed=53, device=dev)
        rs = get_resweeper()
        rs.reset()
        rs.enable(after=RESWEEP_AFTER)
        q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20,
                                   max_pending_rows=1 << 20), device=dev)

        def serve(key):
            f = q.submit(key, x)
            q.flush(key)
            return f.result(60.0)

        try:
            outs = {t: [serve(k) for _ in range(RESWEEP_AFTER - 1)]
                    for t, k in keys.items()}
            t0 = time.perf_counter()
            for t, k in keys.items():  # each bundle's trigger batch
                outs[t].append(serve(k))
            during = 0
            while rs._pending and time.perf_counter() - t0 < 120.0:
                for t, k in keys.items():
                    outs[t].append(serve(k))
                during += 1
            flushed = rs.flush(120.0)
            sweep_s = time.perf_counter() - t0
            tuned0 = {t: dispatches.value(kernel=kernels[t],
                                          provenance="tuned", tier=t)
                      for t in keys}
            tuned = {t: serve(k) for t, k in keys.items()}
            served_tuned = {t: dispatches.value(
                kernel=kernels[t], provenance="tuned", tier=t) - tuned0[t]
                for t in keys}
        finally:
            rs.disable()
            rs.reset()
            q.close()
            records = {k: tcache._default[k].entries()
                       for k in kernels.values()}
            tcache._default.clear()
            tcache._default.update(saved)
        swept = {k: resweeps.value(kernel=k) - swept0[k]
                 for k in kernels.values()}
        checks = {
            "flushed": flushed,
            "records_exact": all(len(r) == 1 and all(
                v["exact"] for v in r.values()) for r in records.values()),
            "records_at_bucket": all(
                key.endswith(f"|cuda|b{RESWEEP_BUCKET}")
                for r in records.values() for key in r),
            "resweep_counted_once": swept == {k: 1 for k in swept},
            "rows_unchanged_during_sweep": all(
                torch.equal(o, v[0]) for v in outs.values() for o in v),
            "next_dispatch_tuned": served_tuned == {t: 1 for t in keys},
            "tuned_rows_bit_identical": all(
                torch.equal(tuned[t], outs[t][0]) for t in keys),
        }
        emit("control_slice", part="resweep", after=RESWEEP_AFTER,
             rows=RESWEEP_ROWS, bucket=RESWEEP_BUCKET, sweep_seconds=sweep_s,
             batches_during_sweep=2 * during, resweeps=swept,
             records={k: {key: {"winner": v["params"], "us": v["us"],
                                "default_us": v["default_us"],
                                "speedup_x": v["speedup_x"],
                                "exact": v["exact"]}
                          for key, v in r.items()}
                      for k, r in records.items()},
             nvidia_smi=smi, **checks)
        if not all(checks.values()):
            raise AssertionError(f"control slice resweep checks: {checks}")

        # ---- 5. the obs endpoint watching the adaptive queue
        server = ObsServer(port=0).start().watch_queue("adaptive", queue)
        hook = threading.excepthook
        try:
            code_metrics, text = http_get(server.url("/metrics"))
            exposition = validate_exposition(text)
            live, live_body = http_get(server.url("/healthz"))
            varz = json.loads(http_get(server.url("/varz"))[1])
            tracez = json.loads(http_get(server.url("/tracez"))[1])

            def stopped():
                raise RuntimeError("dispatcher stopped by the drill")

            # the dispatcher dies: readiness must flip and name the queue
            threading.excepthook = lambda args: None
            queue._due_locked = stopped
            with queue._cv:
                queue._cv.notify_all()
            queue._thread.join(30.0)
            dead, dead_body = http_get(server.url("/healthz"))
        finally:
            threading.excepthook = hook
            server.stop()
    finally:
        queue.close()
    snap_path = work / "control_metrics.json"
    snap_path.write_text(json.dumps(pod_snapshot(), default=str))
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        report_rc = metrics_report.main(["--metrics", str(snap_path),
                                         "--json"])
    quantiles = json.loads(report.getvalue())["snapshots"][0][
        "histogram_quantiles"]
    latency_rows = quantiles.get("repro_serve_request_latency_seconds", [])
    demo = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.server", "--demo",
         "--self-check"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    families = ("repro_controller_decisions_total",
                "repro_tune_resweep_total",
                "repro_serve_request_latency_seconds",
                "repro_serve_batches_total",
                "repro_serve_rows_completed_total")
    checks = {
        "metrics_valid": code_metrics == 200
        and exposition["samples"] > 0,
        "metrics_families": all(f in exposition["families"]
                                for f in families),
        "healthz_live_200": live == 200
        and json.loads(live_body)["queues"] == {"adaptive": True},
        "healthz_dead_503": dead == 503
        and "queue:adaptive" in json.loads(dead_body)["critical"],
        "varz_parses": set(keys.values())
        <= set(varz["queues"]["adaptive"]["keys"]),
        "tracez_parses": "events" in tracez,
        "report_quantiles": report_rc == 0 and len(latency_rows) >= 2
        and all(r["p50"] is not None and r["p99"] is not None
                for r in latency_rows),
        "demo_self_check": demo.returncode == 0
        and "self-check ok" in demo.stdout,
    }
    emit("control_slice", part="endpoint",
         samples=exposition["samples"],
         families=len(exposition["families"]),
         healthz={"live": live, "dead": dead},
         dead_critical=json.loads(dead_body)["critical"],
         report_latency_quantiles=[
             {k: r[k] for k in ("labels", "count", "p50", "p90", "p99")}
             for r in latency_rows],
         demo=demo.stdout.strip().splitlines()[-1:] or demo.stderr[-2000:],
         **checks)
    if not all(checks.values()):
        raise AssertionError(f"control slice endpoint checks: {checks}")
    emit("control_slice", part="total",
         seconds=time.perf_counter() - t_phase, launches=launches,
         nvidia_smi=smi)
    return launches


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
    """Seeded q [B, Sq, H, hd], k [B, Skv, KV, hd] and v [B, Skv, KV,
    hdv] (hdv = hd unless the shape names it) on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dtype = dtype or torch.float32

    def t(*dims):
        return torch.randn(dims, generator=g).to(device=dev, dtype=dtype)
    return (t(shape["b"], shape["sq"], shape["h"], shape["hd"]),
            t(shape["b"], shape["skv"], shape["kv"], shape["hd"]),
            t(shape["b"], shape["skv"], shape["kv"],
              shape.get("hdv", shape["hd"])))


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


def flash_kernel_launches():
    """Each flash_attention kernel's launches since the counts were last
    reset, by its wrapper's name."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    return {f.__name__: f.launches for f in fa.KERNELS}


def record_flash_launches(path):
    """Keep the flash_attention kernels' launches of ``path``'s main run
    (read right after it) for the ``kernels`` line."""
    FLASH_LAUNCHES[path] = flash_kernel_launches()
    return FLASH_LAUNCHES[path]


def check_flash(dev):
    """flash_attention (through its op) against its plain version at the
    spec's tolerance (bf16 outputs one bf16 ulp), each case in f32 and in
    bf16: both default problems, non-causal, GQA groups 1 and 3,
    kv_valid_len including 0, the llama3.2-3b prefill, the widened kernel
    at q.k 192 and 256 over v 128 (``WIDE_HEADS``) causal over 512 keys
    with 16 heads and at 192 / 128 with ``kv_valid_len`` 300, the
    decode shapes (Sq 1 over the llama3.2-3b step's 2,081 keys with 2,049
    valid at GQA groups 1, 3 and 4, none valid, Sq x group 16 and 17, MLA's
    192 / 128 at Sq 1), and whisper's (hd 64, group 1): its causal
    encoder over 1,500 frames, its cross prefill of 384 rows over them
    and a cross step over all of them.  bf16 calls launch the bf16 kernels (the decode
    kernel and its combine at most 16 rows a kv head), never the f32
    design, and a relaunch gives the same bits."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rtol, atol = ops.TOL
    d0, d1 = ops.SPEC.default_problems
    small = dict(b=2, sq=200, skv=333, h=8, kv=2, hd=64)
    step = dict(GQA_DECODE, causal=False)
    shapes = [
        ("default prefill", d0, {}),
        ("default decode", d1, {}),
        ("non-causal", small, {"causal": False}),
        ("group 1", dict(small, h=4, kv=4), {}),
        ("group 3, hd 96", dict(small, h=6, kv=2, hd=96), {}),
        ("kv_valid_len 0", small, {"kv_valid_len": 0}),
        ("kv_valid_len 0, non-causal", small,
         {"kv_valid_len": 0, "causal": False}),
        ("kv_valid_len 150", small, {"kv_valid_len": 150}),
        ("q_offset 133", dict(small, sq=200), {"q_offset": 133}),
        ("llama3.2-3b prefill 4096", PREFILL, {}),
        ("decode step, group 3", step, {"kv_valid_len": GQA_DECODE_VALID}),
        ("decode step, group 1", dict(step, h=8),
         {"kv_valid_len": GQA_DECODE_VALID}),
        ("decode step, group 4", dict(step, h=32),
         {"kv_valid_len": GQA_DECODE_VALID}),
        ("decode step, kv_valid_len 0", step, {"kv_valid_len": 0}),
        ("Sq x group 16", dict(small, sq=4, h=8, kv=2, skv=300),
         {"q_offset": 296}),
        ("Sq x group 17", dict(small, sq=17, h=2, kv=2, skv=300),
         {"q_offset": 283}),
        ("q.k 192 / v 128 decode step", dict(step, h=16, kv=16, hd=192,
                                             hdv=128),
         {"kv_valid_len": GQA_DECODE_VALID}),
    ]
    wide = dict(b=2, sq=512, skv=512, h=16, kv=16)
    shapes += [(f"q.k {hd} / v {hdv}", dict(wide, hd=hd, hdv=hdv), {})
               for hd, hdv in WIDE_HEADS]
    shapes.append(("q.k 192 / v 128 kv_valid_len 300, non-causal",
                   dict(wide, hd=192, hdv=128),
                   {"kv_valid_len": 300, "causal": False}))
    shapes += [
        ("whisper encoder, causal 1500", WHISPER_ENCODER, {}),
        ("whisper cross prefill 384 x 1500", WHISPER_CROSS, {}),
        ("whisper cross step over 1500", WHISPER_CROSS_STEP,
         {"kv_valid_len": WHISPER_FRAMES})]
    errs = {}
    for i, (label, shape, kw) in enumerate(shapes):
        kw = dict({"causal": shape.get("causal", True),
                   "q_offset": shape.get("q_offset", 0)}, **kw)
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype is torch.bfloat16
            name = f"{label} {'bf16' if bf16 else 'f32'}"
            q, k, v = attention_inputs(shape, dev, seed=20 + i, dtype=dtype)
            ops.SPEC.reset_counts()
            got = ops.flash_attention_op(q, k, v, **kw)
            again = ops.flash_attention_op(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            launched = {n for n, c in flash_kernel_launches().items() if c}
            if not bf16:
                expect = {"flash_attention_f32"}
            elif fa.is_decode(shape["sq"], shape["h"], shape["kv"]):
                expect = {"flash_attention_bf16_decode",
                          "flash_attention_bf16_combine"}
            else:
                expect = {"flash_attention_bf16_prefill"}
            max_abs, worst = compare(got.float(), want.float(),
                                     BF16_RTOL if bf16 else rtol, atol)
            if not (worst <= 1.0 and torch.isfinite(got).all()
                    and got.dtype == q.dtype and torch.equal(got, again)
                    and launched == expect and ops.SPEC.plain_calls == 0):
                raise AssertionError(
                    f"flash_attention {name}: max abs error {max_abs}, "
                    f"{worst}x the tolerance, launched {launched}, "
                    f"relaunch equal {torch.equal(got, again)}")
            errs[name] = max_abs
    emit("kernel", kernel="flash_attention", max_abs_err=errs, rtol=rtol,
         atol=atol, bf16_rtol=BF16_RTOL)
    return errs


def decode_kernels_cell(shape, valid, arrays):
    """The bf16 decode kernel and its combine alone at an LM's decode-step
    shape, each held against its plain version on the same inputs (the
    partials to 1e-4 of their largest magnitude: ex2.approx and the order
    of the sums; the combine's bf16 output to one ulp): their errors,
    split count and bounds, and thunks of the four calls.  Bytes bound
    both: the decode kernel reads q and the visited keys' K and V once
    and writes the partials, the combine reads the partials and writes
    the output."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_combine_ref, flash_attention_decode_ref)

    q, k, v = arrays
    b, sq, h, kvh, hd = (shape[n] for n in ("b", "sq", "h", "kv", "hd"))
    hdv = shape.get("hdv", hd)
    kw = dict(causal=shape["causal"], q_offset=shape["q_offset"])
    keys = fa.visited_keys(sq, shape["skv"], kw["causal"], kw["q_offset"],
                           valid)
    splits = fa.split_count(b, kvh, keys, fa.sm_count(q.device))

    def decode():
        return fa.flash_attention_bf16_decode(q, k, v, valid=valid,
                                              splits=splits, **kw)

    def decode_plain():
        return flash_attention_decode_ref(q, k, v, kv_valid_len=valid,
                                          splits=splits, **kw)
    parts = decode()
    out = q.new_empty((b, sq, h, hdv))

    def combine():
        return fa.flash_attention_bf16_combine(*parts, out, hd)

    def combine_plain():
        return flash_attention_combine_ref(*parts, hd)
    want_parts = decode_plain()
    got, want = combine(), combine_plain().reshape(out.shape)
    torch.cuda.synchronize()
    part_err = max((g - w).abs().max().item()
                   / (1 + w.abs().max().item())
                   for g, w in zip(parts, want_parts))
    combine_err, worst = compare(got.float(), want.float(), BF16_RTOL, 2e-5)
    if not (part_err <= 1e-4 and worst <= 1.0):
        raise AssertionError(f"bf16 decode kernels at {shape}: partials "
                             f"{part_err} of their scale, combine {worst}x "
                             f"the tolerance")
    part_bytes = sum(4 * t.numel() for t in parts)
    pairs = b * h * sq * keys
    t_ops = 1.5 * 2 * (hd + hdv) * pairs / PEAK_F16_FLOPS
    t_bytes = (2 * (q.numel() + b * keys * kvh * (hd + hdv)) + part_bytes
               ) / PEAK_HBM_BYTES
    return dict(
        decode=decode, decode_plain=decode_plain, combine=combine,
        combine_plain=combine_plain, splits=splits, keys=keys,
        decode_max_abs_err=part_err, combine_max_abs_err=combine_err,
        decode_bound_ms=max(t_ops, t_bytes) * 1e3,
        decode_bound_by="operations" if t_ops >= t_bytes else "bytes",
        combine_bound_ms=(part_bytes + 2 * out.numel()) / PEAK_HBM_BYTES
        * 1e3, combine_bound_by="bytes")


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
    record_flash_launches("run_tune")
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


def sm_clock_hz():
    """The SM clock the card runs at its limit: ``nvidia-smi``'s
    ``clocks.max.sm``, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def mamba_bound(problem):
    """(bound_ms, bound_by, bytes, operations, sfu_only_ms) of one
    selective scan: dt, x, Bm, Cm read once in the problem's dtype and y
    written once in f32, A, D, h0 and hT in f32.  Its operations: one
    exp2 a state and step, and beside it two products and two fused
    multiply-adds (6 f32 operations at the f32 peak).  Each exp2 runs
    either on the SFUs (``SFU_EXP2_PER_CLOCK_SM`` x SMs x
    ``sm_clock_hz``) or as ``MAMBA_POLY_OPS`` more f32 operations; the
    operations' time is the least over the share on the f32 pipe (the
    share where the two units finish together).  ``sfu_only_ms``: every
    exp2 on the SFUs (the kernel's first design's bound)."""
    import torch
    b, s, di, ds = (problem[k] for k in ("b", "s", "di", "ds"))
    el = 4 if problem["dtype"] == "float32" else 2
    nbytes = el * 2 * b * s * (di + ds) + 4 * b * s * di \
        + 4 * (di * ds + di + 2 * b * di * ds)
    exps = b * s * di * ds
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu = SFU_EXP2_PER_CLOCK_SM * sms * sm_clock_hz()
    t_sfu_only = max(exps / sfu, 6 * exps / PEAK_F32_FLOPS)
    # (1 - share) / sfu = (6 + POLY_OPS share) / f32, clipped to [0, 1]
    share = min(max((PEAK_F32_FLOPS - 6 * sfu)
                    / (PEAK_F32_FLOPS + MAMBA_POLY_OPS * sfu), 0.0), 1.0)
    t_ops = max(exps * (1 - share) / sfu,
                exps * (6 + MAMBA_POLY_OPS * share) / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nbytes,
            {"exp2": exps, "f32": 6 * exps, "poly_share": share,
             "poly_f32_per_exp2": MAMBA_POLY_OPS, "sfu_per_s": sfu,
             "sms": sms, "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3},
            max(t_sfu_only, t_bytes) * 1e3)


def mamba_underflow_case(problem, generator, dev):
    """``ops.SPEC.make_call``'s inputs with dt uniform in [0,
    ``MAMBA_UNDERFLOW_DT``]: decays that underflow to 0 beside decays
    that do not."""
    import torch
    from repro_torch.kernels.mamba_scan import ops
    arrays = ops.SPEC.make_call(problem, generator, dev)
    dt = torch.rand(arrays[0].shape, generator=generator) * MAMBA_UNDERFLOW_DT
    return (dt.to(device=dev, dtype=arrays[0].dtype),) + arrays[1:]


def check_mamba_scan(dev):
    """mamba_scan (through its op) against its plain version, y and the
    final state each within the spec's (1e-5, 1e-5) with the relative
    part taken against the scale of their terms (``ops.term_scale``):
    jamba's prefill shape in bf16 and f32, one step (S 1) at jamba's
    width, S 70 (a partial chunk of 64) at di 200 (a partial block of
    128 channels) in f32 and bf16, d_state 5 and 8 in both (rows the
    wrapper pads to 16 states; at 8 the second lane of each channel
    holds only padding), decays underflowing (dt up to
    ``MAMBA_UNDERFLOW_DT``) in both, every case from a nonzero state; a
    second launch bit for bit.  Returns ``(errors, failures, bf16 prefill
    arrays)``; the caller raises on failures after the LM slices have
    run."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan as scan
    from repro_torch.kernels.mamba_scan import ops

    rtol, atol = ops.SPEC.tol
    small = ops.SPEC.default_problems[0]
    cases = [
        ("jamba prefill bf16", JAMBA_SCAN),
        ("jamba prefill f32", dict(JAMBA_SCAN, dtype="float32")),
        ("S 1", dict(JAMBA_SCAN, s=1)),
        ("S 70, di 200", small),
        ("S 70, di 200 bf16", dict(small, dtype="bfloat16")),
        ("ds 5", dict(small, ds=5)),
        ("ds 5 bf16", dict(small, ds=5, dtype="bfloat16")),
        ("ds 8", dict(small, ds=8)),
        ("ds 8 bf16", dict(small, ds=8, dtype="bfloat16")),
        ("underflow", small),
        ("underflow bf16", dict(small, dtype="bfloat16")),
    ]
    results, failures, prefill = {}, [], None
    for i, (label, problem) in enumerate(cases):
        gen = torch.Generator().manual_seed(110 + i)
        arrays = (mamba_underflow_case(problem, gen, dev)
                  if label.startswith("underflow")
                  else ops.SPEC.make_call(problem, gen, dev))
        y, hT = ops.mamba_scan_op(*arrays)
        y2, hT2 = ops.SPEC.run_call(problem, arrays, {})
        res = dict(ops.held_to_plain(arrays, y, hT),
                   relaunch_bit_identical=bool(torch.equal(y, y2)
                                               and torch.equal(hT, hT2)),
                   finite=bool(torch.isfinite(y).all()
                               and torch.isfinite(hT).all()),
                   launch=scan.launch_shape(problem["b"], problem["di"]))
        results[label] = res
        if label == "jamba prefill bf16":
            prefill = arrays
        del arrays
        if not (max(res["worst_vs_terms"].values()) <= 1.0
                and res["relaunch_bit_identical"]
                and res["finite"] and y.dtype == torch.float32):
            failures.append(f"mamba_scan {label}: {res}")
    emit("kernel", kernel="mamba_scan", cases=results, rtol=rtol, atol=atol,
         ok=not failures)
    return results, failures, prefill


def sass_functions(path, kernel):
    """``(name, loop)`` for each function of the library or cubin at
    ``path`` whose name holds ``kernel``, from ``cuobjdump -sass``:
    ``loop`` the instructions (``NOP`` aside) of its shortest loop (a
    backward ``BRA`` and its target) that holds a ``MUFU.EX2``.  None
    where the toolkit has no ``cuobjdump``."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        return None
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    found = []
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        instrs = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, op in instrs:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                body = [o for a, o in instrs
                        if int(m.group(1), 16) <= a <= addr
                        and not o.startswith("NOP")]
                if any("MUFU.EX2" in o for o in body):
                    loops.append(body)
        if loops:
            found.append((name, min(loops, key=len)))
    return found


def _opcodes(body):
    """Opcode counts of SASS instructions (predicates dropped)."""
    import re
    counts = {}
    for o in body:
        key = re.sub(r"^@!?U?P\w+\s+", "", o).split()[0]
        counts[key] = counts.get(key, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def sass_loops(so_path):
    """Instructions of one step of each ``mamba_scan_kernel`` (one a
    dtype, and one a dtype that keeps states for the backward, ``keep``)
    in the library at ``so_path`` (``sass_functions``): its loop's
    instructions over the steps an iteration (its ``MUFU.EX2`` over a
    lane's 8 exps a step), per lane and per channel (times its 2 lanes),
    with the loop's opcodes counted.  None where the toolkit has no
    ``cuobjdump``."""
    from repro_torch.kernels.mamba_scan import mamba_scan as scan
    loops = sass_functions(so_path, "mamba_scan_kernel")
    if loops is None:
        return None
    lanes, out = scan.LANES, {}
    for name, body in loops:
        head = name.split("EvPK")[0]
        elt = "bf16" if "bfloat16" in head else "f32"
        if "Lb1E" in head:
            elt += " keep"  # the instance that keeps states for the backward
        n, mufu = len(body), sum("MUFU.EX2" in o for o in body)
        steps = mufu / (scan.MAX_STATE // lanes)
        out[elt] = {
            "loop_instructions": n, "steps_an_iteration": steps,
            "per_lane_step": n / steps, "per_channel_step": n / steps * lanes,
            "mufu_per_channel_step": mufu / steps * lanes,
            "opcodes": _opcodes(body)}
    return out


def bwd_sass_loops(path, kernel="mamba_bwd_walk"):
    """Instructions of one lane-step of the selective scan backward's
    chunk loop in each instance of ``kernel`` (one a dtype) in the library
    or cubin at ``path`` (``sass_functions``), cut at the loop's first
    ``MUFU.EX2``, at its ``BWD_CHUNK x 4``-th (the last of the states'
    recompute) and at its last ``SHFL`` (the walk back's last reduction),
    each part over the chunk's ``BWD_CHUNK`` steps: ``recompute``,
    ``walk_back`` and ``chunk_rest`` (staging, barriers, the block's sums
    and the stores; the scheduler may move a few instructions across the
    cuts), with each part's opcodes.  ``kernel`` ``mamba_bwd_chunks``
    reads the earlier design's chunk pass (the backward before the
    forward kept its states), which has the same two loops.  None where
    the toolkit has no ``cuobjdump``."""
    from repro_torch.kernels.mamba_scan import mamba_scan as scan
    loops = sass_functions(path, kernel)
    if loops is None:
        return None
    C, out = scan.BWD_CHUNK, {}
    recompute_exps = C * scan.MAX_STATE // scan.BWD_LANES
    for name, body in loops:
        elt = "bf16" if "bfloat16" in name else "f32"
        exps = [i for i, o in enumerate(body) if "MUFU.EX2" in o]
        shfl = [i for i, o in enumerate(body) if "SHFL" in o]
        cut = exps[recompute_exps - 1] + 1
        end = shfl[-1] + 1 if shfl else len(body)
        parts = {"recompute": body[exps[0]:cut], "walk_back": body[cut:end],
                 "chunk_rest": body[:exps[0]] + body[end:]}
        out[elt] = {"loop_instructions": len(body),
                    "per_lane_step": len(body) / C,
                    "mufu_per_lane_step": len(exps) / C,
                    **{f"{k}_per_lane_step": len(v) / C
                       for k, v in parts.items()},
                    "opcodes": {k: _opcodes(v) for k, v in parts.items()}}
    return out


def time_mamba_scan(dev, arrays, smi):
    """CUDA-event times of mamba_scan (over 20 launches) and its plain
    version at jamba's prefill shape, beside the joint bound and the
    SFU-only one, and the SASS instructions of one step (``sass_loops``).
    No one PyTorch call computes this scan: no library time."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan as scan
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

    problem = JAMBA_SCAN
    bound_ms, bound_by, nbytes, operations, sfu_only_ms = \
        mamba_bound(problem)

    def kernel():
        return ops.SPEC.run_call(problem, arrays, {})
    ms = cuda_ms(kernel, 20)
    out = dict(problem=problem, ms=ms,
               plain_ms=cuda_ms(lambda: mamba_scan_ref(*arrays), 3,
                                warmup=1),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms, sfu_only_bound_ms=sfu_only_ms,
               share_of_sfu_only_bound=sfu_only_ms / ms, bytes=nbytes,
               operations=operations,
               launch=scan.launch_shape(problem["b"], problem["di"]),
               sass=sass_loops(_build.build_all(["mamba_scan"])[
                   "mamba_scan"].so_path))
    emit("timing", kernel="mamba_scan", case="jamba prefill",
         design=MAMBA_DESIGN, nvidia_smi=smi, **out)
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


def gqa_kv(caches, layer):
    """One layer's K and V cache in f32 (an int8 cache dequantized)."""
    c = caches["stack"][0][layer]["mixer"]
    out = []
    for key in ("k", "v"):
        t = c[key].float()
        if key + "_scale" in c:
            t = t * c[key + "_scale"].float()[..., None]
        out.append(t)
    return out


def gqa_compare_kv(caches, want):
    """Every layer's K and V against ``want``'s, one layer at a time:
    ``{"k": (max abs error, largest |want|, worst), "v": ...}`` over all
    layers, and each layer's largest K/V error."""
    acc = {"k": [0.0, 0.0, 0.0], "v": [0.0, 0.0, 0.0]}
    by_layer = []
    for layer in range(len(caches["stack"][0])):
        worst_layer = 0.0
        for key, got, ref in zip(("k", "v"), gqa_kv(caches, layer),
                                 gqa_kv(want, layer)):
            c = lm_compare(got, ref)
            acc[key] = [max(a, b) for a, b in zip(acc[key], c)]
            worst_layer = max(worst_layer, c[0])
        by_layer.append(worst_layer)
    return {k: tuple(v) for k, v in acc.items()}, by_layer


def gqa_handoff(cfg, params, prompts, frames=None):
    """``serve_step`` on the last prompt token after a prefill of the
    others (into a cache of the prompt's length; an encoder-decoder
    model's over ``frames``): the step's logits."""
    from repro_torch.models import lm
    S = prompts.shape[1]
    _, short = lm.prefill(cfg, params, prompts[:, :-1], enc_embeds=frames,
                          cache_len=S)
    return lm.serve_step(cfg, params, short, prompts[:, -1:], S - 1)[0]


def whisper_cross_kv(caches, want):
    """Every decoder layer's cross K and V against ``want``'s: ``{"cross_k":
    (max abs error, largest |want|, worst), "cross_v": ...}``."""
    out = {}
    for key in ("cross_k", "cross_v"):
        acc = [0.0, 0.0, 0.0]
        for got, ref in zip(caches["stack"][0], want["stack"][0]):
            acc = [max(a, b) for a, b in zip(acc, lm_compare(got[key],
                                                             ref[key]))]
        out[key] = tuple(acc)
    return out


def gqa_against_plain(cfg, params, prompts, logits, caches, frames=None):
    """The prefill that gave ``logits``/``caches`` run again with attention
    computed by the kernel's plain version (which must launch nothing),
    then the cache handoff against ``logits``, and the same handoff
    through an int8 KV cache, with the kernel and with the plain
    version.  An encoder-decoder model's prefill runs over ``frames``;
    its encoder's output and every layer's cross K/V are compared too,
    and the cross caches' dtypes reported (the model's, also beside an
    int8 self cache)."""
    from unittest import mock

    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import blocks, lm

    cfg8 = cfg.replace(kv_cache_dtype="int8")
    before = ops.SPEC.launches
    step8 = gqa_handoff(cfg8, params, prompts, frames)
    torch.cuda.synchronize()
    int8_launches = ops.SPEC.launches - before
    encode = frames is not None
    enc = lm.encode(cfg, params, frames) if encode else None
    before = ops.SPEC.launches
    with mock.patch.object(blocks, "flash_attention_op", flash_attention_ref):
        t0 = time.perf_counter()
        logits_p, caches_p = lm.prefill(cfg, params, prompts,
                                        enc_embeds=frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        enc_p = lm.encode(cfg, params, frames) if encode else None
        step8_p = gqa_handoff(cfg8, params, prompts, frames)
        torch.cuda.synchronize()
    plain_launches = ops.SPEC.launches - before
    kv, by_layer = gqa_compare_kv(caches, caches_p)
    extra = {}
    if encode:
        kv.update(whisper_cross_kv(caches, caches_p), enc_out=lm_compare(
            enc, enc_p))
        extra["cross_cache_dtypes"] = sorted({
            str(c[k].dtype).removeprefix("torch.")
            for c in caches["stack"][0] for k in ("cross_k", "cross_v")})
    del caches_p
    step = gqa_handoff(cfg, params, prompts, frames)

    def real(t):  # logits of the vocabulary (padding reads -1e30)
        return t[..., :cfg.vocab_size]

    def named(got, want):
        return dict(zip(("max_abs_err", "max_abs", "worst"),
                        lm_compare(real(got), real(want))))
    vs = {"logits": named(logits, logits_p),
          **{k: dict(zip(("max_abs_err", "max_abs", "worst"), v))
             for k, v in kv.items()}}
    return {
        "plain_attention_prefill_s": seconds,
        "plain_path_launches": plain_launches,
        "int8_handoff_launches": int8_launches,
        "vs_plain_attention": vs,
        "kv_max_abs_err_by_layer": by_layer,
        "handoff": named(step, logits),
        "int8_handoff_vs_plain": named(step8, step8_p),
        # not a check: the int8 cache's own quantization error
        "int8_handoff_vs_prefill": named(step8, logits), **extra}


def gqa_within(res, tol):
    """Every comparison of :func:`gqa_against_plain` but the int8 cache's
    quantization error within ``tol`` of the largest magnitude."""
    cmp = list(res["vs_plain_attention"].values()) + [
        res["handoff"], res["int8_handoff_vs_plain"]]
    return all(c["max_abs_err"] <= tol * (1 + c["max_abs"]) for c in cmp)


def gqa_attention_cell(shape, valid, dev, seed):
    """flash_attention at one of an LM's shapes (bf16): its inputs,
    problem, plain version, one SDPA call computing the same function
    (K/V repeated per group and cut to the valid keys beforehand; the
    backend PyTorch picks for it named), and the bound: each input read
    once and the output written once (only the ``valid`` keys of K/V),
    against the operations (2 (hd + hdv) per visible query-key pair) at
    the bf16 tensor-core peak; ``bound_split_ms`` prices the operations
    as the bf16 kernels run them, q.k once and P.V twice (p as bf16 hi +
    lo), 1.5x those at the same peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = attention_inputs(shape, dev, seed, dtype=torch.bfloat16)
    kw = {"causal": shape["causal"], "q_offset": shape["q_offset"],
          "kv_valid_len": valid}
    b, sq, h, kvh, hd = (shape[n] for n in ("b", "sq", "h", "kv", "hd"))
    hdv = shape.get("hdv", hd)
    seen = valid if valid is not None else shape["skv"]
    group = h // kvh
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t[:, :seen].repeat_interleave(group, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    if shape["causal"]:
        pairs = b * h * sq * (sq + 1) // 2   # q_offset 0, Sq = Skv
    else:
        pairs = b * h * sq * seen
    flops = 2 * (hd + hdv) * pairs
    nbytes = 2 * (q.numel() + b * sq * h * hdv + b * seen * kvh * (hd + hdv))
    t_ops, t_bytes = flops / PEAK_F16_FLOPS, nbytes / PEAK_HBM_BYTES
    return dict(
        arrays=(q, k, v), problem=ops.inspect_call(q, k, v, **kw),
        plain=lambda: flash_attention_ref(q, k, v, **kw),
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=shape["causal"]),
        library_backend=sdpa_backend(qt, kt, vt, shape["causal"]),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_split_ms=max(1.5 * flops / PEAK_F16_FLOPS, t_bytes) * 1e3,
        flops=flops, bytes=nbytes)


def sdpa_backend(q, k, v, causal):
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs (``torch._fused_sdp_choice``), by name, or None where this
    PyTorch does not say."""
    import torch
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, is_causal=causal)).name
    except (AttributeError, ImportError, RuntimeError, TypeError,
            ValueError):
        return None


def time_gqa_attention(dev, smi):
    """CUDA-event times of flash_attention at the GQA LM's prefill and
    decode-step shapes and at the training step's forward (B 2 x 2,048;
    bf16, at the tile dispatch resolves), beside the plain version,
    ``scaled_dot_product_attention`` and the bound; the decode step also
    from a CUDA graph (a loop of one-row launches is paced by the host),
    and its two kernels alone.  Each launch is held against the plain
    version first (bf16 outputs within one ulp)."""
    return time_lm_attention(dev, smi, "gqa_lm", (
        ("prefill", GQA_PREFILL, None, 10),
        ("decode", GQA_DECODE, GQA_DECODE_VALID, 200),
        ("train forward", LMT_ATTN, None, 10)), seed=90)


def time_lm_attention(dev, smi, case, shapes, seed):
    """flash_attention's times at an LM's ``shapes`` ((label, shape,
    valid keys, iterations); a ``decode...`` label also from a CUDA graph,
    and the decode kernel and its combine alone from CUDA graphs beside
    their plain versions, ``decode_kernels``; the others also at every
    tile the spec would sweep, ``tiles_ms``), each launch held against
    the plain version first; one ``timing`` line each, under ``case``."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops

    out = {}
    for label, shape, valid, iters in shapes:
        cell = gqa_attention_cell(shape, valid, dev, seed=seed + len(out))
        problem, arrays = cell.pop("problem"), cell.pop("arrays")
        plain, library = cell.pop("plain"), cell.pop("library")
        params = registry.resolve_params(ops.SPEC, problem)

        def kernel(tile=params):
            return ops.SPEC.run_call(problem, arrays, tile)
        decode = label.startswith("decode")
        want = plain().float()
        tiles = [params] if decode else ops.SPEC.candidates(problem)
        for tile in tiles:
            max_abs, worst = compare(kernel(tile).float(), want, BF16_RTOL,
                                     ops.TOL[1])
            if not worst <= 1.0:
                raise AssertionError(
                    f"flash_attention at {case}'s {label} shape, tile "
                    f"{tile}: max abs error {max_abs}, {worst}x the "
                    f"tolerance")
        max_abs, _ = compare(kernel().float(), want, BF16_RTOL, ops.TOL[1])
        ms = cuda_ms(kernel, iters)
        out[label] = dict(
            cell, problem=problem, params=params, max_abs_err=max_abs,
            ms=ms, graph_ms=graph_ms(kernel) if decode else None,
            plain_ms=cuda_ms(plain, iters if decode else 3),
            library_ms=cuda_ms(library, iters),
            library_call="torch.nn.functional.scaled_dot_product_attention"
                         ", bf16, K/V repeated per group"
                         + (" and cut to kv_valid_len" if valid else "")
                         + " beforehand",
            share_of_bound=cell["bound_ms"] / ms,
            split_share_of_bound=cell["bound_split_ms"] / ms)
        if not decode:
            out[label]["tiles_ms"] = {
                f"{t['block_q']}x{t['block_kv']}":
                cuda_ms(lambda t=t: kernel(t), iters) for t in tiles}
        if decode:
            parts = decode_kernels_cell(shape, valid, arrays)
            thunks = {n: parts.pop(n) for n in (
                "decode", "decode_plain", "combine", "combine_plain")}
            out[label]["decode_kernels"] = dict(
                parts, decode_ms=graph_ms(thunks["decode"]),
                decode_plain_ms=cuda_ms(thunks["decode_plain"], 20),
                combine_ms=graph_ms(thunks["combine"]),
                combine_plain_ms=cuda_ms(thunks["combine_plain"], 20))
        emit("timing", kernel="flash_attention", case=f"{case} {label}",
             nvidia_smi=smi, **out[label])
    return out


def run_gqa_lm_slice(dev, smi):
    """prefill -> serve_step of llama3.2-3b at full width through the
    port's entry points, attention on flash_attention, held against the
    same model with attention computed by the kernel's plain version,
    in its bf16 and as an f32 copy, with bf16 and int8 KV caches; then
    the kernel's times at this path's two shapes.  Returns the generate
    loop's flash_attention launches and the kernel's times."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm

    cfg = get_config(GQA_ARCH)
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    t_phase = t0 = time.perf_counter()
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
    bf16 = gqa_against_plain(cfg, params, prompts, logits, caches)
    del caches

    registry.reset_counts()
    res = serve_lm.generate(cfg, params, prompts, LM_GEN)
    gen_launches = ops.SPEC.launches
    gen_kernels = record_flash_launches("gqa_lm_slice")
    tokens = res["tokens"]
    finite = bool(torch.isfinite(logits).all()
                  and torch.isfinite(res["logits"]).all())

    # the card's busy share over the same decode loop, traced
    steps = LM_GEN - 1
    first, caches = lm.prefill(cfg, params, prompts,
                               cache_len=LM_PROMPT + LM_GEN)

    def decode_loop():
        tok = first.argmax(-1)[:, None]
        for i in range(steps):
            out, _ = lm.serve_step(cfg, params, caches, tok, LM_PROMPT + i)
            tok = out.argmax(-1)[:, None]
        return tok
    _, traced_s, busy_s = device_busy(decode_loop)
    del caches

    # the same weights in f32: the kernel's own differences, without
    # bf16 rounding of the activations to amplify them layer by layer
    cfg32 = cfg.replace(dtype="float32")
    params32 = _cast(params, torch.float32)
    del params
    registry.reset_counts()
    logits32, caches32 = lm.prefill(cfg32, params32, prompts)
    torch.cuda.synchronize()
    f32_launches = ops.SPEC.launches
    f32 = gqa_against_plain(cfg32, params32, prompts, logits32, caches32)
    finite = finite and bool(torch.isfinite(logits32).all())
    del params32, caches32
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    timing = time_gqa_attention(dev, smi)
    seconds["phase"] = time.perf_counter() - t_phase
    L = cfg.n_layers
    checks = {
        "prefill_launches_one_per_layer":
        prefill_launches == (L, 0) and f32_launches == L,
        "plain_path_launched_nothing": bf16["plain_path_launches"] == 0
        and f32["plain_path_launches"] == 0,
        "int8_handoff_launches_one_per_layer_per_call":
        bf16["int8_handoff_launches"] == 2 * L
        and f32["int8_handoff_launches"] == 2 * L,
        "generate_launches_one_per_layer_per_call": gen_launches == L * LM_GEN,
        # the prefill on the bf16 prefill kernel, each step on the decode
        # kernel and its combine, none on the f32 design
        "generate_on_the_bf16_kernels": gen_kernels == {
            "flash_attention_f32": 0, "flash_attention_bf16_prefill": L,
            "flash_attention_bf16_decode": L * (LM_GEN - 1),
            "flash_attention_bf16_combine": L * (LM_GEN - 1)},
        "logits_finite": finite,
        "logits_shape": tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab),
        "bf16_matches_plain_attention_and_handoffs":
        gqa_within(bf16, LM_TOL_BF16),
        "f32_matches_plain_attention_and_handoffs":
        gqa_within(f32, LM_TOL_F32),
        "tokens": tuple(tokens.shape) == (LM_BATCH, LM_GEN)
        and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
    }
    numbers = dict(
        prefill_s=seconds["prefill"], decode_s=res["decode_s"],
        generate_prefill_s=res["prefill_s"],
        decode_ms_per_step=res["decode_s"] / steps * 1e3,
        tokens_per_s=LM_BATCH * steps / res["decode_s"],
        decode_traced_s=traced_s, decode_busy_s=busy_s,
        decode_busy_share=busy_s / traced_s if busy_s else None,
        kernel_ms_prefill=timing["prefill"]["ms"],
        kernel_ms_decode=timing["decode"]["ms"],
        kernel_graph_ms_decode=timing["decode"]["graph_ms"],
        kernel_share_of_prefill=L * timing["prefill"]["ms"]
        / (seconds["prefill"] * 1e3), peak_gib=peak_gib)
    emit("gqa_lm_slice", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype=cfg.dtype,
         params=n_params, batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN,
         seconds=seconds,
         launches={"prefill": prefill_launches[0], "generate": gen_launches,
                   "f32_prefill": f32_launches,
                   "generate_by_kernel": gen_kernels},
         bf16=bf16, f32=f32, tol_bf16=LM_TOL_BF16, tol_f32=LM_TOL_F32,
         sample=tokens[0, :8].tolist(), nvidia_smi=smi, **numbers, **checks)
    if not all(checks.values()):
        raise AssertionError(f"gqa lm slice checks failed: {checks}")
    return gen_launches, timing


@contextlib.contextmanager
def record_routes(probs=False):
    """Every ``blocks.moe_route`` call in the block, in order: a list of
    (experts ``[T, k]``, keep ``[T, k]``), one per MoE layer a forward or
    step walks, and with ``probs`` the router's probabilities ``[T,
    E]`` (whole tensors, gathered under a mesh)."""
    from unittest import mock

    import torch
    from repro_torch.dist.sharding import full_tensor
    from repro_torch.models import blocks
    calls, route = [], blocks.moe_route

    def recorded(cfg, p, x):
        out = route(cfg, p, x)
        calls.append((full_tensor(out[1]).reshape(-1, cfg.top_k),
                      full_tensor(out[3]).reshape(-1, cfg.top_k))
                     + ((full_tensor(torch.softmax(
                         x.float() @ p["w_router"], -1))
                         .reshape(-1, cfg.n_experts),) if probs else ()))
        return out
    with mock.patch.object(blocks, "moe_route", recorded):
        yield calls


def route_agreement(a, b):
    """Each MoE layer's share of the (token, slot) routes of ``a`` whose
    expert ``b`` also chose for that token."""
    return [(ra[0][:, :, None] == rb[0][:, None, :]).any(-1).float().mean()
            .item() for ra, rb in zip(a, b)]


def routes_dropped(routes):
    return sum(int((~r[1]).sum()) for r in routes)


def layer_flips(mine, ref, k):
    """One MoE layer's routes with the kernel (``mine``) against the plain
    version (``ref``), from the same input: the tokens whose experts (as
    a set: two near-tied experts may swap slots) and kept routes agree (a
    bool ``[T]``), and what explains the rest.  A
    flipped route is a near-tie when its token's top-k margin (the k-th
    router probability less the next, with the kernel) is within twice
    the largest change of a probability between the two runs over the
    tokens that agree; a flip into an expert at its capacity moves that
    expert's later rows, so it may change whether one later route is
    kept, and a flip out of one another: at most two such changes a
    flipped route."""
    (ea, ka, pa), (eb, kb, pb) = mine, ref
    # a token's experts as a set, each with whether its route is kept
    (ea, oa), (eb, ob) = ea.sort(-1), eb.sort(-1)
    ka, kb = ka.gather(-1, oa), kb.gather(-1, ob)
    same_experts = (ea == eb).all(-1)
    same = same_experts & (ka == kb).all(-1)
    flipped_routes = int((~(ea[:, :, None] == eb[:, None, :]).any(-1))
                         .sum())
    top = pa.topk(k + 1, dim=-1).values
    margin = top[:, k - 1] - top[:, k]
    drift = (pa - pb).abs().amax(-1)
    margin_max = margin[~same_experts].max().item() if flipped_routes else 0.0
    drift_max = drift[same].max().item() if bool(same.any()) else 0.0
    keep_only = int((same_experts & ~same).sum())
    return same, {
        "tokens_differing": int((~same).sum()),
        "routes_flipped": flipped_routes,
        "keep_changed_tokens": keep_only,
        "flip_margin_max": margin_max,
        "prob_drift_max_agreeing": drift_max,
        "explained": margin_max <= 2 * drift_max
        and keep_only <= 2 * flipped_routes}


def moe_handoff(cfg, params, prompts):
    """``serve_step`` on the last prompt token after a prefill of the
    others (into a cache of the prompt's length): the step's logits and
    the routes its MoE layers dropped (C = 1 for 4 sequences)."""
    from repro_torch.models import lm
    S = prompts.shape[1]
    _, short = lm.prefill(cfg, params, prompts[:, :-1], cache_len=S)
    with record_routes() as routes:
        step = lm.serve_step(cfg, params, short, prompts[:, -1:], S - 1)[0]
    return step, routes_dropped(routes)


@contextlib.contextmanager
def plain_ops(*names):
    """The model's kernel ops named (``blocks.<name>``) patched to their
    plain versions inside the block."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.models import blocks
    plain = {"flash_attention_op": flash_attention_ref,
             "mamba_scan_op": mamba_scan_ref}
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(blocks, name, plain[name]))
        yield


def layers_from_plain(cfg, params, inputs, plain):
    """Each layer run from the plain prefill's own input to it, with the
    kernels and with the ops ``plain`` names on their plain versions: the
    gap between the two outputs (the residual stream after the layer)
    over all tokens and over the tokens whose routes agree
    (:func:`layer_flips`), and what explains the others."""
    import torch
    from repro_torch.models import lm

    def named(got, want):
        return dict(zip(("max_abs_err", "max_abs", "worst"),
                        lm_compare(got, want)))
    out = []
    for (slot, r, spec), x in zip(lm._layers(cfg), inputs):
        p = lm._get(params, slot, r)
        kw = {"positions": torch.arange(x.shape[1], device=x.device),
              "position_ids": None}
        with record_routes(probs=True) as mine:
            y = lm._apply_layer_seq(cfg, p, spec, x, **kw)[0]
        with record_routes(probs=True) as ref, plain_ops(*plain):
            y_p = lm._apply_layer_seq(cfg, p, spec, x, **kw)[0]
        y, y_p = y.reshape(-1, y.shape[-1]), y_p.reshape(-1, y.shape[-1])
        row = {"all_tokens": named(y, y_p)}
        if mine:
            same, flips = layer_flips(mine[0], ref[0], cfg.top_k)
            row.update(flips, agreeing_tokens=named(y[same], y_p[same]),
                       route_agreement=route_agreement(mine, ref)[0])
        else:
            row["agreeing_tokens"] = row["all_tokens"]
        out.append(row)
    return out


def moe_within(res, tol):
    """Every comparison of :func:`against_plain` but the handoff's gap to
    the prefill within ``tol`` of the largest magnitude; or, where a route
    flipped between the two runs, every layer held from the plain run's
    own input within it over the tokens whose routes agree, each other
    token explained by a near-tied flip (:func:`layer_flips`).  Returns
    (ok, how)."""
    def ok(cmp):
        return all(c["max_abs_err"] <= tol * (1 + c["max_abs"])
                   for c in cmp)
    if ok(list(res["vs_plain"].values()) + [res["handoff_vs_plain"]]):
        return True, "end_to_end"
    layers = res["layers_from_plain_input"]
    flips = min(res["route_agreement_by_layer"], default=1.0) < 1.0
    if (flips and ok([c["agreeing_tokens"] for c in layers])
            and all(c.get("explained", True) for c in layers)):
        return True, "per_layer_after_route_flips"
    return False, "failed"


def handoff_without_drops(cfg, params, prompts):
    """The cache handoff at a capacity that drops no route (``E / k``:
    C = 4 for the step's 24 routes, every token's route kept in the
    prefill): the step's gap to the whole prompt's prefill at that
    capacity, and the routes dropped (none)."""
    from repro_torch.models import lm
    wide = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    with record_routes() as routes:
        logits, _ = lm.prefill(wide, params, prompts)
    step, step_drops = moe_handoff(wide, params, prompts)

    def real(t):
        return t[..., :cfg.vocab_size]
    return {"capacity_factor": wide.capacity_factor,
            "routes_dropped": routes_dropped(routes) + step_drops,
            "handoff_vs_prefill": dict(zip(
                ("max_abs_err", "max_abs", "worst"),
                lm_compare(real(step), real(logits))))}


def _mla_f32_copy(cfg, params):
    """The first ``MLA_F32_REPEATS`` pattern layers, the prefix and the
    embeddings of ``params`` in f32 (the router stays f32), and their
    config."""
    import torch
    from repro_torch.configs.base import with_repeats
    keep = {k: v for k, v in params.items() if k != "stack"}
    keep["stack"] = tuple(s[:MLA_F32_REPEATS] for s in params["stack"])
    return (with_repeats(cfg, MLA_F32_REPEATS).replace(dtype="float32"),
            _cast(keep, torch.float32))


def run_mla_lm_slice(dev, smi):
    """prefill -> serve_step of deepseek-v2-lite-16b (MLA + MoE) at full
    width and depth through the port's entry points, its prefill
    attention on flash_attention at q.k 192 / v 128, held against the
    same model with attention computed by the kernel's plain version (the
    MoE routes compared too), in bf16 and as an f32 copy at depth 3; then
    the kernel's times at the prefill shape.  Returns the generate loop's
    flash_attention launches and the kernel's times."""
    import gc

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm

    gc.collect()  # the llama weights of the slice before
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MLA_ARCH)
    seconds = {}
    t_phase = t0 = time.perf_counter()
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
    with record_routes() as routes:
        logits, caches = lm.prefill(cfg, params, prompts)
        torch.cuda.synchronize()
    seconds["prefill"] = time.perf_counter() - t0
    prefill_launches = (ops.SPEC.launches, ops.SPEC.plain_calls)
    bf16 = against_plain(cfg, params, prompts, logits, caches, routes,
                         MLA_PLAIN)
    del caches, routes
    bf16["without_drops"] = handoff_without_drops(cfg, params, prompts)
    _, traced_prefill_s, prefill_busy_s, prefill_kernels = device_busy(
        lambda: lm.prefill(cfg, params, prompts), PREFILL_KERNEL_GROUPS)

    registry.reset_counts()
    res = serve_lm.generate(cfg, params, prompts, LM_GEN)
    gen_launches = ops.SPEC.launches
    record_flash_launches("mla_lm_slice")
    tokens = res["tokens"]
    finite = bool(torch.isfinite(logits).all()
                  and torch.isfinite(res["logits"]).all())

    # the card's busy share over the same decode loop, traced
    steps = LM_GEN - 1
    first, caches = lm.prefill(cfg, params, prompts,
                               cache_len=LM_PROMPT + LM_GEN)

    def decode_loop():
        tok = first.argmax(-1)[:, None]
        for i in range(steps):
            out, _ = lm.serve_step(cfg, params, caches, tok, LM_PROMPT + i)
            tok = out.argmax(-1)[:, None]
        return tok
    _, traced_s, busy_s = device_busy(decode_loop)
    del caches

    # the same weights in f32 at depth 3: the kernel's own differences,
    # without bf16 rounding of the activations to amplify them
    cfg32, params32 = _mla_f32_copy(cfg, params)
    del params
    registry.reset_counts()
    with record_routes() as routes32:
        logits32, caches32 = lm.prefill(cfg32, params32, prompts)
    torch.cuda.synchronize()
    f32_launches = ops.SPEC.launches
    f32 = against_plain(cfg32, params32, prompts, logits32, caches32,
                        routes32, MLA_PLAIN)
    f32["without_drops"] = handoff_without_drops(cfg32, params32,
                                                     prompts)
    finite = finite and bool(torch.isfinite(logits32).all())
    del params32, caches32, routes32
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()

    timing = time_lm_attention(dev, smi, "mla_lm", (
        ("prefill", MLA_PREFILL, None, 10),), seed=95)
    seconds["phase"] = time.perf_counter() - t_phase
    L, L32 = cfg.n_layers, cfg32.n_layers
    bf16_ok, bf16_how = moe_within(bf16, LM_TOL_BF16)
    f32_ok, f32_how = moe_within(f32, LM_TOL_F32)
    checks = {
        "prefill_launches_one_per_layer":
        prefill_launches == (L, 0) and f32_launches == L32,
        "plain_path_launched_nothing": bf16["plain_path_launches"] == 0
        and f32["plain_path_launches"] == 0,
        # two prefills of 2,047 tokens (kernel, then plain) and two steps
        "handoff_launches_one_per_layer_of_its_prefill":
        bf16["handoff_launches"] == {"mamba_scan": 0, "flash_attention": L}
        and f32["handoff_launches"] == {"mamba_scan": 0,
                                        "flash_attention": L32},
        "generate_launches_one_per_layer_of_the_prefill": gen_launches == L,
        "logits_finite": finite,
        "logits_shape": tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab),
        "bf16_matches_plain_attention_and_handoff": bf16_ok,
        "f32_matches_plain_attention_and_handoff": f32_ok,
        "tokens": tuple(tokens.shape) == (LM_BATCH, LM_GEN)
        and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
    }
    numbers = dict(
        prefill_s=seconds["prefill"], decode_s=res["decode_s"],
        generate_prefill_s=res["prefill_s"],
        decode_ms_per_step=res["decode_s"] / steps * 1e3,
        tokens_per_s=LM_BATCH * steps / res["decode_s"],
        decode_traced_s=traced_s, decode_busy_s=busy_s,
        decode_busy_share=busy_s / traced_s if busy_s else None,
        kernel_ms_prefill=timing["prefill"]["ms"],
        kernel_share_of_prefill=L * timing["prefill"]["ms"]
        / (seconds["prefill"] * 1e3), peak_gib=peak_gib,
        prefill_traced_s=traced_prefill_s, prefill_busy_s=prefill_busy_s,
        prefill_kernel_s=prefill_kernels)
    emit("mla_lm_slice", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         heads=cfg.n_heads, qk_head=cfg.qk_nope_dim + cfg.qk_rope_dim,
         v_head=cfg.v_head_dim, kv_lora_rank=cfg.kv_lora_rank,
         experts=cfg.n_experts, top_k=cfg.top_k,
         shared_experts=cfg.n_shared_experts, expert_ff=cfg.moe_d_ff,
         capacity_factor=cfg.capacity_factor, vocab=cfg.vocab_size,
         dtype=cfg.dtype, params=n_params, batch=LM_BATCH, prompt=LM_PROMPT,
         gen=LM_GEN, f32_layers=L32, seconds=seconds,
         launches={"prefill": prefill_launches[0], "generate": gen_launches,
                   "f32_prefill": f32_launches},
         bf16=bf16, f32=f32, bf16_held=bf16_how, f32_held=f32_how,
         tol_bf16=LM_TOL_BF16, tol_f32=LM_TOL_F32,
         sample=tokens[0, :8].tolist(), nvidia_smi=smi, **numbers, **checks)
    if not all(checks.values()):
        raise AssertionError(f"mla lm slice checks failed: {checks}")
    return gen_launches, timing


def scan_attention_launches():
    """(mamba_scan, flash_attention) launches so far."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    return scan_ops.SPEC.launches, flash_ops.SPEC.launches


@contextlib.contextmanager
def record_scans():
    """Each call of the model's ``mamba_scan_op`` inside the block, in
    order: ``(inputs, (y, hT))``, kept on the card."""
    from repro_torch.models import blocks
    calls, op = [], blocks.mamba_scan_op

    def recorded(*args):
        out = op(*args)
        calls.append((args, out))
        return out
    with mock.patch.object(blocks, "mamba_scan_op", recorded):
        yield calls


def scans_held_to_plain(calls):
    """Each recorded scan (:func:`record_scans`, one a Mamba layer) held
    to the plain version on its own inputs, within the op's TOL of the
    terms' scale (``ops.held_to_plain``), so that the check sees the
    recurrence at the model's own inputs (next to the D skip, the states
    add about 1% to y there).  Empties ``calls``; returns a row a
    layer."""
    from repro_torch.kernels.mamba_scan import ops
    rows = [ops.held_to_plain(args, *out) for args, out in calls]
    calls.clear()
    return rows


def compare_caches(cfg, caches, want):
    """Every layer's cache against ``want``'s (MLA's ``ckv`` and ``kr``, a
    Mamba layer's ``conv`` and ``h``, a GQA layer's K and V): ``{name:
    (max abs error, largest |want|, worst)}`` over the layers, and each
    layer's largest error."""
    from repro_torch.models import lm
    acc, by_layer = {}, []
    for slot, r, _ in lm._layers(cfg):
        got, ref = (lm._get(c, slot, r)["mixer"] for c in (caches, want))
        worst_layer = 0.0
        for key in got:
            c = lm_compare(got[key], ref[key])
            acc[key] = [max(x, y) for x, y in zip(acc.get(key, c), c)]
            worst_layer = max(worst_layer, c[0])
        by_layer.append(worst_layer)
    return {k: tuple(v) for k, v in acc.items()}, by_layer


def against_plain(cfg, params, prompts, logits, caches, routes, plain):
    """The prefill that gave ``logits``/``caches`` (its MoE ``routes``)
    run again with the ops ``plain`` names on their plain versions (which
    must launch nothing), keeping each layer's input: logits and every
    layer's cache, each MoE layer's route agreement between the two runs,
    every layer held from the plain run's input, and the cache handoff
    with the kernels and with the plain versions, beside its gap to
    ``logits`` and the routes its step dropped."""
    import torch
    from repro_torch.models import lm

    inputs, layer = [], lm._apply_layer_seq

    def keep_input(cfg_, p, spec, x, **kw):
        inputs.append(x)
        return layer(cfg_, p, spec, x, **kw)
    before = scan_attention_launches()
    with plain_ops(*plain), \
            mock.patch.object(lm, "_apply_layer_seq", keep_input), \
            record_routes() as routes_p:
        t0 = time.perf_counter()
        logits_p, caches_p = lm.prefill(cfg, params, prompts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    plain_launches = sum(scan_attention_launches()) - sum(before)
    cache_cmp, by_layer = compare_caches(cfg, caches, caches_p)
    del caches_p
    layers = layers_from_plain(cfg, params, inputs, plain)
    del inputs
    before = scan_attention_launches()
    step, step_drops = moe_handoff(cfg, params, prompts)
    with plain_ops(*plain):
        step_p, _ = moe_handoff(cfg, params, prompts)
    torch.cuda.synchronize()
    handoff = [a - b for a, b in zip(scan_attention_launches(), before)]

    def named(got, want):
        return dict(zip(("max_abs_err", "max_abs", "worst"),
                        lm_compare(got[..., :cfg.vocab_size],
                                   want[..., :cfg.vocab_size])))
    return {
        "plain_prefill_s": seconds,
        "plain_path_launches": plain_launches,
        "handoff_launches": {"mamba_scan": handoff[0],
                             "flash_attention": handoff[1]},
        "vs_plain": {
            "logits": named(logits, logits_p),
            **{k: dict(zip(("max_abs_err", "max_abs", "worst"), v))
               for k, v in cache_cmp.items()}},
        "cache_max_abs_err_by_layer": by_layer,
        "route_agreement_by_layer": route_agreement(routes, routes_p),
        "routes": len(routes) and int(routes[0][0].numel()),
        "prefill_routes_dropped": routes_dropped(routes),
        "layers_from_plain_input": layers,
        "handoff_vs_plain": named(step, step_p),
        # not a check: the step's capacity (C = 1) drops routes the
        # prefill keeps
        "handoff_vs_prefill": named(step, logits),
        "handoff_step_routes_dropped": step_drops}


def _f32_in_place(tree):
    """Each tensor of ``tree`` (dicts and lists, in tuples too) replaced
    by its f32 copy one at a time, so that each bf16 leaf is freed as its
    copy is made (an f32 leaf stays as it is)."""
    import torch
    keys = (range(len(tree)) if isinstance(tree, (list, tuple))
            else list(tree))
    for k in keys:
        v = tree[k]
        if isinstance(v, torch.Tensor):
            tree[k] = v.float()
        else:
            _f32_in_place(v)


def run_jamba_lm_slice(dev, smi, scan_arrays):
    """prefill -> serve_step of jamba-v0.1-52b at full width and one
    period of its pattern (7 Mamba layers on mamba_scan, 1 GQA layer on
    flash_attention, MoE on every other layer) through the port's entry
    points, held against the same model with both ops on their plain
    versions (the MoE routes compared too), in bf16 and as an f32 copy of
    the same weights; then the scan's time at the prefill shape
    (``scan_arrays``: its inputs there).  Returns the generate loop's
    (mamba_scan, flash_attention) launches and the kernel's times."""
    import gc

    import torch
    from repro_torch.configs.base import get_config, with_repeats
    from repro_torch.kernels import registry
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm

    gc.collect()  # the weights of the slices before
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = with_repeats(get_config(JAMBA_ARCH), JAMBA_REPEATS)
    seconds = {}
    t_phase = t0 = time.perf_counter()
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
    with record_routes() as routes, record_scans() as scans:
        logits, caches = lm.prefill(cfg, params, prompts)
        torch.cuda.synchronize()
    seconds["prefill"] = time.perf_counter() - t0
    plain_calls = sum(s.plain_calls for s in registry.all_specs())
    prefill_launches = scan_attention_launches()
    scans_bf16 = scans_held_to_plain(scans)
    bf16 = against_plain(cfg, params, prompts, logits, caches, routes,
                         JAMBA_PLAIN)
    del caches, routes
    bf16["without_drops"] = handoff_without_drops(cfg, params, prompts)
    _, traced_prefill_s, prefill_busy_s, prefill_kernels = device_busy(
        lambda: lm.prefill(cfg, params, prompts), JAMBA_KERNEL_GROUPS)

    registry.reset_counts()
    res = serve_lm.generate(cfg, params, prompts, LM_GEN)
    gen_launches = scan_attention_launches()
    record_flash_launches("jamba_lm_slice")
    tokens = res["tokens"]
    finite = bool(torch.isfinite(logits).all()
                  and torch.isfinite(res["logits"]).all())

    # the card's busy share over the same decode loop, traced
    steps = LM_GEN - 1
    first, caches = lm.prefill(cfg, params, prompts,
                               cache_len=LM_PROMPT + LM_GEN)

    def decode_loop():
        tok = first.argmax(-1)[:, None]
        for i in range(steps):
            out, _ = lm.serve_step(cfg, params, caches, tok, LM_PROMPT + i)
            tok = out.argmax(-1)[:, None]
        return tok
    _, traced_s, busy_s = device_busy(decode_loop)
    del caches, first
    bf16_peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the same weights in f32, each leaf copied as its bf16 one is freed
    # (54 GB; a capacity that drops nothing would need 22 GB more)
    cfg32 = cfg.replace(dtype="float32")
    _f32_in_place(params)
    gc.collect()
    torch.cuda.empty_cache()
    registry.reset_counts()
    with record_routes() as routes32, record_scans() as scans:
        logits32, caches32 = lm.prefill(cfg32, params, prompts)
    torch.cuda.synchronize()
    f32_launches = scan_attention_launches()
    scans_f32 = scans_held_to_plain(scans)
    f32 = against_plain(cfg32, params, prompts, logits32, caches32,
                        routes32, JAMBA_PLAIN)
    finite = finite and bool(torch.isfinite(logits32).all())
    del params, caches32, routes32
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()

    timing = time_mamba_scan(dev, scan_arrays, smi)
    seconds["phase"] = time.perf_counter() - t_phase
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * JAMBA_REPEATS
    n_gqa = cfg.n_layers - n_mamba
    bf16_ok, bf16_how = moe_within(bf16, LM_TOL_BF16)
    f32_ok, f32_how = moe_within(f32, LM_TOL_F32)
    checks = {
        "prefill_launches_one_per_layer":
        prefill_launches == (n_mamba, n_gqa) and plain_calls == 0
        and f32_launches == (n_mamba, n_gqa),
        "plain_path_launched_nothing": bf16["plain_path_launches"] == 0
        and f32["plain_path_launches"] == 0,
        # two prefills of 2,047 tokens (kernels, then plain) and two steps:
        # the step attends through the kernel and scans in plain torch
        "handoff_launches": all(
            r["handoff_launches"] == {"mamba_scan": n_mamba,
                                      "flash_attention": 2 * n_gqa}
            for r in (bf16, f32)),
        "generate_launches_scan_in_prefill_attention_every_call":
        gen_launches == (n_mamba, n_gqa * LM_GEN),
        "logits_finite": finite,
        "logits_shape": tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab),
        "bf16_matches_plain_and_handoff": bf16_ok,
        "f32_matches_plain_and_handoff": f32_ok,
        # each layer's scan at the model's own inputs, at the kernel's
        # tolerance: the logits and caches above barely see the states
        "scans_within_tol_every_layer": all(
            len(rows) == n_mamba
            and all(max(r["worst_vs_terms"].values()) <= 1.0 for r in rows)
            for rows in (scans_bf16, scans_f32)),
        "tokens": tuple(tokens.shape) == (LM_BATCH, LM_GEN)
        and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
    }
    numbers = dict(
        prefill_s=seconds["prefill"], decode_s=res["decode_s"],
        generate_prefill_s=res["prefill_s"],
        decode_ms_per_step=res["decode_s"] / steps * 1e3,
        tokens_per_s=LM_BATCH * steps / res["decode_s"],
        decode_traced_s=traced_s, decode_busy_s=busy_s,
        decode_busy_share=busy_s / traced_s if busy_s else None,
        kernel_ms_prefill=timing["ms"],
        kernel_share_of_prefill=n_mamba * timing["ms"]
        / (seconds["prefill"] * 1e3), bf16_peak_gib=bf16_peak_gib,
        peak_gib=peak_gib, prefill_traced_s=traced_prefill_s,
        prefill_busy_s=prefill_busy_s, prefill_kernel_s=prefill_kernels)
    emit("jamba_lm_slice", arch=cfg.name, n_layers=cfg.n_layers,
         pattern_repeats=JAMBA_REPEATS, mamba_layers=n_mamba,
         gqa_layers=n_gqa, d_model=cfg.d_model, d_inner=cfg.mamba_d_inner,
         d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
         dt_rank=cfg.dt_rank, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, experts=cfg.n_experts, top_k=cfg.top_k,
         expert_ff=cfg.moe_d_ff, d_ff=cfg.d_ff,
         capacity_factor=cfg.capacity_factor, vocab=cfg.vocab_size,
         max_pos=cfg.max_pos, dtype=cfg.dtype, params=n_params,
         batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, seconds=seconds,
         launches={"prefill": prefill_launches, "generate": gen_launches,
                   "f32_prefill": f32_launches,
                   "order": ["mamba_scan", "flash_attention"]},
         bf16=bf16, f32=f32, bf16_held=bf16_how, f32_held=f32_how,
         scans_vs_plain={"bf16": scans_bf16, "f32": scans_f32},
         tol_bf16=LM_TOL_BF16, tol_f32=LM_TOL_F32, timing=timing,
         sample=tokens[0, :8].tolist(), nvidia_smi=smi, **numbers, **checks)
    if not all(checks.values()):
        raise AssertionError(f"jamba lm slice checks failed: {checks}")
    return gen_launches, timing


def time_whisper_attention(dev, smi):
    """flash_attention at whisper's four shapes (bf16): the causal
    encoder, the cross prefill, and a decode step's self and cross
    attention (also from CUDA graphs, with their two kernels alone),
    beside its plain version, SDPA and the bound."""
    return time_lm_attention(dev, smi, "whisper_lm", (
        ("encoder", WHISPER_ENCODER, None, 10),
        ("cross prefill", WHISPER_CROSS, None, 10),
        ("decode self", WHISPER_SELF_STEP, WHISPER_PROMPT + 1, 200),
        ("decode cross", WHISPER_CROSS_STEP, WHISPER_FRAMES, 200)),
        seed=130)


def run_whisper_lm_slice(dev, smi):
    """prefill -> serve_step of whisper-medium at full width and depth
    through ``serve_lm.generate``, every attention (encoder, decoder
    self, cross) on flash_attention, held against the same model with
    attention computed by the kernel's plain version, in its bf16 and as
    an f32 copy; then the kernel's times at this path's four shapes.
    Returns the generate loop's flash_attention launches and the
    kernel's times."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm

    cfg = get_config(WHISPER_ARCH)
    if (cfg.enc_ctx, serve_lm.ENC_DEC_PROMPT) != (WHISPER_FRAMES,
                                                  WHISPER_PROMPT):
        raise AssertionError("whisper's shapes moved: update WHISPER_*")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    t_phase = t0 = time.perf_counter()
    params = lm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    seconds["init_params"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, WHISPER_PROMPT),
                            generator=g, device=dev)
    frames = serve_lm.enc_embeds_for(cfg, LM_BATCH, g)
    lm.prefill(cfg, params, prompts, enc_embeds=frames)  # warm-up

    registry.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, prompts, enc_embeds=frames)
    torch.cuda.synchronize()
    seconds["prefill"] = time.perf_counter() - t0
    prefill_launches = (ops.SPEC.launches, ops.SPEC.plain_calls)
    prefill_kernels = flash_kernel_launches()
    _, traced_prefill_s, prefill_busy_s, prefill_by_kind = device_busy(
        lambda: lm.prefill(cfg, params, prompts, enc_embeds=frames),
        PREFILL_KERNEL_GROUPS)
    bf16 = gqa_against_plain(cfg, params, prompts, logits, caches, frames)
    del caches

    registry.reset_counts()
    res = serve_lm.generate(cfg, params, prompts, LM_GEN, enc_embeds=frames)
    gen_launches = ops.SPEC.launches
    gen_kernels = record_flash_launches("whisper_lm_slice")
    tokens = res["tokens"]
    finite = bool(torch.isfinite(logits).all()
                  and torch.isfinite(res["logits"]).all())

    # the card's busy share over the same decode loop, traced
    steps = LM_GEN - 1
    first, caches = lm.prefill(cfg, params, prompts, enc_embeds=frames,
                               cache_len=WHISPER_PROMPT + LM_GEN)

    def decode_loop():
        tok = first.argmax(-1)[:, None]
        for i in range(steps):
            out, _ = lm.serve_step(cfg, params, caches, tok,
                                   WHISPER_PROMPT + i)
            tok = out.argmax(-1)[:, None]
        return tok
    _, traced_s, busy_s = device_busy(decode_loop)
    del caches

    # the same weights in f32: the kernel's own differences, without
    # bf16 rounding of the activations to amplify them layer by layer
    cfg32 = cfg.replace(dtype="float32")
    params32, frames32 = _cast(params, torch.float32), frames.float()
    del params
    registry.reset_counts()
    logits32, caches32 = lm.prefill(cfg32, params32, prompts,
                                    enc_embeds=frames32)
    torch.cuda.synchronize()
    f32_launches = ops.SPEC.launches
    f32_kernels = flash_kernel_launches()
    f32 = gqa_against_plain(cfg32, params32, prompts, logits32, caches32,
                            frames32)
    finite = finite and bool(torch.isfinite(logits32).all())
    del params32, caches32
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    timing = time_whisper_attention(dev, smi)
    seconds["phase"] = time.perf_counter() - t_phase
    L, Le = cfg.n_layers, cfg.enc_layers
    per_prefill, per_step = Le + 2 * L, 2 * L
    checks = {
        # 24 encoder, 24 decoder self, 24 cross: all on the prefill kernel
        "prefill_launches_72": prefill_launches == (per_prefill, 0)
        and f32_launches == per_prefill,
        "prefill_on_the_bf16_prefill_kernel": prefill_kernels == {
            "flash_attention_f32": 0,
            "flash_attention_bf16_prefill": per_prefill,
            "flash_attention_bf16_decode": 0,
            "flash_attention_bf16_combine": 0}
        and f32_kernels["flash_attention_f32"] == per_prefill,
        "plain_path_launched_nothing": bf16["plain_path_launches"] == 0
        and f32["plain_path_launches"] == 0,
        "int8_handoff_launches_72_and_48": all(
            r["int8_handoff_launches"] == per_prefill + per_step
            for r in (bf16, f32)),
        "cross_caches_in_the_model_dtype":
        bf16["cross_cache_dtypes"] == ["bfloat16"]
        and f32["cross_cache_dtypes"] == ["float32"],
        "generate_launches_72_then_48_a_step":
        gen_launches == per_prefill + per_step * steps,
        # the prefill on the bf16 prefill kernel, each step's 48 on the
        # decode kernel and its combine, none on the f32 design
        "generate_on_the_bf16_kernels": gen_kernels == {
            "flash_attention_f32": 0,
            "flash_attention_bf16_prefill": per_prefill,
            "flash_attention_bf16_decode": per_step * steps,
            "flash_attention_bf16_combine": per_step * steps},
        "logits_finite": finite,
        "logits_shape": tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab),
        "bf16_matches_plain_attention_and_handoffs":
        gqa_within(bf16, LM_TOL_BF16),
        "f32_matches_plain_attention_and_handoffs":
        gqa_within(f32, LM_TOL_F32),
        "tokens": tuple(tokens.shape) == (LM_BATCH, LM_GEN)
        and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
    }
    numbers = dict(
        prefill_s=seconds["prefill"], decode_s=res["decode_s"],
        generate_prefill_s=res["prefill_s"],
        decode_ms_per_step=res["decode_s"] / steps * 1e3,
        tokens_per_s=LM_BATCH * steps / res["decode_s"],
        decode_traced_s=traced_s, decode_busy_s=busy_s,
        decode_busy_share=busy_s / traced_s if busy_s else None,
        prefill_traced_s=traced_prefill_s, prefill_busy_s=prefill_busy_s,
        prefill_kernel_s=prefill_by_kind,
        kernel_ms_encoder=timing["encoder"]["ms"],
        kernel_ms_cross_prefill=timing["cross prefill"]["ms"],
        kernel_graph_ms_decode_self=timing["decode self"]["graph_ms"],
        kernel_graph_ms_decode_cross=timing["decode cross"]["graph_ms"],
        kernel_share_of_prefill=(Le * timing["encoder"]["ms"]
                                 + L * timing["cross prefill"]["ms"])
        / (seconds["prefill"] * 1e3), peak_gib=peak_gib)
    emit("whisper_lm_slice", arch=cfg.name, enc_layers=Le, n_layers=L,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         padded_vocab=cfg.padded_vocab, dtype=cfg.dtype, params=n_params,
         batch=LM_BATCH, prompt=WHISPER_PROMPT, frames=WHISPER_FRAMES,
         gen=LM_GEN, seconds=seconds,
         launches={"prefill": prefill_launches[0],
                   "prefill_by_kernel": prefill_kernels,
                   "generate": gen_launches, "f32_prefill": f32_launches,
                   "generate_by_kernel": gen_kernels},
         bf16=bf16, f32=f32, tol_bf16=LM_TOL_BF16, tol_f32=LM_TOL_F32,
         sample=tokens[0, :8].tolist(), nvidia_smi=smi, **numbers, **checks)
    if not all(checks.values()):
        raise AssertionError(f"whisper lm slice checks failed: {checks}")
    return gen_launches, timing


def attention_bwd_cell(shape, dtype, dev, seed):
    """flash_attention_bwd at a training shape (v ``hdv`` wide where the
    shape names it): its inputs (o from the plain version, a seeded
    cotangent), the bound (q, k, v, o and dO read once and dq, dk, dv
    written once, against the five causal products of the gradient, S,
    dS K and dS^T Q at hd and dO V^T and P^T dO at hdv, 2 operations a
    visible pair and head column each, at the bf16 tensor-core peak for
    bf16 inputs, the f32 CUDA-core peak for f32), the bound of the
    ``BWD_PRODUCTS`` products the kernel does as it does them
    (``bound_ms_design``: five at hd and three at hdv, bf16 ``mma.sync``
    at the bf16 peak, or 3xTF32, three TF32 products each, at the TF32
    peak), and one PyTorch call for the same function:
    ``scaled_dot_product_attention``'s forward and backward (K/V
    repeated per group), minus its forward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = attention_inputs(shape, dev, seed, dtype=dtype)
    o = flash_attention_ref(q, k, v, causal=True)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(o.shape, generator=g).to(device=dev, dtype=dtype)
    b, sq, h, kvh, hd = (shape[n] for n in ("b", "sq", "h", "kv", "hd"))
    hdv = shape.get("hdv", hd)
    pairs = b * h * sq * (sq + 1) // 2
    flops = 2 * (3 * hd + 2 * hdv) * pairs
    nbytes = q.element_size() * (2 * (q.numel() + k.numel() + v.numel())
                                 + 2 * o.numel())
    peak = PEAK_F16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    design_flops = 2 * (5 * hd + 3 * hdv) * pairs
    t_design = (design_flops / PEAK_F16_FLOPS if dtype == torch.bfloat16
                else 3 * design_flops / PEAK_TF32_FLOPS)
    group = h // kvh
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
              .requires_grad_() for t in (k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)
    return dict(arrays=(q, k, v, o, do), sdpa_fwd=sdpa_fwd,
                sdpa_fwd_bwd=sdpa_fwd_bwd,
                library_backend=sdpa_backend(qt, kt, vt, True),
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                products_design=BWD_PRODUCTS,
                bound_ms_design=max(t_design, t_bytes) * 1e3,
                flops=flops, flops_design=design_flops, bytes=nbytes,
                seen_pairs=pairs)


def check_flash_bwd(dev, smi):
    """flash_attention_bwd at the two training shapes (llama3.2-3b's, and
    deepseek-v2-lite's MLA at q.k 192 / v 128), in f32 and bf16, against
    the plain backward (``TOL_BWD``) and autograd of the plain version
    (``bwd_autograd_tol``), two launches bit for bit, then its CUDA-event
    time beside the plain backward's, SDPA's backward, the bound of the
    five products the gradient needs and that of the ones it does.
    Returns the bf16 lines (the training path's dtype), by shape."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)

    out = {}
    for label, shape in (("llama3.2-3b", LMT_ATTN), ("mla", MLA_TRAIN_ATTN)):
        for dtype in (torch.float32, torch.bfloat16):
            cell = attention_bwd_cell(shape, dtype, dev, seed=120)
            q, k, v, o, do = cell.pop("arrays")
            sdpa_fwd = cell.pop("sdpa_fwd")
            sdpa_fwd_bwd = cell.pop("sdpa_fwd_bwd")

            def kernel():
                return flash_attention_bwd(q, k, v, o, do, causal=True)

            def plain():
                return flash_attention_bwd_ref(q, k, v, o, do, causal=True)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            want = plain()
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            auto = torch.autograd.grad(flash_attention_ref(qq, kk, vv),
                                       (qq, kk, vv), do)
            del qq, kk, vv
            group = shape["h"] // shape["kv"]
            names = ("dq", "dk", "dv")

            def rel(a, b):
                return ((a.float() - b.float()).abs().max()
                        / b.float().abs().max()).item()
            vs_plain = {n: rel(a, b) for n, a, b in zip(names, got, want)}
            vs_auto = {n: rel(a, b) for n, a, b in zip(names, got, auto)}
            max_abs = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, auto))
            shapes_ok = all(a.shape == b.shape and a.dtype == b.dtype
                            for a, b in zip(got, want))
            del got, want, auto
            tol = ops.TOL_BWD[dtype]
            tol_auto = ops.bwd_autograd_tol(dtype, group)
            ok = (same_bits and shapes_ok and max(vs_plain.values()) <= tol
                  and max(vs_auto.values()) <= tol_auto)
            line = dict(
                cell, dtype=str(dtype).removeprefix("torch."), model=label,
                shape=shape, vs_plain_backward=vs_plain, tol=tol,
                vs_autograd_of_plain=vs_auto, tol_autograd=tol_auto,
                max_abs_err=max_abs, bit_identical_relaunch=same_bits,
                ms=cuda_ms(kernel, 5), plain_ms=cuda_ms(plain, 2))
            fwd_ms = cuda_ms(sdpa_fwd, 10)
            fwd_bwd_ms = cuda_ms(sdpa_fwd_bwd, 10)
            line.update(
                library_ms=fwd_bwd_ms - fwd_ms, library_fwd_bwd_ms=fwd_bwd_ms,
                library_call="torch.nn.functional.scaled_dot_product_"
                             "attention forward + backward minus its "
                             "forward, K/V repeated per group",
                share_of_bound=cell["bound_ms"] / line["ms"],
                design_share_of_bound=cell["bound_ms_design"] / line["ms"])
            emit("kernel", kernel="flash_attention_bwd", nvidia_smi=smi,
                 **line)
            if not ok:
                raise AssertionError(
                    f"flash_attention_bwd at the {label} training shape "
                    f"({dtype}): {vs_plain} (tol {tol}), {vs_auto} (tol "
                    f"{tol_auto}), bit-identical relaunch {same_bits}, "
                    f"shapes and dtypes {shapes_ok}")
            if line["dtype"] == "bfloat16":
                out[label] = line
            del q, k, v, o, do
    return out


def rwkv6_bwd_bound(problem):
    """(bound_ms, bound_by, bound_f32_ms, bytes, flops) of one WKV
    backward without a cotangent on the final state (as in training): r,
    k, v, w and do read and dr, dk, dv and dw written once in the
    problem's dtype, u and s0 read and du and ds0 written in f32;
    ``RWKV_BWD_OPS`` hd^2 f32 operations per (b, t, h).  The kernel runs
    its products in 3xTF32 on the tensor cores, so ``bound_ms`` takes the
    operations at that rate (``tc_bound_ms``); ``bound_f32_ms`` takes them
    at the CUDA cores' f32 rate, the bound of a design that walks every
    step on the CUDA cores."""
    b, t, h, hd = (problem[k] for k in ("b", "t", "h", "hd"))
    el = 4 if problem["dtype"] == "float32" else 2
    nbytes = el * 9 * b * t * h * hd + 4 * 2 * (h * hd + b * h * hd * hd)
    flops = RWKV_BWD_OPS * hd * hd * b * t * h
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (tc_bound_ms(flops, nbytes),
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3, nbytes, flops)


def model_decays(arrays, generator, dev):
    """The WKV inputs with w as rwkv6's mixer makes it, exp(-exp(c)) for
    c uniform in [-6, 1] (0.066 to 0.998; ``make_call`` draws 0.7 to
    0.999)."""
    import torch
    w = arrays[3]
    c = torch.rand(w.shape, generator=generator) * 7.0 - 6.0
    return (*arrays[:3], torch.exp(-torch.exp(c)).to(dev, w.dtype),
            *arrays[4:])


def check_rwkv6_bwd(dev, smi):
    """rwkv6_chunk_bwd against the plain backward and against autograd of
    the plain version (each gradient's largest error over its largest
    magnitude within ``ops.TOL_BWD``), a relaunch bit for bit, at the
    rwkv6-1.6b training shape (no cotangent on the final state, as in
    training) with ``make_call``'s decays and with the model's, T 1 and
    33, head sizes 8, 24, 64 and 128, bf16 inputs, all from s0 != 0 and
    the others with a cotangent on the final state; then its CUDA-event
    time at the training shape beside the plain backward's, the
    forward's, the bound (3xTF32) and the CUDA-core f32 bound, and the
    device time a launch of each kernel whose name starts with
    ``rwkv6_bwd_`` over 20 calls (``device_busy``'s top kernels, so any
    design of the backward splits the same way).  Returns the training
    shape's line."""
    import re

    import torch
    from repro_torch.kernels.rwkv6_chunk import ops
    from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk as rwkv
    from repro_torch.kernels.rwkv6_chunk.ref import (rwkv6_chunk_bwd_ref,
                                                     rwkv6_chunk_ref)

    default = ops.SPEC.default_problems[0]
    cases = [
        ("rwkv6-1.6b training", RWKV_TRAIN, False),
        ("rwkv6-1.6b training, model decays", RWKV_TRAIN, False),
        ("T 1", dict(RWKV_TRAIN, t=1), True),
        ("T 33", dict(default, t=33), True),
        ("hd 8", dict(default, hd=8), True),
        ("hd 24", dict(default, t=33, hd=24), True),
        ("hd 64", dict(default, t=100, h=4, hd=64), True),
        ("hd 128", dict(default, t=100, h=4, hd=128), True),
        ("bf16", dict(default, t=100, h=4, hd=64, dtype="bfloat16"), True),
        ("hd 128 bf16", dict(default, t=33, hd=128, dtype="bfloat16"), True),
    ]
    names = ("dr", "dk", "dv", "dw", "du", "ds0")

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
    results, failures = {}, []
    for i, (label, problem, with_dsT) in enumerate(cases):
        arrays = ops.SPEC.make_call(
            problem, torch.Generator().manual_seed(80 + i), dev)
        if "model decays" in label:
            arrays = model_decays(arrays, torch.Generator().manual_seed(70),
                                  dev)
        o, sT = rwkv6_chunk_ref(*arrays)
        g = torch.Generator().manual_seed(90 + i)
        do = torch.randn(o.shape, generator=g).to(device=dev, dtype=o.dtype)
        dsT = (torch.randn(sT.shape, generator=g).to(dev) if with_dsT
               else None)
        got = rwkv.rwkv6_chunk_bwd(*arrays, do, dsT, sT=sT)
        again = rwkv.rwkv6_chunk_bwd(*arrays, do, dsT, sT=sT)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = rwkv6_chunk_bwd_ref(*arrays, do, dsT)
        leaves = [a.clone().requires_grad_() for a in arrays]
        o2, s2 = rwkv6_chunk_ref(*leaves)
        auto = torch.autograd.grad(
            (o2, s2) if with_dsT else (o2,), leaves,
            (do, dsT) if with_dsT else (do,))
        del leaves, o2, s2
        tol = ops.TOL_BWD[arrays[0].dtype]
        res = {"vs_plain_backward": {n: rel(a, b) for n, a, b in
                                     zip(names, got, want)},
               "vs_autograd_of_plain": {n: rel(a, b) for n, a, b in
                                        zip(names, got, auto)},
               "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, want)),
               "bit_identical_relaunch": same, "tol": tol,
               "dsT": with_dsT, "launch": rwkv.bwd_launch_shape(
                   problem["hd"])}
        results[label] = res
        if not (same and max(res["vs_plain_backward"].values()) <= tol
                and max(res["vs_autograd_of_plain"].values()) <= tol
                and all(a.dtype == b.dtype for a, b in zip(got, want))):
            failures.append(f"rwkv6_chunk_bwd {label}: {res}")
        if label == "rwkv6-1.6b training":
            train = (arrays, do, sT)
        del got, want, auto
    arrays, do, sT = train

    def kernel():
        return rwkv.rwkv6_chunk_bwd(*arrays, do, None, sT=sT)

    def plain():
        return rwkv6_chunk_bwd_ref(*arrays, do)
    bound_ms, bound_by, bound_f32, nbytes, flops = rwkv6_bwd_bound(
        RWKV_TRAIN)
    ms = cuda_ms(kernel, 10)
    *_, by = device_busy(lambda: [kernel() for _ in range(20)], {})
    kernels_ms = {}
    for name, s, n in by["top_kernels"]:
        m = re.search(r"rwkv6_bwd_\w+", name)
        if m:
            kernels_ms[m.group(0)] = {"ms": s * 1e3 / n,
                                      "launches_traced": n, "calls": 20}
    line = dict(
        cases=results, shape=RWKV_TRAIN, ms=ms, kernels_ms=kernels_ms,
        plain_ms=cuda_ms(plain, 1, warmup=1),
        fwd_ms=cuda_ms(lambda: ops.SPEC.run_call(RWKV_TRAIN, arrays, {}), 10),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms, bound_f32_ms=bound_f32,
        share_of_bound_f32=bound_f32 / ms, bytes=nbytes, flops=flops,
        max_abs_err=results["rwkv6-1.6b training"]["max_abs_err"],
        launch=rwkv.bwd_launch_shape(RWKV_TRAIN["hd"]), ok=not failures)
    emit("kernel", kernel="rwkv6_chunk_bwd", nvidia_smi=smi, **line)
    if failures:
        raise AssertionError("; ".join(failures))
    return line


def mamba_bwd_bound(problem):
    """(bound_ms, bound_by, bytes, operations) of one selective-scan
    backward without a cotangent on the final state (as in training): dt,
    x, Bm and Cm read and ddt, dx, dBm and dCm written once in the
    problem's dtype, dy read in f32, A, D and h0 read and dA, dD and dh0
    written in f32; its operations one
    exp2 a state and step on the SFUs (``SFU_EXP2_PER_CLOCK_SM`` x SMs x
    ``sm_clock_hz``) beside ``MAMBA_BWD_OPS`` f32 operations a state and
    step at the f32 peak, the larger of the two.  ``operations`` also
    names the kernel design's own exps (``MAMBA_BWD_DESIGN_EXPS`` a state
    and step) and its bound on the SFUs alone."""
    import torch
    b, s, di, ds = (problem[k] for k in ("b", "s", "di", "ds"))
    el = 4 if problem["dtype"] == "float32" else 2
    nbytes = el * (4 * b * s * di + 4 * b * s * ds) + 4 * b * s * di \
        + 4 * (2 * di * ds + 2 * di + 2 * b * di * ds)
    steps = b * s * di * ds
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu = SFU_EXP2_PER_CLOCK_SM * sms * sm_clock_hz()
    t_ops = max(steps / sfu, MAMBA_BWD_OPS * steps / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nbytes,
            {"exp2": steps, "f32": MAMBA_BWD_OPS * steps, "sfu_per_s": sfu,
             "sms": sms, "exp2_ms": steps / sfu * 1e3,
             "f32_ms": MAMBA_BWD_OPS * steps / PEAK_F32_FLOPS * 1e3,
             "bytes_ms": t_bytes * 1e3,
             "design_exp2": MAMBA_BWD_DESIGN_EXPS * steps,
             "design_exp2_ms": MAMBA_BWD_DESIGN_EXPS * steps / sfu * 1e3})


def check_mamba_scan_bwd(dev, smi):
    """mamba_scan_bwd against the plain backward and against autograd of
    the plain version (each gradient's largest error over its largest
    magnitude within ``ops.TOL_BWD``), a relaunch bit for bit: jamba's
    training shape (``JAMBA_TRAIN_SCAN``, no cotangent on the final state,
    as in training) in bf16 and f32, decays underflowing (dt up to
    ``MAMBA_UNDERFLOW_DT``), d_state 8, S 70 (a ragged last chunk), S 1,
    di 200 (a partial block) and 201 (bf16 rows not 4-byte aligned: dt
    and x staged element by element), the others from h0 != 0 with a
    cotangent on the final state; each from the states the forward kernel
    kept (``keep_states``).  Autograd of the plain version keeps
    about 10.6 B S di ds f32 (22.8 GB at the training shape): it fits a
    card that holds nothing else, as here.  Then
    its CUDA-event time at the training shape in bf16 and f32, each of
    its kernels' device time a launch (torch.profiler over 20 calls), the
    plain backward's time, the forward's at the same shape without and
    with its kept states (in turns: without, with, with, without), the
    backward at B 1 (half the blocks: one an SM) and
    ``mamba_bwd_bound``; and the SASS of one lane-step of the walk
    (``bwd_sass_loops``).  Raises on any failure; returns the training
    shape's line."""
    import re

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan as scan
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_bwd_ref,
                                                    mamba_scan_ref)

    small = ops.SPEC.default_problems[0]
    cases = [
        ("jamba training bf16", JAMBA_TRAIN_SCAN, False),
        ("jamba training f32", dict(JAMBA_TRAIN_SCAN, dtype="float32"),
         False),
        ("underflow", small, True),
        ("underflow bf16", dict(small, dtype="bfloat16"), True),
        ("ds 8", dict(small, ds=8), True),
        ("ds 8 bf16", dict(small, ds=8, dtype="bfloat16"), True),
        ("S 70, di 200", small, True),
        ("S 70, di 200 bf16", dict(small, dtype="bfloat16"), True),
        ("di 201 bf16", dict(small, di=201, dtype="bfloat16"), True),
        ("S 1", dict(JAMBA_TRAIN_SCAN, s=1, dtype="float32"), True),
        ("S 1 bf16", dict(small, s=1, dtype="bfloat16"), True),
    ]
    names = ("ddt", "dx", "dBm", "dCm", "dA", "dD", "dh0")

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
    results, failures, timed = {}, [], {}
    for i, (label, problem, with_dhT) in enumerate(cases):
        gen = torch.Generator().manual_seed(140 + i)
        arrays = (mamba_underflow_case(problem, gen, dev)
                  if label.startswith("underflow")
                  else ops.SPEC.make_call(problem, gen, dev))
        B, S, di = arrays[0].shape
        dy = torch.randn((B, S, di), generator=gen).to(dev)
        dhT = (torch.randn(tuple(arrays[6].shape), generator=gen).to(dev)
               if with_dhT else None)
        states = scan.mamba_scan(*arrays, keep_states=True)[2]
        got = scan.mamba_scan_bwd(*arrays, dy, dhT, states=states)
        again = scan.mamba_scan_bwd(*arrays, dy, dhT, states=states)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = mamba_scan_bwd_ref(*arrays, dy, dhT)
        tol = ops.TOL_BWD[arrays[0].dtype]
        res = {"vs_plain_backward": {n: rel(a, b) for n, a, b in
                                     zip(names, got, want)},
               "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, want)),
               "finite": all(bool(torch.isfinite(a.float()).all())
                             for a in got),
               "dtypes_match": all(a.dtype == b.dtype
                                   for a, b in zip(got, arrays)),
               "bit_identical_relaunch": same, "tol": tol, "dhT": with_dhT,
               "launch": scan.bwd_launch_shape(B, S, di)}
        del want
        torch.cuda.empty_cache()
        leaves = [a.clone().requires_grad_() for a in arrays]
        y, hT = mamba_scan_ref(*leaves)
        auto = torch.autograd.grad(
            (y, hT) if with_dhT else (y,), leaves,
            (dy, dhT) if with_dhT else (dy,))
        del leaves, y, hT
        res["vs_autograd_of_plain"] = {n: rel(a, b) for n, a, b in
                                       zip(names, got, auto)}
        del auto
        torch.cuda.empty_cache()
        results[label] = res
        if not (same and res["finite"] and res["dtypes_match"]
                and max(res["vs_plain_backward"].values()) <= tol
                and max(res["vs_autograd_of_plain"].values()) <= tol):
            failures.append(f"mamba_scan_bwd {label}: {res}")
        if label.startswith("jamba training"):
            timed[problem["dtype"]] = (arrays, dy, states)
        del got, states
    line = dict(cases=results, shape=JAMBA_TRAIN_SCAN, design=MAMBA_BWD_DESIGN,
                max_abs_err=results["jamba training bf16"]["max_abs_err"],
                launch=scan.bwd_launch_shape(*(JAMBA_TRAIN_SCAN[k]
                                               for k in ("b", "s", "di"))),
                library_ms=None)
    for dtype, (arrays, dy, states) in timed.items():
        problem = dict(JAMBA_TRAIN_SCAN, dtype=dtype)

        def kernel():
            return scan.mamba_scan_bwd(*arrays, dy, states=states)
        ms = cuda_ms(kernel, 10)
        *_, by = device_busy(lambda: [kernel() for _ in range(20)], {})
        kernels_ms = {}
        for name, secs, n in by["top_kernels"]:
            m = re.search(r"mamba_bwd_\w+", name)
            if m:
                kernels_ms[m.group(0)] = {"ms": secs * 1e3 / n,
                                          "launches_traced": n, "calls": 20}
        bound_ms, bound_by, nbytes, operations = mamba_bwd_bound(problem)
        # the forward without and with its kept states, in turns
        fwd = [cuda_ms(lambda: scan.mamba_scan(*arrays, keep_states=keep),
                       10) for keep in (False, True, True, False)]
        one = [a[:1] for a in arrays[:4]] + [arrays[4], arrays[5],
                                             arrays[6][:1]]
        out = dict(ms=ms, kernels_ms=kernels_ms,
                   plain_ms=cuda_ms(lambda: mamba_scan_bwd_ref(*arrays, dy),
                                    1, warmup=1),
                   fwd_ms=(fwd[0] + fwd[3]) / 2,
                   fwd_keep_ms=(fwd[1] + fwd[2]) / 2,
                   fwd_in_turns_ms=fwd,
                   b1_ms=cuda_ms(lambda: scan.mamba_scan_bwd(
                       *one, dy[:1], states=states[:1]), 10),
                   b1_launch=scan.bwd_launch_shape(1, *(
                       JAMBA_TRAIN_SCAN[k] for k in ("s", "di"))),
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms, bytes=nbytes,
                   operations=operations)
        if dtype == "bfloat16":
            line.update(out)
        else:
            line.update({f"f32_{k}": v for k, v in out.items()})
    line["sass"] = bwd_sass_loops(_build.build_all(["mamba_scan_bwd"])[
        "mamba_scan_bwd"].so_path)
    del timed
    line["ok"] = not failures
    emit("kernel", kernel="mamba_scan_bwd", nvidia_smi=smi, **line)
    if failures:
        raise AssertionError("; ".join(failures))
    return line


def plain_scan_pair():
    """The scan op's plain pair: ``mamba_scan_ref`` forward and
    ``mamba_scan_bwd_ref`` backward in one autograd function with the op's
    signature, the reference the jamba gradients are held to (autograd of
    ``mamba_scan_ref`` keeps about 10.6 B S di ds f32 a layer: 22.8 GB at
    the training shape)."""
    import torch
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_bwd_ref,
                                                    mamba_scan_ref)

    class PlainScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *arrays):
            ctx.save_for_backward(*arrays)
            return mamba_scan_ref(*arrays)

        @staticmethod
        def backward(ctx, dy, dhT):
            return mamba_scan_bwd_ref(*ctx.saved_tensors, dy, dhT)
    return PlainScan.apply


@contextlib.contextmanager
def routes_from(calls):
    """``blocks.moe_route`` choosing, call by call, the experts of
    ``calls`` (:func:`record_routes` of another run, in order: remat's
    calls in the backward too), its gates the router's own probabilities
    at those experts; yields a list of (the experts its own top-k would
    have chosen, its probabilities, the experts taken), one a call."""
    import torch
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.dist.sharding import full_tensor, is_dtensor, lay_out
    from repro_torch.models import blocks
    route, it, seen = blocks.moe_route, iter(calls), []
    topk = torch.topk

    def forced(cfg, p, x):
        taken = next(it)[0]

        def pick(probs, k, dim=-1):
            idx = taken.reshape(probs.shape[:-1] + (k,))
            if is_dtensor(probs):  # laid out as the router's output
                probs = lay_out(probs, probs.device_mesh, [
                    Replicate() if p.is_shard(probs.ndim - 1) else p
                    for p in probs.placements])
                idx = lay_out(idx, probs.device_mesh, probs.placements)
            seen.append((full_tensor(topk(probs, k, dim=dim).indices)
                         .reshape(-1, k),
                         full_tensor(probs).reshape(-1, probs.shape[-1]),
                         taken))
            if not is_dtensor(probs):
                return probs.gather(dim, idx), idx
            # on each rank's block (the experts whole on it): torch
            # 2.11's DTensor takes gather's backward through a view that
            # flattens a sharded dimension
            return local_map(lambda p, i: p.gather(dim, i),
                             out_placements=list(probs.placements),
                             in_placements=(list(probs.placements),
                                            list(idx.placements)),
                             device_mesh=probs.device_mesh)(probs, idx), idx
        with mock.patch.object(torch, "topk", pick):
            return route(cfg, p, x)
    with mock.patch.object(blocks, "moe_route", forced):
        yield seen
    if next(it, None) is not None:
        raise AssertionError("the forced run routed fewer MoE layers than "
                             "the recorded one")


def route_flips(seen, ref, cfg, calls=None):
    """The routes the kernel run would have taken against the plain run's
    (``seen`` from :func:`routes_from`, ``ref`` from
    :func:`record_routes` with probabilities), over ``calls`` MoE calls
    (default the forward's MoE layers: the first calls; remat's
    recomputation repeats them): each
    token whose experts differ as a set, with the experts only one run
    chose and the kernel run's top-k margin (its k-th router probability
    less the next), and per layer the largest change of a probability
    between the two runs.  A flip on a near-tie has a margin of at most
    twice that change (``near_ties``)."""
    moe = (sum(spec.mlp == "moe" for spec in cfg.prefix)
           + cfg.pattern_repeats * sum(spec.mlp == "moe"
                                       for spec in cfg.pattern))
    moe = moe if calls is None else calls
    flips, drift = [], []
    for n, ((own, pa, _), (eb, _, pb)) in enumerate(zip(seen[:moe], ref)):
        k = cfg.top_k
        top = pa.topk(k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        drift.append((pa - pb).abs().max().item())
        tokens = (own.sort(-1).values != eb.sort(-1).values).any(-1)
        for t in tokens.nonzero().flatten().tolist():
            xa, xb = set(own[t].tolist()), set(eb[t].tolist())
            flips.append({"layer": n, "token": t,
                          "kernel_only": sorted(xa - xb),
                          "plain_only": sorted(xb - xa),
                          "margin": margin[t].item()})
    near = all(f["margin"] <= 2 * drift[f["layer"]] for f in flips)
    return flips, drift, near


def has_moe(cfg):
    """Whether any layer of ``cfg`` routes through a mixture of experts."""
    return any(spec.mlp == "moe" for spec in (*cfg.prefix, *cfg.pattern))


def grads_against_plain(cfg, dev, op, plain, bwd):
    """Every leaf's gradient of one TokenPipeline batch with the kernel op
    ``blocks.<op>`` on its kernels, against the same with it patched to
    ``plain`` (autograd of the plain version): (worst error over the
    leaf's largest magnitude, its leaf, the leaf count, the launches of
    the backward kernel ``bwd`` in each run).  The plain run goes first;
    in an MoE model (:func:`has_moe`) its routes are recorded, and the kernel
    run takes the same experts (:func:`routes_from`): bf16 activations an
    ulp apart flip near-tied routes, and a flipped token's gradient
    reaches every leaf (its lm_head row, and every layer below through
    its cotangent), so no leaf could be held otherwise.  Each route the
    kernel run would have taken otherwise is named with its margin
    (:func:`route_flips`)."""
    from unittest import mock

    import torch
    from repro_torch.ckpt.checkpoint import leaf_paths
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import blocks, lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer

    routes = has_moe(cfg)
    params = lm.init_params(0, cfg, device=dev)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = trainer.to_device(TokenPipeline(
        cfg.vocab_size, LMT_SEQ, LMT_BATCH, seed=11).batch_at(0), dev)
    with mock.patch.object(blocks, op, plain), (
            record_routes(probs=True) if routes
            else contextlib.nullcontext([])) as ref:
        before = bwd.launches
        loss_p, want = trainer.compute_grads(cfg, params, batch)
        torch.cuda.synchronize()
        plain_launches = bwd.launches - before
    before = bwd.launches
    with (routes_from(ref) if routes else contextlib.nullcontext()) as seen:
        loss, got = trainer.compute_grads(cfg, params, batch)
        torch.cuda.synchronize()
    kernel_launches = bwd.launches - before
    got = [g.detach() for g in tree_leaves(got)]
    errs = {key: ((g.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp_min(1e-30)).item()
            for key, g, w in zip(leaf_paths(want), got, tree_leaves(want))}
    where = max(errs, key=errs.get)
    out = dict(loss=loss.item(), loss_plain=loss_p.item(),
               worst=errs[where], worst_leaf=where, leaves=len(got),
               kernel_launches=kernel_launches,
               plain_launches=plain_launches)
    if routes:
        flips, drift, near = route_flips(seen, ref, cfg)
        out.update(route_calls=len(ref), routes_taken_from_plain=True,
                   tokens_flipped=len(flips), flips=flips[:40],
                   flip_margin_max=max((f["margin"] for f in flips),
                                       default=0.0),
                   prob_drift_by_layer=drift, flips_near_ties=near)
    return out


def train_cell(cfg, dev, counts, seed):
    """``LMT_STEPS`` train_steps of ``cfg`` (seeded weights) on one
    repeated TokenPipeline batch from ``LMT_AT_STEP``: per step the loss,
    grad norm, rate, host seconds, the device spans of the gradients, the
    clip and AdamW (CUDA events, no sync) and the rise of each of
    ``counts`` ({name: a function reading a launch count}), set to 0 just
    before the steps; the last step traced for the card's busy share and
    its kernel time by kind (``STEP_KERNEL_GROUPS``, and the routing of
    an MoE model, :func:`has_moe`).  Returns ``(steps,
    numbers)``: s a step (the median after the first), tokens/s, busy
    share, kernel seconds by kind, ``peak_gib``, init seconds and the
    parameter count."""
    import gc

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import registry
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.make_train_state(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    batch = trainer.to_device(TokenPipeline(
        cfg.vocab_size, LMT_SEQ, LMT_BATCH, seed=seed).batch_at(0), dev)
    spans = {"grads": [], "clip": [], "adamw": []}
    attrs = {"grads": "compute_grads", "clip": "clip_by_global_norm",
             "adamw": "adamw_update"}
    originals = {n: getattr(trainer, a) for n, a in attrs.items()}

    def timed(name):  # CUDA events on the stream: no sync, no change
        fn = originals[name]

        def wrapper(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            stop.record()
            spans[name].append((start, stop))
            return out
        return wrapper
    for name, attr in attrs.items():
        setattr(trainer, attr, timed(name))
    groups = (dict(STEP_KERNEL_GROUPS,
                   routing=PREFILL_KERNEL_GROUPS["routing"])
              if has_moe(cfg) else STEP_KERNEL_GROUPS)
    if any(spec.mixer == "mamba" for spec in (*cfg.prefix, *cfg.pattern)):
        # first: routing's "scan" would take mamba_scan_kernel
        groups = dict(SCAN_KERNEL_GROUPS, **groups)
    steps = []
    try:
        registry.reset_counts()
        for i in range(LMT_STEPS):
            before = {n: f() for n, f in counts.items()}
            t0 = time.perf_counter()
            if i < LMT_STEPS - 1:
                state, m = trainer.train_step(cfg, state, batch,
                                              step=LMT_AT_STEP + i)
                loss = m["loss"].item()
                wall, busy = time.perf_counter() - t0, None
            else:  # the last step traced: the card's busy share, and
                # its kernel time by kind
                (state, m), wall, busy, by_kind = device_busy(
                    lambda: trainer.train_step(cfg, state, batch,
                                               step=LMT_AT_STEP + i),
                    groups=groups)
                loss = m["loss"].item()
            torch.cuda.synchronize()
            steps.append(dict(
                step=i, loss=loss, grad_norm=m["grad_norm"].item(),
                lr=m["lr"].item(), seconds=wall, busy_s=busy,
                **{f"{n}_launches": f() - before[n]
                   for n, f in counts.items()}))
    finally:
        for name, attr in attrs.items():
            setattr(trainer, attr, originals[name])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, evs in spans.items():
        for rec, (a, b) in zip(steps, evs):
            rec[f"{name}_ms"] = a.elapsed_time(b)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    steady = sorted(r["seconds"] for r in steps[1:])
    step_s = steady[len(steady) // 2]
    last = steps[-1]
    return steps, dict(
        seconds_per_step=step_s, tokens_per_s=LMT_BATCH * LMT_SEQ / step_s,
        busy_share=last["busy_s"] / last["seconds"] if last["busy_s"]
        else None, kernel_s_by_kind=by_kind, peak_gib=peak_gib,
        init_s=init_s, params=n_params)


def _host_copy(state):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def _same_bits(a, b):
    import torch
    from repro_torch.optim.adamw import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.detach().cpu(), y.detach().cpu())
        for x, y in zip(la, lb))


def resume_drill(dev, work):
    """The train_lm example's resume path on the card (20m preset): an
    uninterrupted run of ``DRILL_STEPS``; a run that fails after
    ``DRILL_FAIL_AT`` steps (exit 17, its checkpoint at that step), the
    checkpoint restored into a fresh state and held bit for bit against
    the failing run's state, then resumed to the end; the two runs' last
    losses, and whether they agree bit for bit.  Two gradient
    evaluations of one batch name the leaves whose gradient differs from
    run to run (the ops that are not deterministic)."""
    import torch
    from repro_torch.ckpt.checkpoint import CheckpointManager, leaf_paths
    from repro_torch.examples import train_lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer

    def args(ckpt_dir, fail=False):
        argv = ["--steps", str(DRILL_STEPS), "--ckpt-dir", str(ckpt_dir),
                "--device", str(dev)]
        return train_lm.parser().parse_args(
            argv + (["--simulate-failure"] if fail else []))
    quiet = lambda s: None  # noqa: E731
    t0 = time.perf_counter()
    full = train_lm.train(args(work / "full"), log=quiet)
    seconds_full = time.perf_counter() - t0
    saved = {}

    def capture(step, state, metrics):
        if step + 1 == DRILL_FAIL_AT:
            saved["state"] = _host_copy(state)
    exit_code = None
    try:
        train_lm.train(args(work / "failing", fail=True), on_step=capture,
                       log=quiet)
    except SystemExit as exc:  # the drill's expected crash
        exit_code = exc.code
    cfg = train_lm.preset_config("20m")
    mgr = CheckpointManager(work / "failing", keep=2)
    restored, at = trainer.restore_train_state(
        mgr, cfg, trainer.make_train_state(1, cfg, device=dev))
    restored_exact = _same_bits(restored, saved["state"])
    resumed = train_lm.train(args(work / "failing"), log=quiet)
    last = DRILL_STEPS - 1
    # run-to-run determinism of one gradient evaluation
    batch = trainer.to_device(train_lm.TokenPipeline(
        cfg.vocab_size, 256, 8, seed=7).batch_at(0), dev)
    _, g1 = trainer.compute_grads(cfg, resumed["state"]["params"], batch)
    _, g2 = trainer.compute_grads(cfg, resumed["state"]["params"], batch)
    return dict(exit_code=exit_code, checkpoint_step=at,
                restored_bit_identical=restored_exact,
                resumed_from=resumed["start"],
                loss_first=full["losses"][0], loss_last=full["losses"][last],
                resumed_loss_last=resumed["losses"][last],
                resumed_equals_uninterrupted_bits=(
                    resumed["losses"][last] == full["losses"][last]
                    and _same_bits(resumed["state"], full["state"])),
                seconds_full_run=seconds_full,
                median_step_ms=float(sorted(full["times"])[
                    len(full["times"]) // 2] * 1e3),
                grads_not_deterministic=[
                    key for key, a, b in zip(leaf_paths(g1), tree_leaves(g1),
                                             tree_leaves(g2))
                    if not torch.equal(a, b)])


def run_jamba_train_part(dev, smi, attn_counts):
    """jamba-v0.1-52b's part of the LM training slice:
    :func:`check_mamba_scan_bwd`, then every leaf's gradient of the 3-layer
    cut (``JAMBA_TRAIN_SLOTS``, full width) in bf16 and f32 with the scan
    on its kernels against the plain scan pair (:func:`plain_scan_pair`),
    the MoE routes taken from the plain run, and ``LMT_STEPS`` train steps
    of the cut counting the scan's and attention's launches
    (``attn_counts`` and the scan's own).  Returns ``(the backward
    kernel's line, grads by dtype, steps, numbers, the cut's config)``."""
    import gc

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_bwd

    mamba_line = check_mamba_scan_bwd(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(JAMBA_ARCH)
    lo, hi = JAMBA_TRAIN_SLOTS
    cfg = full.replace(pattern=full.pattern[lo:hi], n_layers=hi - lo)
    grads = {}
    for dtype, tol in (("bfloat16", LMT_GRAD_TOL_BF16),
                       ("float32", LMT_GRAD_TOL_F32)):
        res = grads_against_plain(cfg.replace(dtype=dtype), dev,
                                  "mamba_scan_op", plain_scan_pair(),
                                  mamba_scan_bwd)
        res["tol"] = tol
        grads[dtype] = res
        gc.collect()
        torch.cuda.empty_cache()
    emit("lm_train_slice", part="grads", arch=cfg.name,
         n_layers=cfg.n_layers, slots=list(JAMBA_TRAIN_SLOTS),
         batch=LMT_BATCH, seq=LMT_SEQ, plain="mamba_scan_ref forward, "
         "mamba_scan_bwd_ref backward", nvidia_smi=smi, **grads)
    counts = dict(attn_counts,
                  mamba_scan=lambda: mamba_ops.SPEC.launches,
                  mamba_scan_bwd=lambda: mamba_scan_bwd.launches,
                  mamba_scan_plain=lambda: mamba_ops.SPEC.plain_calls)
    steps, numbers = train_cell(cfg, dev, counts, 8)
    emit("lm_train_slice", part="train", arch=cfg.name,
         n_layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, dtype=cfg.dtype, policy=cfg.opt_policy,
         batch=LMT_BATCH, seq=LMT_SEQ, at_step=LMT_AT_STEP, steps=steps,
         nvidia_smi=smi, slots=list(JAMBA_TRAIN_SLOTS),
         layers=[f"{spec.mixer}+{spec.mlp}" for spec in cfg.pattern],
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         d_inner=cfg.mamba_d_inner, d_state=cfg.mamba_d_state,
         experts=cfg.n_experts, top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff,
         scan_bwd_ms=mamba_line["ms"], scan_fwd_ms=mamba_line["fwd_ms"],
         **numbers)
    return mamba_line, grads, steps, numbers, cfg


def run_lm_train_slice(dev, smi, work):
    """LM training on the card: the backward kernel at the two training
    shapes, the full-width gradients against plain attention at depth 2,
    4 steps of llama3.2-3b at full width and depth; then the WKV
    backward kernel at rwkv6-1.6b's training shape, its full-width
    gradients against the plain recurrence at depth 2 and 4 steps of
    rwkv6-1.6b at full width and depth; then deepseek-v2-lite-16b (MLA
    and MoE) at full width: its gradients at depth 2 against plain
    attention, routes recorded, and 4 steps at ``DEEPSEEK_TRAIN_REPEATS``
    MoE layers; then the selective scan's backward kernel at jamba's
    training shape, the gradients of jamba-v0.1-52b's 3-layer cut
    (``JAMBA_TRAIN_SLOTS``, full width) against the plain scan pair
    (:func:`plain_scan_pair`), routes recorded, and 4 steps of that cut;
    and the train_lm example's resume drill.  Returns the backward
    kernels' lines and the launches of the training steps by kernel and
    model: ``{kernel: {model: launches}}``."""
    import gc

    import torch
    from repro_torch.configs.base import get_config, with_repeats
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_bwd
    from repro_torch.kernels.rwkv6_chunk import ops as rwkv_ops
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    from repro_torch.kernels.rwkv6_chunk.rwkv6_chunk import rwkv6_chunk_bwd

    def grads_part(cfg, op, plain, bwd, tols):
        grads, depth = {}, with_repeats(cfg, 2)
        for dtype, tol in tols:
            res = grads_against_plain(depth.replace(dtype=dtype), dev, op,
                                      plain, bwd)
            res["tol"] = tol
            grads[dtype] = res
            gc.collect()
            torch.cuda.empty_cache()
        emit("lm_train_slice", part="grads", arch=cfg.name,
             n_layers=depth.n_layers, pattern_repeats=2, batch=LMT_BATCH,
             seq=LMT_SEQ, nvidia_smi=smi, **grads)
        return grads, depth.n_layers

    def train_part(cfg, counts, seed, **shape):
        steps, numbers = train_cell(cfg, dev, counts, seed)
        emit("lm_train_slice", part="train", arch=cfg.name,
             n_layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
             vocab=cfg.vocab_size, dtype=cfg.dtype, policy=cfg.opt_policy,
             batch=LMT_BATCH, seq=LMT_SEQ, at_step=LMT_AT_STEP, steps=steps,
             nvidia_smi=smi, **shape, **numbers)
        return steps, numbers

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    bwd_lines = check_flash_bwd(dev, smi)
    cfg = get_config(LMT_ARCH)
    attn_counts = {"flash_attention": lambda: ops.SPEC.launches,
                   "flash_attention_bwd": lambda: flash_attention_bwd.launches,
                   "flash_attention_plain": lambda: ops.SPEC.plain_calls}
    grads, _ = grads_part(cfg, "flash_attention_op", flash_attention_ref,
                          flash_attention_bwd,
                          (("bfloat16", LMT_GRAD_TOL_BF16),
                           ("float32", LMT_GRAD_TOL_F32)))
    steps, numbers = train_part(
        cfg, attn_counts, 5, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim)
    launches = {"flash_attention": {cfg.name: ops.SPEC.launches},
                "flash_attention_bwd": {
                    cfg.name: flash_attention_bwd.launches}}
    record_flash_launches("lm_train_slice")

    # rwkv6-1.6b: the WKV recurrence's backward kernel
    rwkv_line = check_rwkv6_bwd(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    rcfg = get_config(LM_ARCH)
    rgrads, _ = grads_part(rcfg, "rwkv6_chunk_op", rwkv6_chunk_ref,
                        rwkv6_chunk_bwd,
                        (("bfloat16", RWKV_GRAD_TOL_BF16),
                         ("float32", LMT_GRAD_TOL_F32)))
    rsteps, rnumbers = train_part(
        rcfg, {"rwkv6_chunk": lambda: rwkv_ops.SPEC.launches,
               "rwkv6_chunk_bwd": lambda: rwkv6_chunk_bwd.launches,
               "rwkv6_chunk_plain": lambda: rwkv_ops.SPEC.plain_calls},
        6, heads=rcfg.n_rwkv_heads, head_dim=rcfg.rwkv_head_size,
        wkv_bwd_ms=rwkv_line["ms"], wkv_fwd_ms=rwkv_line["fwd_ms"])
    launches.update(rwkv6_chunk={rcfg.name: rwkv_ops.SPEC.launches},
                    rwkv6_chunk_bwd={rcfg.name: rwkv6_chunk_bwd.launches})

    # deepseek-v2-lite-16b: MLA's attention backward at q.k 192 / v 128
    gc.collect()
    torch.cuda.empty_cache()
    dcfg = get_config(DEEPSEEK_ARCH)
    dgrads, dgrad_layers = grads_part(
        dcfg, "flash_attention_op", flash_attention_ref, flash_attention_bwd,
        (("bfloat16", LMT_GRAD_TOL_BF16), ("float32", LMT_GRAD_TOL_F32)))
    dcfg = with_repeats(dcfg, DEEPSEEK_TRAIN_REPEATS)
    dsteps, dnumbers = train_part(
        dcfg, attn_counts, 7, heads=dcfg.n_heads,
        qk_head_dim=dcfg.qk_nope_dim + dcfg.qk_rope_dim,
        v_head_dim=dcfg.v_head_dim, kv_lora_rank=dcfg.kv_lora_rank,
        experts=dcfg.n_experts, top_k=dcfg.top_k,
        shared_experts=dcfg.n_shared_experts, moe_d_ff=dcfg.moe_d_ff,
        pattern_repeats=dcfg.pattern_repeats,
        attention_bwd_ms=bwd_lines["mla"]["ms"])
    launches["flash_attention"][dcfg.name] = ops.SPEC.launches
    launches["flash_attention_bwd"][dcfg.name] = flash_attention_bwd.launches
    record_flash_launches("lm_train_slice_deepseek")

    # jamba-v0.1-52b: the selective scan's backward kernel
    gc.collect()
    torch.cuda.empty_cache()
    mamba_line, jgrads, jsteps, jnumbers, jcfg = run_jamba_train_part(
        dev, smi, attn_counts)
    launches["mamba_scan"] = {jcfg.name: mamba_ops.SPEC.launches}
    launches["mamba_scan_bwd"] = {jcfg.name: mamba_scan_bwd.launches}
    launches["flash_attention"][jcfg.name] = ops.SPEC.launches
    launches["flash_attention_bwd"][jcfg.name] = flash_attention_bwd.launches
    record_flash_launches("lm_train_slice_jamba")

    drill = resume_drill(dev, work)
    emit("lm_train_slice", part="resume_drill", preset="20m",
         steps=DRILL_STEPS, fail_at=DRILL_FAIL_AT, nvidia_smi=smi, **drill)

    def finite(xs):
        return all(x == x and abs(x) < float("inf") for x in xs)
    # remat recomputes each pattern layer, not the prefix (deepseek's
    # dense first layer), as the reference's jax.checkpoint covers only
    # the scanned pattern
    L, RL, DL = cfg.n_layers, rcfg.n_layers, dcfg.n_layers
    JM = sum(spec.mixer == "mamba" for spec in jcfg.pattern)
    JG = jcfg.n_layers - JM
    losses = [r["loss"] for r in steps]
    rlosses = [r["loss"] for r in rsteps]
    dlosses = [r["loss"] for r in dsteps]
    jlosses = [r["loss"] for r in jsteps]
    checks = {
        "grads_bf16_match_plain_attention":
        grads["bfloat16"]["worst"] <= LMT_GRAD_TOL_BF16,
        "grads_f32_match_plain_attention":
        grads["float32"]["worst"] <= LMT_GRAD_TOL_F32,
        "grads_one_backward_launch_per_layer":
        all(g["kernel_launches"] == 2 and g["plain_launches"] == 0
            for g in grads.values()),
        "loss_finite": finite(losses),
        "loss_falling": losses[-1] < losses[0],
        "launches_per_step": all(
            r["flash_attention_launches"] == 2 * L
            and r["flash_attention_bwd_launches"] == L
            and r["flash_attention_plain_launches"] == 0 for r in steps),
        "peak_under_80_gib": numbers["peak_gib"] < 80,
        "rwkv_grads_bf16_match_plain_recurrence":
        rgrads["bfloat16"]["worst"] <= RWKV_GRAD_TOL_BF16,
        "rwkv_grads_f32_match_plain_recurrence":
        rgrads["float32"]["worst"] <= LMT_GRAD_TOL_F32,
        "rwkv_grads_one_backward_launch_per_layer":
        all(g["kernel_launches"] == 2 and g["plain_launches"] == 0
            for g in rgrads.values()),
        "rwkv_loss_finite": finite(rlosses),
        "rwkv_loss_falling": rlosses[-1] < rlosses[0],
        "rwkv_launches_per_step": all(
            r["rwkv6_chunk_launches"] == 2 * RL
            and r["rwkv6_chunk_bwd_launches"] == RL
            and r["rwkv6_chunk_plain_launches"] == 0 for r in rsteps),
        "rwkv_peak_under_80_gib": rnumbers["peak_gib"] < 80,
        "deepseek_grads_bf16_match_plain_attention":
        dgrads["bfloat16"]["worst"] <= LMT_GRAD_TOL_BF16,
        "deepseek_grads_f32_match_plain_attention":
        dgrads["float32"]["worst"] <= LMT_GRAD_TOL_F32,
        "deepseek_route_flips_near_ties":
        all(g["flips_near_ties"] for g in dgrads.values()),
        "deepseek_grads_one_backward_launch_per_layer":
        all(g["kernel_launches"] == dgrad_layers and g["plain_launches"] == 0
            for g in dgrads.values()),
        "deepseek_loss_finite": finite(dlosses),
        "deepseek_loss_falling": dlosses[-1] < dlosses[0],
        "deepseek_launches_per_step": all(
            r["flash_attention_launches"] == 2 * DL - len(dcfg.prefix)
            and r["flash_attention_bwd_launches"] == DL
            and r["flash_attention_plain_launches"] == 0 for r in dsteps),
        "deepseek_peak_under_80_gib": dnumbers["peak_gib"] < 80,
        "jamba_grads_bf16_match_plain_scan":
        jgrads["bfloat16"]["worst"] <= LMT_GRAD_TOL_BF16,
        "jamba_grads_f32_match_plain_scan":
        jgrads["float32"]["worst"] <= LMT_GRAD_TOL_F32,
        "jamba_route_flips_near_ties":
        all(g["flips_near_ties"] for g in jgrads.values()),
        "jamba_grads_one_backward_launch_per_mamba_layer":
        all(g["kernel_launches"] == JM and g["plain_launches"] == 0
            for g in jgrads.values()),
        "jamba_loss_finite": finite(jlosses),
        "jamba_loss_falling": jlosses[-1] < jlosses[0],
        "jamba_launches_per_step": all(
            r["mamba_scan_launches"] == 2 * JM
            and r["mamba_scan_bwd_launches"] == JM
            and r["mamba_scan_plain_launches"] == 0
            and r["flash_attention_launches"] == 2 * JG
            and r["flash_attention_bwd_launches"] == JG
            and r["flash_attention_plain_launches"] == 0 for r in jsteps),
        "jamba_peak_under_80_gib": jnumbers["peak_gib"] < 80,
        "drill_exit_17": drill["exit_code"] == 17,
        "drill_checkpoint_at_fail_step":
        drill["checkpoint_step"] == DRILL_FAIL_AT
        and drill["resumed_from"] == DRILL_FAIL_AT,
        "drill_restore_bit_identical": drill["restored_bit_identical"],
        "drill_loss_falls": drill["loss_last"] < drill["loss_first"],
    }
    emit("lm_train_slice", part="total",
         seconds=time.perf_counter() - t_phase, launches=launches, **checks)
    if not all(checks.values()):
        raise AssertionError(f"lm train slice checks failed: {checks}")
    return bwd_lines, rwkv_line, mamba_line, launches


# the dist slice: the sharding substrate over DIST_RANKS ranks of a gloo
# group that share the one card (NCCL takes no two ranks on one device;
# the collectives go through host memory, the compute stays on the card)
DIST_RANKS = 4
# minibude served at 65,536 rows on a data 4 x model 1 mesh (16,384 a
# rank), and at a row count 4 does not divide (bucketed to 65,536)
DIST_SERVE_MESH = (4, 1)
DIST_ROWS, DIST_ODD_ROWS = INFER_POSES, INFER_POSES - 3
DIST_TIMING_REPS = 5
# llama3.2-3b at full width cut to 2 layers, trained on data 2 x model 2
# (12 q and 4 kv heads a rank) for 2 steps of one batch of 2 x 2,048,
# step 1's loss and gradients held to one rank's with the same kernels:
# f32 within 1e-4 of each leaf's largest magnitude (summation order:
# the shards sum their products in another order), bf16 within
# LMT_GRAD_TOL_BF16 (tests/test_torch_train.py BF16_GRAD_TOL); the bf16
# state saved, then restored onto data 4 x model 1 bit for bit
DIST_TRAIN_MESH, DIST_RESTORE_MESH = (2, 2), (4, 1)
DIST_TRAIN_DEPTH, DIST_TRAIN_STEPS = 2, 2
DIST_GRAD_TOL = {"float32": 1e-4, "bfloat16": LMT_GRAD_TOL_BF16}
DIST_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the smoke cell's steps timed each way, with and without the mode
DIST_MODE_REPS = 5
# the sharded model paths (item 9b-ii) on data 2 x model 2, bf16, at full
# width, each held to rank 0's unsharded run with the same kernels (its
# MoE layers grouped as the mesh groups them, so the same capacity and
# drops; the sharded MoE runs take rank 0's routes, each route it would
# have taken otherwise named with its margin): logits and every cache
# within LM_TOL_BF16 of their largest magnitude, gradients within
# DIST_GRAD_TOL.  deepseek-v2-lite-16b at its dense layer and one MoE
# layer (1.0 B parameters): a prefill of 2 x 2,048 tokens, 8 decode steps
# (MLA's absorbed step: no kernel), one gradient check and one
# train_step of 2 x 2,048; jamba-v0.1-52b serving slots 3-5 of its period
# (Mamba, attention + MoE, Mamba: 3.96 B) the same way, and training its
# two Mamba layers with dense MLPs (slots 3 and 5: the MoE slot's Adam
# state does not fit beside four ranks on one card); llama3.2-3b at the
# slice's 2 layers decoding 8 steps at batch 1 after an 8,192-token
# prompt, its 32,768-position cache laid out with long_ctx (the sequence
# on data and model)
DIST_MODEL_MESH = (2, 2)
DIST_MODELS = {
    "deepseek": {"arch": "deepseek-v2-lite-16b", "repeats": 1, "batch": 2,
                 "prompt": 2048, "steps": 8, "train_slots": "all",
                 "train_batch": 2, "train_seq": 2048},
    "jamba": {"arch": "jamba-v0.1-52b", "slots": [3, 4, 5], "batch": 2,
              "prompt": 2048, "steps": 8, "train_slots": [3, 5],
              "train_batch": 2, "train_seq": 2048},
    "long": {"arch": "llama3.2-3b", "repeats": 2, "batch": 1,
             "prompt": 8192, "cache": 32768, "steps": 8, "long_ctx": True},
}


def dist_config(work):
    """The dist slice's sizes, for the ranks (a rehearsal on the CPU
    writes smaller ones)."""
    return {"device": "cuda", "work": str(work),
            "tune_dir": str(work / "tune_torch"), "ranks": DIST_RANKS,
            "serve_mesh": DIST_SERVE_MESH, "rows": DIST_ROWS,
            "odd_rows": DIST_ODD_ROWS, "reps": DIST_TIMING_REPS,
            "arch": LMT_ARCH, "depth": DIST_TRAIN_DEPTH,
            "batch": LMT_BATCH, "seq": LMT_SEQ, "steps": DIST_TRAIN_STEPS,
            "at_step": LMT_AT_STEP, "train_mesh": DIST_TRAIN_MESH,
            "restore_mesh": DIST_RESTORE_MESH,
            "dtypes": ["bfloat16", "float32"], "restore_dtype": "bfloat16",
            "model_mesh": DIST_MODEL_MESH, "models": DIST_MODELS}


def dist_bundles(work, dev):
    """The minibude serving bundles of the dist slice, made and gated
    here before the ranks start: an f32 one and a gated int8 one (full
    width, seeded weights, normalization from seeded poses)."""
    import torch
    from repro_torch.apps import minibude
    from repro_torch.core import InferenceEngine
    from repro_torch.nn import MLP, save_model
    from repro_torch.quant.budgets import set_rmse_budget
    from repro_torch.quant.gate import gate_bundle
    X = minibude.make_inputs(COLLECT_POSES, seed=1, device=dev)
    Y = minibude.energies(X)[:, None]
    stats = {"x_mu": X.mean(0).tolist(),
             "x_sd": (X.std(0) + 1e-6).tolist(),
             "y_mu": Y.mean(0).tolist(), "y_sd": (Y.std(0) + 1e-6).tolist()}
    out = {}
    for tier, seed in (("f32", 0), ("int8", 1)):
        net = MLP((1, 6), list(BUDE_HIDDEN), 1).init(seed=seed)
        out[tier] = save_model(work / f"bundle_{tier}", net, extra=stats)
    set_rmse_budget(out["int8"], 1e30)  # the tier, not its accuracy
    gate = gate_bundle(out["int8"], X.cpu().numpy(), device=dev)
    if gate["exact"] is not True:
        raise AssertionError(f"the dist slice's int8 gate failed: {gate}")
    for tier, path in out.items():
        eng = InferenceEngine.get(path, dev)
        if eng.tier != tier:
            raise AssertionError(f"{path} serves tier {eng.tier}")
    InferenceEngine.invalidate()
    del X, Y
    torch.cuda.empty_cache()
    return out


def run_dist_slice(dev, smi):
    """The sharding substrate on the card: ``DIST_RANKS`` ranks of one
    gloo group on the one H100 (each rank a process), minibude served
    sharded in both tiers, llama3.2-3b trained sharded and its state
    restored onto another mesh, the sharded model paths
    (``DIST_MODELS``: deepseek and jamba serving and training, a long
    context decode; :func:`dist_rank_main`), then the dry run's smoke
    cell on a fake group of 256 ranks in this process.  Every
    sharded time here is the cost of sharding on one card (four ranks
    share its SMs and move their collectives through host memory), not a
    speedup.  Returns the launches of the ranks' main runs, summed over
    the ranks, by kernel wrapper."""
    work = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    conf = dist_config(work)
    # the slice's own tune cache (the gate verdict of its int8 bundle),
    # which the ranks read too: whatever cache earlier phases set is gone
    tcache = importlib.import_module("repro_torch.tune.cache")
    tcache.ART = pathlib.Path(conf["tune_dir"])
    tcache._default.clear()
    conf["bundles"] = {k: str(v) for k, v in dist_bundles(work, dev).items()}
    (work / "config.json").write_text(json.dumps(conf))
    reports = spawn_dist_ranks(work / "config.json", conf["ranks"])
    launches = dist_report(reports, conf, smi)
    shutil.rmtree(work)

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import dryrun
    smoke_kernels = fa.KERNELS + (fa.flash_attention_bwd,)
    for f in smoke_kernels:
        f.launches = 0
    rec = dryrun.run_smoke(ROOT / "build" / "chip_smoke_dryrun", force=True,
                           device=dev.type)
    smoke_launches = {f.__name__: f.launches for f in smoke_kernels}
    shutil.rmtree(ROOT / "build" / "chip_smoke_dryrun", ignore_errors=True)
    mode_s = time_collective_mode(dev)
    checks = {"status_ok": rec["status"] == "ok",
              "on_the_card": rec.get("device") == dev.type,
              "attention_launched": sum(
                  v for k, v in smoke_launches.items() if "bwd" not in k) > 0,
              "backward_launched": smoke_launches["flash_attention_bwd"] > 0,
              "collective_bytes": rec.get("coll_bytes", 0) > 0,
              "every_kind_moves_bytes": all(
                  b > 0 for b in rec.get("coll_bytes_per_kind", {}).values())}
    emit("dist_slice", part="smoke", mesh=rec.get("mesh_shape"),
         device=rec.get("device"), seconds=rec.get("run_s"),
         launches=smoke_launches, coll_counts=rec.get("coll_counts"),
         coll_bytes_per_kind=rec.get("coll_bytes_per_kind"),
         coll_bytes=rec.get("coll_bytes"),
         coll_bytes_corrected=rec.get("coll_bytes_corrected"),
         resident_per_rank_bytes=rec.get("resident_per_rank_bytes"),
         step_s_without_mode=mode_s["without"],
         step_s_with_mode=mode_s["with"],
         note="a fake group of 256 ranks in this process: its collectives "
              "move nothing", nvidia_smi=smi, **checks)
    if not all(checks.values()):
        raise AssertionError(f"dist smoke checks failed: {checks}")
    return launches


def time_collective_mode(dev, reps=DIST_MODE_REPS):
    """Host seconds of the smoke cell's sharded train step on the card,
    without the collective mode (the fake group needs no staging, so
    DTensor issues its collectives directly) and with it (under
    ``collective_stats``), alternated, every step timed; the median of
    each after one warm step."""
    import torch
    from repro_torch.dist.hlo_analysis import collective_stats
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell
    cfg, shape = dryrun.smoke_cell()
    secs = {"without": [], "with": []}
    with dryrun.fake_group(dryrun.SMOKE_RANKS):
        mesh = make_production_mesh(device=dev.type)
        with use_mesh(mesh):
            cell = build_cell(cfg, shape, mesh, device=dev.type)
            cell["fn"](*cell["args"])
            for _ in range(reps):
                for label in secs:
                    ctx = collective_stats() if label == "with" \
                        else contextlib.nullcontext()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with ctx:
                        cell["fn"](*cell["args"])
                    torch.cuda.synchronize()
                    secs[label].append(time.perf_counter() - t0)
        del cell
    torch.cuda.empty_cache()
    return {k: {"median": sorted(v)[len(v) // 2], "all": v}
            for k, v in secs.items()}


def spawn_dist_ranks(config, ranks):
    """Start ``ranks`` processes of this script as the ranks of one gloo
    group (``--dist-rank``), wait for all, and return each rank's report;
    a rank that fails fails the slice (every rank is stopped)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank", str(r),
         str(ranks), str(port), str(config)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]
    reports, errors = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=900)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n"
                              f"{err[-4000:]}")
                continue
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    if errors:
        raise AssertionError("dist slice ranks failed:\n" + "\n".join(errors))
    return reports


def dist_rank_main(argv):
    """One rank of the dist slice: ``--dist-rank RANK WORLD PORT CONFIG``.
    Joins the gloo group, runs the serving, training and model parts on
    its device and prints its report as the last line."""
    rank, world, port, config = (int(argv[0]), int(argv[1]), argv[2],
                                 argv[3])
    sys.path.insert(0, str(ROOT / "src"))
    import warnings
    warnings.filterwarnings("ignore")
    import torch
    import torch.distributed as dist
    conf = json.loads(pathlib.Path(config).read_text())
    if conf["device"] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the dist slice's ranks need the card")
        torch.cuda.set_device(0)
    from repro_torch.device import resolve_device
    from repro_torch.tune import cache as tcache
    tcache.ART = pathlib.Path(conf["tune_dir"])
    dev = resolve_device(conf["device"])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        report = {"rank": rank, "serve": dist_serve_part(conf, dev),
                  "train": dist_train_part(conf, dev),
                  "models": dist_models_part(conf, dev)}
    finally:
        dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    return 0


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def dist_serve_part(conf, dev):
    """Both minibude tiers through ``InferenceEngine.apply_batched`` under
    ``use_mesh`` (data 4 x model 1) at ``rows`` and at ``odd_rows``: every
    row bit for bit the one-rank kernel's (both kernels keep a row's bits
    whatever its batch), the kernel's launches a rank, the collectives,
    and rows/s sharded (all ranks together, through the gather) and
    unsharded (rank 0 alone, the others waiting)."""
    import torch
    import torch.distributed as dist
    from repro_torch.apps import minibude
    from repro_torch.core import InferenceEngine
    from repro_torch.dist import collective_stats, use_mesh
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(tuple(conf["serve_mesh"]), device=dev.type)
    rank, out = dist.get_rank(), {}
    x = minibude.make_inputs(conf["rows"], seed=2, device=dev)
    x_odd = x[:conf["odd_rows"]]
    for tier, path in conf["bundles"].items():
        eng = InferenceEngine.get(path, dev)
        kernel = {"f32": "fused_mlp", "int8": "fused_mlp_int8"}[tier]
        one, one_odd = eng.apply_batched(x), eng.apply_batched(x_odd)
        registry.reset_counts()
        with use_mesh(mesh), collective_stats() as st:
            y, y_odd = eng.apply_batched(x), eng.apply_batched(x_odd)
        _sync(dev)
        launches = registry.get_spec(kernel).launches
        rates = {}
        for label, ctx in (("unsharded", contextlib.nullcontext()),
                           ("sharded", use_mesh(mesh))):
            dist.barrier()
            secs = []
            if label == "sharded" or rank == 0:
                with ctx:
                    for _ in range(conf["reps"]):
                        _sync(dev)
                        t0 = time.perf_counter()
                        eng.apply_batched(x)
                        _sync(dev)
                        secs.append(time.perf_counter() - t0)
            dist.barrier()
            if secs:
                rates[label] = conf["rows"] / sorted(secs)[len(secs) // 2]
        out[tier] = {
            "route": eng.route, "tier": eng.tier, "rows": conf["rows"],
            "odd_rows": conf["odd_rows"],
            "rows_a_rank": conf["rows"] // mesh.size(),
            "bits_equal": bool(torch.equal(y, one)),
            "odd_bits_equal": bool(torch.equal(y_odd, one_odd)),
            "finite": bool(torch.isfinite(y).all()),
            "launches": launches, "applies": len(eng._applies),
            "collectives": st.per_kind_count,
            "collective_bytes": st.per_kind_bytes,
            "rows_per_s": rates}
        del one, one_odd, y, y_odd
    return out


def dist_train_part(conf, dev):
    """llama3.2-3b at full width cut to ``depth`` layers, on data 2 x
    model 2, in each dtype: step 1's loss and every gradient (gathered
    leaf by leaf) against one rank's with the same kernels (rank 0,
    unsharded); then ``steps`` train_steps with the launch counts reset
    just before and read just after (each rank's flash_attention kernels
    and backward), their collectives, seconds a step and the rank's peak
    memory; the last dtype's state saved, then restored onto data 4 x
    model 1, each rank's block of every leaf checked against the file,
    before and after, bit for bit."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import leaf_paths
    from repro_torch.configs.base import get_config, with_repeats
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.dist import collective_stats, use_mesh
    from repro_torch.dist.sharding import full_tensor
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer
    rank = dist.get_rank()
    mesh = make_local_mesh(tuple(conf["train_mesh"]), device=dev.type)
    batch = trainer.to_device(TokenPipeline(
        get_config(conf["arch"]).vocab_size, conf["seq"], conf["batch"],
        seed=11).batch_at(0), dev)
    out = {}
    for dtype in conf["dtypes"]:
        cfg = with_repeats(get_config(conf["arch"]),
                           conf["depth"]).replace(dtype=dtype)
        res = {"n_layers": cfg.n_layers, "mesh": list(mesh.shape)}
        if rank == 0:  # the one-rank step, with the same kernels
            params = lm.init_params(0, cfg, device=dev)
            for t in tree_leaves(params):
                t.requires_grad_(True)
            loss1, want = trainer.compute_grads(cfg, params, batch)
            want = [g.detach() for g in tree_leaves(want)]
            del params
        state = trainer.make_train_state(0, cfg, device=dev, mesh=mesh)
        p0 = state["params"]["stack"][0][0]["mixer"]["wq"]
        res["wq_placements"] = repr(p0.placements)
        res["wq_local_shape"] = list(p0.to_local().shape)
        with use_mesh(mesh) as ctx:
            b = {k: ctx.make_global(v, ("batch", None))
                 for k, v in batch.items()}
            loss, got = trainer.compute_grads(cfg, state["params"], b)
            res["loss"] = float(full_tensor(loss))
            errs = {}
            for key, g in zip(leaf_paths(got), tree_leaves(got)):
                g = full_tensor(g.detach())
                if rank == 0:
                    w = want.pop(0)
                    errs[key] = ((g.float() - w.float()).abs().max()
                                 / w.float().abs().max().clamp_min(1e-30)
                                 ).item()
                del g
            del got
        if rank == 0:
            where = max(errs, key=errs.get)
            res.update(loss_one_rank=float(loss1), worst=errs[where],
                       worst_leaf=where, leaves=len(errs),
                       tol=DIST_GRAD_TOL[dtype])
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        steps = []
        for f in fa.KERNELS + (fa.flash_attention_bwd,):
            f.launches = 0
        with use_mesh(mesh) as ctx, collective_stats() as st:
            b = {k: ctx.make_global(v, ("batch", None))
                 for k, v in batch.items()}
            for i in range(conf["steps"]):
                _sync(dev)
                t0 = time.perf_counter()
                state, m = trainer.train_step(cfg, state, b,
                                              step=conf["at_step"] + i)
                _sync(dev)
                steps.append({"seconds": time.perf_counter() - t0,
                              "loss": float(m["loss"]),
                              "grad_norm": float(m["grad_norm"])})
        res["launches"] = {f.__name__: f.launches
                           for f in fa.KERNELS + (fa.flash_attention_bwd,)}
        res["steps"] = steps
        res["collectives"] = st.per_kind_count
        res["collective_bytes"] = st.per_kind_bytes
        res["collective_bytes_corrected"] = st.corrected_bytes
        if dev.type == "cuda":
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if dtype == conf["restore_dtype"]:
            res["restore"] = dist_restore_drill(conf, cfg, state)
        out[dtype] = res
        del state, m
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def dist_restore_drill(conf, cfg, state):
    """Save a sharded state (gathered whole, written by rank 0), restore
    it onto the restore mesh; each rank's block of every leaf, on the
    mesh that saved it and on the one that restored it, equal to the
    file's bit for bit (read leaf by leaf, no gather)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import CheckpointManager, leaf_paths
    from repro_torch.dist.sharding import local_block
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer
    mgr = CheckpointManager(pathlib.Path(conf["work"]) / "ckpt", keep=1,
                            async_write=False)
    t0 = time.perf_counter()
    trainer.save_train_state(mgr, 1, state)
    save_s = time.perf_counter() - t0
    rows = make_local_mesh(tuple(conf["restore_mesh"]),
                           device=conf["device"])
    t0 = time.perf_counter()
    back, step = trainer.restore_train_state(mgr, cfg, state, mesh=rows)
    restore_s = time.perf_counter() - t0
    d = mgr.dir / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    index = {k: f"a{i}" for i, k in enumerate(meta["keys"])}
    same, moved = True, 0
    with np.load(d / "arrays.npz") as z:
        for key, old, new in zip(leaf_paths(state), tree_leaves(state),
                                 tree_leaves(back)):
            a = z[index[key]]
            full = torch.from_numpy(a.view(np.int16)).view(old.dtype) \
                if old.dtype == torch.bfloat16 else torch.from_numpy(a)
            for t in (old, new):
                block = local_block(full, t.device_mesh, t.placements)
                same &= torch.equal(t.to_local().detach().cpu(), block)
            moved += tuple(old.placements) != tuple(new.placements)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(mgr.dir, ignore_errors=True)
    return {"bits_equal": bool(same), "step": step, "leaves": len(meta["keys"]),
            "leaves_laid_out_otherwise": moved,
            "from_mesh": list(tree_leaves(state)[0].device_mesh.shape),
            "onto_mesh": list(rows.shape), "save_s": save_s,
            "restore_s": restore_s,
            "bytes": sum(t.numel() * t.element_size()
                         for t in tree_leaves(state))}


def dist_model_cfg(m, train=False):
    """The bf16 config of one of ``DIST_MODELS``: its slots of the
    pattern (serving's, or with ``train`` training's; ``"all"`` the cut
    serving runs), or its pattern repeated ``repeats`` times."""
    from repro_torch.configs.base import get_config, with_repeats
    cfg = get_config(m["arch"]).replace(dtype="bfloat16")
    slots = m.get("train_slots") if train else None
    if slots in (None, "all"):
        slots = m.get("slots")
    if slots is None:
        return with_repeats(cfg, m["repeats"])
    pattern = tuple(cfg.pattern[i] for i in slots)
    return cfg.replace(pattern=pattern,
                       n_layers=len(cfg.prefix) + len(pattern))


def dist_kernels():
    """The kernel wrappers whose launches the model part counts."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    return fa.KERNELS + (fa.flash_attention_bwd, ms.mamba_scan,
                         ms.mamba_scan_bwd)


@contextlib.contextmanager
def mesh_groups(mesh):
    """``blocks._moe_groups`` as it resolves under ``mesh`` (groups of the
    batch axis's size), for a run without one: the sharded run's routing
    groups, so its capacity and drops."""
    from repro_torch.dist.sharding import ShardCtx
    from repro_torch.models import blocks
    g = ShardCtx(mesh).axis_size("batch")
    with mock.patch.object(blocks, "_moe_groups",
                           lambda T: g if g > 1 and T % g == 0 else 1):
        yield


def _share_routes(routes, path, dev):
    """Rank 0's recorded routes (None elsewhere) on every rank, through a
    file under the slice's work directory."""
    import torch
    import torch.distributed as dist
    if dist.get_rank() == 0:
        torch.save([tuple(t.cpu() for t in c) for c in routes], path)
    dist.barrier()
    return [tuple(t.to(dev) for t in c) for c in torch.load(path)]


def dist_models_part(conf, dev):
    """The sharded model paths of ``conf["models"]`` on the model mesh
    (:func:`dist_serve_model`, and :func:`dist_train_model` where a model
    trains).  Returns each model's report (rank 0's holds the checks),
    each path's with the seconds it took, its one-rank run and checks
    included."""
    import gc

    import torch
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(tuple(conf["model_mesh"]), device=dev.type)
    out = {}
    for name, m in conf["models"].items():
        out[name] = {}
        paths = (("serve", dist_serve_model),) + (
            (("train", dist_train_model),) if m.get("train_slots") else ())
        for path, run in paths:
            t0 = time.perf_counter()
            res = run(name, m, dev, mesh, conf["work"])
            res["seconds"] = time.perf_counter() - t0
            out[name][path] = res
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def _real(cfg, t):
    return t[..., :cfg.vocab_size]


def _within(cmp, tol):
    return cmp[0] <= tol * (1 + cmp[1])


def dist_serve_model(name, m, dev, mesh, work):
    """One model's prefill and ``steps`` decode steps (greedy inputs: the
    seeded tokens after the prompt) on ``mesh``, against rank 0's
    unsharded run with the same kernels: seconds, the collectives, the
    rank's peak memory and its kernels' launches in the sharded run
    (counts set to 0 just before, read just after); on rank 0 every
    logit and cache leaf against its unsharded run (``LM_TOL_BF16``) and,
    in an MoE model, the routes the sharded run would have taken (it
    takes rank 0's)."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import leaf_paths
    from repro_torch.dist import collective_stats, use_mesh
    from repro_torch.dist.sharding import full_tensor, param_shardings
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer
    rank, cfg = dist.get_rank(), dist_model_cfg(m)
    B, S, n = m["batch"], m["prompt"], m["steps"]
    L, long_ctx = m.get("cache", S + n), m.get("long_ctx", False)
    toks = torch.randint(0, cfg.vocab_size, (B, S + n),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    moe = has_moe(cfg)
    params = lm.init_params(0, cfg, device=dev)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "pattern": [f"{s.mixer}+{s.mlp}"
                       for s in cfg.prefix + cfg.pattern],
           "params": sum(t.numel() for t in tree_leaves(params)),
           "batch": B, "prompt": S, "cache": L, "steps": n,
           "long_ctx": long_ctx, "mesh": list(mesh.shape)}
    ref = want = None
    if rank == 0:  # the unsharded run, grouped as the mesh groups
        with torch.no_grad(), mesh_groups(mesh), (
                record_routes(probs=True) if moe
                else contextlib.nullcontext([])) as ref:
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches = lm.prefill(cfg, params, toks[:, :S],
                                        cache_len=L)
            _sync(dev)
            res["one_rank_prefill_s"] = time.perf_counter() - t0
            want, step_s = [_real(cfg, logits)], []
            for i in range(n):
                _sync(dev)
                t0 = time.perf_counter()
                logits, caches = lm.serve_step(cfg, params, caches,
                                               toks[:, S + i:S + i + 1],
                                               S + i)
                _sync(dev)
                step_s.append(time.perf_counter() - t0)
                want.append(_real(cfg, logits))
            res["one_rank_step_ms"] = sorted(step_s)[n // 2] * 1e3
        want_caches = dict(zip(leaf_paths(caches), tree_leaves(caches)))
    routes = _share_routes(ref, pathlib.Path(work) / f"routes_{name}.pt",
                           dev) if moe else None
    sharded = trainer.shard_state(params, param_shardings(params, cfg,
                                                          mesh))
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for f in dist_kernels():
        f.launches = 0
    with use_mesh(mesh) as ctx, torch.no_grad(), collective_stats() as st, (
            routes_from(routes) if moe
            else contextlib.nullcontext([])) as seen:
        tk = ctx.make_global(toks, ("batch", None))
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = lm.prefill(cfg, sharded, tk[:, :S], cache_len=L)
        caches = lm.lay_out_caches(cfg, caches, long_ctx=long_ctx)
        _sync(dev)
        res["prefill_s"] = time.perf_counter() - t0
        got, step_s = [_real(cfg, full_tensor(logits))], []
        for i in range(n):
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches = lm.serve_step(cfg, sharded, caches,
                                           tk[:, S + i:S + i + 1], S + i,
                                           long_ctx=long_ctx)
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            got.append(_real(cfg, full_tensor(logits)))
    res["launches"] = {f.__name__: f.launches for f in dist_kernels()}
    res["step_ms"] = sorted(step_s)[n // 2] * 1e3
    res["step_ms_all"] = [s * 1e3 for s in step_s]
    res["collectives"] = st.per_kind_count
    res["collective_bytes"] = st.per_kind_bytes
    if dev.type == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    kv = [t for key, t in zip(leaf_paths(caches), tree_leaves(caches))
          if key.endswith(("mixer/k", "mixer/ckv"))]
    res["cache_placements"] = repr(kv[0].placements) if kv else None
    errs = {}
    for key, t in zip(leaf_paths(caches), tree_leaves(caches)):
        t = full_tensor(t)
        if rank == 0:
            errs[key] = lm_compare(t, want_caches[key])
    if rank == 0:
        logit_errs = [lm_compare(g, w) for g, w in zip(got, want)]
        worst_cache = max(errs, key=lambda k: errs[k][0]
                          / (1 + errs[k][1]))
        res.update(
            tol=LM_TOL_BF16, prefill_logits=logit_errs[0],
            step_logits_worst=max(logit_errs[1:],
                                  key=lambda c: c[0] / (1 + c[1])),
            caches=len(errs), worst_cache_leaf=worst_cache,
            worst_cache=errs[worst_cache],
            checks={"logits_within_tol": all(_within(c, LM_TOL_BF16)
                                             for c in logit_errs),
                    "caches_within_tol": all(_within(c, LM_TOL_BF16)
                                             for c in errs.values()),
                    "finite": all(bool(torch.isfinite(g).all())
                                  for g in got)})
        if moe:
            flips, drift, near = route_flips(seen, ref, cfg,
                                             calls=len(ref))
            res.update(route_calls=len(ref), tokens_flipped=len(flips),
                       flips=flips[:20], flip_margin_max=max(
                           (f["margin"] for f in flips), default=0.0),
                       prob_drift_max=max(drift), routes_from_rank0=True)
            res["checks"]["flips_near_ties"] = near
    return res


def dist_train_model(name, m, dev, mesh, work):
    """One model's training cut (``train_slots``) on ``mesh``: every
    leaf's gradient of one TokenPipeline batch against rank 0's unsharded
    gradient with the same kernels (``DIST_GRAD_TOL``; an MoE model's
    sharded run takes rank 0's routes, each route it would have taken
    otherwise named with its margin), then one train_step: seconds, the
    collectives, the rank's peak memory and its kernels' launches (counts
    set to 0 just before, read just after)."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import leaf_paths
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.dist import collective_stats, use_mesh
    from repro_torch.dist.sharding import full_tensor
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import trainer
    rank, cfg = dist.get_rank(), dist_model_cfg(m, train=True)
    batch = trainer.to_device(TokenPipeline(
        cfg.vocab_size, m["train_seq"], m["train_batch"],
        seed=11).batch_at(0), dev)
    moe = has_moe(cfg)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "pattern": [f"{s.mixer}+{s.mlp}"
                       for s in cfg.prefix + cfg.pattern],
           "batch": m["train_batch"], "seq": m["train_seq"],
           "mesh": list(mesh.shape), "tol": DIST_GRAD_TOL["bfloat16"]}
    ref = want = None
    if rank == 0:
        params = lm.init_params(0, cfg, device=dev)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        with mesh_groups(mesh), (record_routes(probs=True) if moe
                                 else contextlib.nullcontext([])) as ref:
            loss1, want = trainer.compute_grads(cfg, params, batch)
        want = [g.detach() for g in tree_leaves(want)]
        res["loss_one_rank"] = float(loss1)
        del params
    routes = _share_routes(ref, pathlib.Path(work) / f"routes_{name}_t.pt",
                           dev) if moe else None
    state = trainer.make_train_state(0, cfg, device=dev, mesh=mesh)
    res["params"] = sum(t.numel() for t in tree_leaves(state["params"]))
    errs = {}
    with use_mesh(mesh) as ctx, (routes_from(routes) if moe
                                 else contextlib.nullcontext([])) as seen:
        b = {k: ctx.make_global(v, ("batch", None)) for k, v in batch.items()}
        loss, got = trainer.compute_grads(cfg, state["params"], b)
        res["loss"] = float(full_tensor(loss))
        for key, g in zip(leaf_paths(got), tree_leaves(got)):
            g = full_tensor(g.detach())
            if rank == 0:
                w = want.pop(0)
                errs[key] = ((g.float() - w.float()).abs().max()
                             / w.float().abs().max().clamp_min(1e-30)).item()
            del g
        del got
    if rank == 0:
        where = max(errs, key=errs.get)
        res.update(worst=errs[where], worst_leaf=where, leaves=len(errs),
                   checks={"grads_within_tol": errs[where] <= res["tol"],
                           "loss_matches_one_rank": abs(
                               res["loss"] - res["loss_one_rank"])
                           <= DIST_LOSS_RTOL["bfloat16"]
                           * abs(res["loss_one_rank"])})
        if moe:
            flips, drift, near = route_flips(seen, ref, cfg)
            res.update(route_calls=len(ref), tokens_flipped=len(flips),
                       flips=flips[:20], flip_margin_max=max(
                           (f["margin"] for f in flips), default=0.0),
                       prob_drift_max=max(drift), routes_from_rank0=True)
            res["checks"]["flips_near_ties"] = near
    del want
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for f in dist_kernels():
        f.launches = 0
    with use_mesh(mesh) as ctx, collective_stats() as st:
        b = {k: ctx.make_global(v, ("batch", None)) for k, v in batch.items()}
        _sync(dev)
        t0 = time.perf_counter()
        state, mt = trainer.train_step(cfg, state, b, step=LMT_AT_STEP)
        _sync(dev)
        res["step_s"] = time.perf_counter() - t0
    res["launches"] = {f.__name__: f.launches for f in dist_kernels()}
    res["step_loss"] = float(mt["loss"])
    res["grad_norm"] = float(mt["grad_norm"])
    res["collectives"] = st.per_kind_count
    res["collective_bytes"] = st.per_kind_bytes
    if dev.type == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    return res


def dist_report(reports, conf, smi):
    """The ranks' reports as ``dist_slice`` lines (serve, train,
    restore), each checked; returns the main runs' launches summed over
    the ranks by kernel wrapper."""
    checks, launches = {}, {}
    serve = {tier: [r["serve"][tier] for r in reports]
             for tier in conf["bundles"]}
    for tier, rs in serve.items():
        kernel = {"f32": "fused_mlp", "int8": "fused_mlp_int8"}[tier]
        checks.update({
            f"{tier}_bits_equal": all(r["bits_equal"] and r["odd_bits_equal"]
                                      for r in rs),
            f"{tier}_finite": all(r["finite"] for r in rs),
            f"{tier}_route": all(r["route"] == kernel for r in rs),
            f"{tier}_launched_every_rank": all(r["launches"] >= 1
                                               for r in rs),
            f"{tier}_gathered": all(r["collective_bytes"].get(
                "all-gather", 0) > 0 for r in rs)})
        launches[kernel] = sum(r["launches"] for r in rs)
        emit("dist_slice", part="serve", tier=tier, ranks=len(rs),
             mesh=list(conf["serve_mesh"]), rows=rs[0]["rows"],
             odd_rows=rs[0]["odd_rows"], rows_a_rank=rs[0]["rows_a_rank"],
             launches_by_rank=[r["launches"] for r in rs],
             collectives=rs[0]["collectives"],
             collective_bytes=rs[0]["collective_bytes"],
             rows_per_s_sharded=rs[0]["rows_per_s"]["sharded"],
             rows_per_s_unsharded=rs[0]["rows_per_s"]["unsharded"],
             note="sharded rows/s are the cost of sharding on one card "
                  "(four ranks share it, gathers through host memory), "
                  "not a speedup", nvidia_smi=smi,
             **{k: v for k, v in checks.items() if k.startswith(tier)})
    for dtype in conf["dtypes"]:
        rs = [r["train"][dtype] for r in reports]
        r0 = rs[0]
        steps = [s for r in rs for s in r["steps"]]
        kernels = [k for k in rs[0]["launches"] if "bwd" not in k
                   and rs[0]["launches"][k]]
        checks.update({
            f"{dtype}_grads_within_tol": r0["worst"] <= r0["tol"],
            f"{dtype}_loss_matches_one_rank": abs(
                r0["loss"] - r0["loss_one_rank"])
            <= DIST_LOSS_RTOL[dtype] * abs(r0["loss_one_rank"]),
            f"{dtype}_finite": all(
                s["loss"] == s["loss"] and s["grad_norm"] == s["grad_norm"]
                for s in steps),
            f"{dtype}_attention_launched": all(
                sum(v for k, v in r["launches"].items() if "bwd" not in k)
                > 0 for r in rs),
            f"{dtype}_backward_launched": all(
                r["launches"]["flash_attention_bwd"] > 0 for r in rs),
            f"{dtype}_collective_bytes_every_kind": all(
                b > 0 for b in r0["collective_bytes"].values())
            and len(r0["collective_bytes"]) >= 2})
        for k in r0["launches"]:
            launches[k] = launches.get(k, 0) + sum(r["launches"][k]
                                                   for r in rs)
        emit("dist_slice", part="train", arch=conf["arch"], dtype=dtype,
             n_layers=r0["n_layers"], mesh=r0["mesh"], ranks=len(rs),
             batch=conf["batch"], seq=conf["seq"],
             wq_placements=r0["wq_placements"],
             wq_local_shape=r0["wq_local_shape"], loss=r0["loss"],
             loss_one_rank=r0["loss_one_rank"], worst=r0["worst"],
             worst_leaf=r0["worst_leaf"], leaves=r0["leaves"],
             tol=r0["tol"], forward_kernels=kernels,
             launches_by_rank=[r["launches"] for r in rs],
             collectives=r0["collectives"],
             collective_bytes=r0["collective_bytes"],
             collective_bytes_corrected=r0["collective_bytes_corrected"],
             seconds_a_step=[s["seconds"] for s in r0["steps"]],
             losses=[s["loss"] for s in r0["steps"]],
             peak_gib_by_rank=[r.get("peak_gib") for r in rs],
             note="seconds a step are the cost of sharding on one card "
                  "(four ranks share it, collectives through host "
                  "memory), not a speedup", nvidia_smi=smi,
             **{k: v for k, v in checks.items() if k.startswith(dtype)})
        if "restore" in r0:
            rr = [r["restore"] for r in rs]
            checks["restore_bits_equal"] = all(x["bits_equal"] for x in rr)
            checks["restore_relaid"] = r0["restore"][
                "leaves_laid_out_otherwise"] > 0
            emit("dist_slice", part="restore", dtype=dtype,
                 **{k: v for k, v in r0["restore"].items()
                    if k != "bits_equal"},
                 bits_equal=checks["restore_bits_equal"],
                 relaid=checks["restore_relaid"])
    checks.update(dist_models_report(reports, conf, smi, launches))
    if not all(checks.values()):
        raise AssertionError("dist slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


# the kernels each model path must launch on every rank of the sharded
# run: attention's prefill kernel wherever a layer attends, the decode
# kernels wherever a GQA layer decodes (MLA's absorbed step is torch), the
# selective scan wherever a Mamba layer runs; training, attention's
# backward and the scan's backward where their layers train
DIST_MODEL_KERNELS = {
    ("deepseek", "serve"): ("flash_attention_bf16_prefill",),
    ("deepseek", "train"): ("flash_attention_bf16_prefill",
                            "flash_attention_bwd"),
    ("jamba", "serve"): ("flash_attention_bf16_prefill",
                         "flash_attention_bf16_decode",
                         "flash_attention_bf16_combine", "mamba_scan"),
    ("jamba", "train"): ("mamba_scan", "mamba_scan_bwd"),
    ("long", "serve"): ("flash_attention_bf16_prefill",
                        "flash_attention_bf16_decode",
                        "flash_attention_bf16_combine"),
}


def dist_models_report(reports, conf, smi, launches):
    """The model part's ``dist_slice`` lines (one a model and path) and
    their checks: rank 0's comparisons, and each path's kernels launched
    on every rank; adds the ranks' launches to ``launches`` by kernel
    wrapper."""
    checks = {}
    for name in conf["models"]:
        for path in ("serve", "train"):
            rs = [r["models"][name].get(path) for r in reports]
            if rs[0] is None:
                continue
            r0, tag = rs[0], f"{name}_{path}"
            for k, v in r0.get("checks", {}).items():
                checks[f"{tag}_{k}"] = v
            for k in DIST_MODEL_KERNELS[(name, path)]:
                checks[f"{tag}_{k}_every_rank"] = all(
                    r["launches"][k] > 0 for r in rs)
            checks[f"{tag}_collective_bytes"] = sum(
                r0["collective_bytes"].values()) > 0
            for r in rs:
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            emit("dist_slice", part="models", model=name, path=path,
                 ranks=len(rs), launches_by_rank=[r["launches"] for r in rs],
                 peak_gib_by_rank=[r.get("peak_gib") for r in rs],
                 **{k: v for k, v in r0.items()
                    if k not in ("launches", "peak_gib", "checks")},
                 note="times are the cost of sharding on one card (four "
                      "ranks share it, collectives through host memory), "
                      "not a speedup", nvidia_smi=smi,
                 **{k: v for k, v in checks.items() if k.startswith(tag)})
    return checks


# the pod slice: the reference's smoke (2 processes, flight recorder and
# shadow scoring on), minibude at full width on 4 pod processes (8
# callers x 2,048 rows each: 65,536 global rows a pod_flush, both tiers,
# POD_REPS timed flushes against one rank serving the same rows), and the
# host-drop drill at the reference's defaults
POD_SMOKE_PROCESSES, POD_PROCESSES = 2, 4
POD_CALLERS, POD_CALLER_ROWS = 8, 2048
POD_REPS = 5
POD_DRILL_STALL_S, POD_DRILL_WATCHDOG_S = 15.0, 2.0


def run_pod_slice(dev, smi):
    """The multi-host pod (``repro_torch.launch.multihost``) on the card:
    every pod process a rank of one gloo group, all of them sharing the
    one H100, spawned by ``spawn_local_pod`` after the kernels are built
    here.  Part ``smoke``: ``run_smoke`` as the reference runs it, with
    ``--obs`` and ``--shadow-rate 1.0``.  Part ``minibude``: both tiers
    through ``pod_flush`` on ``POD_PROCESSES`` processes
    (:func:`pod_bude_worker`).  Part ``host_drop``:
    ``run_host_drop_drill``.  Pod times are the cost of the pod on one
    card (the processes share it), not a speedup.  Returns the launches
    of the pod flushes, summed over the processes, by kernel wrapper."""
    from repro_torch.launch import multihost
    work = ROOT / "build" / "chip_smoke_pod"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    checks, launches = {}, {"fused_mlp": 0, "fused_mlp_int8": 0}

    t0 = time.perf_counter()
    trace = work / "pod_trace.json"
    res = multihost.run_smoke(processes=POD_SMOKE_PROCESSES,
                              tmpdir=str(work / "smoke"),
                              obs_out=str(trace), shadow_rate=1.0,
                              device=dev.type)
    smoke_s = time.perf_counter() - t0
    snaps = res[0]["obs"]
    agree = {s["process"]: sum(e["name"] == "pod.agree"
                               for e in s["events"]) for s in snaps}
    merged = json.loads(trace.read_text())
    merged = merged.get("traceEvents", merged) \
        if isinstance(merged, dict) else merged
    for r in res:
        launches["fused_mlp"] += r["launches"].get("fused_mlp", 0)
    checks_smoke = {
        "smoke_bits_equal": all(r["equal"] for r in res),
        "smoke_remote_rows": all(r["remote_rows"] > 0 for r in res),
        "smoke_bucket_past_local": all(r["bucket"] > r["local_rows"]
                                       for r in res),
        "smoke_drift_ok": all(r["quality_state"] == "OK" for r in res),
        "smoke_agree_every_host": sorted(agree) == list(
            range(POD_SMOKE_PROCESSES)) and all(agree.values()),
        "smoke_agree_in_trace": sum(e.get("name") == "pod.agree"
                                    for e in merged)
        >= POD_SMOKE_PROCESSES,
        "smoke_on_the_card": all(r["device"].startswith("cuda")
                                 and r["route"] == "fused_mlp"
                                 and r["launches"].get("fused_mlp", 0) >= 1
                                 for r in res)}
    checks.update(checks_smoke)
    emit("pod_slice", part="smoke", processes=POD_SMOKE_PROCESSES,
         device=res[0]["device"], route=res[0]["route"],
         local_rows=res[0]["local_rows"], bucket=res[0]["bucket"],
         remote_rows=[r["remote_rows"] for r in res],
         launches_by_process=[r["launches"] for r in res],
         quality=[r["quality_state"] for r in res],
         pod_agree_by_process=agree, trace_events=len(merged),
         seconds=smoke_s, nvidia_smi=smi, **checks_smoke)

    # the slice's own tune cache (the gate verdict of its int8 bundle),
    # which the pod processes read too
    tcache = importlib.import_module("repro_torch.tune.cache")
    tcache.ART = work / "tune_torch"
    tcache._default.clear()
    conf = {"tune_dir": str(tcache.ART), "callers": POD_CALLERS,
            "caller_rows": POD_CALLER_ROWS, "reps": POD_REPS,
            "bundles": {k: str(v)
                        for k, v in dist_bundles(work, dev).items()}}
    t0 = time.perf_counter()
    # under the drill's watchdog: a healthy pod, fresh processes
    # included, must serve every flush without a false degrade
    reports = multihost.spawn_local_pod(
        POD_PROCESSES, "chip_smoke:pod_bude_worker", (conf,),
        timeout_s=600.0, device=dev.type,
        extra_env={multihost.ENV_POD_WATCHDOG: str(POD_DRILL_WATCHDOG_S)})
    bude_s = time.perf_counter() - t0
    for tier, kernel in (("f32", "fused_mlp"), ("int8", "fused_mlp_int8")):
        rs = [r[tier] for r in reports]
        launches[kernel] += sum(r["launches"] for r in rs)
        tier_checks = {
            f"{tier}_first_flush_in_watchdog": all(
                r["first_pod_flush_s"] < POD_DRILL_WATCHDOG_S for r in rs),
            f"{tier}_never_degraded": not any(r["degraded"] for r in rs),
            f"{tier}_bits_equal": all(r["bits_equal"] for r in rs),
            f"{tier}_finite": all(r["finite"] for r in rs),
            f"{tier}_route": all(r["route"] == kernel for r in rs),
            f"{tier}_launched_every_process": all(r["launches"] >= 1
                                                  for r in rs),
            f"{tier}_no_collective_in_apply": all(
                r["applies"] >= 1 and not r["collectives"] for r in rs),
            f"{tier}_global_rows": all(r["bucket"] == POD_PROCESSES
                                       * POD_CALLERS * POD_CALLER_ROWS
                                       for r in rs)}
        checks.update(tier_checks)
        emit("pod_slice", part="minibude", tier=tier,
             processes=POD_PROCESSES, callers_a_process=POD_CALLERS,
             rows_a_caller=POD_CALLER_ROWS, global_rows=rs[0]["bucket"],
             remote_rows=rs[0]["remote_rows"],
             launches_by_process=[r["launches"] for r in rs],
             collectives_by_process=[r["collectives"] for r in rs],
             first_pod_flush_s_by_process=[r["first_pod_flush_s"]
                                           for r in rs],
             watchdog_s=POD_DRILL_WATCHDOG_S,
             pod_flush_s=rs[0]["pod_flush_s"],
             pod_flush_s_all=rs[0]["pod_flush_s_all"],
             pod_flush_s_by_process=[r["pod_flush_s"] for r in rs],
             traced_flush_span_ms_by_process=[r["span_ms"] for r in rs],
             one_rank_flush_s=rs[0]["one_rank_s"],
             one_rank_flush_s_all=rs[0]["one_rank_s_all"],
             seconds=bude_s,
             note="pod_flush seconds are the cost of the pod on one card "
                  "(four processes share it, the agreement through host "
                  "memory), not a speedup", nvidia_smi=smi, **tier_checks)

    t0 = time.perf_counter()
    drill = multihost.run_host_drop_drill(
        processes=2, tmpdir=str(work / "drill"), stall_s=POD_DRILL_STALL_S,
        watchdog_s=POD_DRILL_WATCHDOG_S, device=dev.type)
    drill_s = time.perf_counter() - t0
    failures = multihost.host_drop_failures(drill, POD_DRILL_STALL_S,
                                            POD_DRILL_WATCHDOG_S)
    drill_checks = {
        "drill_contract": not failures,
        "drill_zero_lost": all(r["resolved"] == r["submitted"]
                               for r in drill),
        "drill_rows_equal": all(r["equal"] for r in drill),
        "drill_degraded_in_time": drill[0]["degraded"] and drill[0][
            "degrade_latency_s"] < POD_DRILL_WATCHDOG_S + 5.0,
        "drill_offenders": drill[0]["offenders"] == [1],
        "drill_healthz_names_host_1": "pod:host-1" in drill[0]["critical"]}
    checks.update(drill_checks)
    emit("pod_slice", part="host_drop", processes=2,
         stall_s=POD_DRILL_STALL_S, watchdog_s=POD_DRILL_WATCHDOG_S,
         degrade_latency_s=[r["degrade_latency_s"] for r in drill],
         flush_s=[r["elapsed_s"] for r in drill],
         setup_s=[r["setup_s"] for r in drill],
         degraded=[r["degraded"] for r in drill],
         offenders=drill[0]["offenders"], critical=drill[0]["critical"],
         failures=failures, seconds=drill_s, nvidia_smi=smi,
         **drill_checks)
    shutil.rmtree(work)
    if not all(checks.values()):
        raise AssertionError("pod slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


def pod_bude_worker(conf):
    """One pod process of the pod slice's minibude part: 8 callers of
    2,048 rows submitted to a thread-free queue and served by one
    ``pod_flush`` under the pod mesh, in each tier.  The tier's first
    flush is timed as it comes, its engine loaded and its mesh apply
    built inside it (in the f32 tier the first flush of a fresh
    process, past its first entry into the mesh); whether the pod
    watchdog ever degraded this process is read at the end.  Rows
    against the one-rank engine's on each caller's rows, bit for bit;
    the kernel's launches and the collectives inside the apply (counted
    on the thread that runs it) over one flush; seconds a flush, warm,
    ``reps`` times, and the host ms of one more flush's spans, traced;
    then rank 0 alone serves the global rows through a mesh-less queue
    (the others wait), ``reps`` times."""
    import torch
    from repro_torch.apps import minibude
    from repro_torch.core import InferenceEngine
    from repro_torch.dist import collective_stats, use_mesh
    from repro_torch.kernels import registry
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.obs import TRACER
    from repro_torch.serve import FlushPolicy, ServeQueue
    from repro_torch.tune import cache as tcache
    tcache.ART = pathlib.Path(conf["tune_dir"])
    dev = multihost.pod_device()
    pid, nproc = multihost.process_index(), multihost.process_count()
    callers, rows = conf["callers"], conf["caller_rows"]
    mesh = make_pod_mesh(device=dev.type)
    full = minibude.make_inputs(nproc * callers * rows, seed=3, device=dev)
    xs = list(full.reshape(nproc, callers, rows, -1)[pid].unbind(0))
    policy = FlushPolicy(max_batch_rows=1 << 30, max_pending_rows=1 << 30)
    out = {"pid": pid}
    for tier, path in conf["bundles"].items():
        kernel = {"f32": "fused_mlp", "int8": "fused_mlp_int8"}[tier]
        q = ServeQueue(policy, device=dev)

        def pod_round():
            with use_mesh(mesh, multi_pod=True):
                futs = [q.submit(path, x) for x in xs]
                _sync(dev)
                t0 = time.perf_counter()
                q.pod_flush(path)
                secs = time.perf_counter() - t0
            return [f.result(60) for f in futs], secs

        multihost.barrier()
        first = pod_round()[1]
        eng = InferenceEngine.get(path, dev)
        ref = [eng(x).cpu() for x in xs]
        stats, apply = [], eng.apply_batched

        def counted(*a, **kw):
            with collective_stats() as st:
                y = apply(*a, **kw)
            stats.append(st.per_kind_count)
            return y

        eng.apply_batched = counted
        registry.reset_counts()
        got, _ = pod_round()
        launches = registry.get_spec(kernel).launches
        del eng.apply_batched
        snap = q.stats(path).snapshot()
        secs = []
        for _ in range(conf["reps"]):
            multihost.barrier()
            secs.append(pod_round()[1])
        # one more round traced: host ms of the flush's spans by name
        # (batch.apply ends with a sync when traced)
        TRACER.enable()
        TRACER.clear()
        multihost.barrier()
        pod_round()
        span_ms = {}
        for sp in TRACER.events():
            if sp.cat in ("pod", "engine"):
                span_ms[sp.name] = span_ms.get(sp.name, 0.0) + sp.dur_s * 1e3
        TRACER.disable()
        TRACER.clear()
        one = []
        multihost.barrier()
        if pid == 0:
            q1 = ServeQueue(policy, device=dev)
            everyone = list(full.reshape(nproc * callers, rows, -1).unbind(0))
            for _ in range(conf["reps"] + 1):
                futs = [q1.submit(path, x) for x in everyone]
                _sync(dev)
                t0 = time.perf_counter()
                q1.flush(path)
                one.append(time.perf_counter() - t0)
                for f in futs:
                    f.result(60)
            one = one[1:]
            q1.close()
        multihost.barrier()
        q.close()
        out[tier] = {
            "route": eng.route, "launches": launches,
            "bits_equal": all(torch.equal(g, r) for g, r in zip(got, ref)),
            "finite": all(bool(torch.isfinite(g).all()) for g in got),
            "applies": len(stats), "collectives": {
                k: v for st in stats for k, v in st.items()},
            "bucket": snap["bucket_rows"] // snap["pod_batches"],
            "remote_rows": snap["remote_rows"] // snap["pod_batches"],
            "first_pod_flush_s": first,
            "pod_flush_s": sorted(secs)[len(secs) // 2],
            "pod_flush_s_all": secs, "span_ms": span_ms,
            "one_rank_s": sorted(one)[len(one) // 2] if one else None,
            "one_rank_s_all": one,
            "degraded": multihost.POD_HEALTH.degraded}
    multihost.barrier()
    return out


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
    from repro_torch.kernels.mamba_scan import mamba_scan as mamba
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
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
    mamba_errs, mamba_failures, mamba_arrays = check_mamba_scan(dev)

    launches = run_slice(dev, work)
    int8_launches = sum(run_int8_slice(app, key, hidden, dev, work)
                        for app, key, hidden in INT8_SLICES)
    train_launches = run_train_slice(dev, smi, work / "train")
    serve_launches, serve_static = run_serve_slice(dev, smi, work)
    control_launches = run_control_slice(dev, smi, work, serve_static)

    timings = time_kernel(bude, BUDE_ACTS, dev, smi)[INFER_POSES]
    timings8_all = time_int8(bude8, dev, smi)
    timings8, time8_256 = timings8_all[INFER_POSES], timings8_all[256]
    timings_new = time_new_kernels(dev, smi, work / "timing_sweeps")
    check_numerics(dev, probe_libs, smi)
    tune_launches = run_tune_phase(work / "bundle", dev, work)
    shutil.rmtree(work)
    lm_launches, rwkv_timing = run_lm_slice(dev, smi, rwkv_arrays)
    _, gqa_timing = run_gqa_lm_slice(dev, smi)
    _, mla_timing = run_mla_lm_slice(dev, smi)
    jamba_launches, mamba_timing = run_jamba_lm_slice(dev, smi,
                                                       mamba_arrays)
    del mamba_arrays
    _, whisper_timing = run_whisper_lm_slice(dev, smi)
    train_work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(train_work, ignore_errors=True)
    train_work.mkdir(parents=True)
    bwd_lines, rwkv_bwd, mamba_bwd, lm_train_launches = run_lm_train_slice(
        dev, smi, train_work)
    bwd, mla_bwd = bwd_lines["llama3.2-3b"], bwd_lines["mla"]
    shutil.rmtree(train_work)
    dist_launches = run_dist_slice(dev, smi)
    pod_launches = run_pod_slice(dev, smi)
    if rwkv_failures or mamba_failures:
        raise AssertionError("; ".join(rwkv_failures + mamba_failures))
    # each flash_attention kernel's launches over the main paths
    flash_by_path = {k: {path: n[k] for path, n in FLASH_LAUNCHES.items()}
                     for k in flash_kernel_launches()}
    flash_launches = {k: sum(v.values()) for k, v in flash_by_path.items()}
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
        if name == "flash_attention":  # the f32 design
            new_rows[-1].update(
                launches=flash_launches["flash_attention_f32"]
                + dist_launches["flash_attention_f32"],
                launches_by_path=dict(
                    flash_by_path["flash_attention_f32"],
                    dist_slice=dist_launches["flash_attention_f32"]),
                max_abs_err=errs_new[name]["llama3.2-3b prefill 4096 f32"])
        if "step_ms" in t:
            new_rows[-1].update(step_ms=t["step_ms"],
                                tuned_step_ms=t["tuned_step_ms"],
                                step_graph_ms=t["step_graph_ms"],
                                tuned_step_graph_ms=t["tuned_step_graph_ms"],
                                step_bound_ms=t["step_bound_ms"])
    lm_p, lm_d = gqa_timing["prefill"], gqa_timing["decode"]
    lm_t, mla_p = gqa_timing["train forward"], mla_timing["prefill"]
    dk = lm_d["decode_kernels"]
    new_rows += [{
        "name": "flash_attention_bf16", "route": "cuda",
        "source": flash.BF16_SOURCE, "replaces": flash.REPLACES,
        "replaces_note": "its bf16 forward; f32 runs flash_attention",
        "design": FLASH_BF16_DESIGN,
        "launches": flash_launches["flash_attention_bf16_prefill"]
        + dist_launches["flash_attention_bf16_prefill"],
        "launches_by_path": dict(
            flash_by_path["flash_attention_bf16_prefill"],
            dist_slice=dist_launches["flash_attention_bf16_prefill"]),
        "max_abs_err": lm_p["max_abs_err"], "rtol": BF16_RTOL,
        "atol": flash_ops.TOL[1], "shape": lm_p["problem"],
        "params": lm_p["params"], "ms": lm_p["ms"],
        "plain_ms": lm_p["plain_ms"], "bound_ms": lm_p["bound_ms"],
        "bound_by": lm_p["bound_by"],
        "bound_split_ms": lm_p["bound_split_ms"],
        "library_ms": lm_p["library_ms"],
        "library_backend": lm_p["library_backend"],
        "tiles_ms": lm_p["tiles_ms"],
        **{f"{pre}_{k}": t[k] for pre, t in (("mla_prefill", mla_p),
                                             ("train_forward", lm_t))
           for k in ("problem", "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "bound_split_ms", "library_ms",
                     "library_backend", "tiles_ms")},
        **{f"whisper_{pre}_{k}": whisper_timing[label][k]
           for pre, label in (("encoder", "encoder"),
                              ("cross_prefill", "cross prefill"))
           for k in ("problem", "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "bound_split_ms", "library_ms",
                     "library_backend")}}, {
        "name": "flash_attention_bf16_decode", "route": "cuda",
        "source": flash.BF16_SOURCE, "replaces": flash.REPLACES,
        "replaces_note": "its bf16 forward at most 16 rows a kv head (a "
                         "decode step); partials for the combine",
        "launches": flash_launches["flash_attention_bf16_decode"]
        + dist_launches["flash_attention_bf16_decode"],
        "launches_by_path": dict(
            flash_by_path["flash_attention_bf16_decode"],
            dist_slice=dist_launches["flash_attention_bf16_decode"]),
        "max_abs_err": dk["decode_max_abs_err"],
        "tol_of_scale": 1e-4, "shape": lm_d["problem"],
        "splits": dk["splits"], "keys": dk["keys"],
        "ms": dk["decode_ms"], "plain_ms": dk["decode_plain_ms"],
        "bound_ms": dk["decode_bound_ms"], "bound_by": dk["decode_bound_by"],
        "library_ms": None,
        "op_ms": lm_d["ms"], "op_graph_ms": lm_d["graph_ms"],
        "op_plain_ms": lm_d["plain_ms"], "op_bound_ms": lm_d["bound_ms"],
        "op_library_ms": lm_d["library_ms"],
        "op_max_abs_err": lm_d["max_abs_err"],
        **{f"whisper_{pre}_{k}": v
           for pre, label in (("self_step", "decode self"),
                              ("cross_step", "decode cross"))
           for k, v in dict(
               whisper_timing[label]["decode_kernels"],
               op_ms=whisper_timing[label]["ms"],
               op_graph_ms=whisper_timing[label]["graph_ms"],
               op_plain_ms=whisper_timing[label]["plain_ms"],
               op_bound_ms=whisper_timing[label]["bound_ms"],
               op_library_ms=whisper_timing[label]["library_ms"],
               problem=whisper_timing[label]["problem"]).items()}}, {
        "name": "flash_attention_bf16_combine", "route": "cuda",
        "source": flash.BF16_SOURCE, "replaces": flash.REPLACES,
        "replaces_note": "the decode kernel's partials added in ascending "
                         "order (no Pallas counterpart: the TPU kernel "
                         "walks every key in one grid)",
        "launches": flash_launches["flash_attention_bf16_combine"]
        + dist_launches["flash_attention_bf16_combine"],
        "launches_by_path": dict(
            flash_by_path["flash_attention_bf16_combine"],
            dist_slice=dist_launches["flash_attention_bf16_combine"]),
        "max_abs_err": dk["combine_max_abs_err"], "rtol": BF16_RTOL,
        "atol": 2e-5, "shape": lm_d["problem"], "ms": dk["combine_ms"],
        "plain_ms": dk["combine_plain_ms"],
        "bound_ms": dk["combine_bound_ms"],
        "bound_by": dk["combine_bound_by"], "library_ms": None}]
    kernels = [{
        "name": "fused_mlp", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches["fused_mlp"] + train_launches
        + serve_launches["fused_mlp"] + control_launches["fused_mlp"]
        + dist_launches["fused_mlp"] + pod_launches["fused_mlp"],
        "launches_by_path": {"slice": launches["fused_mlp"],
                             "train_slice": train_launches,
                             "serve_slice": serve_launches["fused_mlp"],
                             "control_slice": control_launches["fused_mlp"],
                             "dist_slice": dist_launches["fused_mlp"],
                             "pod_slice": pod_launches["fused_mlp"]},
        "max_abs_err": errs[INFER_POSES], "rtol": SPEC.tol[0],
        "atol": SPEC.tol[1],
        "batch": INFER_POSES, "ms": timings["ms"],
        "plain_ms": timings["plain_ms"],
        "bound_ms": timings["bound_ms"],
        "bound_by": timings["bound_by"],
        "bound_tc_ms": timings["bound_tc_ms"],
        "library_ms": timings["library_ms"]}, {
        "name": "fused_mlp_int8", "route": "cuda", "source": int8.SOURCE,
        "replaces": int8.REPLACES,
        "launches": int8_launches + serve_launches["fused_mlp_int8"]
        + control_launches["fused_mlp_int8"]
        + dist_launches["fused_mlp_int8"] + pod_launches["fused_mlp_int8"],
        "launches_by_path": {
            "int8_slice": int8_launches,
            "serve_slice": serve_launches["fused_mlp_int8"],
            "control_slice": control_launches["fused_mlp_int8"],
            "dist_slice": dist_launches["fused_mlp_int8"],
            "pod_slice": pod_launches["fused_mlp_int8"]},
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
        "replaces": rwkv.REPLACES,
        "launches": lm_launches + sum(lm_train_launches["rwkv6_chunk"]
                                      .values()),
        "launches_by_path": {
            "lm_slice": lm_launches,
            "lm_train_slice": lm_train_launches["rwkv6_chunk"]},
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
        "decode_bound_ms": rwkv_timing["decode"]["bound_ms"]}, {
        "name": "mamba_scan", "route": "cuda", "source": mamba.SOURCE,
        "replaces": mamba.REPLACES,
        "replaces_note": "no Pallas kernel: the jnp associative scan of "
                         "mamba_seq",
        "launches": jamba_launches[0]
        + sum(lm_train_launches["mamba_scan"].values())
        + dist_launches["mamba_scan"],
        "launches_by_path": {
            "jamba_lm_slice": jamba_launches[0],
            "lm_train_slice": lm_train_launches["mamba_scan"],
            "dist_slice": dist_launches["mamba_scan"]},
        "max_abs_err": mamba_errs["jamba prefill bf16"]["max_abs_err"],
        "worst_vs_terms": mamba_errs["jamba prefill bf16"]["worst_vs_terms"],
        "rtol": mamba_ops.SPEC.tol[0], "atol": mamba_ops.SPEC.tol[1],
        "shape": JAMBA_SCAN, "ms": mamba_timing["ms"],
        "plain_ms": mamba_timing["plain_ms"],
        "bound_ms": mamba_timing["bound_ms"],
        "bound_by": mamba_timing["bound_by"], "library_ms": None,
        "sfu_only_bound_ms": mamba_timing["sfu_only_bound_ms"],
        "launch": mamba_timing["launch"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": flash.BWD_SOURCE, "replaces": flash.BWD_REPLACES,
        "replaces_note": "no Pallas kernel: jax.grad of full_attention",
        "launches": sum(lm_train_launches["flash_attention_bwd"].values())
        + dist_launches["flash_attention_bwd"],
        "launches_by_path": {
            "lm_train_slice": lm_train_launches["flash_attention_bwd"],
            "dist_slice": dist_launches["flash_attention_bwd"]},
        "max_abs_err": bwd["max_abs_err"], "tol": bwd["tol"],
        "tol_autograd": bwd["tol_autograd"], "shape": bwd["shape"],
        "dtype": bwd["dtype"], "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "products_design": bwd["products_design"],
        "bound_ms_design": bwd["bound_ms_design"],
        "library_ms": bwd["library_ms"],
        **{f"mla_{k}": mla_bwd[k]
           for k in ("shape", "max_abs_err", "tol_autograd", "ms",
                     "plain_ms", "bound_ms", "bound_by", "bound_ms_design",
                     "library_ms", "library_backend")}}, {
        "name": "rwkv6_chunk_bwd", "route": "cuda",
        "source": rwkv.BWD_SOURCE, "replaces": rwkv.BWD_REPLACES,
        "replaces_note": "no Pallas kernel: the gradient XLA takes of the "
                         "chunked associative scan of rwkv6_seq",
        "launches": sum(lm_train_launches["rwkv6_chunk_bwd"].values()),
        "launches_by_path": {
            "lm_train_slice": lm_train_launches["rwkv6_chunk_bwd"]},
        "max_abs_err": rwkv_bwd["max_abs_err"],
        "tol": rwkv_ops.TOL_BWD[torch.float32], "shape": rwkv_bwd["shape"],
        "ms": rwkv_bwd["ms"], "plain_ms": rwkv_bwd["plain_ms"],
        "bound_ms": rwkv_bwd["bound_ms"], "bound_by": rwkv_bwd["bound_by"],
        "bound_f32_ms": rwkv_bwd["bound_f32_ms"],
        "kernels_ms": rwkv_bwd["kernels_ms"],
        "library_ms": None, "launch": rwkv_bwd["launch"]}, {
        "name": "mamba_scan_bwd", "route": "cuda",
        "source": mamba.BWD_SOURCE, "replaces": mamba.BWD_REPLACES,
        "replaces_note": "no Pallas kernel: the gradient XLA takes of the "
                         "chunked associative scan of mamba_seq",
        "launches": sum(lm_train_launches["mamba_scan_bwd"].values())
        + dist_launches["mamba_scan_bwd"],
        "launches_by_path": {
            "lm_train_slice": lm_train_launches["mamba_scan_bwd"],
            "dist_slice": dist_launches["mamba_scan_bwd"]},
        "max_abs_err": mamba_bwd["max_abs_err"],
        "max_err_of_largest": max(mamba_bwd["cases"]["jamba training bf16"][
            "vs_plain_backward"].values()),
        "tol": mamba_ops.TOL_BWD[torch.bfloat16],
        "tol_f32": mamba_ops.TOL_BWD[torch.float32],
        "shape": mamba_bwd["shape"], "ms": mamba_bwd["ms"],
        "plain_ms": mamba_bwd["plain_ms"], "bound_ms": mamba_bwd["bound_ms"],
        "bound_by": mamba_bwd["bound_by"], "library_ms": None,
        "f32_ms": mamba_bwd["f32_ms"], "f32_plain_ms": mamba_bwd["f32_plain_ms"],
        "f32_bound_ms": mamba_bwd["f32_bound_ms"],
        "fwd_ms": mamba_bwd["fwd_ms"], "fwd_keep_ms": mamba_bwd["fwd_keep_ms"],
        "b1_ms": mamba_bwd["b1_ms"], "kernels_ms": mamba_bwd["kernels_ms"],
        "launch": mamba_bwd["launch"]}]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank_main(sys.argv[2:]))
    sys.exit(main())
