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
   (6,1024,819,655,524,419,335,1) and at a gelu/tanh/silu/sigmoid net,
   at batches 1, 37, 256 and 65,536, plus bit-identical rows across
   batch sizes, padding and block sizes; the int8 lines also count the
   elements that differ at all (none on a relu/identity net);
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
   a per-layer library chain (``torch.addmm`` + activation for fused_mlp;
   row quantization + ``torch._int_mm`` + dequant for fused_mlp_int8) at
   batches 256 and 65,536, beside the least time the card could take;
7. the ``kernels`` line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each main path (the f32 slice's
region calls, each int8 slice's infer region) and read just after.  Any
failure raises, so the script exits non-zero and prints no result.  The
bundle weights are random: nothing here measures surrogate accuracy.
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
BATCHES = (1, 37, 256, 65536)
TIMED_BATCHES = (256, 65536)
COLLECT_POSES, INFER_POSES = 4096, 65536
# the int8 slices: app, its region's input name, the hidden widths of the
# widest surrogate its surrogate_space() allows
INT8_SLICES = (("minibude", "poses", BUDE_HIDDEN),
               ("bonds", "bonds", (512, 512)),
               ("binomial", "opts", (512, 512)))
GATE_BUDGET_REL = 0.05   # x the f32 output RMS (tests/test_quant.py:58-65)
PEAK_F32_FLOPS = 67e12   # H100 SXM f32 outside the tensor cores
PEAK_INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12


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
    from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp, pack_mlp
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
    block_rows = [fused_mlp(x37, packed, block_rows=r)
                  for r in (1, 2, 4, 8, 16)]
    torch.cuda.synchronize()
    identical = (torch.equal(alone, padded) and torch.equal(alone, full[:37])
                 and all(torch.equal(alone, b) for b in block_rows))
    if not identical:
        raise AssertionError(f"{name}: rows differ across batch or block "
                             f"sizes")
    emit("kernel", kernel="fused_mlp", net=name, widths=list(widths),
         acts=list(acts),
         max_abs_err={str(b): e for b, e in errs.items()}, rtol=rtol,
         atol=atol, rows_bit_identical=identical)
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
    block_rows = [int8.fused_mlp_int8(x37, packed, block_rows=r)
                  for r in int8.BLOCK_ROWS]
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
         rows_bit_identical=identical)
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


def time_kernel(packed, acts, dev, smi):
    """Kernel, plain version and per-layer cuBLAS chain at TIMED_BATCHES."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.nn.layers import ACTS

    ws, bs = packed.weights, packed.biases
    widths = packed.widths
    flops_per_row = 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    n_params = packed.params.numel()
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
        flops = flops_per_row * batch
        nbytes = 4 * (batch * widths[0] + batch * widths[-1] + n_params)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        timings[batch] = dict(
            ms, bound_ms=bound_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            share_of_bound=bound_ms / ms["ms"], flops=flops, bytes=nbytes,
            block_rows=block_rows)
        emit("timing", kernel="fused_mlp", batch=batch,
             library="per-layer cuBLAS chain (torch.addmm + activation)",
             nvidia_smi=smi, **timings[batch])
    return timings


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

        def kernel():
            return int8.fused_mlp_int8(x, packed, block_rows=block_rows)

        def plain():
            return quant_mlp_ref(x, packed.qlayers, packed.acts)

        library, library_error = int8_library_chain(packed, x)
        ms = {"ms": cuda_ms(kernel, iters), "plain_ms": cuda_ms(plain, iters),
              "library_ms": cuda_ms(library, iters) if library else None}
        library_agrees = None
        if library is not None:
            library_agrees = bool(torch.equal(library(), plain()))
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
            f32_ops=f32_ops, bytes=nbytes, block_rows=block_rows)
        emit("timing", kernel="fused_mlp_int8", batch=batch,
             library="per-layer torch quantization + torch._int_mm + "
                     "dequant", library_error=library_error,
             library_equals_plain=library_agrees, nvidia_smi=smi,
             **timings[batch])
    return timings


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

    t_start = time.perf_counter()
    dev = resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all()
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
    bude8, errs8 = check_kernel_int8("minibude", BUDE_WIDTHS, BUDE_ACTS, dev)
    check_kernel_int8("activations", ACT_WIDTHS, ACT_ACTS, dev)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = run_slice(dev, work)
    int8_launches = sum(run_int8_slice(app, key, hidden, dev, work)
                        for app, key, hidden in INT8_SLICES)
    shutil.rmtree(work)

    timings = time_kernel(bude, BUDE_ACTS, dev, smi)[INFER_POSES]
    timings8 = time_int8(bude8, dev, smi)[INFER_POSES]
    print(json.dumps({"kernels": [{
        "name": "fused_mlp", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches["fused_mlp"],
        "max_abs_err": errs[INFER_POSES], "rtol": SPEC.tol[0],
        "atol": SPEC.tol[1],
        "batch": INFER_POSES, "ms": timings["ms"],
        "plain_ms": timings["plain_ms"],
        "bound_ms": timings["bound_ms"],
        "bound_by": timings["bound_by"],
        "library_ms": timings["library_ms"]}, {
        "name": "fused_mlp_int8", "route": "cuda", "source": int8.SOURCE,
        "replaces": int8.REPLACES, "launches": int8_launches,
        "max_abs_err": errs8[INFER_POSES], "rtol": int8.SPEC.tol[0],
        "atol": int8.SPEC.tol[1],
        "batch": INFER_POSES, "ms": timings8["ms"],
        "plain_ms": timings8["plain_ms"],
        "bound_ms": timings8["bound_ms"],
        "bound_by": timings8["bound_by"],
        "library_ms": timings8["library_ms"]}]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
