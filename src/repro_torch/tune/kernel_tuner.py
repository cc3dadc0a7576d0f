"""Measurement-driven autotuning of every registered kernel on the card
(counterpart of ``repro/tune/kernel_tuner.py``).

Each kernel declares its tunables in a
:class:`repro_torch.kernels.registry.KernelSpec` (candidate ladders, the
shared-memory model, the plain version).  :func:`sweep` runs every
candidate through the kernel itself on the card, timed with CUDA events
(warmup, then the median of ``reps`` launches), validates each against
the plain version on the same inputs (bit for bit where the spec declares
``tol=None``, else to the spec's tolerance), and persists the winner in
the port's tune cache (:mod:`repro_torch.tune.cache`, under
``artifacts/tune_torch/``), which :func:`repro_torch.kernels.registry.
dispatch` consults.  A CPU tensor has no kernel to tune: the sweep needs
a card and raises without one.

Entry points:

* :func:`sweep` -- one (kernel, problem) cell: measure, pick, store;
* :func:`sweep_fused_mlp` -- the fused-MLP-shaped wrapper;
* :func:`autotune` -- the buckets an engine bundle serves, or explicit
  widths;
* :func:`autotune_registered` -- every registered kernel's representative
  problems (what ``python -m repro_torch.launch.dryrun --tune`` runs).
"""
from __future__ import annotations

import json
import pathlib
import statistics
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import registry
from repro_torch.kernels.fused_mlp.ops import candidate_tiles
from repro_torch.serve.batcher import bucket_for
from repro_torch.tune.cache import TuneCache, _dtype_name, default_cache

__all__ = ["autotune", "autotune_registered", "candidate_tiles",
           "serve_buckets", "sweep", "sweep_fused_mlp", "widths_from_spec"]


def widths_from_spec(spec: dict) -> Optional[List[int]]:
    """Dense widths of a pure-MLP bundle spec, or None if not pure-MLP:
    flatten folds trailing dims into the feature dim, acts don't change
    widths."""
    in_shape = spec.get("in_shape") or ()
    feat = 1
    for d in in_shape[1:]:
        feat *= int(d)
    widths = [feat]
    for layer in spec.get("layers", ()):
        kind = layer.get("kind")
        if kind == "dense":
            widths.append(int(layer["features"]))
        elif kind in ("act", "flatten"):
            continue
        else:
            return None  # conv/pool/... : not the fused kernel's shape
    return widths if len(widths) > 1 else None


def _acts_for(n_layers: int, acts=None) -> tuple:
    if acts is not None:
        return tuple(acts)
    return ("relu",) * (n_layers - 1) + ("identity",)


def _require_card(device) -> torch.device:
    """The CUDA device a sweep runs on; raises for any other."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"sweep times the kernels on a CUDA card; {dev} "
                         f"has no kernel to tune")
    return dev


def _measure_us(fn, reps: int, warmup: int) -> float:
    """Median microseconds of ``reps`` launches of ``fn``, each between
    two CUDA events, after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3)
    return float(statistics.median(times))


def _outputs_match(spec, out, ref) -> bool:
    """Bit-identity unless the spec carries a tolerance."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return False
    if spec.tol is None:
        return bool(torch.equal(out, ref))
    rtol, atol = spec.tol
    return bool(torch.allclose(out.to(torch.float32), ref.to(torch.float32),
                               rtol=rtol, atol=atol))


def sweep(kernel, problem: dict, *, reps: int = 5, warmup: int = 2,
          cache: Optional[TuneCache] = None, seed: int = 0,
          force: bool = False, device=None) -> dict:
    """Measure every candidate config of one (kernel, problem) cell.

    Returns (and persists) the record the registry dispatch consults:
    ``params``, ``us``, ``default_us``, ``speedup_x``, ``exact``,
    ``backend``, ``swept``, ``tuned_at`` and the winner's params
    flattened.  A candidate whose output fails the check against the
    plain version, or whose launch raises, is disqualified and recorded
    with its error: a tuned config must never change serving results.
    The spec's defaults come first, so ``speedup_x`` is against the
    config dispatch would use untuned.  A cached record is returned
    unmeasured unless ``force``.
    """
    spec = registry.get_spec(kernel) if isinstance(kernel, str) else kernel
    dev = _require_card(device)
    problem = dict(problem)
    problem["dtype"] = _dtype_name(problem.get("dtype", "float32"))
    if not spec.supports(problem):
        raise ValueError(f"{spec.name}: the kernel does not take {problem}")
    cache = cache or default_cache(spec.name)
    key = spec.cache_key(problem, registry.BACKEND)
    if not force:
        cached = cache.get(key)
        if cached is not None:
            return cached

    generator = torch.Generator().manual_seed(seed)
    arrays = spec.make_call(problem, generator, dev)
    ref = spec.ref_call(problem, arrays)
    defaults = spec.defaults()

    swept = []
    for params in spec.candidates(problem):
        entry = {"params": dict(params)}
        try:
            out = spec.run_call(problem, arrays, params)
            entry["exact"] = _outputs_match(spec, out, ref)
            entry["us"] = round(_measure_us(
                lambda p=dict(params): spec.run_call(problem, arrays, p),
                reps, warmup), 2)
        except (RuntimeError, ValueError) as e:  # refused by the kernel
            entry.update(us=None, exact=False,
                         error=f"{type(e).__name__}: {e}"[:200])
        swept.append(entry)

    valid = [s for s in swept if s["exact"]]
    default = next((s for s in swept
                    if s["params"] == defaults and s["us"]), None)
    if valid:
        best = min(valid, key=lambda s: s["us"])
        default_us = default["us"] if default else best["us"]
        rec = {"params": dict(best["params"]), "us": best["us"],
               "default_us": default_us,
               "speedup_x": round(default_us / best["us"], 3)
               if best["us"] else 1.0,
               "exact": True, "backend": registry.BACKEND, "swept": swept,
               "tuned_at": time.time()}
    else:  # nothing validated: recorded so it is not re-swept, never served
        rec = {"params": dict(defaults), "us": None,
               "default_us": default["us"] if default else None,
               "speedup_x": 1.0, "exact": False,
               "backend": registry.BACKEND, "swept": swept,
               "tuned_at": time.time()}
    rec.update(rec["params"])  # flattened winner params (legacy readers)
    cache.put(key, rec)
    return rec


def sweep_fused_mlp(widths: Sequence[int], bucket: int, *,
                    dtype="float32", acts=None, reps: int = 5,
                    warmup: int = 2, cache: Optional[TuneCache] = None,
                    seed: int = 0, force: bool = False, device=None) -> dict:
    """One fused-MLP (widths, bucket) cell through :func:`sweep`."""
    widths = tuple(int(w) for w in widths)
    problem = {"widths": widths, "acts": _acts_for(len(widths) - 1, acts),
               "batch": int(bucket), "ndim": 2, "dtype": _dtype_name(dtype)}
    return sweep("fused_mlp", problem, reps=reps, warmup=warmup,
                 cache=cache, seed=seed, force=force, device=device)


def serve_buckets(min_bucket: int = 8, max_batch_rows: int = 1024,
                  n_shards: int = 1) -> List[int]:
    """The batch buckets ``apply_batched`` can dispatch for a flush
    policy: powers of two from the (shard-raised) floor up to the bucket
    covering ``max_batch_rows``."""
    lo = bucket_for(1, min_bucket, n_shards)
    hi = bucket_for(max_batch_rows, min_bucket, n_shards)
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


def autotune(target, buckets: Optional[Sequence[int]] = None, *,
             dtype="float32", reps: int = 5, warmup: int = 2,
             cache: Optional[TuneCache] = None, force: bool = False,
             verbose: bool = False, device=None) -> List[dict]:
    """Warm the fused-MLP tune cache for everything an engine will serve.

    ``target`` is a bundle path (widths from its ``spec.json``) or a
    widths sequence.  ``buckets`` defaults to the serve-path buckets of
    the default :class:`~repro_torch.serve.queue.FlushPolicy`.  Returns
    the per-bucket records.
    """
    if isinstance(target, (list, tuple)):
        widths = [int(w) for w in target]
    else:
        spec = json.loads(
            (pathlib.Path(str(target)) / "spec.json").read_text())
        widths = widths_from_spec(spec)
        if widths is None:
            raise ValueError(f"bundle {target!r} is not a pure MLP; "
                             "fused_mlp autotuning does not apply")
    if buckets is None:
        from repro_torch.serve.queue import FlushPolicy
        policy = FlushPolicy()
        buckets = serve_buckets(policy.min_bucket, policy.max_batch_rows)
    recs = []
    for b in sorted(set(int(b) for b in buckets)):
        rec = sweep_fused_mlp(widths, b, dtype=dtype, reps=reps,
                              warmup=warmup, cache=cache, force=force,
                              device=device)
        recs.append(rec)
        if verbose:
            print(f"[tune] widths={widths} bucket={b}: "
                  f"block_rows={rec['params'].get('block_rows')} "
                  f"{rec['us']}us vs default {rec['default_us']}us "
                  f"({rec['speedup_x']}x) exact={rec['exact']}",
                  flush=True)
    return recs


def autotune_registered(kernels: Optional[Sequence[str]] = None, *,
                        reps: int = 5, warmup: int = 2,
                        force: bool = False, verbose: bool = False,
                        device=None) -> List[dict]:
    """Sweep every registered kernel's representative problems
    (``KernelSpec.default_problems``); kernels with no tunable params
    are skipped, there being nothing to pick."""
    recs = []
    names = list(kernels) if kernels else [
        s.name for s in registry.all_specs()]
    for name in names:
        spec = registry.get_spec(name)
        if not spec.params:
            continue
        for problem in spec.default_problems:
            rec = sweep(spec, problem, reps=reps, warmup=warmup,
                        force=force, device=device)
            recs.append(rec)
            if verbose:
                print(f"[tune] {spec.name} "
                      f"{spec.cache_key(dict(problem), registry.BACKEND)}: "
                      f"params={rec['params']} {rec['us']}us vs default "
                      f"{rec['default_us']}us ({rec['speedup_x']}x) "
                      f"exact={rec['exact']}", flush=True)
    return recs
