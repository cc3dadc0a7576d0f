"""Online kernel re-sweep on serving-shape drift (counterpart of
``repro/tune/resweep.py``).

The tune cache is warmed at deploy for the shapes the flush policy was
*expected* to produce.  When traffic drifts -- a new app submits batches
that coalesce into a bucket nobody tuned -- every dispatch of that shape
silently serves the default tile and the
``repro_tune_cache_miss_keys_total`` counter climbs forever.  This
module closes the loop: the batcher reports each completed batch, and
once a (bundle, bucket) has sustained ``REPRO_RESWEEP_AFTER`` real
dispatches with no tune-cache entry for its key, a sweep of that single
cell is enqueued on a low-priority background worker (same discipline
as the shadow scorer: daemon thread, bounded queue, duty-cycle cap --
a sweep must never contend with serving).

For a bundle serving the gated int8 tier the worker sweeps the
``fused_mlp_int8`` cell as well as the f32 one: both tiers' ladders
stay warm, so a gate decision never flips the engine onto untuned
tiles.

Off by default; enabled with ``REPRO_RESWEEP=1`` (or programmatically
via ``get_resweeper().enable()``).  Completed sweeps count in
``repro_tune_resweep_total{kernel}``.

What the port does differently:

* the cell's key carries :data:`repro_torch.kernels.registry.BACKEND`
  (``cuda``), where the reference asks ``jax.default_backend()``: it is
  the key the registry's dispatch looks up, so a re-swept record is the
  one the next dispatch of that bucket serves;
* the worker runs each sweep under a stream of its own on the engine's
  card: :func:`~repro_torch.tune.kernel_tuner.sweep` launches and times
  on the current stream, and the default stream is shared by every
  thread, so serving batches do not queue behind the sweep's launches
  and the sweep's timing does not wait for theirs;
* an engine on the CPU has no kernel to sweep (the sweep raises off the
  card): :meth:`ResweepWorker.observe` enqueues nothing for it, the
  same "nothing to tune" the reference returns for a non-MLP bundle.
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time
from typing import Optional, Set, Tuple

import torch

from repro_torch.obs import TRACER
from repro_torch.obs import metrics as _m


def _acts_from_layers(layers) -> tuple:
    """Per-dense activation names of a bundle's layer specs (the walk
    ``mlp_stack_from_spec`` does, minus the arrays): the re-swept cell
    must validate with the acts the bundle actually serves."""
    acts, pending = [], False
    for l in layers:
        kind = l.get("kind")
        if kind == "dense":
            if pending:
                acts.append("identity")
            pending = True
        elif kind == "act":
            acts.append(l.get("name"))
            pending = False
    if pending:
        acts.append("identity")
    return tuple(acts)


_RESWEEPS = _m.counter(
    "repro_tune_resweep_total",
    "drift-triggered background kernel sweeps completed",
    ("kernel",))
_ENQUEUED = _m.counter(
    "repro_tune_resweep_enqueued_total",
    "drift-triggered sweep cells enqueued", ("kernel",))


def _on_card(engine) -> bool:
    device = getattr(engine, "device", None)
    return device is not None and torch.device(device).type == "cuda"


class ResweepWorker:
    """Drift-triggered background autotuner (one per process)."""

    #: batches a bucket must sustain before its miss triggers a sweep
    DEFAULT_AFTER = 32
    #: worker CPU share cap, same contract as ShadowScorer.DUTY_CYCLE
    DUTY_CYCLE = 0.25

    def __init__(self, after: Optional[int] = None,
                 max_backlog: int = 16):
        env = os.environ.get("REPRO_RESWEEP", "").strip().lower()
        self.enabled = env in ("1", "true", "on")
        if after is None:
            after = int(os.environ.get("REPRO_RESWEEP_AFTER",
                                       self.DEFAULT_AFTER))
        self.after = int(after)
        self.max_backlog = int(max_backlog)
        self._lock = threading.Lock()
        self._q: "_queue.Queue[Optional[tuple]]" = _queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._pending = 0
        # cells already enqueued or swept this process: the trigger must
        # fire once per (kernel, key), not once per batch past threshold
        self._seen: Set[Tuple[str, str]] = set()

    # ---------------------------------------------------------- control ---
    def enable(self, after: Optional[int] = None) -> "ResweepWorker":
        if after is not None:
            self.after = int(after)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Forget triggered cells (tests)."""
        with self._lock:
            self._seen.clear()

    # ---------------------------------------------------------- trigger ---
    def observe(self, engine, bucket: int, stats) -> bool:
        """One completed batch for ``engine`` at ``bucket`` rows.

        Called by the batcher after ``stats.on_batch``; the fast path
        (disabled, below threshold, or already triggered) is a couple of
        dict probes.  Returns True when a sweep cell was enqueued.
        """
        if not self.enabled:
            return False
        if stats.bucket_batches(bucket) < self.after:
            return False
        if not _on_card(engine):
            return False  # a CPU engine: no kernel to sweep
        from repro_torch.kernels.registry import BACKEND
        from repro_torch.tune.cache import best_params, shape_key
        from repro_torch.tune.kernel_tuner import widths_from_spec
        widths = widths_from_spec(engine.spec)
        if widths is None:
            return False  # not the fused kernel's shape: nothing to tune
        dtype = "float32"
        key = shape_key(widths, dtype, BACKEND, int(bucket))
        tiers = [("fused_mlp", key)]
        if getattr(engine, "tier", "f32") == "int8":
            tiers.append(("fused_mlp_int8", key))
        enqueued = False
        for kernel, k in tiers:
            with self._lock:
                if (kernel, k) in self._seen:
                    continue
                if self._pending >= self.max_backlog:
                    break  # bounded backlog: drop, re-trigger next batch
                # suppress only when the *serving* lookup would hit --
                # a gate-fail record (exact=False) still counts as a miss
                if best_params(kernel, [k]) is not None:
                    self._seen.add((kernel, k))
                    continue
                self._seen.add((kernel, k))
                self._pending += 1
                self._ensure_thread_locked()
            self._q.put((kernel, tuple(widths), int(bucket), dtype,
                         _acts_from_layers(engine.spec.get("layers", ()))
                         or None, torch.device(engine.device)))
            _ENQUEUED.inc(1, kernel=kernel)
            enqueued = True
        return enqueued

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="repro-tune-resweep", daemon=True)
            self._thread.start()

    # ----------------------------------------------------------- worker ---
    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            kernel, widths, bucket, dtype, acts, device = item
            t0 = time.monotonic()
            try:
                with TRACER.span("tune.resweep", cat="tune",
                                 args={"kernel": kernel,
                                       "widths": list(widths),
                                       "bucket": bucket}):
                    self._sweep_cell(kernel, widths, bucket, dtype, acts,
                                     device)
                _RESWEEPS.inc(1, kernel=kernel)
            except Exception as e:  # a failed sweep must never kill serving
                _m.warn_once(
                    f"resweep-error:{kernel}:{widths}:{bucket}",
                    f"background re-sweep failed for {kernel} "
                    f"widths={widths} bucket={bucket}: {e!r}")
            finally:
                busy = time.monotonic() - t0
                with self._lock:
                    self._pending -= 1
                self._q.task_done()
                # low priority: a sweep is seconds of launches, so the
                # duty-cycle sleep is capped rather than proportional
                d = self.DUTY_CYCLE
                time.sleep(min(2.0, busy * (1.0 - d) / d))

    @staticmethod
    def _sweep_cell(kernel, widths, bucket, dtype, acts, device) -> None:
        """Sweep one cell on ``device`` under a stream of its own (the
        lowest priority, which is the default one), so serving's
        launches on the default stream neither wait for it nor are timed
        by it."""
        from repro_torch.tune.kernel_tuner import _acts_for, sweep
        problem = {"widths": tuple(widths),
                   "acts": _acts_for(len(widths) - 1, acts),
                   "batch": int(bucket), "ndim": 2, "dtype": dtype}
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            with torch.cuda.stream(side):
                sweep(kernel, problem, device=device)
            side.synchronize()

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until the backlog drains (tests/benches)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.01)
        return False


_resweeper: Optional[ResweepWorker] = None
_resweeper_lock = threading.Lock()


def get_resweeper() -> ResweepWorker:
    global _resweeper
    with _resweeper_lock:
        if _resweeper is None:
            _resweeper = ResweepWorker()
        return _resweeper
