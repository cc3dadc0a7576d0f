"""Batcher: coalesce queued region requests into bucket-shaped mega-batches
(counterpart of ``repro/serve/batcher.py``).

The queue hands the batcher a FIFO run of requests for one bundle path;
the batcher gathers their rows into one batch padded to its power-of-two
bucket, serves it through the engine's
:meth:`InferenceEngine.apply_batched` (the ``fused_mlp`` or
``fused_mlp_int8`` kernel on the card for a pure-MLP bundle), lands the
result on the host in one device-to-host copy, screens it for NaN/Inf,
and scatters per-request row slices into the callers' futures.

Row-wise surrogates make this exact rather than approximate: each output
row depends only on its input row, and neither kernel splits a row's
sums, so a request's rows come back bit-identical to what a synchronous
``MLRegion._infer`` of the same inputs produces, whichever batch they
rode in (``tests/test_torch_serve.py``; on the card, ``chip_smoke.py``'s
``serve_slice``).

What the port does differently:

* the gather concatenates on the card (``torch.cat``) when every request
  is a CUDA tensor, where the reference tests for committed non-CPU
  ``jax.Array``\\ s; otherwise it gathers into a pooled host buffer
  (page-locked when the batcher serves a CUDA device), zero-padded to
  the bucket, which the engine copies to the card once;
* the landing is one copy into a pooled page-locked buffer, finished (a
  stream sync) before any future sees a view of it; futures resolve to
  CPU tensors that are row views of that buffer;
* the non-finite screen runs once per batch on the device (one
  all-reduce per row) and lands as one bool vector beside the rows;
* there is no buffer donation (XLA's ``donate`` has no torch
  counterpart);
* the ``batcher.scatter`` fault site fires inside the retry loop, after
  the landing: a ``raise`` there is retried like any landing failure,
  where the reference lets it escape ``dispatch``.

After each served batch the drift re-sweep hook reports the bucket to
:mod:`repro_torch.tune.resweep` (a no-op unless ``REPRO_RESWEEP`` is
on).  Left out until the pod paths are ported (ROADMAP queue 1 item 9):
``dispatch_pod``/``_slab_layout`` and the mesh contexts of the
submitters.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, List, Optional

import torch

from repro_torch.obs import TRACER
from repro_torch.obs import metrics as _metrics
from repro_torch.resilience.breaker import BREAKERS
from repro_torch.resilience.faults import FAULTS
from repro_torch.resilience.retry import DEFAULT_RETRY, RetryPolicy
from repro_torch.serve.scratch import ScratchPool
from repro_torch.serve.stats import ServeStats

# process-wide dispatch sequence: ties a request's spans to the batch
# that served it in a trace without threading ids through call sites
_BATCH_IDS = itertools.count()

_RETRIES = _metrics.counter(
    "repro_resilience_retries_total",
    "dispatch attempts retried after a transient failure", ("key",))
_SPLITS = _metrics.counter(
    "repro_resilience_split_retries_total",
    "batches bisected to isolate a poisoned request", ("key",))
_NONFINITE = _metrics.counter(
    "repro_resilience_nonfinite_total",
    "output rows screened as NaN/Inf before scatter", ("key",))


class NonFiniteOutput(RuntimeError):
    """A request's output rows contained NaN/Inf and were withheld.

    Screened before scatter: non-finite surrogate output is a failure
    (the caller falls back to the accurate path via its future's
    exception), never a silently returned value.
    """

    def __init__(self, key: str, rows: int):
        super().__init__(f"non-finite surrogate output for {key!r} "
                         f"({rows} rows withheld)")
        self.key, self.rows = key, rows


def bucket_size(n: int, min_bucket: int = 8) -> int:
    """Smallest power-of-two >= max(n, min_bucket)."""
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b


def bucket_for(n: int, min_bucket: int, n_shards: int = 1) -> int:
    """Dispatch bucket: power-of-two floor, rounded up to a multiple of
    the data-shard count."""
    b = bucket_size(n, max(min_bucket, n_shards))
    if n_shards > 1 and b % n_shards:
        b += -b % n_shards
    return b


class Batcher:
    """Stateless dispatch: gather -> padded apply -> land -> scatter.

    ``engine_for`` maps a queue key (bundle path) to an engine-like
    object exposing ``apply_batched``; the default resolves through the
    process-wide :class:`InferenceEngine` cache on ``device`` (None: the
    CUDA card), so retrained or evicted bundles are picked up between
    batches exactly like synchronous serving.
    """

    def __init__(self, *, min_bucket: int = 8,
                 engine_for: Optional[Callable] = None,
                 scratch: Optional[ScratchPool] = None,
                 retry: Optional[RetryPolicy] = None,
                 device=None):
        self.min_bucket = min_bucket
        self.scratch = scratch or ScratchPool()
        self.retry = retry or DEFAULT_RETRY
        self.device = None if device is None else torch.device(device)
        # ServeQueue attaches its TenantBoard here so per-request
        # outcomes (served rows + latencies, drops) land on the tenant
        # that submitted them; None = tenancy-free queue, zero overhead
        self.tenancy = None
        if engine_for is None:
            from repro_torch.device import resolve_device
            self.device = resolve_device(device)

            def engine_for(key):
                from repro_torch.core.engine import InferenceEngine
                return InferenceEngine.get(key, self.device)
        self._engine_for = engine_for

    def _pin(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @staticmethod
    def _wait_ready(requests) -> None:
        """Order this thread's stream after each request's producer
        stream (submitters that built their rows on a side stream)."""
        for r in requests:
            if r.ready is not None:
                torch.cuda.current_stream(r.x.device).wait_event(r.ready)

    def _gather(self, requests, n: int, bucket: int):
        """Assemble the mega-batch; returns ``(x, prepadded)``.

        A lone request rides through untouched (the engine pads it).
        CUDA inputs concatenate on the card; anything else gathers into
        a pooled host buffer already padded to the bucket (page-locked
        when serving a CUDA device), so the engine skips its own pad and
        copies the batch to the card once.
        """
        self._wait_ready(requests)
        if len(requests) == 1:
            return requests[0].x, False
        x0 = requests[0].x
        feat = tuple(x0.shape[1:])
        if all(r.x.is_cuda for r in requests):
            parts = [r.x for r in requests]
            if bucket > n:
                parts.append(x0.new_zeros((bucket - n,) + feat))
            return torch.cat(parts), True
        buf = self.scratch.take((bucket,) + feat, x0.dtype, pin=self._pin())
        off = 0
        for r in requests:
            buf[off:off + r.n] = r.x
            off += r.n
        buf[off:] = 0  # zero padding: the rows the engine's own pad makes
        return buf, True

    def _to_host(self, Y):
        """Land ``Y`` in pooled host memory with one copy, beside a
        per-row finite flag computed on ``Y``'s device (None for
        non-float outputs).  On CUDA both copies are finished (a stream
        sync) before this returns: futures get row views of the buffer,
        and the pool will not reuse it while any view is alive."""
        pin = Y.is_cuda
        out = self.scratch.take(tuple(Y.shape), Y.dtype, pin=pin)
        finite = None
        if Y.is_floating_point() or Y.is_complex():
            rows = torch.isfinite(Y.reshape(Y.shape[0], -1)).all(1)
            finite = self.scratch.take((int(Y.shape[0]),), torch.bool,
                                       pin=pin)
            finite.copy_(rows, non_blocking=pin)
        out.copy_(Y, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(Y.device).synchronize()
        return out, finite

    def _fail_all(self, requests, exc, stats, reason, busy_s, *,
                  record_breaker_key=None):
        for r in requests:
            r.future.set_exception(exc)
        self._note_dropped(requests)
        stats.on_failure(requests=len(requests),
                         rows=sum(r.n for r in requests), reason=reason,
                         busy_s=busy_s)
        if record_breaker_key is not None:
            BREAKERS.record_failure(record_breaker_key)

    # ------------------------------------------------ tenant attribution ---
    def _note_dropped(self, requests) -> None:
        board = self.tenancy
        if board is None or not requests:
            return
        agg = {}
        for r in requests:
            t = getattr(r, "tenant", None)
            if t is not None:
                c = agg.setdefault(t, [0, 0])
                c[0] += 1
                c[1] += r.n
        for t, (n_req, n_rows) in agg.items():
            board.on_dropped(t, n_req, n_rows)

    def _note_served(self, requests, bad, lats) -> None:
        """Attribute a scattered batch's outcomes per tenant.  ``lats``
        aligns with the non-``bad`` requests in order (exactly how the
        scatter loop builds it)."""
        board = self.tenancy
        if board is None or not requests:
            return
        self._note_dropped([r for i, r in enumerate(requests) if i in bad])
        li = 0
        agg = {}
        for i, r in enumerate(requests):
            if i in bad:
                continue
            lat = lats[li]
            li += 1
            t = getattr(r, "tenant", None)
            if t is None:
                continue
            c = agg.setdefault(t, [0, []])
            c[0] += r.n
            c[1].append(lat)
        for t, (rows, ls) in agg.items():
            board.on_served(t, rows, ls)

    @staticmethod
    def _screen_nonfinite(requests, finite) -> tuple:
        """Indices of requests whose output rows contain NaN/Inf, from
        the per-row flags :meth:`_to_host` landed.  The per-request scan
        runs only when the batch is known dirty."""
        if finite is None:
            return ()
        ok = finite.numpy()
        if ok.all():
            return ()
        bad, off = [], 0
        for i, r in enumerate(requests):
            if not ok[off:off + r.n].all():
                bad.append(i)
            off += r.n
        return tuple(bad)

    def dispatch(self, key: str, requests: List, stats: ServeStats,
                 reason: str, *, _attempts: Optional[int] = None) -> None:
        """Serve one coalesced batch and resolve every request future.

        Failure handling, in order (as in the reference):

        1. Engine *load* failures (missing/corrupt bundle) are
           deterministic: fail the whole batch once, no retry, no split.
        2. Compute/landing failures retry up to ``retry.max_attempts``
           with capped exponential backoff (the batch is re-gathered each
           attempt).
        3. A multi-request batch that exhausts its retries is bisected
           (split-retry): each half re-dispatches with a single attempt,
           recursing down to singles, so one poisoned request cannot fail
           its siblings.
        4. Non-finite output rows are screened before scatter and
           converted to per-request :class:`NonFiniteOutput` failures,
           never silently returned.

        Every outcome feeds the per-key circuit breaker.  Nothing here
        moves work to another device: a kernel failure on the card
        surfaces as failed futures.
        """
        if not requests:
            return
        # monotonic throughout: latencies subtract submit-time stamps
        # taken with time.monotonic(), and mixing clocks is undefined
        t0 = time.monotonic()
        tr = TRACER
        traced = tr.enabled
        bid = next(_BATCH_IDS)
        try:
            eng = self._engine_for(key)
        except Exception as e:
            # bundle-load failures are batch-independent: retrying or
            # splitting would re-fail identically request by request
            tr.instant("batch.error", cat="batch",
                       args={"key": key, "batch": bid, "error": repr(e)})
            self._fail_all(requests, e, stats, reason,
                           time.monotonic() - t0, record_breaker_key=key)
            return
        n = sum(r.n for r in requests)
        bucket = bucket_for(n, self.min_bucket)
        attempts = self.retry.max_attempts if _attempts is None \
            else max(1, _attempts)
        Y = finite = rule = None
        last_exc: Optional[Exception] = None
        for attempt in range(attempts):
            try:
                with tr.span("batch.gather", cat="batch",
                             args={"key": key, "batch": bid, "rows": n,
                                   "bucket": bucket,
                                   "requests": len(requests)}):
                    X, owned = self._gather(requests, n, bucket)
                with tr.span("batch.apply", cat="batch",
                             args={"key": key, "batch": bid,
                                   "bucket": bucket, "reason": reason,
                                   "attempt": attempt}):
                    Y = eng.apply_batched(X, min_bucket=self.min_bucket,
                                          prepadded=owned)
                    if traced and Y.is_cuda:
                        # the span ends with the kernel; untraced, the
                        # landing's sync is the batch's only one
                        torch.cuda.current_stream(Y.device).synchronize()
                del X
                # one device->host copy for the whole mega-batch; the
                # futures get row views of the landed buffer
                with tr.span("batch.to_host", cat="batch",
                             args={"key": key, "batch": bid}):
                    Y, finite = self._to_host(Y)
                if FAULTS.enabled:
                    # landed, not yet scattered: a raise here is retried
                    # like any landing failure
                    rule = FAULTS.fire("batcher.scatter", key=key)
                break
            except Exception as e:
                Y, last_exc = None, e
                tr.instant("batch.error", cat="batch",
                           args={"key": key, "batch": bid,
                                 "attempt": attempt, "error": repr(e)})
                if attempt + 1 < attempts:
                    _RETRIES.inc(1, key=key)
                    time.sleep(self.retry.delay_for(attempt))
        if Y is None:
            if len(requests) > 1:
                # split-retry: bisect so a poisoned request fails alone;
                # children get one attempt each (the backoff budget was
                # already spent above) and recurse down to singles
                _SPLITS.inc(1, key=key)
                tr.instant("batch.split", cat="batch",
                           args={"key": key, "batch": bid,
                                 "requests": len(requests)})
                mid = len(requests) // 2
                self.dispatch(key, requests[:mid], stats, reason,
                              _attempts=1)
                self.dispatch(key, requests[mid:], stats, reason,
                              _attempts=1)
                return
            self._fail_all(requests, last_exc, stats, reason,
                           time.monotonic() - t0, record_breaker_key=key)
            return
        if rule is not None and rule.mode in ("nan", "inf"):
            Y = Y.clone()  # a private copy on the injected path only
            Y[:requests[0].n] = float(rule.value)
            if finite is not None:
                finite = finite.clone()
                finite[:requests[0].n] = False
        bad = self._screen_nonfinite(requests, finite)
        t1 = time.monotonic()
        off = 0
        lats = []
        bad_rows = 0
        # per-request span [enqueue, future resolved]: with queue.submit
        # it tiles the request's whole enqueue->resolve window.  One args
        # dict serves every request of the batch (rec() documents that
        # shared args are safe).
        rargs = {"key": key, "batch": bid, "reason": reason} if traced \
            else None
        for i, r in enumerate(requests):
            if i in bad:
                r.future.set_exception(NonFiniteOutput(key, r.n))
                bad_rows += r.n
                off += r.n
                continue
            r.future.set_result(Y[off:off + r.n])
            off += r.n
            lats.append(t1 - r.t_enqueue)
            if traced:
                tr.rec("serve.request", "serve", r.t_enqueue,
                       time.monotonic(), r.trace, rargs)
        if traced:
            tr.record("batch.scatter", t1, time.monotonic(), cat="batch",
                      args={"key": key, "batch": bid,
                            "requests": len(requests)})
        self._note_served(requests, bad, lats)
        if bad:
            _NONFINITE.inc(bad_rows, key=key)
            tr.instant("batch.nonfinite", cat="batch",
                       args={"key": key, "batch": bid,
                             "requests": len(bad), "rows": bad_rows})
            stats.on_failure(requests=len(bad), rows=bad_rows,
                             reason=reason, busy_s=0.0)
            BREAKERS.record_failure(key)
        else:
            BREAKERS.record_success(key)
        if len(bad) < len(requests):
            stats.on_batch(requests=len(requests) - len(bad),
                           rows=n - bad_rows, bucket=bucket, reason=reason,
                           busy_s=t1 - t0, latencies_s=lats)
            # drift re-sweep trigger: a sustained bucket with no tune
            # entry enqueues a background sweep of that exact cell.
            # Lazy import + disabled fast path keep this a no-op unless
            # REPRO_RESWEEP is on.
            from repro_torch.tune.resweep import get_resweeper
            rs = get_resweeper()
            if rs.enabled:
                rs.observe(eng, bucket, stats)
