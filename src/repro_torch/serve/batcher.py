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
on).  A batch is served under the mesh its first request was submitted
under (:meth:`Batcher._request_ctx`), its bucket a multiple of that
mesh's data shards.

:meth:`Batcher.dispatch_pod` serves one cross-host mega-batch: the pod
processes agree on their row counts and the row dtype (one all-gather
of host integers; a dtype travels as its index in :data:`POD_DTYPES`,
since torch dtypes have no type number), each assembles its slab, the
slabs form one DTensor split over the ``pod`` axis
(``ShardCtx.make_global(global_shape=)``), each process's kernel serves
its own slab, and each lands only its own rows of the result (no
all-gather of the result).  Each process is one rank on one device, so
a slab is ``bucket_for(max(counts), min_bucket, 1)`` rows, where the
reference rounds it to its host's data devices.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, List, Optional

import torch

from repro_torch.dist.sharding import reinstall, use_mesh
from repro_torch.obs import TRACER
from repro_torch.obs import metrics as _metrics
from repro_torch.resilience.breaker import BREAKERS
from repro_torch.resilience.faults import FAULTS
from repro_torch.resilience.retry import DEFAULT_RETRY, RetryPolicy
from repro_torch.serve.scratch import ScratchPool
from repro_torch.serve.stats import ServeStats

#: the row dtypes a pod agrees on, by index (``dispatch_pod`` gathers the
#: index; torch dtypes have no type number to gather)
POD_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
              torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8, torch.bool, torch.complex64, torch.complex128)

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


def _dtype_num(dtype: torch.dtype) -> int:
    """``dtype``'s index in :data:`POD_DTYPES`; past the table for a
    dtype it lacks, which a peer that has to adopt it refuses."""
    return POD_DTYPES.index(dtype) if dtype in POD_DTYPES \
        else len(POD_DTYPES)


def _local_rows(Y, rows):
    """Rows ``[rows[0], rows[1])`` of ``Y`` (all of them for None) as a
    plain tensor; of a DTensor, read from this rank's block, which must
    hold them."""
    from repro_torch.dist.sharding import block_offset, is_dtensor
    if is_dtensor(Y):
        n_rows = int(Y.shape[0])
        local = Y.to_local()
        base = block_offset(Y.device_mesh, Y.placements, 0, n_rows)
        start, stop = (0, n_rows) if rows is None else \
            (int(rows[0]), int(rows[1]))
        if start < base or stop > base + int(local.shape[0]):
            raise RuntimeError(
                f"_to_host: this rank's block holds rows [{base}, "
                f"{base + int(local.shape[0])}) of a {tuple(Y.shape)} "
                f"output, not [{start}, {stop}); the rest is owned by "
                f"other processes.  A multi-process dispatch must read "
                f"only its own slab (ServeQueue.pod_flush / "
                f"Batcher.dispatch_pod)")
        return local[start - base:stop - base]
    return Y if rows is None else Y[int(rows[0]):int(rows[1])]


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

    @staticmethod
    def _request_ctx(requests):
        """Install the submitters' ShardCtx around the batched apply.

        Sharding contexts are thread-local; a deadline/max-batch flush
        runs on the dispatcher thread, which would otherwise serve the
        batch unsharded.  The submit-time ctx governs even when it is
        None (a no-mesh submit flushed inline from inside someone else's
        ``use_mesh`` must not pick up that ambient mesh).  Requests of
        one key arrive FIFO, so the first request's ctx speaks for the
        batch."""
        ctx = requests[0].ctx
        return reinstall(ctx) if ctx is not None else use_mesh(None)

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
        return self._padded(requests, n, bucket, tuple(x0.shape[1:]),
                            x0.dtype), True

    def _padded(self, requests, n: int, rows: int, feat, dtype):
        """The requests' ``n`` rows then zeros, ``rows`` long (the rows
        the engine's own pad makes): concatenated on the card when every
        request is a CUDA tensor, else gathered in a pooled host buffer
        (page-locked when serving a CUDA device)."""
        if requests and all(r.x.is_cuda for r in requests):
            parts = [r.x for r in requests]
            if rows > n:
                parts.append(requests[0].x.new_zeros((rows - n,) + feat))
            return torch.cat(parts)
        buf = self.scratch.take((rows,) + feat, dtype, pin=self._pin())
        off = 0
        for r in requests:
            buf[off:off + r.n] = r.x
            off += r.n
        buf[off:] = 0
        return buf

    def _to_host(self, Y, *, rows=None):
        """Land rows ``[rows[0], rows[1])`` of ``Y`` (default: all) in
        pooled host memory with one copy, beside a per-row finite flag
        computed on ``Y``'s device (None for non-float outputs).  On CUDA
        both copies are finished (a stream sync) before this returns:
        futures get row views of the buffer, and the pool will not reuse
        it while any view is alive.

        Of a DTensor only this rank's block can be read, and that is
        enforced: rows outside it raise instead of landing another
        process's rows (``dispatch_pod`` asks for its own slab)."""
        Y = _local_rows(Y, rows)
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
        ctx = requests[0].ctx
        shards = (ctx.axis_size("data")
                  if ctx is not None and ctx.mesh is not None else 1)
        bucket = bucket_for(n, self.min_bucket, shards)
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
                    with self._request_ctx(requests):
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
        rargs = {"key": key, "batch": bid, "reason": reason} if traced \
            else None
        if self._scatter(key, requests, Y, finite, stats, bucket=bucket,
                         reason=reason, t0=t0, bid=bid, rargs=rargs):
            # drift re-sweep trigger: a sustained bucket with no tune
            # entry enqueues a background sweep of that exact cell.
            # Lazy import + disabled fast path keep this a no-op unless
            # REPRO_RESWEEP is on.
            from repro_torch.tune.resweep import get_resweeper
            rs = get_resweeper()
            if rs.enabled:
                rs.observe(eng, bucket, stats)

    def _scatter(self, key: str, requests: List, Y, finite,
                 stats: ServeStats, *, bucket: int, reason: str, t0: float,
                 bid: int, rargs: Optional[dict],
                 remote_rows: int = 0) -> bool:
        """Hand a landed batch to its futures: each request's rows of
        ``Y`` (the landed host buffer), or :class:`NonFiniteOutput` where
        ``finite`` flags a NaN/Inf row; then the tenant attribution, the
        breaker and the stats.  ``rargs`` are the per-request spans'
        args, None when untraced.  Returns whether the batch served any
        rows (an idle pod host serves none and still counts its batch,
        with ``remote_rows`` from its peers)."""
        tr = TRACER
        traced = rargs is not None
        bad = self._screen_nonfinite(requests, finite)
        t1 = time.monotonic()
        off = 0
        lats = []
        bad_rows = 0
        # per-request span [enqueue, future resolved]: with queue.submit
        # it tiles the request's whole enqueue->resolve window.  One args
        # dict serves every request of the batch (rec() documents that
        # shared args are safe).
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
        if requests and len(bad) == len(requests):
            return False
        stats.on_batch(requests=len(requests) - len(bad),
                       rows=sum(r.n for r in requests) - bad_rows,
                       bucket=bucket, reason=reason, busy_s=t1 - t0,
                       latencies_s=lats, remote_rows=remote_rows)
        return True

    # ------------------------------------------------------------- pod ---
    @staticmethod
    def _dtype_from_num(num: int) -> torch.dtype:
        """The dtype a pod peer gathered as its index in
        :data:`POD_DTYPES`."""
        if 0 <= num < len(POD_DTYPES):
            return POD_DTYPES[num]
        raise ValueError(f"dispatch_pod: unknown dtype num {num} gathered "
                         f"from a pod peer")

    def _slab_layout(self, requests, eng, agreed_num: int = -1):
        """(feature shape, dtype) of one slab row.

        From the local requests when this host has any; an idle host
        derives the feature shape from the engine's bundle spec and the
        dtype from the pod-agreed index, so every process contributes a
        block of the same dtype to the global DTensor."""
        if requests:
            return tuple(requests[0].x.shape[1:]), requests[0].x.dtype
        dtype = (self._dtype_from_num(agreed_num) if agreed_num >= 0
                 else torch.float32)
        return tuple(eng.spec["in_shape"][1:]), dtype

    def dispatch_pod(self, key: str, requests: List, stats: ServeStats, *,
                     ctx=None, reason: str = "pod") -> None:
        """Serve one cross-host mega-batch (collective).

        Every process in the pod must call this at the same point for the
        same key: it contains a collective.  The hosts agree on a common
        per-host slab through an all-gather of their pending row counts;
        each host assembles its slab (its callers' rows + zero padding,
        ``bucket_for(max(counts))`` rows so slabs match), the slabs form
        one batch whose leading dim is split over ``("pod", "data")``
        (``ShardCtx.make_global``), and after the batched apply each host
        reads back *only its own slab*: no cross-host result gather.

        A host with nothing pending still participates (zero slab, no
        futures): collectives cannot be skipped unilaterally.  ``ctx``
        overrides the serving ShardCtx for exactly that case: with no
        local requests there is no submit-time ctx to recover.
        """
        from repro_torch.dist.sharding import current_ctx
        from repro_torch.launch import multihost
        t0 = time.monotonic()
        tr = TRACER
        traced = tr.enabled
        bid = next(_BATCH_IDS)
        if ctx is None:
            ctx = requests[0].ctx if requests else current_ctx()
        local_n = sum(r.n for r in requests)
        my_num = _dtype_num(requests[0].x.dtype) if requests else -1
        # pod.agree: the count/dtype all-gather is where a straggling
        # host shows up: every peer's span stretches to the slowest one
        with tr.span("pod.agree", cat="pod",
                     args={"key": key, "batch": bid, "local_rows": local_n}):
            gathered = multihost.allgather_ints([local_n, my_num])
        counts, dtype_nums = gathered[:, 0], gathered[:, 1]
        total = int(counts.sum())
        if total == 0:
            return
        pid, nproc = multihost.process_index(), len(counts)
        Yh = finite = None
        try:
            if nproc > 1 and (ctx is None or ctx.mesh is None):
                raise RuntimeError(
                    "dispatch_pod: cross-process serving needs a pod "
                    "mesh; submit under use_mesh(make_pod_mesh(), "
                    "multi_pod=True) or pass ctx=")
            # hosts with rows must agree on the row dtype; idle hosts
            # adopt it so every process contributes the same dtype
            active = {int(c) for c, k in zip(dtype_nums, counts) if k > 0}
            if len(active) > 1:
                raise ValueError(
                    f"dispatch_pod: pod hosts submitted mixed row dtypes "
                    f"for {key!r} (dtype nums {sorted(active)})")
            eng = self._engine_for(key)
            feat, dtype = self._slab_layout(requests, eng,
                                            next(iter(active), -1))
            # one rank a process: a slab needs no rounding to data shards
            per_slab = bucket_for(int(counts.max()), self.min_bucket, 1)
            bucket = per_slab * nproc
            self._wait_ready(requests)
            slab = self._padded(requests, local_n, per_slab, feat, dtype)
            if ctx is not None and ctx.mesh is not None:
                X = ctx.make_global(slab, ("data",) + (None,) * len(feat),
                                    global_shape=(bucket,) + feat)
            else:
                X = slab
            with tr.span("batch.apply", cat="pod",
                         args={"key": key, "batch": bid, "bucket": bucket,
                               "pid": pid, "nproc": nproc,
                               "local_rows": local_n, "total_rows": total}):
                with reinstall(ctx) if ctx is not None else use_mesh(None):
                    Y = eng.apply_batched(X, min_bucket=self.min_bucket,
                                          prepadded=True, gather=False)
                if traced and Y.is_cuda:
                    torch.cuda.current_stream(Y.device).synchronize()
            del X, slab
            if requests:
                base = pid * per_slab
                with tr.span("batch.to_host", cat="pod",
                             args={"key": key, "batch": bid}):
                    Yh, finite = self._to_host(Y, rows=(base, base + local_n))
        except Exception as e:
            tr.instant("batch.error", cat="pod",
                       args={"key": key, "batch": bid, "error": repr(e)})
            for r in requests:
                r.future.set_exception(e)
            self._note_dropped(requests)
            stats.on_failure(requests=len(requests), rows=local_n,
                             reason=reason, busy_s=time.monotonic() - t0)
            BREAKERS.record_failure(key)
            if nproc > 1:
                # pod-fatal: a host that bails after the count all-gather
                # (bundle read failure, bad dtype, ...) has left the
                # collective schedule its peers follow; swallowing the
                # error would leave them hung in their next collective
                raise
            return
        rargs = {"key": key, "batch": bid, "reason": reason,
                 "pid": pid, "nproc": nproc} if traced else None
        self._scatter(key, requests, Yh, finite, stats, bucket=bucket,
                      reason=reason, t0=t0, bid=bid, rargs=rargs,
                      remote_rows=total - local_n)
