"""ServeQueue: async region serving with coalescing (counterpart of
``repro/serve/queue.py``).

Any number of :class:`MLRegion`\\ s submit inference requests (a block of
bridged rows) keyed by their bundle path; each submit returns a
:class:`ServeFuture`.  Pending requests coalesce per key and are
dispatched as one padded mega-batch by the :class:`Batcher` when a flush
triggers:

  * **max-batch** -- a key's pending rows reach ``policy.max_batch_rows``;
  * **deadline**  -- the oldest pending request ages past
    ``policy.max_delay_s`` (enforced by the dispatcher thread, or by
    :meth:`poll` for thread-free deterministic drivers);
  * **explicit**  -- :meth:`flush` drains everything now.

Backpressure: total queued rows are capped at
``policy.max_pending_rows``; ``submit`` blocks until the dispatcher
drains (or raises :class:`Backpressure` with ``policy.block=False`` /
on timeout), so a runaway producer cannot grow the queue unboundedly.

Multi-tenancy (opt-in): construct with ``tenancy=TenantBoard(...)`` and
submit with ``tenant="name"``.  Admission then charges the tenant's
token bucket before enqueue, per-tenant pending caps add a second
backpressure layer under the global one, and under overload (pending
rows exceed one ``max_batch_rows`` of capacity) flush order across keys
is picked by deficit-round-robin over tenant weights instead of FIFO
(:mod:`repro_torch.serve.tenancy`).

Threading model: all queue state lives behind one condition variable.
Dispatches happen *outside* the lock (in the flusher's thread), so
producers keep enqueueing for other keys while a mega-batch runs.
Without :meth:`start`, the queue is synchronous-deterministic: max-batch
flushes run inline in the submitting thread and ``ServeFuture.result``
flushes the key on demand.

The queue serves one device, its batcher's (``device=None``: the CUDA
card; tests pass ``device="cpu"``).  Rows may be submitted from the host
or from that device; the dispatcher thread selects the device
(``torch.cuda.set_device``) and launches on its default stream, after
the stream each CUDA request was produced on.  Futures resolve to CPU
tensors, row views of the batch landed on the host.

A request carries its submitter's sharding context (``current_ctx()``),
which the batcher re-installs around the apply.  :meth:`ServeQueue.
pod_flush` serves a key's rows of every pod process as one cross-host
mega-batch (:meth:`Batcher.dispatch_pod`), with the reference's key
agreement, heartbeats and watchdog.  The
``controller=`` hook takes any object with ``delay_for``/
``batch_rows_for``, such as
:class:`~repro_torch.tune.controller.AdaptiveFlushController`; a
controller failure serves the static policy through
:func:`~repro_torch.obs.metrics.note_static_fallback`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import current_ctx
from repro_torch.obs import TRACER
from repro_torch.obs.metrics import note_static_fallback
from repro_torch.obs.quality import SHADOW
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.stats import ServeStats


class Backpressure(RuntimeError):
    """The queue is full (policy.max_pending_rows) and cannot admit more."""


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """When to coalesce-and-dispatch, and how much may wait."""

    max_batch_rows: int = 1024        # flush a key at this many pending rows
    max_delay_s: Optional[float] = None   # deadline flush (None: no deadline)
    min_bucket: int = 8               # smallest padded bucket
    max_pending_rows: int = 8192      # backpressure across all keys
    block: bool = True                # submit blocks when full vs raises
    block_timeout_s: float = 30.0     # blocked submit gives up after this


class ServeFuture:
    """Resolves to the engine-output rows ``[n, ...]`` for one request.

    Resolution is first-wins: once set, later ``set_result`` /
    ``set_exception`` calls are dropped.  The pod watchdog relies on
    this: a zombie collective thread that finishes after the watchdog
    already re-dispatched locally cannot overwrite the delivered rows.
    The rows are a CPU tensor, a view of the batch landed on the host.
    """

    __slots__ = ("_event", "_value", "_exc", "_queue", "_key", "_lock",
                 "trace")

    def __init__(self, queue: "ServeQueue", key: str):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._exc: Optional[BaseException] = None
        self._queue = queue
        self._key = key
        self.trace: Optional[str] = None  # obs trace id (when tracing)

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self._event.set()
            return True

    def set_exception(self, exc: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._exc = exc
            self._event.set()
            return True

    def result(self, timeout: Optional[float] = None):
        if not self._event.is_set():
            # thread-free queues make progress on demand; threaded queues
            # will resolve us from the dispatcher, so just wait
            self._queue._progress(self._key)
            if not self._event.wait(timeout):
                raise TimeoutError(
                    f"serve request for {self._key!r} not resolved within "
                    f"{timeout}s (queue depth "
                    f"{self._queue.depth(self._key)} rows)")
        if self._exc is not None:
            raise self._exc
        return self._value


class _Request:
    __slots__ = ("key", "x", "n", "future", "t_enqueue", "ready", "trace",
                 "tenant", "ctx")

    def __init__(self, key, x, n, future, t_enqueue, ready=None, trace=None,
                 tenant=None, ctx=None):
        self.key, self.x, self.n = key, x, n
        self.ctx = ctx  # submitter's ShardCtx: sharding is thread-local
        self.future, self.t_enqueue = future, t_enqueue
        # CUDA event on the submitter's side stream (None on the default
        # stream or the host): the gather waits for it on the card
        self.ready = ready
        self.trace = trace  # obs trace id, minted at submit, rides along
        self.tenant = tenant  # tenancy id (None on tenancy-free queues)


class _StatsGate:
    """Revocable forwarding proxy for :class:`ServeStats`.

    The pod watchdog hands the collective dispatch this gate instead of
    the real stats object; on timeout it calls :meth:`kill` before
    re-dispatching locally, so the zombie collective thread, should it
    ever finish, cannot double-account the batch it lost.  ``kill()``
    returns False when the dispatch already delivered through the gate,
    in which case the watchdog treats the round as completed instead.
    """

    def __init__(self, stats):
        self._stats = stats
        self._lock = threading.Lock()
        self._dead = False
        self._consumed = False

    def on_batch(self, **kw) -> None:
        with self._lock:
            if self._dead:
                return
            self._consumed = True
        self._stats.on_batch(**kw)

    def on_failure(self, **kw) -> None:
        with self._lock:
            if self._dead:
                return
            self._consumed = True
        self._stats.on_failure(**kw)

    def kill(self) -> bool:
        """Revoke the gate; True when nothing was delivered through it."""
        with self._lock:
            self._dead = True
            return not self._consumed


class ServeQueue:
    def __init__(self, policy: FlushPolicy = FlushPolicy(), *,
                 batcher: Optional[Batcher] = None, controller=None,
                 tenancy=None, latency_window: int = 2048, device=None):
        self.policy = policy
        self.controller = controller  # delay_for/batch_rows_for duck type
        self.tenancy = tenancy  # serve.tenancy.TenantBoard (or None)
        self.latency_window = int(latency_window)
        self._batcher = batcher or Batcher(min_bucket=policy.min_bucket,
                                           device=device)
        self.device = self._batcher.device
        if tenancy is not None:
            # the batcher attributes per-request outcomes (served rows,
            # latencies, drops) back to tenants; the controller reads
            # per-key QoS tiers for its deadline targets
            self._batcher.tenancy = tenancy
            if controller is not None and \
                    getattr(controller, "tenancy", None) is None:
                controller.tenancy = tenancy
        self._cv = threading.Condition()
        self._pending: Dict[str, List[_Request]] = {}
        self._rows_total = 0
        self._stats: Dict[str, ServeStats] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._crashed: Optional[BaseException] = None
        self._closed = False

    # ------------------------------------------------- adaptive policy ---
    # An attached controller overrides the static deadline and max-batch
    # trigger per key from observed arrival rates + predicted batch
    # latency; any controller failure degrades to the static policy, so
    # an adaptive queue can never serve *worse* than its FlushPolicy.
    def _delay_for(self, key: str) -> Optional[float]:
        if self.controller is not None:
            try:
                return self.controller.delay_for(key, self._stats.get(key))
            except Exception as exc:
                note_static_fallback(key, "controller-error", repr(exc))
                return self.policy.max_delay_s
        return self.policy.max_delay_s

    def _batch_rows_for(self, key: str) -> int:
        if self.controller is not None:
            try:
                return max(1, int(self.controller.batch_rows_for(
                    key, self._stats.get(key))))
            except Exception as exc:
                note_static_fallback(key, "controller-error", repr(exc))
                return self.policy.max_batch_rows
        return self.policy.max_batch_rows

    def _may_deadline(self) -> bool:
        """Could *any* key ever get a deadline flush from the thread?"""
        return self.policy.max_delay_s is not None or \
            self.controller is not None

    # ------------------------------------------------------------ state ---
    def stats(self, key: str) -> ServeStats:
        with self._cv:
            return self._stat_locked(key)

    def _stat_locked(self, key: str) -> ServeStats:
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = ServeStats(
                key, latency_window=self.latency_window)
        return st

    def depth(self, key: Optional[str] = None) -> int:
        """Pending rows for one key (or across all keys)."""
        with self._cv:
            if key is None:
                return self._rows_total
            return sum(r.n for r in self._pending.get(key, ()))

    def keys(self):
        with self._cv:
            return list(self._pending)

    # -------------------------------------------------------- liveness ---
    def liveness(self) -> Dict[str, object]:
        """Queue liveness for readiness probes (``/healthz``)."""
        with self._cv:
            t = self._thread
            return {
                "mode": "threaded" if t is not None else "thread-free",
                "dispatcher_alive": bool(t is not None and t.is_alive()),
                "stopping": self._stopping,
                "closed": self._closed,
                "crashed": repr(self._crashed) if self._crashed else None,
                "pending_rows": self._rows_total,
                "pending_keys": len(self._pending),
            }

    def healthy(self) -> bool:
        """False when a started dispatcher thread has died (requests
        would queue forever).  Thread-free queues are always healthy —
        callers make their own progress."""
        with self._cv:
            if self._crashed is not None:
                return False
            t = self._thread
            return t is None or (t.is_alive() and not self._stopping)

    def snapshot(self) -> Dict[str, object]:
        """Liveness plus every key's serve-stats snapshot (``/varz``);
        with a tenancy board, the per-tenant occupancy/p99/drop board
        and the weight-residency state ride along."""
        with self._cv:
            stats = dict(self._stats)
        snap = {"liveness": self.liveness(),
                "keys": {k: s.snapshot() for k, s in sorted(stats.items())}}
        if self.tenancy is not None:
            snap["tenants"] = self.tenancy.snapshot()
            from repro_torch.serve.residency import RESIDENCY
            snap["residency"] = RESIDENCY.snapshot()
        return snap

    def tenant_offenders(self) -> List[str]:
        """Tenant ids misbehaving now (dropping rows / stuck past their
        pending cap) — ``/healthz`` names them ``tenant:<id>``."""
        if self.tenancy is None:
            return []
        return self.tenancy.offenders()

    # ----------------------------------------------------------- submit ---
    def submit(self, key: str, rows, *,
               tenant: Optional[str] = None) -> ServeFuture:
        """Queue ``rows`` ([n, ...features], n >= 1) for bundle ``key``.

        With a tenancy board attached, ``tenant`` names the submitting
        tenant (default tenant otherwise): admission charges its token
        bucket *before* enqueue — an empty bucket blocks for refill
        (``policy.block``) or raises
        :class:`repro_torch.serve.tenancy.TenantThrottled` — and the tenant's
        pending-row cap backpressures under the global one.
        """
        board = self.tenancy
        if board is not None:
            from repro_torch.serve.tenancy import DEFAULT_TENANT
            tenant = tenant or DEFAULT_TENANT
        # tensors are held as given (the caller must not write into them
        # until the future resolves); anything else is copied
        x = rows if isinstance(rows, torch.Tensor) \
            else torch.from_numpy(np.array(rows))
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"submit needs [n, ...] rows, got "
                             f"{tuple(x.shape)}")
        ready = None
        if x.is_cuda and torch.cuda.current_stream(x.device) != \
                torch.cuda.default_stream(x.device):
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(x.device))
        n = int(x.shape[0])
        if board is not None:
            # token-bucket admission happens at the door, outside every
            # lock: refill is wall-clock, so a blocked submit sleeps in
            # the board rather than waiting on the queue's condvar
            board.admit(tenant, n, block=self.policy.block,
                        timeout_s=self.policy.block_timeout_s)
        fut = ServeFuture(self, key)
        t_sub = time.monotonic()
        trace = TRACER.new_trace_id() if TRACER.enabled else None
        fut.trace = trace  # shadow scoring rides the same id
        req = _Request(key, x, n, fut, t_sub, ready, trace, tenant,
                       current_ctx())
        deadline = t_sub + self.policy.block_timeout_s
        while True:
            admitted, drain_inline, flush_inline = False, False, False
            with self._cv:
                self._check_open_locked()
                pend = self._pending.get(key)
                if pend and pend[0].x.shape[1:] != x.shape[1:]:
                    raise ValueError(
                        f"feature-shape mismatch for {key!r}: queued "
                        f"{tuple(pend[0].x.shape[1:])}, submitted "
                        f"{tuple(x.shape[1:])}")
                # backpressure: an oversized request is admitted alone into
                # an empty queue (flushing as its own batch: no deadlock);
                # the tenant's own pending cap applies under the global one
                if self._admit_locked(n) and (
                        board is None or board.has_room(tenant, n)):
                    admitted = True
                    self._pending.setdefault(key, []).append(req)
                    self._rows_total += n
                    self._stat_locked(key).on_enqueue(n)
                    if sum(r.n for r in self._pending[key]) >= \
                            self._batch_rows_for(key):
                        if self._thread is not None:
                            self._cv.notify_all()
                        else:
                            flush_inline = True
                    elif self._thread is not None and self._may_deadline():
                        self._cv.notify_all()  # recompute thread deadline
                elif not self.policy.block:
                    raise Backpressure(
                        f"{self._rows_total}+{n} rows exceeds "
                        f"max_pending_rows={self.policy.max_pending_rows}")
                elif self._thread is not None:
                    # a dispatcher will drain; wait for it to make space
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cv.wait(timeout=left):
                        raise Backpressure(
                            f"submit blocked >{self.policy.block_timeout_s}s "
                            f"({self._rows_total} rows pending)")
                else:
                    # thread-free queue: nobody else can flush, so the
                    # submitting thread must make space itself
                    drain_inline = True
            if admitted:
                if board is not None:
                    board.on_enqueue(tenant, key, n)
                if trace is not None:
                    # submitter-thread span: admission (incl. any time
                    # blocked on backpressure).  The dispatcher's
                    # serve.request span starts at t_enqueue, so together
                    # the request's spans tile enqueue -> resolve gap-free.
                    TRACER.rec("queue.submit", "queue", t_sub,
                               time.monotonic(), trace,
                               {"key": key, "rows": n})
                if flush_inline:
                    self.flush(key, reason="max_batch")
                return fut
            if drain_inline:
                if self.flush(reason="backpressure") == 0 or \
                        time.monotonic() > deadline:
                    raise Backpressure(
                        f"queue full ({self._rows_total} rows) and inline "
                        f"drain freed nothing")

    def _admit_locked(self, n: int) -> bool:
        if self._rows_total == 0:
            return True
        return self._rows_total + n <= self.policy.max_pending_rows

    def _check_open_locked(self) -> None:
        if self._closed:
            raise RuntimeError("submit on a closed ServeQueue")
        if self._crashed is not None:
            raise RuntimeError(
                f"serve dispatcher thread died: {self._crashed!r}"
            ) from self._crashed

    # ------------------------------------------------------------ flush ---
    def flush(self, key: Optional[str] = None, *,
              reason: str = "explicit") -> int:
        """Dispatch everything pending for ``key`` (or all keys) now.

        Returns the number of rows dispatched.  Runs in the caller's
        thread; the queue lock is *not* held during the batched apply,
        so concurrent submits proceed.
        """
        dispatched = 0
        keys = [key] if key is not None else self._flush_order()
        for k in keys:
            with self._cv:
                reqs = self._pending.pop(k, [])
                rows = sum(r.n for r in reqs)
                self._rows_total -= rows
                st = self._stat_locked(k)
                if rows:
                    self._cv.notify_all()  # wake backpressured submitters
            if reqs:
                self._note_dispatch(reqs)
                self._batcher.dispatch(k, reqs, st, reason)
                dispatched += rows
        return dispatched

    def pod_flush(self, key: Optional[str] = None, *, ctx=None) -> int:
        """Collective flush: this host's pending rows join one cross-host
        mega-batch with every other pod process's rows for ``key``.

        SPMD contract: every process in the pod must call ``pod_flush``
        at the same point with the same key sequence (with ``key=None``
        the hosts agree on the union of their pending key sets, and keys
        dispatch in sorted order so the collectives line up).  A host
        with nothing pending still participates with a zero slab.
        Returns the number of *local* rows dispatched.

        Only thread-free queues may pod-flush: a per-host dispatcher
        thread firing on its own clock would run the collectives in
        different orders on different hosts and deadlock the pod.
        ``ctx`` pins the serving ShardCtx; without it the first
        request's submit-time ctx governs, and a host with no pending
        requests serves under the caller's ``current_ctx()`` (captured
        here: the watchdog dispatches on a thread of its own).

        Dropout tolerance (multi-process only): each flush round writes
        a heartbeat to the bootstrap store and runs the collective under
        a watchdog (``REPRO_POD_WATCHDOG_S``).  If the collective stalls
        past it (a peer dropped or hung), the survivors mark the pod
        degraded (``/healthz`` names the offending ``pod:host-<k>``),
        abandon the collective to a zombie daemon thread, and re-dispatch
        their local rows through the ordinary single-host path, so no
        request is lost and no host deadlocks.  The agreement moves host
        tensors, so the torn collective holds no device and the local
        dispatch runs at once.  While degraded, flushes stay local-only
        until ``POD_HEALTH.try_rejoin`` clears.
        """
        from repro_torch.launch import multihost
        from repro_torch.resilience.faults import FAULTS
        with self._cv:
            if self._thread is not None:
                raise RuntimeError(
                    "pod_flush on a started queue: cross-host flushes are "
                    "collective and must run from the serving loop, not a "
                    "per-host dispatcher thread (use a thread-free queue)")
            keys = [key] if key is not None else sorted(self._pending)
        if FAULTS.enabled:
            # fires before the heartbeat on purpose: a dropped host must
            # look dropped; it never writes this round's beat
            FAULTS.fire("pod.flush", key=key)
        ambient = current_ctx()
        multi = multihost.is_multiprocess()
        if key is None and multi and not multihost.POD_HEALTH.degraded:
            # cross-host key agreement: each host flushes the *union* of
            # everyone's pending key sets; hosts with disjoint keys would
            # otherwise run different collective sequences and deadlock
            keys = self._agree_pod_keys(keys)
        dispatched = 0
        for k in keys:
            with self._cv:
                reqs = self._pending.pop(k, [])
                rows = sum(r.n for r in reqs)
                self._rows_total -= rows
                st = self._stat_locked(k)
                if rows:
                    self._cv.notify_all()  # wake backpressured submitters
            self._note_dispatch(reqs)
            kctx = ctx if ctx is not None else \
                (reqs[0].ctx if reqs else ambient)
            if not multi:
                # single process: the collective is trivially local and
                # cannot stall on a peer, so no watchdog
                self._batcher.dispatch_pod(k, reqs, st, ctx=kctx)
            elif multihost.POD_HEALTH.degraded:
                # survivors serve local-only: entering a collective with
                # a dead peer would hang again
                if reqs:
                    self._dispatch_local_degraded(k, reqs, st)
            else:
                # always dispatch: a zero-row host still owes the pod its
                # collective (dispatch_pod returns early only when every
                # host is empty)
                self._dispatch_pod_guarded(k, reqs, st, kctx)
            dispatched += rows
        return dispatched

    def _guarded(self, name: str, fn) -> tuple:
        """Run ``fn`` on a daemon thread (on this queue's card) under the
        pod watchdog; ``(finished, result, exception)``."""
        from repro_torch.launch import multihost
        box: Dict[str, object] = {}
        done = threading.Event()
        dev = self.device

        def run():
            try:
                if dev is not None and dev.type == "cuda":
                    torch.cuda.set_device(dev)
                box["got"] = fn()
            except BaseException as e:
                box["exc"] = e
            finally:
                done.set()

        threading.Thread(target=run, daemon=True, name=name).start()
        finished = done.wait(timeout=multihost.pod_watchdog_s())
        return finished, box.get("got"), box.get("exc")

    def _agree_pod_keys(self, local: List[str]) -> List[str]:
        """All-gather every host's pending key set; return the sorted
        union (collective: all hosts call it together, which
        ``pod_flush(None)``'s SPMD contract guarantees).

        Runs under the pod watchdog like any other collective: if a peer
        dropped before the gather, the survivors degrade the pod and fall
        back to their local key list (whose requests the caller then
        serves through the degraded local-only path).
        """
        import json
        from repro_torch.launch import multihost
        health = multihost.POD_HEALTH
        round_id = health.beat()
        finished, got, exc = self._guarded(
            "repro-pod-key-agree", lambda: multihost.allgather_bytes(
                json.dumps(sorted(local)).encode()))
        if finished:
            if exc is not None:
                raise exc  # transport failure is pod-fatal, as in dispatch
            agreed = set()
            for blob in got:
                agreed.update(json.loads(bytes(blob).decode()))
            return sorted(agreed)
        offenders = health.check_round(round_id)
        health.mark_degraded(offenders)
        TRACER.instant("pod.watchdog", cat="pod",
                       args={"phase": "key_agreement", "round": round_id,
                             "offenders": list(offenders)})
        return sorted(local)

    def _dispatch_pod_guarded(self, k: str, reqs: List, st, ctx) -> None:
        """Run one collective dispatch under the pod watchdog."""
        from repro_torch.launch import multihost
        health = multihost.POD_HEALTH
        round_id = health.beat()
        gate = _StatsGate(st)
        finished, _, exc = self._guarded(
            "repro-pod-dispatch",
            lambda: self._batcher.dispatch_pod(k, reqs, gate, ctx=ctx))
        if finished:
            if exc is not None:
                raise exc  # pod-fatal contract preserved
            return
        # watchdog fired.  kill() returning False means the collective
        # delivered in the race window between timeout and now: take it.
        if not gate.kill():
            return
        offenders = health.check_round(round_id)
        health.mark_degraded(offenders)
        TRACER.instant("pod.watchdog", cat="pod",
                       args={"key": k, "round": round_id,
                             "offenders": list(offenders)})
        if reqs:
            # zero-lost: the abandoned collective can no longer win;
            # first-wins futures drop anything the zombie produces late
            self._dispatch_local_degraded(k, reqs, st)

    def _dispatch_local_degraded(self, k: str, reqs: List, st) -> None:
        """Serve pod-submitted requests through the single-host path.

        Their submit-time ShardCtx names the (now torn) pod mesh; strip
        it so the batch serves mesh-less.  Row-wise surrogates make the
        results bit-identical either way.
        """
        for r in reqs:
            r.ctx = None
        self._batcher.dispatch(k, reqs, st, reason="pod_degraded")

    def _flush_order(self) -> List[str]:
        """Key order for an all-keys flush: FIFO insertion order, unless
        a tenancy board is attached and the queue is overloaded (more
        pending rows than one max-batch of capacity) — then deficit-
        round-robin over tenant weights picks who drains first."""
        with self._cv:
            if self.tenancy is None or len(self._pending) < 2 or \
                    self._rows_total <= self.policy.max_batch_rows:
                return list(self._pending)
            pairs = [(k, sum(r.n for r in reqs))
                     for k, reqs in self._pending.items()]
        try:
            return self.tenancy.order_keys(pairs)
        except Exception as exc:
            note_static_fallback("tenancy", "drr-error", repr(exc))
            return [k for k, _ in pairs]

    def _note_dispatch(self, reqs: List) -> None:
        """Tenant accounting for rows leaving the queue (any reason)."""
        if self.tenancy is None:
            return
        agg: Dict[str, int] = {}
        for r in reqs:
            t = getattr(r, "tenant", None)
            if t is not None:
                agg[t] = agg.get(t, 0) + r.n
        for t, rows in agg.items():
            self.tenancy.on_dispatch(t, rows)

    def poll(self) -> int:
        """Flush keys whose max-batch/deadline triggers fired (no thread).

        Driver loops that own their own cadence call this instead of
        running a dispatcher thread: same flush decisions, caller's
        thread, deterministic timing.
        """
        dispatched = 0
        for k, why in self._due():
            dispatched += self.flush(k, reason=why)
        return dispatched

    def _due(self):
        with self._cv:
            return self._due_locked()

    def _progress(self, key: str) -> None:
        """Called by a waiting future: flush on demand unless a dispatcher
        thread with a deadline for this key is guaranteed to resolve us.
        (A cold controller over a deadline-free static policy returns
        None — the future must make its own progress, same as no
        controller at all.)"""
        if self._thread is None or self._delay_for(key) is None:
            self.flush(key, reason="demand")

    # ------------------------------------------------------- dispatcher ---
    def start(self) -> "ServeQueue":
        """Run a daemon dispatcher thread enforcing size + deadline flushes."""
        with self._cv:
            if self._thread is not None:
                return self
            self._stopping = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="repro-serve-dispatch")
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        with self._cv:
            t = self._thread
            self._stopping = True
            self._cv.notify_all()
        if t is not None:
            t.join()
        with self._cv:
            self._thread = None
        if drain:
            self.flush(reason="drain")

    def _run(self) -> None:
        try:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.set_device(self.device)  # per thread
            while True:
                with self._cv:
                    if self._stopping:
                        return
                    due = self._due_locked()
                    if not due:
                        self._cv.wait(timeout=self._nearest_deadline())
                        continue
                for k, why in due:
                    self.flush(k, reason=why)
        except BaseException as e:
            # a dying dispatcher must not leave submitters hanging to
            # block_timeout_s: fail every pending future now, mark the
            # queue crashed (healthz flips, new submits refuse), then
            # re-raise so the crash traceback still reaches stderr
            self._on_dispatcher_crash(e)
            raise

    def _on_dispatcher_crash(self, exc: BaseException) -> None:
        with self._cv:
            self._crashed = exc
            pending, self._pending = self._pending, {}
            self._rows_total = 0
            stats = {k: self._stat_locked(k) for k in pending}
            self._cv.notify_all()  # unblock backpressured submitters
        err = RuntimeError(f"serve dispatcher thread died: {exc!r}")
        err.__cause__ = exc
        TRACER.instant("queue.crash", cat="queue",
                       args={"error": repr(exc)})
        for k, reqs in pending.items():
            self._note_failed(reqs)
            for r in reqs:
                r.future.set_exception(err)
            stats[k].on_failure(requests=len(reqs),
                                rows=sum(r.n for r in reqs),
                                reason="dispatcher_crash", busy_s=0.0)

    def _note_failed(self, reqs: List) -> None:
        """Tenant accounting for requests failed without a dispatch
        (dispatcher crash, drain-free close)."""
        self._note_dispatch(reqs)
        if self.tenancy is None:
            return
        agg: Dict[str, list] = {}
        for r in reqs:
            t = getattr(r, "tenant", None)
            if t is not None:
                c = agg.setdefault(t, [0, 0])
                c[0] += 1
                c[1] += r.n
        for t, (n_req, n_rows) in agg.items():
            self.tenancy.on_dropped(t, n_req, n_rows)

    # ------------------------------------------------------------ close ---
    def close(self, drain: bool = True, *, timeout: float = 30.0) -> None:
        """Orderly shutdown for interpreter teardown / atexit.

        Refuses new submits from this point on, stops the dispatcher
        thread, drains (``drain=True``) or fails (``drain=False``) the
        remaining pending batches, and then stops the shadow-scorer
        worker — in that order, so teardown can never race a mid-replay
        scorer against a dying queue.  Idempotent.
        """
        with self._cv:
            if self._closed:
                return
            self._closed = True
        if self._thread is not None:
            self.stop(drain=drain)
        elif drain:
            self.flush(reason="close")
        if not drain:
            with self._cv:
                pending, self._pending = self._pending, {}
                self._rows_total = 0
                stats = {k: self._stat_locked(k) for k in pending}
                self._cv.notify_all()
            err = RuntimeError("ServeQueue closed before dispatch")
            for k, reqs in pending.items():
                self._note_failed(reqs)
                for r in reqs:
                    r.future.set_exception(err)
                stats[k].on_failure(requests=len(reqs),
                                    rows=sum(r.n for r in reqs),
                                    reason="close", busy_s=0.0)
        SHADOW.close(drain=drain, timeout=timeout)

    def _due_locked(self):
        now = time.monotonic()
        due = []
        for k, reqs in self._pending.items():
            if not reqs:
                continue
            delay = self._delay_for(k)
            if sum(r.n for r in reqs) >= self._batch_rows_for(k):
                due.append((k, "max_batch"))
            elif delay is not None and \
                    now - reqs[0].t_enqueue >= delay:
                due.append((k, "deadline"))
        return self._order_due_locked(due)

    def _order_due_locked(self, due):
        """Under overload with a tenancy board, due keys flush in DRR
        order (weighted fair share) instead of dict insertion order."""
        if self.tenancy is None or len(due) < 2 or \
                self._rows_total <= self.policy.max_batch_rows:
            return due
        try:
            pairs = [(k, sum(r.n for r in self._pending.get(k, ())))
                     for k, _ in due]
            order = {k: i for i, k in
                     enumerate(self.tenancy.order_keys(pairs))}
            return sorted(due, key=lambda kw: order.get(kw[0], len(order)))
        except Exception as exc:
            note_static_fallback("tenancy", "drr-error", repr(exc))
            return due

    def _nearest_deadline(self) -> Optional[float]:
        if not self._may_deadline():
            return None
        now = time.monotonic()
        waits = []
        for k, reqs in self._pending.items():
            if not reqs:
                continue
            delay = self._delay_for(k)
            if delay is not None:
                waits.append(delay - (now - reqs[0].t_enqueue))
        if not waits:
            return None
        return max(1e-4, min(waits))

    # -------------------------------------------------- context manager ---
    def __enter__(self) -> "ServeQueue":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)
