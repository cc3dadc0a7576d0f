"""Per-region serving statistics (counterpart of ``repro/serve/stats.py``).

One :class:`ServeStats` per bundle path (the multiplexing key of the
serve queue).  Counters answer the capacity questions the paper's
Observation 2 raises — is the hardware actually fed? — for a *service*
rather than a single call:

  * queue depth (rows waiting right now),
  * batch occupancy (real rows / bucket rows — how much of each
    dispatched mega-batch was useful work vs padding),
  * request latency percentiles (enqueue -> future resolved),
  * achieved rows/s over dispatch busy time.

All mutation goes through the queue/batcher under this object's own
lock, so stats stay consistent when a dispatcher thread and caller
threads flush concurrently.  The pod counters (``pod_batches``,
``remote_rows``) keep the reference's snapshot layout; they stay 0 until
the cross-host serving path is ported.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Deque, Dict, Optional, Tuple

from repro_torch.obs import metrics as _m


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class ServeStats:
    """Counters for one serving key; thread-safe; cheap to snapshot."""

    #: EWMA weight for per-bucket batch-latency observations — high
    #: enough to track a drifting service time within a few batches,
    #: low enough that one noisy dispatch doesn't whipsaw the
    #: controller's deadline.
    BATCH_LATENCY_ALPHA = 0.25

    def __init__(self, key: str, latency_window: int = 2048):
        self.key = key
        self._lock = threading.Lock()
        self.latency_window = int(latency_window)
        # obs metric families, bound once per key (label resolution off
        # the hot path); mutation below publishes into these so a scrape
        # sees the same numbers snapshot() reports, across all queues
        self._m_rows_enq = _m.counter(
            "repro_serve_rows_enqueued_total",
            "rows submitted to the serve queue", ("key",))
        self._m_reqs_enq = _m.counter(
            "repro_serve_requests_enqueued_total",
            "requests submitted to the serve queue", ("key",))
        self._m_rows_done = _m.counter(
            "repro_serve_rows_completed_total",
            "rows served back to callers", ("key",))
        self._m_reqs_done = _m.counter(
            "repro_serve_requests_completed_total",
            "requests resolved successfully", ("key",))
        self._m_rows_failed = _m.counter(
            "repro_serve_rows_failed_total",
            "rows whose dispatch raised", ("key",))
        self._m_batches = _m.counter(
            "repro_serve_batches_total",
            "dispatched mega-batches by flush reason", ("key", "reason"))
        self._m_batches_failed = _m.counter(
            "repro_serve_batches_failed_total",
            "dispatches that raised", ("key",))
        self._m_padded = _m.counter(
            "repro_serve_padded_rows_total",
            "bucket rows that were padding, not work", ("key",))
        self._m_remote = _m.counter(
            "repro_serve_remote_rows_total",
            "rows served for other pod hosts in shared mega-batches",
            ("key",))
        self._m_depth_rows = _m.gauge(
            "repro_serve_queue_depth_rows",
            "rows waiting in the queue right now", ("key",))
        self._m_depth_reqs = _m.gauge(
            "repro_serve_queue_depth_requests",
            "requests waiting in the queue right now", ("key",))
        self._m_occupancy = _m.gauge(
            "repro_serve_batch_occupancy",
            "real rows / bucket rows over all dispatches", ("key",))
        self._m_batch_lat = _m.histogram(
            "repro_serve_batch_latency_seconds",
            "wall time of one dispatched mega-batch", ("key",))
        self._m_req_lat = _m.histogram(
            "repro_serve_request_latency_seconds",
            "enqueue -> future-resolved latency per request", ("key",))
        self.requests_enqueued = 0
        self.rows_enqueued = 0
        self.requests_completed = 0
        self.rows_completed = 0
        self.batches = 0
        self.batches_failed = 0
        self.requests_failed = 0
        self.rows_failed = 0
        self.bucket_rows = 0      # sum of dispatched (padded) batch sizes
        self.padded_rows = 0
        # pod-scale serving: batches this key co-served with other hosts,
        # and how many of those batches' real rows belonged to them.
        # Local counters stay local-only (rows_completed is what THIS
        # host's callers got back), so occupancy folds remote rows in —
        # a well-fed cross-host mega-batch must not read as padding.
        self.pod_batches = 0
        self.remote_rows = 0
        self.queue_depth_rows = 0
        self.queue_depth_requests = 0
        self.flush_reasons: Counter = Counter()
        self.busy_s = 0.0         # wall time spent inside dispatches
        self._lat: Deque[float] = deque(maxlen=latency_window)
        # (monotonic time, latency_s, ok) per resolved request — the SLO
        # monitor's windowed burn-rate input.  Failures land with NaN
        # latency (they never resolved, so they miss any latency target).
        self._events: Deque[Tuple[float, float, bool]] = deque(
            maxlen=max(4096, latency_window))
        # (monotonic time, rows) of recent submits: the adaptive flush
        # controller reads the observed arrival rate from this window
        self._arrivals: Deque[Tuple[float, int]] = deque(maxlen=256)
        # bucket -> [ewma_busy_s, n_batches]: measured wall time of one
        # dispatched batch per bucket size.  The adaptive flush
        # controller blends these back into its latency model (measured
        # wins once warm; the roofline prediction is the cold-start
        # prior).  Failed dispatches never land here — an exception path
        # timing says nothing about healthy service time.
        self._bucket_lat: Dict[int, list] = {}

    # ------------------------------------------------------------ hooks ---
    def on_enqueue(self, rows: int) -> None:
        with self._lock:
            self.requests_enqueued += 1
            self.rows_enqueued += rows
            self.queue_depth_rows += rows
            self.queue_depth_requests += 1
            self._arrivals.append((time.monotonic(), rows))
            depth_rows, depth_reqs = \
                self.queue_depth_rows, self.queue_depth_requests
        self._m_reqs_enq.inc(1, key=self.key)
        self._m_rows_enq.inc(rows, key=self.key)
        self._m_depth_rows.set(depth_rows, key=self.key)
        self._m_depth_reqs.set(depth_reqs, key=self.key)

    def on_failure(self, *, requests: int, rows: int, reason: str,
                   busy_s: float) -> None:
        """A dispatch failed: its requests left the queue unserved.

        Kept apart from the completed counters so rows/s and occupancy
        reflect only work the device actually served — a key failing every
        batch must look broken on a dashboard, not healthy.
        """
        now = time.monotonic()
        with self._lock:
            self.batches_failed += 1
            self.requests_failed += requests
            self.rows_failed += rows
            self.queue_depth_rows -= rows
            self.queue_depth_requests -= requests
            self.flush_reasons[reason] += 1
            self.busy_s += busy_s
            nan = float("nan")
            for _ in range(requests):
                self._events.append((now, nan, False))
            depth_rows, depth_reqs = \
                self.queue_depth_rows, self.queue_depth_requests
        self._m_batches_failed.inc(1, key=self.key)
        self._m_rows_failed.inc(rows, key=self.key)
        self._m_depth_rows.set(depth_rows, key=self.key)
        self._m_depth_reqs.set(depth_reqs, key=self.key)

    def on_batch(self, *, requests: int, rows: int, bucket: int,
                 reason: str, busy_s: float, latencies_s,
                 remote_rows: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.requests_completed += requests
            self.rows_completed += rows
            self.bucket_rows += bucket
            # remote hosts' real rows in a pod mega-batch are useful
            # work, not padding
            self.padded_rows += bucket - rows - remote_rows
            if reason == "pod" or remote_rows:
                self.pod_batches += 1
                self.remote_rows += remote_rows
            self.queue_depth_rows -= rows
            self.queue_depth_requests -= requests
            self.flush_reasons[reason] += 1
            self.busy_s += busy_s
            self._lat.extend(latencies_s)
            now = time.monotonic()
            for lat in latencies_s:
                self._events.append((now, float(lat), True))
            ewma = self._bucket_lat.get(bucket)
            if ewma is None:
                self._bucket_lat[bucket] = [float(busy_s), 1]
            elif ewma[1] == 1:
                # the first dispatch of a bucket pays its one-time costs
                # (kernel build, allocator growth); blending it in would
                # leave the EWMA orders of magnitude high for dozens of
                # batches, so the second observation replaces it outright
                ewma[0] = float(busy_s)
                ewma[1] = 2
            else:
                ewma[0] += self.BATCH_LATENCY_ALPHA * (busy_s - ewma[0])
                ewma[1] += 1
            occ = ((self.rows_completed + self.remote_rows)
                   / self.bucket_rows if self.bucket_rows else 0.0)
            depth_rows, depth_reqs = \
                self.queue_depth_rows, self.queue_depth_requests
        self._m_batches.inc(1, key=self.key, reason=reason)
        self._m_reqs_done.inc(requests, key=self.key)
        self._m_rows_done.inc(rows, key=self.key)
        self._m_padded.inc(max(0, bucket - rows - remote_rows), key=self.key)
        if remote_rows:
            self._m_remote.inc(remote_rows, key=self.key)
        self._m_occupancy.set(occ, key=self.key)
        self._m_depth_rows.set(depth_rows, key=self.key)
        self._m_depth_reqs.set(depth_reqs, key=self.key)
        self._m_batch_lat.observe(busy_s, key=self.key)
        for lat in latencies_s:
            self._m_req_lat.observe(lat, key=self.key)

    def batch_latency_s(self, bucket: int,
                        min_batches: int = 1) -> Optional[float]:
        """Measured EWMA wall time of one dispatched batch of ``bucket``
        rows, or None until at least ``min_batches`` batches of that
        bucket have completed (callers treat None as "cold: use the
        model prior")."""
        with self._lock:
            ewma = self._bucket_lat.get(int(bucket))
            if ewma is None or ewma[1] < min_batches:
                return None
            return ewma[0]

    def batch_latencies(self) -> Dict[int, Tuple[float, int]]:
        """Snapshot of every bucket's (ewma_s, n_batches)."""
        with self._lock:
            return {b: (e[0], e[1]) for b, e in self._bucket_lat.items()}

    def bucket_batches(self, bucket: int) -> int:
        """Completed-batch count for one bucket size — the drift
        re-sweep trigger reads this to decide a bucket is *sustained*
        (N real dispatches), not a one-off eager call."""
        with self._lock:
            ewma = self._bucket_lat.get(int(bucket))
            return 0 if ewma is None else int(ewma[1])

    def request_events(self, window_s: Optional[float] = None,
                       now: Optional[float] = None):
        """Recent per-request ``(t_monotonic, latency_s, ok)`` outcomes,
        oldest first — the SLO monitor's burn-rate input.  ``window_s``
        keeps only events newer than ``now - window_s``."""
        with self._lock:
            events = list(self._events)
        if window_s is None:
            return events
        cutoff = (time.monotonic() if now is None else now) - window_s
        return [e for e in events if e[0] >= cutoff]

    def arrival_rate_rows_s(self, now: float = None) -> float:
        """Observed submit rate (rows/s) over the recent arrival window.

        0.0 until at least two submits have landed — callers (the
        adaptive flush controller) treat that as "stats cold" and fall
        back to their static policy.  The rate decays naturally when a
        key goes quiet: the window's span stretches to ``now``.
        """
        with self._lock:
            return self._arrival_rate_locked(now)

    # --------------------------------------------------------- snapshot ---
    def snapshot(self) -> Dict:
        with self._lock:
            # copy only — sorting a full 2048-entry window under the
            # lock stalled every on_batch/on_enqueue racing a dashboard
            # poll; the sort happens on the snapshotter's own time below
            lat = list(self._lat)
            occ = ((self.rows_completed + self.remote_rows)
                   / self.bucket_rows if self.bucket_rows else 0.0)
            rows_per_s = (self.rows_completed / self.busy_s
                          if self.busy_s > 0 else 0.0)
            snap = {
                "key": self.key,
                "requests_enqueued": self.requests_enqueued,
                "rows_enqueued": self.rows_enqueued,
                "requests_completed": self.requests_completed,
                "rows_completed": self.rows_completed,
                "batches": self.batches,
                "batches_failed": self.batches_failed,
                "requests_failed": self.requests_failed,
                "rows_failed": self.rows_failed,
                "bucket_rows": self.bucket_rows,
                "padded_rows": self.padded_rows,
                "pod_batches": self.pod_batches,
                "remote_rows": self.remote_rows,
                "queue_depth_rows": self.queue_depth_rows,
                "queue_depth_requests": self.queue_depth_requests,
                "batch_occupancy": occ,
                "flush_reasons": dict(self.flush_reasons),
                "rows_per_s": rows_per_s,
                "arrival_rate_rows_s": self._arrival_rate_locked(),
                "batch_latency_ewma_ms": {
                    b: round(e[0] * 1e3, 4)
                    for b, e in sorted(self._bucket_lat.items())},
                "batch_latency_batches": {
                    b: e[1] for b, e in sorted(self._bucket_lat.items())},
            }
        lat.sort()
        snap["latency_p50_ms"] = _percentile(lat, 0.50) * 1e3
        snap["latency_p99_ms"] = _percentile(lat, 0.99) * 1e3
        return snap

    def _arrival_rate_locked(self, now: float = None) -> float:
        if len(self._arrivals) < 2:
            return 0.0
        span = (time.monotonic() if now is None else now) \
            - self._arrivals[0][0]
        if span <= 0:
            return 0.0
        # rows after the window's first submit, over the span since it:
        # the first submit opens the window, it doesn't fill it
        rows = sum(r for _, r in self._arrivals) - self._arrivals[0][1]
        return rows / span

    def __repr__(self):  # pragma: no cover - debugging aid
        s = self.snapshot()
        return (f"ServeStats({self.key!r}, depth={s['queue_depth_rows']}, "
                f"batches={s['batches']}, occ={s['batch_occupancy']:.2f}, "
                f"p50={s['latency_p50_ms']:.2f}ms, "
                f"rows/s={s['rows_per_s']:.0f})")
