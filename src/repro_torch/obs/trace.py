"""Low-overhead tracing for the serving pipeline (counterpart of
``repro/obs/trace.py``).

A :class:`Tracer` records :class:`Span`\\ s (named, categorized time
intervals, optionally tagged with a *trace id*) into **per-thread ring
buffers**: recording a span is an append to the current thread's own
``deque``, with no lock on the hot path; the tracer's lock is taken only
when a thread records its first span (ring registration) and when
someone exports.  Disabled (the default), every entry point is a single
attribute check returning a shared no-op context.

Trace ids are minted by :meth:`Tracer.new_trace_id` at
``ServeQueue.submit`` and ride the request object through coalescing,
dispatch and scatter: spans recorded from the submitter thread and the
dispatcher thread carry the same id, so a request's end-to-end latency
decomposes after the fact (queued, gathered, applied, landed,
scattered).

Export is Chrome ``trace_event`` JSON (:meth:`export_chrome_trace`);
open it at ``chrome://tracing`` or https://ui.perfetto.dev.  Timestamps
are recorded with ``time.monotonic()`` (the clock every serve-path
latency uses) and shifted to the wall clock at export, so traces from
different processes on one machine merge on a shared timeline.

``annotate=True`` also opens an NVTX range for every span
(``torch.cuda.nvtx.range_push``/``range_pop``), where the reference
enters a ``jax.profiler.TraceAnnotation``: the spans then line up with
the kernels in an Nsight Systems or ``torch.profiler`` capture.  The
ranges open only when a CUDA device is present; on the CPU the same code
records the same spans with no ranges.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

ENV_TRACE = "REPRO_TRACE"
ENV_ANNOTATE = "REPRO_TRACE_ANNOTATE"


class Span:
    """One recorded interval (``t1 == t0`` marks an instant event)."""

    __slots__ = ("name", "cat", "t0", "t1", "trace", "args", "tid", "thread")

    def __init__(self, name, cat, t0, t1, trace, args, tid, thread):
        self.name, self.cat = name, cat
        self.t0, self.t1 = t0, t1
        self.trace, self.args = trace, args
        self.tid, self.thread = tid, thread

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "t0": self.t0,
                "t1": self.t1, "trace": self.trace, "args": self.args,
                "tid": self.tid, "thread": self.thread}

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.dur_s * 1e3:.3f}ms, "
                f"trace={self.trace!r})")


class _NullSpan:
    """Shared no-op context: what ``span()`` returns while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _nvtx():
    """``torch.cuda.nvtx`` when a CUDA device is present, else None (the
    CPU runs record spans without ranges).  Imported here, not at module
    import: the tracer itself is framework-free."""
    try:
        import torch
    except ImportError:
        return None
    return torch.cuda.nvtx if torch.cuda.is_available() else None


class _LiveSpan:
    __slots__ = ("_tracer", "name", "cat", "trace", "args", "_t0", "_ann")

    def __init__(self, tracer, name, cat, trace, args):
        self._tracer = tracer
        self.name, self.cat = name, cat
        self.trace, self.args = trace, args
        self._ann = None

    def __enter__(self):
        if self._tracer.annotate:
            self._ann = _nvtx()
            if self._ann is not None:
                self._ann.range_push(self.name)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        if self._ann is not None:
            self._ann.range_pop()
        self._tracer.rec(self.name, self.cat, self._t0, t1,
                         self.trace, self.args)
        return False


class Tracer:
    """Per-thread ring-buffer event log with Chrome-trace export."""

    def __init__(self, ring_size: int = 8192, annotate: bool = False):
        self.ring_size = ring_size
        self.enabled = False
        self.annotate = annotate
        # monotonic -> wall offset, fixed at construction: export shifts
        # every timestamp by this so per-process traces share a timeline
        self.epoch = time.time() - time.monotonic()
        self._tls = threading.local()
        # (thread_name, tid, deque, drops) — drops is a 2-slot mutable
        # counter: [entries evicted on wrap, evictions already published]
        self._rings: List[tuple] = []
        self._reg_lock = threading.Lock()
        self._seq = itertools.count()
        self._pid_prefix = f"{os.getpid():x}."

    # ---------------------------------------------------------- control ---
    def enable(self, annotate: Optional[bool] = None) -> "Tracer":
        if annotate is not None:
            self.annotate = annotate
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop recorded spans (drop *counters* survive: they are
        cumulative eviction totals, not ring contents)."""
        with self._reg_lock:
            for _, _, ring, _ in self._rings:
                ring.clear()

    # -------------------------------------------------------- recording ---
    def new_trace_id(self) -> str:
        """Mint a process-unique request trace id (pid-prefixed so ids
        from different processes never collide in a merged trace)."""
        return self._pid_prefix + str(next(self._seq))

    def _ring(self) -> tuple:
        """This thread's ``(ring, tid, thread_name, drops)`` — thread
        identity is resolved once at ring registration, not per span
        record."""
        state = getattr(self._tls, "state", None)
        if state is None:
            t = threading.current_thread()
            ring = deque(maxlen=self.ring_size)
            drops = [0, 0]
            state = self._tls.state = (ring, t.ident or 0, t.name, drops)
            with self._reg_lock:
                self._rings.append((t.name, t.ident or 0, ring, drops))
        return state

    def record(self, name: str, t0: float, t1: float, *, cat: str = "serve",
               trace: Optional[str] = None, args: Optional[dict] = None
               ) -> None:
        """Record a span with explicit ``time.monotonic()`` endpoints.

        This is how spans for *past* intervals land (e.g.
        ``serve.request``: the dispatcher stamps the span from the
        request's own ``t_enqueue``, covering queued time it never saw).
        """
        if not self.enabled:
            return
        self.rec(name, cat, t0, t1, trace, args)

    def rec(self, name: str, cat: str, t0: float, t1: float,
            trace: Optional[str], args: Optional[dict]) -> None:
        """Positional fast path of :meth:`record` for per-request serve
        loops (no kwargs packing).  Callers must have checked ``enabled``
        or accept the dead append; ``args`` dicts may be shared across
        records — export copies before mutating."""
        # ring entries are plain tuples: building Span objects is deferred
        # to export so the hot path pays one tuple + one deque append
        ring, tid, tname, drops = self._ring()
        if len(ring) == ring.maxlen:
            drops[0] += 1  # the append below evicts the oldest entry
        ring.append((name, cat, t0, t1, trace, args, tid, tname))

    def instant(self, name: str, *, cat: str = "serve",
                trace: Optional[str] = None, args: Optional[dict] = None
                ) -> None:
        if not self.enabled:
            return
        t = time.monotonic()
        self.record(name, t, t, cat=cat, trace=trace, args=args)

    def span(self, name: str, *, cat: str = "serve",
             trace: Optional[str] = None, args: Optional[dict] = None):
        """Context manager timing its body (no-op unless enabled)."""
        if not self.enabled:
            return _NULL
        return _LiveSpan(self, name, cat, trace, args)

    # ----------------------------------------------------------- export ---
    def drop_counts(self) -> Dict[str, int]:
        """Per-thread-name totals of ring entries evicted on wrap.

        A nonzero count means the exported trace is missing its oldest
        spans for that thread — before this existed the truncation was
        silent and a short-looking trace read as a short run."""
        out: Dict[str, int] = {}
        with self._reg_lock:
            for name, _, _, drops in self._rings:
                out[name] = out.get(name, 0) + drops[0]
        return out

    def publish_drop_counts(self) -> int:
        """Fold eviction counts into ``repro_trace_dropped_total{thread}``
        (delta since last publish; called from every export path so a
        scrape or snapshot always reflects current truncation)."""
        from . import metrics as _metrics
        c = _metrics.counter("repro_trace_dropped_total",
                             "trace ring entries evicted on wrap",
                             ("thread",))
        with self._reg_lock:
            rings = list(self._rings)
        published = 0
        for name, _, _, drops in rings:
            delta = drops[0] - drops[1]
            if delta > 0:
                drops[1] = drops[0]
                c.inc(delta, thread=name)
                published += delta
        return published

    def events(self) -> List[Span]:
        """Snapshot every thread's ring, oldest-first per thread."""
        self.publish_drop_counts()
        with self._reg_lock:
            rings = [(name, tid, list(ring)) for name, tid, ring, _
                     in self._rings]
        out: List[Span] = []
        for _, _, entries in rings:
            out.extend(Span(*e) for e in entries)
        return out

    def chrome_events(self, spans: Optional[List[Span]] = None,
                      pid: Optional[int] = None) -> List[dict]:
        """Spans as Chrome ``trace_event`` dicts (ts/dur in wall-clock
        microseconds)."""
        pid = os.getpid() if pid is None else pid
        out = []
        for s in (self.events() if spans is None else spans):
            args = dict(s.args) if s.args else {}
            if s.trace is not None:
                args["trace"] = s.trace
            ev = {"name": s.name, "cat": s.cat, "pid": pid, "tid": s.tid,
                  "ts": (s.t0 + self.epoch) * 1e6, "args": args}
            if s.t1 > s.t0:
                ev["ph"] = "X"
                ev["dur"] = (s.t1 - s.t0) * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            out.append(ev)
        out.sort(key=lambda e: e["ts"])
        return out

    def export_chrome_trace(self, path=None) -> List[dict]:
        """Dump all recorded spans as Chrome trace JSON; returns the
        event list (and writes ``{"traceEvents": [...]}`` to ``path``)."""
        events = self.chrome_events()
        if path is not None:
            import pathlib
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(
                {"traceEvents": events, "displayTimeUnit": "ms"}))
        return events


# process-wide default tracer: what the serve path consults
TRACER = Tracer()
if os.environ.get(ENV_TRACE, "") not in ("", "0"):
    TRACER.enable(annotate=os.environ.get(ENV_ANNOTATE, "")
                  not in ("", "0"))


def get_tracer() -> Tracer:
    return TRACER


def enable_tracing(ring_size: Optional[int] = None,
                   annotate: Optional[bool] = None) -> Tracer:
    if ring_size is not None:
        TRACER.ring_size = ring_size
    return TRACER.enable(annotate=annotate)


def disable_tracing() -> None:
    TRACER.disable()


def tracing_enabled() -> bool:
    return TRACER.enabled


def export_chrome_trace(path=None) -> List[dict]:
    return TRACER.export_chrome_trace(path)


def merge_chrome_traces(event_lists: List[List[dict]], path=None
                        ) -> List[dict]:
    """Merge per-process Chrome event lists onto one timeline.

    Events already carry wall-clock timestamps and per-process ``pid``
    fields, so the merge is a sort; ``path`` writes the merged artifact.
    """
    merged: List[dict] = []
    for evs in event_lists:
        merged.extend(evs or [])
    merged.sort(key=lambda e: e.get("ts", 0.0))
    if path is not None:
        import pathlib
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(
            {"traceEvents": merged, "displayTimeUnit": "ms"}))
    return merged


# ------------------------------------------------------- trace analysis ----
def request_coverage(events: List[dict]) -> Dict[str, dict]:
    """Per-trace-id span coverage of the measured enqueue→resolve window.

    For every trace id, the window is [earliest span start, latest span
    end] and coverage is the union of its spans' intervals over that
    window — 1.0 means no unaccounted gap anywhere between a request
    entering ``submit`` and its future resolving.
    """
    per: Dict[str, List[tuple]] = {}
    for ev in events:
        trace = (ev.get("args") or {}).get("trace")
        if trace is None or ev.get("ph") != "X":
            continue
        t0 = ev["ts"]
        per.setdefault(trace, []).append((t0, t0 + ev.get("dur", 0.0)))
    out: Dict[str, dict] = {}
    for trace, ivals in per.items():
        ivals.sort()
        lo, hi = ivals[0][0], max(b for _, b in ivals)
        covered, cur_a, cur_b = 0.0, ivals[0][0], ivals[0][1]
        for a, b in ivals[1:]:
            if a > cur_b:
                covered += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        covered += cur_b - cur_a
        window = hi - lo
        out[trace] = {"window_us": window, "covered_us": covered,
                      "coverage": covered / window if window > 0 else 1.0,
                      "spans": len(ivals)}
    return out
