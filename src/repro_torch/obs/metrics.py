"""Process-wide metrics registry with Prometheus text export (counterpart
of ``repro/obs/metrics.py``).

Counters, gauges and explicit-bucket histograms, each labeled (the
serve path labels by queue key, the kernel registry by kernel name and
params provenance).  Metrics are always on: a handful of dict updates
per batch, not per row, and the serving stack's health must be
observable without anyone having remembered to flip a flag.

``MetricsRegistry.dump()`` renders the Prometheus text exposition format;
``collect()`` returns the same data as JSON-able dicts.

:func:`warn_once` is the degradation-visibility helper: the first time a
tag fires it logs a ``logging`` warning (logger ``repro_torch.obs``), and
every occurrence counts in ``repro_obs_warnings_total``.  The queue's
``controller=`` hook reports a failed controller through
:func:`note_static_fallback`.

Framework-free: stdlib only.
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

LOG = logging.getLogger("repro_torch.obs")

#: serve-path batch/request latency buckets (seconds): microseconds to
#: seconds, roughly 2.5x apart
DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5)


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    """Prometheus sample-value rendering: the exposition format spells
    non-finite values ``NaN`` / ``+Inf`` / ``-Inf`` (``%g`` would emit
    ``nan``/``inf``, which real scrapers reject)."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:g}"


def _label_str(names: Sequence[str], values: Tuple[str, ...],
               extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._vals: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def collect(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                    for k, v in sorted(self._vals.items())]

    def dump_lines(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for k, v in sorted(self._vals.items()):
                out.append(f"{self.name}{_label_str(self.labelnames, k)} "
                           f"{_fmt_value(v)}")
        return out


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._vals.get(self._key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._vals[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._vals.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Explicit-bucket histogram: per-labelset cumulative bucket counts
    plus sum and count (the Prometheus histogram contract)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        value = float(value)
        with self._lock:
            st = self._vals.get(k)
            if st is None:
                st = self._vals[k] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0,
                    "count": 0}
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["counts"][i] += 1
            st["sum"] += value
            st["count"] += 1

    def snapshot(self, **labels) -> Optional[dict]:
        with self._lock:
            st = self._vals.get(self._key(labels))
            if st is None:
                return None
            return {"buckets": dict(zip(self.buckets, st["counts"])),
                    "sum": st["sum"], "count": st["count"]}

    def collect(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(zip(self.labelnames, k)),
                     "buckets": dict(zip(self.buckets, st["counts"])),
                     "sum": st["sum"], "count": st["count"]}
                    for k, st in sorted(self._vals.items())]

    def dump_lines(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for k, st in sorted(self._vals.items()):
                for b, c in zip(self.buckets, st["counts"]):
                    le = 'le="%g"' % b
                    out.append(
                        f"{self.name}_bucket"
                        f"{_label_str(self.labelnames, k, le)} {c}")
                inf = 'le="+Inf"'
                out.append(f"{self.name}_bucket"
                           f"{_label_str(self.labelnames, k, inf)}"
                           f" {st['count']}")
                out.append(f"{self.name}_sum"
                           f"{_label_str(self.labelnames, k)} "
                           f"{_fmt_value(st['sum'])}")
                out.append(f"{self.name}_count"
                           f"{_label_str(self.labelnames, k)} "
                           f"{st['count']}")
        return out


class MetricsRegistry:
    """Get-or-create metric families; one registry per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-registered as {cls.__name__}"
                f"{tuple(labelnames)} but exists as "
                f"{type(m).__name__}{m.labelnames}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def dump(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.dump_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def collect(self) -> Dict[str, dict]:
        """JSON-able snapshot of every family."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: {"type": m.kind, "help": m.help,
                       "values": m.collect()}
                for name, m in sorted(metrics.items())}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name, help="", labelnames=()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(),
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def dump() -> str:
    return _REGISTRY.dump()


# ------------------------------------------------------------- warn-once ---
_WARNED: set = set()
_WARN_LOCK = threading.Lock()


def warn_once(tag: str, message: str) -> None:
    """Log ``message`` the first time ``tag`` fires; count every firing.

    The counter (``repro_obs_warnings_total{tag}``) keeps degradations
    visible on a scrape even after the one log line scrolled away.
    """
    counter("repro_obs_warnings_total",
            "warn_once firings by tag", ("tag",)).inc(1, tag=tag)
    with _WARN_LOCK:
        if tag in _WARNED:
            return
        _WARNED.add(tag)
    LOG.warning(message)


def note_static_fallback(key: str, reason: str, detail: str = "") -> None:
    """An adaptive controller degraded to the static flush policy for
    ``key``.  Counted per occurrence, logged once per (key, reason) —
    before this existed the degradation was silent and undiagnosable."""
    counter("repro_controller_static_fallback_total",
            "adaptive-controller decisions degraded to the static policy",
            ("key", "reason")).inc(1, key=key, reason=reason)
    warn_once(f"static-fallback:{reason}:{key}",
              f"AdaptiveFlushController fell back to the static flush "
              f"policy for key {key!r} ({reason})"
              + (f": {detail}" if detail else ""))
