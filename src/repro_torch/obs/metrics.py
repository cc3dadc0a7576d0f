"""Process-wide metrics registry with Prometheus text export (counterpart
of ``repro/obs/metrics.py``, trimmed to what the port uses so far).

Counters, gauges and explicit-bucket histograms, each labeled.  Metrics
are always on: a handful of dict updates per batch, not per row.
``MetricsRegistry.dump()`` renders the Prometheus text exposition format.

Framework-free.  ``warn_once``/``note_static_fallback``, the tracer, the
shadow scorer, SLOs and the endpoint wait for the rest of ``obs/``.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

#: serve-path batch/request latency buckets (seconds), roughly 2.5x apart
DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5)


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    """Prometheus sample-value rendering: ``NaN`` / ``+Inf`` / ``-Inf``
    for non-finite values (``%g`` would emit ``nan``/``inf``)."""
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


_REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def dump() -> str:
    return _REGISTRY.dump()
