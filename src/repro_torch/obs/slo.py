"""Serving SLOs: multi-window burn-rate tracking over ``ServeStats``
(counterpart of ``repro/obs/slo.py``).

An :class:`SLO` declares per-key objectives — a latency target ("99% of
requests resolve within ``latency_threshold_s``") and an availability
target ("99.9% of requests succeed") — and :class:`SLOMonitor`
evaluates them the way production alerting does: **burn rate** per
window, ``error_rate / (1 - target)``, computed over two windows (short
+ long).  Burn 1.0 consumes the error budget exactly at the sustainable
pace; the monitor feeds the *minimum* across windows into an
:class:`~repro_torch.obs.quality.AlertMachine`, so an alert requires the
budget to be burning in the short window (it's happening *now*) **and**
the long window (it's not a blip) — the standard multi-window guard
against both flappy and stale alerts.

Evaluation reads ``ServeStats.request_events()`` (a timestamped ring of
per-request ``(t, latency, ok)`` outcomes that the dispatcher already
records); windows with fewer than ``min_events`` events contribute burn
0, so a key that goes quiet heals rather than alerting on stale data.

Gauges: ``repro_slo_burn_rate{key,slo,window}``,
``repro_slo_alert_state{key,slo}``,
``repro_slo_budget_remaining{key,slo}`` (long window).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

from . import metrics as _metrics
from .quality import LEVELS, AlertMachine


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-key serving objectives (thresholds are per *request*)."""

    latency_threshold_s: float = 0.25
    latency_target: float = 0.99
    availability_target: float = 0.999
    windows_s: Tuple[float, float] = (60.0, 600.0)
    warn_burn: float = 1.0
    crit_burn: float = 6.0
    min_events: int = 20

    def objectives(self) -> Dict[str, float]:
        return {"latency": self.latency_target,
                "availability": self.availability_target}


class _Tracked:
    __slots__ = ("slo", "stats", "machines", "last")

    def __init__(self, slo: SLO, stats):
        self.slo = slo
        self.stats = stats
        self.machines = {name: AlertMachine(breach_n=2, clear_n=3)
                         for name in slo.objectives()}
        self.last: dict = {}


class SLOMonitor:
    """Evaluates tracked keys' SLOs; optionally on a background ticker.

    ``evaluate(now=...)`` is deterministic for tests; :meth:`start`
    evaluates on a background ticker.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._tracked: Dict[str, _Tracked] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._m_burn = _metrics.gauge(
            "repro_slo_burn_rate",
            "error-budget burn rate per key/objective/window",
            ("key", "slo", "window"))
        self._m_state = _metrics.gauge(
            "repro_slo_alert_state",
            "SLO alert state per key/objective (0=OK 1=WARN 2=CRITICAL)",
            ("key", "slo"))
        self._m_budget = _metrics.gauge(
            "repro_slo_budget_remaining",
            "fraction of the long-window error budget left",
            ("key", "slo"))
        self._m_events = _metrics.gauge(
            "repro_slo_window_events",
            "request outcomes observed in the long window", ("key",))

    # --------------------------------------------------------- tracking ---
    def track(self, key: str, stats, slo: Optional[SLO] = None) -> SLO:
        """Watch ``stats`` (a ``ServeStats``) against ``slo``."""
        slo = slo or SLO()
        with self._lock:
            self._tracked[key] = _Tracked(slo, stats)
        return slo

    def untrack(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._tracked.clear()
            else:
                self._tracked.pop(key, None)

    def tracked_keys(self):
        with self._lock:
            return sorted(self._tracked)

    # ------------------------------------------------------- evaluation ---
    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """One evaluation pass over every tracked key.

        Returns (and caches) per-key, per-objective burn rates and alert
        states; publishes the gauges.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            tracked = dict(self._tracked)
        results: Dict[str, dict] = {}
        for key, tr in tracked.items():
            slo = tr.slo
            long_w = max(slo.windows_s)
            events = tr.stats.request_events(window_s=long_w, now=now)
            self._m_events.set(len(events), key=key)
            per_obj: Dict[str, dict] = {}
            for obj, target in slo.objectives().items():
                budget = max(1.0 - target, 1e-9)
                burns: Dict[str, float] = {}
                counts: Dict[str, int] = {}
                err_long = 0.0
                for w in slo.windows_s:
                    evs = [e for e in events if e[0] >= now - w]
                    n = len(evs)
                    if obj == "latency":
                        # failures count against latency too: a request
                        # that never resolved did not resolve in time
                        bad = sum(1 for _, lat, ok in evs
                                  if not ok or
                                  not (lat <= slo.latency_threshold_s))
                    else:
                        bad = sum(1 for _, _, ok in evs if not ok)
                    err = bad / n if n else 0.0
                    wname = f"{w:g}s"
                    counts[wname] = n
                    burns[wname] = (err / budget
                                    if n >= slo.min_events else 0.0)
                    if w == long_w:
                        err_long = err
                # both windows must burn: feed the minimum
                value = min(burns.values()) if burns else 0.0
                state = tr.machines[obj].step(
                    value, slo.warn_burn, slo.crit_burn)
                remaining = max(0.0, 1.0 - err_long / budget)
                per_obj[obj] = {"burn": burns, "events": counts,
                                "state": state, "value": value,
                                "budget_remaining": remaining}
                for wname, b in burns.items():
                    self._m_burn.set(b, key=key, slo=obj, window=wname)
                self._m_state.set(LEVELS[state], key=key, slo=obj)
                self._m_budget.set(remaining, key=key, slo=obj)
            tr.last = per_obj
            results[key] = per_obj
        return results

    # ------------------------------------------------------------ export ---
    def states(self) -> Dict[str, Dict[str, str]]:
        """Last-evaluated alert state per key/objective (no re-eval)."""
        with self._lock:
            return {k: {obj: m.state for obj, m in tr.machines.items()}
                    for k, tr in self._tracked.items()}

    def worst_state(self) -> str:
        worst = 0
        for states in self.states().values():
            for s in states.values():
                worst = max(worst, LEVELS[s])
        return next(name for name, lv in LEVELS.items() if lv == worst)

    def snapshot(self) -> dict:
        """JSON-able SLO state."""
        with self._lock:
            keys = {}
            for k, tr in self._tracked.items():
                keys[k] = {"slo": dataclasses.asdict(tr.slo),
                           "objectives": tr.last or {
                               obj: {"state": m.state}
                               for obj, m in tr.machines.items()}}
        return {"keys": keys}

    # ------------------------------------------------------------ ticker ---
    def start(self, interval_s: float = 5.0) -> "SLOMonitor":
        """Evaluate periodically on a daemon thread (long-running
        servers)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _tick():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception as e:  # pragma: no cover - defensive
                    _metrics.warn_once("slo-eval-error",
                                       f"SLO evaluation failed: {e!r}")

        self._thread = threading.Thread(
            target=_tick, name="repro-slo-eval", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._thread = None


#: process-wide monitor (mirrors obs.TRACER / quality.SHADOW)
MONITOR = SLOMonitor()


def get_monitor() -> SLOMonitor:
    return MONITOR
