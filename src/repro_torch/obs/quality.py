"""Online surrogate-quality monitoring: shadow scoring and drift alerts
(counterpart of ``repro/obs/quality.py``).

The paper's value claim is "speedup with minimal accuracy loss"; this
module makes the accuracy loss observable while serving.  A
:class:`ShadowScorer` samples a configurable fraction of requests
flowing through ``MLRegion`` infer paths (``REPRO_SHADOW_RATE``, default
off), replays the sampled rows through the region's accurate function on
a low-priority background thread, and publishes per-bundle error metrics
(RMSE, max-abs, relative-L2, in numpy float64) as EWMAs plus a
per-sample RMSE histogram in the process metrics registry.  Scoring
rides the request's trace id as a ``quality.shadow`` span.

Drift is judged by an :class:`AlertMachine` per bundle: OK → WARN →
CRITICAL against a per-bundle RMSE budget, with hysteresis (consecutive
breaches to escalate, consecutive clears plus a shrunken threshold to
de-escalate).  The same machine class drives the SLO burn-rate alerts
in :mod:`repro_torch.obs.slo`, and a CRITICAL state trips the bundle's
circuit breaker (:mod:`repro_torch.resilience.breaker`).

Budgets resolve through one chain: an explicit ``set_budget`` wins,
then the port's per-bundle registry :mod:`repro_torch.quant.budgets`
(the numbers the quant gate certifies int8 eligibility against), then
the default budget.

Import contract: stdlib + numpy + ``repro_torch.obs.{metrics,trace}`` +
``repro_torch.quant.budgets`` (stdlib-only).
"""
from __future__ import annotations

import math
import os
import queue as _queue
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import metrics as _metrics
from .trace import TRACER

ENV_SHADOW_RATE = "REPRO_SHADOW_RATE"
ENV_RMSE_BUDGET = "REPRO_SHADOW_RMSE_BUDGET"

OK = "OK"
WARN = "WARN"
CRITICAL = "CRITICAL"
#: alert severity order — exported as the numeric gauge value
LEVELS: Dict[str, int] = {OK: 0, WARN: 1, CRITICAL: 2}

#: per-sample RMSE histogram buckets: the paper's "as low as 0.01 RMSE"
#: regime sits mid-range, decades on either side for drift headroom
ERROR_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.5, 1.0, 10.0)


class AlertMachine:
    """Hysteretic OK → WARN → CRITICAL ladder.

    Escalation requires ``breach_n`` *consecutive* evaluations whose
    candidate level exceeds the current state; de-escalation requires
    ``clear_n`` consecutive evaluations below it, and a level already
    latched keeps its threshold shrunk by ``hysteresis`` — so a value
    oscillating right at the budget neither raises nor clears the alert
    on every sample.
    """

    def __init__(self, *, breach_n: int = 3, clear_n: int = 5,
                 hysteresis: float = 0.8):
        self.breach_n = int(breach_n)
        self.clear_n = int(clear_n)
        self.hysteresis = float(hysteresis)
        self.state = OK
        self.transitions = 0
        self._up = 0
        self._down = 0

    def _candidate(self, value: float,
                   warn_at: Optional[float],
                   crit_at: Optional[float]) -> str:
        cur = LEVELS[self.state]

        def eff(at: float, latched: bool) -> float:
            return at * self.hysteresis if latched else at

        if crit_at is not None and value >= eff(crit_at, cur >= 2):
            return CRITICAL
        if warn_at is not None and value >= eff(warn_at, cur >= 1):
            return WARN
        return OK

    def step(self, value: float, warn_at: Optional[float],
             crit_at: Optional[float]) -> str:
        """Feed one evaluation; returns the (possibly new) state."""
        if warn_at is None and crit_at is None:
            return self.state  # no budget -> no alerting
        cand = self._candidate(float(value), warn_at, crit_at)
        cur, new = LEVELS[self.state], LEVELS[cand]
        if new > cur:
            self._up += 1
            self._down = 0
            if self._up >= self.breach_n:
                self.state = cand
                self.transitions += 1
                self._up = 0
        elif new < cur:
            self._down += 1
            self._up = 0
            if self._down >= self.clear_n:
                self.state = cand
                self.transitions += 1
                self._down = 0
        else:
            self._up = self._down = 0
        return self.state


class _KeyState:
    __slots__ = ("rmse", "max_abs", "rel_l2", "samples", "rows", "machine")

    def __init__(self):
        self.rmse: Optional[float] = None
        self.max_abs: Optional[float] = None
        self.rel_l2: Optional[float] = None
        self.samples = 0
        self.rows = 0
        self.machine = AlertMachine()


class ShadowScorer:
    """Sampled online accuracy scoring against the accurate function.

    The serve path calls :meth:`sample` (one attribute read + one
    ``random.random`` when enabled; a single attribute check when not)
    and, on a hit, :meth:`submit` with two thunks: ``pred`` yields the
    surrogate's output rows (may block on a serve future), ``ref``
    recomputes the accurate output from a snapshot of the inputs.  Both
    run later on the scorer's single daemon worker — the accurate
    function's cost never lands on the serving path.  The backlog is
    bounded: when the worker falls behind, new samples are *dropped and
    counted* (``repro_quality_dropped_total{key,reason}``) rather than
    growing an unbounded queue.
    """

    EWMA_ALPHA = 0.25
    #: scoring a sample waits until it is at least this old — the replay
    #: runs after the serving burst that produced it, not during it, so
    #: the worker's GIL time does not contend with in-flight dispatches
    MIN_AGE_S = 0.05
    #: the worker sleeps after each sample to cap its CPU share at this
    #: fraction (scoring throughput degrades to counted backlog drops
    #: under sustained load, never to serve-path contention)
    DUTY_CYCLE = 0.5

    def __init__(self, rate: float = 0.0, max_backlog: int = 256):
        self.rate = float(rate)
        self.enabled = self.rate > 0.0
        self.max_backlog = int(max_backlog)
        self._lock = threading.Lock()
        self._q: "_queue.Queue[Optional[tuple]]" = _queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._pending = 0
        self._keys: Dict[str, _KeyState] = {}
        self._budgets: Dict[str, Tuple[float, float]] = {}
        self._default_budget: Optional[Tuple[float, float]] = None
        self._m_rmse = _metrics.gauge(
            "repro_quality_rmse",
            "shadow-scored RMSE EWMA per bundle", ("key",))
        self._m_max_abs = _metrics.gauge(
            "repro_quality_max_abs",
            "shadow-scored max-abs-error EWMA per bundle", ("key",))
        self._m_rel_l2 = _metrics.gauge(
            "repro_quality_rel_l2",
            "shadow-scored relative-L2 EWMA per bundle", ("key",))
        self._m_state = _metrics.gauge(
            "repro_quality_alert_state",
            "drift alert state per bundle (0=OK 1=WARN 2=CRITICAL)",
            ("key",))
        self._m_samples = _metrics.counter(
            "repro_quality_samples_total",
            "shadow samples scored", ("key", "region"))
        self._m_rows = _metrics.counter(
            "repro_quality_rows_total",
            "rows shadow-scored", ("key", "region"))
        self._m_dropped = _metrics.counter(
            "repro_quality_dropped_total",
            "shadow samples dropped before scoring", ("key", "reason"))
        self._m_rmse_hist = _metrics.histogram(
            "repro_quality_rmse_per_sample",
            "per-sample shadow RMSE", ("key",), buckets=ERROR_BUCKETS)
        self._m_score_s = _metrics.histogram(
            "repro_quality_shadow_seconds",
            "worker time scoring one shadow sample", ("key",))

    # ---------------------------------------------------------- control ---
    def enable(self, rate: Optional[float] = None) -> "ShadowScorer":
        if rate is not None:
            self.rate = float(rate)
        self.enabled = self.rate > 0.0
        return self

    def disable(self) -> None:
        self.enabled = False

    def set_budget(self, key: str, rmse_budget: float,
                   warn_ratio: float = 0.5) -> None:
        """RMSE past ``rmse_budget`` is CRITICAL (after hysteresis);
        past ``warn_ratio * rmse_budget`` is WARN."""
        b = (float(rmse_budget) * float(warn_ratio), float(rmse_budget))
        with self._lock:
            self._budgets[key] = b

    def set_default_budget(self, rmse_budget: Optional[float],
                           warn_ratio: float = 0.5) -> None:
        with self._lock:
            if rmse_budget is None:
                self._default_budget = None
            else:
                self._default_budget = (
                    float(rmse_budget) * float(warn_ratio),
                    float(rmse_budget))

    def reset(self) -> None:
        """Forget per-key scores, budgets, and alert states (tests)."""
        with self._lock:
            self._keys.clear()
            self._budgets.clear()
            self._default_budget = None

    def _budget_for_locked(self, key: str) -> Tuple:
        """(warn_at, crit_at) for a key: explicit ``set_budget`` wins,
        then the shared registry (:mod:`repro_torch.quant.budgets`, the
        quant gate's numbers), then the default budget."""
        b = self._budgets.get(key)
        if b is not None:
            return b
        from repro_torch.quant.budgets import budget_pair
        b = budget_pair(key)
        if b is not None:
            return b
        return self._default_budget or (None, None)

    # --------------------------------------------------------- sampling ---
    def sample(self) -> bool:
        """Bernoulli sampling decision for one request."""
        return self.enabled and random.random() < self.rate

    def submit(self, key: str, *, pred: Callable[[], np.ndarray],
               ref: Callable[[], np.ndarray], region: str = "-",
               rows: int = 1, trace: Optional[str] = None) -> bool:
        """Enqueue one sampled request for background scoring.

        Returns False (and counts a drop) when the backlog is full —
        shadow scoring degrades by skipping samples, never by stalling
        the caller.
        """
        with self._lock:
            if self._pending >= self.max_backlog:
                dropped = True
            else:
                dropped = False
                self._pending += 1
                self._ensure_thread_locked()
        if dropped:
            self._m_dropped.inc(1, key=key, reason="backlog")
            return False
        self._q.put((key, region, pred, ref, int(rows), trace,
                     time.monotonic()))
        return True

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="repro-shadow-score", daemon=True)
            self._thread.start()

    # ----------------------------------------------------------- worker ---
    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            key, region, pred, ref, rows, trace, t_sub = item
            # low priority, part 1: let the burst that sampled this
            # request finish serving before the replay takes any CPU
            age_left = self.MIN_AGE_S - (time.monotonic() - t_sub)
            if age_left > 0:
                time.sleep(age_left)
            t0 = time.monotonic()
            try:
                with TRACER.span("quality.shadow", cat="quality",
                                 trace=trace,
                                 args={"key": key, "region": region}):
                    yp = np.asarray(pred())
                    yr = np.asarray(ref())
                    if yp.size != yr.size:
                        self._m_dropped.inc(1, key=key, reason="shape")
                    else:
                        self._score(key, region, yp,
                                    yr.reshape(yp.shape), rows)
            except Exception as e:  # replay must never kill the worker
                self._m_dropped.inc(1, key=key, reason="error")
                _metrics.warn_once(
                    f"shadow-score-error:{key}",
                    f"shadow scoring failed for bundle {key!r}: {e!r}")
            finally:
                busy = time.monotonic() - t0
                with self._lock:
                    self._pending -= 1
                self._m_score_s.observe(busy, key=key)
                # low priority, part 2: duty-cycle cap — sleep in
                # proportion to the time just spent scoring so the
                # worker never takes more than DUTY_CYCLE of a core
                d = self.DUTY_CYCLE
                time.sleep(min(0.1, busy * (1.0 - d) / d))

    def _score(self, key: str, region: str, yp: np.ndarray,
               yr: np.ndarray, rows: int) -> None:
        d = yp.astype(np.float64) - yr.astype(np.float64)
        rmse = float(np.sqrt(np.mean(np.square(d)))) if d.size else 0.0
        max_abs = float(np.max(np.abs(d))) if d.size else 0.0
        denom = float(np.linalg.norm(yr.astype(np.float64).ravel()))
        rel_l2 = float(np.linalg.norm(d.ravel()) / max(denom, 1e-12))
        self.observe(key, rmse=rmse, max_abs=max_abs, rel_l2=rel_l2,
                     rows=rows, region=region)

    # ---------------------------------------------------------- scoring ---
    def observe(self, key: str, *, rmse: float, max_abs: float = 0.0,
                rel_l2: float = 0.0, rows: int = 1, region: str = "-"
                ) -> str:
        """Fold one scored sample into the EWMAs + alert machine.

        Public so benches and tests can inject scores without a worker
        round-trip; returns the (possibly new) alert state.
        """
        a = self.EWMA_ALPHA
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyState()
            for attr, v in (("rmse", rmse), ("max_abs", max_abs),
                            ("rel_l2", rel_l2)):
                cur = getattr(st, attr)
                v = float(v)
                setattr(st, attr, v if cur is None or math.isnan(cur)
                        else cur + a * (v - cur))
            st.samples += 1
            st.rows += int(rows)
            warn_at, crit_at = self._budget_for_locked(key)
            state = st.machine.step(st.rmse, warn_at, crit_at)
            vals = (st.rmse, st.max_abs, st.rel_l2)
        self._m_rmse.set(vals[0], key=key)
        self._m_max_abs.set(vals[1], key=key)
        self._m_rel_l2.set(vals[2], key=key)
        self._m_state.set(LEVELS[state], key=key)
        self._m_samples.inc(1, key=key, region=region)
        self._m_rows.inc(rows, key=key, region=region)
        self._m_rmse_hist.observe(rmse, key=key)
        return state

    # ------------------------------------------------------------ export ---
    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until every submitted sample has been scored."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.002)
        return False

    def stop(self) -> None:
        """Stop the worker thread (tests; restarts lazily on submit)."""
        t = self._thread
        if t is not None and t.is_alive():
            self._q.put(None)
            t.join(timeout=5.0)
        self._thread = None

    def close(self, drain: bool = True, *, timeout: float = 30.0) -> None:
        """Orderly shutdown (``ServeQueue.close`` calls this last).

        Disables sampling so no new replays enqueue, optionally drains
        the backlog (``drain=True`` waits up to ``timeout``), then stops
        the worker — interpreter teardown can no longer race a
        mid-replay scorer.  The worker restarts lazily if the scorer is
        re-enabled and submitted to afterwards (tests reuse the
        singleton), so close is safe to call more than once.
        """
        self.disable()
        if drain:
            self.flush(timeout)
        self.stop()

    def state(self, key: str) -> str:
        with self._lock:
            st = self._keys.get(key)
            return st.machine.state if st is not None else OK

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {k: st.machine.state for k, st in self._keys.items()}

    def worst_state(self) -> str:
        states = self.states().values()
        worst = max((LEVELS[s] for s in states), default=0)
        return next(name for name, lv in LEVELS.items() if lv == worst)

    def snapshot(self) -> dict:
        """JSON-able quality state."""
        with self._lock:
            keys = {
                k: {"rmse_ewma": st.rmse, "max_abs_ewma": st.max_abs,
                    "rel_l2_ewma": st.rel_l2, "samples": st.samples,
                    "rows": st.rows, "state": st.machine.state,
                    "transitions": st.machine.transitions,
                    "budget_rmse": self._budget_for_locked(k)[1]}
                for k, st in self._keys.items()}
            rate = self.rate if self.enabled else 0.0
        return {"enabled": self.enabled, "rate": rate, "keys": keys}


#: process-wide scorer: what MLRegion consults (mirrors obs.TRACER)
SHADOW = ShadowScorer(
    rate=float(os.environ.get(ENV_SHADOW_RATE, "0") or 0.0))
if os.environ.get(ENV_RMSE_BUDGET, ""):
    SHADOW.set_default_budget(float(os.environ[ENV_RMSE_BUDGET]))


def get_shadow() -> ShadowScorer:
    return SHADOW
