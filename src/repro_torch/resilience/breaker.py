"""Per-bundle circuit breakers with accurate-path fallback routing
(counterpart of ``repro/resilience/breaker.py``).

A :class:`CircuitBreaker` guards one surrogate bundle key and decides
whether traffic may use the surrogate (``allow()``) based on a dispatch
failure-rate EWMA *and* the shadow-quality alert state
(:mod:`repro_torch.obs.quality`):

::

    CLOSED ──(EWMA >= threshold, >= min_samples) or quality CRITICAL──► OPEN
    OPEN   ──cooldown elapsed──► HALF_OPEN (probe trickle)
    HALF_OPEN ──probe failure or quality still CRITICAL──► OPEN (re-stamped)
    HALF_OPEN ──probe_n consecutive probe successes──► CLOSED (EWMA reset)

While OPEN, ``MLRegion`` routes through its accurate function instead of
raising or serving junk — the predicated-region contract turned into a
safety valve.  HALF_OPEN admits every ``probe_every``-th request as a
probe so recovery is detected without re-exposing the full traffic.

Anti-flap hysteresis: closing from HALF_OPEN zeroes the EWMA *and* the
sample count, so a re-trip needs ``min_samples`` fresh failures — the
breaker cannot oscillate CLOSED↔OPEN on a single borderline observation
(property-tested in ``tests/test_torch_resilience.py``).

The process-wide :data:`BREAKERS` board is enabled by default; set
``REPRO_BREAKER=0`` to disable (every ``allow`` returns True and
recording is a no-op).  This module imports only ``repro_torch.obs``:
the serve layer imports *us*, never the reverse.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import os

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.quality import CRITICAL, SHADOW

ENV_BREAKER = "REPRO_BREAKER"

CLOSED, OPEN, HALF_OPEN = "CLOSED", "OPEN", "HALF_OPEN"
_STATE_NUM = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

_STATE_G = _metrics.gauge(
    "repro_resilience_breaker_state",
    "circuit breaker state per bundle (0=CLOSED 1=OPEN 2=HALF_OPEN)",
    ("key",))
_TRANSITIONS = _metrics.counter(
    "repro_resilience_breaker_transitions_total",
    "breaker state transitions", ("key", "to"))
_FALLBACK = _metrics.counter(
    "repro_resilience_fallback_total",
    "requests routed to the accurate path by the breaker",
    ("key", "path"))


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Tunables for one breaker."""

    failure_threshold: float = 0.5   # EWMA failure rate that trips CLOSED
    ewma_alpha: float = 0.3          # weight of the newest observation
    min_samples: int = 4             # observations before the EWMA counts
    open_cooldown_s: float = 1.0     # OPEN dwell before probing
    probe_n: int = 3                 # consecutive probe successes to close
    probe_every: int = 4             # HALF_OPEN admits every k-th request


class CircuitBreaker:
    """One bundle's CLOSED→OPEN→HALF_OPEN state machine.  Thread-safe;
    the clock is injectable so tests can drive transitions without
    sleeping."""

    def __init__(self, key: str, policy: Optional[BreakerPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.key = key
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._ewma = 0.0
        self._samples = 0
        self._opened_at = 0.0
        self._probe_ok = 0
        self._probe_seq = 0
        _STATE_G.set(0, key=key)

    # -- state plumbing ----------------------------------------------------
    def _set_state(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        _STATE_G.set(_STATE_NUM[to], key=self.key)
        _TRANSITIONS.inc(1, key=self.key, to=to)
        if to == OPEN:
            self._opened_at = self._clock()
            self._probe_ok = 0
            self._probe_seq = 0
        elif to == CLOSED:
            # hysteresis: a re-trip needs min_samples fresh observations
            self._ewma = 0.0
            self._samples = 0

    def _quality_critical(self) -> bool:
        try:
            return SHADOW.state(self.key) == CRITICAL
        except Exception:
            return False

    # -- public API --------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May this request use the surrogate right now?  May transition
        CLOSED→OPEN (quality latch) or OPEN→HALF_OPEN (cooldown)."""
        with self._lock:
            if self._state == CLOSED:
                if self._quality_critical():
                    self._set_state(OPEN)
                    return False
                return True
            if self._state == OPEN:
                if (self._clock() - self._opened_at
                        >= self.policy.open_cooldown_s):
                    self._set_state(HALF_OPEN)
                    self._probe_seq = 1
                    return True  # first probe
                return False
            # HALF_OPEN: admit every probe_every-th request as a probe
            self._probe_seq += 1
            return (self._probe_seq - 1) % max(1, self.policy.probe_every) == 0

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_ok += 1
                if (self._probe_ok >= self.policy.probe_n
                        and not self._quality_critical()):
                    self._set_state(CLOSED)
                return
            self._samples += 1
            a = self.policy.ewma_alpha
            self._ewma = (1.0 - a) * self._ewma

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._set_state(OPEN)  # probe failed: re-open, re-stamp
                return
            self._samples += 1
            a = self.policy.ewma_alpha
            self._ewma = (1.0 - a) * self._ewma + a
            if (self._state == CLOSED
                    and self._samples >= self.policy.min_samples
                    and self._ewma >= self.policy.failure_threshold):
                self._set_state(OPEN)

    def snapshot(self) -> dict:
        with self._lock:
            return {"key": self.key, "state": self._state,
                    "ewma": round(self._ewma, 4),
                    "samples": self._samples,
                    "probe_ok": self._probe_ok}


class BreakerBoard:
    """Lazy per-key breakers.  Disabled (``REPRO_BREAKER=0``) every call
    is a no-op and ``allow`` is always True."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get(ENV_BREAKER, "1") not in ("0", "false")
        self.enabled = enabled
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker(key)
            return b

    def configure(self, key: str, policy: BreakerPolicy,
                  clock: Callable[[], float] = time.monotonic
                  ) -> CircuitBreaker:
        """Install a breaker with a custom policy (benches, tests)."""
        with self._lock:
            b = CircuitBreaker(key, policy, clock)
            self._breakers[key] = b
            return b

    def reset(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._breakers.clear()
            else:
                self._breakers.pop(key, None)

    def allow(self, key: str) -> bool:
        if not self.enabled:
            return True
        return self.get(key).allow()

    def record_success(self, key: str) -> None:
        if self.enabled:
            self.get(key).record_success()

    def record_failure(self, key: str) -> None:
        if self.enabled:
            self.get(key).record_failure()

    def note_fallback(self, key: str, path: str) -> None:
        _FALLBACK.inc(1, key=key, path=path)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: b.snapshot() for k, b in self._breakers.items()}


#: process-wide breaker board (enabled unless REPRO_BREAKER=0)
BREAKERS = BreakerBoard()
