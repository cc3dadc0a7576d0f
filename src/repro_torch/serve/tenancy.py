"""Multi-tenant serving control plane: admission, QoS tiers, fair share
(counterpart of ``repro/serve/tenancy.py``).

The serve queue multiplexes every region's traffic over one card's
capacity; without a control plane, one tenant's burst monopolizes the
batcher and every other tenant's deadline blows.  This module adds the
three pieces a shared inference service needs (the coupling layer Jha et
al. flag as the AI-HPC scaling bottleneck):

  * **admission control** — each tenant declares a token bucket
    (``rate_rows_per_s`` + ``burst_rows``); ``ServeQueue.submit`` asks
    the board before enqueueing, so a runaway producer throttles at the
    door instead of growing the queue.  Per-tenant pending caps bound
    how much of the shared ``max_pending_rows`` budget one tenant may
    hold.
  * **QoS tiers** — a tenant is ``latency`` or ``throughput`` tier;
    the tier's deadline target (:meth:`TenantBoard.qos_for_key`) is the
    per-key bound an adaptive flush controller reads (the reference's
    ``AdaptiveFlushController``, ROADMAP queue 1 item 6): latency tenants cap how long the queue may hold
    their rows, throughput tenants permit waiting past the static
    policy to build fat batches.
  * **weighted fair share** — under overload (pending rows exceed one
    batch of capacity) flush order is picked by deficit-round-robin
    over tenant weights instead of FIFO, so a heavy tenant's backlog
    cannot starve a light tenant's key.

All counters publish through :mod:`repro_torch.obs.metrics` labeled by
``tenant`` and surface in ``ServeQueue.snapshot()``;
``ServeQueue.tenant_offenders()`` names misbehaving tenants.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import metrics as _m
from repro_torch.serve.stats import _percentile

#: QoS tiers and their default deadline targets (seconds).  A latency
#: tenant's rows may wait at most this long before a deadline flush; a
#: throughput tenant's rows may wait *up to* this long so batches run
#: fat.  ``TenantSpec.deadline_target_s`` overrides per tenant.
LATENCY = "latency"
THROUGHPUT = "throughput"
TIER_DEADLINE_S = {LATENCY: 2e-3, THROUGHPUT: 5e-2}

DEFAULT_TENANT = "default"


class TenantThrottled(RuntimeError):
    """Admission denied: the tenant's token bucket is empty (and the
    queue's policy says raise rather than wait for refill)."""

    def __init__(self, tenant: str, rows: int, wait_s: float):
        super().__init__(
            f"tenant {tenant!r} throttled: {rows} rows exceed the "
            f"admission bucket (refill in ~{wait_s * 1e3:.1f}ms)")
        self.tenant, self.rows, self.wait_s = tenant, rows, wait_s


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared contract with the serving control plane."""

    tenant: str = DEFAULT_TENANT
    tier: str = THROUGHPUT          # LATENCY | THROUGHPUT
    weight: float = 1.0             # fair-share weight (rows per DRR round)
    rate_rows_per_s: float = float("inf")  # admission refill rate
    burst_rows: Optional[int] = None       # bucket capacity (None: 1s of rate)
    max_pending_rows: Optional[int] = None  # per-tenant backpressure cap
    deadline_target_s: Optional[float] = None  # overrides the tier default

    def __post_init__(self):
        if self.tier not in (LATENCY, THROUGHPUT):
            raise ValueError(f"tenant {self.tenant!r}: tier must be "
                             f"{LATENCY!r} or {THROUGHPUT!r}, got "
                             f"{self.tier!r}")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.tenant!r}: weight must be > 0 "
                             f"(zero-weight tenants would starve by design)")

    @property
    def target_s(self) -> float:
        if self.deadline_target_s is not None:
            return float(self.deadline_target_s)
        return TIER_DEADLINE_S[self.tier]


class TokenBucket:
    """Thread-safe token bucket over an injectable monotonic clock.

    Refill is **monotonic**: the level between two ``take`` calls never
    decreases (a clock that steps backwards is ignored rather than
    draining the bucket), and never exceeds ``burst``.  A request larger
    than the burst is admitted against a *full* bucket and drives the
    level negative (debt) — otherwise an oversized-but-legitimate batch
    could never be admitted at all and a blocking submit would deadlock.
    """

    def __init__(self, rate_per_s: float, burst: float,
                 clock=time.monotonic):
        if burst <= 0:
            raise ValueError(f"burst must be > 0, got {burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._level = float(burst)      # start full: no cold-start penalty
        self._last = clock()

    def _refill_locked(self, now: float) -> None:
        if now <= self._last:
            return  # non-monotonic clock tick: never drain on refill
        if self.rate == float("inf"):
            self._level = self.burst
        else:
            self._level = min(self.burst,
                              self._level + (now - self._last) * self.rate)
        self._last = now

    def level(self) -> float:
        with self._lock:
            self._refill_locked(self._clock())
            return self._level

    def take(self, n: float) -> bool:
        """Admit ``n`` tokens now, or leave the bucket untouched."""
        with self._lock:
            self._refill_locked(self._clock())
            if self._level >= min(float(n), self.burst):
                self._level -= float(n)
                return True
            return False

    def wait_s(self, n: float) -> float:
        """Seconds of refill until ``take(n)`` could succeed (0 = now)."""
        with self._lock:
            self._refill_locked(self._clock())
            need = min(float(n), self.burst) - self._level
            if need <= 0:
                return 0.0
            if self.rate <= 0:
                return float("inf")
            return need / self.rate


class DeficitRoundRobin:
    """Weighted fair flush ordering over tenants.

    Each scheduling round credits every *backlogged* tenant ``quantum``
    rows of deficit; serving a tenant's key charges the served rows
    back **scaled by 1/weight** (a weight-2 tenant pays half price per
    served row, so it sustains twice the service share).  Keys order by
    descending deficit, ties breaking least-recently-served.

    The charge-side weighting is what makes starvation impossible even
    when capacity admits only one key per round: a losing tenant accrues
    the full quantum every round uncharged, while every winner pays per
    served row, so the loser's deficit eventually tops the board.
    (Crediting ``quantum * weight`` instead — the textbook-adjacent
    shape — lets a heavy tenant's credit outpace its charge forever and
    starve the light one.  tests/test_torch_tenancy.py holds the
    property.)
    """

    def __init__(self, quantum_rows: float = 64.0):
        self.quantum = float(quantum_rows)
        self._lock = threading.Lock()
        self._deficit: Dict[str, float] = {}
        self._weight: Dict[str, float] = {}
        self._last_served: Dict[str, int] = {}
        self._serve_seq = 0

    def order(self, items: Sequence[Tuple[str, str, int]],
              weights: Dict[str, float]) -> List[str]:
        """DRR order of ``(key, tenant, pending_rows)`` triples."""
        if not items:
            return []
        with self._lock:
            active = {t for _, t, rows in items if rows > 0}
            for t in active:
                self._weight[t] = max(float(weights.get(t, 1.0)), 1e-9)
                self._deficit[t] = self._deficit.get(t, 0.0) + self.quantum
            return [k for k, _, _ in sorted(
                items,
                key=lambda it: (-self._deficit.get(it[1], 0.0),
                                self._last_served.get(it[1], -1),
                                it[0]))]

    def charge(self, tenant: str, rows: int) -> None:
        with self._lock:
            self._serve_seq += 1
            w = self._weight.get(tenant, 1.0)
            self._deficit[tenant] = self._deficit.get(tenant, 0.0) \
                - rows / w
            self._last_served[tenant] = self._serve_seq

    def deficit(self, tenant: str) -> float:
        with self._lock:
            return self._deficit.get(tenant, 0.0)


class _TenantState:
    """Mutable per-tenant accounting behind the board's lock."""

    __slots__ = ("spec", "bucket", "pending_rows", "admitted_rows",
                 "served_rows", "dropped_rows", "dropped_requests",
                 "throttled_total", "last_drop_t", "lat")

    def __init__(self, spec: TenantSpec, clock, latency_window: int):
        self.spec = spec
        burst = spec.burst_rows
        if burst is None:
            rate = spec.rate_rows_per_s
            burst = max(1.0, rate if rate != float("inf") else 1.0)
        self.bucket = TokenBucket(spec.rate_rows_per_s, burst, clock)
        self.pending_rows = 0
        self.admitted_rows = 0
        self.served_rows = 0
        self.dropped_rows = 0
        self.dropped_requests = 0
        self.throttled_total = 0
        self.last_drop_t: Optional[float] = None
        self.lat: Deque[float] = deque(maxlen=latency_window)


class TenantBoard:
    """The control plane: tenant registry + admission + fair share.

    One board per :class:`ServeQueue` (pass ``tenancy=board``); the
    queue calls in under its own lock, the board takes its own lock
    second and never calls back out, so the lock order is acyclic.
    """

    #: tenants that dropped rows within this window are /healthz offenders
    OFFENDER_WINDOW_S = 60.0

    def __init__(self, specs: Sequence[TenantSpec] = (), *,
                 default_spec: Optional[TenantSpec] = None,
                 drr_quantum_rows: float = 64.0,
                 latency_window: int = 2048,
                 clock=time.monotonic):
        self._clock = clock
        self._default_spec = default_spec or TenantSpec()
        self._lock = threading.Lock()
        self._states: Dict[str, _TenantState] = {}
        self._key_tenant: Dict[str, str] = {}
        self.latency_window = int(latency_window)
        self.drr = DeficitRoundRobin(drr_quantum_rows)
        self._m_admitted = _m.counter(
            "repro_tenant_admitted_rows_total",
            "rows admitted past the tenant token bucket", ("tenant",))
        self._m_throttled = _m.counter(
            "repro_tenant_throttled_total",
            "admission attempts denied by the token bucket", ("tenant",))
        self._m_served = _m.counter(
            "repro_tenant_served_rows_total",
            "rows resolved back to the tenant's callers", ("tenant",))
        self._m_dropped = _m.counter(
            "repro_tenant_dropped_rows_total",
            "rows whose dispatch failed (tenant-attributed)", ("tenant",))
        self._m_pending = _m.gauge(
            "repro_tenant_pending_rows",
            "rows the tenant holds in the queue right now", ("tenant",))
        self._m_lat = _m.histogram(
            "repro_tenant_request_latency_seconds",
            "enqueue -> resolve latency per tenant", ("tenant",))
        for spec in specs:
            self.register(spec)

    # --------------------------------------------------------- registry ---
    def register(self, spec: TenantSpec) -> TenantSpec:
        with self._lock:
            self._states[spec.tenant] = _TenantState(
                spec, self._clock, self.latency_window)
        return spec

    def _state_locked(self, tenant: str) -> _TenantState:
        st = self._states.get(tenant)
        if st is None:
            spec = dataclasses.replace(self._default_spec, tenant=tenant)
            st = self._states[tenant] = _TenantState(
                spec, self._clock, self.latency_window)
        return st

    def spec_for(self, tenant: str) -> TenantSpec:
        with self._lock:
            return self._state_locked(tenant).spec

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._states)

    # -------------------------------------------------------- admission ---
    def admit(self, tenant: str, rows: int, *, block: bool = True,
              timeout_s: float = 30.0) -> None:
        """Charge ``rows`` against the tenant's token bucket.

        Raises :class:`TenantThrottled` when the bucket is empty and
        ``block`` is False (or the refill wait would exceed
        ``timeout_s``).  Blocking waits sleep outside every lock — refill
        is wall-clock, not queue-drain, so there is nothing to be
        notified by.
        """
        with self._lock:
            st = self._state_locked(tenant)
        deadline = self._clock() + timeout_s
        while True:
            if st.bucket.take(rows):
                return
            wait = st.bucket.wait_s(rows)
            with self._lock:
                st.throttled_total += 1
            self._m_throttled.inc(1, tenant=tenant)
            if not block or self._clock() + wait > deadline:
                raise TenantThrottled(tenant, rows, wait)
            time.sleep(min(wait, 0.05) if wait > 0 else 1e-4)

    def has_room(self, tenant: str, rows: int) -> bool:
        """Per-tenant backpressure: may this tenant hold ``rows`` more?

        A tenant with no pending rows is always admitted (oversized
        requests flush as their own batch — same no-deadlock rule the
        queue applies globally)."""
        with self._lock:
            st = self._state_locked(tenant)
            cap = st.spec.max_pending_rows
            if cap is None or st.pending_rows == 0:
                return True
            return st.pending_rows + rows <= cap

    # ------------------------------------------------------- accounting ---
    def on_enqueue(self, tenant: str, key: str, rows: int) -> None:
        with self._lock:
            st = self._state_locked(tenant)
            st.pending_rows += rows
            st.admitted_rows += rows
            self._key_tenant[key] = tenant
            pending = st.pending_rows
        self._m_admitted.inc(rows, tenant=tenant)
        self._m_pending.set(pending, tenant=tenant)

    def on_dispatch(self, tenant: str, rows: int) -> None:
        """Rows left the queue for the engine: release pending, charge
        the DRR deficit (dispatch IS the service the scheduler meters)."""
        with self._lock:
            st = self._state_locked(tenant)
            st.pending_rows = max(0, st.pending_rows - rows)
            pending = st.pending_rows
        self.drr.charge(tenant, rows)
        self._m_pending.set(pending, tenant=tenant)

    def on_served(self, tenant: str, rows: int,
                  latencies_s: Sequence[float] = ()) -> None:
        with self._lock:
            st = self._state_locked(tenant)
            st.served_rows += rows
            st.lat.extend(float(x) for x in latencies_s)
        self._m_served.inc(rows, tenant=tenant)
        for lat in latencies_s:
            self._m_lat.observe(float(lat), tenant=tenant)

    def on_dropped(self, tenant: str, requests: int, rows: int) -> None:
        with self._lock:
            st = self._state_locked(tenant)
            st.dropped_rows += rows
            st.dropped_requests += requests
            st.last_drop_t = self._clock()
        self._m_dropped.inc(rows, tenant=tenant)

    # ------------------------------------------------------- fair share ---
    def tenant_for_key(self, key: str) -> str:
        with self._lock:
            return self._key_tenant.get(key, DEFAULT_TENANT)

    def order_keys(self, pending: Sequence[Tuple[str, int]]) -> List[str]:
        """DRR flush order for ``(key, pending_rows)`` pairs."""
        with self._lock:
            items = [(k, self._key_tenant.get(k, DEFAULT_TENANT), rows)
                     for k, rows in pending]
            weights = {t: st.spec.weight for t, st in self._states.items()}
        return self.drr.order(items, weights)

    # ------------------------------------------------------ QoS / obs ----
    def qos_for_key(self, key: str) -> Tuple[Optional[str], Optional[float]]:
        """(tier, deadline_target_s) of the tenant bound to ``key``, or
        (None, None) for keys no tenant has touched."""
        with self._lock:
            tenant = self._key_tenant.get(key)
            if tenant is None:
                return None, None
            spec = self._state_locked(tenant).spec
        return spec.tier, spec.target_s

    def offenders(self) -> List[str]:
        """Tenant ids misbehaving *right now* — dropped rows within the
        offender window, or pending past their declared cap (stuck
        backlog).  ``/healthz`` prefixes these ``tenant:``."""
        now = self._clock()
        out = []
        with self._lock:
            for t, st in sorted(self._states.items()):
                if st.last_drop_t is not None and \
                        now - st.last_drop_t <= self.OFFENDER_WINDOW_S:
                    out.append(t)
                elif st.spec.max_pending_rows is not None and \
                        st.pending_rows > st.spec.max_pending_rows:
                    out.append(t)
        return out

    def p99_ms(self, tenant: str) -> float:
        with self._lock:
            st = self._states.get(tenant)
            lat = sorted(st.lat) if st is not None else []
        return _percentile(lat, 0.99) * 1e3

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            states = dict(self._states)
            served_total = sum(st.served_rows for st in states.values())
        out = {}
        for t, st in sorted(states.items()):
            with self._lock:
                lat = sorted(st.lat)
                snap = {
                    "tier": st.spec.tier,
                    "weight": st.spec.weight,
                    "deadline_target_s": st.spec.target_s,
                    "pending_rows": st.pending_rows,
                    "admitted_rows": st.admitted_rows,
                    "served_rows": st.served_rows,
                    "dropped_rows": st.dropped_rows,
                    "dropped_requests": st.dropped_requests,
                    "throttled_total": st.throttled_total,
                    "bucket_level": round(st.bucket.level(), 3),
                    "drr_deficit": round(self.drr.deficit(t), 3),
                }
            snap["occupancy"] = (st.served_rows / served_total
                                 if served_total else 0.0)
            snap["latency_p50_ms"] = _percentile(lat, 0.50) * 1e3
            snap["latency_p99_ms"] = _percentile(lat, 0.99) * 1e3
            out[t] = snap
        return out
