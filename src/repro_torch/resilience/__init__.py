"""repro_torch.resilience: fault tolerance for the serving stack
(counterpart of ``repro/resilience``).

Three pieces, layered under `repro_torch.serve` and
`repro_torch.core.region`:

- :mod:`repro_torch.resilience.faults` — deterministic, seedable fault
  injection (`REPRO_FAULTS`) at fixed serve-path sites, used by tests
  and the fault drills of `chip_smoke.py`.
- :mod:`repro_torch.resilience.retry` — capped exponential backoff policy for
  transient dispatch failures.
- :mod:`repro_torch.resilience.breaker` — per-bundle CLOSED→OPEN→HALF_OPEN
  circuit breakers that route `MLRegion` traffic to the accurate path
  while the surrogate is failing or drifted.

Import order matters: this package imports only `repro_torch.obs`; the serve
and region layers import us.
"""
from repro_torch.resilience.faults import (  # noqa: F401
    FAULTS, FaultInjector, FaultRule, InjectedFault, parse_plan)
from repro_torch.resilience.retry import DEFAULT_RETRY, RetryPolicy  # noqa: F401
from repro_torch.resilience.breaker import (  # noqa: F401
    BREAKERS, BreakerBoard, BreakerPolicy, CircuitBreaker,
    CLOSED, OPEN, HALF_OPEN)

__all__ = [
    "FAULTS", "FaultInjector", "FaultRule", "InjectedFault", "parse_plan",
    "DEFAULT_RETRY", "RetryPolicy",
    "BREAKERS", "BreakerBoard", "BreakerPolicy", "CircuitBreaker",
    "CLOSED", "OPEN", "HALF_OPEN",
]
