"""Shared per-bundle RMSE budget registry (a copy of
``repro/quant/budgets.py``; the port keeps its own table).

One process-wide table mapping a bundle key (the serve-queue key: the
bundle path) to its accuracy budget.  The **quant gate**
(:mod:`repro_torch.quant.gate`) reads it: a quantized variant is
eligible only if its RMSE vs the f32 net stays under the budget.  The
shadow scorer (:mod:`repro_torch.obs.quality`) reads the same numbers for
its drift alerts.

Import contract: stdlib only.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

#: WARN fires at this fraction of the RMSE budget unless overridden
DEFAULT_WARN_RATIO = 0.5

_lock = threading.Lock()
_budgets: Dict[str, Tuple[float, float]] = {}  # key -> (warn_at, crit_at)


def set_rmse_budget(key: str, rmse_budget: float,
                    warn_ratio: float = DEFAULT_WARN_RATIO) -> None:
    """Register ``key``'s accuracy budget: RMSE past ``rmse_budget`` is
    out of budget (gate fail / CRITICAL drift), past ``warn_ratio *
    rmse_budget`` is the WARN band."""
    pair = (float(rmse_budget) * float(warn_ratio), float(rmse_budget))
    with _lock:
        _budgets[str(key)] = pair


def rmse_budget(key: str) -> Optional[float]:
    """The hard RMSE budget for ``key``, or None when unregistered."""
    with _lock:
        pair = _budgets.get(str(key))
    return pair[1] if pair is not None else None


def budget_pair(key: str) -> Optional[Tuple[float, float]]:
    """(warn_at, crit_at) for ``key``, or None when unregistered."""
    with _lock:
        return _budgets.get(str(key))


def clear_budgets() -> None:
    """Forget every registered budget (tests)."""
    with _lock:
        _budgets.clear()
