"""Device weight-residency manager: LRU over loaded bundles, byte budget
(counterpart of ``repro/serve/residency.py``).

The engine cache would otherwise keep every bundle's weights resident
forever; with many tenants that over-commits the card's memory.  This
manager meters bytes per loaded bundle, keeps an LRU over them, and
evicts past a configurable budget (``REPRO_RESIDENCY_BYTES``, 0 =
unlimited).  The bytes are what the engine holds on its device for a
bundle: its parameters, its normalization tensors and the kernel's
packed weights (the f32 pack, or the int8 pack and its layers), each
storage counted once (``InferenceEngine._resident_nbytes``); on the card
they agree with ``torch.cuda.memory_allocated`` around a load.

Eviction deliberately shares one path with retrain invalidation: an
evicted bundle is dropped from the process-wide ``InferenceEngine``
cache exactly like ``invalidate()`` after a NAS rewrite, so the next
request reloads from disk through the same staleness machinery.

Admission-time prefetch: ``prefetch(path)`` warms a bundle on a
background daemon thread so a newly admitted tenant's first request
does not pay the load; the warm touches the LRU like any serve would.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from repro_torch.obs import metrics as _m

ENV_BUDGET = "REPRO_RESIDENCY_BYTES"


def _env_budget() -> int:
    try:
        return max(0, int(os.environ.get(ENV_BUDGET, "0")))
    except ValueError:
        return 0


class ResidencyManager:
    """LRU byte accounting over the engine's loaded bundles.

    The engine calls :meth:`note_load` from ``_load()`` (bytes enter)
    and :meth:`touch` from ``get()`` (recency); both may run with the
    engine's cache lock held, so eviction defers the actual cache drop
    to the caller: :meth:`note_load` *returns* the victim paths and the
    engine drops them under its own lock — the manager never calls back
    into the engine, keeping the lock order acyclic.
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        self._budget = budget_bytes
        self._lock = threading.Lock()
        self._resident: "OrderedDict[str, int]" = OrderedDict()
        self.evictions = 0
        self.prefetches = 0
        self.peak_bytes = 0
        self._prefetch_inflight: set = set()
        self._m_bytes = _m.gauge(
            "repro_residency_bytes",
            "bytes of bundle weights resident right now")
        self._m_budget = _m.gauge(
            "repro_residency_budget_bytes",
            "configured residency byte budget (0 = unlimited)")
        self._m_evict = _m.counter(
            "repro_residency_evictions_total",
            "bundles evicted to fit the byte budget")
        self._m_prefetch = _m.counter(
            "repro_residency_prefetch_total",
            "bundles warmed ahead of first request")

    # ----------------------------------------------------------- budget ---
    @property
    def budget_bytes(self) -> int:
        """0 means unlimited (the pre-tenancy behavior)."""
        b = self._budget if self._budget is not None else _env_budget()
        return max(0, int(b))

    def set_budget(self, budget_bytes: Optional[int]) -> None:
        self._budget = budget_bytes
        self._m_budget.set(self.budget_bytes)

    def reset_stats(self) -> None:
        """Zero the watermark/counters (benchmarks gate a scenario's own
        peak, not whatever an earlier unlimited phase left behind)."""
        with self._lock:
            self.evictions = 0
            self.prefetches = 0
            self.peak_bytes = sum(self._resident.values())

    # -------------------------------------------------------- LRU hooks ---
    def note_load(self, path: str, nbytes: int) -> List[str]:
        """A bundle's params just materialized: account them, return the
        LRU victims the caller must drop to get back under budget.  The
        just-loaded bundle is never its own victim — a bundle larger
        than the whole budget serves anyway (and everything else
        evicts), mirroring the queue's oversized-request admission."""
        budget = self.budget_bytes
        victims: List[str] = []
        with self._lock:
            self._resident.pop(path, None)
            self._resident[path] = int(nbytes)
            total = sum(self._resident.values())
            if budget > 0:
                for cand in list(self._resident):
                    if total <= budget:
                        break
                    if cand == path:
                        continue
                    total -= self._resident.pop(cand)
                    victims.append(cand)
            self.evictions += len(victims)
            self.peak_bytes = max(self.peak_bytes, total)
            resident = total
        if victims:
            self._m_evict.inc(len(victims))
        self._m_bytes.set(resident)
        self._m_budget.set(budget)
        return victims

    def touch(self, path: str) -> None:
        with self._lock:
            if path in self._resident:
                self._resident.move_to_end(path)

    def drop(self, path: Optional[str] = None) -> None:
        """Bundle(s) left the engine cache (invalidate/evict): release
        their bytes.  Idempotent — retrain invalidation and eviction
        both land here."""
        with self._lock:
            if path is None:
                self._resident.clear()
            else:
                self._resident.pop(str(path), None)
            resident = sum(self._resident.values())
        self._m_bytes.set(resident)

    # --------------------------------------------------------- prefetch ---
    def prefetch(self, path: str, device=None
                 ) -> Optional[threading.Thread]:
        """Warm a bundle on ``device`` (None: the CUDA card) off the
        caller's thread (admission-time).

        Returns the warming thread (joinable by tests) or None when the
        bundle is already resident or a warm is in flight."""
        path = str(path)
        with self._lock:
            if path in self._resident or path in self._prefetch_inflight:
                return None
            self._prefetch_inflight.add(path)

        def warm():
            try:
                from repro_torch.core.engine import InferenceEngine
                InferenceEngine.get(path, device)
                with self._lock:
                    self.prefetches += 1
                self._m_prefetch.inc(1)
            except Exception:
                pass  # a missing bundle fails at first real request
            finally:
                with self._lock:
                    self._prefetch_inflight.discard(path)

        t = threading.Thread(target=warm, daemon=True,
                             name="repro-residency-prefetch")
        t.start()
        return t

    # --------------------------------------------------------- snapshot ---
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._resident.values())

    def resident(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._resident)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            resident = dict(self._resident)
            evictions, prefetches = self.evictions, self.prefetches
            peak = self.peak_bytes
        return {
            "budget_bytes": self.budget_bytes,
            "resident_bytes": sum(resident.values()),
            "peak_bytes": peak,
            "resident_bundles": len(resident),
            "evictions": evictions,
            "prefetches": prefetches,
            "lru": list(resident),  # oldest first
        }


#: process-wide manager, mirroring the process-wide engine cache it meters
RESIDENCY = ResidencyManager()
