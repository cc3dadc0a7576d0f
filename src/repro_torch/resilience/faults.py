"""Deterministic fault injection for the serving stack (counterpart of
``repro/resilience/faults.py``).

A :class:`FaultPlan` is a seedable set of rules parsed from the
``REPRO_FAULTS`` env var (or installed programmatically via
:meth:`FaultInjector.configure`); the process-wide :data:`FAULTS`
injector evaluates them at four fixed sites on the serve path:

========================  ====================================================
site                      where it fires
========================  ====================================================
``engine.apply``          ``InferenceEngine.apply_batched`` (per batch)
``kernel.dispatch``       ``repro_torch.kernels.registry.dispatch`` (per call)
``batcher.scatter``       ``Batcher.dispatch`` after device->host, pre-scatter
``pod.flush``             reserved for ``ServeQueue.pod_flush`` (not ported)
========================  ====================================================

Spec grammar (``;``-separated rules)::

    site:mode[:k=v[,k=v...]]

modes: ``raise`` (raise :class:`InjectedFault`), ``nan`` / ``inf``
(poison output rows), ``stall`` (sleep ``stall`` seconds), ``corrupt``
(perturb the engine's resident weights by ``scale``), ``drop``
(simulate a dropped host: stall ``stall`` seconds, default 3600).

triggers (all optional, combinable): ``after=N`` (skip the first N
matching calls), ``every=N`` (then fire each Nth), ``n=N`` (at most N
fires), ``p=F`` with ``seed=S`` (seeded Bernoulli — deterministic
across runs), ``pid=K`` (only in pod process K, from
``REPRO_PROCESS_ID``), ``key=SUBSTR`` (only for keys containing it).

Examples::

    REPRO_FAULTS="engine.apply:raise:after=3,n=2"
    REPRO_FAULTS="batcher.scatter:nan:every=2"
    REPRO_FAULTS="pod.flush:drop:pid=1,stall=20"

The reference's ``kernel.dispatch`` fires once per jit trace (a compile
failure on the serve path); the port dispatches eagerly, so the site
fires once per kernel call.  ``pod.flush`` and the ``drop`` mode keep
the reference's grammar; no ported code calls that site until the pod
paths are ported.  ``np.random.default_rng(seed)`` per rule, as in the
reference, makes the same plan fire on the same calls in both packages.

Disabled (no rules) the injector costs one attribute read at each site
(``FAULTS.enabled`` is checked by the call sites themselves).  Imports
only stdlib + numpy + ``repro_torch.obs.metrics``.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import metrics as _metrics

ENV_FAULTS = "REPRO_FAULTS"

SITES = ("engine.apply", "kernel.dispatch", "batcher.scatter", "pod.flush")
MODES = ("raise", "nan", "inf", "stall", "corrupt", "drop")

_INJECTED = _metrics.counter(
    "repro_resilience_faults_injected_total",
    "faults fired by the injection harness", ("site", "mode"))


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-mode rule; carries ``site`` and ``key``."""

    def __init__(self, site: str, key: Optional[str] = None):
        super().__init__(f"injected fault at {site}"
                         + (f" (key={key})" if key else ""))
        self.site, self.key = site, key


class FaultRule:
    """One parsed ``site:mode:params`` rule with its trigger state."""

    __slots__ = ("site", "mode", "params", "after", "every", "max_fires",
                 "p", "pid", "key_substr", "stall_s", "scale", "value",
                 "_calls", "_fires", "_rng")

    def __init__(self, site: str, mode: str, params: Dict[str, str]):
        if site not in SITES:
            raise ValueError(f"fault rule: unknown site {site!r} "
                             f"(known: {', '.join(SITES)})")
        if mode not in MODES:
            raise ValueError(f"fault rule: unknown mode {mode!r} "
                             f"(known: {', '.join(MODES)})")
        self.site, self.mode = site, mode
        self.params = dict(params)
        self.after = int(params.get("after", 0))
        self.every = int(params.get("every", 1))
        self.max_fires = int(params.get("n", 0)) or None
        self.p = float(params.get("p", 1.0))
        self.pid = int(params["pid"]) if "pid" in params else None
        self.key_substr = params.get("key")
        self.stall_s = float(params.get(
            "stall", 3600.0 if mode == "drop" else 0.25))
        self.scale = float(params.get("scale", 0.5))
        self.value = np.float32("nan" if mode != "inf" else "inf")
        self._calls = 0
        self._fires = 0
        # seeded per rule: same spec -> same fire pattern, every run
        self._rng = np.random.default_rng(int(params.get("seed", 0)))

    def matches(self, site: str, key: Optional[str]) -> bool:
        if site != self.site:
            return False
        if self.key_substr and (key is None or self.key_substr not in key):
            return False
        if self.pid is not None:
            env_pid = os.environ.get("REPRO_PROCESS_ID")
            if env_pid is None or int(env_pid) != self.pid:
                return False
        return True

    def fires(self) -> bool:
        """Advance this rule's trigger state for one matching call."""
        self._calls += 1
        if self._calls <= self.after:
            return False
        if (self._calls - self.after - 1) % max(1, self.every):
            return False
        if self.max_fires is not None and self._fires >= self.max_fires:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self._fires += 1
        return True

    def snapshot(self) -> dict:
        return {"site": self.site, "mode": self.mode,
                "calls": self._calls, "fires": self._fires,
                "params": dict(self.params)}


def parse_plan(spec: str) -> List[FaultRule]:
    """Parse a ``REPRO_FAULTS`` spec string into rules."""
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":", 2)
        if len(bits) < 2:
            raise ValueError(f"fault rule {part!r}: want site:mode[:k=v,..]")
        params: Dict[str, str] = {}
        if len(bits) == 3 and bits[2]:
            for kv in bits[2].split(","):
                k, _, v = kv.partition("=")
                if not _ :
                    raise ValueError(f"fault rule {part!r}: bad param {kv!r}")
                params[k.strip()] = v.strip()
        rules.append(FaultRule(bits[0].strip(), bits[1].strip(), params))
    return rules


class FaultInjector:
    """Process-wide fault plan.  ``enabled`` is False with no rules, and
    call sites guard on it, so disabled injection is one attribute read."""

    def __init__(self, spec: Optional[str] = None):
        self.rules: List[FaultRule] = []
        self.enabled = False
        if spec:
            self.configure(spec)

    def configure(self, spec: Optional[str]) -> "FaultInjector":
        self.rules = parse_plan(spec) if spec else []
        self.enabled = bool(self.rules)
        return self

    def clear(self) -> None:
        self.rules = []
        self.enabled = False

    def fire(self, site: str, key: Optional[str] = None
             ) -> Optional[FaultRule]:
        """Evaluate ``site``; raise/stall modes act here, output-shaping
        modes (``nan``/``inf``/``corrupt``) return the rule for the call
        site to apply.  Returns None when nothing fired."""
        if not self.enabled:
            return None
        for rule in self.rules:
            if not rule.matches(site, key):
                continue
            if not rule.fires():
                continue
            _INJECTED.inc(1, site=site, mode=rule.mode)
            if rule.mode == "raise":
                raise InjectedFault(site, key)
            if rule.mode in ("stall", "drop"):
                time.sleep(rule.stall_s)
                return rule
            return rule
        return None

    def snapshot(self) -> dict:
        return {"enabled": self.enabled,
                "rules": [r.snapshot() for r in self.rules]}


#: process-wide injector, armed from the environment at import
FAULTS = FaultInjector(os.environ.get(ENV_FAULTS) or None)


def get_faults() -> FaultInjector:
    return FAULTS
