"""Pod-wide flight recorder, single-process half (counterpart of
``repro/obs/pod.py``).

``local_snapshot()`` gathers this process's recent spans, metrics,
shadow quality and SLO state as one JSON-able dict;
:func:`merge_pod_trace` and :func:`pod_quality_report` read a list of
such snapshots.  In the reference ``pod_snapshot()`` all-gathers every
host's snapshot over ``launch.multihost.allgather_bytes``; the port's
multi-host transport is ROADMAP queue 1 item 9, so here it returns
``[local]`` in a single process and raises in a
``torch.distributed`` group of more than one rank rather than pass off
one rank's view as the pod's.
"""
from __future__ import annotations

import os
import socket
from typing import List, Optional

from .metrics import default_registry
from .quality import SHADOW
from .slo import MONITOR
from .trace import TRACER, merge_chrome_traces


def _world():
    """``(rank, world size)`` of an initialized ``torch.distributed``
    group, else None (obs must stay importable before any bootstrap)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except ImportError:
        pass
    return None


def _process_index() -> int:
    """Pod process id: the live ``torch.distributed`` rank when a group
    is up, else the bootstrap env var."""
    world = _world()
    if world is not None:
        return int(world[0])
    return int(os.environ.get("REPRO_PROCESS_ID", 0) or 0)


def local_snapshot() -> dict:
    """This process's observability state as a JSON-able dict."""
    return {
        "process": _process_index(),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "events": TRACER.chrome_events(),
        "metrics": default_registry().collect(),
        "quality": SHADOW.snapshot(),
        "slo": MONITOR.snapshot(),
    }


def pod_snapshot() -> List[dict]:
    """Every process's :func:`local_snapshot`, in process order.

    A single process returns ``[local]``.  Across ranks the snapshots
    need the all-gather of ROADMAP queue 1 item 9 (multi-host
    transport); until it lands this raises ``NotImplementedError``.
    """
    world = _world()
    if world is not None and world[1] > 1:
        raise NotImplementedError(
            f"pod_snapshot across {world[1]} ranks needs the multi-host "
            f"all-gather (ROADMAP queue 1 item 9), not yet ported")
    return [local_snapshot()]


def merge_pod_trace(snapshots: List[dict], path: Optional[str] = None
                    ) -> List[dict]:
    """Merge per-host snapshot event lists into one Chrome trace (events
    already carry wall-clock ``ts`` and per-process ``pid``)."""
    return merge_chrome_traces(
        [s.get("events") or [] for s in snapshots], path)


def pod_quality_report(snapshots: List[dict]) -> str:
    """Cross-host drift table from ``pod_snapshot`` output: one row per
    (process, bundle) with the shadow RMSE EWMA and alert state."""
    lines = ["| process | key | rmse ewma | state | samples |",
             "|---:|---|---:|---|---:|"]
    rows = 0
    for s in snapshots:
        keys = ((s.get("quality") or {}).get("keys") or {})
        for key, st in sorted(keys.items()):
            rmse = st.get("rmse_ewma")
            rmse_s = f"{rmse:.4g}" if rmse is not None else "-"
            lines.append(f"| {s.get('process', '?')} | {key} | {rmse_s} "
                         f"| {st.get('state', '?')} "
                         f"| {st.get('samples', 0)} |")
            rows += 1
    if not rows:
        return "(no shadow-quality samples on any host)"
    return "\n".join(lines)
