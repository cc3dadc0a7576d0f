"""Pod-wide flight recorder (counterpart of ``repro/obs/pod.py``):
all-gather every host's recent spans and metrics so a stalled
``pod_flush`` is attributable to a specific host.

``pod_snapshot()`` serializes the local tracer ring, metrics registry,
shadow quality and SLO state (:func:`local_snapshot`) to JSON bytes,
all-gathers them over the transport ``pod_flush`` already rides
(:func:`repro_torch.launch.multihost.allgather_bytes`), and returns one
dict per process.  Like every pod collective it is SPMD: **all
processes must call it together**, or the gather deadlocks.  A single
process returns ``[local]``.  :func:`merge_pod_trace` and
:func:`pod_quality_report` read a list of such snapshots.
"""
from __future__ import annotations

import json
import os
import socket
from typing import List, Optional

from .metrics import default_registry
from .quality import SHADOW
from .slo import MONITOR
from .trace import TRACER, merge_chrome_traces


def _process_index() -> int:
    """Pod process id: this process's rank in a pod of several, else
    the bootstrap env var (obs must stay importable before any
    bootstrap)."""
    from repro_torch.launch import multihost
    if multihost.is_multiprocess():
        return multihost.process_index()
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

    Collective: call from all pod processes together (same contract as
    ``ServeQueue.pod_flush``); index ``i`` is process ``i``'s view.  A
    failed gather raises rather than pass one rank's view off as the
    pod's."""
    from repro_torch.launch import multihost
    local = local_snapshot()
    if not multihost.is_multiprocess():
        return [local]
    blobs = multihost.allgather_bytes(json.dumps(local).encode("utf-8"))
    return [json.loads(b.decode("utf-8")) for b in blobs]


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
