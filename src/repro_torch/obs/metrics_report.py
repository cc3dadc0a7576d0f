"""Render a metrics snapshot (and optionally a trace) as markdown/JSON
(counterpart of ``repro/obs/metrics_report.py``; pure Python, the same
text from the same snapshot).

    PYTHONPATH=src python -m repro_torch.obs.metrics_report \
        --metrics serve_metrics.json --markdown
    PYTHONPATH=src python -m repro_torch.obs.metrics_report \
        --metrics serve_metrics.json --json

Input is the JSON form of ``MetricsRegistry.collect()`` (or a list of
snapshots, each carrying it under ``"metrics"``, as
:func:`repro_torch.obs.pod.pod_snapshot` returns).  With ``--trace`` it
also summarizes span time by name -- the quick "where did the batch go"
table without opening Perfetto.

Histogram quantiles (p50/p90/p99) are linearly interpolated from the
cumulative bucket counts -- ``histogram_quantile`` semantics: exact only
if values are uniform within a bucket, and clamped to the largest
finite bucket bound when the quantile lands in the ``+Inf`` bucket.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
from typing import Dict, List, Optional

#: numeric alert-state gauge values back to names (see obs.quality)
_STATE_NAMES = {0: "OK", 1: "WARN", 2: "CRITICAL"}


def _fmt(v: float) -> str:
    return f"{v:g}"


def _labels(d: dict) -> str:
    return ", ".join(f"{k}={v}" for k, v in sorted(d.items())) or "-"


def quantile_from_buckets(buckets: Dict[float, int], count: int,
                          q: float) -> Optional[float]:
    """Interpolated quantile from cumulative bucket counts.

    Linear interpolation within the first bucket whose cumulative count
    reaches ``q * count`` (the first bucket's lower bound is 0); when
    the quantile falls past the last finite bucket, returns that
    bucket's bound (a lower bound on the true quantile).
    """
    if not count or not buckets:
        return None
    target = q * count
    prev_le, prev_c = 0.0, 0
    items = sorted(buckets.items())
    for le, c in items:
        if c >= target:
            if math.isinf(le):  # clamp to the largest finite bound
                return prev_le
            span = c - prev_c
            if span <= 0:
                return le
            frac = (target - prev_c) / span
            return prev_le + (le - prev_le) * frac
        prev_le, prev_c = le, c
    return prev_le


def histogram_rows(m: dict) -> List[dict]:
    """Per-labelset summary rows (count/sum/mean/p50/p90/p99) for one
    collected histogram family — shared by markdown and JSON output."""
    rows = []
    for v in m.get("values", []):
        count = v.get("count", 0)
        total = v.get("sum", 0.0)
        buckets = {float(k): c for k, c in (v.get("buckets") or {}).items()}
        rows.append({
            "labels": v.get("labels", {}),
            "count": count,
            "sum": total,
            "mean": total / count if count else 0.0,
            "p50": quantile_from_buckets(buckets, count, 0.50),
            "p90": quantile_from_buckets(buckets, count, 0.90),
            "p99": quantile_from_buckets(buckets, count, 0.99),
        })
    return rows


def render_metrics_markdown(collected: Dict[str, dict]) -> str:
    lines: List[str] = []
    scalars = [(n, m) for n, m in sorted(collected.items())
               if m.get("type") in ("counter", "gauge")]
    if scalars:
        lines += ["| metric | type | labels | value |",
                  "|---|---|---|---|"]
        for name, m in scalars:
            for v in m.get("values", []):
                lines.append(f"| {name} | {m['type']} | "
                             f"{_labels(v.get('labels', {}))} | "
                             f"{_fmt(v.get('value', 0))} |")
        lines.append("")
    hists = [(n, m) for n, m in sorted(collected.items())
             if m.get("type") == "histogram"]
    for name, m in hists:
        lines.append(f"**{name}**")
        lines.append("")
        lines += ["| labels | count | sum | mean | p50 | p90 | p99 |",
                  "|---|---|---|---|---|---|---|"]
        for r in histogram_rows(m):
            def fq(x):
                return _fmt(x) if x is not None else "-"
            lines.append(f"| {_labels(r['labels'])} | {r['count']} | "
                         f"{_fmt(r['sum'])} | {_fmt(r['mean'])} | "
                         f"{fq(r['p50'])} | {fq(r['p90'])} | "
                         f"{fq(r['p99'])} |")
        lines.append("")
    return "\n".join(lines)


def _gauge_map(collected: Dict[str, dict], name: str) -> Dict[tuple, float]:
    out = {}
    for v in (collected.get(name) or {}).get("values", []):
        labels = v.get("labels", {})
        out[tuple(sorted(labels.items()))] = v.get("value", 0.0)
    return out


def render_quality_markdown(collected: Dict[str, dict]) -> str:
    """Surrogate-quality summary: one row per shadow-scored bundle, plus
    SLO burn rates when tracked.  Empty string when no quality metrics
    are present (shadow sampling off)."""
    rmse = _gauge_map(collected, "repro_quality_rmse")
    if not rmse:
        return ""
    max_abs = _gauge_map(collected, "repro_quality_max_abs")
    rel_l2 = _gauge_map(collected, "repro_quality_rel_l2")
    states = _gauge_map(collected, "repro_quality_alert_state")
    samples: Dict[str, float] = {}
    for v in (collected.get("repro_quality_samples_total") or {}).get(
            "values", []):
        key = v.get("labels", {}).get("key", "-")
        samples[key] = samples.get(key, 0) + v.get("value", 0)
    lines = ["### Surrogate quality (shadow-scored)", "",
             "| key | rmse ewma | max-abs ewma | rel-L2 ewma | samples "
             "| alert |",
             "|---|---|---|---|---|---|"]
    for lk, r in sorted(rmse.items()):
        key = dict(lk).get("key", "-")
        st = _STATE_NAMES.get(int(states.get(lk, 0)), "?")
        lines.append(
            f"| {key} | {_fmt(r)} | {_fmt(max_abs.get(lk, 0.0))} | "
            f"{_fmt(rel_l2.get(lk, 0.0))} | {int(samples.get(key, 0))} | "
            f"{st} |")
    lines.append("")
    burns = (collected.get("repro_slo_burn_rate") or {}).get("values", [])
    if burns:
        lines += ["**SLO burn rates**", "",
                  "| key | objective | window | burn |",
                  "|---|---|---|---|"]
        slo_states = _gauge_map(collected, "repro_slo_alert_state")
        for v in sorted(burns, key=lambda v: sorted(
                v.get("labels", {}).items())):
            lb = v.get("labels", {})
            lines.append(f"| {lb.get('key', '-')} | {lb.get('slo', '-')} | "
                         f"{lb.get('window', '-')} | "
                         f"{_fmt(v.get('value', 0.0))} |")
        crits = [dict(lk) for lk, s in slo_states.items() if s >= 2]
        if crits:
            lines.append("")
            lines.append(f"CRITICAL SLOs: {crits}")
        lines.append("")
    return "\n".join(lines)


def render_trace_markdown(events: List[dict]) -> str:
    agg: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        agg.setdefault(ev["name"], []).append(ev.get("dur", 0.0))
    lines = ["| span | count | total ms | mean us |", "|---|---|---|---|"]
    for name in sorted(agg, key=lambda n: -sum(agg[n])):
        durs = agg[name]
        lines.append(f"| {name} | {len(durs)} | {sum(durs) / 1e3:.3f} | "
                     f"{sum(durs) / len(durs):.1f} |")
    return "\n".join(lines) + "\n"


def trace_summary(events: List[dict]) -> Dict[str, dict]:
    agg: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        agg.setdefault(ev["name"], []).append(ev.get("dur", 0.0))
    return {name: {"count": len(durs), "total_ms": sum(durs) / 1e3,
                   "mean_us": sum(durs) / len(durs)}
            for name, durs in agg.items()}


def _load_snaps(path: pathlib.Path) -> List[dict]:
    data = json.loads(path.read_text())
    return data if isinstance(data, list) else [{"metrics": data}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.metrics_report",
        description="render obs metrics/trace snapshots as markdown or "
                    "JSON")
    ap.add_argument("--metrics", type=pathlib.Path, default=None,
                    help="JSON file holding MetricsRegistry.collect() "
                         "output (or a pod_snapshot list)")
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="Chrome trace JSON to summarize by span name")
    ap.add_argument("--markdown", action="store_true",
                    help="render markdown (the default)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit a JSON document instead of markdown "
                         "(metrics + interpolated histogram quantiles + "
                         "trace summary)")
    args = ap.parse_args(argv)
    if args.metrics is None and args.trace is None:
        ap.error("need --metrics and/or --trace")

    snaps = _load_snaps(args.metrics) if args.metrics is not None else []
    events: List[dict] = []
    if args.trace is not None:
        data = json.loads(args.trace.read_text())
        events = data.get("traceEvents", data) if isinstance(data, dict) \
            else data

    if args.as_json:
        doc: dict = {"snapshots": []}
        for snap in snaps:
            collected = snap.get("metrics", snap)
            doc["snapshots"].append({
                "process": snap.get("process"),
                "host": snap.get("host"),
                "metrics": collected,
                "histogram_quantiles": {
                    name: histogram_rows(m)
                    for name, m in sorted(collected.items())
                    if m.get("type") == "histogram"},
            })
        if args.trace is not None:
            doc["trace_summary"] = trace_summary(events)
        json.dump(doc, sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
        return 0

    out: List[str] = []
    for snap in snaps:
        if len(snaps) > 1:
            out.append(f"### process {snap.get('process', '?')} "
                       f"({snap.get('host', '?')})\n")
        collected = snap.get("metrics", snap)
        out.append(render_metrics_markdown(collected))
        quality = render_quality_markdown(collected)
        if quality:
            out.append(quality)
    if args.trace is not None:
        out.append("### span time by name\n")
        out.append(render_trace_markdown(events))
    sys.stdout.write("\n".join(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
