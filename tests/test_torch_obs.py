"""Port parity of the observability layer on the CPU: the tracer (spans,
rings, trace ids, Chrome export, coverage, NVTX ranges in place of
``jax.profiler.TraceAnnotation``), the metrics registry, the shadow
scorer and its alert machine, and SLO burn rates, against ``repro.obs``.

The cases are those of tests/test_obs.py and tests/test_quality.py minus
the HTTP endpoint, the pod snapshots and the metrics report (those are
in tests/test_torch_obs_server.py).  Framework-free pieces are held to the reference on the same
scripted inputs: the same numbers or states, exactly.
"""
import json
import logging
import math
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.obs.quality as jquality  # noqa: E402
import repro.obs.slo as jslo  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro_torch.obs import (CRITICAL, MONITOR, OK, SHADOW, SLO,  # noqa: E402
                             TRACER, WARN, AlertMachine, MetricsRegistry,
                             ShadowScorer, default_registry, disable_tracing,
                             enable_tracing, merge_chrome_traces,
                             request_coverage, warn_once)
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.serve import FlushPolicy, ServeQueue  # noqa: E402
from repro_torch.serve.stats import ServeStats  # noqa: E402


@pytest.fixture(autouse=True)
def _obs_reset():
    """TRACER/SHADOW/MONITOR are process-global: leave them as these
    tests found them (off, empty)."""
    from repro_torch.core.engine import InferenceEngine
    InferenceEngine.invalidate()
    yield
    TRACER.enabled = False
    TRACER.annotate = False
    TRACER.clear()
    SHADOW.disable()
    SHADOW.rate = 0.0
    SHADOW.flush(10)
    SHADOW.reset()
    MONITOR.untrack()
    InferenceEngine.invalidate()


def _bundle(tmp, seed=0):
    """A reference-written MLP bundle (the port reads the same format)."""
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 2), [16], 1)
    return save_model(tmp / "m", net, net.init(jax.random.PRNGKey(seed)))


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


def _queue(policy=None, **kw):
    return ServeQueue(policy or FlushPolicy(max_batch_rows=1 << 30),
                      device="cpu", **kw)


# ------------------------------------------------------------ tracer unit ---
def test_disabled_tracer_records_nothing():
    disable_tracing()
    TRACER.record("x", 0.0, 1.0)
    TRACER.instant("y")
    with TRACER.span("z"):
        pass
    assert all(s.name not in ("x", "y", "z") for s in TRACER.events())


def test_span_context_and_record_land_in_ring():
    enable_tracing()
    TRACER.clear()
    with TRACER.span("work", cat="test", trace="t1", args={"k": 1}):
        pass
    TRACER.record("past", 1.0, 2.0, cat="test", trace="t1")
    TRACER.instant("mark", cat="test")
    by_name = {s.name: s for s in TRACER.events()}
    assert by_name["work"].trace == "t1" and by_name["work"].args == {"k": 1}
    assert by_name["work"].dur_s >= 0.0
    assert by_name["past"].dur_s == pytest.approx(1.0)
    assert by_name["mark"].t0 == by_name["mark"].t1  # instant


@pytest.mark.parametrize("mod", [jtrace, ttrace], ids=["jax", "torch"])
def test_ring_evicts_oldest_per_thread(mod):
    t = mod.Tracer(ring_size=4)
    t.enable()
    for i in range(10):
        t.record(f"s{i}", 0.0, 1.0)
    assert [s.name for s in t.events()] == ["s6", "s7", "s8", "s9"]
    assert sum(t.drop_counts().values()) == 6
    t.clear()  # clear keeps the drop totals (they are cumulative)
    assert sum(t.drop_counts().values()) == 6


def test_trace_ids_are_unique_and_pid_prefixed():
    ids = {TRACER.new_trace_id() for _ in range(100)}
    assert len(ids) == 100
    assert all(i.startswith(f"{os.getpid():x}.") for i in ids)


def test_chrome_events_format_and_export(tmp_path):
    enable_tracing()
    TRACER.clear()
    with TRACER.span("dur", cat="c", trace="tr.1", args={"a": 2}):
        pass
    TRACER.instant("pt", cat="c")
    evs = TRACER.chrome_events()
    dur = next(e for e in evs if e["name"] == "dur")
    pt = next(e for e in evs if e["name"] == "pt")
    assert dur["ph"] == "X" and dur["args"] == {"a": 2, "trace": "tr.1"}
    assert "dur" in dur and dur["cat"] == "c"
    assert pt["ph"] == "i" and pt["s"] == "t"
    out = tmp_path / "trace.json"
    TRACER.export_chrome_trace(out)
    doc = json.loads(out.read_text())
    assert {e["name"] for e in doc["traceEvents"]} >= {"dur", "pt"}
    assert abs(dur["ts"] / 1e6 - time.time()) < 60.0


def test_chrome_events_match_reference_for_the_same_spans():
    """The same recorded spans export to the same Chrome events (up to
    the per-process epoch and thread ids)."""
    spans = [("a", "c", 1.0, 2.5, "t.1", {"k": 1}), ("b", "c", 3.0, 3.0,
                                                       None, None)]
    out = []
    for mod in (jtrace, ttrace):
        t = mod.Tracer()
        t.epoch = 100.0
        t.enable()
        for name, cat, t0, t1, trace, args in spans:
            t.record(name, t0, t1, cat=cat, trace=trace, args=args)
        out.append([{k: v for k, v in e.items() if k not in ("tid", "pid")}
                    for e in t.chrome_events()])
    assert out[0] == out[1]


def test_merge_chrome_traces_sorts_by_ts(tmp_path):
    a = [{"name": "b", "ts": 2.0}, {"name": "a", "ts": 1.0}]
    b = [{"name": "c", "ts": 1.5}]
    out = tmp_path / "merged.json"
    merged = merge_chrome_traces([a, b], out)
    assert [e["name"] for e in merged] == ["a", "c", "b"]
    assert json.loads(out.read_text())["traceEvents"] == merged


def _coverage_events():
    def ev(trace, ts, dur):
        return {"name": "s", "ph": "X", "ts": ts, "dur": dur,
                "args": {"trace": trace}}
    return [
        ev("full", 0.0, 50.0), ev("full", 50.0, 50.0),
        ev("gappy", 0.0, 25.0), ev("gappy", 75.0, 25.0),
        ev("overlap", 0.0, 80.0), ev("overlap", 40.0, 60.0),
        {"name": "noise", "ph": "i", "ts": 1.0, "args": {"trace": "full"}},
        {"name": "untagged", "ph": "X", "ts": 0.0, "dur": 9.0, "args": {}},
    ]


def test_request_coverage_union_and_gaps():
    cov = request_coverage(_coverage_events())
    assert set(cov) == {"full", "gappy", "overlap"}
    assert cov["full"]["coverage"] == pytest.approx(1.0)
    assert cov["full"]["spans"] == 2
    assert cov["gappy"]["coverage"] == pytest.approx(0.5)
    assert cov["overlap"]["coverage"] == pytest.approx(1.0)
    assert cov["overlap"]["window_us"] == pytest.approx(100.0)
    assert cov == jtrace.request_coverage(_coverage_events())


class _FakeNvtx:
    def __init__(self):
        self.calls = []

    def range_push(self, name):
        self.calls.append(("push", name))

    def range_pop(self):
        self.calls.append(("pop",))


def test_annotate_opens_nvtx_ranges_only_with_a_card(monkeypatch):
    """``annotate=True`` pairs every span with an NVTX range when a CUDA
    device is present, and records the same span without one on the
    CPU."""
    fake = _FakeNvtx()
    monkeypatch.setattr(torch.cuda, "nvtx", fake)
    t = ttrace.Tracer(annotate=True).enable()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with t.span("cpu"):
        pass
    assert fake.calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with t.span("outer"):
        with t.span("inner"):
            pass
    assert fake.calls == [("push", "outer"), ("push", "inner"), ("pop",),
                          ("pop",)]
    assert [s.name for s in t.events()] == ["cpu", "inner", "outer"]
    t.annotate = False
    with t.span("plain"):
        pass
    assert len(fake.calls) == 4


# --------------------------------------------------------------- metrics ----
def test_counter_gauge_histogram_roundtrip():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "help", ("k",))
    c.inc(2, k="a")
    c.inc(k="a")
    assert c.value(k="a") == 3.0 and c.value(k="b") == 0.0
    g = reg.gauge("g", "help", ("k",))
    g.set(5, k="x")
    g.inc(-2, k="x")
    assert g.value(k="x") == 3.0
    h = reg.histogram("h_seconds", "help", ("k",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, k="q")
    snap = h.snapshot(k="q")
    assert snap["count"] == 3 and snap["sum"] == pytest.approx(5.55)
    assert snap["buckets"] == {0.1: 1, 1.0: 2}


def test_metric_label_mismatch_raises():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "", ("k",))
    with pytest.raises(ValueError, match="labels"):
        c.inc(1, wrong="a")
    with pytest.raises(ValueError, match="re-registered"):
        reg.gauge("c_total", "", ("k",))


def _fill(reg):
    reg.counter("req_total", "requests served", ("key",)).inc(
        4, key='p"ath\nx')
    h = reg.histogram("lat_seconds", "latency", ("key",), buckets=(0.5,))
    h.observe(0.25, key="a")
    h.observe(2.0, key="a")
    g = reg.gauge("weird", "h", ("k",))
    g.set(float("nan"), k="n")
    g.set(float("inf"), k="p")
    g.set(float("-inf"), k="m")
    reg.counter("esc_total", "h", ("k",)).inc(1, k='a\\b"c\nd')
    return reg


def test_prometheus_dump_contract_and_parity():
    text = _fill(MetricsRegistry()).dump()
    assert "# HELP req_total requests served" in text
    assert "# TYPE req_total counter" in text
    assert 'req_total{key="p\\"ath\\nx"} 4' in text
    assert 'lat_seconds_bucket{key="a",le="0.5"} 1' in text
    assert 'lat_seconds_bucket{key="a",le="+Inf"} 2' in text
    assert 'lat_seconds_sum{key="a"} 2.25' in text
    assert 'lat_seconds_count{key="a"} 2' in text
    assert 'weird{k="n"} NaN' in text and 'weird{k="p"} +Inf' in text
    assert 'weird{k="m"} -Inf' in text
    assert 'esc_total{k="a\\\\b\\"c\\nd"} 1' in text
    assert "} nan" not in text and "} inf" not in text
    # the same operations render the same exposition in both packages
    assert text == _fill(JaxRegistry()).dump()


def test_collect_is_json_roundtrippable():
    reg = MetricsRegistry()
    reg.counter("c_total", "h", ("k",)).inc(1, k="v")
    reg.histogram("h_s", "h", (), buckets=(1.0,)).observe(0.5)
    data = json.loads(json.dumps(reg.collect()))
    assert data["c_total"]["type"] == "counter"
    assert data["c_total"]["values"][0] == {"labels": {"k": "v"},
                                            "value": 1.0}
    assert data["h_s"]["values"][0]["count"] == 1


def test_warn_once_logs_once_counts_every(caplog):
    tag = "test-torch-warn-once-unique-tag"
    c = default_registry().counter("repro_obs_warnings_total",
                                   "warn_once firings by tag", ("tag",))
    before = c.value(tag=tag)
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs"):
        warn_once(tag, "the message")
        warn_once(tag, "the message")
    assert c.value(tag=tag) == before + 2
    assert sum("the message" in r.message for r in caplog.records) == 1


def test_publish_drop_counts_is_delta_based():
    enable_tracing()
    TRACER.clear()
    c = default_registry().counter(
        "repro_trace_dropped_total",
        "spans evicted from a full per-thread trace ring", ("thread",))
    label = threading.current_thread().name
    TRACER.publish_drop_counts()
    before = c.value(thread=label)
    for i in range(TRACER.ring_size + 5):
        TRACER.record(f"d{i}", 0.0, 1.0)
    assert TRACER.publish_drop_counts() >= 5
    assert c.value(thread=label) == before + 5
    TRACER.publish_drop_counts()
    assert c.value(thread=label) == before + 5


# ------------------------------------------- serve-path instrumentation ----
def test_trace_id_rides_submit_to_dispatcher_thread(tmp_path):
    mp = _bundle(tmp_path)
    enable_tracing()
    TRACER.clear()
    q = _queue(FlushPolicy(max_batch_rows=1 << 30, max_delay_s=0.005))
    q.start()
    try:
        q.submit(mp, _rows(3)).result(10)
    finally:
        q.close()
    spans = TRACER.events()
    sub = next(s for s in spans if s.name == "queue.submit")
    assert sub.trace is not None
    req = next(s for s in spans if s.name == "serve.request"
               and s.trace == sub.trace)
    assert req.thread == "repro-serve-dispatch"
    assert sub.thread != req.thread
    eng = next(s for s in spans if s.name == "engine.apply")
    assert eng.args["compile"] is True and eng.args["bucket"] == 8
    assert any(s.name == "batch.to_host" for s in spans)
    cov = request_coverage(TRACER.chrome_events())
    assert cov[sub.trace]["coverage"] >= 0.95


def test_inline_flush_spans_single_thread(tmp_path):
    mp = _bundle(tmp_path)
    enable_tracing()
    TRACER.clear()
    q = _queue(FlushPolicy(max_batch_rows=2))  # 3 rows > 2: inline
    q.submit(mp, _rows(3)).result(10)
    spans = TRACER.events()
    sub = next(s for s in spans if s.name == "queue.submit")
    req = next(s for s in spans if s.name == "serve.request")
    assert sub.trace == req.trace and sub.thread == req.thread


def test_engine_span_marks_first_call_at_a_bucket(tmp_path):
    from repro_torch.core.engine import InferenceEngine
    mp = _bundle(tmp_path)
    eng = InferenceEngine.get(mp, "cpu")
    enable_tracing()
    TRACER.clear()
    x = torch.from_numpy(_rows(5))
    eng.apply_batched(x)
    eng.apply_batched(x[:3])          # same bucket (8)
    eng.apply_batched(torch.from_numpy(_rows(9)))  # bucket 16
    flags = [(s.args["bucket"], s.args["compile"]) for s in TRACER.events()
             if s.name == "engine.apply"]
    assert flags == [(8, True), (8, False), (16, True)]


def test_kernel_dispatch_instant_on_the_plain_path():
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.kernels.fused_mlp.fused_mlp import pack_mlp
    packed = pack_mlp([torch.ones(2, 3)], [torch.zeros(3)], ["relu"],
                      device="cpu")
    enable_tracing()
    TRACER.clear()
    ops.fused_mlp_op(torch.ones(4, 2), packed)
    marks = [s for s in TRACER.events() if s.name == "kernel.dispatch"]
    assert len(marks) == 1 and marks[0].t0 == marks[0].t1
    assert marks[0].args == {"kernel": "fused_mlp", "path": "ref",
                             "tier": "f32"}


def test_untraced_requests_have_no_trace_id(tmp_path):
    mp = _bundle(tmp_path)
    disable_tracing()
    q = _queue()
    fut = q.submit(mp, _rows(2))
    q.flush(mp)
    fut.result(10)
    assert fut.trace is None
    assert all(s.name != "queue.submit" for s in TRACER.events())


def test_serve_metrics_published(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue()
    reg = default_registry()
    rows_done = reg.counter("repro_serve_rows_completed_total",
                            "rows completed", ("key",))
    before = rows_done.value(key=mp)
    q.submit(mp, _rows(6)).result(10)
    assert rows_done.value(key=mp) == before + 6
    assert reg.gauge("repro_serve_queue_depth_rows", "pending rows",
                     ("key",)).value(key=mp) == 0
    text = reg.dump()
    for family in ("repro_serve_queue_depth_rows",
                   "repro_serve_batch_occupancy",
                   "repro_serve_batch_latency_seconds_bucket",
                   "repro_serve_request_latency_seconds_bucket"):
        assert family in text


def test_latency_window_knob(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue(latency_window=4)
    st = q.stats(mp)
    assert st.latency_window == 4 and st._lat.maxlen == 4
    for lat in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        st.on_batch(requests=1, rows=1, bucket=8, reason="t",
                    busy_s=0.0, latencies_s=[lat])
    assert st.snapshot()["latency_p50_ms"] == pytest.approx(4500.0)
    assert _queue().latency_window == 2048


def test_controller_error_degrades_with_warning(tmp_path):
    class BoomController:
        def delay_for(self, key, stats):
            raise RuntimeError("boom")

        def batch_rows_for(self, key, stats):
            raise RuntimeError("boom")

    mp = _bundle(tmp_path)
    fallback = default_registry().counter(
        "repro_controller_static_fallback_total",
        "adaptive-controller decisions degraded to the static policy",
        ("key", "reason"))
    before = fallback.value(key=mp, reason="controller-error")
    q = _queue(FlushPolicy(max_batch_rows=4), controller=BoomController())
    q.submit(mp, _rows(6)).result(10)  # 6 > 4: the static trigger fires
    assert fallback.value(key=mp, reason="controller-error") > before


def test_snapshot_sorts_outside_lock():
    st = ServeStats("k", latency_window=8)
    st.on_batch(requests=1, rows=1, bucket=8, reason="t", busy_s=0.0,
                latencies_s=[3.0, 1.0, 2.0])
    assert st.snapshot()["latency_p50_ms"] == pytest.approx(2000.0)
    assert list(st._lat) == [3.0, 1.0, 2.0]


# ---------------------------------------------------------- alert machine ---
_ALERT_SCRIPTS = {
    "consecutive": ([2.0, 2.0, 2.0], dict(breach_n=3, clear_n=5)),
    "streak_reset": ([2.0, 2.0, 0.1, 2.0, 2.0], dict(breach_n=3, clear_n=5)),
    "hysteresis": ([1.5] + [0.9] * 5 + [0.6] * 3,
                   dict(breach_n=1, clear_n=3, hysteresis=0.8)),
}


@pytest.mark.parametrize("script", sorted(_ALERT_SCRIPTS))
def test_alert_machine_states_match_reference(script):
    values, kw = _ALERT_SCRIPTS[script]
    mine, ref = AlertMachine(**kw), jquality.AlertMachine(**kw)
    got = [mine.step(v, 0.5, 1.0) for v in values]
    assert got == [ref.step(v, 0.5, 1.0) for v in values]
    assert mine.transitions == ref.transitions


def test_alert_machine_needs_consecutive_breaches():
    m = AlertMachine(breach_n=3, clear_n=5)
    assert m.step(2.0, 0.5, 1.0) == OK
    assert m.step(2.0, 0.5, 1.0) == OK
    assert m.step(2.0, 0.5, 1.0) == CRITICAL
    assert m.transitions == 1


def test_alert_machine_hysteresis_and_clear():
    m = AlertMachine(breach_n=1, clear_n=3, hysteresis=0.8)
    assert m.step(1.5, 0.5, 1.0) == CRITICAL
    for _ in range(5):
        assert m.step(0.9, 0.5, 1.0) == CRITICAL
    m.step(0.6, 0.5, 1.0)
    m.step(0.6, 0.5, 1.0)
    assert m.step(0.6, 0.5, 1.0) == WARN


def test_alert_machine_without_budget_never_alerts():
    m = AlertMachine(breach_n=1)
    for _ in range(10):
        assert m.step(1e9, None, None) == OK


# ---------------------------------------------------------- shadow scorer ---
def test_observe_folds_ewma_like_reference():
    mine, ref = ShadowScorer(), jquality.ShadowScorer()
    for s in (mine, ref):
        s.set_budget("k", 0.1)
    seq = [0.01, 0.09] + [5.0] * 5 + [0.001] * 8
    states = [(mine.observe("k", rmse=v, max_abs=2 * v, rel_l2=v / 3),
               ref.observe("k", rmse=v, max_abs=2 * v, rel_l2=v / 3))
              for v in seq]
    assert all(a == b for a, b in states)
    a, b = mine.snapshot()["keys"]["k"], ref.snapshot()["keys"]["k"]
    assert a == b
    assert mine.snapshot()["keys"]["k"]["samples"] == len(seq)


def test_observe_folds_ewma_and_drives_alert():
    s = ShadowScorer()
    s.set_budget("k", 0.1)
    assert s.observe("k", rmse=0.01) == OK
    s.observe("k", rmse=0.09)
    assert s.snapshot()["keys"]["k"]["rmse_ewma"] == pytest.approx(0.03)
    for _ in range(20):
        state = s.observe("k", rmse=5.0)
    assert state == CRITICAL and s.worst_state() == CRITICAL
    assert s.state("other") == OK


def test_score_matches_reference_in_float64():
    rng = np.random.default_rng(3)
    yp = rng.normal(size=(17, 3)).astype(np.float32)
    yr = rng.normal(size=(17, 3)).astype(np.float32)
    mine, ref = ShadowScorer(), jquality.ShadowScorer()
    mine._score("k", "r", yp, yr, 17)
    ref._score("k", "r", yp, yr, 17)
    assert mine.snapshot()["keys"]["k"] == ref.snapshot()["keys"]["k"]
    d = yp.astype(np.float64) - yr.astype(np.float64)
    assert mine.snapshot()["keys"]["k"]["rmse_ewma"] == \
        float(np.sqrt(np.mean(d ** 2)))


def test_budget_falls_back_to_the_shared_registry():
    from repro_torch.quant.budgets import clear_budgets, set_rmse_budget
    s = ShadowScorer()
    try:
        set_rmse_budget("kb", 1.0)
        for _ in range(3):
            s.observe("kb", rmse=2.0)
        assert s.state("kb") == CRITICAL
        assert s.snapshot()["keys"]["kb"]["budget_rmse"] == 1.0
    finally:
        clear_budgets()


def test_submit_scores_thunks_on_worker():
    s = ShadowScorer(rate=1.0)
    yp = np.ones((4, 1), np.float32)
    yr = np.zeros((4, 1), np.float32)
    assert s.submit("k", pred=lambda: yp, ref=lambda: yr, rows=4)
    assert s.flush(10)
    snap = s.snapshot()["keys"]["k"]
    assert snap["rmse_ewma"] == pytest.approx(1.0)
    assert snap["max_abs_ewma"] == pytest.approx(1.0)
    assert snap["rows"] == 4
    s.stop()


def test_submit_backlog_drops_are_counted():
    s = ShadowScorer(rate=1.0, max_backlog=0)
    dropped = default_registry().counter(
        "repro_quality_dropped_total", "", ("key", "reason"))
    before = dropped.value(key="kb", reason="backlog")
    assert not s.submit("kb", pred=lambda: 0, ref=lambda: 0)
    assert dropped.value(key="kb", reason="backlog") == before + 1


def test_submit_ref_error_drops_not_kills_worker():
    s = ShadowScorer(rate=1.0)

    def boom():
        raise RuntimeError("replay failed")

    dropped = default_registry().counter(
        "repro_quality_dropped_total", "", ("key", "reason"))
    before = dropped.value(key="ke", reason="error")
    s.submit("ke", pred=lambda: np.zeros(2), ref=boom)
    assert s.flush(10)
    assert dropped.value(key="ke", reason="error") == before + 1
    s.submit("ke", pred=lambda: np.zeros(2), ref=lambda: np.zeros(2))
    assert s.flush(10)
    assert s.snapshot()["keys"]["ke"]["samples"] == 1
    s.stop()


def test_sample_rate_zero_and_one():
    s = ShadowScorer()
    assert not s.enabled and not s.sample()
    s.enable(rate=1.0)
    assert all(s.sample() for _ in range(32))
    s.disable()
    assert not s.sample()


# ------------------------------------------------------------ region hooks ---
def _self_region(tmp, mode, serving=None, n=4):
    """A region whose accurate function is the bundle's own forward:
    shadow scoring must find (near-)zero error on clean weights."""
    from repro_torch.core import approx_ml, tensor_functor
    from repro_torch.nn.serialize import load_model
    mp = _bundle(tmp)
    net, _, _ = load_model(mp, "cpu")

    def fn(x):
        with torch.no_grad():
            return {"out": net(x)}

    rngs = {"i": (0, n)}
    region = approx_ml(
        fn, name="quality_probe",
        inputs={"x": (tensor_functor("qx: [i, 0:2] = ([i, 0:2])"), rngs)},
        outputs={"out": (tensor_functor("qy: [i, 0:1] = ([i, 0:1])"),
                         rngs)},
        mode=mode, model=mp, serving=serving, device="cpu")
    return mp, region


def test_sync_region_shadow_scores_near_zero(tmp_path):
    mp, region = _self_region(tmp_path, "infer")
    SHADOW.enable(rate=1.0)
    SHADOW.set_budget(mp, 0.05)
    region(x=torch.from_numpy(_rows(4)))
    assert SHADOW.flush(30)
    snap = SHADOW.snapshot()["keys"][mp]
    assert snap["samples"] == 1 and snap["rows"] == 4
    assert snap["rmse_ewma"] < 1e-5
    assert snap["state"] == OK


def test_shadow_replays_a_copy_of_the_inputs(tmp_path):
    """The app may write into its buffers after the region returns: the
    replay runs on the copy taken at the call."""
    mp, region = _self_region(tmp_path, "infer")
    SHADOW.enable(rate=1.0)
    x = torch.from_numpy(_rows(4))
    region(x=x)
    x.fill_(1e6)  # the caller reuses its buffer at once
    assert SHADOW.flush(30)
    assert SHADOW.snapshot()["keys"][mp]["rmse_ewma"] < 1e-5


def test_async_region_shadow_span_rides_serve_trace(tmp_path):
    q = _queue()
    mp, region = _self_region(tmp_path, "infer_async", serving=q)
    enable_tracing()
    TRACER.clear()
    SHADOW.enable(rate=1.0)
    h = region(x=torch.from_numpy(_rows(4, seed=1)))
    q.flush(mp)
    h.result(10)
    assert SHADOW.flush(30)
    spans = TRACER.events()
    sub = next(s for s in spans if s.name == "queue.submit")
    shadow = next(s for s in spans if s.name == "quality.shadow")
    assert sub.trace is not None and shadow.trace == sub.trace
    assert shadow.thread == "repro-shadow-score"
    assert SHADOW.snapshot()["keys"][mp]["rmse_ewma"] < 1e-5


def test_disabled_shadow_never_samples_regions(tmp_path):
    mp, region = _self_region(tmp_path, "infer")
    SHADOW.disable()
    region(x=torch.from_numpy(_rows(4)))
    assert mp not in SHADOW.snapshot()["keys"]


# ------------------------------------------------------- stats event ring ---
def test_request_events_window_and_failures():
    st = ServeStats("k")
    st.on_batch(requests=2, rows=4, bucket=8, reason="t", busy_s=0.0,
                latencies_s=[0.1, 0.2])
    st.on_failure(requests=1, rows=2, reason="engine-error", busy_s=0.0)
    evs = st.request_events()
    assert len(evs) == 3
    oks = [e for e in evs if e[2]]
    bad = [e for e in evs if not e[2]]
    assert sorted(e[1] for e in oks) == [0.1, 0.2]
    assert len(bad) == 1 and math.isnan(bad[0][1])
    t_latest = max(e[0] for e in evs)
    assert st.request_events(window_s=1e-9, now=t_latest + 10) == []
    assert len(st.request_events(window_s=1e9, now=t_latest)) == 3


# ------------------------------------------------------------ SLO monitor ---
class _StubStats:
    def __init__(self, events):
        self._events = events

    def request_events(self, window_s=None, now=None):
        if window_s is None:
            return list(self._events)
        return [e for e in self._events if e[0] >= now - window_s]


_NOW = 1000.0
_SLO_CASES = {
    "burn": (dict(latency_threshold_s=0.1, latency_target=0.9,
                  availability_target=0.9, windows_s=(10.0, 100.0),
                  warn_burn=1.0, crit_burn=5.0, min_events=4),
             [(_NOW - 0.1 * i, 0.2 if i % 2 else 0.01, True)
              for i in range(20)]),
    "min_events": (dict(latency_threshold_s=0.1, latency_target=0.9,
                        windows_s=(10.0, 100.0), min_events=10),
                   [(_NOW - 0.1 * i, 9.9, True) for i in range(8)]),
    "old": (dict(latency_threshold_s=0.1, latency_target=0.9,
                 windows_s=(10.0, 100.0), min_events=10),
            [(_NOW - 50.0 - 0.1 * i, 9.9, True) for i in range(30)]),
    "failures": (dict(availability_target=0.9, windows_s=(10.0, 100.0),
                      min_events=4),
                 [(_NOW - 0.1 * i, float("nan"), False)
                  for i in range(10)]),
}


@pytest.mark.parametrize("case", sorted(_SLO_CASES))
def test_slo_evaluation_matches_reference(case):
    kw, events = _SLO_CASES[case]
    mine, ref = tslo.SLOMonitor(), jslo.SLOMonitor()
    mine.track("k", _StubStats(events), tslo.SLO(**kw))
    ref.track("k", _StubStats(events), jslo.SLO(**kw))
    for _ in range(3):  # the machines need consecutive evaluations
        assert mine.evaluate(now=_NOW) == ref.evaluate(now=_NOW)
    assert mine.states() == ref.states()


def test_slo_burn_rates_and_critical():
    kw, events = _SLO_CASES["burn"]
    MONITOR.track("kslo", _StubStats(events), SLO(**kw))
    r = MONITOR.evaluate(now=_NOW)["kslo"]["latency"]
    assert r["burn"]["10s"] == pytest.approx(5.0)
    assert r["burn"]["100s"] == pytest.approx(5.0)
    MONITOR.evaluate(now=_NOW)
    assert MONITOR.states()["kslo"]["latency"] == CRITICAL
    assert MONITOR.states()["kslo"]["availability"] == OK


def test_slo_min_events_guard_and_both_windows_must_burn():
    kw, events = _SLO_CASES["min_events"]
    MONITOR.track("kmin", _StubStats(events), SLO(**kw))
    assert MONITOR.evaluate(now=_NOW)["kmin"]["latency"]["value"] == 0.0
    kw, events = _SLO_CASES["old"]
    MONITOR.track("kold", _StubStats(events), SLO(**kw))
    r = MONITOR.evaluate(now=_NOW)["kold"]["latency"]
    assert r["burn"]["100s"] > 1.0 and r["burn"]["10s"] == 0.0
    assert r["value"] == 0.0


def test_slo_failed_requests_burn_availability():
    kw, events = _SLO_CASES["failures"]
    MONITOR.track("kav", _StubStats(events), SLO(**kw))
    r = MONITOR.evaluate(now=_NOW)["kav"]
    assert r["availability"]["value"] == pytest.approx(10.0)
    assert r["availability"]["budget_remaining"] == 0.0
    assert r["latency"]["value"] > 0.0


def test_slo_monitor_tracks_a_live_queue(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue()
    MONITOR.track(mp, q.stats(mp), SLO(min_events=1))
    for i in range(3):
        q.submit(mp, _rows(2, seed=i)).result(10)
    res = MONITOR.evaluate()[mp]
    assert res["availability"]["events"]["60s"] == 3
    assert res["availability"]["value"] == 0.0


def test_queue_healthy_and_snapshot(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue()
    assert q.healthy()
    q.submit(mp, _rows(2)).result(10)
    snap = q.snapshot()
    assert mp in snap["keys"] and snap["liveness"]["mode"] == "thread-free"
    q2 = _queue(FlushPolicy(max_batch_rows=1 << 30, max_delay_s=0.005))
    q2.start()
    try:
        assert q2.healthy() and q2.liveness()["dispatcher_alive"]
    finally:
        q2.stop()
    assert q2.healthy() and q2.liveness()["mode"] == "thread-free"
    q2.close()
