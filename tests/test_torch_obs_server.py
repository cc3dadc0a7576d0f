"""Port parity of the observability endpoint, the metrics report and the
single-process pod snapshots on the CPU, against ``repro.obs``.

The cases are the twins of tests/test_quality.py's obs-server and
exposition cases and tests/test_obs.py's flight-recorder, report and
exposition edge cases.  On top of them:

* ``validate_exposition`` gives the reference's verdict (the same
  summary, or the same error message) on every text of a corpus;
* ``metrics_report`` renders the same snapshot JSON to the same text as
  the reference's, in markdown and ``--json``, with and without a trace
  and for a list of snapshots;
* ``ObsServer.health()`` imports nothing of ``repro`` (the reference's
  lazy ``repro.launch.multihost`` import must not have been copied);
* ``pod_snapshot`` all-gathers every rank's snapshot in a
  ``torch.distributed`` group of two ranks, and raises when that gather
  fails rather than pass one rank's view off as the pod's;
* the CLI's demo self-check passes on the CPU (``--device cpu``).
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.obs.metrics_report as jreport  # noqa: E402
import repro.obs.server as jserver  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
import repro_torch.obs.metrics_report as treport  # noqa: E402
import repro_torch.obs.pod as tpod  # noqa: E402
import repro_torch.obs.server as tserver  # noqa: E402
from repro_torch.obs import (CRITICAL, MONITOR, SHADOW, SLO,  # noqa: E402
                             TRACER, MetricsRegistry, ObsServer,
                             enable_tracing, local_snapshot,
                             merge_pod_trace, pod_quality_report,
                             pod_snapshot, validate_exposition)
from repro_torch.serve import FlushPolicy, ServeQueue  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _obs_reset():
    """SHADOW/MONITOR/TRACER are process-global: leave them as these
    tests found them (off, empty)."""
    from repro_torch.core.engine import InferenceEngine
    InferenceEngine.invalidate()
    yield
    SHADOW.disable()
    SHADOW.rate = 0.0
    SHADOW.flush(10)
    SHADOW.reset()
    MONITOR.untrack()
    TRACER.enabled = False
    TRACER.clear()
    InferenceEngine.invalidate()


def _bundle(tmp, seed=0):
    """A reference-written MLP bundle (the port reads the same format)."""
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 2), [16], 1)
    return save_model(tmp / "m", net, net.init(jax.random.PRNGKey(seed)))


def _rows(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed)
                            .normal(size=(n, 2)).astype(np.float32))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


class _StubStats:
    def __init__(self, events):
        self._events = events

    def request_events(self, window_s=None, now=None):
        return list(self._events)


# ------------------------------------------------------------ obs server ---
def test_obs_server_routes_and_healthz_flip():
    server = ObsServer().start()
    try:
        for route in ("/", "/metrics", "/varz", "/tracez"):
            code, _ = _get(server.url(route))
            assert code == 200, route
        code, _ = _get(server.url("/nope"))
        assert code == 404
        code, body = _get(server.url("/healthz"))
        assert code == 200 and json.loads(body)["status"] == "ok"
        from repro_torch.launch.multihost import POD_HEALTH
        assert json.loads(body)["pod"] == POD_HEALTH.snapshot()
        assert not json.loads(body)["pod"]["degraded"]
        SHADOW.set_budget("kbad", 0.01)
        for _ in range(5):
            SHADOW.observe("kbad", rmse=9.0)
        assert SHADOW.state("kbad") == CRITICAL
        code, body = _get(server.url("/healthz"))
        detail = json.loads(body)
        assert code == 503 and "quality:kbad" in detail["critical"]
        code, text = _get(server.url("/metrics"))
        assert code == 200
        assert validate_exposition(text)["samples"] > 0
        assert 'repro_quality_rmse{key="kbad"}' in text
    finally:
        server.stop()


def test_obs_server_dead_queue_unready():
    class DeadQueue:
        def healthy(self):
            return False

        def snapshot(self):
            return {}

    server = ObsServer().start().watch_queue("dead", DeadQueue())
    try:
        code, body = _get(server.url("/healthz"))
        assert code == 503
        assert "queue:dead" in json.loads(body)["critical"]
    finally:
        server.stop()


def test_obs_server_watches_a_live_port_queue(tmp_path, monkeypatch):
    """A real threaded queue: ready while its dispatcher lives, its
    stats in /varz, 503 naming it once the dispatcher dies."""
    import threading
    mp = _bundle(tmp_path)
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20, max_delay_s=0.002),
                   device="cpu").start()
    server = ObsServer().start().watch_queue("serve", q)
    try:
        q.submit(mp, _rows(3)).result(10)
        code, body = _get(server.url("/healthz"))
        assert code == 200 and json.loads(body)["queues"] == {"serve": True}
        doc = json.loads(_get(server.url("/varz"))[1])
        assert doc["queues"]["serve"]["keys"][mp]["rows_completed"] == 3

        def boom():
            raise RuntimeError("dispatcher down")

        monkeypatch.setattr(threading, "excepthook", lambda _a: None)
        monkeypatch.setattr(q, "_due_locked", boom)
        with q._cv:
            q._cv.notify_all()
        q._thread.join(10)
        code, body = _get(server.url("/healthz"))
        assert code == 503 and "queue:serve" in json.loads(body)["critical"]
    finally:
        server.stop()


def test_varz_carries_quality_and_slo():
    SHADOW.set_budget("kv", 1.0)
    SHADOW.observe("kv", rmse=0.5)
    MONITOR.track("kv", _StubStats([]), SLO())
    server = ObsServer().start()
    try:
        _, body = _get(server.url("/varz"))
        doc = json.loads(body)
        assert doc["quality"]["keys"]["kv"]["rmse_ewma"] == 0.5
        assert "kv" in doc["slo"]["keys"]
        assert "repro_quality_rmse" in doc["metrics"]
        assert doc["pid"] == os.getpid()
        tz = json.loads(_get(server.url("/tracez"))[1])
        assert set(tz) == {"enabled", "dropped", "total_events", "events"}
    finally:
        server.stop()


def test_tracez_keeps_the_last_spans():
    enable_tracing()
    TRACER.clear()
    for i in range(5):
        TRACER.record(f"s{i}", 0.0, 1.0)
    server = ObsServer(tracez_limit=2).start()
    try:
        doc = json.loads(_get(server.url("/tracez"))[1])
        assert doc["total_events"] == 5
        assert [e["name"] for e in doc["events"]] == ["s3", "s4"]
    finally:
        server.stop()


def test_health_imports_nothing_of_repro():
    """The reference's ``health()`` imports ``repro.launch.multihost``;
    the port's must leave every ``repro.*`` module unimported even
    where the reference package is importable."""
    code = (
        "import sys\n"
        "from repro_torch.obs.server import ObsServer\n"
        "ready, detail = ObsServer().health()\n"
        "assert ready and detail['pod'] == {'round': 0, 'degraded': False,\n"
        "                                   'offenders': []}, detail\n"
        "bad = [m for m in sys.modules if m == 'repro'\n"
        "       or m.startswith('repro.') or m == 'jax']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120, cwd=str(ROOT))


# ----------------------------------------------------- exposition parsing ---
def test_validate_exposition_rejects_malformed():
    with pytest.raises(ValueError, match="unparseable"):
        validate_exposition("no value here\n")
    with pytest.raises(ValueError, match="invalid sample value"):
        validate_exposition("m 12x\n")
    with pytest.raises(ValueError, match="malformed label"):
        validate_exposition('m{k=unquoted} 1\n')
    with pytest.raises(ValueError, match="duplicate"):
        validate_exposition('m{k="a"} 1\nm{k="a"} 2\n')


def test_validate_exposition_histogram_contract():
    ok = ('# TYPE h histogram\n'
          'h_bucket{le="1"} 1\nh_bucket{le="+Inf"} 2\n'
          'h_sum 3.5\nh_count 2\n')
    assert validate_exposition(ok)["families"] == {"h": "histogram"}
    with pytest.raises(ValueError, match="missing _sum"):
        validate_exposition('# TYPE h histogram\n'
                            'h_bucket{le="+Inf"} 1\nh_count 1\n')
    with pytest.raises(ValueError, match="!= _count"):
        validate_exposition('# TYPE h histogram\n'
                            'h_bucket{le="+Inf"} 1\nh_sum 1\nh_count 2\n')
    with pytest.raises(ValueError, match="not cumulative"):
        validate_exposition('# TYPE h histogram\n'
                            'h_bucket{le="1"} 5\nh_bucket{le="+Inf"} 2\n'
                            'h_sum 1\nh_count 2\n')
    with pytest.raises(ValueError, match=r"missing le=.\+Inf"):
        validate_exposition('# TYPE h histogram\n'
                            'h_bucket{le="1"} 1\nh_sum 1\nh_count 1\n')


_EXPOSITIONS = {
    "empty": "",
    "comments": "# a comment\n#another\n\n",
    "counter": "# HELP c_total a counter\n# TYPE c_total counter\n"
               'c_total{k="x"} 3\n',
    "timestamp": "m 1 1700000000\n",
    "specials": 'm{k="n"} NaN\nm{k="p"} +Inf\nm{k="m"} -Inf\nm{k="e"} 1e-3\n',
    "escapes": 'esc{k="a\\\\b\\"c\\nd"} 1\n',
    "two_labels": 'm{a="1",b="2"} 0\n',
    "bad_help": "# HELP 9bad help\n",
    "bad_type": "# TYPE m sometype\n",
    "short_type": "# TYPE m\n",
    "no_value": "no value here\n",
    "bad_value": "m 12x\n",
    "unquoted": "m{k=unquoted} 1\n",
    "no_comma": 'm{a="1" b="2"} 1\n',
    "duplicate": 'm{k="a"} 1\nm{k="a"} 2\n',
    "hist_ok": '# TYPE h histogram\nh_bucket{le="1"} 1\n'
               'h_bucket{le="+Inf"} 2\nh_sum 3.5\nh_count 2\n',
    "hist_labels": '# TYPE h histogram\nh_bucket{k="a",le="+Inf"} 1\n'
                   'h_sum{k="a"} 1\nh_count{k="a"} 1\n'
                   'h_bucket{k="b",le="+Inf"} 2\nh_sum{k="b"} 1\n'
                   'h_count{k="b"} 1\n',
    "hist_no_sum": '# TYPE h histogram\nh_bucket{le="+Inf"} 1\nh_count 1\n',
    "hist_no_count": '# TYPE h histogram\nh_bucket{le="+Inf"} 1\nh_sum 1\n',
    "hist_no_buckets": "# TYPE h histogram\nh_sum 1\nh_count 1\n",
    "hist_no_le": '# TYPE h histogram\nh_bucket{k="a"} 1\nh_sum 1\n'
                  'h_count 1\n',
    "hist_not_cumulative": '# TYPE h histogram\nh_bucket{le="1"} 5\n'
                           'h_bucket{le="+Inf"} 2\nh_sum 1\nh_count 2\n',
    "hist_no_inf": '# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\n'
                   "h_count 1\n",
}


@pytest.mark.parametrize("name", sorted(_EXPOSITIONS))
def test_validate_exposition_verdicts_match_reference(name):
    text = _EXPOSITIONS[name]

    def verdict(fn):
        try:
            return "ok", fn(text)
        except ValueError as e:
            return "invalid", str(e)

    assert verdict(validate_exposition) == \
        verdict(jserver.validate_exposition)


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "invalid"])
def test_validate_cli_matches_reference(valid, tmp_path, capsys):
    path = tmp_path / "scrape.prom"
    path.write_text(_EXPOSITIONS["hist_ok" if valid else "hist_no_inf"])
    rc = tserver.main(["--validate", str(path)])
    ours = capsys.readouterr()
    assert rc == jserver.main(["--validate", str(path)]) == (0 if valid
                                                             else 1)
    ref = capsys.readouterr()
    assert (ours.out, ours.err) == (ref.out, ref.err)


def test_port_env_sets_the_cli_default(monkeypatch):
    monkeypatch.setenv(tserver.ENV_OBS_PORT, "0")
    assert tserver.ENV_OBS_PORT == jserver.ENV_OBS_PORT == "REPRO_OBS_PORT"


# --------------------------------------------- exposition edge cases --------
def test_dump_escapes_backslash_quote_newline():
    reg = MetricsRegistry()
    reg.counter("esc_total", "h", ("k",)).inc(1, k='a\\b"c\nd')
    text = reg.dump()
    assert 'esc_total{k="a\\\\b\\"c\\nd"} 1' in text
    assert len([ln for ln in text.splitlines()
                if ln.startswith("esc_total{")]) == 1
    validate_exposition(text)


def test_dump_renders_nan_and_infinities():
    reg = MetricsRegistry()
    g = reg.gauge("weird", "h", ("k",))
    g.set(float("nan"), k="n")
    g.set(float("inf"), k="p")
    g.set(float("-inf"), k="m")
    text = reg.dump()
    assert 'weird{k="n"} NaN' in text
    assert 'weird{k="p"} +Inf' in text
    assert 'weird{k="m"} -Inf' in text
    assert validate_exposition(text)["samples"] == 3
    assert "} nan" not in text and "} inf" not in text


def test_empty_registry_dumps_and_validates():
    reg = MetricsRegistry()
    assert validate_exposition(reg.dump()) == {"samples": 0,
                                               "families": {}}
    reg.counter("quiet_total", "h", ("k",))
    assert validate_exposition(reg.dump()) == {
        "samples": 0, "families": {"quiet_total": "counter"}}


def test_histogram_dump_satisfies_exposition_contract():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s", "h", ("k",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 7.0):
        h.observe(v, k="a")
    h.observe(2.5, k="b")
    text = reg.dump()
    assert 'lat_s_bucket{k="a",le="+Inf"} 4' in text
    assert 'lat_s_count{k="a"} 4' in text
    assert 'lat_s_bucket{k="b",le="0.1"} 0' in text
    assert validate_exposition(text)["families"]["lat_s"] == "histogram"


# ------------------------------------------------------- flight recorder ----
def test_local_and_pod_snapshot_single_process():
    enable_tracing()
    TRACER.clear()
    TRACER.instant("snap.mark", cat="test")
    local = local_snapshot()
    assert any(e["name"] == "snap.mark" for e in local["events"])
    assert isinstance(local["metrics"], dict) and "pid" in local
    assert set(local) == {"process", "pid", "host", "events", "metrics",
                          "quality", "slo"}
    snaps = pod_snapshot()
    assert len(snaps) == 1 and snaps[0]["process"] == local["process"]
    json.dumps(snaps)  # JSON-able, as the all-gather needs


def test_process_index_reads_the_env_without_a_group(monkeypatch):
    monkeypatch.setenv("REPRO_PROCESS_ID", "3")
    assert tpod._process_index() == 3
    assert local_snapshot()["process"] == 3
    monkeypatch.setenv("REPRO_PROCESS_ID", "")
    assert tpod._process_index() == 0


def test_pod_snapshot_raises_past_one_rank(monkeypatch):
    """Past one rank the snapshots ride ``multihost.allgather_bytes``: a
    failed gather raises, a working one returns every rank's view in
    process order."""
    from repro_torch.launch import multihost
    monkeypatch.setattr(multihost, "is_multiprocess", lambda: True)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    assert tpod._process_index() == 1
    with pytest.raises((RuntimeError, ValueError)):
        pod_snapshot()  # no group: the all-gather cannot run
    peer = json.dumps({"process": 0, "events": []}).encode()
    monkeypatch.setattr(multihost, "allgather_bytes",
                        lambda data: [peer, data])
    snaps = pod_snapshot()
    assert [s["process"] for s in snaps] == [0, 1]
    assert set(snaps[1]) == set(local_snapshot())


_POD_WORKER = r"""
import sys
import torch.distributed as dist
from repro_torch.obs import local_snapshot, pod_snapshot
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
try:
    assert local_snapshot()["process"] == rank
    snaps = pod_snapshot()
    print("snapshots", [s["process"] for s in snaps])
    dist.barrier()
finally:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [1, 2])
def test_pod_snapshot_in_a_gloo_group(world):
    """Rank from ``torch.distributed``; one rank snapshots itself, two
    all-gather both ranks' snapshots, in rank order, on every rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _POD_WORKER, str(r), str(world), str(port)],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.strip())
    finally:
        for p in procs:
            p.kill()
    assert outs == [f"snapshots {list(range(world))}"] * world


def test_merge_pod_trace_and_quality_report(tmp_path):
    snaps = [{"process": 0, "events": [{"name": "a", "ph": "X", "ts": 2.0,
                                        "dur": 1.0, "pid": 1, "tid": 1}],
              "quality": {"keys": {"b1": {"rmse_ewma": 0.0123456,
                                          "state": "WARN",
                                          "samples": 7}}}},
             {"process": 1, "events": [{"name": "b", "ph": "X", "ts": 1.0,
                                        "dur": 1.0, "pid": 2, "tid": 1}],
              "quality": {"keys": {"b2": {"rmse_ewma": None}}}}]
    merged = merge_pod_trace(snaps, str(tmp_path / "pod.json"))
    assert [e["name"] for e in merged if e.get("ph") == "X"] == ["b", "a"]
    from repro.obs.pod import merge_pod_trace as jmerge
    from repro.obs.pod import pod_quality_report as jquality_report
    assert merged == jmerge(snaps)
    assert pod_quality_report(snaps) == jquality_report(snaps)
    assert "| 0 | b1 | 0.01235 | WARN | 7 |" in pod_quality_report(snaps)
    assert pod_quality_report([{"process": 0}]) == \
        jquality_report([{"process": 0}]) == \
        "(no shadow-quality samples on any host)"


# -------------------------------------------------------- metrics report ----
def _populate(reg):
    reg.counter("c_total", "a counter", ("k",)).inc(3, k="x")
    reg.gauge("g", "a gauge").set(-2.5)
    h = reg.histogram("lat_seconds", "latency", ("k",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.7, 0.9, 3.0):
        h.observe(v, k="x")
    h.observe(0.2, k="y")
    reg.gauge("repro_quality_rmse", "h", ("key",)).set(0.02, key="b1")
    reg.gauge("repro_quality_max_abs", "h", ("key",)).set(0.5, key="b1")
    reg.gauge("repro_quality_alert_state", "h", ("key",)).set(2, key="b1")
    reg.counter("repro_quality_samples_total", "h",
                ("key", "region")).inc(7, key="b1", region="r")
    burn = reg.gauge("repro_slo_burn_rate", "h", ("key", "slo", "window"))
    burn.set(14.4, key="b1", slo="latency", window="30s")
    burn.set(0.5, key="b1", slo="availability", window="120s")
    reg.gauge("repro_slo_alert_state", "h", ("key", "slo")).set(
        2, key="b1", slo="latency")
    return reg


def _report(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("source", ["port", "reference"])
@pytest.mark.parametrize("mode", ["markdown", "json", "trace", "pod"])
def test_metrics_report_renders_the_same_text(mode, source, tmp_path,
                                              capsys):
    reg = _populate(MetricsRegistry() if source == "port" else JRegistry())
    collected = reg.collect()
    mpath = tmp_path / "metrics.json"
    if mode == "pod":
        mpath.write_text(json.dumps([
            {"process": 0, "host": "h0", "metrics": collected},
            {"process": 1, "host": "h1", "metrics": collected}]))
    else:
        mpath.write_text(json.dumps(collected))
    argv = ["--metrics", str(mpath)]
    if mode in ("json", "pod"):
        argv.append("--json" if mode == "json" else "--markdown")
    if mode == "trace":
        enable_tracing()
        TRACER.clear()
        TRACER.record("batch.apply", 0.0, 0.010, cat="batch")
        TRACER.record("batch.apply", 0.0, 0.030, cat="batch")
        TRACER.record("batch.gather", 0.0, 0.001, cat="batch")
        tpath = tmp_path / "trace.json"
        TRACER.export_chrome_trace(tpath)
        argv += ["--trace", str(tpath)]
    ours = _report(treport, argv, capsys)
    ref = _report(jreport, argv, capsys)
    assert ours == ref
    assert ours[0] == 0 and "c_total" in ours[1]


def test_metrics_report_renders_markdown(tmp_path, capsys):
    reg = MetricsRegistry()
    reg.counter("c_total", "a counter", ("k",)).inc(3, k="x")
    reg.histogram("lat_seconds", "latency", ("k",),
                  buckets=(0.1, 1.0)).observe(0.5, k="x")
    mpath = tmp_path / "metrics.json"
    mpath.write_text(json.dumps(reg.collect()))
    enable_tracing()
    TRACER.clear()
    TRACER.record("batch.apply", 0.0, 0.010, cat="batch")
    tpath = tmp_path / "trace.json"
    TRACER.export_chrome_trace(tpath)
    rc = treport.main(["--metrics", str(mpath), "--trace", str(tpath),
                       "--markdown"])
    assert rc in (0, None)
    out = capsys.readouterr().out
    assert "c_total" in out and "lat_seconds" in out
    assert "batch.apply" in out


def test_quantile_interpolation_from_buckets():
    q = treport.quantile_from_buckets
    buckets = {1.0: 10, 2.0: 20, float("inf"): 20}
    assert q(buckets, 20, 0.50) == pytest.approx(1.0)
    assert q(buckets, 20, 0.75) == pytest.approx(1.5)
    assert q(buckets, 20, 0.25) == pytest.approx(0.5)
    buckets = {1.0: 10, float("inf"): 40}
    assert q(buckets, 40, 0.99) == 1.0
    assert q({}, 0, 0.5) is None
    for b, n, p in (({1.0: 10, 2.0: 20, float("inf"): 20}, 20, 0.9),
                    ({0.5: 0, 1.0: 3}, 3, 0.0), ({1.0: 5}, 9, 0.99)):
        assert q(b, n, p) == jreport.quantile_from_buckets(b, n, p)


def test_metrics_report_json_mode(tmp_path, capsys):
    reg = MetricsRegistry()
    reg.counter("c_total", "h", ("k",)).inc(3, k="x")
    h = reg.histogram("lat_seconds", "h", ("k",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.7, 0.9):
        h.observe(v, k="x")
    mpath = tmp_path / "metrics.json"
    mpath.write_text(json.dumps(reg.collect()))
    assert treport.main(["--metrics", str(mpath), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    snap = doc["snapshots"][0]
    assert snap["metrics"]["c_total"]["values"][0]["value"] == 3.0
    hq = snap["histogram_quantiles"]["lat_seconds"][0]
    assert hq["count"] == 4
    assert 0.0 < hq["p50"] <= hq["p90"] <= hq["p99"] <= 1.0


def test_metrics_report_renders_quality_section(tmp_path, capsys):
    reg = MetricsRegistry()
    reg.gauge("repro_quality_rmse", "h", ("key",)).set(0.02, key="b1")
    reg.gauge("repro_quality_alert_state", "h", ("key",)).set(2, key="b1")
    reg.counter("repro_quality_samples_total", "h",
                ("key", "region")).inc(7, key="b1", region="r")
    mpath = tmp_path / "metrics.json"
    mpath.write_text(json.dumps(reg.collect()))
    treport.main(["--metrics", str(mpath), "--markdown"])
    out = capsys.readouterr().out
    assert "Surrogate quality (shadow-scored)" in out
    assert "| b1 | 0.02 |" in out and "CRITICAL" in out


def test_metrics_report_needs_an_input():
    with pytest.raises(SystemExit):
        treport.main([])


# ------------------------------------------------------------------ CLI ----
def test_demo_self_check_on_the_cpu():
    """``python -m repro_torch.obs.server --demo --self-check --device
    cpu``: a serve round trip through the port's queue, shadow scoring
    against the bundle's Sequential, a tracked SLO, then every route
    scraped and the exposition validated."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.server", "--demo",
         "--self-check", "--device", "cpu"], env=_env(), cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "self-check ok" in out.stdout


def test_demo_workload_scores_near_zero(monkeypatch):
    q = tserver._demo_workload("cpu")
    try:
        snap = SHADOW.snapshot()["keys"]
        (key, st), = snap.items()
        assert st["samples"] == 4 and st["rmse_ewma"] < 1e-6
        assert q.stats(key).snapshot()["rows_completed"] == 32
        assert key in MONITOR.tracked_keys()
    finally:
        q.stop()
