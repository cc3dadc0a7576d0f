"""Port parity of the pod's observability and dropout tolerance on the
CPU: ``PodHealth``, ``/healthz`` naming pod offenders, the ``pod_flush``
watchdog, the traced ``pod.agree`` span, ``pod_snapshot`` across
processes and the host-drop drill, against ``repro.launch.multihost``,
``repro.obs`` and ``repro.serve``.

The cases are the twins of tests/test_obs.py's pod cases and
tests/test_resilience.py's pod-health and watchdog cases.  In one
process: the same ``PodHealth`` calls leave the same state in both
packages, the degrade latch drives ``/healthz``, a hung ``dispatch_pod``
degrades to local serving within the watchdog, and a traced single
process ``pod_flush`` records ``pod.agree``.  In one spawned CPU pod of
two processes (``tests/torch_pod_workers.py``, with ``REPRO_TRACE=1``):
a traced pod flush, ``pod_snapshot`` gathering both hosts' spans, then
the host-drop drill with a 3 s stall and a 1 s watchdog, held to
``multihost.host_drop_failures``.
"""
import time

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import multihost as jmultihost  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.launch import dryrun, multihost  # noqa: E402
from repro_torch.obs import (SHADOW, TRACER, ObsServer,  # noqa: E402
                             enable_tracing)
from repro_torch.resilience import BREAKERS, FAULTS, RetryPolicy  # noqa: E402
from repro_torch.serve import FlushPolicy, ServeQueue  # noqa: E402
from repro_torch.serve.batcher import Batcher  # noqa: E402
from torch_pod_workers import DRILL_STALL_S, DRILL_WATCHDOG_S  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_globals():
    def reset():
        for health in (multihost.POD_HEALTH, jmultihost.POD_HEALTH):
            health.reset()
        FAULTS.clear()
        BREAKERS.reset()
        SHADOW.reset()
        TRACER.enabled = False
        TRACER.clear()
        InferenceEngine.invalidate()
    reset()
    yield
    reset()


def _bundle(tmp, seed=0):
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 2), [16], 1)
    return save_model(tmp / "m", net, net.init(jax.random.PRNGKey(seed)))


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


# ------------------------------------------------------------ pod health ---
def test_pod_health_rounds_and_degrade():
    snaps = []
    for h in (multihost.PodHealth(), jmultihost.PodHealth()):
        assert h.beat() == 1 and h.beat() == 2
        assert h.check_round(1) == ()  # no store solo: name nobody
        h.mark_degraded([2, 1])
        h.mark_degraded([1])
        assert h.degraded_at is not None
        snaps.append(h.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0] == {"round": 2, "degraded": True, "offenders": [1, 2]}


def test_pod_health_rejoin_with_stub_barrier():
    h = multihost.PodHealth()
    h.mark_degraded([1])
    assert not h.try_rejoin(timeout_s=0.2,
                            barrier_fn=lambda: time.sleep(5))  # hangs
    assert h.degraded

    def fails():
        raise RuntimeError("peer gone")
    assert not h.try_rejoin(timeout_s=1.0, barrier_fn=fails)
    assert h.degraded
    assert h.try_rejoin(timeout_s=1.0, barrier_fn=lambda: None)
    assert not h.degraded and h.offenders == ()
    assert h.degraded_at is None


def test_healthz_names_pod_offenders():
    ready, detail = ObsServer().health()
    assert ready and detail["pod"] == multihost.POD_HEALTH.snapshot()
    multihost.POD_HEALTH.mark_degraded([1])
    ready, detail = ObsServer().health()
    assert not ready
    assert "pod:host-1" in detail["critical"]
    assert detail["pod"]["offenders"] == [1]
    multihost.POD_HEALTH.reset()
    multihost.POD_HEALTH.mark_degraded()  # nobody named
    ready, detail = ObsServer().health()
    assert "pod:degraded" in detail["critical"]
    multihost.POD_HEALTH.reset()
    ready, detail = ObsServer().health()
    assert ready and "pod:host-1" not in detail["critical"]


class _StubEngine:
    """Row-wise fake engine: y = 2x (first feature)."""

    def apply_batched(self, x, **kw):
        return torch.as_tensor(x)[:, :1] * 2.0


def test_pod_flush_watchdog_degrades_instead_of_hanging(monkeypatch):
    """Single-process harness for the watchdog: dispatch_pod hangs (a
    dropped peer); the flush degrades within the timeout and still
    serves every request locally."""
    eng = _StubEngine()

    class _HangingBatcher(Batcher):
        def dispatch_pod(self, key, requests, stats, *, ctx=None,
                         reason="pod"):
            time.sleep(30.0)

    b = _HangingBatcher(engine_for=lambda key: eng,
                        retry=RetryPolicy(max_attempts=1))
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), batcher=b)
    monkeypatch.setattr(multihost, "is_multiprocess", lambda: True)
    monkeypatch.setenv(multihost.ENV_POD_WATCHDOG, "0.3")
    x = _rows(4, seed=11)
    fut = q.submit("k", x)
    t0 = time.monotonic()
    q.pod_flush("k")
    assert time.monotonic() - t0 < 5.0  # degraded, did not wait 30 s
    np.testing.assert_allclose(fut.result(5).numpy(), x[:, :1] * 2.0,
                               rtol=1e-6)
    assert multihost.POD_HEALTH.degraded
    assert q.stats("k").snapshot()["flush_reasons"] == {"pod_degraded": 1}
    # while degraded, later flushes skip the collective entirely
    fut2 = q.submit("k", x)
    t0 = time.monotonic()
    q.pod_flush("k")
    assert time.monotonic() - t0 < 1.0
    assert fut2.done()


def test_pod_key_agreement_watchdog_falls_back_to_local_keys(monkeypatch):
    """A peer that never joins the key agreement: the survivor degrades
    and serves its own keys locally."""
    eng = _StubEngine()
    b = Batcher(engine_for=lambda key: eng,
                retry=RetryPolicy(max_attempts=1))
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), batcher=b)
    monkeypatch.setattr(multihost, "is_multiprocess", lambda: True)
    monkeypatch.setattr(multihost, "allgather_bytes",
                        lambda data: time.sleep(30.0))
    monkeypatch.setenv(multihost.ENV_POD_WATCHDOG, "0.3")
    futs = [q.submit(k, _rows(2, seed=i)) for i, k in enumerate("ba")]
    assert q.pod_flush() == 4
    assert all(f.done() for f in futs)
    assert multihost.POD_HEALTH.degraded


def test_pod_flush_single_process_traced(tmp_path):
    mp = _bundle(tmp_path)
    enable_tracing()
    TRACER.clear()
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
    fut = q.submit(mp, _rows(4))
    q.pod_flush(mp)
    fut.result(30)
    spans = TRACER.events()
    sub = next(s for s in spans if s.name == "queue.submit")
    req = next(s for s in spans if s.name == "serve.request")
    assert sub.trace == req.trace
    agree = next(s for s in spans if s.name == "pod.agree")
    assert agree.cat == "pod"
    assert {s.name for s in spans if s.cat == "pod"} >= {
        "pod.agree", "batch.apply", "batch.to_host"}
    scatter = next(s for s in spans if s.name == "batch.scatter")
    assert scatter.args["requests"] == 1


def test_pod_flush_screens_nonfinite_rows(tmp_path):
    """The pod path hands its landed rows to the futures as dispatch
    does: NaN rows fail their request with ``NonFiniteOutput``, traced
    as ``batch.nonfinite``, and count as a failure, not a batch."""
    from repro_torch.serve.batcher import NonFiniteOutput
    mp = _bundle(tmp_path)
    enable_tracing()
    TRACER.clear()
    FAULTS.configure(f"engine.apply:nan:key={mp},n=1")
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
    futs = [q.submit(mp, _rows(3, seed=i)) for i in range(2)]
    q.pod_flush(mp)
    for f in futs:
        with pytest.raises(NonFiniteOutput):
            f.result(30)
    bad = next(s for s in TRACER.events() if s.name == "batch.nonfinite")
    assert (bad.args["requests"], bad.args["rows"]) == (2, 6)
    snap = q.stats(mp).snapshot()
    assert snap["pod_batches"] == 0 and snap["requests_failed"] == 2


def test_allgather_bytes_single_process():
    for mod in (multihost, jmultihost):
        assert mod.allgather_bytes(b"payload \x00\xff") == \
            [b"payload \x00\xff"]
        assert mod.allgather_bytes(b"") == [b""]


# -------------------------------------------------------- entry points -----
def test_dryrun_obs_needs_pod_smoke(capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--obs"])
    assert "--obs needs --pod-smoke" in capsys.readouterr().err


def test_multihost_main_needs_a_mode(capsys):
    with pytest.raises(SystemExit):
        multihost.main([])
    assert "nothing to do" in capsys.readouterr().err


def test_pod_entry_points_default_to_the_card(monkeypatch):
    """Without ``device`` a pod child runs on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the child would run on it")
    monkeypatch.delenv(multihost.ENV_POD_DEVICE, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.pod_device()
    with pytest.raises(multihost.PodWorkerError, match="no CUDA device"):
        multihost.spawn_local_pod(1, "os:getcwd", timeout_s=60.0)


def test_host_drop_failures_name_each_breach():
    ok = [{"pid": 0, "resolved": 2, "submitted": 2, "equal": True,
           "degraded": True, "offenders": [1], "critical": ["pod:host-1"],
           "degrade_latency_s": 1.2, "elapsed_s": 1.3},
          {"pid": 1, "resolved": 2, "submitted": 2, "equal": True,
           "degraded": False, "offenders": [], "critical": [],
           "degrade_latency_s": None, "elapsed_s": 4.0}]
    assert multihost.host_drop_failures(ok, 3.0, 1.0) == []
    bad = [dict(ok[0], resolved=1, offenders=[2], critical=[],
                degrade_latency_s=3.5, elapsed_s=20.0), ok[1]]
    got = "\n".join(multihost.host_drop_failures(bad, 3.0, 1.0))
    for what in ("lost 1 requests", "offenders [2]", "pod:host-1",
                 "degrade latency", "did not drain"):
        assert what in got
    never = [dict(ok[0], degraded=False), ok[1]]
    assert "never degraded" in multihost.host_drop_failures(never, 3.0,
                                                            1.0)[0]


# ------------------------------------------------ spawned pod of two -------
@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    return multihost.spawn_local_pod(
        2, "torch_pod_workers:traced_pod_and_drill",
        (str(tmp_path_factory.mktemp("pod_obs")),), timeout_s=240.0,
        extra_env={"REPRO_TRACE": "1"}, device="cpu")


def test_pod_flush_trace_ids_across_two_processes(pod):
    assert [r["pid"] for r in pod] == [0, 1]
    for r in pod:
        assert r["enabled"] and r["equal"]
        sub = next(s for s in r["spans"] if s["name"] == "queue.submit")
        req = next(s for s in r["spans"] if s["name"] == "serve.request")
        assert sub["trace"] is not None and sub["trace"] == req["trace"]
        assert any(s["name"] == "pod.agree" and s["cat"] == "pod"
                   for s in r["spans"])
    # ids minted on different processes never collide in a merged trace
    t0, t1 = (next(s["trace"] for s in r["spans"]
                   if s["name"] == "queue.submit") for r in pod)
    assert t0 != t1


def test_pod_snapshot_gathers_both_hosts(pod):
    for r in pod:
        assert r["snap_processes"] == [0, 1]
        assert all(n >= 1 for n in r["snap_agree"])


def test_host_drop_drill_two_processes(pod):
    drill = [r["drill"] for r in pod]
    assert multihost.host_drop_failures(drill, DRILL_STALL_S,
                                        DRILL_WATCHDOG_S) == []
    r0 = drill[0]
    assert r0["degraded"] and r0["offenders"] == [1]
    assert "pod:host-1" in r0["critical"]
    assert r0["degrade_latency_s"] < DRILL_WATCHDOG_S + 5.0
    assert all(r["resolved"] == r["submitted"] for r in drill)
