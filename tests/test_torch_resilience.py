"""Port parity of the resilience layer on the CPU: fault plans, retry
and split-retry, non-finite screening, the circuit breaker, the region's
accurate-path fallback, the dead dispatcher and ``close()``, against
``repro.resilience`` and ``repro.serve``.

The cases are those of tests/test_resilience.py minus the pod and
host-drop ones (not ported yet).  On top of them, the same scripted
inputs go through both packages: the same fault plan fires on the same
calls and leaves the same retry and split counts; the same breaker event
stream on an injected clock walks the same states.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.resilience.breaker as jbreaker  # noqa: E402
import repro.resilience.faults as jfaults  # noqa: E402
import repro.resilience.retry as jretry  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs.quality import SHADOW as JSHADOW  # noqa: E402
from repro.resilience import BREAKERS as JBREAKERS  # noqa: E402
from repro.resilience import FAULTS as JFAULTS  # noqa: E402
from repro.serve import FlushPolicy as JFlushPolicy  # noqa: E402
from repro.serve import ServeQueue as JServeQueue  # noqa: E402
from repro.serve.batcher import Batcher as JBatcher  # noqa: E402
from repro_torch.core import approx_ml, tensor_functor  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs.quality import SHADOW  # noqa: E402
from repro_torch.resilience import (BREAKERS, FAULTS,  # noqa: E402
                                    BreakerPolicy, CircuitBreaker,
                                    FaultInjector, InjectedFault,
                                    RetryPolicy, parse_plan)
from repro_torch.resilience import breaker as tbreaker  # noqa: E402
from repro_torch.resilience import faults as tfaults  # noqa: E402
from repro_torch.resilience import retry as tretry  # noqa: E402
from repro_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN  # noqa: E402
from repro_torch.serve import FlushPolicy, ServeQueue  # noqa: E402
from repro_torch.serve.batcher import Batcher, NonFiniteOutput  # noqa: E402
from repro_torch.serve.queue import ServeFuture, _StatsGate  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_globals():
    """Every test starts from quiet process-wide resilience state, in
    both packages."""
    def reset():
        for faults, breakers, shadow in ((FAULTS, BREAKERS, SHADOW),
                                         (JFAULTS, JBREAKERS, JSHADOW)):
            faults.clear()
            breakers.reset()
            breakers.enabled = True
            shadow.reset()
    reset()
    yield
    reset()


# ------------------------------------------------------------- helpers -----
_ifn = tensor_functor("rin: [i, 0:2] = ([i, 0:2])")
_ofn = tensor_functor("rout: [i, 0:1] = ([i, 0:1])")


def _bundle(tmp, name="m"):
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 2), [8], 1)
    return save_model(tmp / name, net, net.init(jax.random.PRNGKey(0)))


def _accurate(x):
    return {"out": x[:, :1] * 2 + x[:, 1:] * 0.5}


def _region(n, mode, model, serving=None):
    rngs = {"i": (0, n)}
    return approx_ml(_accurate, name="res", inputs={"x": (_ifn, rngs)},
                     outputs={"out": (_ofn, rngs)}, mode=mode, model=model,
                     serving=serving, device="cpu")


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


class _StubEngine:
    """Row-wise fake engine: y = 2x (first feature), with scriptable
    failures so the retry/split paths can be driven exactly.  ``wrap``
    turns the numpy result into the package's array type."""

    def __init__(self, wrap, fail_first=0, poison_value=None):
        self.wrap = wrap
        self.fail_first = fail_first
        self.poison_value = poison_value
        self.calls = 0

    def apply_batched(self, x, **kw):
        self.calls += 1
        xh = np.asarray(x)
        if self.calls <= self.fail_first:
            raise RuntimeError("transient stub failure")
        if self.poison_value is not None and \
                np.any(xh == self.poison_value):
            raise RuntimeError("poisoned row in batch")
        return self.wrap(xh[:, :1] * 2.0)


def _stub(**kw):
    return _StubEngine(lambda a: torch.from_numpy(np.array(a)), **kw)


def _queue(engine, *, attempts=1, **pol):
    pol.setdefault("max_batch_rows", 1 << 30)
    b = Batcher(engine_for=lambda key: engine,
                retry=RetryPolicy(max_attempts=attempts, base_delay_s=0.0,
                                  max_delay_s=0.0, jitter=0.0))
    return ServeQueue(FlushPolicy(**pol), batcher=b)


def _jqueue(engine, *, attempts=1, **pol):
    pol.setdefault("max_batch_rows", 1 << 30)
    b = JBatcher(engine_for=lambda key: engine,
                 retry=jretry.RetryPolicy(max_attempts=attempts,
                                          base_delay_s=0.0, max_delay_s=0.0,
                                          jitter=0.0))
    return JServeQueue(JFlushPolicy(**pol), batcher=b)


# ---------------------------------------------------------- fault plans ----
def test_fault_plan_parse_and_validation():
    rules = parse_plan("engine.apply:raise:after=2,n=1;"
                       "pod.flush:drop:pid=1,stall=9")
    assert len(rules) == 2
    assert rules[0].site == "engine.apply" and rules[0].after == 2
    assert rules[1].mode == "drop" and rules[1].stall_s == 9.0
    for bad in ("nosite:raise", "engine.apply:nomode", "engine.apply",
                "engine.apply:raise:badparam"):
        with pytest.raises(ValueError):
            parse_plan(bad)
        with pytest.raises(ValueError):
            jfaults.parse_plan(bad)
    assert tfaults.SITES == jfaults.SITES and tfaults.MODES == jfaults.MODES


def _fire_pattern(mod, spec, calls, site="engine.apply", key=None):
    f = mod.FaultInjector(spec)
    out = []
    for _ in range(calls):
        try:
            rule = f.fire(site, key=key)
            out.append(rule.mode if rule is not None else "-")
        except mod.InjectedFault:
            out.append("raise")
    return out, f.snapshot()


@pytest.mark.parametrize("spec", [
    "engine.apply:raise:after=2,every=2,n=2",
    "engine.apply:raise:p=0.5,seed=7",
    "engine.apply:nan:p=0.3,seed=11,after=1",
    "engine.apply:inf:every=3;engine.apply:raise:p=0.25,seed=2",
    "engine.apply:corrupt:n=1,scale=0.25",
])
def test_same_plan_fires_on_the_same_calls_in_both_packages(spec):
    mine, msnap = _fire_pattern(tfaults, spec, 40)
    ref, rsnap = _fire_pattern(jfaults, spec, 40)
    assert mine == ref
    assert msnap == rsnap
    assert any(m != "-" for m in mine)


def test_fault_triggers_after_every_n():
    fired, _ = _fire_pattern(tfaults,
                             "engine.apply:raise:after=2,every=2,n=2", 10)
    assert [i for i, m in enumerate(fired) if m == "raise"] == [2, 4]


def test_fault_probability_is_seed_deterministic():
    a, _ = _fire_pattern(tfaults, "engine.apply:raise:p=0.5,seed=7", 32)
    b, _ = _fire_pattern(tfaults, "engine.apply:raise:p=0.5,seed=7", 32)
    assert a == b and 0 < a.count("raise") < 32


def test_fault_pid_and_key_scoping(monkeypatch):
    f = FaultInjector("engine.apply:raise:pid=1;batcher.scatter:nan:key=abc")
    monkeypatch.delenv("REPRO_PROCESS_ID", raising=False)
    assert f.fire("engine.apply") is None
    monkeypatch.setenv("REPRO_PROCESS_ID", "1")
    with pytest.raises(InjectedFault):
        f.fire("engine.apply")
    assert f.fire("batcher.scatter", key="zzz") is None
    rule = f.fire("batcher.scatter", key="x/abc/y")
    assert rule is not None and rule.mode == "nan"


def test_fault_stall_sleeps():
    f = FaultInjector("engine.apply:stall:stall=0.05,n=1")
    t0 = time.monotonic()
    rule = f.fire("engine.apply")
    assert rule is not None and time.monotonic() - t0 >= 0.05


def test_faults_armed_from_the_environment(tmp_path):
    """``REPRO_FAULTS`` arms the process-wide injector at import, in a
    fresh process (reloading the module here would leave the batcher
    and the engine holding the old injector)."""
    import os
    import subprocess
    import sys
    code = ("from repro_torch.resilience import FAULTS\n"
            "assert FAULTS.enabled and len(FAULTS.rules) == 2\n"
            "assert [r.site for r in FAULTS.rules] == "
            "['engine.apply', 'batcher.scatter']\n")
    env = dict(os.environ, REPRO_FAULTS="engine.apply:raise:n=1;"
               "batcher.scatter:nan:every=2",
               PYTHONPATH=os.pathsep.join(sys.path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120, cwd=str(tmp_path))


def test_retry_policy_backoff_caps():
    p = RetryPolicy(max_attempts=5, base_delay_s=0.01, max_delay_s=0.04,
                    jitter=0.0)
    assert p.delay_for(0) == 0.01
    assert p.delay_for(1) == 0.02
    assert p.delay_for(10) == 0.04
    j = RetryPolicy(jitter=0.5, seed=1)
    d = [j.delay_for(0) for _ in range(8)]
    assert all(0.005 <= x <= 0.01 for x in d)


def test_retry_jitter_matches_reference_for_a_seed():
    import random
    mine, ref = tretry.RetryPolicy(seed=5), jretry.RetryPolicy(seed=5)
    assert [mine.delay_for(k) for k in range(6)] == \
        [ref.delay_for(k) for k in range(6)]
    a, b = random.Random(9), random.Random(9)
    assert [mine.delay_for(k, a) for k in range(6)] == \
        [ref.delay_for(k, b) for k in range(6)]


# -------------------------------------------------------- dispatch paths ---
def test_retry_resolves_transient_failure():
    eng = _stub(fail_first=2)
    q = _queue(eng, attempts=3)
    x = _rows(4)
    fut = q.submit("k", x)
    q.flush("k")
    np.testing.assert_allclose(np.asarray(fut.result(5)), x[:, :1] * 2.0,
                               rtol=1e-6)
    assert eng.calls == 3
    snap = q.stats("k").snapshot()
    assert snap["batches"] == 1 and snap["batches_failed"] == 0


def test_split_retry_isolates_poisoned_request():
    eng = _stub(poison_value=np.float32(666.0))
    q = _queue(eng, attempts=1)
    good_a, good_b = _rows(3, seed=1), _rows(2, seed=2)
    poison = _rows(3, seed=3)
    poison[1, 0] = 666.0
    fa = q.submit("k", good_a)
    fp = q.submit("k", poison)
    fb = q.submit("k", good_b)
    q.flush("k")
    np.testing.assert_allclose(np.asarray(fa.result(5)),
                               good_a[:, :1] * 2.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(fb.result(5)),
                               good_b[:, :1] * 2.0, rtol=1e-6)
    with pytest.raises(RuntimeError, match="poisoned"):
        fp.result(5)
    snap = q.stats("k").snapshot()
    assert snap["requests_failed"] == 1 and snap["rows_failed"] == 3
    assert q.depth("k") == 0


@pytest.mark.parametrize("plan", [
    "engine.apply:raise:n=1",
    "engine.apply:raise:p=0.5,seed=3",
])
def test_same_plan_same_retries_and_splits_in_both_packages(plan, tmp_path):
    """The fault sites sit in each package's engine; here a stub engine
    fires the plan itself, so both batchers see the same failures."""
    results = {}
    for pkg in ("torch", "jax"):
        faults = FAULTS if pkg == "torch" else JFAULTS
        raw = _stub if pkg == "torch" else (
            lambda **kw: _StubEngine(jnp.asarray, **kw))

        class _Faulty:
            def __init__(self):
                self.inner = raw(poison_value=np.float32(666.0))
                self.calls = 0

            def apply_batched(self, x, **kw):
                self.calls += 1
                faults.fire("engine.apply", key="k")
                return self.inner.apply_batched(x, **kw)

        eng = _Faulty()
        metrics = tmetrics if pkg == "torch" else jmetrics
        mk = _queue if pkg == "torch" else _jqueue
        retries = metrics.counter("repro_resilience_retries_total", "",
                                  ("key",))
        splits = metrics.counter("repro_resilience_split_retries_total", "",
                                 ("key",))
        key = f"plan-{pkg}-{plan}"
        r0, s0 = retries.value(key=key), splits.value(key=key)
        faults.configure(plan)
        q = mk(eng, attempts=2)
        xs = [_rows(2 + i % 3, seed=i) for i in range(6)]
        xs[4][0, 1] = 666.0
        futs = [q.submit(key, x) for x in xs]
        q.flush(key)
        outcome = []
        for f in futs:
            try:
                outcome.append(np.asarray(f.result(5)).round(5).tolist())
            except Exception as e:
                outcome.append(type(e).__name__)
        results[pkg] = {"outcome": outcome, "calls": eng.calls,
                        "retries": retries.value(key=key) - r0,
                        "splits": splits.value(key=key) - s0,
                        "fires": faults.rules[0].snapshot()["fires"],
                        "failed": q.stats(key).snapshot()["requests_failed"]}
        faults.clear()
    assert results["torch"] == results["jax"]
    assert results["torch"]["splits"] >= 1  # the poisoned request split


def test_engine_apply_fault_site_in_both_engines(tmp_path):
    """The engines' own ``engine.apply`` site: the same plan fires on the
    same batches, and the same requests fail and retry."""
    from repro.core.engine import InferenceEngine as JaxEngine
    from repro_torch.core.engine import InferenceEngine
    mp = _bundle(tmp_path)
    plan = "engine.apply:raise:every=2"
    outcomes = {}
    for pkg in ("torch", "jax"):
        faults = FAULTS if pkg == "torch" else JFAULTS
        if pkg == "torch":
            q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu",
                           batcher=Batcher(device="cpu", retry=RetryPolicy(
                               max_attempts=2, base_delay_s=0.0,
                               jitter=0.0)))
        else:
            q = JServeQueue(JFlushPolicy(max_batch_rows=1 << 30),
                            batcher=JBatcher(retry=jretry.RetryPolicy(
                                max_attempts=2, base_delay_s=0.0,
                                jitter=0.0)))
        faults.configure(plan)
        res = []
        for i in range(4):
            f = q.submit(mp, _rows(3, seed=i))
            q.flush(mp)
            res.append(np.asarray(f.result(5)).shape)
        outcomes[pkg] = (res, faults.rules[0].snapshot()["calls"],
                         faults.rules[0].snapshot()["fires"])
        faults.clear()
    InferenceEngine.invalidate()
    JaxEngine.invalidate()
    assert outcomes["torch"] == outcomes["jax"]
    assert outcomes["torch"][2] == 4  # every first attempt failed once


def test_engine_load_failure_fails_batch_once_no_retry():
    calls = []

    def engine_for(key):
        calls.append(key)
        raise FileNotFoundError("no bundle")

    b = Batcher(engine_for=engine_for,
                retry=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), batcher=b)
    f1, f2 = q.submit("k", _rows(2)), q.submit("k", _rows(2, 1))
    q.flush("k")
    for f in (f1, f2):
        with pytest.raises(FileNotFoundError):
            f.result(5)
    assert len(calls) == 1
    assert q.stats("k").snapshot()["batches_failed"] == 1


def test_nonfinite_screening_isolates_poisoned_request():
    q = _queue(_stub())
    FAULTS.configure("batcher.scatter:nan:n=1")
    xa, xb = _rows(3, seed=4), _rows(2, seed=5)
    fa = q.submit("k", xa)
    fb = q.submit("k", xb)
    q.flush("k")
    with pytest.raises(NonFiniteOutput):
        fa.result(5)
    np.testing.assert_allclose(np.asarray(fb.result(5)), xb[:, :1] * 2.0,
                               rtol=1e-6)
    snap = q.stats("k").snapshot()
    assert snap["requests_failed"] == 1 and snap["rows_failed"] == 3
    assert snap["batches"] == 1


def test_nonfinite_never_silently_returned():
    class _NaNEngine:
        def apply_batched(self, x, **kw):
            return torch.full((int(x.shape[0]), 1), float("nan"))

    q = _queue(_NaNEngine())
    f = q.submit("k", _rows(2))
    q.flush("k")
    with pytest.raises(NonFiniteOutput):
        f.result(5)


def test_screening_flags_each_request_of_a_dirty_batch():
    """An infinity in one request's rows fails that request alone; the
    landed flags are one per row."""
    class _InfEngine:
        def apply_batched(self, x, **kw):
            y = torch.as_tensor(x)[:, :1] * 2.0
            y[y > 100] = float("inf")
            return y

    q = _queue(_InfEngine())
    xs = [_rows(3, seed=1), _rows(4, seed=2), _rows(2, seed=3)]
    xs[1][2, 0] = 1e3
    futs = [q.submit("k", x) for x in xs]
    q.flush("k")
    with pytest.raises(NonFiniteOutput):
        futs[1].result(5)
    for i in (0, 2):
        np.testing.assert_allclose(np.asarray(futs[i].result(5)),
                                   xs[i][:, :1] * 2.0, rtol=1e-6)


def test_scatter_raise_is_retried_and_rows_unchanged():
    """A raise at ``batcher.scatter`` (after the landing) is retried like
    any landing failure; the rows of the second attempt are served."""
    eng = _stub()
    q = _queue(eng, attempts=2)
    FAULTS.configure("batcher.scatter:raise:n=1")
    x = _rows(5, seed=6)
    fut = q.submit("k", x)
    q.flush("k")
    np.testing.assert_allclose(np.asarray(fut.result(5)), x[:, :1] * 2.0,
                               rtol=1e-6)
    assert eng.calls == 2
    assert FAULTS.rules[0].snapshot()["fires"] == 1


def test_engine_nan_fault_poisons_every_row(tmp_path):
    from repro_torch.core.engine import InferenceEngine
    mp = _bundle(tmp_path)
    eng = InferenceEngine.get(mp, "cpu")
    FAULTS.configure(f"engine.apply:nan:key={mp},n=1")
    x = torch.from_numpy(_rows(5))
    assert torch.isnan(eng.apply_batched(x)).all()
    assert torch.isfinite(eng.apply_batched(x)).all()
    InferenceEngine.invalidate()


def test_engine_corrupt_fault_moves_weights_until_reload(tmp_path):
    from repro_torch.core.engine import InferenceEngine
    mp = _bundle(tmp_path)
    eng = InferenceEngine.get(mp, "cpu")
    x = torch.from_numpy(_rows(5))
    clean = eng.apply_batched(x)
    w0 = eng.net.layers[0].w.clone()
    FAULTS.configure("engine.apply:corrupt:n=1,scale=0.25")
    bad = eng.apply_batched(x)
    assert torch.equal(eng.net.layers[0].w, w0 + 0.25)
    assert not torch.equal(bad, clean)
    FAULTS.clear()
    assert torch.equal(eng.apply_batched(x), bad)  # persistent
    eng.reload()
    assert torch.equal(eng.apply_batched(x), clean)
    InferenceEngine.invalidate()


# ------------------------------------------------------- dead dispatcher ---
def test_dispatcher_crash_fails_pending_futures_fast(monkeypatch):
    q = ServeQueue(FlushPolicy(max_batch_rows=4, max_delay_s=60.0,
                               block_timeout_s=60.0),
                   batcher=Batcher(engine_for=lambda k: _stub()))

    def boom():
        raise RuntimeError("boom")

    q.start()
    try:
        assert q.healthy()
        time.sleep(0.2)  # let the thread reach its idle wait first
        monkeypatch.setattr(q, "_due_locked", boom)
        monkeypatch.setattr(threading, "excepthook", lambda _a: None)
        t0 = time.monotonic()
        fut = q.submit("k", _rows(4))
        with pytest.raises(RuntimeError, match="dispatcher thread died"):
            fut.result(10)
        assert time.monotonic() - t0 < 5.0
        assert not q.healthy()
        assert q.liveness()["crashed"] is not None
        with pytest.raises(RuntimeError, match="dispatcher thread died"):
            q.submit("k", _rows(1))
        assert q.depth() == 0
        assert q.stats("k").snapshot()["requests_failed"] == 1
    finally:
        q._thread.join(10)


# ------------------------------------------------------------- close() -----
def test_close_drain_serves_pending_then_refuses():
    q = _queue(_stub())
    x = _rows(3)
    fut = q.submit("k", x)
    q.close(drain=True)
    np.testing.assert_allclose(np.asarray(fut.result(5)), x[:, :1] * 2.0,
                               rtol=1e-6)
    with pytest.raises(RuntimeError, match="closed"):
        q.submit("k", _rows(1))
    q.close(drain=True)  # idempotent
    t = SHADOW._thread
    assert t is None or not t.is_alive()


def test_close_no_drain_fails_pending():
    q = _queue(_stub())
    fut = q.submit("k", _rows(2))
    q.close(drain=False)
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(5)
    assert q.depth() == 0


# ----------------------------------------------------------- the breaker ---
def _breaker(clock, mod=tbreaker, **kw):
    kw.setdefault("min_samples", 4)
    kw.setdefault("failure_threshold", 0.5)
    kw.setdefault("open_cooldown_s", 1.0)
    kw.setdefault("probe_n", 2)
    kw.setdefault("probe_every", 2)
    return mod.CircuitBreaker("b", mod.BreakerPolicy(**kw), clock=clock)


def test_breaker_full_cycle():
    now = [0.0]
    b = _breaker(lambda: now[0])
    assert b.state == CLOSED and b.allow()
    for _ in range(6):
        b.record_failure()
    assert b.state == OPEN
    assert not b.allow()
    now[0] += 1.5
    assert b.allow()
    assert b.state == HALF_OPEN
    b.record_success()
    b.record_success()
    assert b.state == CLOSED
    b.record_failure()
    assert b.state == CLOSED


def test_breaker_probe_failure_reopens_and_restamps():
    now = [0.0]
    b = _breaker(lambda: now[0])
    for _ in range(6):
        b.record_failure()
    now[0] += 1.5
    assert b.allow() and b.state == HALF_OPEN
    b.record_failure()
    assert b.state == OPEN
    now[0] += 0.5
    assert not b.allow()
    now[0] += 1.0
    assert b.allow() and b.state == HALF_OPEN


def test_breaker_half_open_throttles_traffic():
    now = [0.0]
    b = _breaker(lambda: now[0], probe_every=4)
    for _ in range(6):
        b.record_failure()
    now[0] += 1.5
    assert sum(b.allow() for _ in range(9)) == 3


def _event_stream(mod, events):
    """Feed ``events`` ('a' allow, 'f' failure, 's' success, 't<dt>'
    advance the clock) to a fresh breaker; the state after each."""
    now = [0.0]
    b = _breaker(lambda: now[0], mod=mod, min_samples=3, probe_n=2,
                 probe_every=3)
    out = []
    for ev in events:
        if ev == "a":
            out.append(("a", b.allow()))
        elif ev == "f":
            b.record_failure()
        elif ev == "s":
            b.record_success()
        else:
            now[0] += float(ev[1:])
        out.append(b.state)
    return out, b.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_event_stream_matches_reference(seed):
    rng = np.random.default_rng(seed)
    events = [str(e) if e != "t" else f"t{rng.uniform(0, 0.8):.3f}"
              for e in rng.choice(["a", "f", "f", "s", "t"], size=80)]
    mine, ref = _event_stream(tbreaker, events), _event_stream(jbreaker,
                                                                events)
    assert mine == ref
    assert {OPEN, HALF_OPEN} <= set(mine[0])


def test_breaker_quality_critical_trips_closed_breaker():
    key = "qkey"
    b = BREAKERS.configure(key, BreakerPolicy(open_cooldown_s=60.0))
    SHADOW.set_budget(key, 0.01)
    for _ in range(5):
        SHADOW.observe(key, rmse=1.0)
    assert SHADOW.state(key) == "CRITICAL"
    assert not BREAKERS.allow(key)
    assert b.state == OPEN


def test_breaker_board_disabled_is_transparent():
    BREAKERS.enabled = False
    for _ in range(32):
        BREAKERS.record_failure("x")
    assert BREAKERS.allow("x")
    assert BREAKERS.snapshot() == {}


@settings(max_examples=30)
@given(stream=st.integers(min_value=0, max_value=2 ** 20 - 1),
       threshold=st.floats(min_value=0.3, max_value=0.7))
def test_breaker_never_flaps_at_trip_threshold(stream, threshold):
    policy = BreakerPolicy(failure_threshold=threshold, min_samples=4,
                           open_cooldown_s=1.0, probe_n=2, probe_every=2)
    b = CircuitBreaker("p", policy, clock=lambda: 0.0)
    trips, prev = 0, b.state
    obs_since_closed = 0
    for i in range(20):
        bit = (stream >> i) & 1
        b.allow()
        if bit:
            b.record_failure()
        else:
            b.record_success()
        cur = b.state
        if prev == CLOSED:
            obs_since_closed += 1
        assert not (prev == OPEN and cur == CLOSED)
        if prev == CLOSED and cur == OPEN:
            trips += 1
            assert obs_since_closed >= policy.min_samples
        prev = cur
    assert trips <= 1


@settings(max_examples=20)
@given(steps=st.integers(min_value=1, max_value=40),
       dt=st.floats(min_value=0.01, max_value=0.5))
def test_breaker_reopen_rate_bounded_by_cooldown(steps, dt):
    now = [0.0]
    b = _breaker(lambda: now[0], open_cooldown_s=1.0)
    for _ in range(6):
        b.record_failure()
    half_opens = 0
    for _ in range(steps):
        now[0] += dt
        prev = b.state
        b.allow()
        if prev == OPEN and b.state == HALF_OPEN:
            half_opens += 1
        b.record_failure()
    assert half_opens <= now[0] / 1.0 + 1


# ------------------------------------------------------ region fallback ----
def test_region_infer_falls_back_when_breaker_open(tmp_path):
    bundle = str(_bundle(tmp_path))
    b = BREAKERS.configure(bundle, BreakerPolicy(min_samples=2,
                                                 open_cooldown_s=60.0))
    region = _region(4, "infer", bundle)
    x = torch.from_numpy(_rows(4, seed=7))
    surrogate = region(x=x)["out"]
    b.record_failure()
    b.record_failure()
    assert b.state == OPEN
    fallback = tmetrics.counter("repro_resilience_fallback_total", "",
                                ("key", "path"))
    before = fallback.value(key=bundle, path="infer")
    out = region(x=x)["out"]
    assert torch.equal(out, _accurate(x)["out"])
    assert not torch.allclose(out, surrogate)
    assert fallback.value(key=bundle, path="infer") == before + 1


def test_region_infer_failure_falls_back_and_counts(tmp_path):
    """A failed synchronous inference degrades to the accurate path and
    counts a breaker failure; with the board disabled it raises."""
    region = _region(3, "infer", str(tmp_path / "missing_bundle"))
    x = torch.from_numpy(_rows(3, seed=2))
    out = region(x=x)["out"]
    assert torch.equal(out, _accurate(x)["out"])
    assert BREAKERS.get(region.model_path).snapshot()["samples"] == 1
    BREAKERS.enabled = False
    with pytest.raises(Exception):
        region(x=x)


def test_region_infer_async_falls_back_when_breaker_open(tmp_path):
    bundle = str(_bundle(tmp_path))
    b = BREAKERS.configure(bundle, BreakerPolicy(min_samples=2,
                                                 open_cooldown_s=60.0))
    b.record_failure()
    b.record_failure()
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
    region = _region(3, "infer_async", bundle, serving=q)
    x = torch.from_numpy(_rows(3, seed=8))
    res = region(x=x)
    assert not res.deferred() and res.done()
    assert torch.equal(res.result()["out"], _accurate(x)["out"])
    assert q.depth() == 0


def test_async_result_falls_back_on_dispatch_failure(tmp_path):
    bundle = str(_bundle(tmp_path))
    b = Batcher(engine_for=lambda key: (_ for _ in ()).throw(
                    RuntimeError("engine down")),
                retry=RetryPolicy(max_attempts=1, base_delay_s=0.0))
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), batcher=b)
    region = _region(3, "infer_async", bundle, serving=q)
    x = torch.from_numpy(_rows(3, seed=9))
    res = region(x=x)
    assert res.deferred()
    q.flush()
    assert torch.equal(res.result(5)["out"], _accurate(x)["out"])
    BREAKERS.enabled = False
    res = region(x=x)
    q.flush()
    with pytest.raises(RuntimeError, match="engine down"):
        res.result(5)


def test_async_nonfinite_falls_back_to_accurate(tmp_path):
    """Screened rows resolve the handle through the accurate path."""
    bundle = str(_bundle(tmp_path))
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
    region = _region(4, "infer_async", bundle, serving=q)
    FAULTS.configure(f"engine.apply:nan:key={bundle}")
    x = torch.from_numpy(_rows(4, seed=3))
    res = region(x=x)
    q.flush()
    assert torch.equal(res.result(5)["out"], _accurate(x)["out"])
    snap = q.stats(bundle).snapshot()
    assert snap["requests_failed"] == 1 and snap["batches"] == 0


# ------------------------------------------------------- future / gates ----
def test_serve_future_first_resolution_wins():
    q = ServeQueue(FlushPolicy(), device="cpu")
    f = ServeFuture(q, "k")
    assert f.set_result(torch.ones(2))
    assert not f.set_exception(RuntimeError("late loser"))
    assert torch.equal(f.result(1), torch.ones(2))
    g = ServeFuture(q, "k")
    assert g.set_exception(RuntimeError("first"))
    assert not g.set_result(torch.ones(2))
    with pytest.raises(RuntimeError, match="first"):
        g.result(1)


def test_stats_gate_kill_suppresses_zombie_delivery():
    class _Rec:
        def __init__(self):
            self.batches, self.failures = [], []

        def on_batch(self, **kw):
            self.batches.append(kw)

        def on_failure(self, **kw):
            self.failures.append(kw)

    rec = _Rec()
    gate = _StatsGate(rec)
    assert gate.kill()
    gate.on_batch(rows=4)
    gate.on_failure(rows=4)
    assert rec.batches == [] and rec.failures == []
    live = _StatsGate(rec)
    live.on_batch(rows=2)
    assert not live.kill()
    assert len(rec.batches) == 1
