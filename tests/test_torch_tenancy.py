"""Port parity of the multi-tenant control plane and weight residency on
the CPU: token buckets, deficit round robin, the tenant board, the
queue's DRR flush order under overload, and the residency manager's LRU
with the engine's one reload path, against ``repro.serve``.

The cases are those of tests/test_tenancy.py (the hypothesis properties
included) minus the adaptive controller's QoS bounds (those are in
tests/test_torch_controller.py).  On top of them the same scripts run through both
packages: the same DRR arrival script gives the same flush order, the
same clock script the same bucket levels, the same loads the same
eviction victims.
"""
import threading

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.serve.residency as jresidency  # noqa: E402
import repro.serve.tenancy as jtenancy  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.serve import (RESIDENCY, FlushPolicy,  # noqa: E402
                               ResidencyManager, ServeQueue, TenantBoard,
                               TenantSpec, TenantThrottled)
from repro_torch.serve import tenancy as ttenancy  # noqa: E402
from repro_torch.serve.tenancy import (DEFAULT_TENANT,  # noqa: E402
                                       DeficitRoundRobin, TokenBucket)


@pytest.fixture(autouse=True)
def _clean_engine_state():
    InferenceEngine.invalidate()
    RESIDENCY.set_budget(None)
    yield
    InferenceEngine.invalidate()
    RESIDENCY.set_budget(None)
    RESIDENCY.reset_stats()


def _bundle(tmp, name="m"):
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 2), [8], 1)
    return save_model(tmp / name, net, net.init(jax.random.PRNGKey(0)))


def _rows(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 2)).astype(np.float32))


def _queue(policy, **kw):
    return ServeQueue(policy, device="cpu", **kw)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------------- token bucket ------
@settings(max_examples=30)
@given(seed=st.integers(0, 10**6), rate=st.floats(0.5, 200.0),
       burst=st.floats(1.0, 100.0))
def test_token_bucket_refill_monotone(seed, rate, burst):
    """Between takes the level never decreases, even when the clock
    jitters backwards, and never exceeds the burst."""
    rng = np.random.default_rng(seed)
    clock = _FakeClock()
    b = TokenBucket(rate, burst, clock)
    b.take(burst)
    prev = b.level()
    for _ in range(50):
        clock.t += float(rng.uniform(-0.05, 0.2))
        lvl = b.level()
        assert lvl >= prev - 1e-9, "refill drained the bucket"
        assert lvl <= burst + 1e-9
        prev = lvl


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_matches_reference_on_a_clock_script(seed):
    rng = np.random.default_rng(seed)
    steps = [(float(rng.uniform(-0.05, 0.3)), float(rng.uniform(0, 30)))
             for _ in range(60)]
    out = []
    for mod in (ttenancy, jtenancy):
        clock = _FakeClock()
        b = mod.TokenBucket(20.0, 16.0, clock)
        trace = []
        for dt, n in steps:
            clock.t += dt
            trace.append((b.take(n), b.level(), b.wait_s(n)))
        out.append(trace)
    assert out[0] == out[1]


def test_token_bucket_oversized_debt():
    clock = _FakeClock()
    b = TokenBucket(10.0, 16.0, clock)
    assert b.take(64)
    assert b.level() < 0
    assert not b.take(1)
    clock.t += 1e9
    assert b.take(16)


def test_token_bucket_throttles_then_refills():
    clock = _FakeClock()
    board = TenantBoard([TenantSpec("t", rate_rows_per_s=10.0,
                                    burst_rows=8)], clock=clock)
    board.admit("t", 8, block=False)
    with pytest.raises(TenantThrottled):
        board.admit("t", 8, block=False)
    clock.t += 0.8
    board.admit("t", 8, block=False)


def test_queue_submit_throttles_at_the_door(tmp_path):
    board = TenantBoard([TenantSpec("t", rate_rows_per_s=1e-3,
                                    burst_rows=4)])
    q = _queue(FlushPolicy(max_batch_rows=64, block=False), tenancy=board)
    mp = _bundle(tmp_path)
    q.submit(mp, _rows(4), tenant="t")
    with pytest.raises(TenantThrottled):
        q.submit(mp, _rows(4), tenant="t")
    assert q.depth(mp) == 4
    q.close()


# ---------------------------------------------------------- fair share -----
@settings(max_examples=25)
@given(nw=st.integers(2, 4), seed=st.integers(0, 10**6))
def test_drr_never_starves_positive_weight(nw, seed):
    """Every tenant permanently backlogged, capacity for ONE key a round:
    every positive-weight tenant keeps getting served at roughly its
    weight share."""
    rng = np.random.default_rng(seed)
    weights = {f"t{i}": float(rng.uniform(0.25, 4.0)) for i in range(nw)}
    rows = 64
    drr = DeficitRoundRobin(quantum_rows=float(rows))
    items = [(f"k{i}", t, rows) for i, t in enumerate(sorted(weights))]
    key_tenant = {k: t for k, t, _ in items}
    served = {t: 0 for t in weights}
    rounds = 400
    for _ in range(rounds):
        first = drr.order(items, weights)[0]
        drr.charge(key_tenant[first], rows)
        served[key_tenant[first]] += 1
    total_w = sum(weights.values())
    for t, w in weights.items():
        assert served[t] >= max(1, int(rounds * w / total_w / 4)), t


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drr_script_gives_the_same_order_in_both_packages(seed):
    rng = np.random.default_rng(seed)
    weights = {"a": 3.0, "b": 1.0, "c": 0.5}
    mine, ref = DeficitRoundRobin(48.0), jtenancy.DeficitRoundRobin(48.0)
    orders = ([], [])
    for _ in range(60):
        items = [(f"k{t}", t, int(rng.integers(0, 100)))
                 for t in weights if rng.random() < 0.8]
        served = int(rng.integers(1, 200))
        for drr, out in zip((mine, ref), orders):
            order = drr.order(items, weights)
            out.append(order)
            if order:
                drr.charge(order[0][1:], served)
    assert orders[0] == orders[1]
    assert all(mine.deficit(t) == ref.deficit(t) for t in weights)


def test_drr_order_prefers_uncharged_tenant():
    drr = DeficitRoundRobin(quantum_rows=64.0)
    items = [("kh", "heavy", 48), ("kl", "light", 8)]
    weights = {"heavy": 1.0, "light": 1.0}
    drr.order(items, weights)
    drr.charge("heavy", 48)
    drr.charge("light", 8)
    assert drr.order(items, weights) == ["kl", "kh"]


def _overload_script(board_cls, spec_cls, queue_factory, bundles, rows):
    """Two rounds of the reference's overload scenario; returns the
    second round's flush order and the served rows per tenant."""
    board = board_cls([spec_cls("heavy", weight=1.0),
                       spec_cls("light", weight=1.0)])
    q = queue_factory(board)
    kh, kl = bundles
    futs = [q.submit(kh, rows(22), tenant="heavy"),
            q.submit(kh, rows(22), tenant="heavy"),
            q.submit(kl, rows(8), tenant="light")]
    q.flush()
    for f in futs:
        f.result(10)
    q.submit(kh, rows(22), tenant="heavy")
    q.submit(kh, rows(22), tenant="heavy")
    f = q.submit(kl, rows(8), tenant="light")
    order = q._flush_order()
    q.flush()
    f.result(10)
    snap = q.snapshot()
    q.close()
    return order, {t: s["served_rows"] for t, s in snap["tenants"].items()}


def test_queue_flush_order_uses_drr_under_overload(tmp_path):
    from repro.serve import FlushPolicy as JFlushPolicy
    from repro.serve import ServeQueue as JServeQueue
    kh, kl = _bundle(tmp_path, "h"), _bundle(tmp_path, "l")
    pol = dict(max_batch_rows=48, max_pending_rows=1 << 16)
    order, served = _overload_script(
        TenantBoard, TenantSpec,
        lambda b: _queue(FlushPolicy(**pol), tenancy=b), (kh, kl), _rows)
    assert order == [str(kl), str(kh)]
    assert served == {"heavy": 88, "light": 16}
    jorder, jserved = _overload_script(
        jtenancy.TenantBoard, jtenancy.TenantSpec,
        lambda b: JServeQueue(JFlushPolicy(**pol), tenancy=b), (kh, kl),
        lambda n: _rows(n).numpy())
    assert (order, served) == (jorder, jserved)


def test_weighted_shares_under_sustained_overload(tmp_path):
    """Both tenants kept backlogged, one flush a round: served rows
    follow the 3:1 weights (the chip drill's scenario, small)."""
    board = TenantBoard([TenantSpec("heavy", weight=3.0),
                         TenantSpec("light", weight=1.0)])
    q = _queue(FlushPolicy(max_batch_rows=48, max_pending_rows=1 << 16),
               tenancy=board)
    kh, kl = _bundle(tmp_path, "h"), _bundle(tmp_path, "l")
    for _ in range(40):
        for tenant, key in (("heavy", kh), ("light", kl)):
            while q.depth(key) < 32:
                q.submit(key, _rows(8), tenant=tenant)
        q.flush(q._flush_order()[0])
    served = {t: s["served_rows"] for t, s in board.snapshot().items()}
    q.close()
    share = served["heavy"] / (served["heavy"] + served["light"])
    assert abs(share / 0.75 - 1.0) <= 0.2, served


# ----------------------------------------------------- board accounting ----
def test_board_backpressure_and_offenders():
    clock = _FakeClock()
    board = TenantBoard([TenantSpec("t", max_pending_rows=16)], clock=clock)
    board.on_enqueue("t", "k", 16)
    assert not board.has_room("t", 1)
    board.on_dispatch("t", 16)
    assert board.has_room("t", 16)
    assert board.has_room("t", 64)
    assert board.offenders() == []
    board.on_dropped("t", 1, 8)
    assert board.offenders() == ["t"]
    clock.t += TenantBoard.OFFENDER_WINDOW_S + 1
    assert board.offenders() == []


def test_queue_tenant_offenders_surface(tmp_path):
    board = TenantBoard()
    q = _queue(FlushPolicy(max_batch_rows=64), tenancy=board)
    board.on_dropped("noisy", 1, 8)
    assert q.tenant_offenders() == ["noisy"]
    q.close()


def test_failed_dispatch_is_attributed_to_the_tenant(tmp_path):
    board = TenantBoard()
    q = _queue(FlushPolicy(max_batch_rows=64), tenancy=board)
    f = q.submit(str(tmp_path / "missing"), _rows(3), tenant="t")
    q.flush()
    with pytest.raises(Exception):
        f.result(5)
    snap = board.snapshot()["t"]
    assert snap["dropped_rows"] == 3 and snap["pending_rows"] == 0
    assert q.tenant_offenders() == ["t"]
    q.close()


def test_unknown_tenant_inherits_default_spec():
    board = TenantBoard(default_spec=TenantSpec(max_pending_rows=32))
    assert board.spec_for("newcomer").max_pending_rows == 32
    assert board.spec_for("newcomer").tenant == "newcomer"
    board.on_enqueue("newcomer", "k", 8)
    assert board.tenant_for_key("k") == "newcomer"
    assert board.tenant_for_key("unbound") == DEFAULT_TENANT


def test_qos_tiers_for_keys():
    board = TenantBoard([
        TenantSpec("rt", tier="latency", deadline_target_s=5e-4),
        TenantSpec("batch", tier="throughput")])
    board.on_enqueue("rt", "k_rt", 8)
    board.on_enqueue("batch", "k_batch", 8)
    assert board.qos_for_key("k_rt") == ("latency", 5e-4)
    assert board.qos_for_key("k_batch") == (
        "throughput", ttenancy.TIER_DEADLINE_S["throughput"])
    assert board.qos_for_key("k_free") == (None, None)
    with pytest.raises(ValueError):
        TenantSpec("x", tier="gold")
    with pytest.raises(ValueError):
        TenantSpec("x", weight=0.0)


def test_queue_wires_tenancy_into_controller(tmp_path):
    class _Controller:
        tenancy = None

        def delay_for(self, key, stats):
            return None

        def batch_rows_for(self, key, stats):
            return 64

    board, ctrl = TenantBoard(), _Controller()
    q = _queue(FlushPolicy(max_batch_rows=64), controller=ctrl,
               tenancy=board)
    assert ctrl.tenancy is board
    assert q._batcher.tenancy is board
    q.close()


# ------------------------------------------------------------- residency ---
def test_residency_budget_evicts_lru():
    r = ResidencyManager(budget_bytes=100)
    assert r.note_load("a", 60) == []
    assert r.note_load("b", 60) == ["a"]
    assert r.resident_bytes() == 60
    assert r.peak_bytes <= 100
    assert r.note_load("huge", 500) == ["b"]
    assert r.resident() == {"huge": 500}
    r.drop("huge")
    r.drop("huge")
    assert r.resident_bytes() == 0
    assert r.snapshot()["evictions"] == 2


def test_residency_touch_refreshes_lru():
    r = ResidencyManager(budget_bytes=120)
    r.note_load("a", 50)
    r.note_load("b", 50)
    r.touch("a")
    assert r.note_load("c", 50) == ["b"]


@pytest.mark.parametrize("seed", [0, 1])
def test_residency_victims_match_reference(seed):
    rng = np.random.default_rng(seed)
    mine, ref = ResidencyManager(budget_bytes=300), \
        jresidency.ResidencyManager(budget_bytes=300)
    for _ in range(40):
        key = f"b{int(rng.integers(0, 6))}"
        if rng.random() < 0.3:
            mine.touch(key)
            ref.touch(key)
        else:
            n = int(rng.integers(10, 200))
            assert mine.note_load(key, n) == ref.note_load(key, n)
    assert mine.snapshot() == ref.snapshot()


def test_engine_meters_its_bytes_and_evicts_through_invalidate(tmp_path):
    a, b = _bundle(tmp_path, "a"), _bundle(tmp_path, "b")
    ea = InferenceEngine.get(a, "cpu")
    want = sum(p.numel() * 4 for p in ea.net.parameters())
    assert ea.resident_nbytes == want
    assert RESIDENCY.resident() == {str(a): want}
    RESIDENCY.set_budget(want)  # room for one bundle
    InferenceEngine.get(b, "cpu")
    assert list(RESIDENCY.resident()) == [str(b)]
    assert (str(a), "cpu") not in InferenceEngine._cache
    InferenceEngine.invalidate(b)
    assert RESIDENCY.resident() == {}


def test_evicted_bundle_reloads_exactly_once(tmp_path, monkeypatch):
    """3 threads race the first request after an eviction: exactly ONE
    reload, and every thread sees the fully loaded engine."""
    mp = _bundle(tmp_path)
    x = _rows(16)
    y_ref = InferenceEngine.get(mp, "cpu").apply_batched(x)
    loads = []
    lock = threading.Lock()
    orig = InferenceEngine._load

    def counted(self):
        with lock:
            loads.append(self.path)
        return orig(self)

    monkeypatch.setattr(InferenceEngine, "_load", counted)
    InferenceEngine.invalidate(mp)
    barrier = threading.Barrier(3)
    outs, errs = [], []

    def request():
        try:
            barrier.wait(10)
            outs.append(InferenceEngine.get(mp, "cpu").apply_batched(x))
        except Exception as exc:  # pragma: no cover - diagnostic
            errs.append(exc)

    threads = [threading.Thread(target=request) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not errs and len(outs) == 3
    assert loads.count(str(mp)) == 1
    for y in outs:
        assert torch.equal(y, y_ref)


def test_no_torn_reads_under_concurrent_submit_and_evict(tmp_path):
    mp = _bundle(tmp_path)
    x = _rows(16)
    y_ref = InferenceEngine.get(mp, "cpu").apply_batched(x)
    stop = threading.Event()
    errs = []

    def hammer():
        try:
            while not stop.is_set():
                y = InferenceEngine.get(mp, "cpu").apply_batched(x)
                if not torch.equal(y, y_ref):
                    errs.append("torn read: output mismatch")
                    return
        except Exception as exc:
            errs.append(repr(exc))

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    for _ in range(20):
        InferenceEngine.invalidate(mp)
    stop.set()
    for t in threads:
        t.join(10)
    assert not errs, errs[:3]


def test_residency_prefetch_warms_bundle(tmp_path):
    mp = _bundle(tmp_path)
    t = RESIDENCY.prefetch(mp, device="cpu")
    assert t is not None
    t.join(10)
    assert str(mp) in RESIDENCY.resident()
    assert RESIDENCY.prefetch(mp, device="cpu") is None


# ----------------------------------------------------- end-to-end submit ---
def test_tenant_submit_roundtrip_and_latency_accounting(tmp_path):
    board = TenantBoard([TenantSpec("a", tier="latency", weight=2.0),
                         TenantSpec("b")])
    q = _queue(FlushPolicy(max_batch_rows=256), tenancy=board)
    mp = _bundle(tmp_path)
    fa = q.submit(mp, _rows(8, seed=1), tenant="a")
    fb = q.submit(mp, _rows(8, seed=2), tenant="b")
    q.flush()
    fa.result(10), fb.result(10)
    snap = board.snapshot()
    assert snap["a"]["served_rows"] == 8
    assert snap["b"]["served_rows"] == 8
    assert snap["a"]["pending_rows"] == 0
    assert snap["a"]["latency_p99_ms"] > 0.0
    assert abs(sum(s["occupancy"] for s in snap.values()) - 1.0) < 1e-9
    assert "residency" in q.snapshot()
    q.close()
