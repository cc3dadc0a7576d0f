"""Port parity of the adaptive flush controller on the CPU: the roofline
(``repro_torch.dist.hlo_analysis``), the fused-MLP resource model and
batch-latency prediction, and ``AdaptiveFlushController``'s decisions,
against ``repro.dist``/``repro.tune``.

With the same explicit constants (peaks, bandwidth, dispatch floor) both
packages give the same numbers and the same decisions, exactly: the same
``on_batch`` sequences and injected arrival windows go through
``repro.serve.ServeStats`` and the port's, on a frozen clock, and
``delay_for``/``batch_rows_for``/``last_decision`` and the decisions
counter must agree.  The defaults differ on purpose (H100 figures and a
floor measured on the card, where the reference has a TPU's and a
guessed 150 us).  On top of that, the twins of tests/test_tune.py's
controller and queue-integration cases, the real controller end to end
included.
"""
import time
import types
from collections import deque

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve.stats as jstats_mod  # noqa: E402
import repro.tune.controller as jctrl_mod  # noqa: E402
from repro.dist.hlo_analysis import Roofline as JRoofline  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serve import FlushPolicy as JFlushPolicy  # noqa: E402
from repro.serve.tenancy import TenantBoard as JTenantBoard  # noqa: E402
from repro.serve.tenancy import TenantSpec as JTenantSpec  # noqa: E402
import repro_torch.serve.stats as stats_mod  # noqa: E402
import repro_torch.tune.controller as ctrl_mod  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.dist.hlo_analysis import (HBM_BW, ICI_BW,  # noqa: E402
                                           PEAK_FLOPS, Roofline)
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.serve import (FlushPolicy, ServeQueue,  # noqa: E402
                               TenantBoard, TenantSpec)
from repro_torch.serve.stats import ServeStats  # noqa: E402
from repro_torch.tune import (AdaptiveFlushController,  # noqa: E402
                              mlp_resources, predict_batch_latency_s)

NETS = {
    "minibude": (6, 1024, 819, 655, 524, 419, 335, 1),
    "bonds": (4, 512, 512, 2),
    "binomial": (5, 512, 512, 1),
    "toy": (64, 64),
}
BATCHES = sorted({1 << i for i in range(17)} | {3, 7, 37, 1000, 4097})
#: explicit constants both packages get: the reference's v5e defaults,
#: the port's H100 defaults, and a compute-starved toy
CONSTANTS = {
    "v5e": dict(peak_flops=197e12, hbm_bw=819e9, overhead_s=150e-6),
    "h100": dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
                 overhead_s=ctrl_mod.DISPATCH_FLOOR_S),
    "toy": dict(peak_flops=1e9, hbm_bw=1e9, overhead_s=1e-4),
}
DECISION_CONSTANTS = dict(peak_flops=1e12, hbm_bw=1e11, overhead_s=1e-4)


@pytest.fixture(autouse=True)
def _clean_engines():
    InferenceEngine.invalidate()
    yield
    InferenceEngine.invalidate()


def _bundle(tmp, name="m", hidden=16, feat=2):
    """An untrained MLP bundle, written by the reference."""
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, feat), [hidden], 1)
    return save_model(tmp / name, net, net.init(jax.random.PRNGKey(0)))


def _rows(n, seed=0, feat=2):
    return torch.from_numpy(np.random.default_rng(seed)
                            .normal(size=(n, feat)).astype(np.float32))


def _queue(policy, **kw):
    return ServeQueue(policy, device="cpu", **kw)


# ------------------------------------------------------ roofline parity ----
def test_defaults_are_h100_figures():
    assert PEAK_FLOPS == 494.7e12 / 3
    assert HBM_BW == 3.35e12 and ICI_BW == 450e9
    c = AdaptiveFlushController(widths_for=lambda k: [2, 1])
    assert (c.peak_flops, c.hbm_bw) == (PEAK_FLOPS, HBM_BW)
    assert c.overhead_s == ctrl_mod.DISPATCH_FLOOR_S != 150e-6
    # and the defaults price differently from the reference's
    assert predict_batch_latency_s(NETS["minibude"], 256) != \
        jctrl_mod.predict_batch_latency_s(NETS["minibude"], 256)


@pytest.mark.parametrize("consts", sorted(CONSTANTS))
@pytest.mark.parametrize("net", sorted(NETS))
def test_resources_and_prediction_match_reference(net, consts):
    widths, kw = NETS[net], CONSTANTS[consts]
    for b in BATCHES:
        for wbytes in (None, 1):
            assert mlp_resources(widths, b, 4, wbytes) == \
                jctrl_mod.mlp_resources(widths, b, 4, wbytes)
            for chips in (1, 4):
                got = predict_batch_latency_s(
                    widths, b, chips=chips, weight_dtype_bytes=wbytes, **kw)
                want = jctrl_mod.predict_batch_latency_s(
                    widths, b, chips=chips, weight_dtype_bytes=wbytes, **kw)
                assert got == want, (b, wbytes, chips)


@pytest.mark.parametrize("terms", [
    (1e15, 1e9, 0.0, 1, 1e15), (1e12, 1e12, 0.0, 1, 5e11),
    (1e12, 1e9, 1e12, 4, 1e12), (0.0, 0.0, 0.0, 1, 0.0)],
    ids=["compute", "memory", "collective", "empty"])
def test_roofline_to_dict_matches_reference(terms):
    peaks = dict(peak_flops=123e12, hbm_bw=2e12, ici_bw=100e9)
    flops, hbm, coll, chips, model = terms
    got = Roofline(flops, hbm, coll, chips, model, **peaks).to_dict()
    want = JRoofline(flops, hbm, coll, chips, model, **peaks).to_dict()
    assert got == want
    assert Roofline(flops, hbm, coll, chips, model).mfu_bound == \
        JRoofline(flops, hbm, coll, chips, model, peak_flops=PEAK_FLOPS,
                  hbm_bw=HBM_BW, ici_bw=ICI_BW).mfu_bound


# ----------------------------------------------------- decision parity -----
@pytest.fixture
def clock(monkeypatch):
    """One frozen monotonic clock for both packages' stats and
    controllers (arrival rates and memo ages read it)."""
    now = [1000.0]
    fake = types.SimpleNamespace(monotonic=lambda: now[0])
    for mod in (jstats_mod, stats_mod, jctrl_mod, ctrl_mod):
        monkeypatch.setattr(mod, "time", fake)
    return now


def _warm(st, bucket, busy_s, n=3):
    for _ in range(n):
        st.on_enqueue(bucket)
        st.on_batch(requests=1, rows=bucket, bucket=bucket, reason="t",
                    busy_s=busy_s, latencies_s=[busy_s])


def _boom(self, *a, **kw):
    raise RuntimeError("stats backend gone")


def _script(case, cls, now):
    """The stats object of one case, built the same way for either
    package's ServeStats class."""
    pred64 = jctrl_mod.predict_batch_latency_s(
        [5, 16, 1], 64, **DECISION_CONSTANTS)
    if case == "none":
        return None
    st = cls("k")
    if case == "warm_exact":
        _warm(st, 8, 5e-4)
    elif case == "corrected":
        _warm(st, 64, 10.0 * pred64)
        st.on_enqueue(10)
    elif case == "clamped":
        _warm(st, 64, 1000.0 * pred64)
        st.on_enqueue(300)
    elif case == "shard_rounded":
        _warm(st, 12, 0.003)
        st.on_enqueue(10)
    elif case == "slow_measured":
        _warm(st, 8, 5.0)
    elif case == "high_rate":
        st._arrivals = deque([(now - 1.0 + 0.1 * i, 10 ** 6)
                              for i in range(10)], maxlen=256)
        st.requests_enqueued = 10
    elif case == "low_rate":
        st._arrivals = deque([(now - 10.0 + i, 4) for i in range(10)],
                             maxlen=256)
        st.requests_enqueued = 10
        _warm(st, 8, 2e-4)
    elif case == "warmup_gate":
        st._arrivals = deque([(now, 10 ** 9)] * 2, maxlen=256)
        st.requests_enqueued = 2
    elif case == "broken":
        st = type("Boom", (cls,), {"batch_latency_s": _boom})("k")
        _warm(st, 8, 5e-4)
    return st


_CASES = ("none", "cold", "warm_exact", "corrected", "clamped",
          "shard_rounded", "slow_measured", "high_rate", "low_rate",
          "warmup_gate", "broken")
_FLAGS = {"closed_loop": {}, "open_loop": {"use_measured": False},
          "min_batches_1": {"measured_min_batches": 1},
          "clamp_2": {"correction_clamp": 2.0}}


def _decisions(ctrl, stats, counter):
    before = {s: counter.value(key="k", source=s)
              for s in ("measured", "corrected", "roofline")}
    out = (ctrl.delay_for("k", stats), ctrl.batch_rows_for("k", stats),
           dict(ctrl.last_decision.get("k", {})))
    counted = {s: counter.value(key="k", source=s) - v
               for s, v in before.items()}
    return out, counted


def _controllers(widths_for, policy_kw, **kw):
    kw = dict(DECISION_CONSTANTS, decision_ttl_s=0.0, **kw)
    return (jctrl_mod.AdaptiveFlushController(
                JFlushPolicy(**policy_kw), widths_for=widths_for, **kw),
            AdaptiveFlushController(
                FlushPolicy(**policy_kw), widths_for=widths_for, **kw))


_JCOUNT = jmetrics.counter("repro_controller_decisions_total",
                           "adaptive flush decisions by latency-model "
                           "source", ("key", "source"))
_TCOUNT = tmetrics.counter("repro_controller_decisions_total",
                           "adaptive flush decisions by latency-model "
                           "source", ("key", "source"))


@pytest.mark.parametrize("flags", sorted(_FLAGS))
@pytest.mark.parametrize("case", _CASES)
def test_decisions_match_reference(case, flags, clock):
    policy_kw = dict(max_batch_rows=1024, max_delay_s=0.05)
    jc, tc = _controllers(lambda key: [5, 16, 1], policy_kw, **_FLAGS[flags])
    jst = _script(case, jstats_mod.ServeStats, clock[0])
    tst = _script(case, ServeStats, clock[0])
    want, jcounted = _decisions(jc, jst, _JCOUNT)
    got, tcounted = _decisions(tc, tst, _TCOUNT)
    assert got == want
    assert tcounted == jcounted and sum(tcounted.values()) == 1
    dec = got[2]
    assert tc.min_delay_s <= got[0] <= 0.05
    if case == "broken" or flags == "open_loop":
        assert dec["latency_source"] == "roofline"


def test_decision_sources_cover_every_branch(clock):
    """The parity cases above reach each source of the latency model."""
    seen = set()
    for case in _CASES:
        _, tc = _controllers(lambda key: [5, 16, 1],
                             dict(max_batch_rows=1024, max_delay_s=0.05))
        tc.delay_for("k", _script(case, ServeStats, clock[0]))
        seen.add(tc.last_decision["k"]["latency_source"])
    assert seen == {"measured", "corrected", "roofline"}


def test_clamped_correction_matches_reference(clock):
    jc, tc = _controllers(lambda key: [5, 16, 1],
                          dict(max_batch_rows=1024, max_delay_s=0.05),
                          correction_clamp=20.0)
    widths = [5, 16, 1]
    for ctrl, cls in ((jc, jstats_mod.ServeStats), (tc, ServeStats)):
        st = _script("clamped", cls, clock[0])
        lat, src = ctrl.latency_s(widths, 512, st)
        assert src == "corrected"
        assert lat == pytest.approx(20.0 * ctrl.predict_latency_s(widths,
                                                                  512))
    assert tc.latency_s(widths, 512, _script("clamped", ServeStats,
                                             clock[0])) == \
        jc.latency_s(widths, 512, _script("clamped", jstats_mod.ServeStats,
                                          clock[0]))


@pytest.mark.parametrize("case", ("none", "warm_exact"))
def test_unknown_widths_match_reference(case, clock):
    def gone(key):
        raise IOError("gone")

    jc, tc = _controllers(gone, dict(max_batch_rows=1024, max_delay_s=0.03))
    got = (tc.delay_for("k", _script(case, ServeStats, clock[0])),
           tc.batch_rows_for("k", None))
    want = (jc.delay_for("k", _script(case, jstats_mod.ServeStats,
                                      clock[0])),
            jc.batch_rows_for("k", None))
    assert got == want == (0.03, 1024)
    assert tc.last_decision == jc.last_decision == {}
    # widths (and their failure) are resolved once per key
    assert tc._widths == {"k": None}


@pytest.mark.parametrize("key", ("k_rt", "k_batch", "k_free"))
def test_tenancy_tiers_match_reference(key, clock):
    def board(cls_board, cls_spec):
        b = cls_board([
            cls_spec("rt", tier="latency", deadline_target_s=5e-4),
            cls_spec("batch", tier="throughput", deadline_target_s=0.5)])
        b.on_enqueue("rt", "k_rt", 8)
        b.on_enqueue("batch", "k_batch", 8)
        return b

    policy_kw = dict(max_batch_rows=1024, max_delay_s=0.02)
    widths = lambda key: [8, 8192, 8192, 8192, 4]  # noqa: E731
    jc = jctrl_mod.AdaptiveFlushController(
        JFlushPolicy(**policy_kw), widths_for=widths, service_factor=1e6,
        tenancy=board(JTenantBoard, JTenantSpec), decision_ttl_s=0.0,
        **DECISION_CONSTANTS)
    tc = AdaptiveFlushController(
        FlushPolicy(**policy_kw), widths_for=widths, service_factor=1e6,
        tenancy=board(TenantBoard, TenantSpec), decision_ttl_s=0.0,
        **DECISION_CONSTANTS)
    assert tc.delay_for(key, None) == jc.delay_for(key, None)
    assert tc.last_decision[key] == jc.last_decision[key]
    d = tc.last_decision[key]["delay_s"]
    tier = tc.last_decision[key]["qos_tier"]
    if key == "k_rt":
        assert tier == "latency" and d <= 5e-4 + 1e-9
    elif key == "k_batch":
        assert tier == "throughput" and 0.02 < d <= 0.5 + 1e-9
    else:
        assert tier is None and d <= 0.02 + 1e-9


def test_memo_ttl_holds_a_decision_like_reference(clock):
    jc, tc = _controllers(lambda key: [5, 16, 1],
                          dict(max_batch_rows=1024, max_delay_s=0.05))
    for c in (jc, tc):
        c.decision_ttl_s = 0.01
    jst, tst = ServeStats("k"), jstats_mod.ServeStats("k")
    first = (tc.delay_for("k", tst), jc.delay_for("k", jst))
    _warm(tst, 8, 1e-6)
    _warm(jst, 8, 1e-6)
    clock[0] += 0.005  # inside the TTL: the memo answers
    assert (tc.delay_for("k", tst), jc.delay_for("k", jst)) == first
    clock[0] += 0.01  # past it: re-priced from the warm bucket
    again = (tc.delay_for("k", tst), jc.delay_for("k", jst))
    assert again[0] == again[1] != first[0]
    assert tc.last_decision["k"]["latency_source"] == "measured"


# -------------------------------------- twins of tests/test_tune.py ---------
def _ctrl(policy=None, widths=(5, 16, 1), **kw):
    policy = policy or FlushPolicy(max_batch_rows=1024, max_delay_s=0.05)
    return AdaptiveFlushController(policy,
                                   widths_for=lambda key: list(widths), **kw)


def _warm_stats(bucket, busy_s, n=3, key="k"):
    st = ServeStats(key)
    for _ in range(n):
        st.on_batch(requests=1, rows=bucket, bucket=bucket, reason="t",
                    busy_s=busy_s, latencies_s=[busy_s])
    return st


def test_predict_latency_monotone_in_batch():
    lo = predict_batch_latency_s([5, 128, 1], 8)
    hi = predict_batch_latency_s([5, 128, 1], 4096)
    assert hi >= lo > 0


def test_controller_unknown_widths_degrades_to_static():
    pol = FlushPolicy(max_batch_rows=1024, max_delay_s=0.03)
    c = AdaptiveFlushController(
        pol, widths_for=lambda key: (_ for _ in ()).throw(IOError("gone")))
    assert c.delay_for("k", None) == 0.03
    assert c.batch_rows_for("k", None) == 1024


def test_controller_cold_stats_use_service_cap_not_static():
    c = _ctrl(service_factor=4.0, overhead_s=1e-4)
    d = c.delay_for("k", None)
    assert c.min_delay_s <= d < 0.01
    assert d <= 4.0 * c.predict_latency_s([5, 16, 1], 1024) + 1e-9


def test_controller_high_rate_clamps_to_min_delay():
    c = _ctrl(min_delay_s=5e-4)
    st = ServeStats("k")
    now = time.monotonic()
    st._arrivals = deque([(now - 1.0 + 0.1 * i, 10 ** 6) for i in range(10)],
                         maxlen=256)
    st.requests_enqueued = 10
    d = c.delay_for("k", st)
    assert d == pytest.approx(5e-4)
    assert c.last_decision["k"]["arrival_rate_rows_s"] > 0


def test_controller_warmup_gates_rate_term_only():
    c = _ctrl(warmup_requests=8)
    st = ServeStats("k")
    st.requests_enqueued = 2
    st._arrivals = deque([(time.monotonic(), 10 ** 9)] * 2, maxlen=256)
    d = c.delay_for("k", st)
    assert c.last_decision["k"]["arrival_rate_rows_s"] == 0.0
    assert d > 0


def test_controller_bucket_target_amortizes_overhead():
    pol = FlushPolicy(max_batch_rows=4096, min_bucket=8)
    c = AdaptiveFlushController(pol, widths_for=lambda k: [64, 64],
                                peak_flops=1e9, overhead_s=1e-4)
    t = c.batch_rows_for("k", None)
    assert 8 < t < 4096
    assert t & (t - 1) == 0


def test_stats_batch_latency_ewma_and_warmup_gate():
    """The port's stats feed the controller the reference's numbers: the
    first observation of a bucket is replaced, then an EWMA."""
    busy = (0.900, 0.020, 0.010)
    ours, ref = ServeStats("k"), jstats_mod.ServeStats("k")
    assert ours.batch_latency_s(64) is None
    for i, b in enumerate(busy):
        for st in (ours, ref):
            st.on_batch(requests=1, rows=64, bucket=64, reason="t",
                        busy_s=b, latencies_s=[b])
        assert ours.batch_latency_s(64, min_batches=2) == \
            ref.batch_latency_s(64, min_batches=2)
        if i == 1:
            assert ours.batch_latency_s(64, min_batches=2) == \
                pytest.approx(0.020)
    ewma = ours.batch_latency_s(64, min_batches=2)
    assert 0.010 < ewma < 0.020
    assert ours.batch_latencies() == ref.batch_latencies()
    snap = ours.snapshot()
    assert snap["batch_latency_batches"] == {64: 3}
    assert snap["batch_latency_ewma_ms"][64] == pytest.approx(ewma * 1e3,
                                                              rel=1e-3)


def test_stats_failed_dispatches_never_feed_the_latency_model():
    st = ServeStats("k")
    st.on_enqueue(8)
    st.on_failure(requests=1, rows=8, reason="t", busy_s=5.0)
    assert st.batch_latencies() == {}


def test_controller_measured_latency_tightens_the_cap():
    c = _ctrl(overhead_s=5e-3, measured_min_batches=2, decision_ttl_s=0.0)
    measured = 5e-4
    st = _warm_stats(c.policy.min_bucket, measured, n=3)
    d = c.delay_for("k", st)
    dec = c.last_decision["k"]
    assert dec["latency_source"] == "measured"
    assert dec["batch_latency_s"] == pytest.approx(measured, rel=1e-6)
    assert d == pytest.approx(c.measured_service_factor * measured, rel=1e-6)
    assert d < c.service_factor * dec["predicted_batch_latency_s"]


def test_controller_measured_latency_never_inflates_the_cap():
    c = _ctrl(measured_min_batches=2, decision_ttl_s=0.0)
    cold = c.delay_for("cold", None)
    st = _warm_stats(c.policy.min_bucket, 5.0, n=3)
    d = c.delay_for("k", st)
    assert d <= cold + 1e-9


def test_controller_corrects_roofline_from_nearest_warm_bucket():
    c = _ctrl(measured_min_batches=2, decision_ttl_s=0.0)
    widths = [5, 16, 1]
    st = _warm_stats(64, busy_s=10.0 * c.predict_latency_s(widths, 64), n=3)
    lat, source = c.latency_s(widths, 256, st)
    assert source == "corrected"
    assert lat == pytest.approx(10.0 * c.predict_latency_s(widths, 256),
                                rel=0.05)


def test_controller_cap_bucket_matches_shard_rounded_dispatch():
    c = _ctrl(measured_min_batches=2, decision_ttl_s=0.0)
    st = ServeStats("k")
    for _ in range(3):
        st.on_enqueue(12)
        st.on_batch(requests=1, rows=12, bucket=12, reason="t",
                    busy_s=0.003, latencies_s=[0.003])
    st.on_enqueue(10)
    c.delay_for("k", st)
    dec = c.last_decision["k"]
    assert dec["cap_bucket"] == 12
    assert dec["latency_source"] == "measured"
    assert dec["batch_latency_s"] == pytest.approx(0.003)


def test_controller_cold_stats_fall_back_to_roofline_prior():
    c = _ctrl(decision_ttl_s=0.0)
    c.delay_for("k", ServeStats("k"))
    assert c.last_decision["k"]["latency_source"] == "roofline"


def test_controller_open_loop_flag_ignores_measurements():
    c = _ctrl(use_measured=False, decision_ttl_s=0.0)
    st = _warm_stats(c.batch_rows_for("k", None), 5.0, n=10)
    c.delay_for("k", st)
    dec = c.last_decision["k"]
    assert dec["latency_source"] == "roofline"
    assert dec["batch_latency_s"] == dec["predicted_batch_latency_s"]


def test_controller_broken_stats_degrade_to_roofline():
    class _Boom(ServeStats):
        def batch_latency_s(self, *a, **kw):
            raise RuntimeError("stats backend gone")

    c = _ctrl(decision_ttl_s=0.0)
    d = c.delay_for("k", _Boom("k"))
    assert d is not None
    assert c.last_decision["k"]["latency_source"] == "roofline"


def test_default_widths_read_the_bundle_spec(tmp_path):
    """A queue key is a bundle path: its widths come from spec.json
    through the port's widths_from_spec; a non-MLP key falls back."""
    from repro_torch.nn import CNN
    from repro_torch.nn.serialize import save_model
    mp = _bundle(tmp_path, hidden=16, feat=2)
    c = AdaptiveFlushController(FlushPolicy(max_delay_s=0.04))
    assert c._widths_cached(mp) == [2, 16, 1]
    cnn = save_model(tmp_path / "cnn",
                     CNN((1, 8, 8, 1), [(4, 3, 1)], [8], 1).init(0))
    assert c.delay_for(cnn, None) == 0.04
    assert c._widths_cached(cnn) is None


def test_measured_latency_flows_through_real_queue(tmp_path):
    mp = _bundle(tmp_path)
    pol = FlushPolicy(max_batch_rows=1024, max_delay_s=0.05)
    ctrl = AdaptiveFlushController(pol, warmup_requests=4,
                                   measured_min_batches=1,
                                   decision_ttl_s=0.0)
    q = _queue(pol, controller=ctrl)
    for i in range(6):
        q.submit(mp, _rows(4, seed=i))
        q.flush(mp)
    assert q.stats(mp).batch_latencies()
    ctrl.delay_for(mp, q.stats(mp))
    assert ctrl.last_decision[mp]["latency_source"] in ("measured",
                                                        "corrected")


# -------------------------------------------- queue/controller wiring ------
class _StubController:
    def __init__(self, delay=None, rows=None, boom=False):
        self._delay, self._rows, self._boom = delay, rows, boom

    def delay_for(self, key, stats):
        if self._boom:
            raise RuntimeError("controller crashed")
        return self._delay

    def batch_rows_for(self, key, stats):
        if self._boom:
            raise RuntimeError("controller crashed")
        return self._rows


def test_queue_adaptive_deadline_via_poll(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_delay_s=None),
               controller=_StubController(delay=0.02, rows=10 ** 6))
    f = q.submit(mp, _rows(4))
    assert q.poll() == 0
    time.sleep(0.03)
    assert q.poll() == 4
    assert f.done()
    assert q.stats(mp).snapshot()["flush_reasons"] == {"deadline": 1}


def test_queue_adaptive_batch_trigger(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6),
               controller=_StubController(delay=None, rows=16))
    q.submit(mp, _rows(8, seed=1))
    f = q.submit(mp, _rows(8, seed=2))
    assert f.done()
    assert q.stats(mp).snapshot()["flush_reasons"] == {"max_batch": 1}


def test_queue_controller_failure_degrades_to_static(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=16, max_delay_s=None),
               controller=_StubController(boom=True))
    q.submit(mp, _rows(8, seed=1))
    f = q.submit(mp, _rows(8, seed=2))
    assert f.done()


def test_queue_cold_controller_demand_flush_no_deadlock(tmp_path):
    mp = _bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_delay_s=None),
               controller=_StubController(delay=None, rows=10 ** 6))
    q.start()
    try:
        f = q.submit(mp, _rows(4))
        assert tuple(f.result(timeout=5).shape) == (4, 1)
    finally:
        q.stop()


def test_queue_wires_tenancy_into_real_controller(tmp_path):
    board = TenantBoard()
    ctrl = AdaptiveFlushController(widths_for=lambda key: [2, 8, 1])
    q = _queue(FlushPolicy(max_batch_rows=64), controller=ctrl,
               tenancy=board)
    try:
        assert ctrl.tenancy is board
        assert q._batcher.tenancy is board
    finally:
        q.close()


def test_real_controller_end_to_end_bit_identical(tmp_path):
    """The real controller with its H100 defaults drives a threaded
    queue on the CPU: every request's rows equal a synchronous engine
    call bit for bit, and every deadline lies within its bounds."""
    mp = _bundle(tmp_path)
    pol = FlushPolicy(max_batch_rows=1024, max_delay_s=0.05)
    ctrl = AdaptiveFlushController(pol)
    q = _queue(pol, controller=ctrl)
    with q:
        futs = [q.submit(mp, _rows(4, seed=i)) for i in range(10)]
        outs = [f.result(10) for f in futs]
    eng = InferenceEngine.get(mp, "cpu")
    for i, o in enumerate(outs):
        assert torch.equal(o, eng(_rows(4, seed=i)))
    st = q.stats(mp).snapshot()
    assert st["rows_completed"] == 40 and st["queue_depth_rows"] == 0
    d = ctrl.last_decision[mp]["delay_s"]
    assert ctrl.min_delay_s <= d <= pol.max_delay_s
