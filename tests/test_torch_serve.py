"""Port parity of the serving layer on the CPU: queue and batcher flush
policies, bucket padding, multiplexed bundles, deadline determinism,
stats, backpressure, the region's ``infer_async`` and ``serving=`` hook,
the async app drivers, and the pooled host buffers, against
``repro.serve``.

The cases are those of tests/test_serve.py minus the mesh and sharding
ones (the port has no ``dist/`` yet) and the in-trace degrade (the port
has no traced path).  On top of them the same requests go through both
queues in ``poll()`` mode: the same batches and buckets, the port's rows
bit-identical to its own synchronous ``infer`` and within ``fused_mlp``'s
1e-4 of the reference's rows, for a bundle the reference wrote.
"""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import approx_ml as jax_approx_ml  # noqa: E402
from repro.core import tensor_functor as jax_functor  # noqa: E402
from repro.core.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.serve import FlushPolicy as JFlushPolicy  # noqa: E402
from repro.serve import ServeQueue as JServeQueue  # noqa: E402
from repro.serve import bucket_for as jbucket_for  # noqa: E402
from repro.serve import bucket_size as jbucket_size  # noqa: E402
from repro.serve.stats import ServeStats as JServeStats  # noqa: E402
from repro.serve.stats import _percentile as jpercentile  # noqa: E402
from repro_torch.core import approx_ml, tensor_functor  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.serve import (Backpressure, FlushPolicy,  # noqa: E402
                               ScratchPool, ServeQueue, bucket_for,
                               bucket_size)
from repro_torch.serve.stats import ServeStats, _percentile  # noqa: E402

#: fused_mlp's declared tolerance against the reference (the plain
#: version and the reference's XLA dots sum in different orders)
RTOL = ATOL = 1e-4

_ifn = tensor_functor("sin: [i, 0:2] = ([i, 0:2])")
_ofn = tensor_functor("sout: [i, 0:1] = ([i, 0:1])")


@pytest.fixture(autouse=True)
def _clean_engines():
    InferenceEngine.invalidate()
    JaxEngine.invalidate()
    yield
    InferenceEngine.invalidate()
    JaxEngine.invalidate()


def _lin_bundle(tmp, name="m", seed=0, hidden=16):
    """An untrained MLP bundle, written by the reference."""
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 2), [hidden], 1)
    return save_model(tmp / name, net, net.init(jax.random.PRNGKey(seed)))


def _lin(x):
    return {"out": x[:, :1] * 2 + x[:, 1:] * 0.5}


def _region(n, mode, model, serving=None):
    rngs = {"i": (0, n)}
    return approx_ml(_lin, name="lin", inputs={"x": (_ifn, rngs)},
                     outputs={"out": (_ofn, rngs)}, mode=mode, model=model,
                     serving=serving, device="cpu")


def _rows(n, seed=0, d=2):
    return torch.from_numpy(np.random.default_rng(seed)
                            .normal(size=(n, d)).astype(np.float32))


def _queue(policy=None, **kw):
    return ServeQueue(policy or FlushPolicy(max_batch_rows=1024),
                      device="cpu", **kw)


def _eng(mp):
    return InferenceEngine.get(mp, "cpu")


# ------------------------------------------------------------- buckets -----
def test_bucket_size_pow2_and_min():
    assert bucket_size(1) == 8
    assert bucket_size(8) == 8
    assert bucket_size(9) == 16
    assert bucket_size(100) == 128
    assert bucket_size(3, min_bucket=2) == 4
    assert bucket_size(0, min_bucket=1) == 1
    assert bucket_size(129) == 256 and bucket_size(1025) == 2048


def test_buckets_match_reference():
    for n in range(0, 300):
        for mb in (1, 2, 8, 16):
            assert bucket_size(n, mb) == jbucket_size(n, mb)
            for shards in (1, 6, 16):
                assert bucket_for(n, mb, shards) == jbucket_for(n, mb, shards)


# ------------------------------------------------------- coalescing --------
def test_deadline_flush_under_concurrent_submitters(tmp_path):
    """Many threads race the dispatcher's deadline: every future resolves
    exactly once, totals stay consistent and rows are bit-identical to a
    synchronous engine call."""
    mp = _lin_bundle(tmp_path, "conc")
    eng = _eng(mp)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_delay_s=0.01,
                           max_pending_rows=10 ** 6))
    results, errors = {}, []

    def submitter(tid):
        try:
            for i in range(4):
                x = _rows(3, seed=100 * tid + i)
                results[(tid, i)] = (x, q.submit(mp, x))
                time.sleep(0.003)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    q.start()
    try:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        outs = {k: (x, f.result(timeout=10))
                for k, (x, f) in results.items()}
    finally:
        q.close()
        sys.setswitchinterval(switch)
    assert not errors
    assert len(outs) == 32
    for x, y in outs.values():
        assert torch.equal(y, eng(x))
    st = q.stats(mp).snapshot()
    assert st["rows_completed"] == st["rows_enqueued"] == 96
    assert st["requests_completed"] == 32 and st["requests_failed"] == 0
    assert st["queue_depth_rows"] == 0 and st["queue_depth_requests"] == 0
    assert st["flush_reasons"].get("deadline", 0) >= 1
    assert st["arrival_rate_rows_s"] > 0


def test_apply_batched_matches_call_and_pads(tmp_path):
    eng = _eng(_lin_bundle(tmp_path))
    x = _rows(13)
    batched = eng.apply_batched(x)  # padded to 16, sliced to 13
    assert batched.shape[0] == 13
    assert torch.equal(batched, eng(x))


@pytest.mark.parametrize("widths", [(2, 16, 1), (5, 512, 512, 1),
                                    (6, 64, 33, 2)])
def test_cpu_rows_do_not_depend_on_their_batch(tmp_path, widths):
    """On the CPU a pure MLP is served in fixed tiles, so a row's bits do
    not depend on the batch it rides in (the BLAS would otherwise switch
    to a matrix-vector product at one output column)."""
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, widths[0]), list(widths[1:-1]), widths[-1])
    mp = save_model(tmp_path / "w", net, net.init(jax.random.PRNGKey(1)))
    eng = _eng(mp)
    x = _rows(300, seed=2, d=widths[0])
    full = eng(x)
    for lo, hi in ((0, 1), (5, 8), (3, 40), (100, 237), (299, 300)):
        assert torch.equal(eng(x[lo:hi]), full[lo:hi])
        assert torch.equal(eng.apply_batched(x[lo:hi]), full[lo:hi])


def test_explicit_flush_and_bucket_padding_roundtrip(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=1024, min_bucket=8))
    xa, xb = _rows(3, seed=1), _rows(2, seed=2)
    fa, fb = q.submit(mp, xa), q.submit(mp, xb)
    assert not fa.done() and q.depth(mp) == 5
    assert q.flush() == 5
    eng = _eng(mp)
    ya, yb = fa.result(1), fb.result(1)
    assert ya.shape[0] == 3 and yb.shape[0] == 2
    assert torch.equal(ya, eng(xa)) and torch.equal(yb, eng(xb))
    st = q.stats(mp).snapshot()
    assert st["batches"] == 1
    assert st["bucket_rows"] == 8 and st["padded_rows"] == 3
    assert st["batch_occupancy"] == pytest.approx(5 / 8)
    assert st["queue_depth_rows"] == 0 and st["queue_depth_requests"] == 0


def test_max_batch_rows_flushes_inline(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=8))
    futs = [q.submit(mp, _rows(4, seed=i)) for i in range(2)]
    assert all(f.done() for f in futs)
    assert q.stats(mp).snapshot()["flush_reasons"] == {"max_batch": 1}


def test_future_result_flushes_on_demand(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue()
    f = q.submit(mp, _rows(4))
    assert not f.done()
    assert f.result(timeout=5).shape == (4, 1)
    assert q.stats(mp).snapshot()["flush_reasons"] == {"demand": 1}


def test_submit_shape_mismatch_rejected(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue()
    q.submit(mp, _rows(2))
    with pytest.raises(ValueError, match="feature-shape mismatch"):
        q.submit(mp, torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="rows"):
        q.submit(mp, torch.zeros((0, 2)))
    q.flush()


def test_submitted_numpy_rows_are_copied(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue()
    x = _rows(4).numpy()
    want = _eng(mp)(torch.from_numpy(x.copy()))
    f = q.submit(mp, x)
    x[:] = 1e6  # the caller reuses its buffer before the flush
    q.flush()
    assert torch.equal(f.result(5), want)


def test_multiplexed_bundles_one_queue(tmp_path):
    mp1 = _lin_bundle(tmp_path, "m1", seed=1)
    mp2 = _lin_bundle(tmp_path, "m2", seed=2)
    q = _queue()
    xs = [_rows(4, seed=i) for i in range(4)]
    f1a, f2a = q.submit(mp1, xs[0]), q.submit(mp2, xs[1])
    f1b, f2b = q.submit(mp1, xs[2]), q.submit(mp2, xs[3])
    q.flush()
    e1, e2 = _eng(mp1), _eng(mp2)
    assert torch.equal(f1a.result(1), e1(xs[0]))
    assert torch.equal(f2a.result(1), e2(xs[1]))
    assert torch.equal(f1b.result(1), e1(xs[2]))
    assert torch.equal(f2b.result(1), e2(xs[3]))
    assert q.stats(mp1).snapshot()["batches"] == 1
    assert q.stats(mp2).snapshot()["batches"] == 1
    assert q.stats(mp1).snapshot()["rows_completed"] == 8


# ------------------------------------------------------ deadline flush -----
def test_deadline_flush_thread_bit_identical_to_sync(tmp_path):
    mp = _lin_bundle(tmp_path)
    x = _rows(6, seed=3)
    ref = _region(6, "infer", mp)(x=x)["out"]
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_delay_s=0.05))
    q.start()
    try:
        out = _region(6, "infer_async", mp, serving=q)(x=x).result(
            timeout=10)["out"]
    finally:
        q.close()
    assert torch.equal(out, ref)
    assert q.stats(mp).snapshot()["flush_reasons"].get("deadline", 0) >= 1


def test_deadline_flush_poll_deterministic(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_delay_s=0.02))
    f = q.submit(mp, _rows(4))
    assert q.poll() == 0
    time.sleep(0.03)
    assert q.poll() == 4
    assert f.done()
    assert q.stats(mp).snapshot()["flush_reasons"] == {"deadline": 1}


# -------------------------------------------------------- backpressure -----
def test_backpressure_raises_when_not_blocking(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_pending_rows=8,
                           block=False))
    q.submit(mp, _rows(8))
    with pytest.raises(Backpressure):
        q.submit(mp, _rows(4))
    q.flush()
    q.submit(mp, _rows(4))
    q.flush()


def test_backpressure_oversized_request_admitted_when_empty(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_pending_rows=4,
                           block=False))
    f = q.submit(mp, _rows(16))
    q.flush()
    assert f.result(1).shape == (16, 1)


def test_backpressure_thread_free_drains_inline(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_pending_rows=8,
                           block=True, block_timeout_s=5.0))
    f1 = q.submit(mp, _rows(8))
    f2 = q.submit(mp, _rows(8))
    assert f1.done()
    assert q.stats(mp).snapshot()["flush_reasons"]["backpressure"] == 1
    q.flush()
    assert f2.result(1).shape == (8, 1)


def test_backpressure_block_timeout_with_idle_thread(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_pending_rows=8,
                           block=True, block_timeout_s=0.05))
    q.start()
    try:
        q.submit(mp, _rows(8))
        t0 = time.monotonic()
        with pytest.raises(Backpressure, match="blocked"):
            q.submit(mp, _rows(8))
        assert time.monotonic() - t0 >= 0.04
    finally:
        q.close()


def test_backpressure_unblocks_on_dispatcher_drain(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=8, max_pending_rows=8,
                           block=True, block_timeout_s=10.0))
    q.start()
    try:
        q.submit(mp, _rows(8))
        out = q.submit(mp, _rows(8)).result(timeout=10)
    finally:
        q.close()
    assert out.shape == (8, 1)


# ---------------------------------------------------------- statistics -----
def test_stats_counters_and_latency(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=1024, min_bucket=8))
    for i in range(3):
        q.submit(mp, _rows(2, seed=i))
    q.flush()
    st = q.stats(mp).snapshot()
    assert st["requests_enqueued"] == 3 and st["rows_enqueued"] == 6
    assert st["requests_completed"] == 3 and st["rows_completed"] == 6
    assert st["bucket_rows"] == 8 and st["padded_rows"] == 2
    assert st["latency_p50_ms"] > 0
    assert st["latency_p99_ms"] >= st["latency_p50_ms"]
    assert st["rows_per_s"] > 0
    assert st["queue_depth_rows"] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_latencies_same_percentiles(seed):
    rng = np.random.default_rng(seed)
    lats = sorted(rng.exponential(0.01, size=int(rng.integers(1, 500))))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert _percentile(lats, q) == jpercentile(lats, q)
    mine, ref = ServeStats("k", latency_window=64), JServeStats(
        "k", latency_window=64)
    for i in range(0, len(lats), 7):
        kw = dict(requests=len(lats[i:i + 7]), rows=len(lats[i:i + 7]),
                  bucket=8, reason="t", busy_s=0.001,
                  latencies_s=lats[i:i + 7])
        mine.on_batch(**kw)
        ref.on_batch(**kw)
    a, b = mine.snapshot(), ref.snapshot()
    for k in ("latency_p50_ms", "latency_p99_ms", "batch_occupancy",
              "bucket_rows", "padded_rows", "rows_completed"):
        assert a[k] == b[k], k


def test_batch_failure_propagates_to_all_futures(tmp_path):
    q = _queue(FlushPolicy())
    key = str(tmp_path / "no_such_bundle")
    f1 = q.submit(key, _rows(2))
    f2 = q.submit(key, _rows(2))
    q.flush()
    with pytest.raises(Exception):
        f1.result(1)
    with pytest.raises(Exception):
        f2.result(1)
    st = q.stats(key).snapshot()
    assert st["batches"] == 0 and st["batches_failed"] == 1
    assert st["requests_completed"] == 0 and st["requests_failed"] == 2
    assert st["rows_completed"] == 0 and st["rows_failed"] == 4
    assert st["rows_per_s"] == 0.0
    assert st["queue_depth_rows"] == 0 and st["queue_depth_requests"] == 0


# ------------------------------------------------- parity with the reference
def _jregion(n, mode, model, serving=None):
    rngs = {"i": (0, n)}
    return jax_approx_ml(
        lambda x: {"out": x[:, :1] * 2 + x[:, 1:] * 0.5}, name="lin",
        inputs={"x": (jax_functor("sin: [i, 0:2] = ([i, 0:2])"), rngs)},
        outputs={"out": (jax_functor("sout: [i, 0:1] = ([i, 0:1])"), rngs)},
        mode=mode, model=model, serving=serving)


@pytest.mark.parametrize("seed", [0, 1])
def test_same_requests_same_batches_in_both_queues(tmp_path, seed):
    """The same request script through both queues in ``poll()`` mode:
    the same flushes, batches and buckets; the port's rows bit-identical
    to its own synchronous ``infer`` and within 1e-4 of the
    reference's."""
    mp = _lin_bundle(tmp_path, seed=seed, hidden=32)
    rng = np.random.default_rng(seed)
    sizes = [int(rng.choice([1, 3, 7, 20, 64])) for _ in range(24)]
    pol = dict(max_batch_rows=96, max_delay_s=None, min_bucket=8,
               max_pending_rows=10 ** 6)
    q, jq = _queue(FlushPolicy(**pol)), JServeQueue(JFlushPolicy(**pol))
    handles = []
    for i, n in enumerate(sizes):
        x = _rows(n, seed=1000 * seed + i)
        h = _region(n, "infer_async", mp, serving=q)(x=x)
        jh = _jregion(n, "infer_async", mp, serving=jq)(x=jnp.asarray(
            x.numpy()))
        handles.append((n, x, h, jh))
        if i % 5 == 4:
            assert q.poll() == jq.poll()
    q.flush()
    jq.flush()
    for n, x, h, jh in handles:
        got = h.result(5)["out"]
        assert torch.equal(got, _region(n, "infer", mp)(x=x)["out"])
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jh.result(5)["out"]),
                                   rtol=RTOL, atol=ATOL)
    a, b = q.stats(mp).snapshot(), jq.stats(mp).snapshot()
    for k in ("batches", "bucket_rows", "padded_rows", "rows_completed",
              "requests_completed", "flush_reasons"):
        assert a[k] == b[k], k


def test_futures_resolve_to_views_of_the_landed_batch(tmp_path):
    """The form futures return rows in: CPU tensors, row views of one
    landed buffer (the reference returns numpy views of one)."""
    mp = _lin_bundle(tmp_path)
    q = _queue()
    fa, fb = q.submit(mp, _rows(3, seed=1)), q.submit(mp, _rows(2, seed=2))
    q.flush()
    ya, yb = fa.result(1), fb.result(1)
    assert isinstance(ya, torch.Tensor) and ya.device.type == "cpu"
    assert ya.untyped_storage().data_ptr() == yb.untyped_storage().data_ptr()
    assert yb.data_ptr() == ya.data_ptr() + 3 * ya.element_size()


# ------------------------------------------------------- host staging ------
def test_scratch_pool_never_reuses_a_buffer_with_a_live_view():
    pool = ScratchPool()
    a = pool.take((4, 3), torch.float32)
    base = a.untyped_storage().data_ptr()
    b = pool.take((4, 3), torch.float32)
    assert b.untyped_storage().data_ptr() != base
    sub = a[1:2]  # a view of a view keeps the buffer too
    del a
    c = pool.take((4, 3), torch.float32)
    assert c.untyped_storage().data_ptr() != base
    del sub, b, c
    n = pool.take((4, 3), torch.float32).numpy()  # numpy views count too
    d = pool.take((4, 3), torch.float32)
    assert n.ctypes.data == base and d.untyped_storage().data_ptr() != base
    del n, d
    e = pool.take((2, 2), torch.float32)
    assert e.untyped_storage().data_ptr() == base
    assert pool.stats()["misses"] == 3 and pool.stats()["pinned_bytes"] == 0


def test_held_rows_stay_valid_across_later_batches(tmp_path):
    """A caller that keeps its rows while the queue serves more batches
    sees them unchanged: the pool hands their buffer to no one."""
    mp = _lin_bundle(tmp_path)
    q = _queue()
    x = _rows(5, seed=9)
    f = q.submit(mp, x)
    q.flush()
    held = f.result(1)
    want = held.clone()
    for i in range(6):
        g = q.submit(mp, _rows(5, seed=i))
        q.flush()
        g.result(1)
    assert torch.equal(held, want)
    assert q._batcher.scratch.stats()["hits"] > 0


def test_consumed_async_results_release_the_landing_buffer(tmp_path):
    """A handle whose result was bridged drops its future's view of the
    landed batch, so the next batches are pool hits even while the
    caller keeps its handles."""
    mp = _lin_bundle(tmp_path)
    q = _queue()
    region = _region(4, "infer_async", mp, serving=q)
    handles = []
    for i in range(5):
        h = region(x=_rows(4, seed=i))
        q.flush()
        h.result(1)
        handles.append(h)
    st = q._batcher.scratch.stats()
    assert st["misses"] == 2 and st["hits"] == 8  # rows + flags, 5 batches
    assert all(h.deferred() and h.done() for h in handles)


def test_int8_rows_coalesced_bit_identical(tmp_path, monkeypatch):
    """The gated int8 tier (forced on the CPU, served by its plain
    version): coalesced rows equal synchronous rows bit for bit."""
    import repro_torch.tune.cache as tcache
    from repro_torch.nn import MLP, save_model
    from repro_torch.quant.budgets import clear_budgets, set_rmse_budget
    from repro_torch.quant.gate import GATE_NAMESPACE, gate_bundle
    from repro_torch.tune.cache import TuneCache
    monkeypatch.setattr(tcache, "_default", {
        GATE_NAMESPACE: TuneCache(GATE_NAMESPACE,
                                  path=tmp_path / "quant_gate.json")})
    monkeypatch.setenv("REPRO_QUANT", "force")
    mp = save_model(tmp_path / "q", MLP((1, 4), [32, 16], 2).init(0))
    try:
        set_rmse_budget(mp, 1e9)
        assert gate_bundle(mp, _rows(64, d=4).numpy(), device="cpu")["exact"]
        eng = _eng(mp)
        assert eng.route == "fused_mlp_int8"
        q = _queue()
        xs = [_rows(n, seed=n, d=4) for n in (1, 5, 13, 30)]
        futs = [q.submit(mp, x) for x in xs]
        q.flush()
        for x, f in zip(xs, futs):
            assert torch.equal(f.result(1), eng(x))
    finally:
        clear_budgets()


# ----------------------------------------------------- region async API ----
def test_region_infer_async_bit_identical_to_infer(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue()
    x = _rows(8, seed=4)
    h = _region(8, "infer_async", mp, serving=q)(x=x)
    assert h.deferred() and not h.done()
    q.flush()
    assert torch.equal(h.result(1)["out"],
                       _region(8, "infer", mp)(x=x)["out"])


def test_region_infer_async_requires_queue(tmp_path):
    with pytest.raises(ValueError, match="serving"):
        _region(8, "infer_async", _lin_bundle(tmp_path))


def test_predicated_region_serving_defers(tmp_path):
    mp = _lin_bundle(tmp_path)
    q = _queue()
    r = _region(8, "predicated", mp, serving=q)
    x = _rows(8, seed=6)
    h_acc = r(predicate=False, x=x)
    assert not h_acc.deferred() and h_acc.done()
    assert torch.equal(h_acc.result()["out"], _lin(x)["out"])
    h_ml = r(predicate=True, x=x)
    assert h_ml.deferred() and not h_ml.done()
    q.flush()
    assert torch.equal(h_ml.result(1)["out"],
                       _region(8, "infer", mp)(x=x)["out"])


def test_async_result_timeout_is_not_a_fallback(tmp_path):
    """A caller's own time budget running out raises; it is not a
    surrogate failure."""
    mp = _lin_bundle(tmp_path)
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6, max_delay_s=5.0))
    q.start()
    try:
        h = _region(4, "infer_async", mp, serving=q)(x=_rows(4))
        with pytest.raises(TimeoutError):
            h.result(0.01)
    finally:
        q.close()
    assert h.result(5)["out"].shape == (4, 1)


# ----------------------------------------------------------- app drivers ---
def test_binomial_chunked_async_driver(tmp_path):
    from repro.apps import binomial as jbin
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    from repro_torch.apps import binomial
    net = MLP((1, 5), [16], 1)
    mp = save_model(tmp_path / "bin", net, net.init(jax.random.PRNGKey(0)))
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6))
    region = binomial.make_region(8, mode="infer_async", model=mp,
                                  serving=q, device="cpu")
    opts = binomial.make_inputs(32, seed=9, device="cpu")
    out = binomial.price_chunks_async(opts, region, q, chunk=8)
    r_sync = binomial.make_region(32, mode="infer", model=mp, device="cpu")
    assert torch.equal(out, r_sync(opts=opts)["out"])
    st = q.stats(mp).snapshot()
    assert st["batches"] == 1 and st["rows_completed"] == 32
    jq = JServeQueue(JFlushPolicy(max_batch_rows=10 ** 6))
    jregion = jbin.make_region(8, mode="infer_async", model=mp, serving=jq)
    want = jbin.price_chunks_async(jbin.make_inputs(32, seed=9), jregion,
                                   jq, chunk=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="chunks"):
        binomial.price_chunks_async(opts[:30], region, q, chunk=8)


def test_miniweather_ensemble_async_driver(tmp_path):
    from repro.apps import miniweather as jmw
    from repro.nn.layers import Activation, Conv2D, Sequential
    from repro.nn.serialize import save_model
    from repro_torch.apps import miniweather
    ny, nx = miniweather.NY - 2, miniweather.NX - 2
    net = Sequential([Conv2D(8, 3), Activation("relu"), Conv2D(4, 3)],
                     (1, ny, nx, 20))
    mp = save_model(tmp_path / "mw", net, net.init(jax.random.PRNGKey(0)))
    q = _queue(FlushPolicy(max_batch_rows=10 ** 6))
    region = miniweather.make_region(mode="infer_async", model=mp,
                                     serving=q, device="cpu")
    states = [miniweather.init_state(seed=s, device="cpu") for s in range(3)]
    outs = miniweather.run_ensemble_async(states, steps=2, region=region,
                                          queue=q)
    r_sync = miniweather.make_region(mode="infer", model=mp, device="cpu")
    jq = JServeQueue(JFlushPolicy(max_batch_rows=10 ** 6))
    jouts = jmw.run_ensemble_async(
        [jmw.init_state(seed=s) for s in range(3)], steps=2,
        region=jmw.make_region(mode="infer_async", model=mp, serving=jq),
        queue=jq)
    for s0, got, jgot in zip(states, outs, jouts):
        ref = s0
        for _ in range(2):
            ref = r_sync(state=ref)["state"]
        # a conv's sums over a batch of 3 and of 1 may be ordered apart
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot),
                                   rtol=1e-4, atol=1e-4)
    st = q.stats(mp).snapshot()
    assert st["batches"] == 2 and st["rows_completed"] == 6
