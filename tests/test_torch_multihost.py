"""Port parity of the multi-process pod (``repro_torch.launch.multihost``,
``ServeQueue.pod_flush``, ``Batcher.dispatch_pod``,
``ShardCtx.make_global(global_shape=)``) on the CPU, against
``repro.launch.multihost`` and ``repro.serve``.

The cases are the twins of tests/test_multihost.py's bootstrap, spawn
harness, single-process ``pod_flush`` and spawned-pod cases.  In one
process: the bootstrap, the spawn harness's error reporting, the dtype
table and slab layout, ``make_global`` refusing a partial block with the
reference's message, and ``pod_flush`` against the reference's on the
same bundle and rows (the same bucket, pod batches, remote rows and
queue depth; rows within ``RTOL``/``ATOL`` of the reference's eager
engine and bit for bit the port's synchronous call).  In one spawned CPU
pod of two processes (``tests/torch_pod_workers.py``): the agreement
collectives, each process's block of a global DTensor, the cross-host
round trip (remote rows 15, bucket 32, bit for bit one-process
serving), disjoint key sets agreed across hosts, and a host with zero
rows joining the collective.
"""
import time

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.serve import FlushPolicy as JFlushPolicy  # noqa: E402
from repro.serve import ServeQueue as JServeQueue  # noqa: E402
from repro.serve.batcher import Batcher as JBatcher  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.dist.sharding import ShardCtx, use_mesh  # noqa: E402
from repro_torch.launch import multihost  # noqa: E402
from repro_torch.launch.mesh import make_pod_mesh  # noqa: E402
from repro_torch.serve import FlushPolicy, ServeQueue  # noqa: E402
from repro_torch.serve.batcher import POD_DTYPES, Batcher  # noqa: E402
from test_torch_dist import one_rank_group  # noqa: E402

#: fused_mlp's declared tolerance against the reference (the plain
#: version and the reference's XLA dots sum in different orders)
RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_engines():
    InferenceEngine.invalidate()
    JaxEngine.invalidate()
    yield
    InferenceEngine.invalidate()
    JaxEngine.invalidate()


def _bundle(tmp, seed=0):
    """An MLP bundle written by the reference (the port reads it)."""
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 2), [16], 1)
    return save_model(tmp / "m", net, net.init(jax.random.PRNGKey(seed)))


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


# ----------------------------------------------------------- bootstrap -----
def test_bootstrap_single_process_noop(monkeypatch):
    for var in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
                multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    info = multihost.bootstrap()
    assert info == multihost.PodInfo(0, 1, None)
    assert not info.is_multiprocess
    assert not torch.distributed.is_initialized()


def test_bootstrap_multiprocess_requires_coordinator(monkeypatch):
    monkeypatch.delenv(multihost.ENV_COORDINATOR, raising=False)
    with pytest.raises(RuntimeError, match="coordinator"):
        multihost.bootstrap(num_processes=2, process_id=0)


def test_allgather_counts_single_process():
    assert multihost.allgather_counts(7).tolist() == [7]
    assert multihost.allgather_ints([3, -1]).tolist() == [[3, -1]]
    assert multihost.allgather_bytes(b"payload \x00\xff") == \
        [b"payload \x00\xff"]
    multihost.barrier("noop")  # single-process barrier: no collective
    multihost.store_barrier("noop")
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


def test_pod_watchdog_reads_the_env(monkeypatch):
    monkeypatch.setenv(multihost.ENV_POD_WATCHDOG, "2.5")
    assert multihost.pod_watchdog_s() == 2.5
    monkeypatch.setenv(multihost.ENV_POD_WATCHDOG, "bad")
    assert multihost.pod_watchdog_s() == 30.0
    monkeypatch.delenv(multihost.ENV_POD_WATCHDOG)
    assert multihost.pod_watchdog_s() == 30.0


def test_spawn_local_pod_rejects_bad_n():
    with pytest.raises(ValueError):
        multihost.spawn_local_pod(0, "os:getcwd", device="cpu")


def test_spawn_local_pod_worker_exception_not_a_timeout():
    with pytest.raises(multihost.PodWorkerError, match="worker boom"):
        multihost.spawn_local_pod(1, "torch_pod_workers:raising",
                                  timeout_s=120.0, device="cpu")


def test_spawn_local_pod_crashed_child_reports_exit_code():
    with pytest.raises(multihost.PodWorkerError, match="exited 3"):
        multihost.spawn_local_pod(1, "torch_pod_workers:exiting",
                                  timeout_s=120.0, device="cpu")


def test_spawn_local_pod_fast_failure_not_masked_by_hung_peer(monkeypatch):
    """A worker error surfaces within the failure grace (cut to 2 s
    here), as the real exception, not after the whole budget as a
    timeout blaming the hung peer."""
    monkeypatch.setattr(multihost, "FAIL_GRACE_S", 2.0)
    t0 = time.monotonic()
    with pytest.raises(multihost.PodWorkerError, match="early boom"):
        multihost.spawn_local_pod(
            2, "torch_pod_workers:fail_while_peer_hangs", timeout_s=110.0,
            device="cpu")
    assert time.monotonic() - t0 < 60.0


# ---------------------------------------------------- dtypes and slabs -----
def test_dtype_table_round_trips_and_refuses_unknown():
    for i, dt in enumerate(POD_DTYPES):
        assert Batcher._dtype_from_num(i) is dt
    for num in (-2, len(POD_DTYPES)):
        with pytest.raises(ValueError, match="unknown dtype num"):
            Batcher._dtype_from_num(num)
    # the reference's message, word for word
    with pytest.raises(ValueError) as jerr:
        JBatcher._dtype_from_num(10 ** 6)
    with pytest.raises(ValueError) as terr:
        Batcher._dtype_from_num(10 ** 6)
    assert str(terr.value) == str(jerr.value)


def test_slab_layout_of_an_idle_host(tmp_path):
    mp = _bundle(tmp_path)
    b = Batcher(device="cpu")
    eng = InferenceEngine.get(mp, "cpu")
    jeng = JaxEngine.get(mp)
    feat, dtype = b._slab_layout([], eng, POD_DTYPES.index(torch.float64))
    jfeat, _ = JBatcher()._slab_layout([], jeng, np.dtype(np.float64).num)
    assert feat == jfeat == (2,) and dtype is torch.float64
    assert b._slab_layout([], eng) == ((2,), torch.float32)


def test_to_host_reads_the_rows_asked_for():
    b = Batcher(device="cpu")
    y = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    out, finite = b._to_host(y, rows=(4, 8))
    assert torch.equal(out, y[4:8]) and bool(finite.all())


def test_make_global_single_process_refuses_a_partial_block():
    block = np.zeros((2, 3), np.float32)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("pod", "data"))
    with pytest.raises(ValueError) as jerr:
        jsharding.ShardCtx(jmesh, multi_pod=True).make_global(
            block, ("data", None), global_shape=(4, 3))
    with one_rank_group():
        mesh = make_pod_mesh(device="cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
            {"pod": 1, "data": 1}
        ctx = ShardCtx(mesh, multi_pod=True)
        with pytest.raises(ValueError) as terr:
            ctx.make_global(torch.from_numpy(block), ("data", None),
                            global_shape=(4, 3))
        g = ctx.make_global(torch.ones(4, 3), ("data", None),
                            global_shape=(4, 3))
        assert tuple(g.shape) == (4, 3) and torch.equal(g.to_local(),
                                                        torch.ones(4, 3))
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------- pod_flush (single process) ----
def test_pod_flush_single_process_matches_reference(tmp_path):
    mp = _bundle(tmp_path)
    xs = [_rows(5, s) for s in range(3)]
    jq = JServeQueue(JFlushPolicy(max_batch_rows=1 << 30))
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
    jfuts = [jq.submit(mp, x) for x in xs]
    futs = [q.submit(mp, x) for x in xs]
    assert jq.pod_flush(mp) == q.pod_flush(mp) == 15
    eng = InferenceEngine.get(mp, "cpu")
    for f, jf, x in zip(futs, jfuts, xs):
        got = f.result(timeout=30)
        assert torch.equal(got, eng(torch.from_numpy(x)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jf.result(30)),
                                   rtol=RTOL, atol=ATOL)
    fields = ("bucket_rows", "pod_batches", "remote_rows",
              "queue_depth_rows", "rows_completed", "padded_rows")
    snap, jsnap = q.stats(mp).snapshot(), jq.stats(mp).snapshot()
    assert {f: snap[f] for f in fields} == {f: jsnap[f] for f in fields}
    assert snap["bucket_rows"] == 16 and snap["pod_batches"] == 1
    assert snap["remote_rows"] == 0 and snap["queue_depth_rows"] == 0


def test_pod_flush_single_process_under_a_pod_mesh(tmp_path):
    """One process, one rank: the pod mesh is 1 x 1, the batch a DTensor
    of it, the rows bit for bit the synchronous call's."""
    mp = _bundle(tmp_path)
    xs = [_rows(3, s) for s in range(4)]
    with one_rank_group():
        q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
        with use_mesh(make_pod_mesh(device="cpu"), multi_pod=True):
            futs = [q.submit(mp, x) for x in xs]
            assert q.pod_flush() == 12
    eng = InferenceEngine.get(mp, "cpu")
    for f, x in zip(futs, xs):
        assert torch.equal(f.result(30), eng(torch.from_numpy(x)))
    assert q.stats(mp).snapshot()["bucket_rows"] == 16


def test_pod_flush_empty_is_noop(tmp_path):
    q = ServeQueue(FlushPolicy(), device="cpu")
    jq = JServeQueue(JFlushPolicy())
    missing = str(tmp_path / "missing")
    assert q.pod_flush(missing) == jq.pod_flush(missing) == 0
    assert q.pod_flush() == 0


def test_pod_flush_rejects_started_queue():
    q = ServeQueue(FlushPolicy(max_delay_s=10.0), device="cpu").start()
    try:
        with pytest.raises(RuntimeError, match="thread"):
            q.pod_flush("anything")
    finally:
        q.stop()


def test_dispatch_pod_without_a_mesh_across_processes_fails_its_requests(
        tmp_path, monkeypatch):
    """Across processes a pod flush needs a pod mesh: the requests fail
    with the reason and the error is re-raised (pod-fatal)."""
    mp = _bundle(tmp_path)
    monkeypatch.setattr(multihost, "allgather_ints",
                        lambda v: np.array([list(v), [4, 0]], np.int64))
    b = Batcher(device="cpu")
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), batcher=b)
    fut = q.submit(mp, _rows(3))
    reqs = q._pending.pop(mp)
    with pytest.raises(RuntimeError, match="pod mesh"):
        b.dispatch_pod(mp, reqs, q.stats(mp))
    with pytest.raises(RuntimeError, match="pod mesh"):
        fut.result(1)
    assert q.stats(mp).snapshot()["requests_failed"] == 1


# ------------------------------------------------ spawned pod of two -------
@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    return multihost.spawn_local_pod(
        2, "torch_pod_workers:substrate_and_serve",
        (str(tmp_path_factory.mktemp("pod")),), timeout_s=240.0,
        device="cpu")


def test_pod_substrate(pod):
    assert [r["pid"] for r in pod] == [0, 1]
    for r in pod:
        assert r["nproc"] == 2 and r["mesh"] == {"pod": 2, "data": 1}
        assert r["counts"] == [3, 4]  # pid 0 sent 3, pid 1 sent 4
        assert r["blobs"] == [b"h0", b"h1h1"]
        # "data" resolves across the pod: one row of the mesh a process
        assert r["data_size"] == 2 and r["data_axes"] == ("pod",)
        assert r["spec"] == ("pod", None)
        assert r["global_shape"] == (4, 3)
        assert r["placements"] == ["S(0)", "R"]
        assert "owned by other processes" in r["other_rows"]
        assert "is not this process's block" in r["bad_block"]
    # each host's block is exactly its own contributed rows, plus one
    assert pod[0]["mine"] == {0: [1.0, 1.5]}
    assert pod[1]["mine"] == {2: [2.0, 2.5]}
    assert pod[0]["landed_own"] == [1.0, 1.5]
    assert pod[1]["landed_own"] == [2.0, 2.5]


def test_cross_host_serve_round_trip(pod):
    for r in (p["smoke"] for p in pod):
        assert r["equal"]
        assert r["remote_rows"] == 15      # the other host's 3x5 rows
        assert r["bucket"] == 32           # per-slab 16 x 2 hosts
        assert r["pod_batches"] == 1
        assert r["route"] == "sequential" and r["launches"] == {}


def test_pod_flush_agrees_disjoint_key_sets(pod):
    """Host 0 holds 4 rows for a, host 1 6 rows for b: both flush both
    keys (a zero slab for the key a host lacks), rows exact."""
    r0, r1 = pod
    assert r0["union_dispatched"] == 4 and r1["union_dispatched"] == 6
    assert r0["union_equal"] and r1["union_equal"]
    assert r0["union_stats"]["a"] == {"pod_batches": 1, "remote_rows": 0,
                                      "bucket_rows": 16,
                                      "queue_depth_rows": 0}
    assert r1["union_stats"]["a"] == {"pod_batches": 1, "remote_rows": 4,
                                      "bucket_rows": 16,
                                      "queue_depth_rows": 0}
    assert r0["union_stats"]["b"]["remote_rows"] == 6
    assert r1["union_stats"]["b"]["remote_rows"] == 0
    assert r0["union_stats"]["b"]["bucket_rows"] == 16


def test_pod_flush_host_with_zero_rows_joins(pod):
    r0, r1 = pod
    assert r0["zero_dispatched"] == 5 and r1["zero_dispatched"] == 0
    assert r0["zero_equal"] and r1["zero_equal"]
    # both hosts recorded the second pod batch of key a, 8 x 2 rows
    assert r0["zero_stats"] == {"pod_batches": 2, "remote_rows": 0,
                                "bucket_rows": 32}
    assert r1["zero_stats"] == {"pod_batches": 2, "remote_rows": 9,
                                "bucket_rows": 32}
