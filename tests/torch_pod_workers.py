"""Targets of the port's spawned CPU pods (``repro_torch.launch.multihost.
spawn_local_pod``), kept apart from the test modules so the pod
processes import neither JAX nor the reference package.

``tests/test_torch_multihost.py`` and ``tests/test_torch_pod_obs.py``
each spawn one pod of two processes on the CPU and check what these
functions return.
"""
import os
import time

#: the host-drop drill's stall and watchdog in the CPU pod (seconds)
DRILL_STALL_S, DRILL_WATCHDOG_S = 3.0, 1.0


def raising():
    raise ValueError("worker boom")


def exiting():
    os._exit(3)


def fail_while_peer_hangs():
    if os.environ.get("REPRO_PROCESS_ID") == "1":
        raise ValueError("early boom")
    time.sleep(120)  # a peer hung in a now-peerless collective


def _bundle(path, seed, inputs=5):
    from repro_torch.nn import MLP
    from repro_torch.nn.serialize import save_model
    return save_model(path, MLP((1, inputs), [16], 1).init(seed=seed))


def _rows(n, seed, inputs=5):
    import numpy as np
    return np.random.default_rng(seed).standard_normal(
        (n, inputs)).astype(np.float32)


def _serve_one(path, x):
    """Single-process, mesh-less serving of ``x``."""
    import torch

    from repro_torch.core.engine import InferenceEngine
    return InferenceEngine.get(path, "cpu")(torch.from_numpy(x)).numpy()


def substrate_and_serve(tmp):
    """One pod process: the agreement collectives, ``make_global``'s
    per-host blocks, the cross-host round trip, disjoint key sets and a
    host with zero rows."""
    import numpy as np
    import torch

    from repro_torch.dist.sharding import ShardCtx, block_offset, use_mesh
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.serve import FlushPolicy, ServeQueue
    from repro_torch.serve.batcher import Batcher

    pid, nproc = multihost.process_index(), multihost.process_count()
    mesh = make_pod_mesh(device="cpu")
    ctx = ShardCtx(mesh, multi_pod=True)
    out = {"pid": pid, "nproc": nproc,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "counts": multihost.allgather_counts(pid + 3).tolist(),
           "blobs": multihost.allgather_bytes(b"h%d" % pid * (pid + 1)),
           "data_size": ctx.axis_size("data"),
           "data_axes": ctx.mesh_axes_for("data"),
           "spec": ctx.spec_for((8, 4), ("data", None))}

    # per-host feeding: each host contributes 2 distinct rows
    local = (torch.full((2, 3), float(pid))
             + torch.arange(2, dtype=torch.float32)[:, None] * 0.5)
    g = ctx.make_global(local, ("data", None), global_shape=(2 * nproc, 3))
    with use_mesh(mesh, multi_pod=True):
        y = g + 1.0
    start = block_offset(mesh, y.placements, 0, 2 * nproc)
    out["global_shape"] = tuple(g.shape)
    out["placements"] = [str(p) for p in g.placements]
    out["mine"] = {start: y.to_local()[:, 0].tolist()}
    landed, _ = Batcher(device="cpu")._to_host(y, rows=(start, start + 2))
    out["landed_own"] = landed[:, 0].tolist()
    other = (2 * (1 - pid), 2 * (1 - pid) + 2)
    try:
        Batcher(device="cpu")._to_host(y, rows=other)
        out["other_rows"] = "read"
    except RuntimeError as e:
        out["other_rows"] = str(e)
    try:
        ctx.make_global(local[:1], ("data", None),
                        global_shape=(2 * nproc, 3))
        out["bad_block"] = "accepted"
    except ValueError as e:
        out["bad_block"] = str(e)

    # the cross-host round trip, as run_smoke runs it
    out["smoke"] = multihost._smoke_worker(tmp)

    # disjoint key sets: host 0 holds rows for a, host 1 for b
    a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    if pid == 0:
        _bundle(a, 1)
        _bundle(b, 2)
    multihost.barrier()
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
    key = a if pid == 0 else b
    x = _rows(4 + 2 * pid, seed=10 + pid)
    with use_mesh(mesh, multi_pod=True):
        fut = q.submit(key, x)
        out["union_dispatched"] = q.pod_flush()
    out["union_equal"] = bool(np.array_equal(fut.result(60).numpy(),
                                             _serve_one(key, x)))
    out["union_stats"] = {k: {f: q.stats(p).snapshot()[f] for f in
                              ("pod_batches", "remote_rows", "bucket_rows",
                               "queue_depth_rows")}
                          for k, p in (("a", a), ("b", b))}

    # a host with zero rows joins the collective for key a
    x2 = _rows(5, seed=20)
    with use_mesh(mesh, multi_pod=True):
        fut2 = q.submit(a, x2) if pid == 0 else None
        out["zero_dispatched"] = q.pod_flush(a)
    out["zero_equal"] = fut2 is None or bool(np.array_equal(
        fut2.result(60).numpy(), _serve_one(a, x2)))
    out["zero_stats"] = {f: q.stats(a).snapshot()[f]
                         for f in ("pod_batches", "remote_rows",
                                   "bucket_rows")}
    q.close()
    multihost.barrier()
    return out


def traced_pod_and_drill(tmp):
    """One pod process, run with ``REPRO_TRACE=1``: a traced pod flush
    and ``pod_snapshot``, then the host-drop drill in the same pod
    (the fault and the watchdog set here)."""
    import numpy as np

    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.obs import TRACER, pod_snapshot
    from repro_torch.resilience.faults import FAULTS
    from repro_torch.serve import FlushPolicy, ServeQueue

    pid = multihost.process_index()
    path = os.path.join(tmp, "m")
    if pid == 0:
        _bundle(path, 0, inputs=2)
    multihost.barrier()
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device="cpu")
    x = np.full((3, 2), float(pid), np.float32)
    with use_mesh(make_pod_mesh(device="cpu"), multi_pod=True):
        fut = q.submit(path, x)
        q.pod_flush(path)
    got = fut.result(60).numpy()
    spans = [{"name": s.name, "trace": s.trace, "cat": s.cat}
             for s in TRACER.events()]
    snaps = pod_snapshot()  # collective: every host must reach this
    out = {"pid": pid, "enabled": TRACER.enabled, "spans": spans,
           "equal": bool(np.array_equal(got, _serve_one(path, x))),
           "snap_processes": [s["process"] for s in snaps],
           "snap_agree": [sum(e["name"] == "pod.agree" for e in s["events"])
                          for s in snaps]}
    q.close()
    os.environ[multihost.ENV_POD_WATCHDOG] = str(DRILL_WATCHDOG_S)
    FAULTS.configure(f"pod.flush:drop:pid=1,stall={DRILL_STALL_S}")
    out["drill"] = multihost._host_drop_worker(os.path.join(tmp, "drill"))
    return out
