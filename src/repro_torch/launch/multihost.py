"""Multi-process pod bootstrap and local test harness (counterpart of
``repro/launch/multihost.py``).

The pod is a ``torch.distributed`` gloo group in which every process is
one rank on one device (the reference's ``devices_per_host`` and
``REPRO_LOCAL_DEVICES``, forced XLA host devices, have no counterpart):

``bootstrap()``
    Reads the reference's variables (``REPRO_COORDINATOR`` as
    ``host:port``, ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``), starts
    a ``TCPStore`` at the coordinator (process 0 hosts it) and a gloo
    group on that store with the given world size and rank.  The group
    has a finite timeout (:data:`POD_TIMEOUT_S`), the part jax's peer
    timeout plays: a collective torn by a dropped peer
    fails after it instead of blocking for gloo's default 30 minutes.
    The store also carries :class:`PodHealth`'s heartbeats.  One process
    is a no-op.

``spawn_local_pod(n, target)``
    The local harness: ``n`` fresh processes (spawn, never fork), each
    bootstrapping into one pod process, run ``target`` ("pkg.mod:fn").
    Children run on the card (``cuda``, all of them on card 0 of a
    one-card machine) unless ``device="cpu"``; a child without a card
    raises.

``allgather_ints`` / ``allgather_bytes`` / ``barrier``
    The agreement collectives of the serve path (per-host row counts
    and dtypes, key sets, obs snapshots), plain ``torch.distributed``
    calls on host tensors: gloo's functional collectives on CUDA tensors
    of a group crash under torch 2.11, its plain collectives on host
    tensors do not.

Nothing heavy is imported at module level: children of
:func:`spawn_local_pod` import this module before their environment is
final, and the observability singletons read it at their import.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import socket
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_POD_WATCHDOG = "REPRO_POD_WATCHDOG_S"
ENV_POD_DEVICE = "REPRO_POD_DEVICE"

#: seconds the gloo group and the bootstrap store wait on a peer (the
#: reference's peer timeout; gloo's own default is 30 minutes)
POD_TIMEOUT_S = 120.0

# the store bootstrap() made: heartbeats and store barriers ride it
_STORE = None


def pod_watchdog_s() -> float:
    """Collective watchdog budget for one guarded ``pod_flush`` round."""
    raw = os.environ.get(ENV_POD_WATCHDOG, "")
    try:
        return float(raw) if raw else 30.0
    except ValueError:
        return 30.0


@dataclasses.dataclass(frozen=True)
class PodInfo:
    """What bootstrap() resolved: this process's place in the pod."""

    process_id: int = 0
    num_processes: int = 1
    coordinator: Optional[str] = None

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def _env_int(value, name: str, default: Optional[int]) -> Optional[int]:
    if value is not None:
        return int(value)
    raw = os.environ.get(name)
    return int(raw) if raw else default


def bootstrap(coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None) -> PodInfo:
    """Join the pod described by args/env; single-process is a no-op.

    Safe to call again once joined: a live group is returned as-is."""
    global _STORE
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    num_processes = _env_int(num_processes, ENV_NUM_PROCESSES, 1)
    process_id = _env_int(process_id, ENV_PROCESS_ID, 0)
    if num_processes <= 1:
        return PodInfo(0, 1, None)
    import datetime

    import torch.distributed as dist
    if not dist.is_initialized():
        if not coordinator:
            raise RuntimeError(
                f"bootstrap: {num_processes} processes requested but no "
                f"coordinator address (set {ENV_COORDINATOR} or pass "
                f"coordinator=)")
        host, _, port = coordinator.rpartition(":")
        timeout = datetime.timedelta(seconds=POD_TIMEOUT_S)
        _STORE = dist.TCPStore(host, int(port), num_processes,
                               is_master=process_id == 0, timeout=timeout)
        dist.init_process_group("gloo", store=_STORE, rank=process_id,
                                world_size=num_processes, timeout=timeout)
    return PodInfo(dist.get_rank(), dist.get_world_size(), coordinator)


def pod_device():
    """This pod process's device: ``REPRO_POD_DEVICE`` (set by
    :func:`spawn_local_pod`), the card when it is unset."""
    from repro_torch.device import resolve_device
    return resolve_device(os.environ.get(ENV_POD_DEVICE) or None)


# ----------------------------------------------------------- pod state -----

def _group_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def is_multiprocess() -> bool:
    return process_count() > 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if _group_up() else 1


def allgather_ints(values: Sequence[int]):
    """Every process's ``values`` as an int64 array [process_count, k].

    The serve path's agreement primitive: every host learns every host's
    pending row count (and row dtype), so all of them derive the same
    per-host slab and global bucket for a cross-host mega-batch.
    Collective: every process must call it at the same point with the
    same ``k``.  Single-process: ``[values]`` without a collective."""
    import numpy as np
    vals = np.asarray([int(v) for v in values], np.int64).reshape(1, -1)
    if not is_multiprocess():
        return vals
    import torch
    import torch.distributed as dist
    mine = torch.from_numpy(vals[0].copy())
    parts = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(parts, mine)
    return torch.stack(parts).numpy()


def allgather_counts(n: int):
    """Per-process values of ``n`` as an int64 array of len process_count."""
    return allgather_ints([n])[:, 0]


def allgather_bytes(data: bytes) -> List[bytes]:
    """Every process's ``data`` blob, ordered by process id: lengths
    first (one :func:`allgather_ints`), then the blobs padded to the
    longest, each cut back to its length.  The transport under
    ``repro_torch.obs.pod_snapshot``.  Collective (same contract as
    ``allgather_ints``); single-process returns ``[data]``."""
    if not is_multiprocess():
        return [bytes(data)]
    lengths = allgather_ints([len(data)])[:, 0]
    m = int(lengths.max())
    if m == 0:
        return [b""] * len(lengths)
    import torch
    import torch.distributed as dist
    padded = torch.zeros((m,), dtype=torch.uint8)
    if data:
        padded[:len(data)] = torch.frombuffer(bytearray(data),
                                              dtype=torch.uint8)
    parts = [torch.empty_like(padded) for _ in range(len(lengths))]
    dist.all_gather(parts, padded)
    return [p[:int(n)].numpy().tobytes() for p, n in zip(parts, lengths)]


def barrier(tag: str = "repro-pod") -> None:
    """Block until every pod process reaches this point (no-op solo).
    ``tag`` names the barrier in the reference; gloo needs none."""
    del tag
    if not is_multiprocess():
        return
    import torch.distributed as dist
    dist.barrier()


def store_barrier(tag: str) -> None:
    """A barrier through the bootstrap store, not the gloo transport,
    so it holds after a torn collective; process 0, which hosts the
    store, leaves last (its peers' last writes must land).  No-op solo
    or without a bootstrap store."""
    if not is_multiprocess() or _STORE is None:
        return
    import datetime
    timeout = datetime.timedelta(seconds=POD_TIMEOUT_S)
    me, n = process_index(), process_count()
    _STORE.set(f"repro_sb_{tag}_in_{me}", "1")
    _STORE.wait([f"repro_sb_{tag}_in_{k}" for k in range(n)], timeout)
    if me:
        _STORE.set(f"repro_sb_{tag}_out_{me}", "1")
    else:
        _STORE.wait([f"repro_sb_{tag}_out_{k}" for k in range(1, n)],
                    timeout)


# ------------------------------------------------------------ pod health ---

class PodHealth:
    """Dropout bookkeeping for this process's view of the pod.

    Every guarded flush round calls :meth:`beat`, which bumps the local
    round counter and best-effort publishes ``repro_hb_<pid>_<round>``
    to the bootstrap store (per-round keys sidestep overwrite
    semantics).  When the collective watchdog fires, :meth:`check_round`
    names the peers whose beat for that round never landed (a host that
    dropped *before* its flush never wrote one) and
    :meth:`mark_degraded` latches local-only serving (gauge
    ``repro_pod_degraded``; ``/healthz`` reports ``pod:host-<k>``).

    :meth:`try_rejoin` runs a barrier under a timeout and clears the
    latch when every peer answers.  After a *torn* collective (the
    watchdog abandoned a live gloo op to a zombie thread) the group's
    sequence of operations may have diverged, so a true rejoin generally
    needs the returning host to restart; the barrier succeeding is
    evidence of health, not a transport repair.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._round = 0
        self.degraded = False
        self.degraded_at: Optional[float] = None  # monotonic stamp
        self.offenders: tuple = ()

    def beat(self) -> int:
        """Start a flush round: bump the counter, publish the heartbeat."""
        with self._lock:
            self._round += 1
            rid = self._round
        if _STORE is not None:
            try:
                _STORE.set(f"repro_hb_{process_index()}_{rid}",
                           str(time.time()))
            except Exception:
                pass  # heartbeat is best-effort; the watchdog still works
        return rid

    def check_round(self, round_id: int) -> tuple:
        """Peers with no heartbeat for ``round_id`` (empty without a
        bootstrap store: degrade generically, name nobody)."""
        if _STORE is None:
            return ()
        me = process_index()
        offenders = []
        for k in range(process_count()):
            if k == me:
                continue
            try:
                seen = _STORE.check([f"repro_hb_{k}_{round_id}"])
            except Exception:  # the store's host is gone
                seen = False
            if not seen:
                offenders.append(k)
        return tuple(offenders)

    def mark_degraded(self, offenders: Sequence[int] = ()) -> None:
        from repro_torch.obs import metrics as _metrics
        with self._lock:
            already = self.degraded
            self.degraded = True
            if self.degraded_at is None:
                self.degraded_at = time.monotonic()
            self.offenders = tuple(sorted(set(self.offenders)
                                          | set(offenders)))
        _metrics.gauge("repro_pod_degraded",
                       "1 while this host serves local-only").set(1)
        _metrics.counter("repro_pod_watchdog_trips_total",
                         "pod watchdog timeouts").inc(1)
        if not already:
            _metrics.warn_once(
                "pod-degraded",
                f"pod degraded to local-only serving (offenders: "
                f"{list(self.offenders) or 'unknown'})")

    def try_rejoin(self, timeout_s: float = 10.0, *,
                   barrier_fn=None) -> bool:
        """Probe the pod with a barrier under ``timeout_s``; clear the
        degraded latch when every peer answers.  Returns success."""
        fn = barrier_fn or (lambda: barrier("repro-pod-rejoin"))
        done = threading.Event()
        ok: Dict[str, bool] = {}

        def run():
            try:
                fn()
                ok["ok"] = True
            except Exception:
                ok["ok"] = False
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True,
                             name="repro-pod-rejoin")
        t.start()
        if not (done.wait(timeout_s) and ok.get("ok")):
            return False
        from repro_torch.obs import metrics as _metrics
        with self._lock:
            self.degraded = False
            self.degraded_at = None
            self.offenders = ()
        _metrics.gauge("repro_pod_degraded",
                       "1 while this host serves local-only").set(0)
        return True

    def reset(self) -> None:
        """Forget all state (tests)."""
        with self._lock:
            self._round = 0
            self.degraded = False
            self.degraded_at = None
            self.offenders = ()

    def snapshot(self) -> dict:
        with self._lock:
            return {"round": self._round, "degraded": self.degraded,
                    "offenders": list(self.offenders)}


#: process-wide pod health (what pod_flush and healthz consult)
POD_HEALTH = PodHealth()


# ----------------------------------------------------- local pod harness ---

#: seconds the surviving pod processes get once one has failed
FAIL_GRACE_S = 15.0


class PodWorkerError(RuntimeError):
    """One or more spawn_local_pod workers failed; message carries all
    per-process tracebacks."""


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _pod_child(conn, env: Dict[str, str], target: str,
               args: tuple, kwargs: dict) -> None:
    """Spawn-side entry: env first, then the device, the bootstrap and
    the target.  The process ends with ``os._exit`` once its result is
    sent: a watchdog may have left a zombie collective thread behind,
    which an orderly interpreter exit would wait on."""
    os.environ.update(env)
    code = 0
    try:
        # the package's module, not this one: run as ``-m``, this
        # function is ``__main__``'s, and the store must land where the
        # targets read it
        from repro_torch.launch import multihost
        if os.environ.get(ENV_POD_DEVICE, "cuda") != "cpu":
            import torch
            multihost.pod_device()  # raises without a card
            torch.cuda.set_device(0)
        multihost.bootstrap()
        mod_name, _, fn_name = target.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        conn.send(("ok", fn(*args, **(kwargs or {}))))
    except BaseException:
        code = 1
        try:
            conn.send(("err", traceback.format_exc()))
        except Exception:
            pass
    finally:
        conn.close()
    import sys
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def spawn_local_pod(n: int, target: str, args: tuple = (), *,
                    kwargs: Optional[dict] = None, timeout_s: float = 300.0,
                    extra_env: Optional[Dict[str, str]] = None,
                    device=None) -> List[Any]:
    """Run ``target`` ("pkg.mod:fn") in ``n`` fresh pod processes.

    Each child joins one gloo group over localhost and runs the target
    with ``args``/``kwargs`` on ``device`` (None: the card; ``"cpu"``
    the host), which :func:`pod_device` returns there.  Returns the
    targets' return values ordered by process id (results must pickle).
    Raises :class:`PodWorkerError` with every failing process's
    traceback, or ``TimeoutError`` if any child outlives ``timeout_s``
    (stragglers are killed: a hung collective must not hang the caller).
    Once one process has failed, the others get :data:`FAIL_GRACE_S`.
    """
    import multiprocessing as mp
    if n < 1:
        raise ValueError(f"spawn_local_pod needs n >= 1, got {n}")
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    dev = "cuda" if device is None else str(device)
    for pid in range(n):
        env = {
            ENV_COORDINATOR: f"127.0.0.1:{port}",
            ENV_NUM_PROCESSES: str(n),
            ENV_PROCESS_ID: str(pid),
            ENV_POD_DEVICE: dev,
        }
        env.update(extra_env or {})
        parent_conn, child_conn = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_pod_child,
                        args=(child_conn, env, target, tuple(args),
                              dict(kwargs or {})),
                        name=f"repro-pod-{pid}", daemon=True)
        p.start()
        child_conn.close()
        procs.append(p)
        conns.append(parent_conn)

    from multiprocessing import connection as mp_connection
    results: List[Any] = [None] * n
    errors: List[str] = []
    # one shared deadline (sequential per-process timeouts would stack to
    # n * timeout_s), collected round-robin: a fast failure in any
    # process surfaces at once instead of hiding behind an earlier pid's
    # hung collective; once a failure lands, the surviving peers (likely
    # hung in the now-peerless collective) get a short grace
    deadline = time.monotonic() + timeout_s
    fail_grace_s = FAIL_GRACE_S
    by_conn = {conn: pid for pid, conn in enumerate(conns)}
    pending = dict(enumerate(zip(procs, conns)))
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        ready = mp_connection.wait(
            [c for _, c in pending.values()], timeout=left)
        for conn in ready:
            pid = by_conn[conn]
            p, _ = pending.pop(pid)
            try:
                status, payload = conn.recv()
            except (EOFError, OSError):  # a crash, not a hang
                p.join(timeout=5)
                errors.append(f"--- process {pid} exited {p.exitcode} "
                              f"with no result ---")
                continue
            if status == "ok":
                results[pid] = payload
            else:
                errors.append(f"--- process {pid} ---\n{payload}")
        if errors:
            deadline = min(deadline, time.monotonic() + fail_grace_s)
    timed_out = sorted(pending)
    for p in procs:
        p.join(timeout=5 if not timed_out else 0.5)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)
    if errors:
        if timed_out:
            errors.append(f"--- processes {timed_out} still pending "
                          f"{fail_grace_s}s after the first failure "
                          f"(killed) ---")
        raise PodWorkerError("spawn_local_pod worker failure:\n"
                             + "\n".join(errors))
    if timed_out:
        raise TimeoutError(
            f"spawn_local_pod: processes {timed_out} produced no result "
            f"within {timeout_s}s (killed)")
    return results


# ----------------------------------------------------------------- smoke ---

def _write_smoke_bundle(path: str, widths=(32, 32)):
    from repro_torch.nn import MLP
    from repro_torch.nn.serialize import save_model
    return save_model(path, MLP((1, 5), list(widths), 1).init(seed=7))


def _smoke_worker(tmp: str, callers_per_host: int = 3,
                  rows_per_caller: int = 5) -> Dict[str, Any]:
    """One pod process of the cross-host serve round-trip.

    Every host submits its callers' rows to the *same* queue key, all
    hosts pod_flush collectively, and each host checks its callers'
    results bit-identical to single-process (mesh-less) serving of the
    same rows.  The kernel launches are counted over the pod flush
    alone.
    """
    import numpy as np
    import torch

    from repro_torch.core.engine import InferenceEngine
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.serve import FlushPolicy, ServeQueue

    dev = pod_device()
    pid, nproc = process_index(), process_count()
    bundle = os.path.join(tmp, "surrogate")
    if pid == 0:
        _write_smoke_bundle(bundle)
    barrier("smoke-bundle-ready")

    # every host sees the same deterministic global caller set and owns
    # a contiguous slice of it
    rng = np.random.default_rng(1234)
    full = rng.standard_normal(
        (nproc * callers_per_host * rows_per_caller, 5)).astype(np.float32)
    mine = full.reshape(nproc, callers_per_host, rows_per_caller, 5)[pid]

    mesh = make_pod_mesh(device=dev.type)
    queue = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device=dev)
    registry.reset_counts()
    with use_mesh(mesh, multi_pod=True):
        futs = [queue.submit(bundle, mine[c])
                for c in range(callers_per_host)]
        queue.pod_flush(bundle)
    launches = {s.name: s.launches for s in registry.all_specs()
                if s.launches}
    got = [f.result(timeout=120).numpy() for f in futs]

    # single-process reference: the same engine serving, no mesh
    eng = InferenceEngine.get(bundle, dev)
    ref = [eng(torch.from_numpy(mine[c])).cpu().numpy()
           for c in range(callers_per_host)]
    equal = all(np.array_equal(g, r) for g, r in zip(got, ref))

    snap = queue.stats(bundle).snapshot()
    out = {
        "pid": pid,
        "nproc": nproc,
        "equal": bool(equal),
        "local_rows": int(callers_per_host * rows_per_caller),
        "bucket": int(snap["bucket_rows"]),
        "pod_batches": int(snap["pod_batches"]),
        "remote_rows": int(snap["remote_rows"]),
        "device": str(dev),
        "route": eng.route,
        "launches": launches,
    }
    from repro_torch.obs import SHADOW, TRACER, pod_snapshot
    if SHADOW.enabled:
        # quality pass: every host shadow-scores its own served rows
        # against the single-process reference it already computed
        # (bit-identical, so the drift alert must stay OK)
        SHADOW.set_budget(bundle, 0.05)
        for c in range(callers_per_host):
            SHADOW.submit(bundle,
                          pred=lambda g=got[c]: g,
                          ref=lambda r=ref[c]: r,
                          region="pod-smoke", rows=rows_per_caller)
        SHADOW.flush(60.0)
        out["quality_state"] = SHADOW.state(bundle)
    if TRACER.enabled:
        # flight-recorder pass: all-gather every host's spans/metrics
        # (collective, so it runs before the final barrier on every
        # host); each worker returns the merged pod view
        out["obs"] = pod_snapshot()
    queue.close()
    barrier("smoke-done")
    return out


def run_smoke(processes: int = 2, tmpdir: Optional[str] = None,
              timeout_s: float = 420.0, obs_out: Optional[str] = None,
              shadow_rate: Optional[float] = None,
              device=None) -> List[Dict[str, Any]]:
    """The multi-process smoke: spawn_local_pod driving a cross-host
    serve round-trip on ``device`` (None: the card).  Raises on any
    correctness failure; returns the per-process summaries.

    ``obs_out`` turns the pod into a flight recorder: children run with
    tracing on, every host's spans/metrics are all-gathered in-pod
    (``obs.pod_snapshot``), and the merged Chrome trace lands at
    ``obs_out``.  ``shadow_rate`` enables shadow quality scoring in
    every child (1.0 by default with the flight recorder); every host's
    drift alert must then report OK, since the served rows are
    bit-identical to the reference.
    """
    tmp = tmpdir or tempfile.mkdtemp(prefix="repro_torch_pod_smoke_")
    if shadow_rate is None and obs_out:
        shadow_rate = 1.0
    extra_env: Dict[str, str] = {}
    if obs_out:
        extra_env["REPRO_TRACE"] = "1"
    if shadow_rate:
        extra_env["REPRO_SHADOW_RATE"] = str(shadow_rate)
    res = spawn_local_pod(processes,
                          "repro_torch.launch.multihost:_smoke_worker",
                          (tmp,), timeout_s=timeout_s,
                          extra_env=extra_env or None, device=device)
    failures = []
    for r in res:
        if not r["equal"]:
            failures.append(f"p{r['pid']}: results diverge from "
                            f"single-process serving")
        if r["pod_batches"] < 1:
            failures.append(f"p{r['pid']}: no pod batch dispatched")
        if processes > 1 and r["remote_rows"] <= 0:
            failures.append(f"p{r['pid']}: mega-batch carried no remote "
                            f"rows; it did not span the pod axis")
        if r["bucket"] <= r["local_rows"]:
            failures.append(f"p{r['pid']}: global bucket {r['bucket']} "
                            f"does not exceed local rows {r['local_rows']}")
        if shadow_rate and r.get("quality_state") != "OK":
            failures.append(
                f"p{r['pid']}: drift alert {r.get('quality_state')!r} on "
                f"bit-identical served rows (expected OK)")
    for r in res:
        q = f" quality={r['quality_state']}" if "quality_state" in r else ""
        print(f"[pod-smoke] p{r['pid']}/{r['nproc']} device={r['device']} "
              f"route={r['route']} bucket={r['bucket']} "
              f"remote_rows={r['remote_rows']} equal={r['equal']}{q}",
              flush=True)
    if failures:
        raise PodWorkerError("pod smoke FAILED:\n" + "\n".join(failures))
    if obs_out:
        from repro_torch.obs import merge_pod_trace, pod_quality_report
        snapshots = (res[0] or {}).get("obs") or []
        merged = merge_pod_trace(snapshots, obs_out)
        print(f"[pod-smoke] obs: merged {len(merged)} events from "
              f"{len(snapshots)} hosts -> {obs_out}", flush=True)
        if shadow_rate:
            print("[pod-smoke] cross-host surrogate quality:", flush=True)
            print(pod_quality_report(snapshots), flush=True)
    print(f"[pod-smoke] OK: {processes} processes, cross-host mega-batch, "
          f"bit-identical to single-process serving", flush=True)
    return res


# ------------------------------------------------------ host-drop drill ---

def _host_drop_worker(tmp: str, callers_per_host: int = 2,
                      rows_per_caller: int = 4) -> Dict[str, Any]:
    """One pod process of the host-drop drill.

    Launched with ``REPRO_FAULTS="pod.flush:drop:pid=1,stall=<s>"`` and a
    short ``REPRO_POD_WATCHDOG_S``: host 1 stalls at ``pod_flush`` entry
    (*before* writing its heartbeat, so it looks exactly like a dropped
    host) and host 0's watchdog must fire, degrade to local-only
    dispatch, and still resolve every future bit-identically.  Host 1,
    on waking, either completes a late pod batch with host 0's abandoned
    collective thread or degrades locally itself; both are correct, and
    first-wins futures keep either race winner exact.  The agreement
    collective moves host tensors, so the torn collective pins no device
    and host 0's local dispatch runs at once.  Every host waits for the
    others through the store (:func:`store_barrier`) before it returns,
    so host 0's zombie collective is still there when host 1 wakes.
    """
    import numpy as np
    import torch

    from repro_torch.core.engine import InferenceEngine
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.serve import FlushPolicy, ServeQueue

    dev = pod_device()
    pid, nproc = process_index(), process_count()
    bundle = os.path.join(tmp, "surrogate")
    if pid == 0:
        _write_smoke_bundle(bundle)
    barrier("drill-bundle-ready")

    rng = np.random.default_rng(99)
    full = rng.standard_normal(
        (nproc * callers_per_host * rows_per_caller, 5)).astype(np.float32)
    mine = full.reshape(nproc, callers_per_host, rows_per_caller, 5)[pid]

    # set-up, untimed by the drill: the mesh, and a process's first
    # entry into one, import DTensor and its dispatch (seconds on a
    # cold host), which are not the pod's to detect
    t_setup = time.monotonic()
    mesh = make_pod_mesh(device=dev.type)
    with use_mesh(mesh, multi_pod=True):
        pass
    queue = ServeQueue(FlushPolicy(max_batch_rows=1 << 30), device=dev)
    t0 = time.monotonic()
    with use_mesh(mesh, multi_pod=True):
        futs = [queue.submit(bundle, mine[c])
                for c in range(callers_per_host)]
        queue.pod_flush(bundle)
    elapsed = time.monotonic() - t0

    got = [f.result(timeout=120).numpy() for f in futs]
    eng = InferenceEngine.get(bundle, dev)
    ref = [eng(torch.from_numpy(mine[c])).cpu().numpy()
           for c in range(callers_per_host)]
    equal = all(np.array_equal(g, r) for g, r in zip(got, ref))

    from repro_torch.obs.server import ObsServer
    _, health = ObsServer().health()
    # no rejoin drill here: after a torn gloo collective only a process
    # restart truly rejoins (see PodHealth.try_rejoin); the unit tests
    # cover the rejoin state machine with a stubbed barrier
    degrade_latency = (POD_HEALTH.degraded_at - t0
                       if POD_HEALTH.degraded_at is not None else None)
    out = {
        "pid": pid, "nproc": nproc, "equal": bool(equal),
        "resolved": sum(1 for f in futs if f.done()),
        "submitted": len(futs),
        "elapsed_s": float(elapsed),
        "setup_s": float(t0 - t_setup),
        "degrade_latency_s": (float(degrade_latency)
                              if degrade_latency is not None else None),
        "degraded": bool(POD_HEALTH.degraded),
        "offenders": list(POD_HEALTH.offenders),
        "critical": list(health["critical"]),
        "watchdog_s": pod_watchdog_s(),
    }
    store_barrier("drill-done")
    return out


def host_drop_failures(res: List[Dict[str, Any]], stall_s: float,
                       watchdog_s: float) -> List[str]:
    """What the drill's per-process results fail of its contract: no
    request lost, rows exact, host 0 degraded within the watchdog (plus
    slack, and before the stall ends) naming host 1, and its flush
    drained promptly once the stall ended."""
    failures = []
    for r in res:
        if r["resolved"] != r["submitted"]:
            failures.append(f"p{r['pid']}: lost "
                            f"{r['submitted'] - r['resolved']} requests")
        if not r["equal"]:
            failures.append(f"p{r['pid']}: results diverge from "
                            f"single-process serving")
    r0 = res[0]
    if not r0["degraded"]:
        failures.append("p0: survivor never degraded; the watchdog did "
                        "not fire")
    else:
        if r0["offenders"] != [1]:
            failures.append(f"p0: offenders {r0['offenders']} "
                            f"(expected [1])")
        if "pod:host-1" not in r0["critical"]:
            failures.append(f"p0: healthz critical {r0['critical']} does "
                            f"not name pod:host-1")
        lat = r0["degrade_latency_s"]
        if lat is None or lat >= min(watchdog_s + 5.0, stall_s):
            failures.append(
                f"p0: degrade latency {lat}s; the watchdog ({watchdog_s}s) "
                f"did not flip the pod to local-only before the {stall_s}s "
                f"stall ended")
    if r0["elapsed_s"] >= stall_s + 10.0:
        failures.append(
            f"p0: pod_flush took {r0['elapsed_s']:.1f}s; the in-flight "
            f"batch did not drain promptly")
    return failures


def run_host_drop_drill(processes: int = 2, tmpdir: Optional[str] = None,
                        timeout_s: float = 240.0, stall_s: float = 15.0,
                        watchdog_s: float = 2.0,
                        device=None) -> List[Dict[str, Any]]:
    """The host-drop drill on ``device`` (None: the card): drop host 1
    mid-flush, require the survivor to *degrade* within the watchdog
    (healthz flips, later flushes go local-only) and to serve the
    in-flight batch with zero lost requests (:func:`host_drop_failures`).
    """
    if processes < 2:
        raise ValueError("host-drop drill needs >= 2 processes")
    tmp = tmpdir or tempfile.mkdtemp(prefix="repro_torch_pod_drill_")
    extra_env = {
        "REPRO_FAULTS": f"pod.flush:drop:pid=1,stall={stall_s}",
        ENV_POD_WATCHDOG: str(watchdog_s),
    }
    res = spawn_local_pod(
        processes, "repro_torch.launch.multihost:_host_drop_worker", (tmp,),
        timeout_s=timeout_s, extra_env=extra_env, device=device)
    failures = host_drop_failures(res, stall_s, watchdog_s)
    for r in res:
        lat = r["degrade_latency_s"]
        print(f"[host-drop] p{r['pid']}/{r['nproc']} "
              f"resolved={r['resolved']}/{r['submitted']} "
              f"equal={r['equal']} degraded={r['degraded']} "
              f"degrade_latency="
              f"{'-' if lat is None else format(lat, '.1f') + 's'} "
              f"offenders={r['offenders']} "
              f"flush={r['elapsed_s']:.1f}s", flush=True)
    if failures:
        raise PodWorkerError("host-drop drill FAILED:\n"
                             + "\n".join(failures))
    print(f"[host-drop] OK: host 1 dropped {stall_s}s, survivor flipped "
          f"local-only in {res[0]['degrade_latency_s']:.1f}s "
          f"(watchdog {watchdog_s}s), zero requests lost", flush=True)
    return res


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="spawn_local_pod cross-host serve round-trip")
    ap.add_argument("--host-drop-drill", action="store_true",
                    help="drop one host mid-pod_flush and require "
                         "degrade-within-watchdog, zero lost requests")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="flight recorder: run the pod with tracing on "
                         "and write the merged Chrome trace to PATH")
    ap.add_argument("--shadow-rate", type=float, default=None,
                    help="shadow-score this fraction of served requests "
                         "in every pod process (default 1.0 with --obs)")
    ap.add_argument("--device", default=None,
                    help="the pod processes' device (default: cuda; cpu "
                         "runs the pod on the host)")
    args = ap.parse_args(argv)
    if args.smoke:
        run_smoke(processes=args.processes, obs_out=args.obs,
                  shadow_rate=args.shadow_rate, device=args.device)
        return
    if args.host_drop_drill:
        run_host_drop_drill(processes=args.processes, device=args.device)
        return
    ap.error("nothing to do (pass --smoke or --host-drop-drill)")


if __name__ == "__main__":
    main()
