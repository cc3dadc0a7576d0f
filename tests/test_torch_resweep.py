"""Port parity of the drift-triggered kernel re-sweep on the CPU, against
``repro.tune.resweep``: the trigger threshold, dedup per (kernel, key),
the bounded backlog, the enqueued and completed counters, both ladders
for an int8-tier engine, the env switches, and the batcher's hook.

The port's key carries the registry's backend (``cuda``) and must be
the very key the registry's dispatch looks up; an engine on the CPU has
no kernel to sweep and enqueues nothing.  The sweep itself runs only on
the card (``tests/test_torch_cuda.py``); here ``_sweep_cell`` or the
tuner's ``sweep`` is replaced by a recorder.
"""
import json
import types

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.tune.resweep as jresweep  # noqa: E402
import repro_torch.tune.cache as tcache  # noqa: E402
import repro_torch.tune.kernel_tuner as kt  # noqa: E402
import repro_torch.tune.resweep as tresweep  # noqa: E402
from repro_torch.core.engine import InferenceEngine  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.fused_mlp import ops as fused_ops  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.serve import FlushPolicy, ServeQueue  # noqa: E402
from repro_torch.tune.cache import TuneCache, shape_key  # noqa: E402
from repro_torch.tune.resweep import ResweepWorker  # noqa: E402

CUDA = torch.device("cuda", 0)
HOT = types.SimpleNamespace(bucket_batches=lambda b: 100)
COLD = types.SimpleNamespace(bucket_batches=lambda b: 1)


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    """Every default tune cache lives under tmp; no cached engines."""
    monkeypatch.setattr(tcache, "_default", {
        k: TuneCache(k, path=tmp_path / f"{k}.json")
        for k in ("fused_mlp", "fused_mlp_int8", "quant_gate")})
    InferenceEngine.invalidate()
    yield
    InferenceEngine.invalidate()


def _bundle(tmp, name="m"):
    """An untrained MLP bundle, written by the reference."""
    from repro.nn import MLP
    from repro.nn.serialize import save_model
    net = MLP((1, 4), [16], 2)
    return save_model(tmp / name, net, net.init(jax.random.PRNGKey(0)))


def _spec(tmp):
    return json.loads((tmp / "m" / "spec.json").read_text())


def _recorder(monkeypatch, swept):
    monkeypatch.setattr(
        ResweepWorker, "_sweep_cell",
        staticmethod(lambda k, w, b, d, a, dev: swept.append(
            (k, w, b, a, dev))))


_RESWEEPS = tmetrics.counter(
    "repro_tune_resweep_total",
    "drift-triggered background kernel sweeps completed", ("kernel",))
_ENQUEUED = tmetrics.counter(
    "repro_tune_resweep_enqueued_total",
    "drift-triggered sweep cells enqueued", ("kernel",))


# ---------------------------------------------------- trigger, dedup -------
def test_resweep_trigger_dedup_and_counter(tmp_path, monkeypatch):
    """The twin of tests/test_quant.py's case, with a card engine."""
    _bundle(tmp_path)
    spec = _spec(tmp_path)
    swept = []
    _recorder(monkeypatch, swept)
    worker = ResweepWorker(after=4)
    worker.enable()
    eng = types.SimpleNamespace(spec=spec, tier="f32", device=CUDA)
    assert not worker.observe(eng, 64, COLD)
    before = _RESWEEPS.value(kernel="fused_mlp")
    enq = _ENQUEUED.value(kernel="fused_mlp")
    assert worker.observe(eng, 64, HOT)
    assert not worker.observe(eng, 64, HOT)
    assert worker.flush()
    assert _RESWEEPS.value(kernel="fused_mlp") == before + 1
    assert _ENQUEUED.value(kernel="fused_mlp") == enq + 1
    assert swept == [("fused_mlp", (4, 16, 2), 64, ("relu", "identity"),
                      CUDA)]
    # an int8-tier engine re-sweeps both ladders
    eng8 = types.SimpleNamespace(spec=spec, tier="int8", device=CUDA)
    before8 = _RESWEEPS.value(kernel="fused_mlp_int8")
    assert worker.observe(eng8, 32, HOT)
    assert worker.flush()
    assert {k for k, *_ in swept} == {"fused_mlp", "fused_mlp_int8"}
    assert _RESWEEPS.value(kernel="fused_mlp_int8") == before8 + 1
    # a key the cache already resolves is suppressed, not re-swept
    key = shape_key((4, 16, 2), "float32", registry.BACKEND, 128)
    tcache._default["fused_mlp"].put(
        key, {"params": {"block_rows": 16}, "exact": True})
    n = len(swept)
    assert not worker.observe(eng, 128, HOT)
    worker.flush()
    assert len(swept) == n


def test_resweep_disabled_is_inert():
    worker = ResweepWorker(after=1)
    assert not worker.enabled
    assert not worker.observe(
        types.SimpleNamespace(spec={}, tier="f32", device=CUDA), 64, HOT)


def test_resweep_cpu_engine_enqueues_nothing(tmp_path, monkeypatch):
    """A CPU engine has no kernel to sweep: nothing is enqueued, seen or
    counted, where the reference (backend-blind) would enqueue."""
    _bundle(tmp_path)
    spec = _spec(tmp_path)
    swept = []
    _recorder(monkeypatch, swept)
    worker = ResweepWorker(after=1).enable()
    enq = _ENQUEUED.value(kernel="fused_mlp")
    for dev in (torch.device("cpu"), "cpu", None):
        eng = types.SimpleNamespace(spec=spec, tier="int8", device=dev)
        assert not worker.observe(eng, 64, HOT)
    real = InferenceEngine.get(_bundle(tmp_path, "real"), "cpu")
    assert not worker.observe(real, 64, HOT)
    assert worker.flush() and swept == [] and worker._seen == set()
    assert _ENQUEUED.value(kernel="fused_mlp") == enq
    # the reference does enqueue the same engine: the divergence is the
    # port's (a CPU sweep raises there), not a missed trigger
    jworker = jresweep.ResweepWorker(after=1).enable()
    monkeypatch.setattr(jresweep.ResweepWorker, "_sweep_cell",
                        staticmethod(lambda *a: None))
    assert jworker.observe(types.SimpleNamespace(spec=spec, tier="f32"),
                           64, HOT)
    assert jworker.flush()


def test_resweep_non_mlp_bundle_is_nothing_to_tune(tmp_path, monkeypatch):
    from repro_torch.nn import CNN
    swept = []
    _recorder(monkeypatch, swept)
    spec = CNN((1, 8, 8, 1), [(4, 3, 1)], [8], 1).spec()
    worker = ResweepWorker(after=1).enable()
    eng = types.SimpleNamespace(spec=spec, tier="f32", device=CUDA)
    assert not worker.observe(eng, 64, HOT)
    assert jresweep.ResweepWorker(after=1).enable().observe(
        types.SimpleNamespace(spec=spec, tier="f32"), 64, HOT) is False


def test_resweep_bounded_backlog_drops_and_retriggers(tmp_path,
                                                      monkeypatch):
    _bundle(tmp_path)
    spec = _spec(tmp_path)
    import threading
    gate, swept = threading.Event(), []

    def slow(k, w, b, d, a, dev):
        gate.wait(10)
        swept.append(b)

    monkeypatch.setattr(ResweepWorker, "_sweep_cell", staticmethod(slow))
    monkeypatch.setattr(ResweepWorker, "DUTY_CYCLE", 1.0)
    worker = ResweepWorker(after=1, max_backlog=2).enable()
    eng = types.SimpleNamespace(spec=spec, tier="f32", device=CUDA)
    assert worker.observe(eng, 8, HOT)
    assert worker.observe(eng, 16, HOT)
    assert not worker.observe(eng, 32, HOT)  # backlog full: dropped
    gate.set()
    assert worker.flush()
    assert worker.observe(eng, 32, HOT)      # re-triggers once drained
    assert worker.flush()
    assert sorted(swept) == [8, 16, 32]


def test_resweep_failure_warns_and_never_counts(tmp_path, monkeypatch):
    _bundle(tmp_path)
    spec = _spec(tmp_path)

    def broken(*a):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ResweepWorker, "_sweep_cell", staticmethod(broken))
    monkeypatch.setattr(ResweepWorker, "DUTY_CYCLE", 1.0)
    warned = []
    monkeypatch.setattr(tmetrics, "warn_once",
                        lambda tag, msg: warned.append(tag))
    worker = ResweepWorker(after=1).enable()
    before = _RESWEEPS.value(kernel="fused_mlp")
    assert worker.observe(types.SimpleNamespace(spec=spec, tier="f32",
                                                device=CUDA), 64, HOT)
    assert worker.flush()
    assert _RESWEEPS.value(kernel="fused_mlp") == before
    assert warned == ["resweep-error:fused_mlp:(4, 16, 2):64"]
    assert worker._thread.is_alive()


@pytest.mark.parametrize("env", [
    {}, {"REPRO_RESWEEP": "1"}, {"REPRO_RESWEEP": "on",
                                 "REPRO_RESWEEP_AFTER": "3"},
    {"REPRO_RESWEEP": "TRUE"}, {"REPRO_RESWEEP": "0",
                                "REPRO_RESWEEP_AFTER": "7"}],
    ids=["unset", "one", "on-after", "upper", "off"])
def test_env_switches_match_reference(env, monkeypatch):
    monkeypatch.delenv("REPRO_RESWEEP", raising=False)
    monkeypatch.delenv("REPRO_RESWEEP_AFTER", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, ref = ResweepWorker(), jresweep.ResweepWorker()
    assert (ours.enabled, ours.after, ours.max_backlog) == \
        (ref.enabled, ref.after, ref.max_backlog)


@pytest.mark.parametrize("layers", [
    [{"kind": "dense"}, {"kind": "act", "name": "relu"}, {"kind": "dense"}],
    [{"kind": "dense"}, {"kind": "dense"}, {"kind": "act", "name": "tanh"}],
    [{"kind": "flatten"}, {"kind": "dense"}],
    []], ids=["mlp", "bare-dense", "flatten", "empty"])
def test_acts_from_layers_match_reference(layers):
    assert tresweep._acts_from_layers(layers) == \
        jresweep._acts_from_layers(layers)


# ------------------------------------------------ the key dispatch reads ---
def test_resweep_key_is_the_registry_dispatch_key(tmp_path, monkeypatch):
    """The enqueued cell's key is the first key the registry's dispatch
    looks up for a batch of that bucket through the engine's pack, for
    both tiers: a re-swept record is served."""
    from repro_torch.kernels.fused_mlp import int8 as int8_ops
    from repro_torch.nn.serialize import load_model
    from repro_torch.quant.quantize import quantize_params
    mp = _bundle(tmp_path)
    _recorder(monkeypatch, [])
    net, params, spec = load_model(mp, "cpu")
    worker = ResweepWorker(after=1).enable()
    assert worker.observe(types.SimpleNamespace(spec=spec, tier="int8",
                                                device=CUDA), 256, HOT)
    assert worker.flush()
    packed = fused_ops.pack_from_spec(spec, params, torch.device("cpu"))
    x = torch.zeros((256, 4))
    want = {("fused_mlp", fused_ops.SPEC.lookup_keys(
        fused_ops.inspect_call(x, packed))[0])}
    _, weights, biases, acts = fused_ops.mlp_stack_from_spec(spec, params,
                                                             x)
    packed8 = int8_ops.pack_int8_mlp(
        quantize_params(weights, biases, device="cpu"), acts)
    want.add(("fused_mlp_int8", int8_ops.SPEC.lookup_keys(
        int8_ops.inspect_call(x, packed8))[0]))
    assert worker._seen == want
    assert all(k.split("|")[2] == "cuda" for _, k in want)


def test_sweep_cell_runs_sweep_on_a_side_stream(monkeypatch):
    """``_sweep_cell`` hands the tuner a problem the kernel's spec
    supports, on the engine's device, inside a stream of its own."""
    calls = []

    class FakeStream:
        def __init__(self, device):
            self.device, self.synced = device, False

        def synchronize(self):
            self.synced = True

    class Ctx:
        def __init__(self, tag, arg):
            self.tag, self.arg = tag, arg

        def __enter__(self):
            calls.append(("enter", self.tag, self.arg))

        def __exit__(self, *exc):
            calls.append(("exit", self.tag))

    streams = []

    def make_stream(device):
        streams.append(FakeStream(device))
        return streams[-1]

    monkeypatch.setattr(torch.cuda, "device", lambda d: Ctx("device", d))
    monkeypatch.setattr(torch.cuda, "Stream", make_stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: Ctx("stream", s))
    monkeypatch.setattr(kt, "sweep", lambda kernel, problem, device: calls
                        .append(("sweep", kernel, problem, device)))
    for kernel in ("fused_mlp", "fused_mlp_int8"):
        calls.clear()
        ResweepWorker._sweep_cell(kernel, (4, 16, 2), 512, "float32",
                                  ("relu", "identity"), CUDA)
        assert [c[:2] for c in calls] == [
            ("enter", "device"), ("enter", "stream"), ("sweep", kernel),
            ("exit", "stream"), ("exit", "device")]
        problem = calls[2][2]
        assert calls[2][3] == CUDA and calls[1][2] is streams[-1]
        assert streams[-1].device == CUDA and streams[-1].synced
        assert registry.get_spec(kernel).supports(problem)
        assert registry.get_spec(kernel).cache_key(
            problem, registry.BACKEND) == shape_key((4, 16, 2), "float32",
                                                    registry.BACKEND, 512)


# ---------------------------------------------------------- batcher hook ---
def test_batcher_reports_each_served_batch(tmp_path, monkeypatch):
    """The batcher calls ``observe(engine, bucket, stats)`` after
    ``stats.on_batch`` when enabled, and not at all when disabled."""
    mp = _bundle(tmp_path)
    seen = []

    class Probe:
        enabled = False

        def observe(self, engine, bucket, stats):
            seen.append((engine.path, bucket, stats.bucket_batches(bucket)))
            return False

    probe = Probe()
    monkeypatch.setattr(tresweep, "get_resweeper", lambda: probe)
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 4)).astype(np.float32))
    q.submit(mp, x).result(10)
    assert seen == []
    probe.enabled = True
    q.submit(mp, x).result(10)
    q.submit(mp, torch.cat([x] * 4)).result(10)
    assert seen == [(mp, 8, 2), (mp, 32, 1)]
    q.close()


def test_enabled_resweep_through_a_cpu_queue_sweeps_nothing(tmp_path,
                                                            monkeypatch):
    mp = _bundle(tmp_path)
    swept = []
    _recorder(monkeypatch, swept)
    worker = ResweepWorker(after=1).enable()
    monkeypatch.setattr(tresweep, "get_resweeper", lambda: worker)
    q = ServeQueue(FlushPolicy(max_batch_rows=1 << 20), device="cpu")
    try:
        for i in range(3):
            q.submit(mp, torch.zeros((3, 4))).result(10)
    finally:
        q.close()
    assert worker.flush() and swept == [] and worker._seen == set()
