"""Port parity: the kernel tuner (sweep, autotune, run_tune), tuned
resolution in the registry and ``best_tile`` against repro.tune and
repro.kernels.registry, on the CPU.

The sweep times kernels on the card, so it raises on the CPU; the tests
that drive it here register a toy spec whose ``run_call`` is a torch
function, and stand in a host-side check and timer for the card's."""
import json

import pytest

torch = pytest.importorskip("torch")

import repro.tune.cache as jcache  # noqa: E402
import repro_torch.tune.cache as tcache  # noqa: E402
import repro_torch.tune.kernel_tuner as kt  # noqa: E402
from repro.tune import kernel_tuner as jkt  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.fused_mlp import ops as fused_ops  # noqa: E402
from repro_torch.launch.dryrun import run_tune  # noqa: E402
from repro_torch.nn import MLP, save_model  # noqa: E402
from repro_torch.obs import metrics as _m  # noqa: E402
from repro_torch.serve.queue import FlushPolicy  # noqa: E402
from repro_torch.tune import (TuneCache, autotune, autotune_registered,  # noqa: E402
                              best_tile, candidate_tiles, serve_buckets,
                              shape_key, sweep, widths_from_spec)

# toy timings by candidate: the wrong candidate (k=2) is the fastest and
# must still lose
TOY_US = {4: 10.0, 1: 5.0, 2: 1.0, 16: 3.0}


def _toy_spec(name="toy_double"):
    """``x * 2`` with tunable ``k``: ``k=2`` answers wrongly, ``k=8`` is
    refused by its 'kernel', and ``fits`` caps ``k`` at the problem's
    ``max_k``."""
    seen = []

    def run(problem, arrays, params):
        seen.append(params["k"])
        if params["k"] == 8:
            raise ValueError("k=8 refused")
        x, = arrays
        return x * 2 + (1 if params["k"] == 2 else 0)

    run.launches = 0

    def fits(problem, params):
        return params["k"] <= problem["max_k"]

    spec = registry.KernelSpec(
        name=name, params=(registry.TunableParam("k", 4, (1, 2, 4, 8, 16)),),
        kernel=run, run_call=run, ref_call=lambda p, a: a[0] * 2,
        make_call=lambda p, g, dev: (torch.randn(p["n"], generator=g)
                                     .to(dev),),
        cache_key=lambda p, backend: f"n{p['n']}|{p['dtype']}|{backend}",
        candidates=lambda p: registry.ladder_candidates(
            spec.params, fits=lambda c: fits(p, c)),
        fits=fits, supports=lambda p: True,
        default_problems=({"n": 64, "max_k": 8, "dtype": "float32"},))
    spec.seen = seen
    return spec


@pytest.fixture
def host_sweep(monkeypatch, tmp_path):
    """Sweeps on the CPU: the card check passes, the timer reads the toy
    table by the candidate that just ran, and every default cache lives
    under ``tmp_path/tune_torch``."""
    spec = _toy_spec()
    monkeypatch.setitem(registry._SPECS, spec.name, spec)
    monkeypatch.setattr(kt, "_require_card", lambda device: torch.device(
        "cpu"))

    def fake_us(fn, reps, warmup):
        fn()
        return TOY_US.get(spec.seen[-1], 7.0)

    monkeypatch.setattr(kt, "_measure_us", fake_us)
    monkeypatch.setattr(tcache, "ART", tmp_path / "tune_torch")
    monkeypatch.setattr(tcache, "_default", {})
    return spec


def test_widths_from_spec_matches_reference():
    specs = [
        {"in_shape": [1, 5], "layers": [{"kind": "dense", "features": 16},
                                        {"kind": "act", "name": "relu"},
                                        {"kind": "dense", "features": 1}]},
        {"in_shape": [1, 4, 3], "layers": [{"kind": "flatten"},
                                           {"kind": "dense", "features": 2}]},
        {"in_shape": [1, 8, 8, 2], "layers": [{"kind": "conv2d",
                                               "features": 4}]},
        {"in_shape": [1, 6], "layers": [{"kind": "act", "name": "tanh"}]},
    ]
    for spec in specs:
        assert widths_from_spec(spec) == jkt.widths_from_spec(spec)
    assert widths_from_spec(specs[1]) == [12, 2]


@pytest.mark.parametrize("args", [(8, 1024), (8, 100, 6), (16, 16),
                                  (8, 1000, 4), (1, 3)])
def test_serve_buckets_match_reference(args):
    assert serve_buckets(*args) == jkt.serve_buckets(*args)


def test_flush_policy_defaults_match_reference():
    from repro.serve.queue import FlushPolicy as JaxPolicy
    assert FlushPolicy() == FlushPolicy(**vars(JaxPolicy()))


def test_record_schema_matches_reference(tmp_path, host_sweep):
    jrec = jkt.sweep_fused_mlp([4, 16, 2], 32, reps=1, warmup=0,
                               cache=jcache.TuneCache(
                                   "fused_mlp", tmp_path / "jax.json"))
    rec = sweep("toy_double", {"n": 64, "max_k": 8}, reps=1, warmup=0)
    flat = lambda r: set(r) - set(r["params"])  # noqa: E731
    assert flat(rec) == flat(jrec) == {
        "params", "us", "default_us", "speedup_x", "exact", "backend",
        "swept", "tuned_at"}
    assert set(rec["params"]) <= set(rec)            # flattened winner
    assert {k for s in rec["swept"] for k in s} == \
        {k for s in jrec["swept"] for k in s} | {"error"}
    assert rec["backend"] == "cuda"


def test_candidates_defaults_first_and_filtered_by_fits():
    spec = _toy_spec()
    assert spec.candidates({"max_k": 8}) == [{"k": 4}, {"k": 1}, {"k": 2},
                                             {"k": 8}]
    assert spec.candidates({"max_k": 3}) == [{"k": 1}, {"k": 2}]
    two = (registry.TunableParam("a", 2, (1, 2, 4)),
           registry.TunableParam("b", 8, (8, 16)))
    assert registry.ladder_candidates(two, {"a": 2, "b": 8}) == [
        {"a": 2, "b": 8}, {"a": 1, "b": 8}]
    # the fused MLP: block_rows that overflow a 4096-wide net are not swept
    # (16 and 32 take layers up to 1,024 wide; 8 rows' two buffers would
    # take 256 KB)
    wide = {"widths": (6, 4096, 1), "acts": ("relu", "identity"),
            "batch": 256, "ndim": 2, "dtype": "float32"}
    assert fused_ops.SPEC.candidates(wide) == [{"block_rows": 1},
                                               {"block_rows": 2},
                                               {"block_rows": 4}]
    assert fused_ops.SPEC.candidates(dict(wide, widths=(1500, 1024, 1))) \
        == [{"block_rows": 1}, {"block_rows": 2}, {"block_rows": 4},
            {"block_rows": 8}, {"block_rows": 16}]
    small = dict(wide, widths=(6, 64, 1), batch=4)
    assert fused_ops.SPEC.candidates(small) == [
        {"block_rows": 32}, {"block_rows": 1}, {"block_rows": 2},
        {"block_rows": 4}]
    # the tuner's helper is the spec's source
    assert candidate_tiles((6, 64, 1), 8) == [32, 1, 2, 4, 8]
    assert candidate_tiles((6, 64, 1), 256) == [32, 1, 2, 4, 8, 16]
    assert candidate_tiles((1500, 1024, 1), 1024) == [1, 2, 4, 8, 16]
    assert candidate_tiles((6, 4096, 1), 1024) == [1, 2, 4]


def test_flash_attention_sweeps_only_the_kernels_tiles():
    """``run_tune`` sweeps the tiles the kernel launches: block_q 64 or
    128, block_kv 32, 64 or 128, clipped to the extent rounded up to the
    smallest rung, and filtered by shared memory (at hd 128 in f32 only
    chunks of 32 keys fit beside the q tile and their TF32 split)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    spec = flash_ops.SPEC
    tiles = lambda problem: [(c["block_q"], c["block_kv"])  # noqa: E731
                             for c in spec.candidates(problem)]
    llama = {"b": 1, "sq": 4096, "skv": 4096, "h": 24, "kv": 8, "hd": 128,
             "causal": True, "q_offset": 0, "dtype": "float32"}
    assert tiles(llama) == [(128, 32), (64, 32)]
    assert tiles(dict(llama, dtype="bfloat16")) == [
        (128, 32), (128, 64), (128, 128), (64, 32), (64, 64), (64, 128)]
    decode = spec.default_problems[1]
    assert tiles(decode) == [(128, 32), (128, 64), (64, 32), (64, 64)]
    assert tiles(dict(decode, sq=20, skv=50)) == [
        (128, 32), (128, 64), (64, 32), (64, 64)]
    assert tiles(dict(decode, sq=20, skv=20)) == [(128, 32), (64, 32)]
    for problem in spec.default_problems + (llama,):
        assert spec.supports(problem)
        assert all(c["block_q"] in (64, 128) and c["block_kv"] in (32, 64, 128)
                   for c in spec.candidates(problem))


def test_sweep_on_the_cpu_raises(tmp_path):
    problem = fused_ops.SPEC.default_problems[0]
    with pytest.raises(ValueError, match="CUDA"):
        sweep("fused_mlp", problem, device="cpu",
              cache=TuneCache("fused_mlp", tmp_path / "f.json"))
    assert not (tmp_path / "f.json").exists()


def test_sweep_disqualifies_wrong_and_refused_candidates(host_sweep):
    rec = sweep("toy_double", {"n": 64, "max_k": 8}, reps=1, warmup=0)
    by_k = {s["params"]["k"]: s for s in rec["swept"]}
    assert sorted(by_k) == [1, 2, 4, 8]               # 16 does not fit
    assert by_k[2]["exact"] is False and by_k[2]["us"] == 1.0
    assert by_k[8]["exact"] is False and by_k[8]["us"] is None
    assert "k=8 refused" in by_k[8]["error"]
    assert rec["exact"] is True and rec["params"] == {"k": 1}
    assert rec["k"] == 1 and rec["us"] == 5.0 and rec["default_us"] == 10.0
    assert rec["speedup_x"] == 2.0
    # persisted in the port's default cache, under its own directory
    path = tcache.ART / "toy_double.json"
    data = json.loads(path.read_text())
    assert data["schema"] == 2 and data["kernel"] == "toy_double"
    assert data["entries"]["n64|float32|cuda"]["params"] == {"k": 1}
    # cached: the same record, unmeasured; force measures again
    runs = len(host_sweep.seen)
    assert sweep("toy_double", {"n": 64, "max_k": 8}) == rec
    assert len(host_sweep.seen) == runs
    again = sweep("toy_double", {"n": 64, "max_k": 8}, force=True, reps=1,
                  warmup=0)
    assert len(host_sweep.seen) > runs and again["params"] == {"k": 1}


def test_sweep_with_no_valid_candidate_is_never_served(host_sweep):
    # a ladder of the wrong candidate alone
    spec = host_sweep
    spec.params = (registry.TunableParam("k", 2, (2,)),)
    rec = sweep(spec, {"n": 16, "max_k": 2}, reps=1, warmup=0)
    assert rec["exact"] is False and rec["us"] is None
    assert registry.tuned_params(spec, {"n": 16, "max_k": 2,
                                        "dtype": "float32"}) == {}


def test_resolve_params_explicit_tuned_default(host_sweep):
    spec = host_sweep
    problem = {"n": 64, "max_k": 8, "dtype": "float32"}
    assert registry.resolve_params_info(spec, problem) == ({"k": 4},
                                                           "default")
    sweep(spec, problem, reps=1, warmup=0)
    assert registry.resolve_params_info(spec, problem) == ({"k": 1},
                                                           "tuned")
    assert registry.resolve_params_info(spec, problem, {"k": 2}) == (
        {"k": 2}, "explicit")
    # a tuned or explicit config that overflows this card serves the
    # defaults
    assert registry.resolve_params_info(spec, problem, {"k": 16}) == (
        {"k": 4}, "default:smem-fallback")
    cache = tcache.default_cache(spec.name)
    key = spec.cache_key(problem, "cuda")
    cache.put(key, dict(cache.get(key), params={"k": 16}))
    assert registry.resolve_params_info(spec, problem) == (
        {"k": 4}, "default:smem-fallback")
    # an unvalidated record is ignored
    cache.put(key, dict(cache.get(key), params={"k": 2}, exact=False))
    assert registry.resolve_params_info(spec, problem) == ({"k": 4},
                                                           "default")


def test_swept_winner_reaches_dispatch_and_is_counted(host_sweep):
    spec = host_sweep
    problem = {"n": 32, "max_k": 8, "dtype": "float32"}
    rec = sweep(spec, problem, reps=1, warmup=0)
    dispatches = _m.counter(
        "repro_kernel_dispatch_total",
        "kernel dispatches by resolved-params provenance and precision tier",
        ("kernel", "provenance", "tier"))
    before = dispatches.value(kernel=spec.name, provenance="tuned",
                              tier="f32")
    x = torch.ones(32)
    # the kernel path (the card's); arrays on the CPU suffice for a toy
    out = registry.dispatch(spec, problem, (x,), torch.device("cuda"))
    assert spec.seen[-1] == rec["params"]["k"] and torch.equal(out, x * 2)
    assert dispatches.value(kernel=spec.name, provenance="tuned",
                            tier="f32") == before + 1
    ref = dispatches.value(kernel=spec.name, provenance="ref", tier="f32")
    registry.dispatch(spec, problem, (x,), torch.device("cpu"))
    assert dispatches.value(kernel=spec.name, provenance="ref",
                            tier="f32") == ref + 1


def test_best_tile_exact_batch_before_pow2_bucket(tmp_path, monkeypatch):
    c = TuneCache("fused_mlp", tmp_path / "fused_mlp.json")
    monkeypatch.setattr(tcache, "_default", {"fused_mlp": c})
    widths = [5, 16, 1]
    c.put(shape_key(widths, "float32", "cuda", 12),
          {"params": {"block_rows": 4}, "exact": True})
    c.put(shape_key(widths, torch.float32, "cuda", 16),
          {"params": {"block_rows": 8}, "exact": True})
    assert best_tile(widths, torch.float32, "cuda", 12) == 4   # exact
    assert best_tile(widths, "float32", "cuda", 13) == 8       # pow2
    assert best_tile(widths, "float32", "cuda", 100) is None
    c.put(shape_key(widths, "float32", "cuda", 32),
          {"params": {"block_rows": 2}, "exact": False})
    assert best_tile(widths, "float32", "cuda", 32) is None
    # the same chain the fused MLP's spec looks up
    problem = {"widths": tuple(widths), "batch": 12, "dtype": "float32"}
    assert fused_ops.SPEC.lookup_keys(problem) == [
        shape_key(widths, "float32", "cuda", 12),
        shape_key(widths, "float32", "cuda", 16)]
    assert registry.tuned_params(fused_ops.SPEC, problem) == {
        "block_rows": 4}


def _bundle(tmp_path, name="b", hidden=(8,)):
    return save_model(tmp_path / name, MLP((1, 3), list(hidden), 1).init(0))


def test_autotune_sweeps_bundle_buckets(tmp_path, monkeypatch):
    swept = []
    monkeypatch.setattr(kt, "sweep", lambda kernel, problem, **kw:
                        swept.append((kernel, problem)) or {"exact": True})
    mp = _bundle(tmp_path)
    autotune(mp, buckets=[16, 8])
    assert [p["batch"] for _, p in swept] == [8, 16]
    assert {p["widths"] for _, p in swept} == {(3, 8, 1)}
    assert swept[0][1]["acts"] == ("relu", "identity")
    swept.clear()
    autotune([3, 8, 1])  # the default flush policy's serve buckets
    policy = FlushPolicy()
    assert [p["batch"] for _, p in swept] == serve_buckets(
        policy.min_bucket, policy.max_batch_rows) == [
            8, 16, 32, 64, 128, 256, 512, 1024]


def test_autotune_rejects_non_mlp_bundle(tmp_path):
    (tmp_path / "conv").mkdir()
    (tmp_path / "conv" / "spec.json").write_text(json.dumps(
        {"in_shape": [1, 8, 8, 2],
         "layers": [{"kind": "conv2d", "features": 4}]}))
    with pytest.raises(ValueError, match="not a pure MLP"):
        autotune(str(tmp_path / "conv"), buckets=[8])


def test_autotune_registered_sweeps_default_problems(host_sweep,
                                                     monkeypatch):
    bare = _toy_spec("toy_bare")
    bare.params = ()
    monkeypatch.setitem(registry._SPECS, bare.name, bare)
    recs = autotune_registered(["toy_bare", "toy_double"], reps=1,
                               warmup=0)
    assert len(recs) == 1 and recs[0]["exact"]     # the bare spec: skipped
    assert bare.seen == []
    names = []
    monkeypatch.setattr(kt, "sweep", lambda spec, problem, **kw:
                        names.append(spec.name) or {"exact": True})
    autotune_registered()
    assert sorted(set(names)) == ["flash_attention", "flash_attention_int8",
                                  "fused_mlp", "fused_mlp_int8",
                                  "stencil_gather", "toy_double"]
    assert names.count("fused_mlp") == 2 and names.count("toy_bare") == 0


def test_run_tune_writes_only_under_the_port_tune_directory(host_sweep,
                                                            tmp_path):
    """The reference writes ``artifacts/tune/``; the port's ``run_tune``
    writes its own ``artifacts/tune_torch/`` and nothing else.  On the
    CPU every fused-MLP candidate is refused (the kernel takes CUDA
    tensors only), so the records are stored as never to be served."""
    mp = _bundle(tmp_path)
    before = {p for p in tmp_path.rglob("*")}
    run_tune(bundle=mp, buckets=(8, 16), kernels="fused_mlp,toy_double")
    written = {p for p in tmp_path.rglob("*")} - before
    assert written == {tcache.ART, tcache.ART / "fused_mlp.json",
                       tcache.ART / "toy_double.json"}
    entries = json.loads((tcache.ART / "fused_mlp.json").read_text())[
        "entries"]
    assert sorted(entries) == [shape_key((3, 8, 1), "float32", "cuda", b)
                               for b in (16, 8)]
    assert not any(r["exact"] for r in entries.values())
    assert all("CUDA" in s["error"] for r in entries.values()
               for s in r["swept"])
    assert tcache.ART.name == "tune_torch"


def test_dryrun_cli_requires_tune():
    from repro_torch.launch import dryrun
    with pytest.raises(SystemExit):
        dryrun.main([])


@pytest.mark.parametrize("name", ["fused_mlp", "fused_mlp_int8"])
def test_sweep_inputs_keep_activations_at_unit_scale(name):
    """The sweep holds each candidate to the spec's tolerance, which is
    stated for unit-scale activations: the inputs of a 1,024-wide
    minibude stack must stay there through every layer."""
    spec = registry.get_spec(name)
    problem = {"widths": (6, 1024, 819, 655, 524, 419, 335, 1),
               "acts": ("relu",) * 6 + ("identity",), "batch": 256,
               "ndim": 2, "dtype": "float32"}
    arrays = spec.make_call(problem, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    out = spec.ref_call(problem, arrays)
    assert out.shape == (256, 1) and 0.05 < float(out.abs().max()) < 20.0
