"""Port parity: the sharding substrate (``repro_torch.dist``,
``repro_torch.launch.mesh``) against ``repro.dist`` on the CPU.

In one process: ``spec_for`` and the axis sizes on the reference's fake
meshes (``tests/test_dist.py``), ``param_spec_tree`` and
``cache_spec_tree`` leaf by leaf over every registered config's reduced
parameters and caches, the context stack, ``placements_for``,
``_moe_groups`` and the pricing of ``CollectiveStats`` against the
reference's HLO parser.  In one spawned gloo group of four ranks
(:func:`spawn_group`, one per module): ``constrain`` redistributing a
DTensor, ``collective_stats`` of a sum, ``fused_mlp_sharded`` and
``fused_mlp_int8_sharded`` (their plain versions, on each rank's rows),
``InferenceEngine.apply_batched`` and ``__call__`` under a mesh, and the
serve queue carrying a submitter's mesh to its batcher.

Tolerances: a rank's rows of a sharded op equal the op on the same rows
bit for bit (the same function of the same inputs); the gathered rows
against the unsharded op and the reference's oracle within 1e-5 (f32:
the CPU's matrix products sum a row in an order that depends on the
batch's shape) or bit for bit (the engine, which serves fixed tiles of
64 rows on the CPU, and the int8 tier, whose products are exact).
"""
import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.dist.hlo_analysis import collective_stats as jcollective_stats  # noqa: E402
from repro.kernels.fused_mlp.ref import fused_mlp_ref as jfused_mlp_ref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant.quantize import quant_mlp_ref as jquant_mlp_ref  # noqa: E402
from repro_torch.configs import archs, base  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.hlo_analysis import CollectiveStats  # noqa: E402
from repro_torch.dist.sharding import (ShardCtx, cache_spec_tree,  # noqa: E402
                                       constrain, current_ctx,
                                       param_spec_tree, placements_for,
                                       use_mesh)
from repro_torch.models import blocks, lm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAKE_MESH = types.SimpleNamespace(shape={"data": 4, "model": 2})
FAKE_POD = types.SimpleNamespace(shape={"pod": 2, "data": 4, "model": 2})


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def spawn_group(script: str, world: int, *args, timeout=240):
    """Run ``script`` in ``world`` processes, each told its rank, the
    world size, a free local port and ``args``; returns each rank's
    standard output, asserting every rank exited 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(port),
         *map(str, args)],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


@contextlib.contextmanager
def one_rank_group():
    """A gloo group of this process alone, destroyed on exit."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ spec_for -----
SPEC_CASES = [
    (FAKE_MESH, False, (16, 64), ("batch", "ffn")),
    (FAKE_MESH, False, (3, 64), ("batch", "ffn")),
    (FAKE_MESH, False, (16, 64, 64), ("batch", "seq", "ffn")),
    (FAKE_MESH, False, (16, 1, 64), ("batch", "seq", "ffn")),
    (FAKE_MESH, False, (1, 512, 8), ("batch", "longseq", None)),
    (FAKE_MESH, False, (8, 6), ("fsdp", "heads")),
    (FAKE_MESH, False, (2, 2, 3), ("batch", "vocab", "experts")),
    (FAKE_MESH, False, (12, 8), ("experts", "ffn")),
    (FAKE_MESH, False, (5,), (None,)),
    (FAKE_POD, True, (16, 8), ("batch", None)),
    (FAKE_POD, False, (16, 8), ("batch", None)),
    (FAKE_POD, True, (4, 8), ("batch", None)),
    (FAKE_POD, True, (1, 64, 8), ("batch", "longseq", "heads")),
]


@pytest.mark.parametrize("mesh,multi_pod,shape,axes", SPEC_CASES)
def test_spec_for_matches_the_reference(mesh, multi_pod, shape, axes):
    want = jsharding.ShardCtx(mesh, multi_pod).spec_for(shape, axes)
    got = ShardCtx(mesh, multi_pod).spec_for(shape, axes)
    assert isinstance(got, tuple) and got == tuple(want)


@pytest.mark.parametrize("mesh,multi_pod", [(FAKE_MESH, False),
                                            (FAKE_POD, True),
                                            (FAKE_POD, False)])
def test_axis_sizes_match_the_reference(mesh, multi_pod):
    ref, ctx = jsharding.ShardCtx(mesh, multi_pod), ShardCtx(mesh, multi_pod)
    for name in list(sharding._LOGICAL_TO_MESH) + ["unmapped"]:
        assert ctx.axis_size(name) == ref.axis_size(name), name
        assert ctx.mesh_axes_for(name) == ref.mesh_axes_for(name), name
        assert ctx.local_axis_size(name) == ref.local_axis_size(name), name


def test_spec_for_without_a_mesh_replicates():
    assert ShardCtx().spec_for((4, 8), ("batch", "ffn")) == (None, None)
    with pytest.raises(ValueError, match="logical axes"):
        ShardCtx(FAKE_MESH).spec_for((4, 8), ("batch",))


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    assert placements_for(("data", "model"), FAKE_MESH) == [Shard(0),
                                                          Shard(1)]
    assert placements_for((None, "data"), FAKE_MESH) == [Shard(1),
                                                         Replicate()]
    # one dim over two axes: both mesh dims shard it, outer first
    assert placements_for((None, ("data", "model")), FAKE_MESH) == [
        Shard(1), Shard(1)]
    assert placements_for(((("pod", "data")), None), FAKE_POD) == [
        Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="axis order"):
        placements_for((("model", "data"),), FAKE_MESH)


# ----------------------------------------------------------- spec trees ----
def _port_specs(tree, prefix=""):
    """{reference-style path: spec} of a port spec tree, each layer of a
    pattern slot folded onto its slot (the reference stacks them)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_specs(v, f"{prefix}/{k}"))
    elif isinstance(tree, list) and prefix.endswith("prefix"):
        for i, v in enumerate(tree):
            out.update(_port_specs(v, f"{prefix}/{i}"))
    elif isinstance(tree, (list, tuple)) and tree and \
            not isinstance(tree[0], (str, type(None), tuple)):
        if prefix.endswith("stack"):  # slots of lists of layers
            for slot, layers in enumerate(tree):
                specs = [_port_specs(lay, f"{prefix}/{slot}")
                         for lay in layers]
                assert all(s == specs[0] for s in specs)  # every repeat
                out.update({p: (None,) + sp for p, sp in specs[0].items()})
        else:
            for i, v in enumerate(tree):
                out.update(_port_specs(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        keys = [str(getattr(e, "key", getattr(e, "idx", "")))
                for e in path]
        out["/" + "/".join(keys)] = tuple(spec)
    return out


REDUCED = sorted(base.all_configs())


@pytest.mark.parametrize("name", REDUCED)
@pytest.mark.parametrize("mesh,multi_pod", [(FAKE_MESH, False),
                                            (FAKE_POD, True)])
def test_param_spec_tree_matches_the_reference(name, mesh, multi_pod):
    """Every leaf of the reduced config's parameters (and, named alike,
    its optimizer mirrors) gets the reference's spec: the port's
    per-layer leaves that of the reference's stacked leaf past its
    repeat axis."""
    jcfg = jarchs.reduced(jbase.get_config(name))
    cfg = archs.reduced(base.get_config(name))
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    want = _ref_specs(jsharding.param_spec_tree(shapes, jcfg, mesh,
                                                multi_pod))
    params = lm.init_params(0, cfg, device="cpu")
    got = _port_specs(param_spec_tree(params, cfg, mesh, multi_pod))
    assert got == want


@pytest.mark.parametrize("name", REDUCED)
@pytest.mark.parametrize("long_ctx", [False, True])
def test_cache_spec_tree_matches_the_reference(name, long_ctx):
    jcfg = jarchs.reduced(jbase.get_config(name))
    cfg = archs.reduced(base.get_config(name))
    B, S = 8, 64
    jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                jcfg))

    def jcaches(p):
        enc = None
        if jcfg.enc_dec:
            enc = jlm.encode(jcfg, p, jax.numpy.zeros(
                (B, jcfg.enc_ctx, jcfg.d_model), jcfg.jdtype))
        return jlm.init_caches(jcfg, B, S, jcfg.jdtype, enc_out=enc,
                               params=p if jcfg.enc_dec else None)
    shapes = jax.eval_shape(jcaches, jp)
    want = _ref_specs(jsharding.cache_spec_tree(shapes, jcfg, FAKE_MESH,
                                                long_ctx=long_ctx))
    params = lm.init_params(0, cfg, device="cpu")
    enc = None
    if cfg.enc_dec:
        with torch.no_grad():
            enc = lm.encode(cfg, params, torch.zeros(
                (B, cfg.enc_ctx, cfg.d_model), dtype=cfg.torch_dtype))
    caches = lm.init_caches(cfg, B, S, enc_out=enc,
                            params=params if cfg.enc_dec else None,
                            device="cpu")
    got = _port_specs(cache_spec_tree(caches, cfg, FAKE_MESH,
                                      long_ctx=long_ctx))
    assert got == want


def test_train_state_mirrors_take_the_parameters_specs():
    cfg = archs.reduced(base.get_config("llama3.2-3b"))
    from repro_torch.train import trainer
    st = trainer.make_train_state(0, cfg, device="cpu")
    specs = param_spec_tree(st, cfg, FAKE_MESH)
    for k in ("m", "v", "master"):
        assert specs["opt"][k] == specs["params"]
    assert specs["opt"]["step"] == ()
    assert specs["params"]["tok_embed"] == ("model", "data")


# ------------------------------------------------------------- context -----
def test_use_mesh_stack_and_current_ctx():
    assert current_ctx() is None
    with use_mesh(FAKE_MESH) as ctx:
        assert current_ctx() is ctx and ctx.mesh is FAKE_MESH
        with use_mesh(FAKE_MESH, multi_pod=True) as inner:
            assert current_ctx() is inner and inner.multi_pod
        with use_mesh(None) as none:
            assert current_ctx() is none and none.mesh is None
        assert current_ctx() is ctx
    assert current_ctx() is None


def test_constrain_is_a_noop_without_a_mesh_and_on_plain_tensors():
    x = torch.ones((4, 8))
    assert constrain(x, "batch", None) is x
    with use_mesh(FAKE_MESH):
        assert constrain(x, "batch", None) is x
    with use_mesh(None):
        assert constrain(x, "batch", None) is x


@pytest.mark.parametrize("shards,T", [(1, 8192), (4, 8192), (4, 30),
                                      (8, 24)])
def test_moe_groups_match_the_reference(shards, T):
    mesh = types.SimpleNamespace(shape={"data": shards, "model": 2})
    with jsharding.use_mesh(mesh):
        want = jblocks._moe_groups(T)
    with use_mesh(mesh):
        got = blocks._moe_groups(T)
    assert got == want
    assert blocks._moe_groups(T) == 1  # no mesh


# --------------------------------------------------------- accounting ------
@pytest.mark.parametrize("kind,dtype,n_in,n_out", [
    ("all-reduce", "f32", 1024, 1024),
    ("all-gather", "bf16", 256, 1024),
    ("reduce-scatter", "f32", 4096, 1024),
    ("all-to-all", "s32", 512, 512),
])
def test_collective_pricing_matches_the_reference(kind, dtype, n_in, n_out):
    """The port's per-collective bytes (max of in and out, all-reduce
    doubled, f32 re-priced as bf16 in ``corrected``) equal what the
    reference's HLO parser prices the same collective at."""
    hlo = (f"  %c = {dtype}[{n_out}] {kind}({dtype}[{n_in}] %x), "
           f"replica_groups={{}}")
    want = jcollective_stats(hlo)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16,
           "s32": torch.int32}[dtype]
    got = CollectiveStats()
    got.add(kind, n_in, n_out, tdt)
    assert got.per_kind_count == want.per_kind_count
    assert got.per_kind_bytes == want.per_kind_bytes
    assert got.per_kind_corrected == want.per_kind_corrected
    assert got.corrected_bytes <= got.total_bytes
    assert str(got).startswith("CollectiveStats(" + kind)


# ----------------------------------------------------- a gloo group --------
_WORKER = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np
import torch
import torch.distributed as dist
rank, world, port, tmp, bundle = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import Replicate, Shard
from repro_torch.core.engine import InferenceEngine
from repro_torch.dist.hlo_analysis import collective_stats
from repro_torch.dist.sharding import (constrain, current_ctx, distribute,
                                       use_mesh)
from repro_torch.kernels.fused_mlp import int8 as qops
from repro_torch.kernels.fused_mlp import ops as fops
from repro_torch.kernels.fused_mlp.fused_mlp import pack_mlp
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.quant.quantize import quantize_params
from repro_torch.serve import ServeQueue
out, arrays = {}, {}
try:
    grid = make_local_mesh((2, 2), device="cpu")
    rows = make_local_mesh(device="cpu")  # (4, 1)
    out["rows_mesh"] = list(rows.shape)
    full = torch.arange(48.0).reshape(8, 6)
    with use_mesh(grid) as ctx:
        x = distribute(full, grid, [Replicate(), Replicate()])
        y = constrain(x, "batch", "ffn")
        out["constrained"] = [repr(p) for p in y.placements]
        out["block_ok"] = torch.equal(
            y.to_local(), full.reshape(2, 4, 2, 3)[
                grid.get_coordinate()[0], :, grid.get_coordinate()[1]])
        out["same"] = constrain(y, "batch", "ffn") is y
        t = ctx.make_global(full, ("batch", None))
        out["global"] = [repr(p) for p in t.placements]
        out["global_ok"] = torch.equal(t.full_tensor(), full)
    with use_mesh(rows), collective_stats() as st:
        s = distribute(full, rows, [Shard(0), Replicate()]).sum()
        out["sum"] = float(s.full_tensor())
    out["stats"] = {"count": st.per_kind_count, "bytes": st.per_kind_bytes,
                    "corrected": st.corrected_bytes,
                    "total": st.total_bytes}
    from repro_torch.dist import comm
    from repro_torch.models.loss import embed_lookup
    with use_mesh(rows):  # a host mesh needs no staging: no mode
        out["mode_under_mesh"] = comm._active() is not None
    with use_mesh(rows), collective_stats() as outer:
        with collective_stats() as inner:
            distribute(full, rows, [Shard(0), Replicate()]).sum(
                ).full_tensor()
    out["nested"] = [outer.per_kind_count, inner.per_kind_count]
    # the vocab-parallel lookup of a table laid out as tok_embed (vocab
    # on model, its other dim on data); integer values: sums are exact
    V, D = 12, 6
    table = torch.arange(V * D, dtype=torch.float32).reshape(V, D)
    toks = torch.tensor([[0, 11, 5, 6, 3], [7, 7, 1, 10, 2],
                         [4, 8, 9, 0, 11], [6, 5, 3, 2, 1]])
    wgt = torch.arange(4 * 5 * D, dtype=torch.float32).reshape(4, 5, D) % 7
    one_t = table.clone().requires_grad_(True)
    (embed_lookup(one_t, toks) * wgt).sum().backward()
    with use_mesh(grid) as ctx:
        tt = distribute(table, grid, [Shard(1), Shard(0)],
                        requires_grad=True)
        tk = ctx.make_global(toks, ("batch", None))
        with collective_stats() as lst:
            looked = embed_lookup(tt, tk)
        out["lookup_stats"] = lst.per_kind_bytes
        out["lookup_placements"] = [repr(p) for p in looked.placements]
        out["lookup_equal"] = torch.equal(looked.full_tensor(),
                                          table[toks])
        (looked * ctx.make_global(wgt, ("batch", None, None))).sum(
            ).backward()
        out["lookup_grad_placements"] = [repr(p)
                                         for p in tt.grad.placements]
        out["lookup_grad_equal"] = torch.equal(tt.grad.full_tensor(),
                                               one_t.grad)
    g = torch.Generator().manual_seed(0)
    widths = (5, 32, 16, 3)
    ws = [torch.randn(a, b, generator=g) * (2.0 / a) ** 0.5
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.randn(b, generator=g) * 0.1 for b in widths[1:]]
    acts = ("relu", "relu", "identity")
    xs = torch.randn(64, 5, generator=g)
    arrays.update({f"w{i}": w for i, w in enumerate(ws)})
    arrays.update({f"b{i}": b for i, b in enumerate(bs)})
    arrays["x"] = xs
    packed = pack_mlp(ws, bs, acts, device="cpu")
    q = qops.pack_int8_mlp(quantize_params(ws, bs, device="cpu"), acts)
    with use_mesh(rows):
        for tag, op, pk in (("f32", fops, packed), ("int8", qops, q)):
            shard = (fops.fused_mlp_sharded if tag == "f32"
                     else qops.fused_mlp_int8_sharded)
            one = (fops.fused_mlp_op if tag == "f32"
                   else qops.fused_mlp_int8_op)
            y = shard(xs, pk, mesh=rows, data_axes=("data",))
            lo = rank * 16
            out[tag + "_local"] = torch.equal(y.to_local(),
                                              one(xs[lo:lo + 16], pk))
            out[tag + "_placements"] = [repr(p) for p in y.placements]
            arrays[tag] = y.full_tensor()
            odd = shard(xs[:63], pk, mesh=rows, data_axes=("data",))
            out[tag + "_odd"] = (not hasattr(odd, "to_local")
                                 and torch.equal(odd, one(xs[:63], pk)))
    eng = InferenceEngine.get(bundle, device="cpu")
    xe = torch.randn(37, 2, generator=g)
    base_rows = eng.apply_batched(xe)
    with use_mesh(rows), collective_stats() as est:
        sharded_rows = eng.apply_batched(xe)
        called = eng(xe[:32])
        odd = eng(xe[:30])
    out["engine_batched"] = torch.equal(sharded_rows, base_rows)
    out["engine_call"] = torch.equal(called, eng(xe[:32]))
    out["engine_odd"] = torch.equal(odd, eng(xe[:30]))
    out["engine_plain"] = not hasattr(sharded_rows, "to_local")
    out["engine_stats"] = est.per_kind_count
    out["applies"] = len(eng._applies)
    qu = ServeQueue(device="cpu")
    try:
        with use_mesh(rows) as ctx:
            futs = [qu.submit(bundle, xe[i:i + 5]) for i in range(0, 30, 5)]
            out["req_ctx"] = qu._pending[bundle][0].ctx is ctx
        qu.flush()
        out["queue"] = all(torch.equal(f.result(10), eng(xe[i:i + 5]))
                           for f, i in zip(futs, range(0, 30, 5)))
    finally:
        qu.close()
    out["ctx_after"] = current_ctx() is None
    np.savez(f"{tmp}/rank{rank}.npz",
             **{k: v.detach().numpy() for k, v in arrays.items()})
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Four gloo ranks on the CPU, run once for the module: each rank's
    JSON report and arrays."""
    from repro_torch.nn import MLP, save_model
    tmp = tmp_path_factory.mktemp("dist")
    bundle = save_model(tmp / "bundle", MLP((1, 2), [32, 16], 3).init(0))
    outs = spawn_group(_WORKER, 4, tmp, bundle)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    arrays = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return reports, arrays


def test_local_mesh_defaults_to_the_group_on_the_data_axis(group):
    assert all(r["rows_mesh"] == [4, 1] for r in group[0])


def test_constrain_redistributes_a_dtensor(group):
    for r in group[0]:
        assert r["constrained"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert r["block_ok"] and r["same"]
        assert r["global"] == ["Shard(dim=0)", "Replicate()"]
        assert r["global_ok"]


def test_the_collective_mode_runs_only_where_it_has_work(group):
    """A host mesh's collectives need no staging, so ``use_mesh`` puts
    no mode on them; nested recorders join one mode and each counts a
    collective once."""
    for r in group[0]:
        assert not r["mode_under_mesh"]
        outer, inner = r["nested"]
        assert outer == inner and outer.get("all-reduce") == 1


def test_embed_lookup_is_vocab_parallel(group):
    """A table laid out as ``tok_embed`` on data 2 x model 2: the lookup
    gathers only the table's data dim (each rank's 6 vocab rows, 6 wide:
    36 f32 elements, not the whole 72), its rows are partial over the
    vocabulary's mesh dim, and rows and gradient equal one rank's bit
    for bit; the gradient stays in each rank's vocab rows."""
    for r in group[0]:
        assert r["lookup_stats"] == {"all-gather": 36 * 4}
        assert r["lookup_placements"] == ["Shard(dim=0)", "Partial(sum)"]
        assert r["lookup_equal"] and r["lookup_grad_equal"]
        assert r["lookup_grad_placements"][1] == "Shard(dim=0)"


def test_collective_stats_counts_the_all_reduce_of_a_sum(group):
    for r in group[0]:
        st = r["stats"]
        assert r["sum"] == float(sum(range(48)))
        assert st["count"].get("all-reduce", 0) >= 1
        assert st["total"] > 0 and st["corrected"] <= st["total"]
        assert st["corrected"] < st["total"]  # f32 re-priced as bf16


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_sharded_fused_mlp_matches_unsharded_and_the_oracle(group, tier):
    """Each rank runs the op (its plain version here) on its own 16 rows
    of 64: bit for bit the op on those rows; gathered, every rank holds
    the same rows, close to the unsharded op and the reference's
    oracle; rows that do not divide run unsharded on every rank."""
    reports, arrays = group
    for r in reports:
        assert r[tier + "_local"] and r[tier + "_odd"]
        assert r[tier + "_placements"] == ["Shard(dim=0)", "Replicate()"]
    ys = [a[tier] for a in arrays]
    for y in ys[1:]:
        np.testing.assert_array_equal(y, ys[0])
    a = arrays[0]
    ws = [a[f"w{i}"] for i in range(3)]
    bs = [a[f"b{i}"] for i in range(3)]
    acts = ("relu", "relu", "identity")
    if tier == "f32":
        want = np.asarray(jfused_mlp_ref(a["x"], ws, bs, acts))
        np.testing.assert_allclose(ys[0], want, rtol=1e-5, atol=1e-5)
    else:
        from repro.quant.quantize import quantize_params as jq
        want = np.asarray(jquant_mlp_ref(a["x"], jq(ws, bs), acts))
        np.testing.assert_array_equal(ys[0], want)


def test_apply_batched_under_a_mesh_equals_one_rank(group):
    for r in group[0]:
        assert r["engine_batched"] and r["engine_call"] and r["engine_odd"]
        assert r["engine_plain"]
        # the bucket (64 rows) and 32 rows gather their shards; 30 rows
        # do not divide and run unsharded on every rank
        assert r["engine_stats"] == {"all-gather": 2}
        assert r["applies"] == 1  # one apply for the mesh


def test_the_queue_carries_the_submitters_mesh(group):
    for r in group[0]:
        assert r["req_ctx"] and r["queue"] and r["ctx_after"]
