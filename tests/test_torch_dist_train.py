"""Port parity: the sharded train step of ``repro_torch`` against the
reference's unsharded one, on the CPU.

The reference's ``TINY`` config (``tests/test_dist.py``) in f32, with
the reference's weights, trains one step on a gloo group of four ranks
laid out data 2 x model 2 (one head, half the vocabulary and half the
MLP a rank, the batch split over data; the step runs on DTensors under
``use_mesh``): its loss and every gradient against
``jax.value_and_grad`` of the reference's ``train_loss``, each
gradient's largest error within 1e-4 of the leaf's largest magnitude and
the loss within rtol 1e-5 (``tests/test_torch_train.py``'s f32 limits:
summation order only).  The sharded ``train_step`` against the
unsharded port step on the same rank: loss and norm within rtol 1e-6,
every leaf of the state within 1e-4 of its largest magnitude after one
step, the gradients' limit: at step 0 the rate is 0, so the step moves
only Adam's moments, which carry each gradient's summation-order error
(the largest 1.2e-6 of a leaf's magnitude, measured on the CPU).  A
state saved from the 2 x 2 mesh and restored onto data 4 x model 1
equals what was saved bit for bit.  ``run_smoke`` on torch's
fake group of 256 ranks reports non-zero collective bytes.
"""
import json
import pickle

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from test_torch_dist import spawn_group  # noqa: E402
from test_torch_train import assert_trees_close  # noqa: E402

# the reference's TINY (tests/test_dist.py), in f32
JTINY = JModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                     n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
                     pattern=(JLayerSpec(),), dtype="float32")
B, S = 4, 16

_WORKER = r"""
import json, pickle, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np
import torch
import torch.distributed as dist
rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.dist.hlo_analysis import collective_stats
from repro_torch.dist.sharding import full_tensor, use_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import init_opt_state, tree_leaves, tree_map
from repro_torch.train import trainer
cfg = ModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
                  pattern=(LayerSpec(),), dtype="float32")
with open(f"{tmp}/inputs.pkl", "rb") as f:
    tree, batch = pickle.load(f)
batch = trainer.to_device(batch, "cpu")
out = {}
try:
    mesh = make_local_mesh((2, 2), device="cpu")

    def fresh():
        p = lm.params_from_jax(cfg, tree, device="cpu")
        for t in tree_leaves(p):
            t.requires_grad_(True)
        return {"params": p, "opt": init_opt_state(p, cfg.opt_policy)}
    state = trainer.shard_state(fresh(), trainer.state_shardings(
        cfg, fresh(), mesh))
    params = state["params"]
    with use_mesh(mesh) as ctx, collective_stats() as st:
        b = {k: ctx.make_global(v, ("batch", None)) for k, v in batch.items()}
        loss = lm.train_loss(cfg, params, b)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        whole = [full_tensor(g) for g in grads]
        out["loss"] = float(full_tensor(loss))
    out["placements"] = {
        "wq": repr(params["stack"][0][0]["mixer"]["wq"].placements),
        "tok_embed": repr(params["tok_embed"].placements)}
    out["stats"] = st.per_kind_count
    out["stats_bytes"] = st.total_bytes
    np.savez(f"{tmp}/grads{rank}.npz",
             **{f"g{i}": g.detach().numpy() for i, g in enumerate(whole)})
    with use_mesh(mesh) as ctx:
        b = {k: ctx.make_global(v, ("batch", None)) for k, v in batch.items()}
        state, m = trainer.train_step(cfg, state, b)
    ref, m0 = trainer.train_step(cfg, fresh(), batch)
    out["step_loss"] = [float(m["loss"]), float(m0["loss"])]
    out["step_norm"] = [float(m["grad_norm"]), float(m0["grad_norm"])]
    errs = []
    for a, c in zip(tree_leaves(state), tree_leaves(ref)):
        a, c = full_tensor(a).detach().float(), c.detach().float()
        errs.append(float((a - c).abs().max()
                          / max(float(c.abs().max()), 1e-30)))
    out["step_err"] = max(errs)
    mgr = CheckpointManager(f"{tmp}/ckpt", async_write=False)
    trainer.save_train_state(mgr, 1, state)
    rows = make_local_mesh((4, 1), device="cpu")
    back, step = trainer.restore_train_state(mgr, cfg, fresh(), mesh=rows)
    out["restore_step"] = step
    out["restore_exact"] = all(
        torch.equal(full_tensor(a).detach(), full_tensor(c).detach())
        for a, c in zip(tree_leaves(back), tree_leaves(state)))
    out["restore_mesh"] = all(t.device_mesh is rows
                              for t in tree_leaves(back))
    out["restore_grad"] = all(t.requires_grad
                              for t in tree_leaves(back["params"]))
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's loss and gradients, and the four ranks' reports
    and gathered gradients."""
    tmp = tmp_path_factory.mktemp("dist_train")
    jparams = jlm.init_params(jax.random.PRNGKey(0), JTINY)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, JTINY.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tree = jax.tree.map(np.asarray, jparams)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump((tree, batch), f)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(JTINY, p, {k: jax.numpy.asarray(v)
                                           for k, v in batch.items()}))(
        jparams)
    outs = spawn_group(_WORKER, 4, tmp)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    grads = [dict(np.load(tmp / f"grads{r}.npz")) for r in range(4)]
    return tree, float(jloss), jgrads, reports, grads


def test_sharded_loss_and_every_grad_match_the_reference(run):
    from repro_torch.configs.base import LayerSpec, ModelConfig
    tree, jloss, jgrads, reports, grads = run
    cfg = ModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                      n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
                      pattern=(LayerSpec(),), dtype="float32")
    like = lm.params_from_jax(cfg, tree, device="cpu")
    for r, g in zip(reports, grads):
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        it = iter(torch.from_numpy(g[f"g{i}"]) for i in range(len(g)))
        assert_trees_close(tree_map(lambda _: next(it), like), jgrads, 1e-4)


def test_the_step_ran_sharded_with_collectives(run):
    for r in run[3]:
        # wq: fsdp over data, heads over model; the table: vocab over
        # model, fsdp over data
        assert r["placements"]["wq"] == "(Shard(dim=0), Shard(dim=1))"
        assert r["placements"]["tok_embed"] == "(Shard(dim=1), Shard(dim=0))"
        assert r["stats"].get("all-gather", 0) > 0
        assert r["stats"].get("reduce-scatter", 0) > 0
        assert r["stats_bytes"] > 0


def test_sharded_train_step_matches_one_rank(run):
    for r in run[3]:
        np.testing.assert_allclose(*r["step_loss"], rtol=1e-6)
        np.testing.assert_allclose(*r["step_norm"], rtol=1e-6)
        assert r["step_err"] <= 1e-4


def test_save_then_restore_onto_other_shardings_is_exact(run):
    for r in run[3]:
        assert r["restore_step"] == 1
        assert r["restore_exact"] and r["restore_mesh"] and r["restore_grad"]


def test_run_smoke_reports_collective_bytes(tmp_path, capsys):
    rec = dryrun.run_smoke(tmp_path, force=True, device="cpu")
    assert rec["status"] == "ok" and rec["coll_bytes"] > 0
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["device"] == "cpu"
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert rec["coll_counts"].get(kind, 0) > 0
        assert rec["coll_bytes_per_kind"][kind] > 0
    assert rec["coll_bytes_corrected"] <= rec["coll_bytes"]
    assert "[smoke] status=ok" in capsys.readouterr().out
    # cached unless forced
    assert dryrun.run_smoke(tmp_path)["run_s"] == rec["run_s"]


def test_dryrun_cli_smoke_and_refusals(tmp_path):
    dryrun.main(["--smoke", "--device", "cpu", "--out", str(tmp_path)])
    record = tmp_path / "smoke-tiny__smoke_train__pod16x16.json"
    assert json.loads(record.read_text())["device"] == "cpu"
    with pytest.raises(SystemExit):
        dryrun.main([])
    if not torch.cuda.is_available():
        # the card unless the caller asks for the host: no quiet fallback
        with pytest.raises(SystemExit, match="smoke cell failed"):
            dryrun.main(["--smoke", "--force", "--out", str(tmp_path)])
        assert json.loads(record.read_text())["status"].startswith("FAIL")


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium"])
def test_input_specs_match_the_reference(arch, shape_name):
    """Each input of a cell: the reference's shape and, on its fake
    mesh, its spec entry by entry (dtypes: int64 indices in the port,
    the reference's int32)."""
    import types
    from repro.configs import base as jbase
    from repro.launch.specs import input_specs as jinput_specs
    from repro_torch.configs import base
    from repro_torch.launch.specs import input_specs
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    want = jinput_specs(jbase.get_config(arch), jbase.SHAPES[shape_name])
    got = input_specs(base.get_config(arch), base.SHAPES[shape_name], mesh)
    assert set(got) == set(want)
    from repro.dist.sharding import ShardCtx as JShardCtx
    for k, sp in got.items():
        assert sp.shape == tuple(want[k].shape)
        axes = {"tokens": ("batch", None), "targets": ("batch", None),
                "position_ids": (None, "batch", None),
                "enc_embeds": ("batch", None, None)}[k]
        assert sp.spec == tuple(JShardCtx(mesh).spec_for(sp.shape, axes))


def test_prefill_and_decode_cells_build_on_a_mesh():
    """Prefill and decode cells of a reduced config on a one-rank group:
    parameters, caches and inputs laid out as DTensors; the step is not
    run (the dry run runs the train cell)."""
    from repro_torch.configs import archs, base
    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import build_cell
    from test_torch_dist import one_rank_group
    cfg = archs.reduced(base.get_config("llama3.2-3b"))
    with one_rank_group():
        mesh = make_local_mesh(device="cpu")
        with use_mesh(mesh):
            for kind in ("prefill", "decode"):
                cell = build_cell(cfg, ShapeCell(kind, 16, 2, kind), mesh,
                                  device="cpu")
                leaves = [t for t in tree_leaves(list(cell["args"][:-1]))
                          if isinstance(t, torch.Tensor)]
                assert leaves and all(hasattr(t, "device_mesh")
                                      for t in leaves)
