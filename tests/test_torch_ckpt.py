"""Port parity: the seekable token pipeline against repro.data (bit for
bit), and the checkpoint manager: round trips bit for bit in f32 and
bf16, atomic writes, keep-k, and exact resume of LM training on the CPU
(N steps, save, restore, M more equal N + M uninterrupted steps bit for
bit).
"""
import json

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import archs, base  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.dist.sharding import NamedSharding  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


@pytest.mark.parametrize("vocab,seq,batch,rank,size", [
    (8192, 256, 8, 0, 1), (256, 33, 6, 1, 3), (128256, 64, 4, 3, 4)])
def test_batches_equal_the_references(vocab, seq, batch, rank, size):
    mine = TokenPipeline(vocab, seq, batch, seed=7, dp_rank=rank,
                         dp_size=size)
    ref = jpipe.TokenPipeline(vocab, seq, batch, seed=7, dp_rank=rank,
                              dp_size=size)
    for step in (0, 1, 36, 1000):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    back = mine.reshard(0, 1).batch_at(5)["tokens"]
    lo = rank * (batch // size)
    np.testing.assert_array_equal(back[lo:lo + batch // size],
                                  mine.batch_at(5)["tokens"])
    with pytest.raises(ValueError, match="split"):
        TokenPipeline(vocab, seq, batch + 1, dp_size=2 * batch)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16)
                       .requires_grad_(),
                       "layers": [{"b": torch.randn(4, generator=g)}],
                       "pair": (torch.randn(2, 2, generator=g),
                                torch.arange(3, dtype=torch.int64))},
            "opt": {"step": torch.tensor(seed, dtype=torch.int32)}}


@pytest.mark.parametrize("async_write", [True, False])
def test_round_trip_is_bit_exact(tmp_path, async_write):
    mgr = CheckpointManager(tmp_path, keep=3, async_write=async_write)
    st = _state(3)
    mgr.save(7, st)
    st["params"]["layers"][0]["b"].add_(1.0)  # the copy was taken at save
    restored, step = mgr.restore(_state(0))
    assert step == 7
    want = _state(3)
    for a, b in zip(tree_leaves(restored), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert restored["params"]["w"].requires_grad
    assert isinstance(restored["params"]["pair"], tuple)
    meta = json.loads((tmp_path / "step_00000007" / "meta.json").read_text())
    assert "bfloat16" in meta["dtypes"] and meta["step"] == 7
    # the file the reference's manager reads: bf16 as raw 16-bit words
    z = np.load(tmp_path / "step_00000007" / "arrays.npz")
    assert z[f"a{meta['dtypes'].index('bfloat16')}"].dtype == np.uint16


def test_restore_refuses_shardings(tmp_path):
    """Shardings that do not match the state are refused; matching ones
    lay each leaf out on its mesh (a one-rank gloo group here): a
    DTensor equal to the saved leaf bit for bit, in its dtype, with its
    ``requires_grad``."""
    from torch.distributed.tensor import Replicate
    from test_torch_dist import one_rank_group
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(1))
    with pytest.raises(ValueError, match="shardings"):
        mgr.restore(_state(0), shardings={})
    with one_rank_group():
        mesh = make_local_mesh(device="cpu")
        sh = tree_map(lambda t: NamedSharding(mesh, (Replicate(),) * 2),
                      _state(0))
        restored, step = mgr.restore(_state(0), shardings=sh)
        assert step == 1
        for a, b, like in zip(tree_leaves(restored), tree_leaves(_state(1)),
                              tree_leaves(_state(0))):
            assert hasattr(a, "to_local") and a.dtype == b.dtype
            assert a.requires_grad == like.requires_grad
            assert torch.equal(a.to_local(), b)


def test_crash_before_rename_keeps_the_last_checkpoint(tmp_path,
                                                       monkeypatch):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, _state(1))
    real = type(tmp_path).rename

    def crash(self, target):
        if self.name.endswith(".tmp"):
            raise OSError("crash between the write and the rename")
        return real(self, target)
    monkeypatch.setattr(type(tmp_path), "rename", crash)
    with pytest.raises(OSError, match="crash"):
        mgr.save(2, _state(2))
    monkeypatch.undo()
    assert (tmp_path / "step_00000002.tmp").exists()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    restored, step = mgr.restore(_state(0))
    assert step == 1 and torch.equal(restored["opt"]["step"],
                                      torch.tensor(1, dtype=torch.int32))
    mgr.save(2, _state(2))  # a later save replaces the stale .tmp
    assert mgr.all_steps() == [1, 2]
    assert not (tmp_path / "step_00000002.tmp").exists()


def test_keep_k_rotation_matches_reference(tmp_path):
    mine = CheckpointManager(tmp_path / "port", keep=2)
    ref = jckpt.CheckpointManager(tmp_path / "ref", keep=2)
    for s in (3, 1, 5, 9):
        mine.save(s, _state(s))
        ref.save(s, {"x": np.zeros(2)})
    mine.wait()
    ref.wait()
    assert mine.all_steps() == ref.all_steps() == [5, 9]
    assert mine.latest_step() == 9
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_state(0))


def _run(cfg, state, pipe, steps):
    losses = []
    for step in steps:
        state, m = trainer.train_step(cfg, state, trainer.to_device(
            pipe.batch_at(step), "cpu"), total_steps=20)
        losses.append(m["loss"].item())
    return state, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_resume_equals_uninterrupted_training(tmp_path, dtype):
    """N steps, save, restore into a fresh state, M more: the parameters,
    optimizer state and losses equal N + M uninterrupted steps bit for
    bit (the pipeline is seekable; the CPU's arithmetic is
    deterministic)."""
    cfg = archs.reduced(base.get_config("llama3.2-3b")).replace(dtype=dtype)
    pipe = TokenPipeline(cfg.vocab_size, 16, 2, seed=3)
    N, M = 3, 2
    full, full_losses = _run(cfg, trainer.make_train_state(0, cfg, "cpu"),
                             pipe, range(N + M))
    mgr = CheckpointManager(tmp_path, keep=1)
    first, losses = _run(cfg, trainer.make_train_state(0, cfg, "cpu"), pipe,
                         range(N))
    trainer.save_train_state(mgr, N, first)
    fresh = trainer.make_train_state(1, cfg, "cpu")  # other weights
    resumed, start = trainer.restore_train_state(mgr, cfg, fresh)
    assert start == N
    for a, b in zip(tree_leaves(resumed), tree_leaves(first)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    resumed, more = _run(cfg, resumed, pipe, range(start, N + M))
    assert losses + more == full_losses
    for a, b in zip(tree_leaves(resumed), tree_leaves(full)):
        assert torch.equal(a.detach(), b.detach())
    # onto a mesh (a one-rank group): the same leaves, laid out on it
    from test_torch_dist import one_rank_group
    with one_rank_group():
        mesh = make_local_mesh(device="cpu")
        on_mesh, start = trainer.restore_train_state(mgr, cfg, fresh,
                                                     mesh=mesh)
        assert start == N
        for a, b in zip(tree_leaves(on_mesh), tree_leaves(first)):
            assert a.device_mesh is mesh
            assert torch.equal(a.to_local().detach(), b.detach())
