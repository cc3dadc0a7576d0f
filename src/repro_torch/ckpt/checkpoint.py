"""Fault-tolerant checkpointing (counterpart of
``repro/ckpt/checkpoint.py``).

* atomic: write to ``step_XXXXXXXX.tmp`` then rename: a crash mid-write
  never corrupts the latest checkpoint;
* keep-k rotation;
* async: the device-to-host copy happens on the caller's thread, the
  file write on a background writer thread;
* exact: every leaf is stored with its dtype (bf16 as its ``uint16``
  bits, the dtype named in ``meta.json``), and ``restore`` lays the
  arrays onto the devices and dtypes of ``state_like``;
* elastic: a sharded state (DTensor leaves) is gathered to whole host
  arrays on save, so a checkpoint holds no topology, and ``restore``
  with ``shardings`` (``trainer.state_shardings``) lays each leaf out
  for the current mesh, whatever mesh wrote it.

States are trees of tensors (dicts, lists and tuples).  Every rank of a
sharded state takes part in the gather; rank 0 writes, and a restore
waits at a barrier until it has.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import distribute, full_tensor, is_dtensor
from repro_torch.optim.adamw import tree_leaves, tree_map

# dtypes numpy cannot hold, stored as the raw bits of a 16-bit integer
_BITS = {torch.bfloat16}


def leaf_paths(tree):
    """Each leaf's path ("stack/0/3/mixer/wq": dict keys and sequence
    indices joined by "/"), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [""]
    return [f"{name}/{p}" if p else name for name, sub in items
            for p in leaf_paths(sub)]


def _to_host(t):
    """A host copy of a leaf (never a view of memory the caller goes on
    updating in place): ``(numpy array, dtype name)``; a DTensor whole."""
    t = full_tensor(torch.as_tensor(t).detach())
    name = str(t.dtype).removeprefix("torch.")
    t = t.to("cpu", copy=True)
    if t.dtype in _BITS:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread = None

    # ---------------------------------------------------------- save ------
    def save(self, step: int, state) -> None:
        keys = leaf_paths(state)
        if _sharded(state) and dist.get_rank() != 0:
            for x in tree_leaves(state):  # every rank takes part in the
                full_tensor(x)            # gathers; rank 0 writes
            return
        host = [_to_host(x) for x in tree_leaves(state)]  # caller's thread
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, keys, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, keys, host)

    def _write(self, step, keys, host):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{f"a{i}": a for i, (a, _) in enumerate(host)})
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "keys": keys,
             "dtypes": [name for _, name in host]}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------- restore ----
    def all_steps(self):
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "meta.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None, shardings=None):
        """Restore into the structure of ``state_like``: each leaf on that
        leaf's device, in its dtype, with its ``requires_grad``, and with
        ``shardings`` (a tree of
        :class:`~repro_torch.dist.sharding.NamedSharding` matching it) a
        DTensor laid out on its mesh.  Returns ``(state, step)``; the
        latest step when ``step`` is None."""
        self.wait()
        if (shardings is not None or _sharded(state_like)) and \
                dist.is_initialized():
            dist.barrier()  # rank 0's write of a sharded save is done
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        dt_by_key = dict(zip(meta["keys"], meta["dtypes"]))
        keys, leaves = leaf_paths(state_like), tree_leaves(state_like)
        sh_leaves = (_sharding_leaves(shardings) if shardings is not None
                     else [None] * len(leaves))
        if len(sh_leaves) != len(leaves):
            raise ValueError(f"{len(sh_leaves)} shardings for a state of "
                             f"{len(leaves)} leaves")
        out = []
        index = {k: f"a{i}" for i, k in enumerate(meta["keys"])}
        z = np.load(d / "arrays.npz")  # read leaf by leaf below
        for k, ref, sh in zip(keys, leaves, sh_leaves):
            a = z[index[k]]
            dtype = getattr(torch, dt_by_key[k])
            if dtype in _BITS:
                t = torch.from_numpy(a.view(np.int16)).view(dtype)
            else:
                t = torch.from_numpy(a)
            ref = torch.as_tensor(ref)
            t = t.to(device=ref.device, dtype=ref.dtype)
            if sh is not None:
                t = distribute(t, sh.mesh, sh.placements)
            out.append(t.requires_grad_(ref.requires_grad))
            del a, t
        z.close()
        it = iter(out)
        return tree_map(lambda _: next(it), state_like), step


def _sharded(state) -> bool:
    return any(is_dtensor(x) for x in tree_leaves(state))


def _sharding_leaves(shardings) -> list:
    """The shardings in ``tree_leaves`` order (each one a leaf)."""
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings)
                for x in _sharding_leaves(shardings[k])]
    if isinstance(shardings, (list, tuple)):
        return [x for v in shardings for x in _sharding_leaves(v)]
    return [shardings]
