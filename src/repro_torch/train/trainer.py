"""The LM's train step (counterpart of ``repro/train/trainer.py``):
forward, backward, clip and AdamW, with optional microbatch gradient
accumulation and int8 gradient compression.

The port's state is ``{"params", "opt"}`` of tensors, updated in place
by :func:`train_step` (and returned, as the reference returns its new
state).  Parameters require grad; on the card the GQA mixer's attention
is differentiated through the ``flash_attention`` backward kernel.

On a mesh (``make_train_state(..., mesh=)``, or a state restored with
:func:`restore_train_state`) every leaf is a DTensor laid out by
:func:`state_shardings`: the reference's name-driven rules, the
optimizer's mirrors by the names they share with the parameters.  The
step then runs under :func:`~repro_torch.dist.sharding.use_mesh`: each
gradient is laid out as its parameter, the global norm comes from an
all-reduce of the shards' sums, and AdamW updates each rank's local
shards in place, leaf by leaf.  Checkpoints go through
:class:`~repro_torch.ckpt.checkpoint.CheckpointManager`, which gathers a
sharded state to whole host arrays, and restore lays it out again for
whatever mesh is current.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import (current_ctx, distribute,
                                       is_dtensor, param_shardings,
                                       use_mesh)
from repro_torch.models import lm
from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     init_opt_state, tree_leaves, tree_map,
                                     warmup_cosine)


def make_train_state(seed, cfg, device=None, mesh=None,
                     multi_pod: bool = False):
    """Seeded parameters (requiring grad) and a fresh optimizer state of
    ``cfg.opt_policy``, on ``device`` (None: the card); with ``mesh``,
    laid out on it by :func:`state_shardings` (every rank draws the same
    seeded parameters and keeps its own blocks; the optimizer's state is
    made from those blocks)."""
    params = lm.init_params(seed, cfg, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    if mesh is not None:  # the optimizer's state made from the shards
        params = shard_state(params, param_shardings(params, cfg, mesh,
                                                     multi_pod))
    return {"params": params, "opt": init_opt_state(params, cfg.opt_policy)}


def state_shardings(cfg, state_like, mesh=None, multi_pod: bool = False):
    """A :class:`~repro_torch.dist.sharding.NamedSharding` per leaf of a
    train state on ``mesh`` (default: the active one), or None without a
    mesh (an unsharded restore).  Name-driven: the optimizer's m/v/master
    mirrors reuse the param rules, the step counter and norm scales
    replicate."""
    if mesh is None:
        ctx = current_ctx()
        if ctx is None or ctx.mesh is None:
            return None
        mesh, multi_pod = ctx.mesh, ctx.multi_pod
    return param_shardings(state_like, cfg, mesh, multi_pod)


def shard_state(state, shardings):
    """Each leaf of ``state`` (whole on every rank) laid out by its
    sharding, keeping ``requires_grad``."""
    return tree_map(lambda t, sh: distribute(t, sh.mesh, sh.placements,
                                             requires_grad=t.requires_grad),
                    state, shardings)


def save_train_state(mgr, step: int, state) -> None:
    """Checkpoint a train state (a sharded one gathered to whole host
    arrays on this thread, written on the manager's writer thread)."""
    mgr.save(step, state)


def restore_train_state(mgr, cfg, state_like, step: Optional[int] = None,
                        mesh=None, multi_pod: bool = False):
    """Restore a train state, laid out for ``mesh`` (default: the active
    one; none: onto ``state_like``'s devices).  ``state_like`` gives the
    tree, dtypes, devices and ``requires_grad``.  Returns ``(state,
    step)``."""
    shardings = state_shardings(cfg, state_like, mesh, multi_pod)
    return mgr.restore(state_like, step, shardings=shardings)


def to_device(batch, device):
    """A batch of numpy arrays (``TokenPipeline.batch_at``) as tensors on
    ``device``: tokens and targets as int64 indices."""
    out = {}
    for k, a in batch.items():
        t = torch.as_tensor(np.asarray(a))
        out[k] = t.to(device=device, dtype=torch.int64
                      if k in ("tokens", "targets") else None)
    return out


def _grads(cfg, params, batch):
    leaves = tree_leaves(params)
    loss = lm.train_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda p: _laid_out(next(it), p), params)


def _laid_out(g, p):
    """A DTensor gradient in its parameter's placements (autograd may
    leave it partial or laid out otherwise)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _slice_mb(batch, i, mb):
    """Microbatch ``i`` of ``mb`` rows; ``position_ids`` ``[3, B, S]`` is
    cut on its batch axis."""
    def cut(x):
        axis = 1 if x.ndim == 3 and x.shape[0] == 3 else 0
        return x.narrow(axis, i * mb, mb)
    return {k: cut(v) for k, v in batch.items()}


def compute_grads(cfg, params, batch, *, microbatches: int = 1):
    """Loss and grads (a tree shaped as ``params``), optionally averaged
    over microbatches in f32 (the grads are then f32)."""
    if microbatches <= 1:
        return _grads(cfg, params, batch)
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    mb = B // microbatches
    g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                                requires_grad=False), params)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    for i in range(microbatches):
        loss, g = _grads(cfg, params, _slice_mb(batch, i, mb))
        for a, b in zip(tree_leaves(g_acc), tree_leaves(g)):
            a.add_(b.to(torch.float32))
        loss_acc = loss_acc + loss
        del g
    for a in tree_leaves(g_acc):
        a.div_(microbatches)
    return loss_acc / microbatches, g_acc


def train_step(cfg, state, batch, *, step=None, microbatches: int = 1,
               peak_lr=3e-4, total_steps=10000, grad_compress=None):
    """One full optimizer step, in place.  Returns ``(state, metrics)``,
    metrics ``loss``, ``grad_norm`` and ``lr`` as 0-d f32 tensors (whole
    on every rank of a sharded state, whose step runs under its mesh)."""
    params, opt = state["params"], state["opt"]
    lead = tree_leaves(params)[0]
    if is_dtensor(lead) and (current_ctx() is None
                             or current_ctx().mesh is None):
        with use_mesh(lead.device_mesh):
            return train_step(cfg, state, batch, step=step,
                              microbatches=microbatches, peak_lr=peak_lr,
                              total_steps=total_steps,
                              grad_compress=grad_compress)
    loss, grads = compute_grads(cfg, params, batch,
                                microbatches=microbatches)
    if grad_compress is not None:
        grads = grad_compress(grads)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    lr = warmup_cosine(opt["step"] if step is None else step,
                       peak_lr=peak_lr, total=total_steps)
    lr = _whole(lr).to(loss.device)
    adamw_update(params, grads, opt, lr, policy=cfg.opt_policy)
    return state, {"loss": _whole(loss), "grad_norm": _whole(gnorm),
                   "lr": lr}


def _whole(t):
    """A 0-d DTensor's value as a plain tensor on every rank."""
    return t.full_tensor() if is_dtensor(t) else t
