"""The LM's train step (counterpart of ``repro/train/trainer.py``):
forward, backward, clip and AdamW, with optional microbatch gradient
accumulation and int8 gradient compression.

The port's state is ``{"params", "opt"}`` of tensors on one device,
updated in place by :func:`train_step` (and returned, as the reference
returns its new state).  Parameters require grad; on the card the GQA
mixer's attention is differentiated through the ``flash_attention``
backward kernel.  Checkpoints go through
:class:`~repro_torch.ckpt.checkpoint.CheckpointManager`; restoring onto
a mesh (the reference's elastic path, ``state_shardings``) waits for
ROADMAP queue 1 item 9.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     init_opt_state, tree_leaves, tree_map,
                                     warmup_cosine)

_MESH = ("restoring onto a device mesh is not in the port yet (ROADMAP "
         "queue 1 item 9)")


def make_train_state(seed, cfg, device=None):
    """Seeded parameters (requiring grad) and a fresh optimizer state of
    ``cfg.opt_policy``, on ``device`` (None: the card)."""
    params = lm.init_params(seed, cfg, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, cfg.opt_policy)}


def state_shardings(cfg, state_like, mesh=None, multi_pod: bool = False):
    """None: the port runs unsharded on one device.  A mesh raises."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    return None


def save_train_state(mgr, step: int, state) -> None:
    """Checkpoint a train state (each leaf copied to the host on this
    thread, written on the manager's writer thread)."""
    mgr.save(step, state)


def restore_train_state(mgr, cfg, state_like, step: Optional[int] = None,
                        mesh=None, multi_pod: bool = False):
    """Restore a train state onto ``state_like``'s devices and dtypes.
    Returns ``(state, step)``."""
    state_shardings(cfg, state_like, mesh, multi_pod)
    return mgr.restore(state_like, step)


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
    return loss.detach(), tree_map(lambda p: next(it), params)


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
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
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
    metrics ``loss``, ``grad_norm`` and ``lr`` as 0-d f32 tensors."""
    params, opt = state["params"], state["opt"]
    loss, grads = compute_grads(cfg, params, batch,
                                microbatches=microbatches)
    if grad_compress is not None:
        grads = grad_compress(grads)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    lr = warmup_cosine(opt["step"] if step is None else step,
                       peak_lr=peak_lr, total=total_steps)
    lr = lr.to(loss.device)
    adamw_update(params, grads, opt, lr, policy=cfg.opt_policy)
    return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}
