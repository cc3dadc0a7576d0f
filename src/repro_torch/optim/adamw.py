"""AdamW with mixed-precision state policies (counterpart of
``repro/optim/adamw.py``).

``policy="full"``: an f32 master copy and f32 (m, v), 12 bytes a
parameter of state.  ``policy="lean"``: no master, bf16 (m, v), 4 bytes
a parameter; the update is computed in f32 and applied to the bf16
parameters directly.

The port updates in place, leaf by leaf, so that its f32 temporaries
stay the size of one leaf (llama3.2-3b's ``tok_embed`` is 394 M elements:
a whole-tree update would hold several f32 copies of 3.2 B parameters).
Each leaf's arithmetic keeps the reference's order of operations (``upd``,
adamw.py:36-44), and the bias corrections and the schedule are f32
tensors, not Python floats, so f32 results match XLA's to the rounding.
Parameters, states and gradients are trees of tensors: dicts, lists and
tuples.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``),
    keeping dicts, lists and tuples; leaves visited in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in a fixed order: dicts by sorted key (as
    ``jax.tree.leaves`` orders them), lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_opt_state(params, policy: str = "full"):
    """Zero moments (f32 for ``full``, with an f32 master copy; bf16 for
    ``lean``) and the step counter, a 0-d int32 tensor."""
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(dtype):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                              device=p.device), params)
    if policy == "full":
        return {"step": step, "m": zeros(F32), "v": zeros(F32),
                "master": tree_map(lambda p: p.detach().to(F32).clone(),
                                   params)}
    return {"step": step, "m": zeros(torch.bfloat16),
            "v": zeros(torch.bfloat16)}


def _upd(p, g, m, v, master, lr, c1, c2, b1, b2, eps, weight_decay):
    """One leaf of the reference's ``upd``, in place: the moments, the
    master (or, without one, the parameter itself) and the parameter."""
    gf = g.to(F32)  # g itself when g is f32: never written
    m_new = m.to(F32).mul_(b1).add_(gf * (1 - b1))
    v_new = v.to(F32).mul_(b2).add_((gf * (1 - b2)).mul_(gf))
    del gf
    base = master if master is not None else p.detach().to(F32)
    step = (m_new / c1).div_((v_new / c2).sqrt_().add_(eps))
    step.add_(base * weight_decay).mul_(lr)
    new = base - step
    del step
    m.copy_(m_new)
    v.copy_(v_new)
    if master is not None:
        master.copy_(new)
    p.copy_(new)


@torch.no_grad()
def adamw_update(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, policy: str = "full"):
    """One AdamW step at learning rate ``lr`` (an f32 tensor or a
    number): updates ``params`` and ``state`` in place, leaf by leaf, and
    returns them, as the reference returns its new trees."""
    step = state["step"] + 1
    stepf = step.to(F32)
    c1 = 1.0 - torch.tensor(b1, dtype=F32, device=stepf.device) ** stepf
    c2 = 1.0 - torch.tensor(b2, dtype=F32, device=stepf.device) ** stepf
    lr = torch.as_tensor(lr, dtype=F32, device=stepf.device)
    masters = (tree_leaves(state["master"]) if policy == "full"
               else [None] * len(tree_leaves(params)))
    for p, g, m, v, w in zip(tree_leaves(params), tree_leaves(grads),
                             tree_leaves(state["m"]), tree_leaves(state["v"]),
                             masters):
        _upd(p, g, m, v, w, lr, c1, c2, b1, b2, eps, weight_decay)
    state["step"] = step
    return params, state


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = 1.0):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``, in
    place, leaf by leaf (each scaled in f32 and cast back); returns
    ``(grads, norm)``, the norm of the unscaled gradients as an f32
    tensor."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=F32, device=leaves[0].device)
    for g in leaves:
        sq = sq + g.to(F32).square().sum()
    norm = torch.sqrt(sq)
    # true divisions by tensors: a Python number over a tensor is a
    # reciprocal times it, and on the card a tensor over a Python number
    # is a multiply by its reciprocal
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves:
        if g.dtype == F32:
            g.mul_(scale)
        else:
            g.copy_(g.to(F32) * scale)
    return grads, norm


def warmup_cosine(step, *, peak_lr=3e-4, warmup=100, total=10000,
                  floor=0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; an f32 0-d tensor."""
    stepf = torch.as_tensor(step).to(F32)
    warm = peak_lr * stepf / stepf.new_tensor(max(1, warmup))
    frac = torch.clamp((stepf - warmup) / stepf.new_tensor(
        max(1, total - warmup)), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(stepf < warmup, warm, cos)
