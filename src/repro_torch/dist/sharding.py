"""Logical-axis sharding over DTensor (counterpart of
``repro/dist/sharding.py``).

Model and runtime code names *logical* axes ("batch", "seq", "ffn",
...) and an active :class:`ShardCtx`, installed with :func:`use_mesh`,
resolves them against the live mesh, by the reference's rules:

  * no active mesh            -> :func:`constrain` is a no-op;
  * axis absent / size 1      -> that dimension replicates;
  * size not divisible        -> candidate axes are dropped outer-first
                                 until the remainder divides;
  * axis already claimed      -> later dimensions of the same spec fall
                                 through to their next candidate.

Logical -> physical mapping (mesh axes "pod", "data", "model"):

  batch/data -> (pod,) data      fsdp    -> data      (ZeRO-style weights)
  seq        -> model            kvseq   -> model     (decode KV cache)
  longseq    -> data+model       heads/ffn/vocab/dinner/experts -> model

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions; resolution reads only its name -> size map, so any object
whose ``shape`` is such a map (the tests' fake meshes) resolves too.  A
resolved spec is a tuple with one entry per tensor dimension, as the
reference's ``PartitionSpec`` entries read: None, a mesh axis name, or a
tuple of names sharding one dimension major to minor.
:func:`placements_for` turns it into DTensor placements (``Shard`` and
``Replicate``, one per mesh dimension): DTensor splits a dimension that
several mesh dimensions shard in mesh-dimension order, the outer axis
first, which is JAX's order for a tuple entry whose axes follow the
mesh's (every entry the table yields does).

Tensors under a mesh are DTensors: a parameter or a batch is laid out by
:func:`distribute` or :meth:`ShardCtx.make_global` (each rank slices its
own block of a full tensor every rank holds or, with ``global_shape``,
contributes its own block to the whole; no communication either way);
:func:`constrain` redistributes a DTensor to the resolved placements
(the reference's ``with_sharding_constraint``) and passes a plain
tensor through, as the reference passes an eager array.  :func:`use_mesh`
also switches on DTensor's implicit replication of plain tensors
(positions, masks, fresh buffers), and, where a gloo group carries CUDA
tensors, installs the collective mode of :mod:`repro_torch.dist.comm`,
which stages the collectives through host memory.  Elsewhere DTensor
issues its collectives directly, and the mode runs only under
:func:`~repro_torch.dist.hlo_analysis.collective_stats`, which counts
them.

``param_spec_tree`` / ``cache_spec_tree`` derive spec trees for LM
params (and their mirrored optimizer-state copies) and KV caches from
the *name* of each leaf, right-aligned to its rank; the port's trees are
dicts, lists and tuples of tensors (each layer a dict of its own, where
the reference stacks a slot's repeats on a leading axis).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# ------------------------------------------------------- logical mapping ---

# ordered outer -> inner; resolution drops candidates outer-first
_LOGICAL_TO_MESH = {
    "batch": ("pod", "data"),
    "data": ("pod", "data"),
    "fsdp": ("data",),
    "seq": ("model",),
    "kvseq": ("model",),
    "longseq": ("data", "model"),
    "heads": ("model",),
    "ffn": ("model",),
    "dinner": ("model",),
    "vocab": ("model",),
    "model": ("model",),
    "experts": ("model",),
}


def mesh_shape(mesh) -> dict:
    """A mesh's axis name -> size map: a ``DeviceMesh``'s named
    dimensions, or any object whose ``shape`` already is such a map."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The active mesh + axis roles. Immutable; cheap to construct."""

    mesh: Any = None
    multi_pod: bool = False

    def _shape(self) -> dict:
        return mesh_shape(self.mesh) if self.mesh is not None else {}

    def _candidates(self, logical: str) -> Tuple[str, ...]:
        axes = _LOGICAL_TO_MESH.get(logical, ())
        if not self.multi_pod:
            axes = tuple(a for a in axes if a != "pod")
        if self.mesh is None:
            return ()
        shape = self._shape()
        return tuple(a for a in axes if shape.get(a, 1) > 1)

    def axis_size(self, logical: str) -> int:
        """Total shard count a logical axis resolves to (1 if unmapped)."""
        shape, n = self._shape(), 1
        for a in self._candidates(logical):
            n *= shape[a]
        return n

    def mesh_axes_for(self, logical: str) -> Tuple[str, ...]:
        """Physical mesh axes (size > 1) a logical axis maps onto."""
        return self._candidates(logical)

    def local_axis_size(self, logical: str) -> int:
        """Shards of a logical axis within the mesh's ``local_mesh`` (the
        reference's per-host extent), or :meth:`axis_size` for a mesh
        without one, as the reference reads it."""
        local = getattr(self.mesh, "local_mesh", None)
        local_shape = mesh_shape(local) if local is not None else {}
        shape, n = self._shape(), 1
        for a in self._candidates(logical):
            n *= local_shape.get(a, shape[a])
        return n

    def spec_for(self, shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]]) -> tuple:
        """The spec of ``shape``, one logical name (or None) per dim."""
        if len(shape) != len(logical_axes):
            raise ValueError(f"spec_for: {len(shape)} dims, "
                             f"{len(logical_axes)} logical axes")
        sizes = self._shape()
        used: set = set()
        entries = []
        for dim, name in zip(shape, logical_axes):
            if name is None or self.mesh is None:
                entries.append(None)
                continue
            cand = [a for a in self._candidates(name) if a not in used]
            while cand:
                n = 1
                for a in cand:
                    n *= sizes[a]
                if n > 1 and dim % n == 0:
                    break
                cand = cand[1:]  # drop outermost first
            if not cand:
                entries.append(None)
                continue
            used.update(cand)
            entries.append(cand[0] if len(cand) == 1 else tuple(cand))
        return tuple(entries)

    def sharding_for(self, shape, logical_axes):
        """DTensor placements for ``shape`` on the mesh, or None."""
        if self.mesh is None:
            return None
        return placements_for(self.spec_for(shape, logical_axes), self.mesh)

    def make_global(self, x, logical_axes, *, global_shape=None):
        """A DTensor on the mesh, placed under the resolved placements
        of ``logical_axes``; no communication either way.  Without a
        mesh ``x`` comes back as it is.

        Without ``global_shape``, ``x`` is the whole tensor, which every
        rank holds, and each rank keeps its own block
        (:func:`distribute`).  With it, ``x`` is this process's block
        (in a pod, its slab of the leading dimension) and the DTensor is
        assembled from every process's block (``DTensor.from_local``
        with the shape and stride given, no check): the per-host feeding
        primitive of the ``pod`` axis.  One process holds the whole, so
        there a block that is not the global shape is refused."""
        x = torch.as_tensor(x)
        if self.mesh is None:
            return x
        shape = tuple(x.shape) if global_shape is None else \
            tuple(int(s) for s in global_shape)
        placements = self.sharding_for(shape, tuple(logical_axes))
        if global_shape is None or not (dist.is_initialized()
                                        and dist.get_world_size() > 1):
            if shape != tuple(x.shape):
                raise ValueError(
                    f"make_global: single-process local block "
                    f"{tuple(x.shape)} must equal the global shape {shape}")
            return distribute(x, self.mesh, placements)
        from torch.distributed.tensor import DTensor
        sizes = list(mesh_shape(self.mesh).values())
        block = list(shape)
        for i, pl in enumerate(placements):
            if pl.is_shard():
                block[pl.dim] //= sizes[i]
        if tuple(block) != tuple(x.shape):
            raise ValueError(
                f"make_global: local block {tuple(x.shape)} is not this "
                f"process's block {tuple(block)} of {shape} under "
                f"{placements}")
        local = x.to(mesh_device(self.mesh)).contiguous()
        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one tensor on it (the reference's
    ``jax.sharding.NamedSharding``)."""

    mesh: Any
    placements: tuple


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def placements_for(spec: Sequence, mesh) -> list:
    """DTensor placements (one per mesh dimension) of a resolved spec.

    A mesh axis named in a spec entry shards that entry's tensor
    dimension; every other mesh axis replicates.  An entry naming
    several axes must list them in the mesh's order (outer first), the
    order DTensor splits a dimension in."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh`` (a CUDA mesh's ranks each select
    theirs)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_block(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements``: each sharded
    dimension split evenly, mesh dimensions in order (outer first)."""
    coord = mesh.get_coordinate()
    sizes = list(mesh_shape(mesh).values())
    block = full
    for i, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        d, n = pl.dim, sizes[i]
        if block.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(block.shape)} does not "
                             f"split into {n} shards")
        step = block.shape[d] // n
        block = block.narrow(d, coord[i] * step, step)
    return block


def distribute(full: torch.Tensor, mesh, placements, *,
               requires_grad: Optional[bool] = None):
    """A DTensor laid out by ``placements`` from ``full``, which every
    rank holds: each rank keeps its own block (a copy, on its device of
    the mesh), no communication.  ``requires_grad`` (default:
    ``full``'s) makes the result a leaf that requires grad."""
    from torch.distributed.tensor import DTensor
    rg = full.requires_grad if requires_grad is None else requires_grad
    local = local_block(full.detach(), mesh, placements).to(
        mesh_device(mesh)).contiguous()
    out = DTensor.from_local(local, mesh, placements, run_check=False,
                             shape=full.shape,
                             stride=_contiguous_stride(full.shape))
    return out.requires_grad_(rg) if rg else out


def lay_out(t, mesh, placements):
    """``t`` under ``placements`` on ``mesh``: a plain tensor (which
    every rank holds whole) distributed, a DTensor redistributed where
    its placements differ."""
    if not is_dtensor(t):
        return distribute(t, mesh, placements)
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(mesh, placements)


def resolve(mesh, shape, *logical_axes) -> list:
    """Placements of ``shape`` on ``mesh`` by the active context's
    resolution of ``logical_axes`` (the mesh's own without one)."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        ctx = ShardCtx(mesh)
    return placements_for(ctx.spec_for(tuple(shape), logical_axes), mesh)


def place(t, mesh, *logical_axes):
    """``t`` laid out on ``mesh`` (:func:`lay_out`) by :func:`resolve`:
    :func:`constrain` for a plain tensor too."""
    return lay_out(t, mesh, resolve(mesh, t.shape, *logical_axes))


def block_offset(mesh, placements, dim: int, size: int) -> int:
    """Where this rank's block of dimension ``dim`` (of global extent
    ``size``) starts under ``placements``."""
    coord, sizes = mesh.get_coordinate(), list(mesh_shape(mesh).values())
    off, width = 0, size
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            width //= sizes[i]
            off += coord[i] * width
    return off


def rows_sharded(fn, x, *, mesh, data_axes):
    """``fn`` (a row-wise function of a plain tensor) on each rank's
    rows of ``x``: rows split over the mesh axes ``data_axes``, each
    rank calling ``fn`` on its own rows, the result a DTensor of the
    same row split (the reference's ``shard_map`` with the batch on
    ``data_axes`` and everything else replicated).  When the rows do not
    divide the shard count, every rank runs ``fn`` on all of them: a
    replicated result (a plain result for a plain ``x``), the reference's
    fall back to the unsharded op."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names, sizes = list(mesh_shape(mesh)), mesh_shape(mesh)
    n = 1
    for a in data_axes:
        n *= sizes[a]
    if n <= 1 or x.shape[0] % n:
        if not is_dtensor(x):
            return fn(x)
        whole = [Replicate()] * len(names)
        y = fn(x.redistribute(mesh, whole).to_local())
        return DTensor.from_local(y, mesh, whole, run_check=False)
    rows = [Shard(0) if a in data_axes else Replicate() for a in names]
    if not is_dtensor(x):
        x = distribute(x, mesh, rows)
    elif tuple(x.placements) != tuple(rows):
        x = x.redistribute(mesh, rows)
    y = fn(x.to_local())
    shape = (int(x.shape[0]),) + tuple(y.shape[1:])
    return DTensor.from_local(y, mesh, rows, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _gather_inner(t):
    """A DTensor of three or more dims gathered on every dim between its
    first and its last that is sharded; anything else as it is."""
    if not is_dtensor(t) or t.ndim <= 2:
        return t
    from torch.distributed.tensor import Replicate
    pl = list(t.placements)
    inner = [p.is_shard() and 0 < p.dim < t.ndim - 1 for p in pl]
    if not any(inner):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if i else p
                                          for p, i in zip(pl, inner)])


class _GatherInnerGrad(torch.autograd.Function):
    """Identity whose backward gathers the cotangent's inner dims."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _gather_inner(g)


def matmul(x, w):
    """``x @ w``.  The product flattens the leading dims of ``x`` (and,
    in the backward, of its cotangent), which DTensor cannot do across a
    shard boundary of an inner dim (torch 2.11): a DTensor ``x`` sharded
    between its first and its last dim (the sequence, in a
    sequence-parallel residual stream) is gathered on it first, and so
    is the cotangent of the product.  A plain ``x`` is multiplied as it
    is."""
    if not is_dtensor(x) or x.ndim <= 2:
        return x @ w
    return _GatherInnerGrad.apply(_gather_inner(x) @ w)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def full_tensor(x):
    """The whole of a DTensor on every rank (an all-gather where it is
    sharded, a reduction where it is partial); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    with _collectives(x.device_mesh):
        return x.full_tensor()


# ------------------------------------------------------------- context -----

_state = threading.local()


def _stack():
    if not hasattr(_state, "ctxs"):
        _state.ctxs = []
    return _state.ctxs


def current_ctx() -> Optional[ShardCtx]:
    """The innermost active ShardCtx, or None outside any use_mesh()."""
    s = _stack()
    return s[-1] if s else None


def _collectives(mesh):
    """The collective mode where ``mesh``'s collectives need staging (a
    gloo group's CUDA tensors), else nothing."""
    from repro_torch.dist.comm import collectives, mesh_needs_staging
    if mesh_needs_staging(mesh):
        return collectives()
    return contextlib.nullcontext()


@contextlib.contextmanager
def use_mesh(mesh, multi_pod: bool = False):
    """Install ``mesh`` as the active sharding context for this thread
    (with implicit replication, and the collective mode where its
    collectives need staging, while a mesh is set; ``use_mesh(None)``
    installs a context without a mesh)."""
    ctx = ShardCtx(mesh, multi_pod)
    with _install(ctx):
        yield ctx


@contextlib.contextmanager
def _install(ctx: Optional[ShardCtx]):
    s = _stack()
    s.append(ctx)
    try:
        if ctx is None or ctx.mesh is None:
            yield ctx
        else:
            with _collectives(ctx.mesh), _implicit_replication():
                yield ctx
    finally:
        s.pop()


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, restoring the flag it found
    (the library's resets it to False on exit, which would switch it
    off for an enclosing mesh when a nested one, a remat'd layer,
    ends)."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def reinstall(ctx: Optional[ShardCtx]):
    """Install a context captured earlier (``current_ctx()``), on this
    thread: a remat'd layer recomputed in the backward, or a batcher
    thread applying a submitter's request, runs under the submitter's
    mesh.  ``reinstall(None)`` installs nothing."""
    return _install(ctx) if ctx is not None else contextlib.nullcontext()


def constrain(x, *logical_axes):
    """Redistribute a DTensor to the placements the active mesh resolves
    ``logical_axes`` to; a no-op without a mesh or on a plain tensor."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not is_dtensor(x):
        return x
    placements = placements_for(ctx.spec_for(tuple(x.shape), logical_axes),
                                x.device_mesh)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


# ----------------------------------------------------- spec derivation -----

# trailing-dim logical axes per parameter leaf name (right-aligned, so
# optimizer mirrors just work)
_PARAM_RULES = {
    "tok_embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "pos_embed": (None, "fsdp"),
    # dense / GLU MLPs (also the serve-time FFN surrogate w1/w2)
    "w1": ("fsdp", "ffn"), "w3": ("fsdp", "ffn"), "w2": ("ffn", "fsdp"),
    "w_up": ("fsdp", "ffn"), "w_down": ("ffn", "fsdp"),
    "wk_cm": ("fsdp", "ffn"), "wv_cm": ("ffn", "fsdp"), "wr_cm": ("fsdp", None),
    # attention (gqa + cross + mla)
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "w_q": ("fsdp", "heads"), "w_dkv": ("fsdp", None), "w_kr": ("fsdp", None),
    "w_ukv": (None, "heads"),
    # rwkv6
    "wr_tm": ("fsdp", "heads"), "wk_tm": ("fsdp", "heads"),
    "wv_tm": ("fsdp", "heads"), "wg_tm": ("fsdp", "heads"),
    "lora_a_mix": ("fsdp", None), "lora_b_mix": (None, None, "heads"),
    "lora_a_w": ("fsdp", None), "lora_b_w": (None, "heads"),
    # mamba
    "w_in": ("fsdp", "dinner"), "conv_w": (None, "dinner"),
    "w_x": ("dinner", None), "w_dt": (None, "dinner"),
    "w_out": ("dinner", "fsdp"),
    # moe: experts take "model" (EP) when E divides it; otherwise the
    # ffn dim claims it
    "w_router": ("fsdp", None),
    "we1": ("experts", "fsdp", "ffn"), "we3": ("experts", "fsdp", "ffn"),
    "we2": ("experts", "ffn", "fsdp"),
    "ws1": ("fsdp", "ffn"), "ws3": ("fsdp", "ffn"), "ws2": ("ffn", "fsdp"),
}


def _cache_rules(long_ctx: bool):
    seq = "longseq" if long_ctx else "kvseq"
    return {
        "k": ("batch", seq, None, None),
        "v": ("batch", seq, None, None),
        "k_scale": ("batch", seq, None),
        "v_scale": ("batch", seq, None),
        "ckv": ("batch", seq, None),
        "kr": ("batch", seq, None),
        "S": ("batch", "heads", None, None),
        "x_last": ("batch", None),
        "conv": ("batch", None, "dinner"),
        "h": ("batch", "dinner", None),
        "cm_x_last": ("batch", None, None),
        "cross_k": ("batch", None, None, None),
        "cross_v": ("batch", None, None, None),
    }


def _spec_from_rules(ctx: ShardCtx, rules: dict, name, leaf) -> tuple:
    shape = tuple(leaf.shape)
    if not shape:
        return ()
    rule = rules.get(name)
    if rule is None:
        # unknown leaves (norm scales, biases, mixing coefficients, ...)
        # replicate: sharding decisions stay explicit, replication is
        # always correct
        return (None,) * len(shape)
    n = len(shape)
    axes = rule[-n:] if len(rule) >= n else \
        (None,) * (n - len(rule)) + tuple(rule)
    return ctx.spec_for(shape, axes)


def _map_named(tree, fn, name=None):
    """``fn(name, leaf)`` over a tree of dicts, lists and tuples, ``name``
    the innermost dict key above the leaf (the reference's
    ``_leaf_name``)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn, name) for v in tree)
    return fn(name, tree)


def param_spec_tree(tree, cfg, mesh=None, multi_pod: bool = False):
    """Spec tree for LM params or a full train state.

    ``tree`` is any tree of tensors (or shaped stand-ins) whose leaf
    *names* follow models/lm.py + optim/adamw.py (the optimizer's m/v/
    master mirror the param names, so one rule table covers both).
    ``cfg`` is accepted for call-site symmetry with cache_spec_tree;
    rules are name-driven."""
    del cfg
    ctx = ShardCtx(mesh, multi_pod)
    return _map_named(
        tree, lambda name, leaf: _spec_from_rules(ctx, _PARAM_RULES, name,
                                                  leaf))


def param_shardings(tree, cfg, mesh, multi_pod: bool = False):
    """:class:`NamedSharding` per leaf of ``tree`` on ``mesh``, by
    :func:`param_spec_tree`'s rules."""
    del cfg
    ctx = ShardCtx(mesh, multi_pod)
    return _map_named(tree, lambda name, leaf: NamedSharding(
        mesh, tuple(placements_for(
            _spec_from_rules(ctx, _PARAM_RULES, name, leaf), mesh))))


def cache_spec_tree(tree, cfg, mesh=None, multi_pod: bool = False, *,
                    long_ctx: bool = False):
    """Spec tree for decode caches (models/lm.py layout).

    ``long_ctx=True`` switches the KV sequence dim from "kvseq" (model
    axis) to "longseq" (data+model)."""
    del cfg
    ctx = ShardCtx(mesh, multi_pod)
    rules = _cache_rules(long_ctx)
    return _map_named(
        tree, lambda name, leaf: _spec_from_rules(ctx, rules, name, leaf))
