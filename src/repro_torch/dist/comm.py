"""The collective mode: every collective a DTensor op issues, run and
counted in one place.

DTensor lowers a redistribution to PyTorch's functional collectives
(``torch.ops._c10d_functional``; a shard-to-shard move on the card to
``torch.ops._dtensor.shard_dim_alltoall``).  :class:`CollectiveMode`, a
``TorchDispatchMode``, sees each one after DTensor has desugared it, on
the ranks' local tensors, and

  * records it (kind, dtype, elements in and out) into every
    :class:`~repro_torch.dist.hlo_analysis.CollectiveStats` open around
    it (:func:`~repro_torch.dist.hlo_analysis.collective_stats`);
  * runs it.  Where a gloo group carries CUDA tensors, it stages the
    operands through pinned host buffers and calls the group's
    synchronous collective on them: ranks that share one card cannot
    form an NCCL communicator, and gloo's functional collectives on CUDA
    tensors of a sub-group crash the process (torch 2.11 on an H100),
    while its plain collectives on host tensors do not.  Everything
    else (NCCL, host tensors, the fake backend of the dry run) runs as
    DTensor issued it.

Only the communication crosses host memory: the compute stays on the
ranks' devices.  The mode sees every op, not only collectives, so it is
installed only where it has work: by
:func:`~repro_torch.dist.sharding.use_mesh` on a mesh whose collectives
need staging (:func:`mesh_needs_staging`), so model and serving code
under such a mesh needs nothing more, and by
:func:`~repro_torch.dist.hlo_analysis.collective_stats`.  Nested, the
inner use joins the active mode (:func:`collectives`): one mode runs
each collective once and counts it into every open sink.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.distributed.tensor  # noqa: F401  (registers torch.ops._dtensor)
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

_F = torch.ops._c10d_functional

#: functional collective -> the reference's HLO kind name
KINDS = {
    _F.all_reduce: "all-reduce",
    _F.all_reduce_: "all-reduce",
    _F.all_reduce_coalesced: "all-reduce",
    _F.all_gather_into_tensor: "all-gather",
    _F.all_gather_into_tensor_out: "all-gather",
    _F.all_gather_into_tensor_coalesced: "all-gather",
    _F.reduce_scatter_tensor: "reduce-scatter",
    _F.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _F.all_to_all_single: "all-to-all",
    _F.broadcast: "broadcast",
    _F.broadcast_: "broadcast",
    torch.ops._dtensor.shard_dim_alltoall: "all-to-all",
}

_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _group(name):
    if isinstance(name, dist.ProcessGroup):
        return name
    return dist.distributed_c10d._resolve_process_group(name)


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def _staged(packet, args):
    """Run one functional collective of CUDA tensors through pinned host
    buffers and the group's synchronous collective; the result on the
    input's device, as the functional op would return it.  The kinds
    DTensor's redistributions issue are staged; another raises rather
    than reach gloo's functional path."""
    if packet in (_F.all_reduce, _F.all_reduce_):
        x, op, name = args
        g = _group(name)
        h = _host(x)
        dist.all_reduce(h, op=_OPS[op], group=g)
        if op == "avg":
            h.div_(dist.get_world_size(g))
        if packet is _F.all_reduce_:
            return x.copy_(h)
        return h.to(x.device, non_blocking=True)
    if packet is _F.all_gather_into_tensor:
        x, n, name = args
        h = _host(x.contiguous())
        out = torch.empty((n * h.shape[0],) + tuple(h.shape[1:]),
                          dtype=h.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, h, group=_group(name))
        return out.to(x.device, non_blocking=True)
    if packet is _F.reduce_scatter_tensor:
        x, op, n, name = args
        h = _host(x.contiguous())
        out = torch.empty((h.shape[0] // n,) + tuple(h.shape[1:]),
                          dtype=h.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(out, h, op=_OPS[op], group=_group(name))
        if op == "avg":
            out.div_(n)
        return out.to(x.device, non_blocking=True)
    if packet is _F.all_to_all_single:
        x, out_splits, in_splits, name = args
        h = _host(x.contiguous())
        out = torch.empty((sum(out_splits),) + tuple(h.shape[1:]),
                          dtype=h.dtype, pin_memory=True)
        dist.all_to_all_single(out, h, list(out_splits), list(in_splits),
                               group=_group(name))
        return out.to(x.device, non_blocking=True)
    if packet is torch.ops._dtensor.shard_dim_alltoall:
        # send chunk j of the shard dim to rank j, gather what arrives
        # along the gather dim, in rank order
        x, gather_dim, shard_dim, name = args
        g = _group(name)
        n = dist.get_world_size(g)
        chunks = [c.contiguous() for c in torch.chunk(x, n, dim=shard_dim)]
        if len(chunks) != n or len({c.shape for c in chunks}) != 1:
            raise ValueError(f"shard_dim_alltoall: dim {shard_dim} of "
                             f"{tuple(x.shape)} does not split into {n}")
        h = _host(torch.stack(chunks))
        out = torch.empty_like(h, pin_memory=True)
        dist.all_to_all_single(out, h, group=g)
        got = out.to(x.device, non_blocking=True)
        return torch.cat(list(got.unbind(0)), dim=gather_dim)
    raise NotImplementedError(f"no staged form of {packet} for a gloo "
                              f"group's CUDA tensors")


def _elements(x) -> tuple:
    """(elements, dtype) of a tensor or a list of tensors."""
    if isinstance(x, (list, tuple)):
        return sum(t.numel() for t in x), x[0].dtype
    return x.numel(), x.dtype


def _needs_staging(x, name) -> bool:
    t = x[0] if isinstance(x, (list, tuple)) else x
    return t.is_cuda and dist.get_backend(_group(name)) == "gloo"


def mesh_needs_staging(mesh) -> bool:
    """Whether a ``DeviceMesh``'s collectives carry CUDA tensors over a
    gloo group (and so must run under the mode)."""
    from torch.distributed.device_mesh import DeviceMesh
    return (isinstance(mesh, DeviceMesh) and mesh.device_type == "cuda"
            and any(dist.get_backend(mesh.get_group(d)) == "gloo"
                    for d in range(mesh.ndim)))


class CollectiveMode(TorchDispatchMode):
    """Run and count the collectives DTensor issues (module docstring).
    ``sinks`` are the stats every collective is added to."""

    def __init__(self, sinks=()):
        super().__init__()
        self.sinks = list(sinks)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar into collectives
        packet = getattr(func, "_overloadpacket", None)
        kind = KINDS.get(packet)
        if kind is None:
            return func(*args, **kwargs)
        if _needs_staging(args[0], args[-1]):
            out = _staged(packet, args)
        else:
            out = func(*args, **kwargs)
        n_in, dtype = _elements(args[0])
        n_out, _ = _elements(out)
        for st in self.sinks:
            st.add(kind, n_in, n_out, dtype)
        return out


def _active() -> "CollectiveMode | None":
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CollectiveMode):
            return mode
    return None


@contextlib.contextmanager
def collectives(stats=None):
    """Run the body under a :class:`CollectiveMode` that counts into
    ``stats`` (when given): the active mode, with ``stats`` added to its
    sinks for the body, or a new one when none is active."""
    outer = _active()
    if outer is None:
        with CollectiveMode([stats] if stats is not None else []) as mode:
            yield mode
        return
    if stats is not None:
        outer.sinks.append(stats)
    try:
        yield outer
    finally:
        if stats is not None:
            outer.sinks.remove(stats)
