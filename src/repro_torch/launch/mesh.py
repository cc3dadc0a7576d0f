"""Mesh builders (counterpart of ``repro/launch/mesh.py``).

Functions, never module-level meshes: importing this module touches no
process group and no device.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, which the caller starts
(``torch.distributed.init_process_group`` with its address, world size
and rank): one rank a device.  Meshes are built on the card (``cuda``)
unless the caller asks for another device type; the CPU tests pass
``device="cpu"`` over a gloo group, the dry run over its fake group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _mesh(device, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("start a process group first "
                           "(torch.distributed.init_process_group)")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                           f"group has {world}")
    return init_device_mesh(device or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_local_mesh(shape=None, axes=("data", "model"), device=None):
    """A mesh over the group's ranks: ``shape`` (default ``(world, 1)``)
    over ``axes``, on ``device`` (None: ``cuda``)."""
    if shape is None:
        shape = (dist.get_world_size() if dist.is_initialized() else 1, 1)
    return _mesh(device, shape, axes)


def make_pod_mesh(axes=("pod", "data"), device=None):
    """``pod`` x ``data`` over the group's ranks: one pod row per
    process, in process order (the reference's process-major contract),
    each process one rank on one device, so ``(processes, 1)``; 1 x 1
    for one process.  The pod processes are the ranks of the default
    group (:func:`repro_torch.launch.multihost.bootstrap`).

    The mesh comes back with one empty DTensor built on it, which issues
    no collective: the first DTensor a process builds imports
    ``torch._dynamo`` (a second or more on a cold host), a cost of
    set-up that must not land under the pod watchdog of the first
    ``pod_flush``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import mesh_device
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = _mesh(device, (world, 1), axes)
    DTensor.from_local(torch.empty(0, device=mesh_device(mesh)), mesh,
                       [Replicate()] * mesh.ndim, run_check=False,
                       shape=torch.Size([0]), stride=(1,))
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh, 16 x 16 (``data``, ``model``) or
    2 x 16 x 16 (``pod``, ``data``, ``model``), over a group of exactly
    that many ranks: the dry run's fake group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)
