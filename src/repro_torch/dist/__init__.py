"""Distributed-execution substrate of the port (counterpart of
``repro/dist``).

``sharding``
    Logical-axis sharding contexts over DTensor.  Model and runtime code
    names *logical* axes ("batch", "seq", "ffn", ...); an active
    :class:`ShardCtx` (installed by :func:`use_mesh`) resolves them to
    the mesh axes ("pod", "data", "model") with per-dimension
    divisibility fallback, so the same code runs on one device, a local
    mesh of ranks, or the dry run's 256-rank fake group.

``hlo_analysis``
    Collective accounting (:func:`collective_stats`: counts and wire
    bytes per kind of the collectives a sharded program issues) and the
    three-term (compute / HBM / interconnect) :class:`Roofline` at the
    H100's peaks.

``comm``
    The dispatch mode that runs and counts DTensor's collectives,
    staging them through host memory where a gloo group carries CUDA
    tensors.
"""
from repro_torch.dist.hlo_analysis import (HBM_BW, ICI_BW, PEAK_FLOPS,
                                           CollectiveStats, Roofline,
                                           collective_stats)
from repro_torch.dist.sharding import (ShardCtx, cache_spec_tree, constrain,
                                       current_ctx, param_spec_tree,
                                       use_mesh)

__all__ = [
    "CollectiveStats", "Roofline", "collective_stats",
    "ShardCtx", "cache_spec_tree", "constrain", "current_ctx",
    "param_spec_tree", "use_mesh",
    "HBM_BW", "ICI_BW", "PEAK_FLOPS",
]
