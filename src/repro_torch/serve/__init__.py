"""Async batched surrogate serving of the port (counterpart of
``repro/serve``): the queue, the coalescing batcher, stats, pooled host
buffers, weight residency and tenancy.

Still to be ported: the cross-host pod paths (``pod_flush``,
``dispatch_pod``; ROADMAP queue 1 item 9).  The adaptive flush
controller is :mod:`repro_torch.tune.controller`.
"""
from repro_torch.serve.batcher import Batcher, bucket_for, bucket_size
from repro_torch.serve.queue import (Backpressure, FlushPolicy, ServeFuture,
                                     ServeQueue)
from repro_torch.serve.residency import RESIDENCY, ResidencyManager
from repro_torch.serve.scratch import ScratchPool
from repro_torch.serve.stats import ServeStats
from repro_torch.serve.tenancy import (DeficitRoundRobin, TenantBoard,
                                       TenantSpec, TenantThrottled,
                                       TokenBucket)

__all__ = ["Backpressure", "Batcher", "DeficitRoundRobin", "FlushPolicy",
           "RESIDENCY", "ResidencyManager", "ScratchPool", "ServeFuture",
           "ServeQueue", "ServeStats", "TenantBoard", "TenantSpec",
           "TenantThrottled", "TokenBucket", "bucket_for", "bucket_size"]
