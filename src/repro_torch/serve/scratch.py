"""Pooled host staging buffers for the batcher's gather and landing
(counterpart of ``repro/serve/scratch.py``).

Every flush would otherwise allocate twice: once to assemble the
mega-batch and once to land the device-to-host result.  A
:class:`ScratchPool` keeps a few flat byte buffers (``torch.uint8``) and
hands out typed views.  With ``pin=True`` a buffer is page-locked host
memory (``pin_memory=True``), so the card's copy engines read and write
it directly; on the CPU the buffers are plain.

A buffer is reused only when **no view of it is alive**, the reference's
rule.  The reference reads the numpy base's refcount; here every torch
view, and every numpy array made from one with ``.numpy()``, holds the
buffer's storage, so the pool reads the storage's use count.  Rows handed
to callers therefore stay valid for as long as the caller holds them,
however they slice them further.

The pool is intentionally simple: first fit over capacity, buffers only
grow, at most ``max_buffers`` retained.  In steady state every flush is a
hit; a caller that parks its rows forever costs one buffer, never
corruption.
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch

from repro_torch.obs import metrics as _m

_POOL_REQS = _m.counter("repro_scratch_pool_requests_total",
                        "scratch-buffer takes by outcome", ("outcome",))


def _uses(buf: torch.Tensor) -> int:
    """Tensors (and numpy arrays) sharing ``buf``'s storage, counted the
    same way on every call."""
    return torch._C._storage_Use_Count(buf.untyped_storage()._cdata)


class ScratchPool:
    """Reusable host buffers, guarded against live views by the
    storage's use count."""

    def __init__(self, max_buffers: int = 16, min_bytes: int = 4096):
        self.max_buffers = max_buffers
        self.min_bytes = min_bytes
        self._lock = threading.Lock()
        self._bufs: list = []  # (tensor, pinned, use count while idle)
        self.hits = 0
        self.misses = 0

    def take(self, shape: Tuple[int, ...], dtype: torch.dtype, *,
             pin: bool = False) -> torch.Tensor:
        """A writable CPU tensor of ``shape``/``dtype`` on pooled memory
        (page-locked when ``pin``).

        The view holds its buffer's storage until dropped, so callers
        just let it go out of scope: there is no ``release``.  Contents
        are uninitialized; callers overwrite every row they hand out (the
        batcher zero-fills only the padding tail).
        """
        n = 1
        for d in shape:
            n *= int(d)
        if n == 0:
            return torch.empty(shape, dtype=dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = n * itemsize
        with self._lock:
            for buf, pinned, idle in self._bufs:
                if pinned == pin and buf.numel() >= nbytes \
                        and _uses(buf) <= idle:
                    self.hits += 1
                    _POOL_REQS.inc(1, outcome="hit")
                    return buf[:nbytes].view(dtype).view(shape)
            self.misses += 1
            _POOL_REQS.inc(1, outcome="miss")
            buf = torch.empty((max(nbytes, self.min_bytes),),
                              dtype=torch.uint8, pin_memory=pin)
            self._bufs.append((buf, pin, _uses(buf)))
            if len(self._bufs) > self.max_buffers:
                # dropping a busy buffer is safe: outstanding views keep
                # its storage alive, it just stops being pool-managed
                self._bufs.pop(0)
            return buf[:nbytes].view(dtype).view(shape)

    def stats(self) -> dict:
        with self._lock:
            return {"buffers": len(self._bufs),
                    "bytes": sum(b.numel() for b, _, _ in self._bufs),
                    "pinned_bytes": sum(b.numel() for b, p, _ in self._bufs
                                        if p),
                    "hits": self.hits, "misses": self.misses}
