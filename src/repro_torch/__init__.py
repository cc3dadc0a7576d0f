"""PyTorch/CUDA port of the ``repro`` HPAC-ML runtime.

The package mirrors ``repro``'s module layout (``core``, ``nn``,
``kernels``, ``apps``, ...) so the counterpart of each JAX module sits at
the same subpath.  It imports ``torch`` and numpy and never JAX or
``repro``.  Entry points run on the CUDA card unless given
``device="cpu"``; see :mod:`repro_torch.device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
