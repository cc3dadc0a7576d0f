"""Device resolution for every entry point of the port.

``device=None`` means the CUDA card.  Without a card an entry point
raises instead of quietly running on the CPU; callers that want the CPU
(the tests) pass ``device="cpu"`` explicitly.

Whenever a CUDA device is resolved, TF32 is switched off for both
matrix products (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN
convolutions (``torch.backends.cudnn.allow_tf32``).  PyTorch leaves
cuDNN's TF32 on by default, which keeps about three decimal digits and
would break the f32 parity the JAX reference computes.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` resolves to ``cuda`` and raises ``RuntimeError`` when no card
    is present; an explicit device is taken as given.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:  # "cuda" and "cuda:0" must key caches alike
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
