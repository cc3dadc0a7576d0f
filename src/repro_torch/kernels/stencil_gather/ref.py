"""Plain PyTorch version of the stencil gather (counterpart of
``repro/kernels/stencil_gather/ref.py``), and the bounds check every
path shares."""
from __future__ import annotations

import torch


def check_bounds(shape, offsets, out_h: int, out_w: int,
                 origin=(0, 0)) -> None:
    """Raise ``ValueError`` unless every feature's read lies inside the
    ``[H, W]`` source: ``0 <= origin0 + dy`` and ``origin0 + dy + out_h
    <= H`` for each ``(dy, dx)``, and the same for columns.  The
    reference slices, so it requires the same; nothing reads past the
    end or pads."""
    h, w = int(shape[0]), int(shape[1])
    if not offsets:
        raise ValueError("stencil_gather needs at least one offset")
    if out_h < 0 or out_w < 0:
        raise ValueError(f"negative output extent {out_h}x{out_w}")
    for dy, dx in offsets:
        i0, j0 = origin[0] + dy, origin[1] + dx
        if not (0 <= i0 and i0 + out_h <= h and 0 <= j0 and j0 + out_w <= w):
            raise ValueError(
                f"offset ({dy}, {dx}) from origin {tuple(origin)} reads "
                f"rows {i0}..{i0 + out_h - 1}, columns {j0}..{j0 + out_w - 1}"
                f" of a {h}x{w} source")


def stencil_gather_ref(x, offsets, out_h, out_w, *, origin=(0, 0)):
    """``out[i, j, f] = x[origin0 + i + dy_f, origin1 + j + dx_f]``:
    ``[out_h, out_w, F]``, one slice per offset."""
    check_bounds(x.shape, offsets, out_h, out_w, origin)
    feats = []
    for dy, dx in offsets:
        i0 = origin[0] + dy
        j0 = origin[1] + dx
        feats.append(x[i0:i0 + out_h, j0:j0 + out_w])
    return torch.stack(feats, dim=-1)
