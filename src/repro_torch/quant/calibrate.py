"""Calibration rows for the quant gate (counterpart of
``repro/quant/calibrate.py``).

The gate measures quantization error on real application inputs: rows
come from the held-out split of the ``SurrogateDB`` the surrogate was
trained on, with the trainer's ``train_test_split`` seed and fraction, so
calibration never sees training rows.

:func:`activation_ranges` harvests per-layer activation absmax over
those rows, for observability only: the serving kernel derives its row
scales per batch, and nothing is baked into the bundle.
"""
from __future__ import annotations

import pathlib
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.database import SurrogateDB
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_mlp.ops import mlp_stack_from_spec
from repro_torch.nn.layers import ACTS
from repro_torch.nn.serialize import load_model


def calibration_rows(db, region: str, *, max_rows: int = 2048,
                     test_frac: float = 0.2, seed: int = 0) -> np.ndarray:
    """Held-out input rows for one region: ``[n, in_features]`` f32.

    ``db`` is a :class:`repro_torch.core.database.SurrogateDB` or a path
    to one.  Raises when the region holds no held-out rows: gating
    against an empty calibration set would certify nothing.
    """
    if isinstance(db, (str, pathlib.Path)):
        db = SurrogateDB(db)
    store = db.group(region)
    _, held = store.train_test_split(test_frac=test_frac, seed=seed)
    x = np.asarray(held["inputs"], np.float32)
    if x.shape[0] == 0:
        raise ValueError(
            f"region {region!r}: no held-out calibration rows "
            f"(test_frac={test_frac} of {store.name} is empty)")
    return x[:max_rows]


@torch.no_grad()
def activation_ranges(bundle_path, rows, device=None
                      ) -> List[Dict[str, float]]:
    """Per-layer activation absmax stats of the f32 forward over the
    calibration rows, on ``device`` (None means CUDA):
    ``[{"absmax", "p50"}, ...]``, one entry per dense layer input (what
    the row quantizer sees at serve time)."""
    from repro_torch.core.engine import bundle_norm
    dev = resolve_device(device)
    net, params, spec = load_model(str(bundle_path), dev)
    norm = bundle_norm(spec, net, dev)
    x = torch.from_numpy(np.asarray(rows, np.float32)).to(dev)
    if norm is not None:
        x = (x - norm[0]) / norm[1]
    h, weights, biases, acts = mlp_stack_from_spec(spec, params, x)
    stats: List[Dict[str, float]] = []
    for w, b, act in zip(weights, biases, acts):
        row_absmax = h.abs().amax(dim=1).cpu().numpy()
        stats.append({"absmax": float(row_absmax.max(initial=0.0)),
                      "p50": float(np.median(row_absmax))
                      if row_absmax.size else 0.0})
        h = ACTS[act](h @ w + b)
    return stats
