"""Per-bundle accuracy gate for the int8 serving tier (counterpart of
``repro/quant/gate.py``).

A quantized variant is never served on speed alone: the bundle must
first pass this gate, the RMSE of the int8 forward against the f32 net
on held-out calibration rows (:mod:`repro_torch.quant.calibrate`), in
physical output units, judged against the bundle's RMSE budget
(:mod:`repro_torch.quant.budgets`).

One deliberate difference from the reference: its gate runs the int8
side through the oracle ``quant_mlp_ref``; this one runs it through
:func:`repro_torch.kernels.fused_mlp.int8.fused_mlp_int8_op`, which is
the plain version on the CPU and the ``fused_mlp_int8`` CUDA kernel on
the card.  The plain version then serves nothing on the card's main
path, and the gate measures the numbers the engine will serve.  The f32
side is the bundle's ``Sequential``.

Verdicts persist in the port's own ``quant_gate`` tune-cache namespace
(``artifacts/tune_torch/quant_gate.json``) with the schema-2 envelope
and atomic writes of :mod:`repro_torch.tune.cache`:

  * a **pass** is ``{"params": {"gated": 1}, "exact": True, ...}``,
    resolvable by ``best_params`` like any validated winner;
  * a **fail** is ``{"params": {"gated": 0}, "exact": False, ...}``,
    which ``best_params`` never resolves.

Each verdict binds to the bundle's on-disk fingerprint (mtime_ns +
size): rewriting the bundle un-gates it until it is gated again.  A
verdict the JAX package wrote (``artifacts/tune/quant_gate.json``) is
not read: the port gates its bundles itself.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.fused_mlp.int8 import (fused_mlp_int8_op,
                                                pack_int8_mlp)
from repro_torch.kernels.fused_mlp.ops import mlp_stack_from_spec
from repro_torch.nn.serialize import load_model
from repro_torch.obs import metrics as _m
from repro_torch.quant.budgets import rmse_budget
from repro_torch.quant.quantize import quantize_params
from repro_torch.tune.cache import default_cache

#: tune-cache namespace the verdicts persist under
GATE_NAMESPACE = "quant_gate"

_GATE_FAILS = _m.counter(
    "repro_quant_gate_fail_total",
    "quant gate evaluations that failed the RMSE budget", ("bundle",))
_GATE_RMSE = _m.gauge(
    "repro_quant_gate_rmse",
    "observed int8-vs-f32 RMSE at the last gate evaluation", ("bundle",))


def _key(bundle_path) -> str:
    return os.path.abspath(str(bundle_path))


def verdict(bundle_path) -> Optional[dict]:
    """The persisted gate record for a bundle, or None if never gated."""
    return default_cache(GATE_NAMESPACE).get(_key(bundle_path))


def gate_passed(bundle_path) -> bool:
    """True iff the bundle holds a passing verdict bound to its current
    on-disk fingerprint.  A fail, a missing verdict, or a verdict from
    before the last rewrite all answer False: the engine serves f32."""
    from repro_torch.core.engine import _bundle_mtime
    rec = verdict(bundle_path)
    if not rec or not rec.get("exact", False):
        return False
    fp = rec.get("fingerprint")
    return fp is not None and list(fp) == list(_bundle_mtime(str(bundle_path)))


@torch.no_grad()
def _forwards(bundle_path, rows, scale_mult: float, device):
    """(y_f32, y_int8) on the calibration rows, both in physical units
    (the bundle's normalization applied around both paths: budgets are
    written in output units)."""
    from repro_torch.core.engine import bundle_norm
    net, params, spec = load_model(str(bundle_path), device)
    kinds = {layer["kind"] for layer in spec["layers"]}
    if not kinds <= {"dense", "act", "flatten"}:
        raise ValueError(f"bundle {bundle_path!s}: int8 tier only covers "
                         f"pure-MLP bundles, found layers {sorted(kinds)}")
    norm = bundle_norm(spec, net, device)
    x = torch.from_numpy(np.asarray(rows, np.float32)).to(device)
    if norm is not None:
        x = (x - norm[0]) / norm[1]
    y32 = net(x)
    xq, weights, biases, acts = mlp_stack_from_spec(spec, params, x)
    packed = pack_int8_mlp(quantize_params(weights, biases,
                                           scale_mult=scale_mult,
                                           device=device), acts)
    yq = fused_mlp_int8_op(xq.contiguous(), packed)
    if norm is not None:
        y32 = y32 * norm[3] + norm[2]
        yq = yq * norm[3] + norm[2]
    return (y32.cpu().numpy().astype(np.float64),
            yq.cpu().numpy().astype(np.float64))


def gate_bundle(bundle_path, rows, *, budget: Optional[float] = None,
                scale_mult: float = 1.0, device=None) -> dict:
    """Evaluate and persist the gate verdict for one bundle, computed on
    ``device`` (None means CUDA).

    ``rows``: calibration inputs (:func:`repro_torch.quant.calibrate
    .calibration_rows`).  ``budget``: explicit RMSE budget; when None it
    resolves from the registry under the bundle's absolute path, then
    the path as given.  No budget anywhere is a configuration error, not
    a free pass.  ``scale_mult`` feeds weight quantization (1.0 = correct
    absmax calibration; the fail drill passes a wrong one) and is
    recorded in the verdict so the engine serves the exact blessed
    configuration.  Returns the record.
    """
    dev = resolve_device(device)
    key = _key(bundle_path)
    if budget is None:
        budget = rmse_budget(key)
        if budget is None:
            budget = rmse_budget(str(bundle_path))
    if budget is None:
        raise ValueError(
            f"no RMSE budget for bundle {bundle_path!s}: pass budget= or "
            f"register one via repro_torch.quant.budgets.set_rmse_budget")
    y32, yq = _forwards(bundle_path, rows, scale_mult, dev)
    rmse = float(np.sqrt(np.mean((yq - y32) ** 2)))
    passed = bool(np.isfinite(rmse)) and rmse <= float(budget)

    from repro_torch.core.engine import InferenceEngine, _bundle_mtime
    rec = {"params": {"gated": int(passed)}, "exact": passed,
           "rmse": rmse, "budget": float(budget),
           "rows": int(np.asarray(rows).shape[0]),
           "scale_mult": float(scale_mult),
           "fingerprint": list(_bundle_mtime(str(bundle_path)))}
    default_cache(GATE_NAMESPACE).put(key, rec)
    _GATE_RMSE.set(rmse, bundle=str(bundle_path))
    if not passed:
        _GATE_FAILS.inc(1, bundle=str(bundle_path))
    # the engine resolves its tier at load: drop the cached engines so
    # the next get() reads the fresh verdict
    InferenceEngine.invalidate(str(bundle_path))
    return rec
