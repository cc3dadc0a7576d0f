"""Quantized inference tier: int8 kernels behind per-bundle accuracy
gates (counterpart of ``repro/quant``).

  * :mod:`repro_torch.quant.budgets` -- the per-bundle RMSE budget
    registry;
  * :mod:`repro_torch.quant.quantize` -- per-output-channel static weight
    quantization, per-row dynamic activation quantization,
    :func:`quant_mlp_ref`, the plain version of the ``fused_mlp_int8``
    CUDA kernel, and :func:`quantize_kv`, the int8 KV cache of
    ``flash_attention_int8``;
  * :mod:`repro_torch.quant.calibrate` -- calibration rows from the
    held-out split of a ``SurrogateDB``;
  * :mod:`repro_torch.quant.gate` -- the per-bundle accuracy gate, its
    verdicts persisted in the port's ``quant_gate`` tune-cache namespace.

Package import stays lazy: only the stdlib-only budget registry is
imported here, so importing ``repro_torch.quant`` does not load torch.
"""
from repro_torch.quant.budgets import (budget_pair, clear_budgets,
                                       rmse_budget, set_rmse_budget)

__all__ = ["budget_pair", "clear_budgets", "gate_bundle", "gate_passed",
           "quant_mlp_ref", "quantize_kv", "quantize_params",
           "quantize_weights_per_channel", "rmse_budget",
           "set_rmse_budget", "verdict"]

_LAZY = {
    "gate_bundle": "repro_torch.quant.gate",
    "gate_passed": "repro_torch.quant.gate",
    "verdict": "repro_torch.quant.gate",
    "quant_mlp_ref": "repro_torch.quant.quantize",
    "quantize_kv": "repro_torch.quant.quantize",
    "quantize_params": "repro_torch.quant.quantize",
    "quantize_weights_per_channel": "repro_torch.quant.quantize",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.quant' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
