"""Kernel tuning of the port (counterpart of ``repro/tune``): the on-disk
cache (:mod:`repro_torch.tune.cache`) and the sweep that fills it on the
card (:mod:`repro_torch.tune.kernel_tuner`).  The adaptive flush
controller and the resweep wait for the port of the serve queue.

The exports resolve lazily: the kernels import :mod:`repro_torch.tune.
cache` while they register, and the tuner imports the kernels, so
importing this package must not import the tuner.
"""
__all__ = ["TuneCache", "autotune", "autotune_registered", "best_params",
           "best_tile", "candidate_tiles", "default_cache", "serve_buckets",
           "shape_key", "sweep", "sweep_fused_mlp", "widths_from_spec"]

_CACHE = ("TuneCache", "best_params", "best_tile", "default_cache",
          "shape_key")


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module 'repro_torch.tune' has no attribute "
                             f"{name!r}")
    import importlib
    mod = "cache" if name in _CACHE else "kernel_tuner"
    return getattr(importlib.import_module(f"repro_torch.tune.{mod}"), name)
