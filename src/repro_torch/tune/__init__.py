"""Kernel tuning and flush control of the port (counterpart of
``repro/tune``): the on-disk cache (:mod:`repro_torch.tune.cache`), the
sweep that fills it on the card (:mod:`repro_torch.tune.kernel_tuner`),
the drift-triggered background re-sweep the batcher feeds
(:mod:`repro_torch.tune.resweep`) and the adaptive flush controller of
the serve queue (:mod:`repro_torch.tune.controller`).

The exports resolve lazily: the kernels import :mod:`repro_torch.tune.
cache` while they register, and the tuner imports the kernels, so
importing this package must not import the tuner.
"""
__all__ = ["AdaptiveFlushController", "TuneCache", "autotune",
           "autotune_registered", "best_params", "best_tile",
           "candidate_tiles", "default_cache", "mlp_resources",
           "predict_batch_latency_s", "serve_buckets", "shape_key", "sweep",
           "sweep_fused_mlp", "widths_from_spec"]

_CACHE = ("TuneCache", "best_params", "best_tile", "default_cache",
          "shape_key")
_CONTROLLER = ("AdaptiveFlushController", "mlp_resources",
               "predict_batch_latency_s")


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module 'repro_torch.tune' has no attribute "
                             f"{name!r}")
    import importlib
    mod = ("cache" if name in _CACHE else
           "controller" if name in _CONTROLLER else "kernel_tuner")
    return getattr(importlib.import_module(f"repro_torch.tune.{mod}"), name)
