"""Kernel tuning of the port (counterpart of ``repro/tune``): so far only
the on-disk cache, :mod:`repro_torch.tune.cache`."""
