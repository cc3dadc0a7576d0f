"""Observability of the port (counterpart of ``repro/obs``): so far only
the metrics registry, :mod:`repro_torch.obs.metrics`."""
