"""Distributed-execution substrate of the port (counterpart of
``repro/dist``).

So far one module: :mod:`repro_torch.dist.hlo_analysis`, the three-term
:class:`Roofline` at the H100's peaks, which the adaptive flush
controller prices batches with.  The sharding contexts and the
collective accounting wait for ROADMAP queue 1 item 9.
"""
from repro_torch.dist.hlo_analysis import (HBM_BW, ICI_BW, PEAK_FLOPS,
                                           Roofline)

__all__ = ["HBM_BW", "ICI_BW", "PEAK_FLOPS", "Roofline"]
