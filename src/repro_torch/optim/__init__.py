"""Optimizers of the port (counterpart of ``repro/optim``)."""
