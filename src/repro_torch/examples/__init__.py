"""Twins of the repo's examples that drive the port: each runs as
``python -m repro_torch.examples.<name>``, on the CUDA card unless given
``--device cpu``."""
