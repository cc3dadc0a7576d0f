"""The Mamba selective scan of the port: plain version, CUDA kernel and
registry declaration."""
