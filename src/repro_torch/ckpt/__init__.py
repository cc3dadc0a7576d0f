"""Checkpointing of the port (counterpart of ``repro/ckpt``)."""
