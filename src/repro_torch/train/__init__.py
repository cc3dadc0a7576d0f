"""The LM training step and gradient compression of the port
(counterpart of ``repro/train``)."""
