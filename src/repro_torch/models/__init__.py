"""The LM of the port (counterpart of ``repro/models``): so far the
RWKV6 serving path, ``lm.prefill`` then ``lm.serve_step``."""
