"""The RWKV6 WKV recurrence of the port: plain version, CUDA kernel and
registry declaration."""
