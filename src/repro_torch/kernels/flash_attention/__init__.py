"""Flash attention kernels of the port (f32 and the int8 KV path): plain
versions, CUDA kernels and registry declarations."""
