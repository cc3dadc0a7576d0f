"""The stencil-gather (im2col) kernel of the port: plain version, CUDA
kernel and registry declaration."""
