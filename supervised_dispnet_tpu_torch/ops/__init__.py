"""Tensor ops of the port (resize) and its CUDA kernels (``ops.cuda``)."""
