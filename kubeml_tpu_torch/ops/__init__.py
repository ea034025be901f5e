"""Operators of the port: plain PyTorch versions and the wrappers of the
hand-written CUDA kernels (``paged_attention``, ``int8_matmul``)."""
