"""Kernels of the port: CUDA sources under each kernel's ``csrc/``, their
bindings and their plain PyTorch versions."""
