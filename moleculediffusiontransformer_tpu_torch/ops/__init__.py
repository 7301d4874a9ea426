"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Nothing here builds or loads a kernel at import: ``cuda_build`` compiles
``csrc/`` with nvcc on the first call that needs a kernel."""
