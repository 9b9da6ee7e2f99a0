"""Hand-written CUDA kernels of the solver path, each beside its plain
PyTorch version."""
