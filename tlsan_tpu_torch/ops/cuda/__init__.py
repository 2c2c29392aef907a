"""Hand-written CUDA kernels: the build and the PyTorch wrappers."""
