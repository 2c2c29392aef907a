"""Feature-wise attention: the plain version and its CUDA kernel."""
