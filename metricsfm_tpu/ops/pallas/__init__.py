"""Hand-written Pallas kernels for NVIDIA GPUs (Triton route)."""
