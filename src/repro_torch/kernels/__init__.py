"""Hand-written CUDA kernels (Hopper) and their plain PyTorch versions."""
