"""Hand-written GPU kernels and their plain PyTorch versions."""
