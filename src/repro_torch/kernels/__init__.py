"""Hand-written CUDA kernels with their plain PyTorch versions beside
them (`ref`); models call `ops`, never a kernel directly."""
