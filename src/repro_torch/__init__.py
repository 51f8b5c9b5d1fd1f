"""PyTorch/CUDA port of `repro`: hierarchical cloud/edge/device workload
allocation for the paper's ICU LSTM classifiers, with the LSTM cell step
as a hand-written CUDA kernel and the Algorithm-2 tabu search as torch
ops. The package imports torch and never jax; see README.md."""
