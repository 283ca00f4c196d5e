"""Hand-written Hopper (sm_90a) CUDA kernels, each beside its plain PyTorch
version."""
