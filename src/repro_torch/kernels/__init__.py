"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (`ref`). Wrappers run the plain version for CPU tensors and the
kernel for CUDA tensors; kernels build on first use (`_build`)."""
