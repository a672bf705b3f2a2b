"""Kernels of the port: hand-written CUDA for Hopper (`csrc/`, built by
`_build`) behind wrappers that run the plain PyTorch versions (`ref.py`,
`rmsnorm.rmsnorm_plain`) for CPU tensors."""
