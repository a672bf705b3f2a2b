"""Attention kernels of the port: hand-written CUDA for Hopper (`csrc/`,
built by `_build`) behind wrappers that run the plain PyTorch versions in
`ref.py` for CPU tensors."""
