"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers."""
