"""Hand-written CUDA kernels (sources in ``../csrc``) and their wrappers."""
