"""Plain tensor operations around the kernels."""
