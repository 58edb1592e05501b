"""CUDA kernels written by hand for Hopper, and their build."""
