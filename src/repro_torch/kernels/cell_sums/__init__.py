"""Per-cell in-order sums for the flock's block means: a CUDA kernel
(`csrc/cell_sums.cu`) and its plain version."""
