"""The partitioners' greedy capacity-constrained assignment: a one-block
CUDA kernel (`csrc/capacity_assign.cu`) and its plain version."""
