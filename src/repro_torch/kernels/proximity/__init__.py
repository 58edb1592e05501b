"""Proximity/LP-histogram kernels for the §5.1 hot spot."""
from repro_torch.kernels.proximity.ops import (  # noqa: F401
    proximity_lp_counts, proximity_lp_counts_grid)
