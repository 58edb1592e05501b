"""Plain PyTorch versions of the two proximity kernels.

Same functions, same signatures as the CUDA kernels' wrappers in
`ops.py`, computed with ordinary tensor operations and chunked so that
1M rows fit. The CPU path runs them, the tests hold the kernels to
them, and `chip_smoke.py` compares each kernel with its plain version
on the card. They are the sweeps of `repro_torch.core.neighbors`, so
the per-pair math has one source of truth, as in the reference.
"""
from __future__ import annotations

from repro_torch.core import neighbors

#: cell-list LP histogram over a prebuilt CSR grid, in id order
grid_lp_counts_plain = neighbors.grid_lp_counts_from

#: dense O(N^2) LP histogram, swept in row chunks
dense_lp_counts_plain = neighbors.dense_lp_counts
