"""Plain PyTorch version of the cell-sum kernel.

`cell_sums_plain` adds each cell's members in id order, one float32
add at a time, starting from 0 — the order of the reference's
scatter-add on the CPU. It walks every cell's CSR segment in lockstep,
one member rank per pass, so it takes as many passes as the fullest
cell has members. The CPU path runs it and `chip_smoke.py` holds the
kernel to it on the card.
"""
from __future__ import annotations

import torch


def cell_sums_plain(pos, vec, grid):
    """(5, ncells) float32: per cell, the member count and the sums of
    pos[:, 0], pos[:, 1], vec[:, 0] and vec[:, 1], each added in id
    order from 0. `grid` is `neighbors.build_grid(pos, spec)`."""
    order, starts, counts = grid["order"], grid["starts"], grid["counts"]
    n = pos.shape[0]
    vals = torch.stack([torch.ones_like(pos[:, 0]), pos[:, 0], pos[:, 1],
                        vec[:, 0], vec[:, 1]])[:, order]
    acc = torch.zeros((5, starts.shape[0]), dtype=torch.float32,
                      device=pos.device)
    for k in range(int(counts.max()) if n else 0):
        idx = (starts + k).clamp(max=n - 1)
        acc = torch.where(counts > k, acc + vals[:, idx], acc)
    return acc
