"""Spatial-grid (cell-list) neighbor search on the toroidal square.

The port of `repro.core.neighbors`, main-path subset: the grid geometry
and capacity math, the binning, the CSR grid build, and the plain
PyTorch sweeps that count, for each sender, the recipients on each LP
within range. On the card the engine does not run these sweeps: it
hands the grid to the hand-written kernels in
`repro_torch.kernels.proximity`, whose plain versions delegate here.

Parity with the reference's compiled program, bit for bit:

  * the range test is `fma(dx, dx, dy*dy) <= rng*rng`, the fused form
    XLA compiles `toroidal_d2` to (`fp32.fma32`);
  * `cell_ids` multiplies by the float32 reciprocal of the cell side,
    which is what XLA makes of the division by a constant;
  * the cell sort is stable, and each segment is truncated at
    `capacity` keeping its first members in sorted order, so an
    overflowed grid drops the same members.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.fp32 import f32, fma32

#: offsets of the 3x3 neighborhood, row-major
NEIGH_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]

#: auto-chunking target: max candidate-matrix entries resident at once
_CHUNK_BUDGET = 1 << 22

#: resident bytes per (row, candidate-slot) entry of one chunked sweep
_BYTES_PER_CAND_ENTRY = 20


def chunk_entries(mem_budget_mb: int) -> int:
    """Candidate-entry budget for the chunked sweeps from a byte budget
    (0 keeps the `_CHUNK_BUDGET` default)."""
    if mem_budget_mb <= 0:
        return _CHUNK_BUDGET
    return max(1 << 12, (mem_budget_mb << 20) // _BYTES_PER_CAND_ENTRY)


def budget_capacity(ncell: int, mem_budget_mb: int) -> int:
    """Largest member-table capacity whose (ncell^2, capacity) i32 table
    fits in half the byte budget; a clamp below the true peak occupancy
    trips `grid_overflow`, never a silent undercount."""
    return max(1, (mem_budget_mb << 19) // (4 * ncell * ncell))


def toroidal_d2(a, b, area: float):
    """Squared toroidal distance between (..., 2) float32 positions:
    `fma(dx, dx, dy*dy)` rounded once, as the compiled reference."""
    d = (a - b).abs()
    d = torch.minimum(d, f32(area) - d)
    dx, dy = d[..., 0], d[..., 1]
    return fma32(dx, dx, dy * dy)


def dense_lp_counts(pos, lp, sender_mask, n_lp: int, area: float,
                    rng: float, chunk: int = 1024):
    """The dense O(N^2) oracle: counts[i, l] = #{j != i :
    toroidal_dist(i, j) <= rng, lp[j] == l}, zeroed for non-senders.
    Rows are swept in chunks, so memory is O(chunk * N)."""
    n = pos.shape[0]
    dev = pos.device
    rng2 = f32(rng * rng)
    cols = torch.arange(n, device=dev)
    out = torch.zeros((n, n_lp), dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        mask = toroidal_d2(pos[s:e, None, :], pos[None, :, :], area) <= rng2
        mask &= cols[None, :] != cols[s:e, None]
        mask &= sender_mask[s:e, None]
        out[s:e] = _histogram(mask, lp[None, :], n_lp)
    return out


def _histogram(mask, lpj, n_lp: int):
    """(R, n_lp) int32 counts of the masked entries per LP label."""
    return torch.stack([(mask & (lpj == l)).sum(1, dtype=torch.int32)
                        for l in range(n_lp)], dim=1)


def default_capacity(n: int, ncell: int) -> int:
    """Static per-cell capacity bound for n uniform SEs on ncell^2 cells:
    mean occupancy plus 8 Poisson standard deviations plus slack."""
    mean = n / float(ncell * ncell)
    return int(math.ceil(mean + 8.0 * math.sqrt(mean) + 8.0))


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static geometry of the cell grid."""
    ncell: int  # cells per side
    cell: float  # cell side length, >= interaction_range
    capacity: int  # max SEs per cell a segment window reads


def make_grid_spec(n: int, area: float, rng: float,
                   capacity: int = 0) -> Optional[GridSpec]:
    """Largest grid whose cell side still covers `rng`, or None when
    `area / rng < 3` (the 3x3 sweep would alias cells through the
    wrap; callers then use the dense sweep)."""
    ncell = int(area // rng)
    if ncell < 3:
        return None
    cap = capacity if capacity > 0 else default_capacity(n, ncell)
    return GridSpec(ncell=ncell, cell=area / ncell, capacity=cap)


def cell_ids(pos, spec: GridSpec):
    """(N,) int32 cell id per position: floor(pos * (1 / cell)), with
    the reciprocal rounded to float32, clipped at the seam."""
    cxy = torch.floor(pos * f32(1.0 / f32(spec.cell))).to(torch.int32)
    cxy = cxy.clamp(0, spec.ncell - 1)
    return cxy[:, 0] * spec.ncell + cxy[:, 1]


def build_grid(pos, spec: GridSpec):
    """Bin positions into the CSR grid.

    Keys: cell (N,) int32 cell id per SE; order (N,) int64 the stable
    sort permutation by cell and cell_sorted (N,) int32 = cell[order];
    starts/counts (ncell^2,) int64 segment offsets and sizes; overflow
    () bool — True iff some cell holds more than `capacity` SEs (members
    past it are dropped from the segment window, so exactness requires
    overflow == False)."""
    ncells = spec.ncell * spec.ncell
    cell = cell_ids(pos, spec)
    cell_sorted, order = torch.sort(cell, stable=True)
    cids = torch.arange(ncells, dtype=cell.dtype, device=pos.device)
    starts = torch.searchsorted(cell_sorted, cids)
    counts = torch.searchsorted(cell_sorted, cids, right=True) - starts
    return {"cell": cell, "order": order, "cell_sorted": cell_sorted,
            "starts": starts, "counts": counts,
            "overflow": counts.max() > spec.capacity}


def rows_grid_counts(pos, lp, n_lp: int, area: float, rng: float,
                     spec: GridSpec, grid, row_pos, row_idx, row_sender,
                     budget_entries: int = 0):
    """Cell-list counts for a row subset against a prebuilt grid, via
    the CSR segment sweep: for each of the 9 neighbor cells every row
    reads one `capacity`-wide window of the sorted order, masked by the
    segment's count, and folds the in-range tests into its histogram.
    Rows go in chunks of at most `budget_entries // capacity`."""
    n, dev = pos.shape[0], pos.device
    nc, cap = spec.ncell, spec.capacity
    order, starts = grid["order"], grid["starts"]
    seg_cnt = grid["counts"].clamp(max=cap)
    rng2 = f32(rng * rng)
    karange = torch.arange(cap, device=dev)
    budget = budget_entries if budget_entries > 0 else _CHUNK_BUDGET
    chunk = max(1, budget // max(cap, 1))
    r = row_pos.shape[0]
    out = torch.zeros((r, n_lp), dtype=torch.int32, device=dev)
    for s in range(0, r, chunk):
        rp, ri = row_pos[s:s + chunk], row_idx[s:s + chunk]
        rs = row_sender[s:s + chunk]
        rc = cell_ids(rp, spec)
        cx, cy = rc // nc, rc % nc
        acc = torch.zeros((rp.shape[0], n_lp), dtype=torch.int32,
                          device=dev)
        for di, dj in NEIGH_OFFSETS:
            ncid = ((cx + di) % nc) * nc + (cy + dj) % nc
            idx = starts[ncid][:, None] + karange[None, :]
            valid = karange[None, :] < seg_cnt[ncid][:, None]
            j = order[idx.clamp(0, n - 1)]
            valid &= j != ri[:, None]
            mask = toroidal_d2(rp[:, None, :], pos[j], area) <= rng2
            mask &= valid & rs[:, None]
            acc += _histogram(mask, lp[j], n_lp)
        out[s:s + chunk] = acc
    return out


def grid_lp_counts_from(pos, lp, sender_mask, n_lp: int, area: float,
                        rng: float, spec: GridSpec, grid,
                        budget_entries: int = 0):
    """LP histogram over a prebuilt grid, in id order: the CSR sweep
    with every agent as a row, visited in sorted cell order (locality
    for the segment reads), scattered back by the sort permutation."""
    order = grid["order"]
    out = rows_grid_counts(pos, lp, n_lp, area, rng, spec, grid,
                           pos[order], order, sender_mask[order],
                           budget_entries)
    counts = torch.empty_like(out)
    counts[order] = out
    return counts


def grid_lp_counts(pos, lp, sender_mask, n_lp: int, area: float, rng: float,
                   spec: GridSpec, budget_entries: int = 0):
    """Cell-list version of the dense LP histogram (bit-identical)."""
    return grid_lp_counts_from(pos, lp, sender_mask, n_lp, area, rng, spec,
                               build_grid(pos, spec), budget_entries)
