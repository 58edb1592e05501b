"""Spatial-grid (cell-list) neighbor search on the toroidal square.

The port of `repro.core.neighbors`: the grid geometry and capacity
math (uniform and clustered), the binning, the CSR grid build (with the
open world's dead rows binned out of it), the plain PyTorch sweeps that
count, for each sender, the recipients on each LP within range (over
every row, or a row subset against a gathered world), the service's
neighbour query, the flock's 3x3 block means, and the sharded halo's
cell masks (`halo_mask`, `dilate_mask`). On the card the engine does not run these
sweeps: it hands the grid to the hand-written kernels in
`repro_torch.kernels.proximity` (whose plain versions delegate here)
and `repro_torch.kernels.cell_sums`.

Parity with the reference's compiled program, bit for bit:

  * the range test is `fma(dx, dx, dy*dy) <= rng*rng`, the fused form
    XLA compiles `toroidal_d2` to (`fp32.fma32`);
  * `cell_ids` multiplies by the float32 reciprocal of the cell side,
    which is what XLA makes of the division by a constant;
  * the cell sort is stable, and each segment is truncated at
    `capacity` keeping its first members in sorted order, so an
    overflowed grid drops the same members.

Replicas. Positions may carry a leading replica axis, (R, N, 2): the
grid then covers R worlds at once, replica r's cells offset by
r * ncell^2 and its rows by r * N, so one stable sort orders every
replica's SEs and replica r's segments are those of its solo grid
(same members, same order). The sweeps and the block means read each
replica's cells only; the overflow flag is one a replica.

Dead rows. An open world (`build_grid(valid=)`) bins its dead rows to
one virtual cell, R * ncell^2, that sorts after every real cell of
every replica: they occupy no segment, are nobody's candidate, never
trip `overflow`, and their count rows are zeros.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.fp32 import div32, f32, fma32
from repro_torch.kernels.cell_sums import ops as cell_sums_ops

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


def toroidal_d2(a, b, area: float, fused: bool = True):
    """Squared toroidal distance between (..., 2) float32 positions:
    `fma(dx, dx, dy*dy)` rounded once, as the compiled reference; with
    `fused=False`, dx*dx + dy*dy rounded op by op, as the reference
    computes it eagerly (the service's queries)."""
    d = (a - b).abs()
    d = torch.minimum(d, f32(area) - d)
    dx, dy = d[..., 0], d[..., 1]
    return fma32(dx, dx, dy * dy) if fused else dx * dx + dy * dy


def dense_lp_counts(pos, lp, sender_mask, n_lp: int, area: float,
                    rng: float, chunk: int = 1024):
    """The dense O(N^2) oracle: counts[i, l] = #{j != i :
    toroidal_dist(i, j) <= rng, lp[j] == l}, zeroed for non-senders.
    Rows are swept in chunks, so memory is O(chunk * N). With a leading
    replica axis, each replica is swept alone."""
    if pos.dim() > 2:
        return torch.stack([
            dense_lp_counts(p, l, s, n_lp, area, rng, chunk)
            for p, l, s in zip(pos, lp, sender_mask)])
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows_dense_counts(pos, lp, n_lp, area, rng, pos, rows,
                             sender_mask, chunk)


def rows_dense_counts(pos, lp, n_lp: int, area: float, rng: float,
                      row_pos, row_idx, row_sender, chunk: int = 2048):
    """Dense-sweep counts (R, n_lp) int32 for a row subset against the
    reference arrays `pos` / `lp` (the sharded engine's dense fallback
    asks its own rows against the gathered world). `row_idx` is each
    row's index into `pos`, left out of its own count; entries with
    lp < 0 (empty shard slots) match no LP."""
    rng2 = f32(rng * rng)
    cols = torch.arange(pos.shape[0], device=pos.device)
    out = torch.zeros((row_pos.shape[0], n_lp), dtype=torch.int32,
                      device=pos.device)
    for s in range(0, row_pos.shape[0], chunk):
        rp, ri = row_pos[s:s + chunk], row_idx[s:s + chunk]
        mask = toroidal_d2(rp[:, None, :], pos[None, :, :], area) <= rng2
        mask &= cols[None, :] != ri[:, None]
        mask &= row_sender[s:s + chunk, None]
        out[s:s + chunk] = _histogram(mask, lp[None, :], n_lp)
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


def clustered_capacity(n: int, ncell: int, cell: float, n_clusters: int,
                       radius: float) -> int:
    """Static per-cell capacity bound for K-blob clustered placement:
    the blob population times the share of the blob one cell covers,
    times 3 (two blobs on one cell, center peaking), plus the uniform
    terms. An underestimate trips `grid_overflow`."""
    per_blob = -(-n // max(n_clusters, 1))
    blob_area = math.pi * max(radius, cell / 2.0) ** 2
    peak = 3.0 * per_blob * min(1.0, cell * cell / blob_area)
    mean = n / float(ncell * ncell)
    return min(n, int(math.ceil(peak + mean + 8.0 * math.sqrt(max(mean, 1.0))
                                + 16.0)))


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
    """(..., N) int32 cell id per position: floor(pos * (1 / cell)),
    with the reciprocal rounded to float32, clipped at the seam."""
    cxy = torch.floor(pos * f32(1.0 / f32(spec.cell))).to(torch.int32)
    cxy = cxy.clamp(0, spec.ncell - 1)
    return cxy[..., 0] * spec.ncell + cxy[..., 1]


def replica_offsets(n_rep: int, stride: int, device, dtype=torch.int64):
    """(R, 1): r * stride, the offset of replica r's block of a flat
    axis."""
    return torch.arange(0, n_rep * stride, stride, dtype=dtype,
                        device=device)[:, None]


def build_grid(pos, spec: GridSpec, valid=None):
    """Bin positions ((N, 2), or (R, N, 2): R worlds) into the CSR
    grid; `valid` ((N,) or (R, N) bool, the open world's live rows)
    bins the other rows to the virtual cell R * ncell^2.

    Keys, over all R * N rows and R * ncell^2 cells (replica r's cells
    offset by r * ncell^2, its rows by r * N): cell (R*N,) int32 cell id
    per SE; order (R*N,) int64 the stable sort permutation by cell (row
    ids across replicas) and cell_sorted (R*N,) int32 = cell[order];
    starts/counts (R*ncell^2,) int64 segment offsets and sizes; overflow
    () or (R,) bool — True iff some cell of the replica holds more than
    `capacity` SEs (members past it are dropped from the segment window,
    so exactness requires overflow == False). Counts, starts and
    overflow span the real cells only; a dead row's `cell` is the
    virtual id (index no cell-shaped array with it)."""
    ncells = spec.ncell * spec.ncell
    lead = pos.shape[:-2]
    n_rep = math.prod(lead)
    cell = cell_ids(pos, spec)
    if n_rep > 1:
        cell = cell + replica_offsets(n_rep, ncells, pos.device,
                                      torch.int32)
    if valid is not None:
        cell = torch.where(valid, cell, n_rep * ncells)
    cell = cell.reshape(-1)
    cell_sorted, order = torch.sort(cell, stable=True)
    cids = torch.arange(n_rep * ncells, dtype=cell.dtype, device=pos.device)
    starts = torch.searchsorted(cell_sorted, cids)
    counts = torch.searchsorted(cell_sorted, cids, right=True) - starts
    return {"cell": cell, "order": order, "cell_sorted": cell_sorted,
            "starts": starts, "counts": counts,
            "overflow": counts.view(lead + (ncells,)).amax(-1)
            > spec.capacity}


def rows_grid_counts(pos, lp, n_lp: int, area: float, rng: float,
                     spec: GridSpec, grid, row_pos, row_idx, row_sender,
                     budget_entries: int = 0, n_per_rep: int = 0):
    """Cell-list counts for a row subset against a prebuilt grid, via
    the CSR segment sweep: for each of the 9 neighbor cells every row
    reads one window of the sorted order, masked by the segment's count
    (cut at `capacity`), and folds the in-range tests into its
    histogram.
    Rows go in chunks of at most `budget_entries // window`, where the
    window is the fullest segment's count (at most `capacity`): slots
    past a segment's count are masked anyway, so a clustered world's
    large capacity costs nothing where its cells are sparser.
    With `n_per_rep` > 0, `pos` holds replicas of that many rows and a
    row's neighbour cells are its own replica's."""
    n, dev = pos.shape[0], pos.device
    nc = spec.ncell
    order, starts = grid["order"], grid["starts"]
    seg_cnt = grid["counts"].clamp(max=spec.capacity)
    cap = int(seg_cnt.max()) if seg_cnt.numel() else 0
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
        base = (ri // n_per_rep) * (nc * nc) if n_per_rep else 0
        acc = torch.zeros((rp.shape[0], n_lp), dtype=torch.int32,
                          device=dev)
        for di, dj in NEIGH_OFFSETS:
            ncid = base + ((cx + di) % nc) * nc + (cy + dj) % nc
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
    for the segment reads), scattered back by the sort permutation.
    Takes a leading replica axis as `build_grid` does. Rows the grid
    holds in its virtual cell (dead rows) count nothing, sender or
    not, as the cell-list kernel writes them."""
    lead, n = pos.shape[:-2], pos.shape[-2]
    pos, lp = pos.reshape(-1, 2), lp.reshape(-1)
    order = grid["order"]
    live = grid["cell_sorted"] < grid["starts"].shape[0]
    out = rows_grid_counts(pos, lp, n_lp, area, rng, spec, grid,
                           pos[order], order,
                           sender_mask.reshape(-1)[order] & live,
                           budget_entries, n_per_rep=n if lead else 0)
    counts = torch.empty_like(out)
    counts[order] = out
    return counts.view(lead + (n, n_lp))


def rows_grid_neighbor_ids(pos, area: float, rng: float, spec: GridSpec,
                           grid, q_pos, q_row):
    """Indices (into `pos`, one world's (N, 2)) of every agent within
    `rng` of each query point, via the CSR cell list: (Q, 9 * capacity)
    int64, padded with -1. `q_row` is each query's own row (or -1),
    left out of its result. Dead rows are in no segment, so never
    appear; windows are cut at `capacity` as in the counting sweep.
    Q is a request batch, so no chunking. The pair test is the
    reference's eager one (its service calls this outside a compiled
    program)."""
    n, nc, cap = pos.shape[0], spec.ncell, spec.capacity
    order, starts = grid["order"], grid["starts"]
    seg_cnt = grid["counts"].clamp(max=cap)
    rng2 = f32(rng * rng)
    rc = cell_ids(q_pos, spec)
    cx, cy = rc // nc, rc % nc
    karange = torch.arange(cap, device=pos.device)
    cols = []
    for di, dj in NEIGH_OFFSETS:
        ncid = ((cx + di) % nc) * nc + (cy + dj) % nc
        idx = starts[ncid][:, None] + karange[None, :]
        ok = karange[None, :] < seg_cnt[ncid][:, None]
        j = order[idx.clamp(0, n - 1)]
        ok &= j != q_row[:, None]
        ok &= toroidal_d2(q_pos[:, None, :], pos[j], area,
                          fused=False) <= rng2
        cols.append(torch.where(ok, j, -1))
    return torch.cat(cols, dim=1)


def grid_lp_counts(pos, lp, sender_mask, n_lp: int, area: float, rng: float,
                   spec: GridSpec, budget_entries: int = 0):
    """Cell-list version of the dense LP histogram (bit-identical)."""
    return grid_lp_counts_from(pos, lp, sender_mask, n_lp, area, rng, spec,
                               build_grid(pos, spec), budget_entries)


def occupied(cell, valid, ncells: int):
    """(..., ncells) bool: the cells holding a valid row, from (..., N)
    cell ids (`valid` rows only)."""
    occ = torch.zeros(cell.shape[:-1] + (ncells + 1,), dtype=torch.bool,
                      device=cell.device)
    occ.scatter_(-1, torch.where(valid, cell, ncells).long(), True)
    return occ[..., :ncells]


def halo_mask(cell_ref, row_cell, row_valid, spec: GridSpec):
    """Which reference agents lie in the halo of a row set: a bool mask
    over `cell_ref` (per-agent cell ids), True for the agents in the 3x3
    neighbourhood of a cell a valid row occupies. This is the exact
    halo of a shard, the set `halo_frac` counts (the sparse exchange
    ships a dilated superset of it). Leading axes are row sets of their
    own (a shard's view each)."""
    nc = spec.ncell
    lead = row_cell.shape[:-1]
    occ = occupied(row_cell, row_valid, nc * nc).view(lead + (nc, nc))
    return dilate_mask(occ, 1).view(lead + (nc * nc,)).gather(
        -1, cell_ref.long())


def dilate_mask(occ, r: int):
    """Chebyshev dilation by radius r of a bool cell mask (..., ncell,
    ncell) on the torus: out[i, j] is True iff a cell within r rows and
    r columns (wrapping) is True. r = 1 is the 3x3 block the proximity
    sweep reads. Separable (rows, then columns); when 2r + 1 >= ncell
    the roll chain wraps all the way and an occupied axis saturates."""
    out = occ
    for axis in (-2, -1):
        acc = out
        for s in range(1, r + 1):
            acc = acc | torch.roll(out, s, axis) | torch.roll(out, -s, axis)
        out = acc
    return out


def cell_block_mean(pos, vec, spec: GridSpec, area: float, valid=None):
    """Per-SE mean of positions and of `vec` over the 3x3 cell block:
    (cdelta, vmean), where cdelta (N, 2) is the displacement from each
    SE to the centroid of the *other* SEs of its block (zero when alone)
    and vmean (N, 2) their mean `vec`.

    Each cell's five sums (count, position, vec) add its members in id
    order from 0, as the reference's CPU scatter-add does; the CSR order
    of the stable cell sort lists them so (`kernels.cell_sums`, one
    kernel launch on the card). Cells rolled across the seam shift their
    position sums by -+area, `fma(count, -+area, sum)` rounded once as
    XLA fuses it, and the nine rolled grids are added in the 3x3
    offsets' order. With a leading replica axis every replica's cells
    are summed in the one launch and rolled within their own grid.
    `valid` (the open world's live rows) leaves dead rows out of every
    sum; their own output rows are garbage the caller masks."""
    nc = spec.ncell
    lead, n = pos.shape[:-2], pos.shape[-2]
    grid = build_grid(pos, spec, valid=valid)
    cnt, sx, sy, vx, vy = cell_sums_ops.cell_sums(pos, vec, grid).view(
        (5,) + lead + (nc, nc)).unbind(0)
    dims = (-2, -1)
    acc = None
    for di, dj in NEIGH_OFFSETS:
        rc = torch.roll(cnt, (di, dj), dims)
        rsx = torch.roll(sx, (di, dj), dims)
        rsy = torch.roll(sy, (di, dj), dims)
        # unwrap the seam: cells rolled across it hold coordinates
        # shifted by +-area on the rolled axis
        if di:
            row = 0 if di == 1 else -1
            rsx = rsx.clone()
            rsx[..., row, :] = fma32(rc[..., row, :], -di * area,
                                     rsx[..., row, :])
        if dj:
            col = 0 if dj == 1 else -1
            rsy = rsy.clone()
            rsy[..., col] = fma32(rc[..., col], -dj * area, rsy[..., col])
        parts = (rc, rsx, rsy, torch.roll(vx, (di, dj), dims),
                 torch.roll(vy, (di, dj), dims))
        acc = list(parts) if acc is None else \
            [a + p for a, p in zip(acc, parts)]
    cell = grid["cell"].long().clamp(max=grid["starts"].shape[0] - 1)
    flat = [a.reshape(-1)[cell].view(lead + (n,)) for a in acc]
    others = torch.clamp(flat[0] - 1.0, min=1.0)[..., None]
    alone = ((flat[0] - 1.0) <= 0.0)[..., None]
    csum = torch.stack([flat[1], flat[2]], dim=-1) - pos
    vsum = torch.stack([flat[3], flat[4]], dim=-1) - vec
    zero = torch.zeros_like(pos)
    cdelta = torch.where(alone, zero, div32(csum, others) - pos)
    vmean = torch.where(alone, zero, div32(vsum, others))
    return cdelta, vmean
