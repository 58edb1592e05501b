"""Wrappers of the two hand-written proximity kernels.

proximity_lp_counts_grid  cell-list kernel  (csrc/proximity_grid.cu)
proximity_lp_counts       dense kernel      (csrc/proximity_dense.cu)

On a CUDA tensor a wrapper checks its inputs, allocates the output with
`torch.empty`, launches its kernel on the current stream and counts the
launch; a launch the CUDA runtime refuses raises. Each call is that one
launch: the cell-list kernel reads the CSR grid and the id-order inputs
in place (no gather into sorted order), and the dense kernel's launch
function zeroes its output itself (`cudaMemsetAsync`, same stream). On
a CPU tensor it runs the kernel's plain version (`ref.py`), and only
then: there is no fallback from the card to the plain code.

Both take R replicas at once: inputs with a leading replica axis,
(R, N, ...), are one launch for all R worlds. The cell-list kernel's
grid is `neighbors.build_grid` of the (R, N, 2) positions (its `order`
holds row ids across replicas, r * N + i, and its CSR spans R * ncell^2
cells); the dense kernel sweeps each replica's pairs only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.fp32 import f32
from repro_torch.kernels import build
from repro_torch.kernels.common import check
from repro_torch.kernels.proximity import ref

#: the histogram bound the kernels are compiled for
MAX_LP = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


grid_kernel = build.CudaKernel(
    "proximity_grid", "grid_lp_counts_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _I],
    errors="proximity_error_string")
dense_kernel = build.CudaKernel(
    "proximity_dense", "dense_lp_counts_launch",
    [_P, _P, _P, _I, _I, _F, _F, _P, _I], errors="proximity_error_string")
KERNELS = (grid_kernel, dense_kernel)


def _check(name, t, dtype, shape, device):
    check(name, t, (dtype,), shape, device)


def _check_common(pos, lp, sender_mask, n_lp: int):
    """(R, N): the replica count and rows a replica of (..., N, 2)
    positions, with every input checked."""
    if pos.device.type != "cuda":
        raise RuntimeError(f"proximity kernels run on CUDA tensors, got "
                           f"{pos.device}")
    if not 1 <= n_lp <= MAX_LP:
        raise ValueError(f"n_lp={n_lp} outside the kernels' 1..{MAX_LP}")
    lead, n = pos.shape[:-2], pos.shape[-2]
    _check("pos", pos, torch.float32, lead + (n, 2), pos.device)
    _check("lp", lp, torch.int32, lead + (n,), pos.device)
    _check("sender_mask", sender_mask, torch.bool, lead + (n,), pos.device)
    if pos.data_ptr() % 8:
        raise ValueError("pos: the kernels read float2 rows, which need "
                         "8-byte alignment")
    return math.prod(lead), n


def proximity_lp_counts_grid(pos, lp, sender_mask, n_lp: int, area: float,
                             rng: float, spec, grid,
                             budget_entries: int = 0):
    """counts[i, l] = #{j != i in range of i : lp[j] == l} for senders i
    (zeros elsewhere), (..., N, n_lp) int32 in id order, over the CSR
    grid `grid = neighbors.build_grid(pos, spec)`. Members past
    `spec.capacity` in a cell are not seen (`grid["overflow"]`).
    `budget_entries` sizes the plain version's chunks."""
    if pos.device.type == "cpu":
        return ref.grid_lp_counts_plain(pos, lp, sender_mask, n_lp, area,
                                        rng, spec, grid, budget_entries)
    n_rep, n = _check_common(pos, lp, sender_mask, n_lp)
    rows, ncells = n_rep * n, n_rep * spec.ncell * spec.ncell
    if n_rep * spec.ncell + rows // 256 + 1 > 65535:
        raise ValueError(f"{n_rep} replicas of a {spec.ncell}^2 grid "
                         "exceed the cell-list launch's grid rows")
    order = grid["order"]
    _check("order", order, torch.int64, (rows,), pos.device)
    _check("cell_sorted", grid["cell_sorted"], torch.int32, (rows,),
           pos.device)
    for k in ("starts", "counts"):
        _check(k, grid[k], torch.int64, (ncells,), pos.device)
    snd = sender_mask.view(torch.uint8)
    out = torch.empty(pos.shape[:-1] + (n_lp,), dtype=torch.int32,
                      device=pos.device)
    grid_kernel.launch(
        pos.data_ptr(), lp.data_ptr(), snd.data_ptr(), order.data_ptr(),
        grid["cell_sorted"].data_ptr(), grid["starts"].data_ptr(),
        grid["counts"].data_ptr(), rows, spec.ncell, spec.capacity, n_lp,
        f32(area), f32(rng * rng), out.data_ptr(), n_rep)
    return out


def proximity_lp_counts(pos, lp, sender_mask, n_lp: int, area: float,
                        rng: float):
    """Dense-sweep twin of `proximity_lp_counts_grid` (exact on every
    world, O(N^2) pair tests). The output is zeroed and summed into by
    the launch (int32 atomics: exact and order-free)."""
    if pos.device.type == "cpu":
        return ref.dense_lp_counts_plain(pos, lp, sender_mask, n_lp, area,
                                         rng)
    n_rep, n = _check_common(pos, lp, sender_mask, n_lp)
    if n_rep > 65535:
        raise ValueError(f"{n_rep} replicas exceed the dense launch's "
                         "grid depth")
    out = torch.empty(pos.shape[:-1] + (n_lp,), dtype=torch.int32,
                      device=pos.device)
    dense_kernel.launch(pos.data_ptr(), lp.data_ptr(),
                        sender_mask.view(torch.uint8).data_ptr(), n, n_lp,
                        f32(area), f32(rng * rng), out.data_ptr(), n_rep)
    return out


def reset_launches() -> None:
    """Set both proximity kernels' launch counts to 0."""
    build.reset_launches(KERNELS)


def launches() -> dict:
    """{library stem: launches since the last reset}."""
    return build.launches(KERNELS)
