"""Wrapper of the hand-written cell-sum kernel (csrc/cell_sums.cu).

On a CUDA tensor `cell_sums` checks its inputs, allocates the output
with `torch.empty` (the kernel writes every cell), launches the kernel
on the current stream and counts the launch; a launch the CUDA runtime
refuses raises. On a CPU tensor it runs the plain version (`ref.py`),
and only then.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cell_sums import ref
from repro_torch.kernels.common import check, on_cuda

_P = ctypes.c_void_p

kernel = build.CudaKernel("cell_sums", "cell_sums_launch",
                          [_P, _P, _P, _P, _P, ctypes.c_int, _P],
                          errors="cell_sums_error_string")
KERNELS = (kernel,)


def cell_sums(pos, vec, grid):
    """(5, ncells) float32: per cell, the member count and the sums of
    pos[:, 0], pos[:, 1], vec[:, 0] and vec[:, 1], each added in id
    order from 0, over the CSR grid `neighbors.build_grid(pos, spec)`.
    With a leading replica axis ((R, N, 2) rows, a grid of R worlds)
    the cells are all R * ncell^2, summed in the one launch: the CSR
    order holds row ids across replicas, so the kernel needs no replica
    index."""
    pos, vec = pos.reshape(-1, 2), vec.reshape(-1, 2)
    if pos.device.type == "cpu":
        return ref.cell_sums_plain(pos, vec, grid)
    on_cuda("cell_sums", pos)
    n, dev = pos.shape[0], pos.device
    ncells = grid["starts"].shape[0]
    check("pos", pos, (torch.float32,), (n, 2), dev)
    check("vec", vec, (torch.float32,), (n, 2), dev)
    check("order", grid["order"], (torch.int64,), (n,), dev)
    for k in ("starts", "counts"):
        check(k, grid[k], (torch.int64,), (ncells,), dev)
    if pos.data_ptr() % 8 or vec.data_ptr() % 8:
        raise ValueError("cell_sums reads float2 rows, which need 8-byte "
                         "alignment")
    out = torch.empty((5, ncells), dtype=torch.float32, device=dev)
    kernel.launch(pos.data_ptr(), vec.data_ptr(), grid["order"].data_ptr(),
                  grid["starts"].data_ptr(), grid["counts"].data_ptr(),
                  ncells, out.data_ptr())
    return out


def reset_launches() -> None:
    build.reset_launches(KERNELS)


def launches() -> dict:
    return build.launches(KERNELS)
