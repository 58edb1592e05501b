"""Wrappers of the two hand-written proximity kernels.

proximity_lp_counts_grid  cell-list kernel  (csrc/proximity_grid.cu)
proximity_lp_counts       dense kernel      (csrc/proximity_dense.cu)

On a CUDA tensor a wrapper checks its inputs, allocates the output with
`torch.empty`, launches its kernel on the current stream and counts the
launch; a launch the driver refuses raises. On a CPU tensor it runs the
kernel's plain version (`ref.py`), and only then: there is no fallback
from the card to the plain code.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.fp32 import f32
from repro_torch.kernels import build
from repro_torch.kernels.proximity import ref

#: the histogram bound the kernels are compiled for
MAX_LP = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class CudaKernel:
    """One kernel of a ctypes library: built and bound at first launch,
    with a count of its launches."""

    def __init__(self, stem: str, entry: str, argtypes):
        self.stem, self.entry, self.argtypes = stem, entry, argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def _bind(self):
        if self._fn is None:
            self._lib = build.load(self.stem)
            fn = getattr(self._lib, self.entry)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            err = self._lib.proximity_error_string
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._fn = fn
        return self._fn

    def launch(self, *args):
        code = self._bind()(*args, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            msg = self._lib.proximity_error_string(code).decode()
            raise RuntimeError(f"{self.entry} failed to launch: {msg} "
                               f"(cudaError {code})")
        self.launches += 1


grid_kernel = CudaKernel(
    "proximity_grid", "grid_lp_counts_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P])
dense_kernel = CudaKernel(
    "proximity_dense", "dense_lp_counts_launch",
    [_P, _P, _P, _I, _I, _F, _F, _P, _P])
KERNELS = (grid_kernel, dense_kernel)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}" + ("" if t.is_contiguous() else " (strided)"))


def _check_common(pos, lp, sender_mask, n_lp: int):
    if pos.device.type != "cuda":
        raise RuntimeError(f"proximity kernels run on CUDA tensors, got "
                           f"{pos.device}")
    if not 1 <= n_lp <= MAX_LP:
        raise ValueError(f"n_lp={n_lp} outside the kernels' 1..{MAX_LP}")
    n = pos.shape[0]
    _check("pos", pos, torch.float32, (n, 2), pos.device)
    _check("lp", lp, torch.int32, (n,), pos.device)
    _check("sender_mask", sender_mask, torch.bool, (n,), pos.device)
    if pos.data_ptr() % 8:
        raise ValueError("pos: the kernels read float2 rows, which need "
                         "8-byte alignment")
    return n


def proximity_lp_counts_grid(pos, lp, sender_mask, n_lp: int, area: float,
                             rng: float, spec, grid,
                             budget_entries: int = 0):
    """counts[i, l] = #{j != i in range of i : lp[j] == l} for senders i
    (zeros elsewhere), (N, n_lp) int32 in id order, over the CSR grid
    `grid = neighbors.build_grid(pos, spec)`. Members past
    `spec.capacity` in a cell are not seen (`grid["overflow"]`).
    `budget_entries` sizes the plain version's chunks."""
    if pos.device.type == "cpu":
        return ref.grid_lp_counts_plain(pos, lp, sender_mask, n_lp, area,
                                        rng, spec, grid, budget_entries)
    n = _check_common(pos, lp, sender_mask, n_lp)
    ncells = spec.ncell * spec.ncell
    order = grid["order"]
    _check("order", order, torch.int64, (n,), pos.device)
    _check("cell_sorted", grid["cell_sorted"], torch.int32, (n,), pos.device)
    for k in ("starts", "counts"):
        _check(k, grid[k], torch.int64, (ncells,), pos.device)
    pos_s = pos[order]
    lp_s = lp[order]
    snd_s = sender_mask[order].view(torch.uint8)
    out = torch.empty((n, n_lp), dtype=torch.int32, device=pos.device)
    grid_kernel.launch(
        pos_s.data_ptr(), lp_s.data_ptr(), snd_s.data_ptr(),
        grid["cell_sorted"].data_ptr(), order.data_ptr(),
        grid["starts"].data_ptr(), grid["counts"].data_ptr(), n,
        spec.ncell, spec.capacity, n_lp, f32(area), f32(rng * rng),
        out.data_ptr())
    return out


def proximity_lp_counts(pos, lp, sender_mask, n_lp: int, area: float,
                        rng: float):
    """Dense-sweep twin of `proximity_lp_counts_grid` (exact on every
    world, O(N^2) pair tests)."""
    if pos.device.type == "cpu":
        return ref.dense_lp_counts_plain(pos, lp, sender_mask, n_lp, area,
                                         rng)
    n = _check_common(pos, lp, sender_mask, n_lp)
    out = torch.empty((n, n_lp), dtype=torch.int32, device=pos.device)
    dense_kernel.launch(pos.data_ptr(), lp.data_ptr(),
                        sender_mask.view(torch.uint8).data_ptr(), n, n_lp,
                        f32(area), f32(rng * rng), out.data_ptr())
    return out


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    """{library stem: launches since the last reset}."""
    return {k.stem: k.launches for k in KERNELS}
