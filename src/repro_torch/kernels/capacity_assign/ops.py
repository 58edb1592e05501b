"""Wrapper of the hand-written capacity-assignment kernel
(csrc/capacity_assign.cu).

On a CUDA tensor `capacity_assign` checks its inputs, sorts the flat
costs on the device (a stable sort: ties to the lower flat index),
launches the one-block kernel on the current stream and counts the
launch; a launch the CUDA runtime refuses raises. The kernel picks its
branch on the device (parallel rounds for weights of 0 or 1, else the
serial scan) and writes the rounds it ran to a one-int tensor that
`last_rounds()` returns without a sync. On a CPU tensor it runs the
plain version (`ref.py`), and only then.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.capacity_assign import ref
from repro_torch.kernels.common import check, on_cuda

#: the LP count the kernel is compiled for
MAX_LP = 64

_P = ctypes.c_void_p

kernel = build.CudaKernel(
    "capacity_assign", "capacity_assign_launch",
    [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    errors="capacity_assign_error_string")
KERNELS = (kernel,)

_rounds = None


def capacity_assign(cost, weights, caps):
    """Greedy capacity-constrained assignment: cost (N, L) float32,
    weights (N,) float32, caps (L,) float32 (numpy or tensor) -> (N,)
    int32 on cost's device (see `ref.capacity_assign_plain`)."""
    if cost.device.type == "cpu":
        return ref.capacity_assign_plain(cost, weights, caps)
    on_cuda("capacity_assign", cost)
    if cost.dim() != 2:
        raise ValueError("capacity_assign: cost is (N, L)")
    n, L = cost.shape
    if not 1 <= L <= MAX_LP:
        raise ValueError(f"{L} LPs outside the kernel's 1..{MAX_LP}")
    dev = cost.device
    check("cost", cost, (torch.float32,), (n, L), dev)
    check("weights", weights, (torch.float32,), (n,), dev)
    caps = torch.as_tensor(np.asarray(
        caps.cpu() if torch.is_tensor(caps) else caps, np.float32)).to(dev)
    order = torch.sort(cost.reshape(-1), stable=True).indices
    # the pairs' ranks and the SEs' words, where they do not fit in
    # shared memory
    scratch = torch.empty((n * L + n,), dtype=torch.int32, device=dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    global _rounds
    _rounds = torch.empty((1,), dtype=torch.int32, device=dev)
    kernel.launch(order.data_ptr(), weights.data_ptr(), caps.data_ptr(), n,
                  L, scratch.data_ptr(), out.data_ptr(), _rounds.data_ptr())
    return out


def last_rounds():
    """(1,) int32 on the card: the rounds the last launch ran (0: the
    serial branch), or None before the first launch. Reading its value
    synchronises."""
    return _rounds


def reset_launches() -> None:
    build.reset_launches(KERNELS)


def launches() -> dict:
    return build.launches(KERNELS)
