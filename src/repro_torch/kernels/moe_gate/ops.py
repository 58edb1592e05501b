"""Wrapper of the hand-written fused MoE gate (`csrc/moe_gate.cu`).

On a CUDA tensor it checks its inputs, allocates the outputs with
`torch.empty` (the histogram with `torch.zeros`: the kernel adds into
it), launches the kernel on the current stream and counts the launch; a
launch CUDA refuses raises. On a CPU tensor it runs the plain
version (`ref.py`), and only then: there is no fallback from the card to
the plain code.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPES, check, on_cuda
from repro_torch.kernels.moe_gate import ref

#: the largest expert count the kernel holds in registers
MAX_E = 512
#: the largest k (one pick per lane of a warp)
MAX_K = 32

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel(
    "moe_gate", "moe_gate_launch",
    [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P], errors="moe_gate_error_string")


def moe_gate(logits, k: int, bias=None, norm_topk: bool = True):
    """Softmax over experts, top-k of probs + bias (ties to the lower
    id), the unbiased probabilities of the picks (renormalised to sum 1
    when `norm_topk`) and the per-expert pick counts.

    logits: (T, E) float32 or bfloat16; bias: (E,) float32 or None.
    Returns (top_p (T, k) float32, top_e (T, k) int32, counts (E,)
    int32)."""
    if logits.device.type == "cpu":
        return ref.moe_gate_plain(logits, k, bias, norm_topk)
    on_cuda("moe_gate", logits)
    if logits.dim() != 2:
        raise ValueError(f"logits: expected (T, E), got {tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= E <= MAX_E:
        raise ValueError(f"E={E} outside the kernel's 1..{MAX_E}")
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"k={k} outside 1..min(E, {MAX_K})")
    dev = logits.device
    check("logits", logits, DTYPES, (T, E), dev)
    if bias is not None:
        check("bias", bias, (torch.float32,), (E,), dev)
    top_p = torch.empty((T, k), dtype=torch.float32, device=dev)
    top_e = torch.empty((T, k), dtype=torch.int32, device=dev)
    counts = torch.zeros(E, dtype=torch.int32, device=dev)
    kernel.launch(logits.data_ptr(),
                  None if bias is None else bias.data_ptr(), T, E, k,
                  int(norm_topk), DTYPES[logits.dtype], top_p.data_ptr(),
                  top_e.data_ptr(), counts.data_ptr())
    return top_p, top_e, counts
