"""Wrapper of the hand-written flash-attention forward
(`csrc/flash_attention.cu`).

On a CUDA tensor it checks its inputs, allocates the output with
`torch.empty`, launches the kernel on the current stream and counts the
launch; a launch CUDA refuses raises. On a CPU tensor it runs the
plain version (`ref.py`), and only then: there is no fallback from the
card to the plain code.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPES, check, on_cuda
from repro_torch.kernels.flash_attention import ref

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel(
    "flash_attention", "flash_attention_launch",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float],
    errors="flash_attention_error_string")


def flash_attention(q, k, v, causal: bool = True):
    """Softmax(q k^T D^-0.5) v per head, causal (top-left aligned) or
    not. q: (B, H, S, D); k, v: (B, Hkv, Skv, D), Hkv dividing H: query
    head h reads KV head h // (H // Hkv), so grouped K/V is passed
    unexpanded. One dtype, float32 or bfloat16. Returns (B, H, S, D)."""
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal)
    on_cuda("flash_attention", q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q and k/v are (B, H, S, D)")
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{Hkv} KV heads do not divide {H} query heads")
    dev = q.device
    check("q", q, DTYPES, (B, H, S, D), dev)
    check("k", k, (q.dtype,), (B, Hkv, Skv, D), dev)
    check("v", v, (q.dtype,), (B, Hkv, Skv, D), dev)
    out = torch.empty_like(q)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, H, Hkv, S, Skv, D, int(causal), DTYPES[q.dtype],
                  D ** -0.5)
    return out
